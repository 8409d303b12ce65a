"""Sharded device programs: multi-device phasing + polish steps.

Port of ``falcon_unzip_tpu.parallel.sharding`` without shard_map: rows
are split over a ``parallel.mesh.Mesh`` with ``shard_rows``, every shard
runs the port's single-device op on its own device (the hand-written
kernels on a card: the pair-HMM forward, the Arrow sweeps), and the
shards' results are merged with the collectives of
``parallel.collectives`` (integer partials summed, float rows gathered).
Shards on different cards are launched without a sync between them, so
their kernels overlap.

- phase step: read tag batches are data-parallel across every shard;
  the pileup counts and the banded SNP association table are psum-merged
  (integer, order-free, so bit-identical to one device); het calling is
  computed once on the merged counts.
- polish step: (variant x read) pair-HMM and Arrow splice pairs are
  split across the shards and gathered in mesh order.
- window votes: the contig template axis is split over 'window', the
  tags over 'data', then a halo exchange.

Every sharded class re-runs the single-device op and compares when
``parallel.debug`` is on.  ``_pad_to`` and ``_bucket`` are verbatim
copies.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.arrow import ArrowSplicer
from ..ops.association import association_band_batch
from ..ops.banded_align import build_schedule, prepare_batch
from ..ops.consensus import vote_matrix, votes_scatter
from ..ops.pairhmm import pairhmm_forward, params_vector
from ..ops.pileup import _het_core, pileup_batch
from ..oracle.consensus import MAX_DELTA
from . import debug
from . import distributed as dist
from .collectives import all_gather, halo_exchange, psum
from .mesh import ALL, Mesh, make_mesh, replicate, shard_rows


def _pileup(pos: torch.Tensor, base: torch.Tensor, t_len: int):
    """(t_len, 5) int32 counts of flat tags on their device."""
    return pileup_batch(pos.reshape(1, -1), base.reshape(1, -1),
                        t_len=t_len)[0]


def _assoc(M: torch.Tensor, max_span: int):
    score, cov = association_band_batch(M[None], max_span=max_span)
    return score[0], cov[0]


def make_phase_step(mesh: Mesh, *, t_len: int, s_cap: int, max_span: int,
                    min_depth: int = 10, min_allele_count: int = 2,
                    allele_freq_min: float = 0.25,
                    biallelic_frac: float = 0.8):
    """Sharded phasing step.

    Inputs (split over every mesh shard on the read axis):
      tagpos, tagbase: (R, T) int32, -1-padded delta-0 tags per read.
    Outputs, on the mesh's first device:
      counts (t_len, 5);  is_het (t_len,);  b1, b2 (t_len,) int8;
      score/cov (s_cap, max_span);  M (R, s_cap) int8 allele matrix.
    """

    def step(tagpos, tagbase):
        pos_s = shard_rows(mesh, tagpos).parts
        base_s = shard_rows(mesh, tagbase).parts
        # ---- pileup (scatter-add) + psum merge over the whole mesh
        counts = psum(mesh, [_pileup(p, b, t_len)
                             for p, b in zip(pos_s, base_s)])
        # ---- het predicate (computed once, copied to every shard)
        is_het, b1, b2 = _het_core(
            counts, min_depth=min_depth, min_allele_count=min_allele_count,
            allele_freq_min=allele_freq_min, biallelic_frac=biallelic_frac)
        site_of_pos = torch.where(
            is_het, torch.cumsum(is_het.to(torch.int32), 0) - 1, -1)
        site_of_pos = torch.where(site_of_pos < s_cap, site_of_pos, -1)
        tabs = replicate(mesh, torch.stack([
            site_of_pos.to(torch.int32), b1.to(torch.int32),
            b2.to(torch.int32)]))
        Ms, scores, covs = [], [], []
        for pos, base, tab in zip(pos_s, base_s, tabs):
            # ---- allele matrix for the shard's reads (first s_cap sites)
            site_t, b1_t, b2_t = tab
            R_loc, T = pos.shape
            ok = (pos >= 0) & (pos < t_len)
            pc = pos.clamp(0, t_len - 1).long()
            site = torch.where(ok, site_t[pc], -1)
            hit = site >= 0
            val = torch.where(base == b1_t[pc], 1,
                              torch.where(base == b2_t[pc], -1, 0))
            rows = torch.arange(R_loc, device=pos.device)[:, None].expand(
                R_loc, T)
            M = torch.zeros((R_loc, s_cap + 1), dtype=torch.int8,
                            device=pos.device)
            M[rows, torch.where(hit, site, s_cap).long()] = torch.where(
                hit, val, 0).to(torch.int8)
            M = M[:, :s_cap]
            # ---- banded association partials
            sc, cv = _assoc(M, max_span)
            Ms.append(M)
            scores.append(sc)
            covs.append(cv)
        return (counts, is_het, b1, b2, psum(mesh, scores),
                psum(mesh, covs), all_gather(mesh, Ms))

    return step


def make_polish_step(mesh: Mesh, *, W: int, Lt: int, G: int):
    """Sharded pair-HMM scoring: pairs split across all shards, each
    shard's banded forward on its device, ll gathered in mesh order."""

    def step(qg, trg, n, m, lo_arr, params_vec):
        parts = [shard_rows(mesh, x).parts for x in (qg, trg, n, m)]
        lls = [pairhmm_forward(q, t, nn, mm, lo_arr, params_vec, W=W,
                               Lt=Lt, G=G) for q, t, nn, mm in zip(*parts)]
        return all_gather(mesh, lls)

    return step


# ---------------------------------------------------------------------------
# Pipeline-facing sharded executors (config-5: full pipeline over a mesh)
# ---------------------------------------------------------------------------

def _pad_to(x, mult, fill):
    pad = (-len(x)) % mult
    if pad == 0:
        return x
    return np.concatenate([x, np.full(pad, fill, x.dtype)])


def _bucket(n: int, mult: int) -> int:
    """Round n up to mult * next_pow2 so jit shape cache stays small."""
    per = -(-max(n, 1) // mult)
    p = 1
    while p < per:
        p <<= 1
    return mult * p


def _on(mesh: Mesh, x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(mesh.first)


class ShardedPhaseOps:
    """Mesh data-parallel pileup + allele-association with EXACT integer
    semantics — results are bit-identical to the single-device ops
    (scatter-adds and psum are integer, order-free).

    Flat read tags are split over every shard, each shard scatter-adds
    its pileup / association partials on its device, and one psum over
    ('data', 'window') merges them.
    """

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.n_dev = mesh.size

    def _pileup_shards(self, gp, gb, t_len: int) -> torch.Tensor:
        return psum(self.mesh, [_pileup(p, b, t_len)
                                for p, b in zip(gp.parts, gb.parts)])

    def _assoc_shards(self, gM, max_span: int):
        parts = [_assoc(M, max_span) for M in gM.parts]
        return (psum(self.mesh, [s for s, _ in parts]),
                psum(self.mesh, [c for _, c in parts]))

    def pileup(self, pos, base, *, t_len: int) -> np.ndarray:
        pos = np.asarray(pos, np.int32)
        base = np.asarray(base, np.int32)
        B = _bucket(len(pos), self.n_dev)
        pos_p = _pad_to(pos, B, -1)     # no tags: stays empty
        gp = shard_rows(self.mesh, pos_p)
        gb = shard_rows(self.mesh, _pad_to(base, B, 0))
        out = self._pileup_shards(gp, gb, t_len).cpu().numpy()
        if debug.enabled():
            debug.check_spec("pileup.pos", gp,
                             self.mesh.row_spec(ALL, len(pos_p)))
            ref = _pileup(_on(self.mesh, pos), _on(self.mesh, base), t_len)
            debug.check_equal("pileup", out, ref.cpu().numpy())
        return out

    def association(self, M, *, max_span: int):
        M0 = np.asarray(M, np.int8)
        M = M0
        B = _bucket(M.shape[0], self.n_dev)
        pad = B - M.shape[0]
        if pad:  # zero rows contribute nothing to score or cov
            M = np.concatenate([M, np.zeros((pad, M.shape[1]), np.int8)])
        gM = shard_rows(self.mesh, M)
        score, cov = (x.cpu().numpy()
                      for x in self._assoc_shards(gM, max_span))
        if debug.enabled():
            debug.check_spec("association.M", gM, self.mesh.row_spec(ALL, B))
            rs, rc = _assoc(_on(self.mesh, M0), max_span)
            debug.check_equal("association.score", score, rs.cpu().numpy())
            debug.check_equal("association.cov", cov, rc.cpu().numpy())
        return score, cov


class ShardedPairHMMScorer:
    """Drop-in ``ops.pairhmm.PairHMMScorer`` that splits scoring pairs
    across the mesh: the same (q, t, n, m) -> ll interface; each shard
    runs the banded forward (the CUDA kernel on a card) on its pairs and
    the lls are gathered in mesh order.
    """

    def __init__(self, mesh: Mesh, W: int = 64, params=None):
        self.mesh = mesh
        self.W = W
        self.pvec = params_vector(params)
        self.n_dev = mesh.size

    def __call__(self, q: np.ndarray, t: np.ndarray,
                 n: np.ndarray, m: np.ndarray) -> np.ndarray:
        Pn, Lq = q.shape
        Lt = t.shape[1]
        B = _bucket(Pn, self.n_dev)
        pad = B - Pn
        if pad:  # repeat last pair; padded lanes are dropped after gather
            q = np.concatenate([q, np.tile(q[-1:], (pad, 1))])
            t = np.concatenate([t, np.tile(t[-1:], (pad, 1))])
            n = np.concatenate([n, np.tile(n[-1:], pad)])
            m = np.concatenate([m, np.tile(m[-1:], pad)])
        qg, trg, G = prepare_batch(q, t, self.W)
        Dmax, lo = build_schedule(Lq, Lt, self.W)
        n = np.asarray(n, np.int32)
        m = np.asarray(m, np.int32)
        step = make_polish_step(self.mesh, W=self.W, Lt=Lt, G=G)
        out = step(qg, trg, n, m, lo, self.pvec).cpu().numpy()[:Pn]
        if debug.enabled():
            ref = pairhmm_forward(
                *(_on(self.mesh, x[:Pn]) for x in (qg, trg, n, m)), lo,
                self.pvec, W=self.W, Lt=Lt, G=G)
            debug.check_equal("pairhmm.ll", out, ref.cpu().numpy(),
                              atol=1e-4)
        return out


class ShardedArrowSplicer:
    """Mesh-sharded ``ops.arrow.ArrowSplicer`` (the polish hot loop).

    Same (qs, ts, cands, pvecs) -> (ll_cur, ll_mut) interface.  The
    base splicer (on the mesh's first device) keeps the host packing;
    its ``_pick_chunk`` and ``_dispatch`` are overridden so every chunk's
    pair axis is split over ('data', 'window'), each shard's
    ``ArrowSplicer`` runs the sweeps + splice on its device, and the
    results are gathered in mesh order.
    """

    def __init__(self, mesh: Mesh, max_cand: int = 8, params=None,
                 chunk: int = 512, fixed_lq: int | None = None,
                 fixed_lj: int | None = None,
                 tier_params: np.ndarray | None = None):
        kw = dict(max_cand=max_cand, params=params, chunk=chunk,
                  fixed_lq=fixed_lq, fixed_lj=fixed_lj,
                  tier_params=tier_params)
        self._base = ArrowSplicer(device=mesh.first, **kw)
        self._shards = [ArrowSplicer(device=d, **kw) for d in mesh.local]
        self._single = self._base._dispatch     # the one-device op
        self._base._dispatch = self._dispatch
        self._base._pick_chunk = self._pick_chunk
        self.C = max_cand
        self.mesh = mesh
        self.n_dev = mesh.size

    def _pick_chunk(self, N: int) -> int:
        # both candidates are n_dev-divisible so shards stay equal
        return min(_bucket(N, self.n_dev),
                   _bucket(self._base.chunk, self.n_dev))

    def _dispatch(self, qa, ta, nn, mm, ca, pv, Lq: int, LJ: int,
                  qt=None):
        per = len(qa) // self.n_dev
        pend = []
        for sp, slot in zip(self._shards, self.mesh.slots):
            r = slice(slot * per, (slot + 1) * per)
            pend.append(sp._dispatch(
                qa[r], ta[r], nn[r], mm[r], ca[r], pv[r], Lq, LJ,
                qt=None if qt is None else qt[r]))
        out = (all_gather(self.mesh, [c for c, _ in pend]),
               all_gather(self.mesh, [m for _, m in pend]))
        if debug.enabled():
            ref = self._single(qa, ta, nn, mm, ca, pv, Lq, LJ, qt=qt)
            debug.check_equal("arrow.ll_cur", out[0].cpu().numpy(),
                              ref[0].cpu().numpy(), atol=1e-3)
            debug.check_equal("arrow.ll_mut", out[1].cpu().numpy(),
                              ref[1].cpu().numpy(), atol=1e-3)
        return out

    def __call__(self, qs, ts, cands, pvecs=None, qtiers=None):
        return self._base(qs, ts, cands, pvecs=pvecs, qtiers=qtiers)


class ShardedWindowVotes:
    """Window-axis (sequence-parallel) vote-tensor construction.

    The contig TEMPLATE axis is split over the mesh 'window' axis: each
    window shard scatter-adds (``ops.consensus.votes_scatter``) the votes
    of its template segment from the data-split flat tag stream, the
    partials of the 'data' shards are summed, and a ring halo exchange
    (``parallel.collectives.halo_exchange``) ships each shard's leading
    ``window`` columns to its left neighbour.  Every polish window [lo,
    lo+window) is then sliced entirely from the extended block of the
    shard owning ``lo``.  Integer scatter-add + sums keep the result
    bit-identical to ``ops.consensus.vote_matrix``.  Runs on a
    process-local mesh.
    """

    def __init__(self, mesh: Mesh, max_delta: int | None = None):
        if mesh.spans_processes:
            raise ValueError("ShardedWindowVotes runs on a process-local "
                             "mesh")
        self.mesh = mesh
        self.nw = int(mesh.shape["window"])
        self.nd = int(mesh.shape["data"])
        self.D = (MAX_DELTA if max_delta is None else max_delta) + 1

    def supports(self, t_len: int, window: int) -> bool:
        """The halo covers exactly one right neighbor, so each segment
        must be at least one polish window long."""
        return self.nw > 1 and -(-t_len // self.nw) >= window

    def _segment_votes(self, gp, gd, gb, seg: int) -> list:
        """Per window shard w, the (seg, D, 5) votes of template segment
        w summed over the 'data' shards, on the device of shard (0, w)."""
        votes: dict[int, torch.Tensor] = {}
        for k, slot in enumerate(self.mesh.slots):
            _, w = self.mesh.coords(slot)
            pos = gp.parts[k]
            lp = torch.where(pos >= 0, pos - w * seg, -1)
            v = votes_scatter(lp, gd.parts[k], gb.parts[k], t_len=seg,
                              max_delta=self.D - 1)
            if w in votes:
                votes[w] += v.to(votes[w].device)
            else:
                votes[w] = v
        return [votes[w] for w in range(self.nw)]

    def blocks(self, pos, delta, base, *, t_len: int, window: int):
        """Build per-shard vote blocks for a contig.

        pos/delta/base: flat int32 tag columns (pos < 0 rows ignored).
        Returns (blocks (nw, seg+window, D, 5) np.ndarray, seg).
        """
        pos = np.asarray(pos, np.int32)
        delta = np.asarray(delta, np.int32)
        base = np.asarray(base, np.int32)
        seg = -(-t_len // self.nw)
        B = _bucket(len(pos), self.nd)
        g = lambda x, fill: shard_rows(self.mesh, _pad_to(x, B, fill),
                                       "data")
        gp = g(pos, -1)                 # no tags: stays empty
        votes = self._segment_votes(gp, g(delta, 0), g(base, 0), seg)
        _left, right = halo_exchange(self.mesh, votes, window)
        v_np = np.stack([v.cpu().numpy() for v in votes])
        r_np = np.stack([r.cpu().numpy() for r in right])
        blocks = np.concatenate([v_np, r_np], axis=1)
        if debug.enabled():
            debug.check_spec("window_votes.pos", gp, self.mesh.row_spec(
                "data", len(_pad_to(pos, B, -1))))
            tags = np.stack([pos, delta, base], axis=1)
            ref = vote_matrix([tags], t_len, max_delta=self.D - 1)
            full = v_np.reshape(self.nw * seg, self.D, 5)[:t_len]
            debug.check_equal("window_votes", full, ref)
        return blocks, seg


def make_pipeline_mesh(n_devices: int = 0, window_par: int = 0, *,
                       device, local_only: bool = False):
    """Mesh for the pipeline drivers: None when only one device is visible
    (single-device path) or when n_devices == 1 (explicitly disabled).

    On a card the mesh takes the visible cards (n_devices = 0: all of
    them); on the CPU it is n_devices logical shards (n_devices = 0: one
    device, so None).  local_only: a mesh over THIS PROCESS's devices
    only — the contig-owner dataflow runs each host's per-contig device
    work independently, so the mesh must not span processes."""
    if n_devices == 1:
        return None
    world = 1 if local_only else dist.process_count()
    if torch.device(device).type == "cuda":
        avail = len(dist.local_devices()) * world
    else:
        avail = n_devices or world
    n = min(n_devices, avail) if n_devices else avail
    if n < 2:
        return None
    return make_mesh(n, window_par or None, device=device,
                     local_only=local_only)

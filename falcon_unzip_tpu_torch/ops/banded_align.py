"""Batched banded edit-distance alignment on a torch device.

Port of ``falcon_unzip_tpu.ops.banded_align``.  The host numpy helpers
(``build_schedule``, ``prepare_batch``, ``moves_forward``,
``unpack_moves2``, ``moves_to_tags_vec``, ``anchor_trim``) are verbatim
copies.  The device work has two implementations of the same integer
recurrence:

* on CUDA tensors, the hand-written kernels of ``csrc/banded_align.cu``
  (``_kernels.banded_wavefront`` and ``_kernels.traceback``);
* on CPU tensors, the plain torch versions below
  (``banded_align_batch_plain``, ``traceback_batch_plain``), Python loops
  over antidiagonals / traceback steps.

Both emit the backpointers in one packed layout, 2 bits per cell:
``bp[d // 16, p, w] >> (2 * (d % 16)) & 3`` as int32 (the layout of the
TPU kernel ``ops/pallas_align.py``).  Semantics are defined by and tested
against ``oracle.align`` and the JAX scan path.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve
from ..oracle.align import GAP, INF, band_lo
from ..seq import PAD
from . import _kernels

MOVE_DIAG, MOVE_UP, MOVE_LEFT, MOVE_NONE = 0, 1, 2, 3


def _round128(x: int) -> int:
    return -(-x // 128) * 128


def build_schedule(Lq: int, Lt: int, W: int):
    """Host-side band schedule for padded lengths (Lq, Lt): lo per antidiag."""
    Dmax = Lq + Lt + 1
    lo = np.array([band_lo(d, W) for d in range(Dmax)], dtype=np.int32)
    return Dmax, lo


def prepare_batch(q: np.ndarray, t: np.ndarray, W: int,
                  tail_guard: int = 0):
    """Guard-pad query and reversed target for shared-slice wavefront access.

    q: (P, Lq) int8 padded with PAD;  t: (P, Lt) int8.
    Returns (qg, trg, G) with
      qg[:, k]  == q[:, k-1]      (so q[i-1] = qg[i])
      trg[:, G+k] == t[:, Lt-1-k] (so t[j-1] = trg[G + Lt - j])

    tail_guard: extra PAD columns appended to both outputs (the Pallas
    kernel over-reads past the schedule end; allocating it here avoids a
    second full np.pad copy of the guarded arrays per chunk — measured
    ~4.5 s of the 1 Mb overlap pass).
    """
    P, Lq = q.shape
    _, Lt = t.shape
    LQG = _round128(max((Lq + Lt + 1) // 2 + W // 2 + 2, Lq + 2)) + tail_guard
    qg = np.full((P, LQG), PAD, dtype=np.int8)
    qg[:, 1 : Lq + 1] = q
    G = W + max(0, (Lq - Lt + 1) // 2) + 2
    LTG = _round128(G + Lt + W + 2) + tail_guard
    trg = np.full((P, LTG), PAD, dtype=np.int8)
    trg[:, G : G + Lt] = t[:, ::-1]
    return qg, trg, G


def _as_list(x) -> list[int]:
    if isinstance(x, torch.Tensor):
        return [int(v) for v in x.tolist()]
    return [int(v) for v in np.asarray(x).tolist()]


def banded_align_batch_plain(qg, trg, n, m, lo_arr, *, W: int, Lt: int,
                             G: int, mode: str = "global",
                             want_bp: bool = True) -> dict:
    """Plain torch wavefront (the CPU path; the card's reference).

    qg (P, LQG) / trg (P, LTG) int8 guarded rows from ``prepare_batch``;
    n, m (P,) int32 true lengths; lo_arr (Dmax,) band schedule.  Returns
    dist, end_i, end_j (P,) int32 [, bp (ceil(Dmax/16), P, W) int32].
    Same arithmetic as the JAX ``banded_align_batch``: the masks that
    depend only on (d, w) are applied as slices, the per-pair ones as
    comparisons against n and m.
    """
    dev = qg.device
    P = qg.shape[0]
    lo_l = _as_list(lo_arr)
    Dmax = len(lo_l)
    inf = int(INF)
    i32 = torch.int32
    n = n.to(dev, i32)
    m = m.to(dev, i32)
    n_col = n[:, None]
    m_col = m[:, None]
    w_iota = torch.arange(W, dtype=i32, device=dev)[None, :]
    q_ok = qg < 4
    # padded wavefronts: Vp[:, 1 + w] = V[w], INF guard columns at both ends
    ring = [torch.full((P, W + 2), inf, dtype=i32, device=dev)
            for _ in range(3)]
    best = torch.full((P,), inf, dtype=i32, device=dev)
    best_j = torch.full((P,), -1, dtype=i32, device=dev)
    final = torch.full((P,), inf, dtype=i32, device=dev)
    bp = (torch.zeros((-(-Dmax // 16), P, W), dtype=i32, device=dev)
          if want_bp else None)
    # global mode: pairs whose corner (n, m) lies on antidiagonal d
    hits: dict[int, list[int]] = {}
    if mode == "global":
        for p, s in enumerate(_as_list(n + m)):
            hits.setdefault(s, []).append(p)
    local = mode in ("qglocal", "tglocal")
    for d in range(Dmax):
        lo = lo_l[d]
        s1 = lo - (lo_l[d - 1] if d >= 1 else 0)
        s2 = lo - (lo_l[d - 2] if d >= 2 else 0)
        Vp1 = ring[(d - 1) % 3]
        Vp2 = ring[(d - 2) % 3]
        Vp = ring[d % 3]
        up = Vp1[:, s1 : s1 + W]                # V1[w + s1 - 1]
        left = Vp1[:, 1 + s1 : 1 + s1 + W]      # V1[w + s1]
        diag = Vp2[:, s2 : s2 + W]              # V2[w + s2 - 1]
        qi = qg[:, lo : lo + W]
        t0 = G + Lt - d + lo
        tj = trg[:, t0 : t0 + W]
        eq = (qi == tj) & q_ok[:, lo : lo + W]
        cd = torch.where(eq, diag, diag + 1)
        cu = up + 1
        cl = left + 1
        jz = max(0, d - lo)          # j >= 1  <=>  w < d - lo
        cd[:, jz:] = inf
        cl[:, jz:] = inf
        if lo == 0:                  # i >= 1  <=>  not (lo == 0 and w == 0)
            cd[:, 0] = inf
            cu[:, 0] = inf
        V = torch.minimum(torch.minimum(cd, cu), cl)
        mv = torch.where(cd <= V, MOVE_DIAG,
                         torch.where(cu <= V, MOVE_UP,
                                     MOVE_LEFT)).to(i32)
        # origin: (i == 0) & (j >= 0) in tglocal, (i == 0) & (j == 0)
        # otherwise; i == 0 only at w == 0 when lo == 0
        origin = lo == 0 and (mode == "tglocal" or d == 0)
        if origin:
            V[:, 0] = 0
        valid = (w_iota <= n_col - lo) & (w_iota >= (d - lo) - m_col)
        valid[:, d - lo + 1:] = False              # j >= 0
        V = torch.where(valid, V, inf).clamp_(max=inf)
        Vp[:, 1 : W + 1] = V
        if want_bp:
            keep = valid & (V < inf)
            if origin:
                keep[:, 0] = False
            bp_d = torch.where(keep, mv, MOVE_NONE)
            bp[d // 16] |= bp_d << (2 * (d % 16))
        if local:
            # row i == n sits at w = n - lo (one cell per antidiagonal)
            wn = n - lo
            inb = (wn >= 0) & (wn < W)
            v = V.gather(1, wn.clamp(0, W - 1)[:, None].long())[:, 0]
            upd = inb & (v < best)
            best = torch.where(upd, v, best)
            best_j = torch.where(upd, d - n, best_j)
        elif d in hits:
            idx = torch.tensor(hits[d], dtype=torch.long, device=dev)
            wnm = (n[idx] - lo).clamp(0, W - 1).long()
            final[idx] = V[idx, wnm]
    if mode == "global":
        out = {"dist": final, "end_i": n.clone(), "end_j": m.clone()}
    else:
        out = {"dist": best, "end_i": n.clone(), "end_j": best_j}
    if want_bp:
        out["bp"] = bp
    return out


def banded_align_batch(qg, trg, n, m, lo_arr, *, W: int, Lt: int, G: int,
                       mode: str = "global", want_bp: bool = True) -> dict:
    """Batched banded DP: the CUDA kernel for CUDA tensors, the plain
    torch version for CPU tensors.  Arguments and results as in
    ``banded_align_batch_plain``."""
    if qg.is_cuda:
        return _kernels.banded_wavefront(
            qg, trg, n, m, W=W, Lt=Lt, G=G, Dmax=len(lo_arr), mode=mode,
            want_bp=want_bp)
    return banded_align_batch_plain(qg, trg, n, m, lo_arr, W=W, Lt=Lt, G=G,
                                    mode=mode, want_bp=want_bp)


def unpack_bp(bp: torch.Tensor, Dmax: int) -> torch.Tensor:
    """Packed (ceil(Dmax/16), P, W) int32 -> (Dmax, P, W) int8 moves."""
    d = torch.arange(Dmax, device=bp.device)
    sh = (2 * (d % 16)).to(torch.int32)[:, None, None]
    return ((bp[d // 16] >> sh) & 3).to(torch.int8)


def traceback_batch_plain(bp, lo_arr, end_i, end_j, *,
                          max_steps: int) -> torch.Tensor:
    """Plain torch traceback over packed moves.  Returns (P, max_steps)
    int8 in REVERSE order (first entry = last move), MOVE_NONE past the
    end; the JAX ``traceback_batch``'s clipping of d and w is kept."""
    _, P, W = bp.shape
    dev = bp.device
    lo = torch.as_tensor(np.asarray(_as_list(lo_arr), np.int32), device=dev)
    Dmax = len(lo)
    flat = bp.reshape(-1)
    base = torch.arange(P, dtype=torch.int64, device=dev) * W
    i = end_i.to(dev, torch.int32).clone()
    j = end_j.to(dev, torch.int32).clone()
    out = torch.full((P, max_steps), MOVE_NONE, dtype=torch.int8,
                     device=dev)
    for k in range(max_steps):
        dc = (i + j).clamp(0, Dmax - 1)
        w = (i - lo[dc.long()]).clamp(0, W - 1)
        idx = (dc >> 4).long() * (P * W) + base + w.long()
        mv = (flat[idx] >> (2 * (dc & 15))) & 3
        mv = torch.where((i <= 0) & (j <= 0), MOVE_NONE, mv)
        out[:, k] = mv.to(torch.int8)
        i = i - (mv <= MOVE_UP).to(torch.int32)
        j = j - ((mv & 1) == 0).to(torch.int32)      # DIAG or LEFT
        # MOVE_NONE freezes (i, j): once every pair has stopped, the
        # remaining columns are MOVE_NONE, as initialised
        if k % 64 == 63 and bool((mv == MOVE_NONE).all()):
            break
    return out


def traceback_batch(bp, lo_arr, end_i, end_j, *,
                    max_steps: int) -> torch.Tensor:
    """Batched traceback: the CUDA kernel for CUDA tensors, the plain
    torch version for CPU tensors."""
    if bp.is_cuda:
        return _kernels.traceback(bp, end_i, end_j, W=bp.shape[2],
                                  Dmax=len(lo_arr), max_steps=max_steps)
    return traceback_batch_plain(bp, lo_arr, end_i, end_j,
                                 max_steps=max_steps)


def moves_forward(moves_rev: np.ndarray) -> list[np.ndarray]:
    """Reverse-order padded moves -> list of forward move arrays per pair."""
    out = []
    for row in np.asarray(moves_rev):
        row = row[row != MOVE_NONE]
        out.append(row[::-1].astype(np.int8))
    return out


def pack_moves2(moves: torch.Tensor) -> torch.Tensor:
    """(P, S) int8 moves (values 0..3) -> (P, ceil(S/16)) int32, 2 bits
    per move (bit pattern of the JAX ``pack_moves2``)."""
    P, S = moves.shape
    S16 = -(-S // 16) * 16
    mv = torch.full((P, S16), MOVE_NONE, dtype=torch.int64,
                    device=moves.device)
    mv[:, :S] = moves.to(torch.int64) & 3
    shifts = 2 * torch.arange(16, dtype=torch.int64, device=moves.device)
    word = (mv.reshape(P, S16 // 16, 16) << shifts).sum(dim=-1)
    return torch.where(word >= 1 << 31, word - (1 << 32),
                       word).to(torch.int32)


def _combine_results(packed, dist, end_i, end_j) -> torch.Tensor:
    """Packed moves + dist/end_i/end_j as one (P, K+3) int32 tensor, so
    ``collect`` makes one device-to-host copy per chunk."""
    tail = torch.stack([dist.to(torch.int32), end_i.to(torch.int32),
                        end_j.to(torch.int32)], dim=1)
    return torch.cat([packed, tail], dim=1)


def _summarize_moves(moves_rev, dist, end_i, end_j) -> torch.Tensor:
    """Per-pair alignment summary on the device, (P, 7) int32.

    The overlapper needs the matched interval and the up-run trims, not
    the move string.  moves_rev is REVERSE move order with a
    MOVE_NONE-padded suffix, so: forward-leading up run = the run of
    MOVE_UP ending the valid prefix; forward-trailing up run = the run of
    MOVE_UP starting at index 0.
    Columns: dist, end_j, n_t (diag+left moves), lead, trail, n_up, end_i.
    """
    valid = moves_rev != MOVE_NONE
    is_up = moves_rev == MOVE_UP
    is_t = (moves_rev == MOVE_DIAG) | (moves_rev == MOVE_LEFT)
    n_t = (is_t & valid).sum(dim=1)
    n_up = (is_up & valid).sum(dim=1)
    # run of UP closing the valid prefix: suffix-AND of (UP or padding)
    up_or_pad = is_up | ~valid
    suff = torch.flip(torch.cumprod(
        torch.flip(up_or_pad, dims=[1]).to(torch.int32), dim=1), dims=[1])
    lead = (suff.bool() & valid).sum(dim=1)
    trail = torch.cumprod(is_up.to(torch.int32), dim=1).sum(dim=1)
    return torch.stack([x.to(torch.int32) for x in
                        (dist, end_j, n_t, lead, trail, n_up, end_i)],
                       dim=1)


def unpack_moves2(packed: np.ndarray, S: int) -> np.ndarray:
    """Inverse of pack_moves2 on host: (P, S16/16) int32 -> (P, S) int8."""
    p = np.asarray(packed)
    shifts = (2 * np.arange(16, dtype=np.int32))[None, None, :]
    m = (p[:, :, None] >> shifts) & 3
    return m.reshape(p.shape[0], -1)[:, :S].astype(np.int8)


def moves_to_tags_vec(q: np.ndarray, moves: np.ndarray,
                      t_offset: int = 0) -> np.ndarray:
    """Vectorized numpy tags from forward moves (spec: oracle.moves_to_tags)."""
    if len(moves) == 0:
        return np.zeros((0, 3), dtype=np.int32)
    mv = np.asarray(moves)
    is_d = mv == MOVE_DIAG
    is_u = mv == MOVE_UP
    is_l = mv == MOVE_LEFT
    consumes_t = is_d | is_l
    consumes_q = is_d | is_u
    j = np.cumsum(consumes_t) - 1          # t index of this move (for d/l)
    i = np.cumsum(consumes_q) - 1          # q index (for d/u)
    # t_pos: for diag/left -> j; for up -> last consumed t index (ffill)
    last_j = np.where(consumes_t, j, -1)
    last_j = np.maximum.accumulate(last_j)
    t_pos = np.where(consumes_t, j, last_j)
    # delta for an up at position p = p - (index of last t-consuming move
    # before p); count of consecutive ups since last diag/left.
    pos_in = np.arange(len(mv))
    lastc = np.where(consumes_t, pos_in, -1)
    lastc = np.maximum.accumulate(lastc)
    delta = np.where(is_u, pos_in - lastc, 0).astype(np.int64)
    base = np.where(is_l, GAP, q[np.clip(i, 0, max(len(q) - 1, 0))])
    tags = np.stack([t_pos + t_offset, delta, base], axis=1).astype(np.int32)
    return tags


def anchor_trim(q: np.ndarray, t_win: np.ndarray, moves: np.ndarray,
                end_j: int, k: int = 8):
    """Trim an alignment to start AND end on a run of k exact diagonal
    matches (vectorized numpy).

    An edit-distance DP with free target ends has no match bonus, so
    query bases hanging past the target (or erroneous read ends) smear
    into mismatch/insertion mixtures at the alignment's extremes — and
    those become insertion VOTES that corrupt consensus near contig
    ends.  DALIGNER/blasr end their alignments at exact anchor points
    ([U] SURVEY.md §2b); this does the same post-hoc: everything before
    the first and after the last k-long exact-match run is clipped, and
    the clipped query bases emit no tags.

    Returns None when no k-run exists (reject the alignment), else a
    dict with the kept ``moves``, sliced ``q``, contig-window
    ``start_j``/``end_j`` of the kept span, and its edit ``dist``.
    """
    mv = np.asarray(moves)
    L = len(mv)
    if L < k:
        return None
    consumes_t = (mv == MOVE_DIAG) | (mv == MOVE_LEFT)
    consumes_q = (mv == MOVE_DIAG) | (mv == MOVE_UP)
    start_j = int(end_j) - int(consumes_t.sum())
    j = start_j + np.cumsum(consumes_t) - 1
    i = np.cumsum(consumes_q) - 1
    qi = np.clip(i, 0, max(len(q) - 1, 0))
    tj = np.clip(j, 0, max(len(t_win) - 1, 0))
    diag_eq = ((mv == MOVE_DIAG) & (q[qi] == t_win[tj]) & (q[qi] < 4)
               & (j >= 0) & (j < len(t_win)))
    # local-alignment end trim (Kadane on the move path, match +1 /
    # edit -2): an edit-distance DP has no match bonus, so a chimeric
    # junction or long garbage tail rides the min-cost path at ~50%
    # matches and an accidental k-run can anchor it — the max-score
    # subpath drops any tail that is net noise while a 3%-error read
    # (expected +0.91/move) keeps its full span.  First-optimal ties.
    sc = np.where(diag_eq, 1, -2).astype(np.int64)
    pre = np.concatenate([[0], np.cumsum(sc)])          # (L+1,)
    run_min = np.minimum.accumulate(pre[:-1])           # min prefix < j
    gain = pre[1:] - run_min
    hi_k = int(np.argmax(gain))                         # subpath end
    if gain[hi_k] <= 0:
        return None
    lo_k = int(np.nonzero(pre[: hi_k + 1] == run_min[hi_k])[0][0])
    win_ok = np.zeros(L, bool)
    win_ok[lo_k : hi_k + 1] = True
    c = np.concatenate([[0], np.cumsum(diag_eq.astype(np.int32))])
    ok = (c[k:] - c[:-k]) == k          # ok[s]: moves[s : s+k] all match
    ok &= win_ok[:L - k + 1] & win_ok[k - 1:]   # runs inside the subpath
    idx = np.nonzero(ok)[0]
    if len(idx) == 0:
        return None
    s0, s_last = int(idx[0]), int(idx[-1])
    kept = mv[s0 : s_last + k]
    q0 = int(consumes_q[:s0].sum())
    q1 = int(consumes_q[s_last + k:].sum())
    t0 = int(consumes_t[:s0].sum())
    t1 = int(consumes_t[s_last + k:].sum())
    return {
        "moves": kept,
        "q": q[q0 : len(q) - q1],
        "q0": q0,
        "start_j": start_j + t0,
        "end_j": int(end_j) - t1,
        "dist": int((~diag_eq[s0 : s_last + k]).sum()),
    }


class BandedAligner:
    """Batched aligner over same-shape (bucketed) pair batches on one
    torch device.  On CUDA the DP and traceback run in the hand-written
    kernels; on the CPU in the plain torch versions.  Both are
    conformance-equal to ``oracle.align.banded_dp``."""

    def __init__(self, W: int = 128, mode: str = "global", device=None):
        self.W = W
        self.mode = mode
        self.device = resolve(device)

    def __call__(self, q: np.ndarray, t: np.ndarray,
                 n: np.ndarray, m: np.ndarray, want_moves=True):
        """q (P, Lq), t (P, Lt) int8; n, m true lengths. Returns dict of
        numpy arrays: dist, end_i, end_j [, moves list of forward arrays]."""
        return self.collect(self.dispatch(q, t, n, m, want_moves=want_moves))

    def dispatch(self, q: np.ndarray, t: np.ndarray,
                 n: np.ndarray, m: np.ndarray, want_moves=True):
        """Issue the device work without waiting for results.

        CUDA launches are asynchronous, so callers batching many chunks
        dispatch them all first and then ``collect`` in order.  The
        handle holds only small per-pair results plus 2-bit packed
        traceback moves; the packed backpointer tensor is consumed on
        the device here.  want_moves: True (moves), "summary" (the 7-int
        summary of ``_summarize_moves``) or False (dist and ends only).
        """
        P, Lq = q.shape
        Lt = t.shape[1]
        Dmax, lo = build_schedule(Lq, Lt, self.W)
        # the DP runs Dmax antidiagonals, but cells past d = n + m are
        # masked-inert padding: truncate to the chunk's true need,
        # quantized to 1024 (band_lo depends only on (d, W), so the
        # schedule prefix is unchanged)
        need = (int(np.max(np.asarray(n) + np.asarray(m))) + 1
                if P else Dmax)
        Dmax = min(Dmax, -(-need // 1024) * 1024)
        lo = lo[:Dmax]
        steps = Dmax - 1
        qg, trg, G = prepare_batch(q, t, self.W)
        dev = self.device
        res = banded_align_batch(
            torch.from_numpy(qg).to(dev), torch.from_numpy(trg).to(dev),
            torch.from_numpy(np.asarray(n, np.int32)).to(dev),
            torch.from_numpy(np.asarray(m, np.int32)).to(dev), lo,
            W=self.W, Lt=Lt, G=G, mode=self.mode, want_bp=bool(want_moves))
        handle = {"res": None, "steps": steps, "combined": None,
                  "summary": None}
        if want_moves == "summary":
            moves_rev = traceback_batch(res["bp"], lo, res["end_i"],
                                        res["end_j"], max_steps=steps)
            handle["summary"] = _summarize_moves(
                moves_rev, res["dist"], res["end_i"], res["end_j"])
        elif want_moves:
            moves_rev = traceback_batch(res["bp"], lo, res["end_i"],
                                        res["end_j"], max_steps=steps)
            handle["combined"] = _combine_results(
                pack_moves2(moves_rev), res["dist"], res["end_i"],
                res["end_j"])
        else:
            handle["res"] = {k: v for k, v in res.items() if k != "bp"}
        return handle

    @staticmethod
    def collect_summaries(handles: list) -> dict:
        """Materialize many summary-mode handles with one device-to-host
        copy.  Summaries are (P, 7) int32 whatever the bucket shape, so
        the pending chunks concatenate on the device.  Rows follow handle
        order; the caller slices by its per-chunk P."""
        parts = [h["summary"] for h in handles]
        if not parts:
            return {"dist": np.zeros(0, np.int32)}
        s = torch.cat(parts, dim=0).cpu().numpy()
        return {"dist": s[:, 0], "end_j": s[:, 1], "n_t": s[:, 2],
                "lead": s[:, 3], "trail": s[:, 4], "n_up": s[:, 5],
                "end_i": s[:, 6]}

    def collect(self, handle) -> dict:
        """Materialize a ``dispatch`` handle as numpy (blocks)."""
        if handle["summary"] is not None:
            s = handle["summary"].cpu().numpy()
            return {"dist": s[:, 0].copy(), "end_j": s[:, 1].copy(),
                    "n_t": s[:, 2].copy(), "lead": s[:, 3].copy(),
                    "trail": s[:, 4].copy(), "n_up": s[:, 5].copy(),
                    "end_i": s[:, 6].copy()}
        if handle["combined"] is not None:
            c = handle["combined"].cpu().numpy()
            out = {"dist": c[:, -3].copy(), "end_i": c[:, -2].copy(),
                   "end_j": c[:, -1].copy()}
            moves_rev = unpack_moves2(c[:, :-3], handle["steps"])
            out["moves"] = moves_forward(moves_rev)
            return out
        return {k: v.cpu().numpy() for k, v in handle["res"].items()}

"""Seeded batches of the banded pair-HMM forward and the bar they are held to.

The card kernel's checks (its GPU tests, ``chip_smoke.py`` phase 3 and
``scripts/tune_pairhmm.py``) and the CPU tests of its yardstick build their
inputs here.  ``edge_batch`` gives one kind of edge case at a band width W:
specs ``(n, m)`` turned into PAD-filled reads and templates of a window of
``window(W)`` bases and the schedule length Dmax the forward runs to;
``bench_batch`` gives the bench's shape (half the reads exact copies, half
at 15% error); ``to_device`` makes the forward's arguments; ``max_rel_err``
measures a result against the plain version.
"""
from __future__ import annotations

import numpy as np
import torch

from falcon_unzip_tpu_torch.ops.banded_align import (build_schedule,
                                                     prepare_batch)
from falcon_unzip_tpu_torch.oracle.align import band_lo
from falcon_unzip_tpu_torch.utils.arrow_batches import _pair
from falcon_unzip_tpu_torch.utils.simulate import mutate_read, random_genome

EDGE_KINDS = ("out_of_band", "empty", "prologue_end", "truncated",
              "band_edges", "mixed", "one_pair", "odd_count")


def window(W: int) -> int:
    """The read and template width of the edge batches at band width W."""
    return 2 * W + 64


def corner_w(n: int, m: int, W: int) -> int:
    """The band index of the (n, m) corner on its antidiagonal n + m (in
    the band iff 0 <= it < W)."""
    return n - band_lo(n + m, W)


def _m_for(n: int, w: int, W: int, top: int) -> int | None:
    """The smallest m in 0..top whose corner (n, m) lies at band index w."""
    for m in range(top + 1):
        if corner_w(n, m, W) == w:
            return m
    return None


def edge_specs(kind: str, W: int) -> tuple:
    """(specs [(n, m), ...], Dmax or None for the full schedule) of one
    kind at band width W:

    out_of_band: corners off either side of the band (NEG), beside one in it;
    empty: n = 0 or m = 0;
    prologue_end: n + m from W - 1 to W + 4, across the prologue's end
    (the band starts to move at d = W + 1) and the first steady pair;
    truncated: n + m around a cut schedule of odd length 2W + 1 (pairs
    past it are NEG);
    band_edges: corners at band index 0, 1, W - 2, W - 1 (n < m and n > m)
    and just outside, -1 and W;
    mixed: long and short pairs in one batch;
    one_pair: a batch of one;
    odd_count: 37 pairs, a multiple of no warp count."""
    L = window(W)
    if kind == "out_of_band":
        return [(10, W + 40), (W + 40, 10), (0, W + 10), (L, 3),
                (W // 2, W // 2)], None
    if kind == "empty":
        return [(0, 0), (0, 1), (1, 0), (0, 5), (5, 0), (0, W // 2),
                (W // 2, 0)], None
    if kind == "prologue_end":
        return [(s // 2 + k, s - s // 2 - k) for s in range(W - 1, W + 5)
                for k in (0, 1)], None
    if kind == "truncated":
        Dmax = 2 * W + 1
        return [(s // 2, s - s // 2) for s in range(Dmax - 3, Dmax + 3)] \
            + [(Dmax, Dmax), (3, 4)], Dmax
    if kind == "band_edges":
        specs = []
        for n in (W // 2, W, W + 20):
            for w in (-1, 0, 1, W - 2, W - 1, W):
                m = _m_for(n, w, W, L)
                if m is not None:
                    specs.append((n, m))
        return specs, None
    if kind == "mixed":
        return [(L - 3, L - 1), (4, 6), (L, L), (1, 2), (L // 2, L // 2 + 9),
                (17, 12), (L - 40, L - 30), (0, 3)], None
    if kind == "one_pair":
        return [(L - 21, L - 13)], None
    if kind == "odd_count":
        rng = np.random.default_rng(W)
        specs = []
        for _ in range(37):
            m = int(rng.integers(0, L + 1))
            n = int(np.clip(m + rng.integers(-W // 2, W // 2 + 1), 0, L))
            specs.append((n, m))
        return specs, None
    raise ValueError(f"unknown edge kind {kind!r}")


def pack(rng, specs, *, Lq: int, Lt: int) -> tuple:
    """PAD-filled numpy (q, t, n, m) of the specs [(n, m), ...]: reads at 0,
    5 and 15% error in turn, one read base in 40 an N."""
    P = len(specs)
    q = np.full((P, Lq), 4, np.int8)
    t = np.full((P, Lt), 4, np.int8)
    n = np.zeros(P, np.int32)
    m = np.zeros(P, np.int32)
    for k, (nk, mk) in enumerate(specs):
        qk, tk = _pair(rng, nk, mk, (0.0, 0.05, 0.15)[k % 3],
                       int(rng.integers(1 << 30)))
        if k % 2 == 1:
            qk[::40] = 4
        q[k, :nk] = qk
        t[k, :mk] = tk
        n[k], m[k] = nk, mk
    return q, t, n, m


def edge_batch(kind: str, W: int, seed: int = 0, P: int | None = None
               ) -> dict:
    """One kind's batch at band width W, its pairs repeated up to P if P is
    given: numpy q, t, n, m and the schedule length Dmax (the full Lq + Lt
    + 1 unless the kind cuts it)."""
    specs, Dmax = edge_specs(kind, W)
    if P is not None:
        specs = (specs * -(-P // len(specs)))[:P]
    L = window(W)
    q, t, n, m = pack(np.random.default_rng(seed + W), specs, Lq=L, Lt=L)
    return {"q": q, "t": t, "n": n, "m": m,
            "Dmax": Dmax if Dmax is not None else 2 * L + 1}


def bench_batch(seed: int, P: int, win: int, tlen=(400, 501)) -> dict:
    """P pairs of the bench's shape: templates of tlen (lo, hi) bases, half
    the reads exact copies, half at 15% error, both cut to win."""
    rng = np.random.default_rng(seed)
    qs, ts = [], []
    for k in range(P):
        tk = random_genome(int(rng.integers(*tlen)), int(rng.integers(1 << 30)))
        qk = mutate_read(tk, 0.0 if k % 2 == 0 else 0.15, rng)[:win]
        qs.append(qk)
        ts.append(tk[:win])
    q = np.full((P, win), 4, np.int8)
    t = np.full((P, win), 4, np.int8)
    for k, (a, b) in enumerate(zip(qs, ts)):
        q[k, : len(a)] = a
        t[k, : len(b)] = b
    return {"q": q, "t": t, "n": np.array([len(a) for a in qs], np.int32),
            "m": np.array([len(b) for b in ts], np.int32),
            "Dmax": 2 * win + 1}


def to_device(batch: dict, W: int, pvec, dev) -> tuple:
    """(args, kw) of ``ops.pairhmm.pairhmm_forward`` for a batch on dev:
    the guarded rows, n, m, the (cut) schedule and pvec; W, Lt, G."""
    q, t = batch["q"], batch["t"]
    qg, trg, G = prepare_batch(q, t, W)
    _, lo = build_schedule(q.shape[1], t.shape[1], W)
    dt = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    args = (dt(qg), dt(trg), dt(batch["n"]), dt(batch["m"]),
            lo[: batch["Dmax"]], pvec)
    return args, {"W": W, "Lt": t.shape[1], "G": G}


def max_rel_err(got, want) -> float:
    """Largest |got - want| / max(1, |want|) over the pairs in the band, and
    inf if the pairs out of it (< -1e29) differ."""
    got = torch.as_tensor(got).double().cpu()
    want = torch.as_tensor(want).double().cpu()
    if not torch.equal(got < -1e29, want < -1e29):
        return float("inf")
    ok = want > -1e29
    if not bool(ok.any()):
        return 0.0
    err = (got - want).abs()[ok] / want.abs()[ok].clamp(min=1.0)
    return float(err.max())

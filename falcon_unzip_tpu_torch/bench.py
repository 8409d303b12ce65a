"""Kernel bench of the port on one NVIDIA GPU: one JSON line.

    python -m falcon_unzip_tpu_torch.cli bench

The twin of the reference's ``bench.py``.  Headline: the banded pair-HMM
forward kernel (``ops/pairhmm.py``, ``csrc/pairhmm.cu``) at P, WIN, W =
256, 512, 128 in consensus bases/s and band cells/s.  Beside it, the
Arrow splice (``ops/arrow.py::arrow_splice``: the sweep kernel plus the
torch splice assembly) at the polish's padded shape, in mutations/s and
pairs/s, and the banded edit-distance wavefront (``ops/banded_align.py``,
``csrc/banded_align.cu``) in cells/s at W=256 tglocal, P=256, 2048-base
query bucket.

Timing: K launches chained in one dispatch, each depending on the last
(the next input adds 0 * an element of the running sum), then summed.
The per-launch cost is the slope between a K- and a 2K-chained dispatch,
per_iter = (t2K - tK) / K, which cancels every fixed cost (intercept,
reported).  The two are timed in interleaved (tK, t2K) pairs over TRIALS
trials with CUDA events; the value is the median slope and
``spread_pct`` the relative half-range of the middle slopes.  The extra
elementwise launches of the chain (a few microseconds) are inside the
slope.

Roofline: ``pct_fp32_peak`` is the pair-HMM's band-cell rate times the
reference's 48 operations per cell (40 vector flops + 8 transcendentals,
``bench.py:45`` of the reference) over the published 67 TFLOP/s float32
peak of one H100 SXM (outside the tensor cores, at the full 700 W); the
card's name and power limit are printed beside it.  Cells are counted as
the data needs them: a pair's band stops at its (n, m) corner.

There is no CPU baseline (``vs_baseline`` is null) and no CPU fallback:
without a GPU the bench raises.
"""
from __future__ import annotations

import json
import subprocess

import numpy as np
import torch

P, WIN, W, K = 256, 512, 128, 20
SPLICE_K = 4                # a splice launch is ~10x heavier
TRIALS = 5
DP_W, DP_P, DP_BQ = 256, 256, 2048

# published peaks of one H100 SXM at 700 W
FP32_PEAK = 67e12           # float32 operations/s outside the tensor cores
INT32_PEAK = 132 * 64 * 1.98e9   # SMs x INT32 lanes x boost clock (16.7e12)
HBM_BYTES_PER_S = 3.35e12

# Operations per cell, counted from the reference's algorithm (not from a
# kernel's instructions); transcendentals count one each.
OPS_PER_CELL = {
    # ops/pallas_pairhmm.py: 40 vector flops + 8 transcendentals (the
    # reference bench's count)
    "pairhmm_forward": 48,
    # ops/banded_align.py:107-162, int32, what the edit recurrence needs
    # at an inner cell: the substitution test (q == t, q < 4, and: 3), the
    # three candidates (3 adds), 2 mins, the move code (2 compares, 2
    # selects) and its packing into the move word (shift, or: 2); the
    # boundary masks and the row-end min are per antidiagonal (below)
    "banded_wavefront": 14,
    # ops/banded_align.py:180-207 per step, int32: d, lo, w clip (4),
    # done (3), index (4), the move select (1), di and dj (8), i and j (2)
    "traceback": 22,
    # ops/arrow.py:153-218 per swept cell, averaged over the two sweeps
    # (57 forward, 75 backward) with the within-row D recurrence counted
    # as the sequential scan it computes (one logaddexp and one add)
    "arrow_splice": 66,
}

# ops/banded_align.py:125-151 per antidiagonal and pair, int32: the i >= 1
# guard at the band's low edge and the j >= 1 guard at the j = 0 cell (a
# compare and 2 selects each: 6), the valid mask at the i = n and j = m
# edges (2 compares and a select each: 6), the tglocal origin (2 compares
# and a select: 3) and the row-end min at the cell i = n (index, compare,
# 2 selects: 4)
WAVEFRONT_OPS_PER_ANTIDIAGONAL = 19

# scripts/ablate_pallas.py:29-58 per cell and step, by feature set: the
# plain-max step (2 max + em add for M, 1 max each for I and D, the out
# max: 6); shift adds 4 selects, load a compare and a select, lse turns
# the step into 7 constant subtractions, 4 logaddexps of 7 ops each
# (max, sub, abs, neg, exp, log1p, add), the em add and the out max
ABLATE_OPS_PER_CELL = {(): 6, ("shift",): 10, ("load",): 8, ("lse",): 37,
                       ("load", "lse", "shift"): 43}


def card_label() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def bound_ms(ops: float, nbytes: float, ops_per_s: float) -> tuple:
    """(least ms, "operations" or "bytes"): the larger of the operations
    over the peak rate of their type and the bytes over the memory rate."""
    t_ops = ops / ops_per_s
    t_bytes = nbytes / HBM_BYTES_PER_S
    if t_ops >= t_bytes:
        return 1e3 * t_ops, "operations"
    return 1e3 * t_bytes, "bytes"


def pairhmm_work(n, m, *, Dmax: int, W: int, LQG: int, LTG: int) -> dict:
    """Band cells, operations and bytes of one pair-HMM forward call."""
    n = np.asarray(n, np.int64)
    m = np.asarray(m, np.int64)
    P = len(n)
    cells = int(np.minimum(Dmax, n + m + 1).sum()) * W
    nbytes = P * (LQG + LTG) + 8 * P + 4 * P
    return {"cells": cells, "ops": cells * OPS_PER_CELL["pairhmm_forward"],
            "bytes": nbytes, "peak": FP32_PEAK}


def wavefront_work(n, m, *, Dmax: int, W: int, LQG: int, LTG: int,
                   want_bp: bool = True) -> dict:
    """DP cells, int32 operations and bytes of one wavefront call
    (antidiagonals past a pair's (n, m) corner are never needed)."""
    n = np.asarray(n, np.int64)
    m = np.asarray(m, np.int64)
    P = len(n)
    diags = int(np.minimum(Dmax, n + m + 1).sum())
    cells = diags * W
    nbytes = P * (LQG + LTG) + 8 * P + 12 * P
    if want_bp:
        nbytes += 4 * (-(-Dmax // 16)) * P * W
    ops = (cells * OPS_PER_CELL["banded_wavefront"]
           + diags * WAVEFRONT_OPS_PER_ANTIDIAGONAL)
    return {"cells": cells, "ops": ops, "bytes": nbytes, "peak": INT32_PEAK}


def traceback_work(n_moves: int, *, P: int, max_steps: int) -> dict:
    """Steps, int32 operations and bytes of one traceback call: one packed
    move word read per move taken, the (P, max_steps) moves written."""
    return {"cells": n_moves, "ops": n_moves * OPS_PER_CELL["traceback"],
            "bytes": 4 * n_moves + 8 * P + P * max_steps,
            "peak": INT32_PEAK}


def arrow_work(n, m, *, Lq: int, LJ: int, C: int) -> dict:
    """Swept cells, operations and bytes of one Arrow sweep call: rows
    0..n and columns 0..m of each pair, forward and backward; the sweeps'
    outputs written in full."""
    n = np.asarray(n, np.int64)
    m = np.asarray(m, np.int64)
    P = len(n)
    R = Lq + 1
    cells = 2 * int(((n + 1) * (m + 1)).sum())
    nbytes = (P * (Lq + LJ) + 8 * P + 4 * P * C + 40 * P
              + 4 * P * C * R * (3 + 2 * 3) + 4 * P)
    return {"cells": cells, "ops": cells * OPS_PER_CELL["arrow_splice"],
            "bytes": nbytes, "peak": FP32_PEAK}


def ablate_work(feats, *, P: int, Dmax: int, W: int, LQG: int) -> dict:
    """Cells, operations and bytes of one ablation call: every step of
    every row runs; the int32 rows and the (P, W) start read once, the
    (P, W) maxima written."""
    cells = P * Dmax * W
    return {"cells": cells,
            "ops": cells * ABLATE_OPS_PER_CELL[tuple(sorted(feats))],
            "bytes": 4 * P * LQG + 8 * P * W, "peak": FP32_PEAK}


def pct_fp32_peak(cells_per_s: float) -> float:
    """The pair-HMM's operation rate as a share of the fp32 peak, %."""
    return 100.0 * cells_per_s * OPS_PER_CELL["pairhmm_forward"] / FP32_PEAK


def slope_stats(pairs, k: int) -> tuple:
    """(per_iter, intercept, spread_pct) from interleaved (tK, t2K) timing
    pairs: the median slope, the median intercept, and the trimmed
    relative half-range of the slopes (the reference's arithmetic)."""
    slopes, icpts = [], []
    for tK, t2K in pairs:
        s = max((t2K - tK) / k, 1e-9)
        slopes.append(s)
        icpts.append(max(tK - k * s, 0.0))
    slopes.sort()
    mid = slopes[len(slopes) // 2]
    trim = slopes[1:-1] if len(slopes) >= 3 else slopes
    spread = 100.0 * (trim[-1] - trim[0]) / (2 * mid)
    return mid, float(np.median(icpts)), spread


def _time_once(chained, k: int) -> float:
    """Seconds of one k-chained dispatch on the card (CUDA events)."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    v = chained(k)
    b.record()
    torch.cuda.synchronize()
    if not bool(torch.isfinite(v)):
        raise RuntimeError("chained dispatch gave a non-finite sum")
    return a.elapsed_time(b) / 1e3


def _slope(chained, k: int) -> tuple:
    _time_once(chained, k), _time_once(chained, 2 * k)       # warm-up
    pairs = [(_time_once(chained, k), _time_once(chained, 2 * k))
             for _ in range(TRIALS)]
    return slope_stats(pairs, k)


def _measure_pairhmm(dev) -> dict:
    from .ops.banded_align import build_schedule, prepare_batch
    from .ops.pairhmm import pairhmm_forward, params_vector
    rng = np.random.default_rng(0)
    q = rng.integers(0, 4, size=(P, WIN)).astype(np.int8)
    t = rng.integers(0, 4, size=(P, WIN)).astype(np.int8)
    n = np.full(P, WIN - 12, np.int32)
    m = np.full(P, WIN - 10, np.int32)
    qg, trg, G = prepare_batch(q, t, W)
    Dmax, lo = build_schedule(WIN, WIN, W)
    qg_d, trg_d, n_d, m_d = (torch.from_numpy(x).to(dev)
                             for x in (qg, trg, n, m))
    pvec = params_vector()

    def chained(k):
        acc = torch.zeros(P, dtype=torch.float32, device=dev)
        for _ in range(k):
            qg2 = qg_d + (acc[0] * 0).to(torch.int8)
            acc = acc + pairhmm_forward(qg2, trg_d, n_d, m_d, lo, pvec, W=W,
                                        Lt=WIN, G=G)
        return acc.sum()

    per_iter, icpt, spread = _slope(chained, K)
    work = pairhmm_work(n, m, Dmax=Dmax, W=W, LQG=qg.shape[1],
                        LTG=trg.shape[1])
    return {"bases_per_s": P * (WIN - 12) / per_iter,
            "cells_per_s": work["cells"] / per_iter,
            "ms": 1e3 * per_iter, "intercept_s": icpt, "spread_pct": spread,
            "work": work}


def _measure_splice(dev) -> dict:
    from .models.polisher import PolisherConfig
    from .ops.arrow import arrow_splice
    from .ops.pairhmm import params_vector
    pc = PolisherConfig()
    cap, Ps, C = pc.len_cap(), 512, pc.arrow_candidates
    rng = np.random.default_rng(1)
    q = rng.integers(0, 4, size=(Ps, cap)).astype(np.int8)
    t = rng.integers(0, 4, size=(Ps, cap)).astype(np.int8)
    n = np.full(Ps, 360, np.int32)             # typical window segment
    m = np.full(Ps, 384, np.int32)
    cand = np.tile(np.arange(C, dtype=np.int32)[None, :] * 37 + 11, (Ps, 1))
    pv = np.tile(params_vector(), (Ps, 1)).astype(np.float32)
    q_d, t_d, n_d, m_d, cand_d, pv_d = (torch.from_numpy(x).to(dev)
                                        for x in (q, t, n, m, cand, pv))

    def chained(k):
        acc = torch.zeros((Ps, 1), dtype=torch.float32, device=dev)
        for _ in range(k):
            pv2 = pv_d + (acc * 0)[0, 0]
            _cur, mut = arrow_splice(q_d, t_d, n_d, m_d, cand_d, pv2, C=C)
            acc = acc + mut.sum(dim=(1, 2))[:, None]
        return acc.sum()

    per_iter, _icpt, spread = _slope(chained, SPLICE_K)
    return {"mutations_per_s": Ps * C * 9 / per_iter,
            "pairs_per_s": Ps / per_iter, "ms": 1e3 * per_iter,
            "spread_pct": spread,
            "work": arrow_work(n, m, Lq=cap, LJ=cap, C=C)}


def _dp_batch(seed: int):
    """DP_P seeded tglocal (query, target) pairs in the DP_BQ query bucket
    (half exact, half at 15% error), cut as BandedAligner.dispatch cuts
    the schedule.  Returns (qg, trg, n, m, lo, G, Lt)."""
    from .models.aligner import _t_bucket
    from .ops.banded_align import build_schedule, prepare_batch
    from .utils.simulate import mutate_read, random_genome
    rng = np.random.default_rng(seed)
    qs, ts = [], []
    for k in range(DP_P):
        L = int(rng.integers(DP_BQ // 2 + 1, DP_BQ + 1))
        pad = int(rng.integers(40, 300))
        t = random_genome(L + pad, int(rng.integers(1 << 30)))
        off = int(rng.integers(0, pad))
        err = 0.0 if k < DP_P // 2 else 0.15
        qs.append(mutate_read(t[off : off + L], err, rng)[:DP_BQ])
        ts.append(t)
    bt = _t_bucket(max(len(x) for x in ts), DP_BQ)
    q = np.full((DP_P, DP_BQ), 4, np.int8)
    t = np.full((DP_P, bt), 4, np.int8)
    for k, (a, b) in enumerate(zip(qs, ts)):
        q[k, : len(a)] = a
        t[k, : len(b)] = b
    n = np.array([len(a) for a in qs], np.int32)
    m = np.array([len(b) for b in ts], np.int32)
    Dmax, lo = build_schedule(DP_BQ, bt, DP_W)
    need = int((n + m).max()) + 1
    lo = lo[: min(Dmax, -(-need // 1024) * 1024)]
    qg, trg, G = prepare_batch(q, t, DP_W)
    return qg, trg, n, m, lo, G, bt


def _measure_editdp(dev) -> dict:
    from .ops.banded_align import banded_align_batch
    qg, trg, n, m, lo, G, Lt = _dp_batch(2048)
    qg_d, trg_d, n_d, m_d = (torch.from_numpy(x).to(dev)
                             for x in (qg, trg, n, m))

    def chained(k):
        acc = torch.zeros(DP_P, dtype=torch.int32, device=dev)
        for _ in range(k):
            qg2 = qg_d + (acc[0] * 0).to(torch.int8)
            r = banded_align_batch(qg2, trg_d, n_d, m_d, lo, W=DP_W, Lt=Lt,
                                   G=G, mode="tglocal")
            acc = acc + r["dist"]
        return acc.sum().float()

    per_iter, _icpt, spread = _slope(chained, K)
    work = wavefront_work(n, m, Dmax=len(lo), W=DP_W, LQG=qg.shape[1],
                          LTG=trg.shape[1])
    return {"cells_per_s": work["cells"] / per_iter, "ms": 1e3 * per_iter,
            "spread_pct": spread, "Dmax": len(lo), "work": work}


def run() -> dict:
    """Measure the three kernels on the GPU (raises without one) and
    return the bench line as a dict."""
    from .device import resolve
    dev = resolve("cuda")
    card = card_label()
    hmm = _measure_pairhmm(dev)
    splice = _measure_splice(dev)
    dp = _measure_editdp(dev)
    return {
        "metric": "consensus_bases_per_sec_per_chip",
        "value": round(hmm["bases_per_s"], 1),
        "unit": "bases/s",
        "vs_baseline": None,
        "gcells_per_sec": round(hmm["cells_per_s"] / 1e9, 3),
        "pct_fp32_peak": round(pct_fp32_peak(hmm["cells_per_s"]), 3),
        "card": card,
        "device": {"platform": "gpu",
                   "kind": torch.cuda.get_device_name(dev),
                   "count": torch.cuda.device_count()},
        "pairhmm_ms": round(hmm["ms"], 4),
        "dispatch_s_intercept": round(hmm["intercept_s"], 5),
        "spread_pct": round(hmm["spread_pct"], 2),
        "trials": TRIALS,
        "splice_mutations_per_sec": round(splice["mutations_per_s"], 1),
        "splice_pairs_per_sec": round(splice["pairs_per_s"], 1),
        "splice_ms": round(splice["ms"], 4),
        "splice_spread_pct": round(splice["spread_pct"], 2),
        "editdp_gcells_per_sec": round(dp["cells_per_s"] / 1e9, 3),
        "editdp_ms": round(dp["ms"], 4),
        "editdp_Dmax": dp["Dmax"],
        "editdp_spread_pct": round(dp["spread_pct"], 2),
    }


def main() -> int:
    print(json.dumps(run()))
    return 0

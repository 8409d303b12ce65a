"""Timing of the banded edit-DP wavefront and traceback kernels on one
NVIDIA GPU, at the main path's shape and around it.

    python -m falcon_unzip_tpu_torch.scripts.tune_banded [--W 128|256|512]
    python falcon_unzip_tpu_torch/scripts/tune_banded.py --root OTHER_CHECKOUT

At W=256 (or --W), tglocal, query bucket 2048 (the shape of the overlap
and placement alignments; P seeded pairs, half exact and half at 15% error,
query lengths in (1024, 2048], the schedule cut as
``BandedAligner.dispatch`` cuts it) it prints one JSON line with

* the wavefront's ms a launch, checked bit-exact against the plain
  version first (P=256);
* the traceback's ms a launch in its three epilogues (moves, packed,
  summary), each bit-exact against its plain composition, beside the ms
  of the torch chains they replace (``pack_moves2`` + ``_combine_results``
  and ``_summarize_moves`` on the kernel's moves);
* both kernels' ms a launch and microseconds a pair at P = 256, 512, 1024
  and 2048 (what a larger batch would buy);
* the card's name and power limit.

``--root`` times another checkout's package (one whose traceback has
only the moves, for example) with the same inputs, so that two designs
are compared inside one run on one card.
Times are CUDA events over REPS launches after a warm-up.  Needs a GPU.
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import sys

import numpy as np
import torch

if __name__ == "__main__":      # run as a file: this checkout first
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
from falcon_unzip_tpu_torch.scripts.common import load_package, time_ms

MODE, BQ = "tglocal", 2048
REPS = 10


def _inputs(pkg, P: int, seed: int, W: int):
    """Device tensors and the cut schedule for P seeded pairs."""
    ba = pkg["ba"]
    rng = np.random.default_rng(seed)
    qs, ts = [], []
    for k in range(P):
        L = int(rng.integers(BQ // 2 + 1, BQ + 1))
        pad = int(rng.integers(40, 300))
        t = pkg["random_genome"](L + pad, int(rng.integers(1 << 30)))
        off = int(rng.integers(0, pad))
        qs.append(pkg["mutate_read"](t[off : off + L],
                                     0.0 if k < P // 2 else 0.15, rng)[:BQ])
        ts.append(t)
    bt = pkg["t_bucket"](max(len(x) for x in ts), BQ)
    q = np.full((P, BQ), 4, np.int8)
    t = np.full((P, bt), 4, np.int8)
    for k in range(P):
        q[k, : len(qs[k])] = qs[k]
        t[k, : len(ts[k])] = ts[k]
    n = np.array([len(x) for x in qs], np.int32)
    m = np.array([len(x) for x in ts], np.int32)
    Dmax, lo = ba.build_schedule(BQ, bt, W)
    Dmax = min(Dmax, -(-(int((n + m).max()) + 1) // 1024) * 1024)
    lo = lo[:Dmax]
    qg, trg, G = ba.prepare_batch(q, t, W)
    dev = torch.device("cuda")
    args = tuple(torch.from_numpy(x).to(dev) for x in (qg, trg, n, m))
    return args, lo, dict(W=W, Lt=bt, G=G, mode=MODE), Dmax


def measure(pkg, W: int = 256) -> dict:
    ba, kn = pkg["ba"], pkg["kernels"]
    has_epi = "epilogue" in inspect.signature(kn.traceback).parameters
    args, lo, kw, Dmax = _inputs(pkg, 256, 2024, W)
    steps = Dmax - 1
    plain = ba.banded_align_batch_plain(*args, lo, **kw)
    out = {"shape": {"W": W, "mode": MODE, "bq": BQ, "P": 256, "Dmax": Dmax},
           "traceback_ms": {}, "torch_chain_ms": {}, "by_P": {}}
    got = kn.banded_wavefront(*args, Dmax=Dmax, want_bp=True, **kw)
    for key in ("dist", "end_i", "end_j", "bp"):
        if not torch.equal(got[key], plain[key]):
            raise SystemExit(f"wavefront {key} differs")
    out["wavefront_ms"] = time_ms(lambda: kn.banded_wavefront(
        *args, Dmax=Dmax, want_bp=True, **kw), REPS, spin=False)
    ends = (plain["end_i"], plain["end_j"])
    moves_p = ba.traceback_batch_plain(plain["bp"], lo, *ends,
                                       max_steps=steps)
    moves = ba.traceback_batch(plain["bp"], lo, *ends, max_steps=steps)
    if not torch.equal(moves, moves_p):
        raise SystemExit("traceback moves differ")
    out["traceback_ms"]["moves"] = time_ms(lambda: ba.traceback_batch(
        plain["bp"], lo, *ends, max_steps=steps), REPS, spin=False)
    out["torch_chain_ms"]["packed"] = time_ms(lambda: ba._combine_results(
        ba.pack_moves2(moves), plain["dist"], *ends), REPS, spin=False)
    out["torch_chain_ms"]["summary"] = time_ms(lambda: ba._summarize_moves(
        moves, plain["dist"], *ends), REPS, spin=False)
    if has_epi:
        for name in ("packed", "summary"):
            fused = getattr(ba, f"traceback_{name}")
            want = getattr(ba, f"traceback_{name}_plain")(
                plain["bp"], lo, plain["dist"], *ends, max_steps=steps)
            got = fused(plain["bp"], lo, plain["dist"], *ends,
                        max_steps=steps)
            if not torch.equal(got, want):
                raise SystemExit(f"traceback {name} epilogue differs")
            out["traceback_ms"][name] = time_ms(lambda: fused(
                plain["bp"], lo, plain["dist"], *ends, max_steps=steps),
                REPS, spin=False)
    for P in (256, 512, 1024, 2048):
        a, lo_p, kw_p, D = _inputs(pkg, P, 2024 + P, W)
        res = kn.banded_wavefront(*a, Dmax=D, want_bp=True, **kw_p)
        wf = time_ms(lambda: kn.banded_wavefront(*a, Dmax=D, want_bp=True,
                                                 **kw_p), REPS, spin=False)
        tb = time_ms(lambda: ba.traceback_batch(
            res["bp"], lo_p, res["end_i"], res["end_j"], max_steps=D - 1),
            REPS, spin=False)
        out["by_P"][str(P)] = {
            "Dmax": D, "wavefront_ms": wf, "wavefront_us_per_pair":
            1e3 * wf / P, "traceback_ms": tb, "traceback_us_per_pair":
            1e3 * tb / P}
    out["card"] = pkg["card_label"]()
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--W", type=int, default=256, help="band width")
    ap.add_argument("--root", default=None,
                    help="time the package of this checkout instead")
    args = ap.parse_args(argv)
    load_package(args.root)
    from falcon_unzip_tpu_torch.bench import card_label
    from falcon_unzip_tpu_torch.models.aligner import _t_bucket
    from falcon_unzip_tpu_torch.ops import _kernels
    from falcon_unzip_tpu_torch.ops import banded_align as ba
    from falcon_unzip_tpu_torch.utils.simulate import (mutate_read,
                                                       random_genome)
    if not torch.cuda.is_available():
        raise RuntimeError("tune_banded needs a CUDA device")
    pkg = {"ba": ba, "kernels": _kernels, "card_label": card_label,
           "t_bucket": _t_bucket, "mutate_read": mutate_read,
           "random_genome": random_genome}
    res = measure(pkg, args.W)
    res["package"] = os.path.dirname(os.path.dirname(
        os.path.abspath(ba.__file__)))
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()

"""Ablation timing of the pair-HMM step on one NVIDIA GPU.

    python -m falcon_unzip_tpu_torch.scripts.ablate_pairhmm
    python falcon_unzip_tpu_torch/scripts/ablate_pairhmm.py --root OTHER_CHECKOUT

The twin of the reference's ``scripts/ablate_pallas.py``: the
antidiagonal step of the pair-HMM forward cut to its parts (band shift,
windowed base load, logaddexp; ``ops/pairhmm_ablate.py``) and timed one
feature set at a time through the kernel of ``csrc/pairhmm_ablate.cu``,
at the same constants (P=256 rows, W=128, Dmax=1025, LQG=1024, seeded
int32 bases 0..4).  Each set is timed twice: from the reference's start
(every state plane NEG, so every exp and log1p sees the same argument)
and from a seeded finite start (``seeded_init``: the values vary as in a
real forward).  Each time is taken with ``common.time_ms`` over REPS
launches, queued behind a spin of the card so that the host's time a
call does not show, and printed in ms and microseconds per antidiagonal
step beside the set's SFU floor (``bench.ablate_work``) and the card's
name and power limit.  The kernel is held against its plain version by
``chip_smoke.py`` and the GPU tests, not here.

``--root`` times another checkout's package (it needs only
``ops.pairhmm_ablate``) with the same inputs, so that two designs are
compared inside one run on one card; the SFU floors come from this
checkout.  Needs a GPU: without one it raises.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

if __name__ == "__main__":      # run as a file: this checkout first
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
from falcon_unzip_tpu_torch.scripts.common import load_package, time_ms

P, W, Dmax, LQG = 256, 128, 1025, 1024
REPS = 20


def rows(seed: int = 0) -> np.ndarray:
    """The (P, LQG) int32 bases of the reference script (values 0..4)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 5, size=(P, LQG)).astype(np.int32)


def measure(pa=None) -> list:
    """[{feats, ms, us_per_step, ms_seeded, us_per_step_seeded}] for the
    five feature sets on the card: ms from the NEG start, ms_seeded from
    the seeded one.  ``pa`` is the ``ops.pairhmm_ablate`` module timed
    (this package's by default)."""
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the ablation needs a GPU")
    if pa is None:
        from falcon_unzip_tpu_torch.ops import pairhmm_ablate as pa
    dev = torch.device("cuda")
    qg = torch.from_numpy(rows()).to(dev)
    starts = {"": torch.from_numpy(pa.neg_init(P, W)).to(dev),
              "_seeded": torch.from_numpy(pa.seeded_init(P, W, 0)).to(dev)}
    out = []
    for feats in pa.FEATURE_SETS:
        r = {"feats": list(feats)}
        for tag, init in starts.items():
            ms = time_ms(lambda: pa.pairhmm_ablate(qg, init, feats,
                                                   Dmax=Dmax), REPS)
            r["ms" + tag] = ms
            r["us_per_step" + tag] = 1e3 * ms / Dmax
        out.append(r)
    return out


def main(argv=()) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=None,
                    help="time the package of this checkout instead")
    args = ap.parse_args(argv)
    # the work counts come from this checkout whichever package is timed
    from falcon_unzip_tpu_torch import bench
    load_package(args.root)
    from falcon_unzip_tpu_torch.ops import pairhmm_ablate as pa
    res = measure(pa)
    card = bench.card_label()
    package = os.path.dirname(os.path.dirname(os.path.abspath(pa.__file__)))
    for r in res:
        r["sfu_ms"] = bench.ablate_work(r["feats"], P=P, Dmax=Dmax, W=W,
                                        LQG=LQG)["sfu_ms"]
        print(f"{tuple(r['feats'])}: {r['ms']:.4f} ms "
              f"({r['us_per_step']:.4f} us/step for {P} rows) from NEG, "
              f"{r['ms_seeded']:.4f} ms ({r['us_per_step_seeded']:.4f} "
              f"us/step) from the seeded start, SFU floor "
              f"{r['sfu_ms']:.4f} ms | {package} | {card}", flush=True)
    return res


if __name__ == "__main__":
    main(sys.argv[1:])

"""Timing of the Arrow splice sweep kernel on one NVIDIA GPU, at the
polish's shapes, with the seeded batches of ``utils/arrow_batches.py``.

    python -m falcon_unzip_tpu_torch.scripts.tune_arrow
    python falcon_unzip_tpu_torch/scripts/tune_arrow.py --root OTHER_CHECKOUT

At Lq = LJ = 640 and C = 4 (the polish's pinned splice shape; read and
template lengths 300-420, reads at 0, 5 and 15% error in turn) it
prints one JSON line with

* the kernel's raw outputs (afM, afI, afD, bM, bD, ll_cur) checked against
  ``arrow_sweeps_plain`` at P = 16, 64, 256 and 512 (the launch sizes of
  the hotspot polish and of the production chunk), per-pair and per-base
  tiers, within ``|kernel - plain| <= 1e-3 * max(1, |plain|)`` with NEG
  slots equal;
* the kernel's ms a launch at each P in both modes, and the warps a block
  each P launches with;
* the card's name and power limit.

``--root`` times another checkout's package with the same inputs (it
needs only ``ops.arrow``, ``ops._kernels`` and the simulator), so that two
designs are compared inside one run on one card.  Times are CUDA events
over REPS launches after a warm-up.  Needs a GPU.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

if __name__ == "__main__":      # run as a file: this checkout first
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
from falcon_unzip_tpu_torch.scripts.common import load_package, time_ms

L, C = 640, 4
PS = (16, 64, 256, 512)
REPS = 10


def measure(ar, kn, ab) -> dict:
    dev = torch.device("cuda")
    warps = getattr(kn, "arrow_warps", None)   # absent in older packages
    out = {"shape": {"Lq": L, "LJ": L, "C": C}, "max_rel_err": {}, "ms": {},
           "warps": {P: warps(P) if warps else None for P in PS}}
    rng = np.random.default_rng(2026)
    batches = {P: ab.pack(rng, ab.polish_specs(rng, P, LJ=L, C=C), Lq=L,
                          LJ=L, C=C) for P in PS}
    for mode in ("per-pair", "per-base"):
        for P in PS:
            a = ab.to_device(batches[P], mode, dev)
            got = kn.arrow_sweeps(*a, C=C)
            want = ar.arrow_sweeps_plain(*a, C=C)
            err = max(ab.max_rel_err(g, w) for g, w in zip(got, want))
            out["max_rel_err"][f"{mode} P={P}"] = err
            if not err <= 1e-3:
                raise SystemExit(f"{mode} P={P}: rel err {err} over 1e-3")
            out["ms"][f"{mode} P={P}"] = time_ms(
                lambda: kn.arrow_sweeps(*a, C=C), REPS, spin=False)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=None,
                    help="time the package of this checkout instead")
    args = ap.parse_args(argv)
    # the batches come from this checkout whichever package is timed
    from falcon_unzip_tpu_torch.utils import arrow_batches as ab
    load_package(args.root)
    from falcon_unzip_tpu_torch.bench import card_label
    from falcon_unzip_tpu_torch.ops import _kernels
    from falcon_unzip_tpu_torch.ops import arrow as ar
    if not torch.cuda.is_available():
        raise RuntimeError("tune_arrow needs a CUDA device")
    res = measure(ar, _kernels, ab)
    res["card"] = card_label()
    res["package"] = os.path.dirname(os.path.dirname(
        os.path.abspath(ar.__file__)))
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()

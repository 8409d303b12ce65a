"""Timing of the banded pair-HMM forward kernel on one NVIDIA GPU, with the
seeded batches of ``utils/hmm_batches.py``.

    python -m falcon_unzip_tpu_torch.scripts.tune_pairhmm
    python falcon_unzip_tpu_torch/scripts/tune_pairhmm.py --root OTHER_CHECKOUT
    ... --shape P:Lq:Lt:W   (repeatable: a further shape, e.g. a polish's)
    ... --cells 1|2         (W = 128 launched with that many cells a lane)

At 512-base windows (templates of 400-500 bases, half the reads exact
copies, half at 15% error: the shape of ``cli bench``) it prints one JSON
line with

* the kernel's log-likelihoods checked against ``pairhmm_forward_plain``
  at W = 64, 128, 256 and P = 16, 64, 256, 1024, 4096, within
  ``|kernel - plain| <= 1e-3 * max(1, |plain|)`` with the out-of-band pairs
  equal;
* the kernel's ms a launch at each (W, P), beside its bound and its SFU
  floor (``bench.pairhmm_work``);
* the card's name and power limit.

A ``--shape`` adds P pairs of Lq-base reads and Lt-base templates (reads
within 10% of the template's length) at band width W.  ``--cells`` launches
every W = 128 case with the given cells a lane (W = 128 has both builds; the
launch otherwise picks one from P) through ``fu_pairhmm_forward_cells``, so
that the two are timed against each other at any P.  ``--root`` times
another checkout's package with the same inputs (it needs only
``ops.pairhmm``), so that two designs are compared inside one run on one
card.  Times are CUDA events over REPS launches after a warm-up.  Needs a
GPU.
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

WIN = 512
WS = (64, 128, 256)
PS = (16, 64, 256, 1024, 4096)
REPS = 10


def _shape_batch(hb, P: int, Lq: int, Lt: int) -> dict:
    """P seeded pairs filling Lq / Lt: templates of 0.9 Lt .. Lt bases,
    reads at 0 / 15% error cut to Lq."""
    b = hb.bench_batch(P + Lq + Lt, P, max(Lq, Lt),
                       tlen=(max(1, (9 * Lt) // 10), Lt + 1))
    b["q"] = np.ascontiguousarray(b["q"][:, :Lq])
    b["t"] = np.ascontiguousarray(b["t"][:, :Lt])
    b["n"] = np.minimum(b["n"], Lq).astype(np.int32)
    b["Dmax"] = Lq + Lt + 1
    return b


def _forward_cells(kn, cells: int, args, kw) -> torch.Tensor:
    """The forward of ``ops.pairhmm.pairhmm_forward``'s arguments launched
    with ``cells`` cells a lane."""
    qg, trg, n, m, lo, pvec = args
    ll = torch.empty(qg.shape[0], dtype=torch.float32, device=qg.device)
    code = kn._load()["pairhmm"].fu_pairhmm_forward_cells(
        cells, qg.data_ptr(), trg.data_ptr(), n.data_ptr(), m.data_ptr(),
        qg.shape[0], qg.shape[1], trg.shape[1], kw["Lt"], kw["G"], len(lo),
        kw["W"], *[float(x) for x in pvec], ll.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    kn._check(code, "fu_pairhmm_forward_cells")
    return ll


def measure(ph, hb, bench, shapes, cells: int = 0) -> dict:
    dev = torch.device("cuda")
    pvec = ph.params_vector()
    out = {"window": WIN, "max_rel_err": {}, "ms": {}, "bound_ms": {},
           "sfu_floor_ms": {}}
    cases = [(f"W={W} P={P}", W, hb.bench_batch(2025 + P, P, WIN))
             for W in WS for P in PS]
    cases += [(f"W={W} P={P} Lq={Lq} Lt={Lt}", W, _shape_batch(hb, P, Lq, Lt))
              for P, Lq, Lt, W in shapes]
    for key, W, b in cases:
        args, kw = hb.to_device(b, W, pvec, dev)
        if cells and W == 128:
            from falcon_unzip_tpu_torch.ops import _kernels as kn
            fwd = lambda: _forward_cells(kn, cells, args, kw)
        else:
            fwd = lambda: ph.pairhmm_forward(*args, **kw)
        got = fwd()
        want = ph.pairhmm_forward_plain(*args, **kw)
        err = hb.max_rel_err(got, want)
        out["max_rel_err"][key] = err
        if not err <= 1e-3:
            raise SystemExit(f"{key}: rel err {err} over 1e-3")
        out["ms"][key] = time_ms(fwd, REPS, spin=False)
        work = bench.pairhmm_work(b["n"], b["m"], Dmax=b["Dmax"], W=W,
                                  LQG=args[0].shape[1], LTG=args[1].shape[1])
        out["bound_ms"][key] = bench.bound_ms(work["ops"], work["bytes"],
                                              work["peak"])[0]
        out["sfu_floor_ms"][key] = work["sfu_ms"]
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=None,
                    help="time the package of this checkout instead")
    ap.add_argument("--shape", action="append", default=[],
                    help="P:Lq:Lt:W, a further shape to check and time")
    ap.add_argument("--cells", type=int, choices=(1, 2), default=0,
                    help="launch W = 128 with this many cells a lane")
    args = ap.parse_args(argv)
    shapes = [tuple(int(x) for x in s.split(":")) for s in args.shape]
    # the batches and the work counts come from this checkout whichever
    # package is timed
    from falcon_unzip_tpu_torch import bench
    from falcon_unzip_tpu_torch.utils import hmm_batches as hb
    load_package(args.root)
    from falcon_unzip_tpu_torch.ops import pairhmm as ph
    if not torch.cuda.is_available():
        raise RuntimeError("tune_pairhmm needs a CUDA device")
    res = measure(ph, hb, bench, shapes, args.cells)
    res["cells"] = args.cells
    res["card"] = bench.card_label()
    res["package"] = os.path.dirname(os.path.dirname(
        os.path.abspath(ph.__file__)))
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()

"""Timing of the banded edit-DP wavefront and traceback kernels on one
NVIDIA GPU, at the main path's shape and around it.

    python -m falcon_unzip_tpu_torch.scripts.tune_banded [--W 128|256|512]
    python falcon_unzip_tpu_torch/scripts/tune_banded.py --root OTHER_CHECKOUT
    python -m falcon_unzip_tpu_torch.scripts.tune_banded --layouts
    python -m falcon_unzip_tpu_torch.scripts.tune_banded --build-only \
        [--root OTHER_CHECKOUT]

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

``--layouts`` times the candidate (C cells a lane, NW warps) layouts of
the wide bands against each other at the same shape: the wavefront source
is built once more with ``-DFU_WAVEFRONT_CANDIDATES`` (an entry point
that launches any candidate) into ``_build/candidates/``; each candidate
is checked bit-exact against the plain version, then timed beside the
package's own build at that width and at a ragged width just below it.

``--build-only`` compiles each CUDA source of the package (``--root``'s,
or this one's) alone with the package's nvcc flags into a temporary
directory and prints the seconds each took.
Times are CUDA events over REPS launches after a warm-up.  Needs a GPU.
"""
from __future__ import annotations

import argparse
import ctypes
import inspect
import json
import os
import subprocess
import sys
import tempfile
import time

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


# the candidate layouts (C, NW) of each wide band width, 32 C NW == W
CANDIDATES = {768: ((6, 4), (3, 8)), 1024: ((8, 4), (4, 8)),
              1536: ((6, 8), (3, 16)),
              2048: ((8, 8), (4, 16), (2, 32)), 3072: ((6, 16), (3, 32)),
              4096: ((8, 16), (4, 32))}


def _candidate_lib(kn):
    """The wavefront source built with its candidate layouts' entry."""
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(kn.__file__))), "csrc", "banded_align.cu")
    out_dir = os.path.join(kn.BUILD_DIR, "candidates")
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, "libbanded_candidates.so")
    t0 = time.perf_counter()
    subprocess.run([kn._nvcc(), *kn.NVCC_FLAGS, "-DFU_WAVEFRONT_CANDIDATES",
                    "-o", lib_path, src], check=True, capture_output=True)
    build_s = time.perf_counter() - t0
    lib = ctypes.CDLL(lib_path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.fu_banded_wavefront_layout.argtypes = (
        [ci, ci, vp, vp, vp, vp] + [ci] * 8 + [vp] * 5)
    lib.fu_banded_wavefront_layout.restype = ci
    return lib, build_s


def measure_layouts(pkg) -> dict:
    """Each candidate layout's wavefront ms a launch at P = 256 (checked
    bit-exact first), the package's own build at that width and at a
    ragged width 100 below it."""
    ba, kn = pkg["ba"], pkg["kernels"]
    lib, build_s = _candidate_lib(kn)
    out = {"shape": {"mode": MODE, "bq": BQ, "P": 256},
           "candidates_build_s": build_s, "by_W": {}}
    for W, layouts in CANDIDATES.items():
        args, lo, kw, Dmax = _inputs(pkg, 256, 2024, W)
        plain = ba.banded_align_batch_plain(*args, lo, **kw)
        P = args[0].shape[0]
        row = {"Dmax": Dmax, "layouts": {}}
        for C, NW in layouts:
            res = {k: torch.empty_like(plain[k]) for k in plain}
            stream = torch.cuda.current_stream()

            def launch():
                code = lib.fu_banded_wavefront_layout(
                    C, NW, *(a.data_ptr() for a in args), P,
                    args[0].shape[1], args[1].shape[1], kw["Lt"], kw["G"],
                    Dmax, W, kn.MODES[MODE], res["bp"].data_ptr(),
                    res["dist"].data_ptr(), res["end_i"].data_ptr(),
                    res["end_j"].data_ptr(), stream.cuda_stream)
                if code != 0:
                    raise RuntimeError(f"layout ({C}, {NW}): CUDA error "
                                       f"{code}")
            launch()
            for key in ("dist", "end_i", "end_j", "bp"):
                if not torch.equal(res[key], plain[key]):
                    raise SystemExit(f"layout ({C}, {NW}) W={W}: {key} "
                                     "differs")
            row["layouts"][f"{C}x{NW}"] = time_ms(launch, REPS, spin=False)
        row["package_ms"] = time_ms(lambda: kn.banded_wavefront(
            *args, Dmax=Dmax, want_bp=True, **kw), REPS, spin=False)
        Wr = W - 100
        a_r, lo_r, kw_r, D_r = _inputs(pkg, 256, 2024, Wr)
        got = kn.banded_wavefront(*a_r, Dmax=D_r, want_bp=True, **kw_r)
        want = ba.banded_align_batch_plain(*a_r, lo_r, **kw_r)
        for key in ("dist", "end_i", "end_j", "bp"):
            if not torch.equal(got[key], want[key]):
                raise SystemExit(f"ragged W={Wr}: {key} differs")
        row[f"package_ms_W{Wr}"] = time_ms(lambda: kn.banded_wavefront(
            *a_r, Dmax=D_r, want_bp=True, **kw_r), REPS, spin=False)
        out["by_W"][str(W)] = row
        print(json.dumps({str(W): row}), flush=True)
    out["card"] = pkg["card_label"]()
    return out


def build_seconds(kn) -> dict:
    """Seconds of nvcc for each CUDA source of the package alone."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for src in kn.SOURCES:
            t0 = time.perf_counter()
            subprocess.run([kn._nvcc(), *kn.NVCC_FLAGS, "-o",
                            os.path.join(tmp, "lib.so"), src], check=True,
                           capture_output=True)
            out[os.path.basename(src)] = time.perf_counter() - t0
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--W", type=int, default=256, help="band width")
    ap.add_argument("--root", default=None,
                    help="time the package of this checkout instead")
    ap.add_argument("--layouts", action="store_true",
                    help="time the wide bands' candidate layouts")
    ap.add_argument("--build-only", action="store_true",
                    help="time each source's nvcc build alone")
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
    if args.build_only:
        res = {"build_s": build_seconds(_kernels)}
    elif args.layouts:
        res = measure_layouts(pkg)
    else:
        res = measure(pkg, args.W)
    res["package"] = os.path.dirname(os.path.dirname(
        os.path.abspath(ba.__file__)))
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()

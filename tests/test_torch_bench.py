"""The port's kernel bench: its arithmetic, on fixed inputs, and its refusal
to run without a GPU.

The slope, intercept and spread of ``falcon_unzip_tpu_torch.bench`` must
equal the reference bench's on the same timings (the reference's
``_slope`` fed through a stubbed clock); the cell, byte and operation
counts that feed the bounds and the roofline share are checked against
hand counts; ``bench`` (module, command line) and ``ablate_pairhmm``
raise where CUDA is not available.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

from falcon_unzip_tpu_torch import bench
from falcon_unzip_tpu_torch.ops.banded_align import build_schedule
from falcon_unzip_tpu_torch.scripts import ablate_pairhmm

REF_BENCH = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                         "bench.py")

TIMINGS = [(0.131, 0.262), (0.129, 0.255), (0.140, 0.281), (0.128, 0.259),
           (0.135, 0.266)]


def _ref_bench():
    spec = importlib.util.spec_from_file_location("_ref_bench", REF_BENCH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_slope_stats_equal_the_reference_bench():
    ref = _ref_bench()
    clock = iter([1.0, 2.0] + [t for pair in TIMINGS for t in pair])
    ref._time_once = lambda fn, args: next(clock)      # warm-up, then pairs
    want = ref._slope(lambda k: None, ())
    got = bench.slope_stats(TIMINGS, ref.K)
    assert ref.TRIALS == bench.TRIALS == len(TIMINGS)
    assert ref.K == bench.K
    assert got == want


def test_slope_stats_by_hand():
    per_iter, icpt, spread = bench.slope_stats(
        [(1.0, 1.5), (1.0, 1.7), (1.0, 1.6)], k=10)
    assert per_iter == pytest.approx(0.06)                  # median slope
    assert icpt == pytest.approx(0.4)                       # 1.0 - 10*0.06
    assert spread == pytest.approx(0.0)      # one slope left after trimming
    _, _, spread = bench.slope_stats([(0, 1), (0, 2), (0, 3), (0, 4)], k=1)
    assert spread == pytest.approx(100.0 * (3 - 2) / (2 * 3))


def test_pairhmm_counts_at_the_bench_shape():
    Dmax, _ = build_schedule(bench.WIN, bench.WIN, bench.W)
    n = np.full(bench.P, bench.WIN - 12)
    m = np.full(bench.P, bench.WIN - 10)
    w = bench.pairhmm_work(n, m, Dmax=Dmax, W=128, LQG=700, LTG=900)
    assert Dmax >= 1003
    assert w["cells"] == 256 * 1003 * 128         # corner at d = n + m
    assert w["ops"] == 48 * w["cells"]
    assert w["bytes"] == 256 * (700 + 900) + 12 * 256
    assert w["peak"] == bench.FP32_PEAK == 67e12
    # 1 ms per launch -> cells/s -> share of the fp32 peak
    pct = bench.pct_fp32_peak(w["cells"] / 1e-3)
    assert pct == pytest.approx(100 * 256 * 1003 * 128 * 48 / 1e-3 / 67e12)


def test_wavefront_traceback_arrow_ablate_counts():
    w = bench.wavefront_work([10, 3000], [20, 3000], Dmax=4609, W=256,
                             LQG=2300, LTG=3000)
    assert w["cells"] == (31 + 4609) * 256
    assert w["ops"] == 14 * w["cells"] + 19 * (31 + 4609)
    assert w["bytes"] == 2 * 5300 + 40 + 4 * 289 * 2 * 256
    assert w["peak"] == bench.INT32_PEAK == pytest.approx(16.73e12, rel=1e-3)
    t = bench.traceback_work(1000, P=2, max_steps=4608)
    assert (t["ops"], t["bytes"]) == (22_000, 4000 + 16 + 2 * 4608)
    a = bench.arrow_work([360, 0], [384, 5], Lq=640, LJ=640, C=4)
    assert a["cells"] == 2 * (361 * 385 + 1 * 6)
    assert a["ops"] == 66 * a["cells"]
    assert a["bytes"] == (2 * 1280 + 16 + 32 + 80 + 4 * 2 * 4 * 641 * 9 + 8)
    for feats, ops in ((), 6), (("shift",), 10), (("load",), 8), \
            (("lse",), 37), (("shift", "load", "lse"), 43):
        b = bench.ablate_work(feats, P=256, Dmax=1025, W=128, LQG=1024)
        assert b["cells"] == 256 * 1025 * 128
        assert b["ops"] == ops * b["cells"]
        assert b["bytes"] == 4 * 256 * 1024 + 2 * 4 * 256 * 128


def test_bound_names_what_sets_it():
    ms, by = bench.bound_ms(67e9, 1.0, 67e12)          # 1 ms of operations
    assert (ms, by) == (pytest.approx(1.0), "operations")
    ms, by = bench.bound_ms(1.0, 3.35e9, 67e12)        # 1 ms of bytes
    assert (ms, by) == (pytest.approx(1.0), "bytes")


def test_bench_and_ablation_raise_without_cuda(monkeypatch, capsys):
    from falcon_unzip_tpu_torch.cli import main as cli_main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.run()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_main(["bench"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ablate_pairhmm.main()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ablate_pairhmm.measure()
    assert capsys.readouterr().out == ""               # no result printed

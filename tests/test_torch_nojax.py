"""The port runs without JAX, and never silently leaves its device.

A subprocess blocks ``import jax`` (as on a machine that has no JAX) and
``import falcon_unzip_tpu`` (the reference package), imports every module
of the port and runs 3-unzip and 4-polish on a small sim on the CPU,
built with the port's own readers and simulator.  The sources (and
``chip_smoke.py``) must import neither JAX nor the reference, and asking
for CUDA without a GPU must raise.
"""
import ast
import json
import os
import subprocess
import sys

import pytest
import torch

import falcon_unzip_tpu_torch
from falcon_unzip_tpu_torch import device as port_device
from falcon_unzip_tpu_torch.ops.banded_align import BandedAligner

PKG = os.path.dirname(falcon_unzip_tpu_torch.__file__)
REPO = os.path.dirname(PKG)

_SCRIPT = r"""
import sys
sys.modules["jax"] = None            # any `import jax` now raises
sys.modules["falcon_unzip_tpu"] = None   # and any import of the reference
import importlib, os, pkgutil
import falcon_unzip_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
from falcon_unzip_tpu_torch.config import PipelineConfig
from falcon_unzip_tpu_torch.io.fasta import write_fasta
from falcon_unzip_tpu_torch.seq import decode
from falcon_unzip_tpu_torch.utils.simulate import make_diploid, simulate_reads
from falcon_unzip_tpu_torch.pipeline.unzip import run_unzip
d = sys.argv[1]
dip = make_diploid(length=4000, het_rate=0.02, seed=5, het_span=(0.3, 0.7))
pr = simulate_reads(dip, coverage=12.0, read_len=1200, error_rate=0.0,
                    seed=6)
raw = simulate_reads(dip, coverage=10.0, read_len=1200, error_rate=0.03,
                     seed=7)
for fn, b in (("/preads.fa", pr.batch), ("/raw.fa", raw.batch)):
    write_fasta(d + fn, ((b.names[i], b.to_str(i)) for i in range(len(b))))
write_fasta(d + "/draft.fa", [("d0", decode(dip.hap0))])
cfg = PipelineConfig(preads=d + "/preads.fa", reads=d + "/raw.fa",
                     draft=d + "/draft.fa", out_dir=d + "/out")
res = run_unzip(cfg, device="cpu")
assert res["p_ctg"]["total_bp"] >= 3600, res
assert os.path.getsize(d + "/out/3-unzip/all_phased_reads") > 0
from falcon_unzip_tpu_torch.pipeline.quiver import run_quiver
res = run_quiver(cfg, device="cpu")
assert res["p"]["total_bp"] >= 3600, res
assert os.path.getsize(d + "/out/4-polish/cns_h_ctg.fastq") > 0
assert not any(k.split(".")[0] in ("jax", "falcon_unzip_tpu")
               for k, v in sys.modules.items() if v is not None)
print("NOJAX-OK")
"""


def test_port_runs_without_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _SCRIPT, str(tmp_path)],
                          capture_output=True, text=True, env=env,
                          cwd=str(tmp_path), timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "NOJAX-OK" in proc.stdout


def _sources():
    for base, _, names in os.walk(PKG):
        for nm in names:
            if nm.endswith(".py"):
                yield os.path.join(base, nm)
    yield os.path.join(REPO, "chip_smoke.py")


def test_no_jax_import_in_port_sources():
    bad = []
    for path in _sources():
        with open(path) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                if mod.split(".")[0] in ("jax", "falcon_unzip_tpu"):
                    bad.append(f"{path}:{node.lineno} {mod}")
    assert not bad, bad


def test_script_twins_are_scanned():
    scanned = {os.path.relpath(p, PKG) for p in _sources()}
    for name in ("e2e_bench", "qv_calibrate", "qv_attrib", "profile_align",
                 "scaling_bench"):
        assert os.path.join("scripts", f"{name}.py") in scanned


def test_cuda_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_device.resolve("cuda")
    with pytest.raises(RuntimeError):
        BandedAligner(W=128, device="cuda")


def test_cli_cuda_without_gpu_raises(monkeypatch, tmp_path):
    from falcon_unzip_tpu_torch.cli import main as cli_main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tmp_path / "run.json"
    cfg.write_text(json.dumps({"preads": str(tmp_path / "p.fa"),
                               "draft": str(tmp_path / "d.fa"),
                               "out_dir": str(tmp_path / "out")}))
    for cmd in ("unzip", "quiver"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli_main([cmd, str(cfg)])          # --device defaults to cuda
    assert not (tmp_path / "out").exists()


def test_missing_device_raises_outside_scope():
    with pytest.raises(ValueError, match="no device"):
        port_device.resolve(None)
    with port_device.scope("cpu"):
        assert BandedAligner(W=128).device == torch.device("cpu")
    with pytest.raises(ValueError):
        BandedAligner(W=128)

"""The port's scaling bench == the JAX package's ``scripts/scaling_bench.py``,
on the CPU.

* Inputs: ``measure_pipeline``'s three FASTAs for N = 1 and 2, at 8 kb
  contigs, byte-identical to the reference's.  The reference runs in this
  process from its source, with its ``/tmp/scaling_pipe_`` prefix swapped
  for a directory under pytest's ``tmp_path`` and its 40 kb contigs for
  8 kb ones, in memory; ``subprocess.Popen`` is stubbed in its namespace,
  so no worker starts.  The file is not changed.
* JSON: given the same stubbed measurements, both ``main``s print the
  same JSON line but for the port's three added keys (``device``,
  ``ranks_per_card``, ``multiprocess.digest``) and the free-text
  ``note`` / ``caveat`` fields, which name each package's world.
* Pipeline: two gloo ranks of the port (N = 2 inputs) write the seven
  canonical files byte-identical to the JAX package's one-process
  ``run_unzip`` + ``run_quiver`` on the same inputs.
* Phase step: the port's step over N = 1 and 2 ranks (256 rows a rank)
  has the digest of the JAX package's ``make_phase_step`` over an N-device
  mesh on the same ``rng(0)`` rows, and of the port's one-process step.
* Launcher: each rank gets its world variables, one card
  (``CUDA_VISIBLE_DEVICES``) and its core count; every thread of a rank
  runs on its own cores.
"""
import io
import json
import os
import sys
from contextlib import redirect_stdout

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from falcon_unzip_tpu.config import PipelineConfig as RefConfig
from falcon_unzip_tpu.parallel.mesh import make_mesh as ref_make_mesh
from falcon_unzip_tpu.parallel.sharding import \
    make_phase_step as ref_make_phase_step
from falcon_unzip_tpu.pipeline.quiver import run_quiver as ref_run_quiver
from falcon_unzip_tpu.pipeline.unzip import run_unzip as ref_run_unzip
from falcon_unzip_tpu_torch.parallel.mesh import make_mesh
from falcon_unzip_tpu_torch.scripts import scaling_bench as sb

# one intra-op thread: the suite runs several pytest workers on one host
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PER_CTG = 8000
# N = 1: 2 contigs (the floor), N = 2: 3 contigs
GENOME_PER_HOST = 12_000
FASTAS = ("preads.fa", "raw.fa", "draft.fa")
CANONICAL = ("3-unzip/all_p_ctg.fa", "3-unzip/all_h_ctg.fa",
             "3-unzip/all_phased_reads", "4-polish/cns_p_ctg.fasta",
             "4-polish/cns_h_ctg.fasta", "4-polish/cns_p_ctg.fastq",
             "4-polish/cns_h_ctg.fastq")
ADDED = ("device", "ranks_per_card")


class FakePopen:
    """A worker that is not started: it records its command and
    environment and reports the line a worker of its kind prints."""

    started: list = []

    def __init__(self, cmd, *, env=None, stdout=None, **_):
        self.cmd, self.env, self.returncode = cmd, env, 0
        FakePopen.started.append(self)
        rank = int((env or {}).get("RANK", "0"))
        if "--worker" in cmd and cmd[cmd.index("--worker") + 1] == "phase":
            self.out = "RESULT " + json.dumps(
                {"n": 1, "reads_per_sec": 1.0, "digest": "0",
                 "cores": [0]}) + "\n"
        else:
            self.out = "HOSTSTAT " + json.dumps(
                {"pid": rank, "n": 1, "wall_s": 1.0, "maxrss_mb": 1.0,
                 "cpu_s": 1.0}) + "\n"
        if stdout is not None and hasattr(stdout, "write"):
            stdout.write(self.out)

    def communicate(self, timeout=None):
        return self.out, None

    def poll(self):
        return 0

    def kill(self):
        pass

    def wait(self, timeout=None):
        return 0


class _FakeSubprocess:
    Popen = FakePopen
    PIPE = STDOUT = -1


def _ref_module(root):
    """scripts/scaling_bench.py's namespace, run from its source with the
    scratch prefix (``:124``) and the contig length (``:128``) swapped."""
    path = os.path.join(REPO, "scripts", "scaling_bench.py")
    with open(path) as fh:
        src = fh.read()
    for old, new in (('f"/tmp/scaling_pipe_', 'ROOT + f"/scaling_pipe_'),
                     ("per_ctg = 40_000", f"per_ctg = {PER_CTG}")):
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    g = {"__name__": "ref_scaling_bench", "__file__": path, "ROOT": root}
    exec(compile(src, path, "exec"), g)
    g["subprocess"] = _FakeSubprocess
    return g


@pytest.fixture
def stub_popen(monkeypatch):
    FakePopen.started = []
    monkeypatch.setattr(sb, "subprocess", _FakeSubprocess)
    return FakePopen.started


def _read(path) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("n", [1, 2])
def test_inputs_byte_identical(tmp_path, monkeypatch, stub_popen, n):
    ref = _ref_module(str(tmp_path / "ref"))
    os.makedirs(tmp_path / "ref")
    want = ref["measure_pipeline"](n, 1, GENOME_PER_HOST, 10.0)
    monkeypatch.setattr(sb, "PER_CTG", PER_CTG)
    got = sb.measure_pipeline(n, 1, GENOME_PER_HOST, 10.0, device="cpu",
                              scratch=str(tmp_path / "twin"))
    assert got["n_reads"] == want["n_reads"] > 0
    assert got["genome_bp"] == want["genome_bp"] == PER_CTG * (n + 1)
    assert len(got["hosts"]) == len(want["hosts"]) == n
    for name in FASTAS:
        twin = _read(tmp_path / "twin" / f"scaling_pipe_{n}" / name)
        assert len(twin) > 0
        assert twin == _read(tmp_path / "ref" / f"scaling_pipe_{n}" / name)


def _measurements():
    pipe = {n: {"n": n, "n_reads": 100 * n, "genome_bp": 80_000 * n,
                "wall_s": 10.0 + n,
                "hosts": [{"pid": p, "n": n, "wall_s": 10.0 + n - p,
                           "maxrss_mb": 500.0 + 7 * p,
                           "cpu_s": 9.0 + 0.5 * n + p}
                          for p in reversed(range(n))]}
            for n in (1, 2, 4)}
    mp = {1: 1000.123, 2: 1900.456, 4: 3500.789}
    virt = {1: 300.55, 2: 580.44, 4: 1000.33, 8: 1700.22}
    return pipe, mp, virt


def _printed(fn) -> dict:
    buf = io.StringIO()
    with redirect_stdout(buf):
        fn()
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def _text_free(out: dict) -> dict:
    out = json.loads(json.dumps(out))
    for part in ("pipeline", "multiprocess"):
        assert out[part].pop("note")
    assert out["virtual_mesh"].pop("caveat")
    return out


def test_json_equal_but_added_keys(tmp_path, monkeypatch):
    pipe, mp, virt = _measurements()
    ref = _ref_module(str(tmp_path))
    ref["measure_pipeline"] = lambda n, per, g, coverage: pipe[n]
    ref["measure_multiprocess"] = lambda n, per: mp[n]
    ref["measure_virtual"] = lambda n: virt[n]
    want = _printed(ref["main"])
    monkeypatch.setattr(sb, "measure_pipeline",
                        lambda n, per, g, coverage, **kw: pipe[n])
    monkeypatch.setattr(sb, "measure_multiprocess", lambda n, per, **kw: {
        "reads_per_sec": mp[n], "digest": f"d{n}"})
    monkeypatch.setattr(sb, "measure_virtual", lambda n, **kw: virt[n])
    got = _printed(lambda: sb.main(["--device", "cpu", "--scratch",
                                    str(tmp_path / "s")]))
    assert got["device"] == "cpu"
    assert got["ranks_per_card"] == {"1": None, "2": None, "4": None}
    assert got["multiprocess"].pop("digest") == {"1": "d1", "2": "d2",
                                                 "4": "d4"}
    for k in ADDED:
        got.pop(k)
    assert _text_free(got) == _text_free(want)
    assert want["pipeline"]["scaling_efficiency"]["2"] == round(11 / 12, 3)
    assert set(want["virtual_mesh"]["per_devices"]) == {"1", "2", "4", "8"}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The port's pipeline over two gloo ranks on the N = 2 inputs, and
    the JAX package's one process on the same files."""
    root = str(tmp_path_factory.mktemp("pipe"))
    saved = sb.PER_CTG
    sb.PER_CTG = PER_CTG
    try:
        res = sb.measure_pipeline(2, 1, GENOME_PER_HOST, 10.0, device="cpu",
                                  scratch=root)
    finally:
        sb.PER_CTG = saved
    d = os.path.join(root, "scaling_pipe_2")
    cfg = RefConfig(preads=f"{d}/preads.fa", reads=f"{d}/raw.fa",
                    draft=f"{d}/draft.fa", out_dir=f"{d}/ref", resume=False)
    ref_run_unzip(cfg)
    ref_run_quiver(cfg)
    files = {rel: (_read(os.path.join(d, "ref", rel)),
                   _read(os.path.join(d, "out_n2", rel)))
             for rel in CANONICAL}
    return res, files


def test_two_ranks_report_each_host(two_ranks):
    res, _ = two_ranks
    hosts = sorted(res["hosts"], key=lambda h: h["pid"])
    assert [h["pid"] for h in hosts] == [0, 1]
    for h in hosts:
        assert h["n"] == 2 and 0 < h["wall_s"] < h["life_s"]
        # one core: the CPU seconds fit in the process's life
        assert 0 < h["cpu_s"] <= h["life_s"] + 0.5
        assert h["maxrss_mb"] > 0 and h["device_ms"] is None
        assert h["cores"] == sorted(sb.pinned_cores(h["pid"], 1))
        assert set(h["launches"]) >= {"banded_wavefront", "traceback",
                                      "arrow_splice"}
        assert h["stages"]["align_compute"]["s"] >= 0
        assert "polish_windows" in h["stages"]
    assert res["wall_s"] == max(h["wall_s"] for h in hosts)


@pytest.mark.parametrize("rel", CANONICAL)
def test_two_ranks_byte_identical_to_jax(two_ranks, rel):
    ref, port = two_ranks[1][rel]
    assert len(port) > 0
    assert port == ref


@pytest.mark.parametrize("n", [1, 2])
def test_phase_step_digest_equals_jax(monkeypatch, n):
    monkeypatch.setenv("SCALING_R_PER_DEV", "256")
    got = sb.measure_multiprocess(n, 1, device="cpu")
    assert got["reads_per_sec"] > 0
    # every thread of rank 0 (numpy's BLAS pool too) on its one core
    assert got["cores"] == sorted(sb.pinned_cores(0, 1))
    R = 256 * n
    tagpos, tagbase = sb.phase_inputs(R)
    want = ref_make_phase_step(ref_make_mesh(n, window_par=1), t_len=4096,
                               s_cap=128, max_span=32, min_depth=2)(
        jnp.asarray(tagpos), jnp.asarray(tagbase))
    assert np.asarray(want[1]).any()         # some het sites were called
    step, a, b = sb.run_phase_step(make_mesh(1, 1, device="cpu"), R)
    one = step(a, b)
    for name, g, w in zip(sb.PHASE_OUTPUTS, one, want):
        assert np.array_equal(g.numpy(), np.asarray(w)), name
    assert got["digest"] == sb.phase_digest(want) == sb.phase_digest(one)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_launcher_gives_each_rank_one_card(monkeypatch, stub_popen, n):
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    got = sb.measure_multiprocess(n, 3, device="cuda")
    assert got == {"reads_per_sec": 1.0, "digest": "0", "cores": [0]}
    assert len(stub_popen) == n
    ports = {p.env["MASTER_PORT"] for p in stub_popen}
    assert len(ports) == 1
    for pid, p in enumerate(stub_popen):
        assert p.cmd[:3] == [sys.executable, "-m", sb.MODULE]
        assert p.cmd[p.cmd.index("--worker") + 1] == "phase"
        assert p.cmd[p.cmd.index("--per") + 1] == "3"
        assert p.cmd[p.cmd.index("--device") + 1] == "cuda"
        env = p.env
        assert env["MASTER_ADDR"] == "localhost"
        assert (env["WORLD_SIZE"], env["RANK"]) == (str(n), str(pid))
        assert (env["LOCAL_WORLD_SIZE"], env["LOCAL_RANK"]) == (str(n),
                                                                str(pid))
        assert env["CUDA_VISIBLE_DEVICES"] == str(pid % 4)
        assert REPO in env["PYTHONPATH"].split(os.pathsep)
    assert sb.ranks_per_card(n, 4) == -(-n // 4)
    # a caller's own card list is what the ranks are spread over
    stub_popen.clear()
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "5,7")
    sb.measure_multiprocess(n, 1, device="cuda", cards=2)
    assert [p.env["CUDA_VISIBLE_DEVICES"] for p in stub_popen] == [
        "57"[pid % 2] for pid in range(n)]


@pytest.mark.parametrize("ncores,per,want", [
    (8, 1, [{0}, {1}, {2}, {3}]), (8, 2, [{0, 1}, {2, 3}, {4, 5}, {6, 7}]),
    (2, 1, [{0}, {1}, {0}, {1}])])
def test_pinned_cores_equal_and_disjoint(monkeypatch, ncores, per, want):
    """Rank k's ``per`` cores of the allowed set: disjoint while they
    last, then wrapping."""
    allowed = set(range(10, 10 + ncores))
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: allowed)
    assert [sb.pinned_cores(pid, per) for pid in range(4)] == [
        {10 + c for c in s} for s in want]


def test_default_device_is_cuda(monkeypatch, tmp_path):
    """Without --device the bench asks for cuda, and raises without a GPU
    before it writes anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sb.main(["--scratch", str(tmp_path / "s")])
    assert not (tmp_path / "s").exists()

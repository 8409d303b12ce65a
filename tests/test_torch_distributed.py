"""The port's torch.distributed layer in a two-process gloo world.

Each check spawns two worker processes that join one gloo world on a
free local port (MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK, as
torchrun sets them) and run one collective of
``falcon_unzip_tpu_torch.parallel.distributed``; every wait has a
timeout and a hung worker is killed.  The process-spanning psum is the
twin of tests/test_distributed_multiprocess.py::
test_two_process_distributed_psum (2 processes x 2 shards, total 12).
The slow test runs the port's whole pipeline over two processes on the
golden fixture, then a resume pass, as
test_two_process_full_pipeline_byte_identical does for the JAX package.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from falcon_unzip_tpu.parallel.distributed import \
    contig_owners as ref_contig_owners
from falcon_unzip_tpu_torch.parallel import distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from falcon_unzip_tpu_torch.parallel import distributed as dist
check = sys.argv[1]
dist.initialize(timeout_s=120)
me, P = dist.process_index(), dist.process_count()
assert P == 2, P
if check == "allgather_bytes":
    got = dist.allgather_bytes(bytes([7 + me]) * (3 + 1000 * me))
    assert got == [bytes([7]) * 3, bytes([8]) * 1003], [len(g) for g in got]
    assert dist.allgather_bytes(b"" if me else b"x") == [b"x", b""]
elif check == "exchange_to_owners":
    got = dist.exchange_to_owners([f"{me}->{d}".encode() for d in range(P)])
    assert got == [f"{s}->{me}".encode() for s in range(P)], got
elif check == "gather_to_primary":
    got = dist.gather_to_primary(f"host{me}".encode() * (me + 1))
    assert got == ([b"host0", b"host1host1"] if me == 0 else None), got
elif check == "sync_stage_done":
    # rank 0's decision wins on every rank, either way
    assert dist.sync_stage_done(me == 0) is True
    assert dist.sync_stage_done(me == 1) is False
elif check == "barrier":
    import os, time
    flag = sys.argv[2] + "/rank0-was-here"
    if me == 0:
        time.sleep(1.0)
        open(flag, "w").close()
    dist.barrier("test")
    assert os.path.exists(flag)       # nobody passes before rank 0 arrives
elif check == "psum":
    from falcon_unzip_tpu_torch.parallel.collectives import psum
    from falcon_unzip_tpu_torch.parallel.mesh import make_mesh, shard_rows
    from falcon_unzip_tpu_torch.parallel.sharding import ShardedPhaseOps
    mesh = make_mesh(4, 1, device="cpu")     # spans both processes
    assert mesh.spans_processes and len(mesh.local) == 2, mesh
    assert list(mesh.slots) == [2 * me, 2 * me + 1]
    full = np.repeat(np.arange(1, 3, dtype=np.int32), 4)  # proc0 1s, proc1 2s
    parts = shard_rows(mesh, full).parts
    total = int(psum(mesh, [p.sum().reshape(1) for p in parts])[0])
    assert total == 4 * 1 + 4 * 2, total    # sees BOTH processes' data
    # the sharded pileup over the process-spanning mesh sees all rows
    rng = np.random.default_rng(0)
    pos = rng.integers(-1, 200, 999).astype(np.int32)
    base = rng.integers(0, 5, 999).astype(np.int32)
    got = ShardedPhaseOps(mesh).pileup(pos, base, t_len=200)
    ok = pos >= 0
    want = np.zeros((200, 5), np.int32)
    np.add.at(want, (pos[ok], base[ok]), 1)
    assert np.array_equal(got, want)
    print(f"total={total}", flush=True)
print(f"WORKER-OK {check} rank={me}", flush=True)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(script, args, n=2, timeout=240):
    """Run ``script`` as n ranks of one gloo world; returns their
    outputs, killing every rank if one of them hangs."""
    port = _free_port()
    procs = []
    for rank in range(n):
        env = dict(os.environ, MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), WORLD_SIZE=str(n),
                   RANK=str(rank), LOCAL_RANK=str(rank),
                   LOCAL_WORLD_SIZE=str(n), PYTHONPATH=REPO)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", script, *args], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        pytest.fail("a distributed worker timed out")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {i} failed:\n{out[-3000:]}"
    return outs


@pytest.mark.parametrize("check", ["allgather_bytes", "exchange_to_owners",
                                   "gather_to_primary", "sync_stage_done",
                                   "barrier", "psum"])
def test_two_process_collective(check, tmp_path):
    outs = _spawn(_WORKER, [check, str(tmp_path)])
    for rank, out in enumerate(outs):
        assert f"WORKER-OK {check} rank={rank}" in out, out[-1000:]
    if check == "psum":
        assert all("total=12" in out for out in outs)


def test_one_process_world_without_env(monkeypatch):
    """No world set up: one process, every collective the identity."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert dist.process_count() == 1 and dist.is_primary_host()
    assert dist.allgather_bytes(b"abc") == [b"abc"]
    assert dist.exchange_to_owners([b"z"]) == [b"z"]
    assert dist.gather_to_primary(b"q") == [b"q"]
    assert dist.sync_stage_done(False) is False
    assert dist.host_shard(10) == (0, 10)
    dist.barrier("noop")


@pytest.mark.parametrize("n_hosts", [1, 2, 3, 5])
def test_contig_owners_match_reference(n_hosts):
    rng = np.random.default_rng(n_hosts)
    lengths = rng.integers(1, 10_000, 37)
    lengths[5] = lengths[9]                  # a tie, broken by index
    got = dist.contig_owners(lengths, n_hosts)
    want = ref_contig_owners(lengths, n_hosts)
    assert got.dtype == want.dtype and np.array_equal(got, want)


_PIPELINE_WORKER = r"""
import sys
import torch
torch.set_num_threads(1)
from falcon_unzip_tpu_torch.config import PipelineConfig
from falcon_unzip_tpu_torch.parallel import distributed as dist
from falcon_unzip_tpu_torch.parallel.checkpoint import Stage
from falcon_unzip_tpu_torch.pipeline.quiver import run_quiver
from falcon_unzip_tpu_torch.pipeline.unzip import run_unzip
d = sys.argv[1]
cfg = PipelineConfig(preads=f"{d}/preads.fa", reads=f"{d}/raw.fa",
                     draft=f"{d}/draft.fa", out_dir=f"{d}/out_mp")
cfg.mesh.multihost = True      # initialize() from the torchrun env vars
run_unzip(cfg, device="cpu")
run_quiver(cfg, device="cpu")
# resume pass: every stage must SKIP identically on every host (the
# sync_stage_done broadcast); a divergent decision would deadlock in the
# first collective and trip the timeout
real = Stage.run
skipped = []
def spy(self, fn):
    ran = real(self, fn)
    if not ran:
        skipped.append(self.name)
    return ran
Stage.run = spy
run_unzip(cfg, device="cpu")
run_quiver(cfg, device="cpu")
print(f"SKIPPED {sorted(skipped)}", flush=True)
print(f"WORKER-OK process={dist.process_index()}", flush=True)
"""

_COMPARE = [
    "3-unzip/all_p_ctg.fa", "3-unzip/all_h_ctg.fa",
    "3-unzip/all_phased_reads", "3-unzip/all_h_ctg_ids",
    "3-unzip/h_ctg_placements.m4", "3-unzip/sg_edges_list",
    "3-unzip/preads.ovl",
    "4-polish/cns_p_ctg.fasta", "4-polish/cns_p_ctg.fastq",
    "4-polish/cns_h_ctg.fasta", "4-polish/cns_h_ctg.fastq",
]
_STAGES = ["0-draft", "1-align", "1-track", "2-phasing", "2-polish",
           "3-hasm"]


@pytest.mark.slow
def test_two_process_pipeline_byte_identical(tmp_path):
    """The port's 3-unzip + 4-polish over a two-process gloo world on the
    golden fixture: canonical artifacts byte-identical to the port's
    one-process run, and a resume pass that skips every stage on both
    ranks."""
    from falcon_unzip_tpu_torch.config import PipelineConfig
    from falcon_unzip_tpu_torch.pipeline.quiver import run_quiver
    from falcon_unzip_tpu_torch.pipeline.unzip import run_unzip
    from test_torch_pipeline_sharded import _golden_inputs

    d = str(tmp_path)
    _golden_inputs(d)
    cfg = PipelineConfig(preads=f"{d}/preads.fa", reads=f"{d}/raw.fa",
                         draft=f"{d}/draft.fa", out_dir=f"{d}/out_sp")
    run_unzip(cfg, device="cpu")
    run_quiver(cfg, device="cpu")
    outs = _spawn(_PIPELINE_WORKER, [d], timeout=900)
    for rank, out in enumerate(outs):
        assert f"WORKER-OK process={rank}" in out, out[-2000:]
        assert f"SKIPPED {_STAGES}" in out, out[-2000:]
    mismatches = []
    for rel in _COMPARE:
        with open(os.path.join(d, "out_sp", rel), "rb") as a, \
                open(os.path.join(d, "out_mp", rel), "rb") as b:
            if a.read() != b.read():
                mismatches.append(rel)
    assert not mismatches, mismatches


def test_mesh_cards_calls_only_smoke_helpers_that_exist():
    """scripts/mesh_cards.py runs only on four cards and borrows
    chip_smoke.py's helpers: each one it names must exist there."""
    import ast

    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import chip_smoke
    path = os.path.join(REPO, "falcon_unzip_tpu_torch", "scripts",
                        "mesh_cards.py")
    with open(path) as fh:
        tree = ast.parse(fh.read())
    used = {n.attr for n in ast.walk(tree)
            if isinstance(n, ast.Attribute)
            and isinstance(n.value, ast.Name) and n.value.id == "cs"}
    assert used, "mesh_cards no longer borrows from chip_smoke"
    assert not sorted(u for u in used if not hasattr(chip_smoke, u))

"""The port's multi-host path over four gloo ranks on the CPU.

Four worker processes, one thread each, join one gloo world on a free
local port (as ``tests/test_torch_distributed.py`` spawns two) and run
the port's ``run_unzip`` + ``run_quiver`` with ``cfg.mesh.multihost`` on
three diploid contigs of 6 kb: ``contig_owners`` gives three ranks a
contig each and the fourth none.  Host 0's seven canonical files must be
byte-identical to the JAX package's one-process run.

The collective helpers' spans: under a profiler every helper keeps a
``dist.*`` row, the leaves' rows carry ``bytes_out`` and ``bytes_in``
(an exchange's bytes are those of the gathers under it) and each
``allgather_bytes`` row its ``pad_bytes``.  Without a profiler, and in a
one-process world, no ``dist.*`` row is kept.
"""
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from falcon_unzip_tpu.config import PipelineConfig as RefConfig
from falcon_unzip_tpu.pipeline.quiver import run_quiver as ref_run_quiver
from falcon_unzip_tpu.pipeline.unzip import run_unzip as ref_run_unzip
from falcon_unzip_tpu_torch.io.fasta import write_fasta
from falcon_unzip_tpu_torch.parallel import distributed as dist
from falcon_unzip_tpu_torch.seq import decode
from falcon_unzip_tpu_torch.utils.profiling import drain
from falcon_unzip_tpu_torch.utils.simulate import make_diploid, simulate_reads

from test_torch_adversarial_het_indels import CANONICAL
from test_torch_distributed import _spawn

torch.set_num_threads(1)

N_CTG = 3
CTG_LEN = 6000

_PIPELINE = r"""
import json, sys
import torch
torch.set_num_threads(1)
from falcon_unzip_tpu_torch.config import PipelineConfig
from falcon_unzip_tpu_torch.parallel import distributed as dist
from falcon_unzip_tpu_torch.pipeline.quiver import run_quiver
from falcon_unzip_tpu_torch.pipeline.unzip import run_unzip
d = sys.argv[1]
cfg = PipelineConfig(preads=f"{d}/preads.fa", reads=f"{d}/raw.fa",
                     draft=f"{d}/draft.fa", out_dir=f"{d}/out_mp")
cfg.mesh.multihost = True
run_unzip(cfg, device="cpu")
run_quiver(cfg, device="cpu")
lens = [6000] * 3
print("OWNED", json.dumps(int((dist.contig_owners(lens, 4)
                               == dist.process_index()).sum())), flush=True)
print(f"WORKER-OK process={dist.process_index()}", flush=True)
"""


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ranks4"))
    preads, raw, draft = [], [], []
    for i in range(N_CTG):
        dip = make_diploid(length=CTG_LEN, het_rate=0.012, seed=60 + i,
                           het_span=(0.25, 0.75))
        pr = simulate_reads(dip, coverage=14.0, read_len=2200,
                            error_rate=0.0, seed=70 + i)
        rw = simulate_reads(dip, coverage=18.0, read_len=1800,
                            error_rate=0.03, seed=80 + i)
        preads += [(f"c{i}_{pr.batch.names[k]}", pr.batch.to_str(k))
                   for k in range(len(pr.batch))]
        raw += [(f"c{i}_{rw.batch.names[k]}", rw.batch.to_str(k))
                for k in range(len(rw.batch))]
        draft.append((f"draft{i}", decode(dip.hap0)))
    write_fasta(f"{d}/preads.fa", preads)
    write_fasta(f"{d}/raw.fa", raw)
    write_fasta(f"{d}/draft.fa", draft)
    ref = RefConfig(preads=f"{d}/preads.fa", reads=f"{d}/raw.fa",
                    draft=f"{d}/draft.fa", out_dir=f"{d}/ref")
    ref_run_unzip(ref)
    ref_run_quiver(ref)
    outs = _spawn(_PIPELINE, [d], n=4, timeout=300)
    return d, outs


def test_four_ranks_leave_one_rank_without_a_contig(four_ranks):
    _, outs = four_ranks
    owned = []
    for rank, out in enumerate(outs):
        assert f"WORKER-OK process={rank}" in out, out[-2000:]
        owned.append(int(out.split("OWNED ")[1].split()[0]))
    assert owned == [1, 1, 1, 0]


@pytest.mark.parametrize("rel", CANONICAL)
def test_four_rank_canonical_file_matches_jax(four_ranks, rel):
    d, _ = four_ranks
    with open(os.path.join(d, "ref", rel), "rb") as a, \
            open(os.path.join(d, "out_mp", rel), "rb") as b:
        want, got = a.read(), b.read()
    assert got == want and want, rel


def test_four_ranks_keep_no_dist_row_without_a_profiler(four_ranks):
    d, _ = four_ranks
    for rank in range(4):
        root = os.path.join(d, "out_mp", *([f".host{rank}"] if rank else []))
        with open(os.path.join(root, "metrics.jsonl")) as fh:
            rows = [json.loads(x) for x in fh]
        assert rows and not [r for r in rows
                             if r["stage"].startswith("dist.")]


_COLLECTIVES = r"""
import json, sys
import torch
torch.set_num_threads(1)
from torch.profiler import ProfilerActivity, profile
from falcon_unzip_tpu_torch.parallel import distributed as dist
from falcon_unzip_tpu_torch.utils.profiling import drain, span
dist.initialize(timeout_s=120)
me, P = dist.process_index(), dist.process_count()
with profile(activities=[ProfilerActivity.CPU]):
    with span("run_unzip", rank=me, world=P):
        dist.exchange_to_owners([bytes(10 * (me + 1) + d) for d in range(P)])
        dist.gather_to_primary(bytes(100 * me))
        dist.allgather_bytes(b"")
        dist.all_reduce_sum(torch.ones(3, dtype=torch.int64))
        dist.all_gather_rows(torch.zeros(2, dtype=torch.int32))
        dist.sync_stage_done(True)
        dist.barrier("end")
print("ROWS " + json.dumps(drain()), flush=True)
"""


@pytest.fixture(scope="module")
def collective_rows():
    outs = _spawn(_COLLECTIVES, [], n=4, timeout=240)
    return [json.loads(out.split("ROWS ")[1].splitlines()[0])
            for out in outs]


TOP = ["dist.exchange_to_owners", "dist.gather_to_primary",
       "dist.allgather_bytes", "dist.all_reduce_sum",
       "dist.all_gather_rows", "dist.sync_stage_done", "dist.barrier"]
LEAVES = {"dist.all_gather_rows", "dist.all_reduce_sum",
          "dist.sync_stage_done", "dist.barrier"}


def _tree(rows: list, me: int) -> tuple:
    """(this rank's root row, its children by name, a row's leaves)."""
    root = [r for r in rows if r["stage"] == "run_unzip"]
    assert [(r["rank"], r["world"]) for r in root] == [(me, 4)]
    top = sorted((r for r in rows if r["parent"] == root[0]["id"]),
                 key=lambda r: r["t0"])
    assert [r["stage"] for r in top] == TOP

    def leaves(row):
        kids = [r for r in rows if r["parent"] == row["id"]]
        return [row] if not kids else [x for k in kids for x in leaves(k)]
    return root[0], {r["stage"]: r for r in top}, leaves


def test_every_collective_row_carries_its_bytes(collective_rows):
    """The leaves carry the byte counts, the helpers that nest none of
    their own; each ``allgather_bytes`` its padding."""
    for me, rows in enumerate(collective_rows):
        _tree(rows, me)
        dists = [r for r in rows if r["stage"].startswith("dist.")]
        assert dists
        for r in dists:
            if r["stage"] in LEAVES:
                assert {"bytes_in", "bytes_out"} <= set(r), r
                assert r["bytes_in"] >= 0 and r["bytes_out"] >= 0
            else:
                assert "bytes_in" not in r and "bytes_out" not in r, r
            assert ("pad_bytes" in r) == (r["stage"] ==
                                          "dist.allgather_bytes"), r


def test_collective_bytes_match_the_hand_worked_counts(collective_rows):
    P = 4
    for me, rows in enumerate(collective_rows):
        _, got, leaves = _tree(rows, me)
        ex = got["dist.exchange_to_owners"]
        # its own rounds, each with its two gathers, lie under it
        rounds = [r for r in rows if r["parent"] == ex["id"]]
        assert [r["stage"] for r in rounds] == ["dist.allgather_bytes"] * P
        for rd in rounds:
            kids = [r for r in rows if r["parent"] == rd["id"]]
            assert [r["stage"] for r in kids] == ["dist.all_gather_rows"] * 2
            assert sum(r["s"] for r in kids) <= rd["s"]
        assert sum(r["s"] for r in rounds) <= ex["s"]
        # round d gathers blobs of 10 (s + 1) + d bytes from each source s,
        # padded to the longest (10 P + d), after P lengths of 8 bytes
        ex_in = sum(r["bytes_in"] for r in leaves(ex))
        assert ex_in == sum(P * 8 + P * (10 * P + d) for d in range(P))
        assert sum(r["bytes_out"] for r in leaves(ex)) == sum(
            8 + 10 * P + d for d in range(P))
        assert [r["pad_bytes"] for r in rounds] == [
            P * (10 * P + d) - sum(10 * (s + 1) + d for s in range(P))
            for d in range(P)]
        gp = got["dist.gather_to_primary"]
        assert sum(r["bytes_in"] for r in leaves(gp)) == P * 8 + P * 300
        [gp_round] = [r for r in rows if r["parent"] == gp["id"]]
        assert gp_round["pad_bytes"] == P * 300 - 600
        empty = got["dist.allgather_bytes"]
        assert (sum(r["bytes_in"] for r in leaves(empty)),
                empty["pad_bytes"]) == (P * 8 + P, P)
        assert (got["dist.all_reduce_sum"]["bytes_in"],
                got["dist.all_gather_rows"]["bytes_in"]) == (24, 8 * P)
        sync = got["dist.sync_stage_done"]
        assert (sync["bytes_out"], sync["bytes_in"]) == \
            ((4, 0) if me == 0 else (0, 4))


def test_one_process_world_keeps_no_dist_row(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    drain()
    with profile(activities=[ProfilerActivity.CPU]):
        dist.exchange_to_owners([b"z"])
        dist.gather_to_primary(b"q")
        dist.allgather_bytes(b"abc")
        dist.all_reduce_sum(torch.ones(2, dtype=torch.int64))
        dist.all_gather_rows(torch.ones(2))
        dist.sync_stage_done(True)
        dist.barrier("noop")
    assert drain() == []
    assert np.array_equal(dist.contig_owners([5, 5, 5], 4), [0, 1, 2])

"""The port's command line (cli/) == the JAX package's.

Each of the nine subcommands phase, ovlp-filter, track, dedup, gen-gfa,
readmap, graph, select-reads and bam2m4 runs through both packages' CLIs
on the same inputs (the port's with ``--device cpu``); every output file
must be byte-identical.  Then the twins of tests/test_cli_tools.py and of
tests/test_pipeline.py::test_cli_gen_gfa_and_dedup, and the fc_* shims of
cli/compat.py forwarding to their subcommands.
"""
import os
import sys

import numpy as np
import pytest
import torch

from falcon_unzip_tpu.cli import main as ref_main
from falcon_unzip_tpu_torch.cli import compat
from falcon_unzip_tpu_torch.cli import main
from falcon_unzip_tpu_torch.io import bamlite as bl
from falcon_unzip_tpu_torch.io.fasta import read_fasta, write_fasta
from falcon_unzip_tpu_torch.io.serialize import serialize
from falcon_unzip_tpu_torch.seq import decode
from falcon_unzip_tpu_torch.utils.fixtures import dir_bytes
from falcon_unzip_tpu_torch.utils.simulate import (make_diploid,
                                                   random_genome,
                                                   simulate_reads)

# one intra-op thread: the suite runs several pytest workers on one host
torch.set_num_threads(1)


def _mk_bam(d, n=12):
    """tests/test_cli_tools.py::_mk_bam: n 60 bp records on two refs."""
    rng = np.random.default_rng(0)
    recs = []
    for i in range(n):
        L = 60
        recs.append(bl.BamRecord(
            name=f"r{i}", flag=0, ref_id=i % 2,
            pos=int(rng.integers(0, 100)), mapq=60, cigar=[(L, 0)],
            seq=random_genome(L, i), qual=np.full(L, 30, np.uint8)))
    bam = bl.BamFile(text="@HD\tVN:1.6\n",
                     refs=[("c0", 400), ("c1", 400)], records=recs)
    path = os.path.join(str(d), "in.bam")
    bl.write_bam(path, bam)
    return path


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The diploid of tests/test_cli_tools.py cut to 4 kb and 10x
    error-free 1200 bp preads, with its hap0 as the draft, unzipped by
    the port's CLI; a 12-record BAM and a read -> contig map."""
    d = tmp_path_factory.mktemp("cli")
    dip = make_diploid(length=4000, het_rate=0.02, seed=7,
                       het_span=(0.25, 0.75))
    pr = simulate_reads(dip, coverage=10.0, read_len=1200,
                        error_rate=0.0, seed=8)
    write_fasta(str(d / "preads.fa"),
                ((pr.batch.names[i], pr.batch.to_str(i))
                 for i in range(len(pr.batch))))
    write_fasta(str(d / "draft.fa"), [("d0", decode(dip.hap0))])
    with open(d / "run.json", "w") as fh:
        fh.write(f'{{"preads": "{d}/preads.fa", "draft": "{d}/draft.fa", '
                 f'"out_dir": "{d}/out"}}')
    assert main(["unzip", str(d / "run.json"), "--device", "cpu"]) == 0
    bam = _mk_bam(d)
    serialize(str(d / "map.msgpack"), {f"r{i}": i % 2 for i in range(8)})
    return d, bam


def _argv(d, bam, out):
    """Each subcommand's arguments, writing under ``out``."""
    u = f"{d}/out/3-unzip"
    return {
        "phase": ["--preads", f"{d}/preads.fa", "--draft", f"{d}/draft.fa",
                  "--out", f"{out}/phased_reads"],
        "ovlp-filter": ["--preads", f"{d}/preads.fa", "--phased-reads",
                        f"{u}/all_phased_reads", "--out",
                        f"{out}/filtered.json"],
        "track": ["--reads", f"{d}/preads.fa", "--contigs",
                  f"{u}/all_p_ctg.fa", "--out", f"{out}/r2c.msgpack"],
        "dedup": ["--p-ctg", f"{u}/all_p_ctg.fa", "--h-ctg",
                  f"{u}/all_h_ctg.fa", "--out", f"{out}/h.dedup.fa"],
        "gen-gfa": ["--unzip-dir", u, "--out", f"{out}/asm.gfa"],
        "readmap": [f"{u}/all_phased_reads", f"{u}/all_phased_reads",
                    "--out", f"{out}/rid_to_phase.all"],
        "graph": ["--preads", f"{d}/preads.fa", "--phased-reads",
                  f"{u}/all_phased_reads", "--out-dir", f"{out}/graph"],
        "select-reads": ["--bam", bam, "--map", f"{d}/map.msgpack",
                         "--out-pattern", f"{out}/part_{{}}.bam"],
        "bam2m4": ["--bam", bam, "--out", f"{out}/aln.m4"],
    }


ALIGNS = {"phase", "ovlp-filter", "track", "dedup", "graph"}


@pytest.fixture(scope="module")
def both(inputs):
    """{subcommand: (reference outputs, port outputs)}."""
    d, bam = inputs
    res = {}
    for cmd in _argv(d, bam, ""):
        outs = []
        for tag, fn, extra in (("ref", ref_main, []),
                               ("port", main, ["--device", "cpu"])):
            out = f"{d}/{tag}/{cmd}"
            os.makedirs(out)
            argv = _argv(d, bam, out)[cmd]
            assert fn([cmd] + argv + (extra if cmd in ALIGNS else [])) == 0
            outs.append(dir_bytes(out))
        res[cmd] = outs
    return res


@pytest.mark.parametrize("cmd", ["phase", "ovlp-filter", "track", "dedup",
                                 "gen-gfa", "readmap", "graph",
                                 "select-reads", "bam2m4"])
def test_subcommand_outputs_byte_identical(both, cmd):
    ref, port = both[cmd]
    assert ref and sorted(port) == sorted(ref)
    for rel in ref:
        assert port[rel] == ref[rel], rel
    assert any(len(v) for v in ref.values())


def test_readmap_merges_and_dedups(tmp_path, capsys):
    a = tmp_path / "phased.0"
    b = tmp_path / "phased.1"
    a.write_text("000000F 0 0 r0\n000000F 0 1 r1\n")
    b.write_text("000001F 0 0 r2\n000000F 0 1 r1\n")   # r1 repeated
    out = str(tmp_path / "rid_to_phase.all")
    assert main(["readmap", str(a), str(b), "--out", out]) == 0
    lines = open(out).read().splitlines()
    assert len(lines) == 3
    assert "000001F 0 0 r2" in lines


def test_phase_then_graph_cli(inputs, tmp_path, capsys):
    """Twin of test_cli_tools.py::test_phase_then_graph_cli: the longest
    pread as a one-contig draft."""
    d, _ = inputs
    preads = str(d / "preads.fa")
    batch = read_fasta(preads)
    longest = int(np.argmax(batch.lengths))
    write_fasta(str(tmp_path / "draft.fa"),
                [("d0", batch.to_str(longest))])
    phased = str(tmp_path / "phased_reads")
    assert main(["phase", "--preads", preads,
                 "--draft", str(tmp_path / "draft.fa"),
                 "--out", phased, "--device", "cpu"]) == 0
    assert os.path.exists(phased)
    out_dir = str(tmp_path / "graphed")
    assert main(["graph", "--preads", preads, "--phased-reads", phased,
                 "--out-dir", out_dir, "--device", "cpu"]) == 0
    assert os.path.exists(os.path.join(out_dir, "all_p_ctg.fa"))
    assert os.path.exists(os.path.join(out_dir, "all_h_ctg.fa"))
    assert len(read_fasta(os.path.join(out_dir, "all_p_ctg.fa"))) >= 1


def test_select_reads_cli(tmp_path, capsys):
    path = _mk_bam(tmp_path)
    mp = str(tmp_path / "map.msgpack")
    serialize(mp, {f"r{i}": i % 2 for i in range(8)})
    pattern = str(tmp_path / "part_{}.bam")
    assert main(["select-reads", "--bam", path, "--map", mp,
                 "--out-pattern", pattern]) == 0
    p0 = bl.read_bam(pattern.format(0))
    p1 = bl.read_bam(pattern.format(1))
    assert len(p0.records) + len(p1.records) == 8


def test_bam2m4_cli(tmp_path, capsys):
    path = _mk_bam(tmp_path)
    out = str(tmp_path / "aln.m4")
    assert main(["bam2m4", "--bam", path, "--out", out]) == 0
    from falcon_unzip_tpu_torch.coords import read_m4
    recs = read_m4(out)
    assert len(recs) == 12
    assert all(r.t_name in ("c0", "c1") for r in recs)


def test_cli_gen_gfa_and_dedup(inputs, tmp_path, capsys):
    """Twin of test_pipeline.py::test_cli_gen_gfa_and_dedup on the port's
    unzip of the fixture."""
    d, _ = inputs
    unzip_dir = f"{d}/out/3-unzip"
    gfa = str(tmp_path / "asm.gfa")
    assert main(["gen-gfa", "--unzip-dir", unzip_dir, "--out", gfa]) == 0
    text = open(gfa).read()
    assert text.startswith("H\tVN:Z:1.0")
    assert "\nL\t" in text and "S\t000000F" in text
    out_fa = str(tmp_path / "h.dedup.fa")
    assert main(["dedup", "--p-ctg", f"{unzip_dir}/all_p_ctg.fa",
                 "--h-ctg", f"{unzip_dir}/all_h_ctg.fa", "--out", out_fa,
                 "--device", "cpu"]) == 0
    assert os.path.exists(out_fa)


def test_aligning_subcommands_need_a_device(inputs, tmp_path):
    """--device defaults to cuda, which raises without a GPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    d, _ = inputs
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["track", "--reads", f"{d}/preads.fa", "--contigs",
              f"{d}/draft.fa", "--out", str(tmp_path / "x.msgpack")])


SHIMS = {"fc_unzip": "unzip", "fc_quiver": "quiver", "fc_phasing": "phase",
         "fc_ovlp_filter": "ovlp-filter", "fc_track": "track",
         "fc_dedup": "dedup", "fc_gen_gfa": "gen-gfa",
         "fc_phasing_readmap": "readmap", "fc_phased_ovlp_to_graph": "graph",
         "fc_graphs_to_h_tigs_2": "graph", "fc_rr_hctg_track": "track",
         "fc_rr_hctg_track2": "track", "fc_get_read2ctg": "track",
         "fc_get_read_hctg_map": "track",
         "fc_select_reads_from_bam": "select-reads",
         "fc_unzip_gen_gfa_v1": "gen-gfa"}


@pytest.mark.parametrize("shim", sorted(SHIMS))
def test_compat_shim_forwards(shim, monkeypatch):
    seen = []
    monkeypatch.setattr(compat, "main", lambda argv: seen.append(argv) or 0)
    monkeypatch.setattr(sys, "argv", [shim, "--out", "x", "in.txt"])
    assert getattr(compat, shim)() == 0
    assert seen == [[SHIMS[shim], "--out", "x", "in.txt"]]


def test_compat_shim_runs_readmap(tmp_path, monkeypatch):
    """fc_phasing_readmap through the real command line."""
    a = tmp_path / "phased.0"
    a.write_text("000000F 0 0 r0\n000000F 0 0 r0\n")
    out = tmp_path / "rid_to_phase.all"
    monkeypatch.setattr(sys, "argv", ["fc_phasing_readmap", str(a), "--out",
                                      str(out)])
    assert compat.fc_phasing_readmap() == 0
    assert out.read_text() == "000000F 0 0 r0\n"

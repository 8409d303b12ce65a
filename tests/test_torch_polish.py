"""Port 4-polish (polisher, phase routing, run_quiver) == the JAX package.

Bars:
- consensus sequences (``cns_*.fasta``) byte-identical to the JAX
  package's on the same inputs, and the golden hashes of
  tests/test_golden.py on the golden fixture;
- ``cns_*.fastq``: identical sequence lines; per-base QVs within 1 (the
  margin QV truncates a float margin; the count that differ is reported);
- the re-forward path with the port's CPU pair-HMM scorer reaches the
  decisions of ``oracle.hmm.polish_window_oracle``;
- phase-routing votes are integers and must be equal.

The port's ``run_quiver`` runs on a copy of the JAX run's ``3-unzip/``:
the port's 3-unzip files are byte-identical to the reference's
(tests/test_torch_pipeline.py), so this saves one unzip per fixture.
"""
import hashlib
import json
import os
import shutil

import numpy as np
import pytest
import torch

from falcon_unzip_tpu.config import PipelineConfig
from falcon_unzip_tpu.io.fasta import read_fasta, write_fasta, write_fastq
from falcon_unzip_tpu.models import aligner as ref_aligner
from falcon_unzip_tpu.models import phaser as ref_phaser
from falcon_unzip_tpu.models import polisher as ref_polisher
from falcon_unzip_tpu.oracle.hmm import polish_window_oracle
from falcon_unzip_tpu.oracle.phasing import PhasingConfig
from falcon_unzip_tpu.pipeline.quiver import run_quiver as ref_run_quiver
from falcon_unzip_tpu.pipeline.unzip import run_unzip as ref_run_unzip
from falcon_unzip_tpu.seq import SeqBatch, decode
from falcon_unzip_tpu.utils.simulate import (make_diploid, mutate_read,
                                             random_genome, simulate_reads)
from falcon_unzip_tpu_torch import device as port_device
from falcon_unzip_tpu_torch.models import aligner as port_aligner
from falcon_unzip_tpu_torch.models import phaser as port_phaser
from falcon_unzip_tpu_torch.models import polisher as port_polisher
from falcon_unzip_tpu_torch.ops.pairhmm import PairHMMScorer
from falcon_unzip_tpu_torch.pipeline import quiver as port_quiver

# one intra-op thread: the suite runs several pytest workers on one host,
# and a torch CPU thread pool in each would oversubscribe the cores
torch.set_num_threads(1)

GOLDEN = {"cns_p_ctg.fasta": "2864673ab4dc9bf2",
          "cns_h_ctg.fasta": "70b2521a58bd85f1"}
OUTPUTS = ("cns_p_ctg.fasta", "cns_h_ctg.fasta", "cns_p_ctg.fastq",
           "cns_h_ctg.fastq")


def _fastq(path):
    with open(path) as fh:
        lines = fh.read().splitlines()
    return lines[1::4], lines[3::4]


def _same_polish(ref_dir, port_dir):
    """fasta byte-identical; fastq sequences identical, QVs within 1.
    Returns the number of QVs that differ."""
    n_diff = 0
    for f in OUTPUTS:
        with open(os.path.join(ref_dir, f), "rb") as fh:
            want = fh.read()
        with open(os.path.join(port_dir, f), "rb") as fh:
            got = fh.read()
        if f.endswith(".fasta"):
            assert got == want, f
            continue
        (gs, gq), (ws, wq) = (_fastq(os.path.join(port_dir, f)),
                              _fastq(os.path.join(ref_dir, f)))
        assert gs == ws, f
        for a, b in zip(gq, wq):
            d = np.abs(np.frombuffer(a.encode(), np.uint8).astype(int)
                       - np.frombuffer(b.encode(), np.uint8).astype(int))
            assert d.max(initial=0) <= 1, f
            n_diff += int((d > 0).sum())
    print(f"per-base QVs that differ: {n_diff}")
    return n_diff


def _port_quiver(d, ref_out, name, **cfg_kw):
    """The port's run_quiver on a copy of the JAX run's 3-unzip/."""
    out = os.path.join(d, name)
    shutil.copytree(os.path.join(ref_out, "3-unzip"),
                    os.path.join(out, "3-unzip"))
    cfg = _cfg(d, out, **cfg_kw)
    return cfg, port_quiver.run_quiver(cfg, device="cpu")


def _cfg(d, out, reads="raw.fa", **polish):
    cfg = PipelineConfig(preads=f"{d}/preads.fa", reads=f"{d}/{reads}",
                         draft=f"{d}/draft.fa", out_dir=out)
    for k, v in polish.items():
        setattr(cfg.polish, k, v)
    return cfg


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    """The fixture of tests/test_golden.py through the JAX package."""
    d = str(tmp_path_factory.mktemp("golden"))
    dip = make_diploid(length=6000, het_rate=0.02, seed=77,
                       het_span=(0.3, 0.7))
    pr = simulate_reads(dip, coverage=14.0, read_len=1800, error_rate=0.0,
                        seed=78)
    raw = simulate_reads(dip, coverage=16.0, read_len=1500,
                         error_rate=0.03, seed=79)
    write_fasta(f"{d}/preads.fa", ((pr.batch.names[i], pr.batch.to_str(i))
                                   for i in range(len(pr.batch))))
    write_fasta(f"{d}/raw.fa", ((raw.batch.names[i], raw.batch.to_str(i))
                                for i in range(len(raw.batch))))
    write_fasta(f"{d}/draft.fa", [("d0", decode(dip.hap0))])
    cfg = _cfg(d, f"{d}/ref")
    ref_run_unzip(cfg)
    ref = ref_run_quiver(cfg)
    port_cfg, port = _port_quiver(d, f"{d}/ref", "port")
    return d, cfg, ref, port_cfg, port


def test_run_quiver_golden_matches_jax(golden):
    d, _, ref, _, port = golden
    for f, want in GOLDEN.items():
        with open(f"{d}/port/4-polish/{f}", "rb") as fh:
            assert hashlib.sha256(fh.read()).hexdigest()[:16] == want, f
    _same_polish(f"{d}/ref/4-polish", f"{d}/port/4-polish")
    assert port["p"] == ref["p"] and port["h"] == ref["h"]
    assert abs(port["mean_qv"] - ref["mean_qv"]) <= 1


def test_run_quiver_resume_reloads_alnset(golden, monkeypatch):
    """A partial resume reloads the persisted raw-read AlnSet instead of
    aligning again, and reproduces the outputs."""
    d, _, _, port_cfg, _ = golden
    before = {f: open(f"{d}/port/4-polish/{f}", "rb").read()
              for f in OUTPUTS}

    def _boom(*a, **k):
        raise AssertionError("aligner ran on a resumed quiver")

    monkeypatch.setattr(port_aligner.ReadToContigAligner, "align_batch",
                        _boom)
    os.remove(f"{d}/port/4-polish/cns_p_ctg.fasta")
    port_quiver.run_quiver(port_cfg, device="cpu")
    with open(f"{d}/port/metrics.jsonl") as fh:
        assert any(json.loads(ln)["stage"] == "align_reload" for ln in fh)
    for f in OUTPUTS:
        assert open(f"{d}/port/4-polish/{f}", "rb").read() == before[f], f


def test_quiver_per_base_qv_fastq(tmp_path):
    """tests/test_pipeline.py::test_quiver_per_base_qv_fastq through the
    port's run_quiver: raw reads as FASTQ with a per-base quality track
    (hotspot profile, half reverse-complemented); the run completes and
    emits calibrated consensus that matches one haplotype closely."""
    d = str(tmp_path)
    dip = make_diploid(length=9000, het_rate=0.015, seed=40,
                       het_span=(0.3, 0.7))
    preads = simulate_reads(dip, coverage=16.0, read_len=2200,
                            error_rate=0.0, seed=41)
    raw = simulate_reads(dip, coverage=20.0, read_len=1800,
                         error_rate=0.03, seed=42, rc_frac=0.5,
                         qv_profile="hotspot")
    write_fasta(f"{d}/preads.fa",
                ((preads.batch.names[i], preads.batch.to_str(i))
                 for i in range(len(preads.batch))))
    write_fastq(f"{d}/raw.fastq",
                ((raw.batch.names[i], raw.batch.to_str(i),
                  (raw.quals[i] + 33).tobytes().decode("latin1"))
                 for i in range(len(raw.batch))))
    write_fasta(f"{d}/draft.fa", [("draft0", decode(dip.hap0))])
    ref_run_unzip(_cfg(d, f"{d}/ref", reads="raw.fastq"))
    _, res = _port_quiver(d, f"{d}/ref", "port", reads="raw.fastq")
    assert res["mean_qv"] > 30
    cns = read_fasta(f"{d}/port/4-polish/cns_p_ctg.fasta")
    assert len(cns) >= 1
    s = cns.to_str(0)
    haps = [decode(dip.hap0), decode(dip.hap1)]
    chunks = [s[o : o + 400] for o in range(0, len(s) - 400, 400)]
    n_hit = sum(any(c in h for h in haps) for c in chunks)
    assert n_hit >= 0.9 * len(chunks), (n_hit, len(chunks))


def test_reforward_matches_window_oracle():
    """tests/test_polisher.py::test_arrow_matches_window_oracle with the
    port's CPU pair-HMM scorer in place of the full-matrix scorer."""
    rng = np.random.default_rng(7)
    truth = random_genome(48, 7)
    draft = truth.copy()
    draft[10] = (draft[10] + 1) % 4
    draft[30] = (draft[30] + 2) % 4
    reads = [mutate_read(truth, 0.03, rng) for _ in range(8)]
    cand = [10, 30]
    ref = polish_window_oracle(draft, reads, cand, max_rounds=8)
    st = port_polisher._WinState(
        cns=draft.copy(), votes=np.zeros((48, 9, 5), np.int32), segs=reads,
        active=True, cand=list(cand))
    pol = port_polisher.Polisher(
        port_polisher.PolisherConfig(arrow_rounds=8, use_pallas=False),
        scorer=PairHMMScorer(W=64, device="cpu"))
    pol._refine_windows([st])
    assert np.array_equal(st.cns, ref)
    assert np.array_equal(st.cns, truth)


def _window_aln(seed, cov=14, L=384, n_sub=2):
    rng = np.random.default_rng(seed)
    truth = random_genome(L, seed)
    draft = truth.copy()
    pos = np.sort(rng.choice(np.arange(40, L - 40), size=n_sub + 1,
                             replace=False))
    for p in pos[:n_sub]:
        draft[p] = (draft[p] + 1) % 4
    draft = np.delete(draft, pos[n_sub:])
    reads = [mutate_read(truth, 0.05, rng) for _ in range(cov)]
    batch = SeqBatch.from_strs(reads, names=[f"r{i}"
                                             for i in range(len(reads))])
    aln = ref_aligner.ReadToContigAligner([draft]).align_batch(batch)
    return truth, draft, aln


@pytest.mark.parametrize("path", ["splice", "per-base", "reforward"])
def test_polisher_matches_jax(path):
    """Both refinement paths, the splice one also with per-base quality
    tiers, on a multi-error window (the setup of
    tests/test_polisher.py::test_arrow_converges_on_multi_error_window):
    equal consensus and QVs from the JAX and the port polisher."""
    truth, draft, aln = _window_aln(60)
    port_aln = port_aligner.AlnSet.from_bytes(aln.to_bytes())
    kw = dict(window=512, arrow_rounds=8, arrow_candidates=8,
              margin_frac=0.9)
    if path == "per-base":
        rng = np.random.default_rng(61)
        qtiers = [ref_polisher.phred_to_tiers(
            rng.integers(3, 40, int(aln.q_len.max()) + 64).astype(np.uint8))
            for _ in range(int(aln.read_id.max()) + 1)]
        ref_pol = ref_polisher.Polisher(ref_polisher.PolisherConfig(**kw),
                                        read_qtiers=qtiers)
        port_pol = port_polisher.Polisher(port_polisher.PolisherConfig(**kw),
                                          read_qtiers=qtiers, device="cpu")
    elif path == "reforward":
        from falcon_unzip_tpu.ops.pairhmm import PairHMMScorer as RefScorer
        ref_pol = ref_polisher.Polisher(ref_polisher.PolisherConfig(**kw),
                                        scorer=RefScorer(W=64))
        port_pol = port_polisher.Polisher(
            port_polisher.PolisherConfig(**kw),
            scorer=PairHMMScorer(W=64, device="cpu"))
    else:
        ref_pol = ref_polisher.Polisher(ref_polisher.PolisherConfig(**kw))
        port_pol = port_polisher.Polisher(port_polisher.PolisherConfig(**kw),
                                          device="cpu")
    want = ref_pol.polish_contig("w", draft, aln, 0)
    got = port_pol.polish_contig("w", draft, port_aln, 0)
    assert np.array_equal(got.seq, want.seq)
    assert np.abs(got.qv.astype(int) - want.qv.astype(int)).max() <= 1
    if path == "splice":
        assert np.array_equal(got.seq, truth)


def test_template_route_votes_match_jax():
    """Phase-routing votes (integers) equal the reference's on the fixture
    of tests/test_polisher.py::test_phase_route_mask_drops_opposite_reads,
    through the driver-level call and the verbatim _phase_route_mask."""
    dip = make_diploid(length=9000, het_rate=0.02, seed=95,
                       het_span=(0.1, 0.9))
    rng = np.random.default_rng(96)
    reads = []
    for i in range(60):
        g = dip.hap0 if i % 2 == 0 else dip.hap1
        s = rng.integers(0, 5000)
        reads.append(mutate_read(g[s : s + 4000], 0.02, rng))
    batch = SeqBatch.from_strs(reads, names=[f"r{i}" for i in range(60)])
    aln = ref_aligner.ReadToContigAligner([dip.hap0]).align_batch(batch)
    port_aln = port_aligner.AlnSet.from_bytes(aln.to_bytes())
    args = ([0], [len(dip.hap0)], [dip.hap0], PhasingConfig())
    want = ref_phaser.template_route_votes(aln, *args)
    got = port_phaser.template_route_votes(port_aln, *args, device="cpu")
    assert len(got) == len(want) == 1
    for g, w in zip(got[0], want[0]):
        assert np.array_equal(g, w)
    assert (want[0][1] < 0).sum() > 0
    from falcon_unzip_tpu.pipeline.quiver import _phase_route_mask
    cfg = PipelineConfig(preads="x", out_dir="/tmp/x")
    with port_device.scope("cpu"):
        keep = port_quiver._phase_route_mask(port_aln, [0], [len(dip.hap0)],
                                             [dip.hap0], cfg)
    assert np.array_equal(keep, _phase_route_mask(
        aln, [0], [len(dip.hap0)], [dip.hap0], cfg))


def test_unported_quiver_options_raise(tmp_path):
    with pytest.raises(FileNotFoundError):
        port_quiver.run_quiver(_cfg(str(tmp_path), str(tmp_path / "out")),
                               device="cpu")

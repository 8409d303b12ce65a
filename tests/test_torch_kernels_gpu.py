"""CUDA kernels == their plain torch versions, on the card.

The banded wavefront, its traceback (the moves and the fused packed and
summary epilogues) and the pair-HMM step ablation must be bit-exact; the
float kernels (pair-HMM forward, Arrow splice sweeps: their raw outputs
and the splice scores) within ``|kernel - plain| <= 1e-3 * max(1,
|plain|)`` with NEG slots equal.

Marked ``gpu``: these need an NVIDIA GPU and nvcc and skip elsewhere.
Run them on a GPU machine with
``python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py``
(the repository's conftest imports JAX; this file imports only the port).
"""
import hashlib

import numpy as np
import pytest
import torch

from falcon_unzip_tpu_torch.ops import _kernels
from falcon_unzip_tpu_torch.ops import banded_align as ba
from falcon_unzip_tpu_torch.seq import SeqBatch
from falcon_unzip_tpu_torch.utils import arrow_batches as ab
from falcon_unzip_tpu_torch.utils.fixtures import template_reads
from falcon_unzip_tpu_torch.utils import hmm_batches as hb
from falcon_unzip_tpu_torch.utils.simulate import mutate_read, random_genome

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def _batch(W, mode, seed, P=48):
    rng = np.random.default_rng(seed)
    qs, ts = [], []
    for k in range(P):
        t = random_genome(int(rng.integers(200, 700)), seed * 1000 + k)
        src = t if mode == "global" else t[: int(rng.integers(100, len(t)))]
        qs.append(mutate_read(src, 0.0 if k % 2 else 0.15, rng))
        ts.append(t)
    qs.append(qs[0][:0])                                   # n = 0
    ts.append(ts[0])
    qs.append(random_genome(W + 200, seed + 1))            # no end found
    ts.append(random_genome(80, seed + 2))
    qb, tb = SeqBatch.from_strs(qs), SeqBatch.from_strs(ts)
    return (qb.data, tb.data, qb.lengths.astype(np.int32),
            tb.lengths.astype(np.int32))


# the built layouts' own widths and ragged widths between them (run on the
# narrowest wider layout with the cells past W held out of the band)
_WIDTHS = [2, 16, 33, 48, 96, 128, 200, 256, 384, 512, 640, 768, 1024, 1100,
           2048, 4096]


@pytest.mark.parametrize("W", _WIDTHS)
@pytest.mark.parametrize("mode", ["global", "qglocal", "tglocal"])
def test_kernels_match_plain_on_card(cuda, W, mode):
    q, t, n, m = _batch(W, mode, seed=W + len(mode))
    Dmax, lo = ba.build_schedule(q.shape[1], t.shape[1], W)
    qg, trg, G = ba.prepare_batch(q, t, W)
    args = [torch.from_numpy(x).to(cuda) for x in (qg, trg, n, m)]
    kw = dict(W=W, Lt=t.shape[1], G=G, mode=mode)
    _kernels.reset_counts()
    k = ba.banded_align_batch(*args, lo, **kw)
    p = ba.banded_align_batch_plain(*args, lo, **kw)
    for key in ("dist", "end_i", "end_j", "bp"):
        assert torch.equal(k[key], p[key]), key
    tk = ba.traceback_batch(k["bp"], lo, k["end_i"], k["end_j"],
                            max_steps=Dmax - 1)
    tp = ba.traceback_batch_plain(p["bp"], lo, p["end_i"], p["end_j"],
                                  max_steps=Dmax - 1)
    torch.cuda.synchronize()
    assert torch.equal(tk, tp)
    assert (_kernels.WAVEFRONT.launches, _kernels.TRACEBACK.launches) \
        == (1, 1)


def _hard_batch(W, mode, seed):
    """Pairs that stress the early stop and the traceback's reloads: short
    pairs in a long bucket (n + m under half of Dmax), n = 0, m = 0, an
    all-insertion path (query against an empty target, global), pairs
    that cannot align (dist INF, end_j -1) and ordinary long ones."""
    rng = np.random.default_rng(seed)
    qs, ts = [], []
    for k in range(12):                                    # short pairs
        t = random_genome(int(rng.integers(40, 300)), seed * 77 + k)
        src = t if mode == "global" else t[: int(rng.integers(20, len(t)))]
        qs.append(mutate_read(src, 0.15 * (k % 2), rng))
        ts.append(t)
    for k in range(6):                                     # long pairs
        t = random_genome(int(rng.integers(1500, 2300)), seed * 79 + k)
        src = t if mode == "global" else t[50 : int(rng.integers(900, 1400))]
        qs.append(mutate_read(src, 0.15 * (k % 2), rng))
        ts.append(t)
    qs.append(qs[0][:0])                                   # n = 0
    ts.append(ts[0])
    qs.append(random_genome(90, seed + 3))                 # m = 0
    ts.append(ts[0][:0])
    for k in range(3):                                     # cannot align
        qs.append(random_genome(W + 200 + 300 * k, seed + 10 + k))
        ts.append(random_genome(80, seed + 20 + k))
    qb, tb = SeqBatch.from_strs(qs), SeqBatch.from_strs(ts)
    return (qb.data, tb.data, qb.lengths.astype(np.int32),
            tb.lengths.astype(np.int32))


@pytest.mark.parametrize("W", [2, 32, 33, 128, 200, 256, 384, 512, 1024,
                               2048])
@pytest.mark.parametrize("mode", ["global", "qglocal", "tglocal"])
def test_early_stop_and_epilogues_match_plain_on_card(cuda, W, mode):
    """Short pairs in a long bucket, degenerate and unalignable pairs:
    the wavefront, the moves and both fused epilogues equal their plain
    versions, and bp past d = n + m is MOVE_NONE."""
    q, t, n, m = _hard_batch(W, mode, seed=3 * W + len(mode))
    Dmax, lo = ba.build_schedule(q.shape[1], t.shape[1], W)
    assert int((n + m)[:12].max()) < Dmax // 2
    qg, trg, G = ba.prepare_batch(q, t, W)
    args = [torch.from_numpy(x).to(cuda) for x in (qg, trg, n, m)]
    kw = dict(W=W, Lt=t.shape[1], G=G, mode=mode)
    p = ba.banded_align_batch_plain(*args, lo, **kw)
    if mode != "global":
        assert int((p["dist"] >= 1 << 20).sum()) >= 3
    k = _kernels.banded_wavefront(*args, Dmax=Dmax, want_bp=True, **kw)
    for key in ("dist", "end_i", "end_j", "bp"):
        assert torch.equal(k[key], p[key]), key
    k_nobp = _kernels.banded_wavefront(*args, Dmax=Dmax, want_bp=False, **kw)
    for key in ("dist", "end_i", "end_j"):
        assert torch.equal(k_nobp[key], p[key]), key
    ends = (p["dist"], p["end_i"], p["end_j"])
    _kernels.reset_counts()
    for steps in (Dmax - 1, 100):
        assert torch.equal(
            ba.traceback_batch(k["bp"], lo, *ends[1:], max_steps=steps),
            ba.traceback_batch_plain(p["bp"], lo, *ends[1:],
                                     max_steps=steps))
        assert torch.equal(
            ba.traceback_packed(k["bp"], lo, *ends, max_steps=steps),
            ba.traceback_packed_plain(p["bp"], lo, *ends, max_steps=steps))
        assert torch.equal(
            ba.traceback_summary(k["bp"], lo, *ends, max_steps=steps),
            ba.traceback_summary_plain(p["bp"], lo, *ends, max_steps=steps))
    torch.cuda.synchronize()
    assert _kernels.TRACEBACK.launches == 6


def test_rows_too_long_for_shared_memory_on_card(cuda):
    """A bucket whose guarded rows exceed the kernel's shared-memory
    staging limit (96 KB a pair): the wavefront reads them where they
    are, with the same result."""
    W, L = 128, 50000
    q0, t0, n, m = _batch(W, "tglocal", seed=5, P=6)
    q = np.full((len(n), L), 4, np.int8)
    t = np.full((len(n), L), 4, np.int8)
    q[:, : q0.shape[1]] = q0
    t[:, : t0.shape[1]] = t0
    Dmax, lo = ba.build_schedule(L, L, W)
    Dmax = min(Dmax, -(-(int((n + m).max()) + 1) // 1024) * 1024)
    lo = lo[:Dmax]
    qg, trg, G = ba.prepare_batch(q, t, W)
    assert qg.shape[1] + trg.shape[1] > 96 * 1024
    args = [torch.from_numpy(x).to(cuda) for x in (qg, trg, n, m)]
    kw = dict(W=W, Lt=L, G=G, mode="tglocal")
    p = ba.banded_align_batch_plain(*args, lo, **kw)
    assert int((p["dist"] < 1 << 20).sum()) >= 6
    k = _kernels.banded_wavefront(*args, Dmax=Dmax, want_bp=True, **kw)
    for key in ("dist", "end_i", "end_j", "bp"):
        assert torch.equal(k[key], p[key]), key


@pytest.mark.parametrize("p_none", [0.0, 0.002, 0.25])
def test_traceback_follows_arbitrary_moves_on_card(cuda, p_none):
    """Random packed moves (mostly diagonal, so the walks are long and
    drift to the band's edges; with and without MOVE_NONE) and random ends
    (also outside the band and the schedule): the kernel's steady walk,
    its window reloads and the clipping of d and w give the plain
    version's moves, packing and summary."""
    rng = np.random.default_rng(9)
    probs = np.array([0.5, 0.25, 0.25, 0.0]) * (1 - p_none)
    probs[3] = p_none
    # also bands narrower than the kernel's 64-word window (W < 64) and
    # wider than 2048
    for W, Dmax, P in ((32, 200, 40), (64, 333, 40), (128, 700, 40),
                       (256, 1500, 40), (512, 2100, 40), (1, 150, 40),
                       (2, 170, 40), (16, 250, 40), (33, 300, 40),
                       (200, 900, 40), (3000, 700, 6), (4096, 600, 4)):
        _, lo = ba.build_schedule(Dmax - 1, 0, W)
        fields = rng.choice(4, p=probs, size=(-(-Dmax // 16), P, W, 16))
        words = (fields.astype(np.int64) << (2 * np.arange(16))).sum(-1)
        bp = torch.from_numpy(words.astype(np.uint32).view(np.int32))
        end_i = torch.from_numpy(
            rng.integers(-5, Dmax, size=P).astype(np.int32))
        end_j = torch.from_numpy(
            rng.integers(-5, Dmax, size=P).astype(np.int32))
        dist = torch.from_numpy(rng.integers(0, 99, size=P).astype(np.int32))
        cpu = (bp, lo, dist, end_i, end_j)
        dev = (bp.to(cuda), lo, dist.to(cuda), end_i.to(cuda),
               end_j.to(cuda))
        for steps in (Dmax - 1, 37):
            want = ba.traceback_batch_plain(bp, lo, end_i, end_j,
                                            max_steps=steps)
            if p_none == 0.0 and steps > 37:
                assert int((want != ba.MOVE_NONE).sum(1).max()) > Dmax // 2
            assert torch.equal(
                ba.traceback_batch(dev[0], lo, *dev[3:],
                                   max_steps=steps).cpu(), want)
            assert torch.equal(
                ba.traceback_packed(*dev, max_steps=steps).cpu(),
                ba.traceback_packed_plain(*cpu, max_steps=steps))
            assert torch.equal(
                ba.traceback_summary(*dev, max_steps=steps).cpu(),
                ba.traceback_summary_plain(*cpu, max_steps=steps))


def test_aligner_dispatch_is_fused_on_card(cuda):
    """BandedAligner on the card: one wavefront and one traceback launch
    a chunk in every mode of want_moves, results equal to the CPU path."""
    q, t, n, m = _batch(128, "tglocal", seed=21)
    for want, launches in ((True, (1, 1)), ("summary", (1, 1)),
                           (False, (1, 0))):
        _kernels.reset_counts()
        got = ba.BandedAligner(W=128, mode="tglocal", device="cuda")(
            q, t, n, m, want_moves=want)
        assert (_kernels.WAVEFRONT.launches,
                _kernels.TRACEBACK.launches) == launches
        ref = ba.BandedAligner(W=128, mode="tglocal", device="cpu")(
            q, t, n, m, want_moves=want)
        assert sorted(got) == sorted(ref)
        for key in ref:
            if key == "moves":
                assert all(np.array_equal(a, b)
                           for a, b in zip(got[key], ref[key]))
            else:
                assert np.array_equal(got[key], ref[key]), key


def test_golden_pipeline_on_card(cuda, tmp_path):
    from falcon_unzip_tpu_torch.config import PipelineConfig
    from falcon_unzip_tpu_torch.io.fasta import write_fasta
    from falcon_unzip_tpu_torch.seq import decode
    from falcon_unzip_tpu_torch.utils.simulate import (make_diploid,
                                                       simulate_reads)
    from falcon_unzip_tpu_torch.pipeline.unzip import run_unzip
    d = str(tmp_path)
    dip = make_diploid(length=6000, het_rate=0.02, seed=77,
                       het_span=(0.3, 0.7))
    pr = simulate_reads(dip, coverage=14.0, read_len=1800,
                        error_rate=0.0, seed=78)
    write_fasta(f"{d}/preads.fa", ((pr.batch.names[i], pr.batch.to_str(i))
                                   for i in range(len(pr.batch))))
    write_fasta(f"{d}/draft.fa", [("d0", decode(dip.hap0))])
    _kernels.reset_counts()
    run_unzip(PipelineConfig(preads=f"{d}/preads.fa", draft=f"{d}/draft.fa",
                             out_dir=f"{d}/out"), device="cuda")
    golden = {"all_p_ctg.fa": "2864673ab4dc9bf2",
              "all_h_ctg.fa": "70b2521a58bd85f1",
              "all_phased_reads": "3c3f04ee8364d5f6"}
    for rel, want in golden.items():
        with open(f"{d}/out/3-unzip/{rel}", "rb") as fh:
            assert hashlib.sha256(fh.read()).hexdigest()[:16] == want, rel
    assert _kernels.WAVEFRONT.launches > 0
    assert _kernels.TRACEBACK.launches > 0


def test_falcon_sense_shape_matches_plain_on_card(cuda):
    """FalconSense's largest launch: W = 128 tglocal, the query bucket
    16384 (reads of 8193 bases and more), P = 64, each read against its
    template window padded by 48 bases, the schedule cut as
    BandedAligner.dispatch cuts it.  The wavefront (rows staged in shared
    memory), the moves and the fused packed epilogue equal their plain
    versions."""
    from falcon_unzip_tpu_torch.models.aligner import _t_bucket
    W, P, bq = 128, 64, 16384
    _, template, reads, spans = template_reads(60000, 160, seed=31,
                                               rc=False)
    pick = [k for k, r in enumerate(reads) if len(r) > bq // 2][:P]
    assert len(pick) == P
    qs = [reads[k] for k in pick]
    ts = [template[max(0, spans[k][0] - 48) : spans[k][1] + 48]
          for k in pick]
    bt = _t_bucket(max(len(x) for x in ts), bq)
    q = np.full((P, bq), 4, np.int8)
    t = np.full((P, bt), 4, np.int8)
    for k in range(P):
        q[k, : len(qs[k])] = qs[k]
        t[k, : len(ts[k])] = ts[k]
    n = np.array([len(x) for x in qs], np.int32)
    m = np.array([len(x) for x in ts], np.int32)
    Dmax, lo = ba.build_schedule(bq, bt, W)
    Dmax = min(Dmax, -(-(int((n + m).max()) + 1) // 1024) * 1024)
    lo = lo[:Dmax]
    qg, trg, G = ba.prepare_batch(q, t, W)
    assert qg.shape[1] + trg.shape[1] < 96 * 1024       # staged rows
    args = [torch.from_numpy(x).to(cuda) for x in (qg, trg, n, m)]
    kw = dict(W=W, Lt=bt, G=G, mode="tglocal")
    _kernels.reset_counts()
    k = ba.banded_align_batch(*args, lo, **kw)
    p = ba.banded_align_batch_plain(*args, lo, **kw)
    for key in ("dist", "end_i", "end_j", "bp"):
        assert torch.equal(k[key], p[key]), key
    assert int((p["dist"] < 1 << 20).sum()) == P
    ends = (p["dist"], p["end_i"], p["end_j"])
    tk = ba.traceback_batch(k["bp"], lo, *ends[1:], max_steps=Dmax - 1)
    tp = ba.traceback_batch_plain(p["bp"], lo, *ends[1:],
                                  max_steps=Dmax - 1)
    assert torch.equal(tk, tp)
    assert int((tp != ba.MOVE_NONE).sum(1).min()) > bq // 2
    assert torch.equal(
        ba.traceback_packed(k["bp"], lo, *ends, max_steps=Dmax - 1),
        ba.traceback_packed_plain(p["bp"], lo, *ends, max_steps=Dmax - 1))
    torch.cuda.synchronize()
    assert (_kernels.WAVEFRONT.launches, _kernels.TRACEBACK.launches) \
        == (1, 2)


def test_falcon_sense_card_equals_cpu_on_card(cuda):
    """FalconSense on a 20 kb template, 16 reads of 10 kb mean at 8%, half
    reverse-complemented: the card's consensus equals the CPU's (the plain
    versions) byte for byte, through the kernels."""
    from falcon_unzip_tpu_torch.models.consensus import (ConsensusConfig,
                                                         FalconSense)
    _, template, reads, _ = template_reads(20000, 16, seed=32)
    _kernels.reset_counts()
    got = FalconSense(ConsensusConfig(), "cuda")(template, reads)
    launches = (_kernels.WAVEFRONT.launches, _kernels.TRACEBACK.launches)
    want = FalconSense(ConsensusConfig(), "cpu")(template, reads)
    assert len(want) > 19000
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert min(launches) >= 2        # the 8192 and 16384 query buckets


def _close(k, p):
    k, p = k.double().cpu(), p.double().cpu()
    assert torch.equal(k < -1e29, p < -1e29)
    ok = p > -1e29
    err = (k - p).abs()[ok]
    assert bool((err <= 1e-3 * p.abs()[ok].clamp(min=1.0)).all()), \
        float(err.max())


@pytest.mark.parametrize("W", [16, 32, 48, 64, 96, 128, 200, 256, 384, 512,
                               640, 768, 1024, 2048, 4096])
def test_pairhmm_kernel_matches_plain_on_card(cuda, W):
    from falcon_unzip_tpu_torch.ops import pairhmm as ph
    q, t, n, m = _batch(W, "global", seed=W + 7, P=40)
    Dmax, lo = ba.build_schedule(q.shape[1], t.shape[1], W)
    qg, trg, G = ba.prepare_batch(q, t, W)
    args = [torch.from_numpy(x).to(cuda) for x in (qg, trg, n, m)]
    pvec = ph.params_vector()
    _kernels.reset_counts()
    k = ph.pairhmm_forward(*args, lo, pvec, W=W, Lt=t.shape[1], G=G)
    p = ph.pairhmm_forward_plain(*args, lo, pvec, W=W, Lt=t.shape[1], G=G)
    torch.cuda.synchronize()
    _close(k, p)
    assert _kernels.PAIRHMM.launches == 1


def _pairhmm_matches_plain(batch, W, dev):
    """The forward kernel on a batch of ``utils/hmm_batches.py`` equals the
    plain version within the float bar, the out-of-band pairs exactly NEG
    on both sides; one launch."""
    from falcon_unzip_tpu_torch.ops import pairhmm as ph
    args, kw = hb.to_device(batch, W, ph.params_vector(), dev)
    _kernels.reset_counts()
    k = ph.pairhmm_forward(*args, **kw)
    assert _kernels.PAIRHMM.launches == 1
    p = ph.pairhmm_forward_plain(*args, **kw)
    torch.cuda.synchronize()
    _close(k, p)
    out = p < -1e29
    assert bool((k[out] == -1e30).all()) and bool((p[out] == -1e30).all())


# each build of the forward: (band width, a batch size it is launched at or
# None for the batch's own, the cells a lane the launch takes)
_HMM_BUILDS = [(32, None, 1), (64, None, 2), (128, None, 1), (128, 600, 2),
               (256, None, 2), (512, None, 2),
               # ragged widths (the cells past W held at NEG) and wide ones
               (16, None, 1), (33, None, 2), (96, None, 1), (96, 600, 2),
               (200, None, 2), (384, None, 2), (1024, None, 2),
               (1500, None, 3), (2048, None, 4)]


@pytest.mark.parametrize("W, P, cells", _HMM_BUILDS)
@pytest.mark.parametrize("kind", hb.EDGE_KINDS)
def test_pairhmm_kernel_edge_batches_on_card(cuda, kind, W, P, cells):
    """Every build of the forward on the edge batches (at W = 128 also
    repeated to P = 600, the two-cells-a-lane build): corners out of the
    band, n = 0 or m = 0, n + m ending around the prologue's end (W - 1 ..
    W + 4), a cut schedule of odd length, corners at the band's edges, long
    and short pairs mixed, P = 1 and P = 37."""
    b = hb.edge_batch(kind, W, P=P)
    assert _kernels.pairhmm_cells(W, len(b["n"])) == cells
    _pairhmm_matches_plain(b, W, cuda)


@pytest.mark.parametrize("W, P, cells", _HMM_BUILDS)
def test_pairhmm_kernel_rows_too_long_for_shared_memory_on_card(cuda, W, P,
                                                               cells):
    """Guarded rows past the kernel's shared-memory stage (96 KB): the
    builds that read the bases from device memory, on short and long
    pairs in 50 kb rows."""
    rng = np.random.default_rng(W)
    L = 50_000
    specs = [(0, 0), (5, 9), (W + 3, W), (700, 690), (2 * W, 2 * W + 40),
             (400, 395)]
    if P is not None:
        specs = (specs * -(-P // len(specs)))[:P]
    q, t, n, m = hb.pack(rng, specs, Lq=L, Lt=L)
    assert _kernels.pairhmm_cells(W, len(n)) == cells
    batch = {"q": q, "t": t, "n": n, "m": m, "Dmax": 2 * L + 1}
    _pairhmm_matches_plain(batch, W, cuda)


def _arrow_matches_plain(args, C):
    """The sweep kernel's raw outputs (afM, afI, afD, bM, bD, ll_cur) and
    the splice scores built on them equal the plain versions within the
    float bar, NEG slots equal; one launch."""
    from falcon_unzip_tpu_torch.ops import arrow as ar
    _kernels.reset_counts()
    k_sw = _kernels.arrow_sweeps(*args, C=C)
    assert _kernels.ARROW.launches == 1
    p_sw = ar.arrow_sweeps_plain(*args, C=C)
    torch.cuda.synchronize()
    for name, k, p in zip(("afM", "afI", "afD", "bM", "bD", "ll_cur"),
                          k_sw, p_sw):
        assert k.shape == p.shape, name
        _close(k, p)
    k_cur, k_mut = ar.splice_from_sweeps(*args, k_sw, C=C)
    p_cur, p_mut = ar.splice_from_sweeps(*args, p_sw, C=C)
    _close(k_cur, p_cur)
    _close(k_mut, p_mut)


@pytest.mark.parametrize("mode", ["per-pair", "per-base"])
@pytest.mark.parametrize("LJ", [128, 640])
def test_arrow_kernel_matches_plain_on_card(cuda, mode, LJ):
    from falcon_unzip_tpu_torch.ops import arrow as ar
    from falcon_unzip_tpu_torch.ops.pairhmm import params_vector
    from falcon_unzip_tpu_torch.models.polisher import tier_table
    rng = np.random.default_rng(LJ + len(mode))
    P, C = 24, 4
    Lq = LJ
    q = np.full((P, Lq), 4, np.int8)
    t = np.full((P, LJ), 4, np.int8)
    n = np.zeros(P, np.int32)
    m = np.zeros(P, np.int32)
    cand = np.full((P, C), -1, np.int32)
    for k in range(P - 1):                   # the last pair is padding
        tk = random_genome(int(rng.integers(LJ // 3, LJ - 1)), k)
        qk = mutate_read(tk, 0.15 * (k % 2), rng)[:Lq]
        q[k, : len(qk)] = qk
        t[k, : len(tk)] = tk
        n[k], m[k] = len(qk), len(tk)
        cols = [m[k] - 1, 0, m[k] // 2, 7][: 1 + k % C]
        cand[k, : len(cols)] = cols
    pvec = np.tile(params_vector(), (P, 1))
    tiers = tier_table()
    qt = rng.integers(0, len(tiers), size=(P, Lq + 1)).astype(np.int8)
    dt = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(cuda)
    args = [dt(x) for x in (q, t, n, m, cand, pvec)]
    args += [dt(qt), dt(tiers)] if mode == "per-base" else [None, None]
    _arrow_matches_plain(args, C)
    _kernels.reset_counts()
    k_cur, k_mut = ar.arrow_splice(*args, C=C)
    p_cur, p_mut = ar.arrow_splice_plain(*args, C=C)
    torch.cuda.synchronize()
    _close(k_cur, p_cur)
    _close(k_mut, p_mut)
    assert _kernels.ARROW.launches == 1


# a batch size of each build of the sweep kernel: 8 warps a block up to
# P = 132 on an H100, 2 above
_ARROW_P = {8: 64, 2: 256}


@pytest.mark.parametrize("nw", [8, 2])
@pytest.mark.parametrize("mode", ["per-pair", "per-base"])
@pytest.mark.parametrize("kind", ab.EDGE_KINDS)
def test_arrow_kernel_edge_shapes_on_card(cuda, kind, mode, nw):
    """Lq = LJ = 640, C = 4, in each build (8 and 2 warps a block, the
    batch padded to its P): padding pairs (n = 0, m = 0), n and m at the
    warp edges and the stripe edges of the builds (31..33, 63..65,
    127..129, 255..257), n > m, n < m, m much smaller than LJ, and
    m = LJ - 1 with cand = m - 1 and m - 2 (the slots that clip to column
    m)."""
    assert _kernels.arrow_warps(_ARROW_P[nw]) == nw
    rng = np.random.default_rng(len(kind) * 31 + len(mode))
    specs = ab.edge_specs(kind, LJ=640)
    arrays = ab.pack(rng, specs, Lq=640, LJ=640, C=4, P=_ARROW_P[nw])
    _arrow_matches_plain(ab.to_device(arrays, mode, cuda), 4)


@pytest.mark.parametrize("mode", ["per-pair", "per-base"])
@pytest.mark.parametrize("P", [1, 16, 256, 512])
def test_arrow_kernel_batch_sizes_on_card(cuda, P, mode):
    """The polish's launch sizes at its pinned shape (Lq = LJ = 640,
    C = 4, lengths 300-420), the last eighth of a batch padding pairs:
    P = 1 and 16 run the 8-warp build, 256 and 512 the 2-warp one."""
    rng = np.random.default_rng(P + len(mode))
    specs = ab.polish_specs(rng, P - P // 8, LJ=640, C=4)
    arrays = ab.pack(rng, specs, Lq=640, LJ=640, C=4, P=P)
    _arrow_matches_plain(ab.to_device(arrays, mode, cuda), 4)


@pytest.mark.parametrize("nw", [8, 2])
@pytest.mark.parametrize("mode", ["per-pair", "per-base"])
@pytest.mark.parametrize("C", [9, 20])
def test_arrow_kernel_many_candidates_on_card(cuda, C, mode, nw):
    """More candidates a pair than the 8 whose 3C backward slots fit the
    kernel's first column word (the builds with further slot words): C =
    9 (one further word backward) and C = 20 (two), with clipped and
    unused slots, in each warp count."""
    rng = np.random.default_rng(C + len(mode))
    arrays = ab.pack(rng, ab.wide_specs(rng, LJ=640, C=C), Lq=640, LJ=640,
                     C=C, P=_ARROW_P[nw])
    _arrow_matches_plain(ab.to_device(arrays, mode, cuda), C)


@pytest.mark.parametrize("P", [1, 37, 256])
@pytest.mark.parametrize("Dmax", [1, 2, 33, 128, 129, 130, 131, 385, 1025])
def test_ablation_kernel_equals_plain_on_card(cuda, Dmax, P):
    """From the NEG start (out NEG everywhere) bit-exact; at the probe,
    where each part changes out, bit-exact without the logaddexps and
    within 1e-5 relative with them.  Dmax around the phase boundaries
    (d = W, W + 1, W + 2, an odd and an even tail), one row to a full
    card."""
    from falcon_unzip_tpu_torch.ops import pairhmm_ablate as pa
    rng = np.random.default_rng(Dmax)
    qg = torch.from_numpy(
        rng.integers(0, 5, size=(P, 1024)).astype(np.int32)).to(cuda)
    neg = torch.from_numpy(pa.neg_init(P, 128)).to(cuda)
    probe = [torch.from_numpy(x).to(cuda)
             for x in pa.probe_inputs(P, 1024, 128, Dmax)]
    for feats in pa.FEATURE_SETS:
        _kernels.reset_counts()
        k = pa.pairhmm_ablate(qg, neg, feats, Dmax=Dmax)
        p = pa.pairhmm_ablate_plain(qg, neg, feats, Dmax=Dmax)
        torch.cuda.synchronize()
        assert torch.equal(k, p), feats                 # tolerance 0
        assert _kernels.ABLATE.launches == 1
        k = pa.pairhmm_ablate(*probe, feats, Dmax=Dmax)
        p = pa.pairhmm_ablate_plain(*probe, feats, Dmax=Dmax)
        assert bool((p > -1e29).all())
        if "lse" in feats:
            torch.testing.assert_close(k, p, rtol=1e-5, atol=0)
        else:
            assert torch.equal(k, p), feats             # tolerance 0


def test_layouts_of_every_width_on_card(cuda):
    """Every band width from 1 to 4096 has a layout at least as wide in
    both band kernels (its own width where one is built), and the
    bindings refuse the widths past 4096 before anything is launched."""
    built = {32, 64, 128, 256, 384, 512, 640, 768, 896, 1024, 1536, 2048,
             3072, 4096}
    for kernel in ("banded_wavefront", "pairhmm_forward"):
        prev = 0
        for W in range(1, 4097):
            wp = _kernels.layout_width(kernel, W)
            assert wp >= W and (wp == W) == (W in built), (kernel, W)
            assert wp >= prev
            prev = wp
    x8 = torch.zeros((2, 8192), dtype=torch.int8, device=cuda)
    i32 = torch.zeros(2, dtype=torch.int32, device=cuda)
    _kernels.reset_counts()
    with pytest.raises(ValueError, match="4097 is outside 1..4096"):
        _kernels.banded_wavefront(x8, x8, i32, i32, W=4097, Lt=16, G=4099,
                                  Dmax=33, mode="global", want_bp=True)
    with pytest.raises(ValueError, match="4097 is outside 1..4096"):
        _kernels.pairhmm_forward(x8, x8, i32, i32, [0.0] * 10, W=4097,
                                 Lt=16, G=4099, Dmax=33)
    assert all(k.launches == 0 for k in _kernels.KERNELS)

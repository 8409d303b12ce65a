"""CUDA kernels == their plain torch versions, on the card.

The banded wavefront, its traceback and the pair-HMM step ablation must
be bit-exact; the float kernels (pair-HMM forward, Arrow splice sweeps)
within ``|kernel - plain| <= 1e-3 * max(1, |plain|)`` with NEG slots
equal.

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


@pytest.mark.parametrize("W", [128, 256, 512])
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


def _close(k, p):
    k, p = k.double().cpu(), p.double().cpu()
    assert torch.equal(k < -1e29, p < -1e29)
    ok = p > -1e29
    err = (k - p).abs()[ok]
    assert bool((err <= 1e-3 * p.abs()[ok].clamp(min=1.0)).all()), \
        float(err.max())


@pytest.mark.parametrize("W", [32, 64, 128, 256, 512])
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
    _kernels.reset_counts()
    k_cur, k_mut = ar.arrow_splice(*args, C=C)
    p_cur, p_mut = ar.arrow_splice_plain(*args, C=C)
    torch.cuda.synchronize()
    _close(k_cur, p_cur)
    _close(k_mut, p_mut)
    assert _kernels.ARROW.launches == 1


@pytest.mark.parametrize("Dmax", [33, 385, 1025])
def test_ablation_kernel_equals_plain_on_card(cuda, Dmax):
    """From the NEG start (out NEG everywhere) bit-exact; at the probe,
    where each part changes out, bit-exact without the logaddexps and
    within 1e-5 relative with them."""
    from falcon_unzip_tpu_torch.ops import pairhmm_ablate as pa
    rng = np.random.default_rng(Dmax)
    qg = torch.from_numpy(
        rng.integers(0, 5, size=(37, 1024)).astype(np.int32)).to(cuda)
    neg = torch.from_numpy(pa.neg_init(37, 128)).to(cuda)
    probe = [torch.from_numpy(x).to(cuda)
             for x in pa.probe_inputs(37, 1024, 128, Dmax)]
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

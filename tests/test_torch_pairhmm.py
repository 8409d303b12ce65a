"""Port pair-HMM forward == the JAX package's forward and the numpy oracle.

The same numpy-seeded inputs go through ``ops.pairhmm.forward_core``
(the XLA scan), ``PallasPairHMMScorer`` in interpret mode (the TPU
kernel's semantics on the CPU) and ``oracle.hmm.forward_full`` on one side,
and the port's ``pairhmm_forward_plain`` / ``PairHMMScorer(device="cpu")``
on the other.  Tolerance: ``|port - ref| <= 1e-3 * max(1, |ref|)``, the
bar of tests/test_pallas_pairhmm.py; pairs whose corner leaves the band
must be NEG (< -1e29) on both sides.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from falcon_unzip_tpu.oracle import hmm as oh
from falcon_unzip_tpu.ops import pairhmm as ref_hmm
from falcon_unzip_tpu.ops.banded_align import build_schedule, prepare_batch
from falcon_unzip_tpu.ops.pallas_pairhmm import PallasPairHMMScorer
from falcon_unzip_tpu.seq import SeqBatch
from falcon_unzip_tpu.utils.simulate import mutate_read, random_genome
from falcon_unzip_tpu_torch.ops import _kernels
from falcon_unzip_tpu_torch.ops import pairhmm as port_hmm
from falcon_unzip_tpu_torch.utils import hmm_batches as hb

# one intra-op thread: the suite runs several pytest workers on one host,
# and a torch CPU thread pool in each would oversubscribe the cores
torch.set_num_threads(1)

TOL = 1e-3


def _close(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    neg = want < -1e29
    assert np.array_equal(got < -1e29, neg)
    err = np.abs(got - want)[~neg]
    assert (err <= TOL * np.maximum(1.0, np.abs(want[~neg]))).all(), \
        err.max()


def _pairs(seed, P=8, lens=(60, 140), errs=(0.0, 0.05, 0.1, 0.2)):
    rng = np.random.default_rng(seed)
    ts = [random_genome(int(rng.integers(*lens)), seed * 100 + k)
          for k in range(P)]
    qs = [mutate_read(t, errs[k % len(errs)], rng) for k, t in enumerate(ts)]
    qs[-1] = qs[-1][:12]          # a short read: the corner leaves W<=64
    qb, tb = SeqBatch.from_strs(qs), SeqBatch.from_strs(ts)
    return qs, ts, qb.data, tb.data, qb.lengths, tb.lengths


# layout widths of the card kernel and ragged widths it runs on a wider one
@pytest.mark.parametrize("W", [16, 32, 33, 48, 64, 96, 128, 200])
def test_plain_forward_matches_forward_core(W):
    _, _, q, t, n, m = _pairs(seed=W)
    qg, trg, G = prepare_batch(q, t, W)
    Dmax, lo = build_schedule(q.shape[1], t.shape[1], W)
    pvec = ref_hmm.params_vector(oh.HMMParams(e_sub=0.05, p_ins=0.08))
    want = np.asarray(ref_hmm.pairhmm_forward_batch(
        jnp.asarray(qg), jnp.asarray(trg), jnp.asarray(n), jnp.asarray(m),
        jnp.asarray(lo), jnp.asarray(pvec), W=W, Lt=t.shape[1], G=G))
    got = port_hmm.pairhmm_forward_plain(
        torch.from_numpy(qg), torch.from_numpy(trg),
        torch.from_numpy(n.astype(np.int32)),
        torch.from_numpy(m.astype(np.int32)), lo, pvec, W=W,
        Lt=t.shape[1], G=G)
    _close(got.numpy(), want)


def test_scorer_matches_pallas_interpret_and_oracle():
    qs, ts, q, t, n, m = _pairs(seed=3, P=8, lens=(90, 110))
    got = port_hmm.PairHMMScorer(W=64, device="cpu")(q, t, n, m)
    pallas = PallasPairHMMScorer(W=64, PB=8, interpret=True)(q, t, n, m)
    _close(got, pallas)
    oracle = np.array([oh.forward_full(a, b) for a, b in zip(qs, ts)])
    inband = got > -1e29
    assert inband[:-1].all()
    _close(got[inband], oracle[inband])


def test_scorer_matches_jax_scorer_with_params():
    prm = oh.HMMParams(e_sub=0.08, p_ins=0.1, p_del=0.03, eps_ins=0.4)
    _, _, q, t, n, m = _pairs(seed=5, P=6, lens=(150, 260))
    got = port_hmm.PairHMMScorer(W=128, params=prm, device="cpu")(q, t, n, m)
    want = ref_hmm.PairHMMScorer(W=128, params=prm)(q, t, n, m)
    _close(got, want)


def test_kernel_wrapper_refuses_cpu_tensors(monkeypatch):
    x8 = torch.zeros((2, 256), dtype=torch.int8)
    i32 = torch.zeros(2, dtype=torch.int32)
    pv = port_hmm.params_vector()
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.pairhmm_forward(x8, x8, i32, i32, pv, W=64, Lt=16, G=66,
                                 Dmax=33)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_hmm.PairHMMScorer(W=64, device="cuda")


@pytest.mark.parametrize("W", [16, 32, 33, 48, 96, 128, 200])
@pytest.mark.parametrize("kind", hb.EDGE_KINDS)
def test_plain_forward_edge_batches_match_forward_core(kind, W):
    """The edge batches the card kernel is held to (utils/hmm_batches.py):
    corners out of the band, n = 0 or m = 0, n + m ending around the
    prologue's end, a cut schedule, corners at the band's edges, long and
    short pairs mixed, P = 1 and P = 37; the plain forward against the JAX
    package's ``pairhmm_forward_batch`` on the same cut schedule."""
    b = hb.edge_batch(kind, W)
    pvec = port_hmm.params_vector()
    args, kw = hb.to_device(b, W, pvec, "cpu")
    qg, trg, n, m, lo, _ = args
    want = np.asarray(ref_hmm.pairhmm_forward_batch(
        jnp.asarray(qg.numpy()), jnp.asarray(trg.numpy()),
        jnp.asarray(b["n"]), jnp.asarray(b["m"]), jnp.asarray(lo),
        jnp.asarray(pvec), **kw))
    got = port_hmm.pairhmm_forward_plain(*args, **kw).numpy()
    _close(got, want)
    # every kind but the full-band ones has pairs on both sides of the bar
    out = want < -1e29
    n_, m_ = b["n"].astype(int), b["m"].astype(int)
    in_band = np.array([0 <= hb.corner_w(a, c, W) < W and a + c < b["Dmax"]
                        for a, c in zip(n_, m_)])
    assert np.array_equal(~out, in_band)

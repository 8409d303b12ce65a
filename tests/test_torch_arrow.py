"""Port Arrow splice == the JAX package's ``arrow_splice_core``.

The same numpy-seeded pairs go through the reference's ``ArrowSplicer``
/ ``arrow_splice_batch`` and the port's ``ArrowSplicer(device="cpu")`` /
``arrow_splice_plain``, in per-pair and per-base tier mode, with unused
(-1) candidate slots and the terminal deletion ``cand == m - 1``.
Tolerance: ``|port - ref| <= 1e-3 * max(1, |ref|)`` for ``ll_cur`` and
``ll_mut`` (the bar of tests/test_arrow_splice.py:80); NEG (< -1e29) slots
must agree exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from falcon_unzip_tpu.oracle import hmm as oh
from falcon_unzip_tpu.ops import arrow as ref_arrow
from falcon_unzip_tpu.ops.pairhmm import params_vector
from falcon_unzip_tpu.seq import PAD
from falcon_unzip_tpu.utils.simulate import mutate_read, random_genome
from falcon_unzip_tpu_torch.ops import _kernels
from falcon_unzip_tpu_torch.ops import arrow as port_arrow

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


def _tier_table():
    return np.stack([
        params_vector(oh.HMMParams(e_sub=0.01, p_ins=0.02, p_del=0.02)),
        params_vector(oh.HMMParams(e_sub=0.08, p_ins=0.10, p_del=0.08,
                                   eps_ins=0.35)),
        params_vector(oh.HMMParams(e_sub=0.20, p_ins=0.18, p_del=0.15,
                                   eps_ins=0.45, eps_del=0.3)),
    ])


def _cases(seed, n_pairs=6, base=30, step=7):
    """The cases of tests/test_arrow_splice.py:65: rising error rates and
    1..4 candidates including 0 and m - 1."""
    rng = np.random.default_rng(seed)
    qs, ts, cands = [], [], []
    for s in range(n_pairs):
        t = random_genome(base + step * s, 100 + s)
        q = mutate_read(t, (0.0, 0.05, 0.1, 0.2, 0.3, 0.15)[s % 6], rng)
        qs.append(q)
        ts.append(t)
        cands.append([0, 3, len(t) // 2, len(t) - 1][: (s % 4) + 1])
    qtiers = [rng.integers(0, 3, len(q)).astype(np.int8) for q in qs]
    return qs, ts, cands, qtiers


@pytest.mark.parametrize("mode", ["per-pair", "per-base"])
def test_splicer_matches_jax(mode):
    qs, ts, cands, qtiers = _cases(21)
    kw = dict(tier_params=_tier_table()) if mode == "per-base" else {}
    call = dict(qtiers=qtiers) if mode == "per-base" else {}
    want = ref_arrow.ArrowSplicer(max_cand=4, chunk=8, **kw)(qs, ts, cands,
                                                              **call)
    got = port_arrow.ArrowSplicer(max_cand=4, chunk=8, device="cpu",
                                  **kw)(qs, ts, cands, **call)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g, w)
    # unused candidate slots score NEG
    for k, cc in enumerate(cands):
        assert (got[1][k, len(cc):] < -1e29).all()


def test_splicer_matches_oracle_and_per_pair_params():
    rng = np.random.default_rng(23)
    t = random_genome(40, 200)
    q0 = mutate_read(t, 0.05, rng)
    q1 = mutate_read(t, 0.25, rng)
    pa = oh.HMMParams(e_sub=0.01)
    pb = oh.HMMParams(e_sub=0.15)
    pvecs = np.stack([params_vector(pa), params_vector(pb)])
    cur, mut = port_arrow.ArrowSplicer(max_cand=2, chunk=4, device="cpu")(
        [q0, q1], [t, t], [[5], [5]], pvecs=pvecs)
    rcur, rmut = ref_arrow.ArrowSplicer(max_cand=2, chunk=4)(
        [q0, q1], [t, t], [[5], [5]], pvecs=pvecs)
    _close(cur, rcur)
    _close(mut, rmut)
    for k, (q, prm) in enumerate(((q0, pa), (q1, pb))):
        _close(cur[k], oh.forward_full(q, t, prm))
        fb = oh.forward_backward_full(q, t, prm)
        _close(mut[k, 0], oh.splice_scores(q, t, fb, 5, prm))


@pytest.mark.parametrize("mode", ["per-pair", "per-base"])
def test_plain_core_matches_arrow_splice_core(mode):
    """Direct call on padded batches with a ragged read length, -1 slots,
    cand == m - 1 and a padding pair (n = m = 0)."""
    rng = np.random.default_rng(29)
    P, Lq, LJ, C = 5, 64, 72, 3
    q = np.full((P, Lq), PAD, np.int8)
    t = np.full((P, LJ), PAD, np.int8)
    n = np.zeros(P, np.int32)
    m = np.zeros(P, np.int32)
    cand = np.full((P, C), -1, np.int32)
    for k in range(P - 1):
        tk = random_genome(int(rng.integers(30, LJ - 1)), 500 + k)
        qk = mutate_read(tk, 0.1 * k, rng)[:Lq]
        q[k, : len(qk)] = qk
        t[k, : len(tk)] = tk
        n[k], m[k] = len(qk), len(tk)
        cand[k, : 1 + k % C] = [m[k] - 1, 2, m[k] // 2][: 1 + k % C]
    pvec = np.tile(params_vector(), (P, 1)).astype(np.float32)
    pvec[1] = params_vector(oh.HMMParams(e_sub=0.1, p_del=0.1))
    tiers = _tier_table().astype(np.float32)
    qt = rng.integers(0, 3, size=(P, Lq + 1)).astype(np.int8)
    per_base = mode == "per-base"
    want = ref_arrow.arrow_splice_batch(
        jnp.asarray(q), jnp.asarray(t), jnp.asarray(n), jnp.asarray(m),
        jnp.asarray(cand), jnp.asarray(pvec),
        jnp.asarray(qt.astype(np.int32)) if per_base else None,
        jnp.asarray(tiers) if per_base else None, Lq=Lq, LJ=LJ, C=C)
    dt = torch.from_numpy
    got = port_arrow.arrow_splice_plain(
        dt(q), dt(t), dt(n), dt(m), dt(cand), dt(pvec),
        dt(qt) if per_base else None, dt(tiers) if per_base else None, C=C)
    for g, w in zip(got, want):
        _close(g.numpy(), np.asarray(w))
    # the dispatcher takes the plain path for CPU tensors
    again = port_arrow.arrow_splice(
        dt(q), dt(t), dt(n), dt(m), dt(cand), dt(pvec),
        dt(qt) if per_base else None, dt(tiers) if per_base else None, C=C)
    for a, b in zip(again, got):
        assert torch.equal(a, b)


def test_tiers_uniform_match_pvec_and_pairs_are_independent():
    """A constant tier track reproduces the per-pair path, and with pinned
    shapes a pair scores the same alone and inside a batch."""
    rng = np.random.default_rng(39)
    tiers = _tier_table()
    t = random_genome(40, 400)
    q = mutate_read(t, 0.1, rng)
    prm = oh.HMMParams(e_sub=0.08, p_ins=0.10, p_del=0.08, eps_ins=0.35)
    cur_t, mut_t = port_arrow.ArrowSplicer(
        max_cand=2, chunk=4, tier_params=tiers, device="cpu")(
        [q], [t], [[7, 20]], qtiers=[np.ones(len(q), np.int8)])
    cur_p, mut_p = port_arrow.ArrowSplicer(max_cand=2, chunk=4,
                                           device="cpu")(
        [q], [t], [[7, 20]], pvecs=params_vector(prm)[None])
    _close(cur_t, cur_p)
    _close(mut_t, mut_p)
    sp = port_arrow.ArrowSplicer(max_cand=2, chunk=8, fixed_lq=128,
                                 fixed_lj=128, device="cpu")
    others = [mutate_read(random_genome(90, 9), 0.1, rng) for _ in range(5)]
    alone = sp([q], [t], [[7, 20]])
    batch = sp(others + [q], [random_genome(90, 9)] * 5 + [t],
               [[3]] * 5 + [[7, 20]])
    assert np.array_equal(alone[0][0], batch[0][-1])
    assert np.array_equal(alone[1][0], batch[1][-1])


def test_kernel_wrapper_refuses_cpu_tensors():
    z = torch.zeros((2, 8), dtype=torch.int8)
    i32 = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.arrow_sweeps(z, z, i32, i32,
                              torch.zeros((2, 1), dtype=torch.int32),
                              torch.zeros((2, 10)), None, None, C=1)

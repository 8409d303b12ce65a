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
from falcon_unzip_tpu_torch.utils import arrow_batches

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


EDGE_SEED = {k: 700 + i for i, k in enumerate(arrow_batches.EDGE_KINDS)}
NEG_F = np.float32(-1e30)


def _params_of(pv):
    """HMMParams whose logs() are the ten log-params pv (float32 exact)."""
    class _P:
        def logs(self):
            return {k: np.float32(pv[i]) for k, i in oh._K.items()}
    return _P()


@pytest.mark.parametrize("mode", ["per-pair", "per-base"])
@pytest.mark.parametrize("kind", arrow_batches.EDGE_KINDS)
def test_plain_sweeps_match_oracle_matrices_at_edge_shapes(kind, mode):
    """The raw sweep outputs of ``arrow_sweeps_plain`` (the card kernel's
    yardstick) against the reference oracle's full matrices
    (``forward_backward_full`` / ``_pb``) at the edge shapes of the card's
    tests, scaled to LJ = Lq = 72 with 32-row stripes standing in for the
    kernel's (n, m in 31..33 and 63..65): padding pairs, n > m, n < m,
    m much smaller than LJ, m = LJ - 1 with clipped slots.

    Conventions: afM/afI/afD[p, c, i] is A_S[i, col] and bM/bD[p, s, c, i]
    is B_S[i, col + s] with no row offset (the splice assembly shifts the
    backward by one row itself), the column clipped into [0, LJ) first and
    NEG past m; rows past n are NEG; ll_cur is B_M[0, 0].  Per-base: the
    oracle clips a read base's index into [0, n - 1] where the sweeps read
    the tier track at i = n too; row n's M/I edges consume no read base, so
    the two agree (for n = 0 the oracle is given base 0's row)."""
    LJ, C = 72, 4
    rng = np.random.default_rng(EDGE_SEED[kind])
    specs = arrow_batches.edge_specs(kind, LJ=LJ)      # n, m <= 72
    arrays = arrow_batches.pack(rng, specs, Lq=LJ, LJ=LJ, C=C)
    q, t, n, m, cand, pvec, qt, tiers = arrays
    got = port_arrow.arrow_sweeps_plain(
        *arrow_batches.to_device(arrays, mode, "cpu"), C=C)
    afM, afI, afD, bM, bD, ll_cur = (x.numpy() for x in got)
    R = LJ + 1
    for p, (nk, mk, _) in enumerate(specs):
        qk, tk = q[p, :nk], t[p, :mk]
        if mode == "per-base":
            pb = tiers[np.clip(qt[p, : max(nk, 1)], 0, len(tiers) - 1)]
            fb = oh.forward_backward_full_pb(qk, tk, pb)
        else:
            fb = oh.forward_backward_full(qk, tk, _params_of(pvec[p]))
        (A_M, A_I, A_D), (B_M, _B_I, B_D) = fb

        def at(mat, col):
            out = np.full(R, NEG_F, np.float32)
            if col <= mk:
                out[: nk + 1] = mat[:, col]
            return out

        for c in range(C):
            col = int(np.clip(cand[p, c], 0, LJ - 1))
            for mat, o in ((A_M, afM), (A_I, afI), (A_D, afD)):
                _close(o[p, c], at(mat, col))
            for s in range(3):
                colb = int(np.clip(cand[p, c] + s, 0, LJ - 1))
                _close(bM[p, s, c], at(B_M, colb))
                _close(bD[p, s, c], at(B_D, colb))
        _close(ll_cur[p], B_M[0, 0])


@pytest.mark.parametrize("mode", ["per-pair", "per-base"])
def test_plain_core_matches_arrow_splice_core_many_candidates(mode):
    """C = 12 candidates a pair (36 backward slots, past the 24 of the card
    kernel's first column word): the port's ``arrow_splice_plain`` against
    the reference's ``arrow_splice_batch``, with clipped slots at
    m = LJ - 1 and unused slots."""
    LJ, C = 72, 12
    rng = np.random.default_rng(31)
    arrays = arrow_batches.pack(rng, arrow_batches.wide_specs(rng, LJ=LJ, C=C),
                                Lq=LJ, LJ=LJ, C=C)
    q, t, n, m, cand, pvec, qt, tiers = arrays
    per_base = mode == "per-base"
    want = ref_arrow.arrow_splice_batch(
        jnp.asarray(q), jnp.asarray(t), jnp.asarray(n), jnp.asarray(m),
        jnp.asarray(cand), jnp.asarray(pvec),
        jnp.asarray(qt.astype(np.int32)) if per_base else None,
        jnp.asarray(tiers) if per_base else None, Lq=LJ, LJ=LJ, C=C)
    got = port_arrow.arrow_splice_plain(
        *arrow_batches.to_device(arrays, mode, "cpu"), C=C)
    for g, w in zip(got, want):
        _close(g.numpy(), np.asarray(w))
    assert int((cand >= 0).sum(axis=1).max()) > 8     # past slot word 1

"""Port sharded steps on logical CPU shards == the JAX package's on its
8-device CPU mesh.

The same numpy-seeded inputs go through ``falcon_unzip_tpu.parallel``
(8 virtual CPU devices from tests/conftest.py) and through
``falcon_unzip_tpu_torch.parallel`` on 1, 3 and 8 logical CPU shards,
with row counts that are not multiples of the shard count where the op
pads.  Integer results (pileup, het call, association, allele matrix,
window votes) must be bit-exact; the pair-HMM and Arrow log-likelihoods
within ``1e-3 * max(1, |ref|)`` (the bar of tests/test_arrow_splice.py:80)
with NEG slots equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from falcon_unzip_tpu.models.polisher import tier_table
from falcon_unzip_tpu.ops import arrow as ref_arrow
from falcon_unzip_tpu.ops.pairhmm import PairHMMScorer as RefScorer
from falcon_unzip_tpu.ops.pairhmm import (build_schedule, params_vector,
                                          prepare_batch)
from falcon_unzip_tpu.parallel import mesh as ref_mesh
from falcon_unzip_tpu.parallel import sharding as ref_sharding
from falcon_unzip_tpu.utils.simulate import mutate_read, random_genome
from falcon_unzip_tpu_torch.ops.consensus import vote_matrix
from falcon_unzip_tpu_torch.parallel import sharding
from falcon_unzip_tpu_torch.parallel.mesh import Mesh, make_mesh

torch.set_num_threads(1)

TOL = 1e-3
SHARDS = [1, 3, 8]


def _close(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    neg = want < -1e29
    assert np.array_equal(got < -1e29, neg)
    err = np.abs(got - want)[~neg]
    assert (err <= TOL * np.maximum(1.0, np.abs(want[~neg]))).all(), \
        err.max()


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) >= 8, "conftest must provide 8 CPU devices"
    return ref_mesh.make_mesh(8)


@pytest.mark.parametrize("n", SHARDS)
def test_mesh_axes(n):
    m = make_mesh(n, device="cpu")
    assert m.axis_names == ("data", "window")
    assert m.devices.size == n
    ref = ref_mesh.make_mesh(n)
    assert dict(m.shape) == dict(ref.shape)
    assert m.devices.shape == ref.devices.shape
    explicit = make_mesh(device=["cpu"] * 4)     # logical shards, repeats
    assert dict(explicit.shape) == {"data": 2, "window": 2}
    with pytest.raises(ValueError):
        Mesh(["cpu"] * 3, window_par=2)


def _tags(seed, R, T, t_len):
    """The biallelic signal of tests/test_sharding.py: half the reads
    carry alt alleles at 20 SNPs."""
    rng = np.random.default_rng(seed)
    base_seq = rng.integers(0, 4, size=t_len).astype(np.int32)
    tagpos = np.zeros((R, T), np.int32)
    tagbase = np.zeros((R, T), np.int32)
    snp = rng.choice(t_len, 20, replace=False)
    for r in range(R):
        ps = np.sort(rng.choice(t_len, T, replace=False)).astype(np.int32)
        tagpos[r] = ps
        tagbase[r] = base_seq[ps]
        if r % 2 == 1:
            hit = np.isin(ps, snp)
            tagbase[r][hit] = (base_seq[ps][hit] + 1) % 4
    tagpos[-1, -7:] = -1                        # padded tags are inert
    return tagpos, tagbase, snp


@pytest.mark.parametrize("n", SHARDS)
def test_sharded_phase_step_matches_jax(mesh8, n):
    t_len, s_cap, max_span = 512, 64, 16
    tagpos, tagbase, snp = _tags(7, 24, 200, t_len)
    kw = dict(t_len=t_len, s_cap=s_cap, max_span=max_span, min_depth=2)
    want = ref_sharding.make_phase_step(mesh8, **kw)(
        jnp.asarray(tagpos), jnp.asarray(tagbase))
    got = sharding.make_phase_step(make_mesh(n, device="cpu"), **kw)(
        tagpos, tagbase)
    names = ("counts", "is_het", "b1", "b2", "score", "cov", "M")
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        g = g.numpy()
        assert g.dtype == w.dtype and np.array_equal(g, w), name
    assert got[1].numpy()[snp].mean() > 0.8


def test_sharded_polish_step_matches_jax(mesh8):
    W, Lq, Lt, P_ = 32, 128, 128, 24
    rng = np.random.default_rng(9)
    q = rng.integers(0, 4, size=(P_, Lq)).astype(np.int8)
    t = q.copy()
    t[::3, 40] = (t[::3, 40] + 1) % 4
    nn = rng.integers(80, 100, P_).astype(np.int32)
    mm = rng.integers(80, 100, P_).astype(np.int32)
    qg, trg, G = prepare_batch(q, t, W)
    _, lo = build_schedule(Lq, Lt, W)
    want = RefScorer(W=W)(q, t, nn, mm)
    for n in SHARDS:
        step = sharding.make_polish_step(make_mesh(n, device="cpu"), W=W,
                                         Lt=Lt, G=G)
        _close(step(qg, trg, nn, mm, lo, params_vector()).numpy(), want)


@pytest.mark.parametrize("n", SHARDS)
def test_sharded_scorer_matches_jax(n):
    W, Lq = 16, 64
    rng = np.random.default_rng(n)
    P_ = 13                                   # not a multiple of 3 or 8
    q = rng.integers(0, 4, size=(P_, Lq)).astype(np.int8)
    t = rng.integers(0, 4, size=(P_, Lq)).astype(np.int8)
    nn = rng.integers(40, 64, P_).astype(np.int32)
    mm = rng.integers(40, 64, P_).astype(np.int32)
    mm[2] = 10                                # the corner leaves the band
    got = sharding.ShardedPairHMMScorer(make_mesh(n, device="cpu"), W=W)(
        q, t, nn, mm)
    want = RefScorer(W=W)(q, t, nn, mm)
    assert got.shape == (P_,)
    _close(got, want)
    assert got[2] < -1e29


@pytest.mark.parametrize("n,wp", [(8, 2), (4, 4), (3, 3)])
def test_window_votes_match_jax(n, wp):
    rng = np.random.default_rng(n)
    t_len, window, n_tags = 2200, 256, 6001
    pos = rng.integers(-5, t_len + 5, n_tags).astype(np.int32)
    delta = rng.integers(0, 11, n_tags).astype(np.int32)  # some > MAX_DELTA
    base = rng.integers(0, 5, n_tags).astype(np.int32)
    ops = sharding.ShardedWindowVotes(make_mesh(n, wp, device="cpu"))
    ref = ref_sharding.ShardedWindowVotes(ref_mesh.make_mesh(n, wp))
    assert ops.supports(t_len, window) and ref.supports(t_len, window)
    assert not ops.supports(t_len, t_len)
    blocks, seg = ops.blocks(pos, delta, base, t_len=t_len, window=window)
    want, want_seg = ref.blocks(pos, delta, base, t_len=t_len, window=window)
    assert seg == want_seg
    assert blocks.dtype == want.dtype and np.array_equal(blocks, want)
    # every window of the contig sliced from its shard's block
    full = vote_matrix([np.stack([pos, delta, base], axis=1)], t_len)
    for lo in range(0, t_len, window - 64):
        hi = min(t_len, lo + window)
        s = lo // seg
        assert np.array_equal(blocks[s, lo - s * seg:lo - s * seg + hi - lo],
                              full[lo:hi]), lo


def _splice_cases(seed, N):
    rng = np.random.default_rng(seed)
    qs, ts, cands = [], [], []
    for s in range(N):
        t = random_genome(30 + 3 * s, 100 + s)
        q = mutate_read(t, (0.0, 0.05, 0.1, 0.2, 0.15)[s % 5], rng)
        qs.append(q)
        ts.append(t)
        cands.append([0, 3, len(t) // 2, len(t) - 1][: (s % 4) + 1])
    qtiers = [rng.integers(0, 4, len(q)).astype(np.int8) for q in qs]
    return qs, ts, cands, qtiers


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("mode", ["flat", "tiered"])
def test_sharded_splicer_matches_jax(n, mode):
    qs, ts, cands, qtiers = _splice_cases(21 + n, 13)
    kw = dict(max_cand=4, chunk=8, fixed_lq=128, fixed_lj=128)
    call = {}
    if mode == "tiered":
        kw["tier_params"] = tier_table()
        call["qtiers"] = qtiers
    want = ref_arrow.ArrowSplicer(**kw)(qs, ts, cands, **call)
    sp = sharding.ShardedArrowSplicer(make_mesh(n, device="cpu"), **kw)
    got = sp(qs, ts, cands, **call)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g, w)
    for k, cc in enumerate(cands):            # unused slots score NEG
        assert (got[1][k, len(cc):] < -1e29).all()
    # the chunk splits evenly over the shards
    assert sp._pick_chunk(13) % n == 0 and sp._pick_chunk(3000) % n == 0


def test_pipeline_mesh_on_cpu():
    assert sharding.make_pipeline_mesh(0, 0, device="cpu") is None
    assert sharding.make_pipeline_mesh(1, 0, device="cpu") is None
    m = sharding.make_pipeline_mesh(8, 0, device="cpu")
    assert dict(m.shape) == {"data": 4, "window": 2}
    m = sharding.make_pipeline_mesh(6, 3, device="cpu", local_only=True)
    assert dict(m.shape) == {"data": 2, "window": 3}


def test_bucket_and_pad_match_reference():
    for n in (0, 1, 5, 13, 64, 65, 1000):
        for mult in (1, 3, 8):
            assert sharding._bucket(n, mult) == ref_sharding._bucket(n, mult)
            x = np.arange(n, dtype=np.int32)
            assert np.array_equal(sharding._pad_to(x, mult, -1),
                                  ref_sharding._pad_to(x, mult, -1))

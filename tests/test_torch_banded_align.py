"""Port banded DP (plain torch path) == JAX scan path == numpy oracle.

Inputs are made from seeds with numpy and go through both packages.
Every comparison is bit-exact (integer DP): dist, end cells, every
backpointer, the traceback moves, the packed moves and the 7-int
summaries.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from falcon_unzip_tpu.ops import banded_align as ref
from falcon_unzip_tpu.oracle import align as oa
from falcon_unzip_tpu.seq import SeqBatch
from falcon_unzip_tpu.utils.simulate import mutate_read, random_genome
from falcon_unzip_tpu_torch.ops import _kernels
from falcon_unzip_tpu_torch.ops import banded_align as port

# one intra-op thread: the suite runs several pytest workers on one host,
# and a torch CPU thread pool in each would oversubscribe the cores
torch.set_num_threads(1)

MODES = ("global", "qglocal", "tglocal")


def _pairs(W: int, mode: str, seed: int):
    """Seeded (q, t) pairs plus degenerate rows: an empty query (n=0), a
    query far longer than its target (row i == n never enters the band,
    so no end is found) and repeated pad rows (the aligner's tail-chunk
    padding)."""
    rng = np.random.default_rng(seed)
    qs, ts = [], []
    for k in range(6):
        t = random_genome(int(rng.integers(120, 260)), seed * 100 + k)
        if mode == "global":
            src = t
        else:
            src = t[: int(rng.integers(60, len(t)))]
        qs.append(mutate_read(src, float(rng.choice([0.0, 0.15])), rng))
        ts.append(t)
    qs.append(qs[0][:0])                                  # n = 0
    ts.append(ts[0])
    qs.append(random_genome(W + 140, seed + 7))           # no end found
    ts.append(random_genome(60, seed + 8))
    qs += [qs[-1]] * 2                                    # repeated pad rows
    ts += [ts[-1]] * 2
    qb, tb = SeqBatch.from_strs(qs), SeqBatch.from_strs(ts)
    return (qb.data, tb.data, qb.lengths.astype(np.int32),
            tb.lengths.astype(np.int32), qs, ts)


@pytest.mark.parametrize("W", [128, 256, 512])
@pytest.mark.parametrize("mode", MODES)
def test_plain_wavefront_and_traceback_match_jax(W, mode):
    q, t, n, m, qs, ts = _pairs(W, mode, seed=W + len(mode))
    Dmax, lo = ref.build_schedule(q.shape[1], t.shape[1], W)
    qg, trg, G = ref.prepare_batch(q, t, W)
    r = ref.banded_align_batch(
        jnp.asarray(qg), jnp.asarray(trg), jnp.asarray(n), jnp.asarray(m),
        jnp.asarray(lo), W=W, Lt=t.shape[1], G=G, mode=mode)
    p = port.banded_align_batch(
        torch.from_numpy(qg), torch.from_numpy(trg), torch.from_numpy(n),
        torch.from_numpy(m), lo, W=W, Lt=t.shape[1], G=G, mode=mode)
    for k in ("dist", "end_i", "end_j"):
        assert np.array_equal(np.asarray(r[k]), p[k].numpy()), k
    assert np.array_equal(np.asarray(r["bp"]),
                          port.unpack_bp(p["bp"], Dmax).numpy())
    # the degenerate rows really are degenerate
    if mode != "global":
        assert int(p["end_j"][-1]) == -1
        assert int(p["dist"][-1]) == int(oa.INF)

    mr = ref.traceback_batch(r["bp"], jnp.asarray(lo), r["end_i"],
                             r["end_j"], max_steps=Dmax - 1)
    mp = port.traceback_batch(p["bp"], lo, p["end_i"], p["end_j"],
                              max_steps=Dmax - 1)
    assert np.array_equal(np.asarray(mr), mp.numpy())
    assert np.array_equal(np.asarray(ref.pack_moves2(mr)),
                          port.pack_moves2(mp).numpy())
    assert np.array_equal(
        np.asarray(ref._summarize_moves(mr, r["dist"], r["end_i"],
                                        r["end_j"])),
        port._summarize_moves(mp, p["dist"], p["end_i"],
                              p["end_j"]).numpy())

    # numpy oracle on every pair whose answer is finite
    fwd = port.moves_forward(mp.numpy())
    for k in range(len(qs)):
        dist_o, end_o, bp_o, lo_o = oa.banded_dp(qs[k], ts[k], W, mode)
        assert int(p["dist"][k]) == int(dist_o), k
        if dist_o < oa.INF:
            assert int(p["end_j"][k]) == end_o[1], k
            moves_o = oa.traceback_banded(bp_o, lo_o, end_o)
            assert np.array_equal(fwd[k], moves_o), k


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("want", [True, "summary", False])
def test_banded_aligner_collect_matches_jax(mode, want):
    q, t, n, m, _, _ = _pairs(128, mode, seed=11)
    ra = ref.BandedAligner(W=128, mode=mode, use_pallas=False)
    pa = port.BandedAligner(W=128, mode=mode, device="cpu")
    rr = ra.collect(ra.dispatch(q, t, n, m, want_moves=want))
    pr = pa.collect(pa.dispatch(q, t, n, m, want_moves=want))
    assert sorted(rr) == sorted(pr)
    for k in rr:
        if k == "moves":
            assert len(rr[k]) == len(pr[k])
            for a, b in zip(rr[k], pr[k]):
                assert np.array_equal(a, b)
        else:
            assert np.array_equal(rr[k], pr[k]), k


def test_collect_summaries_concatenates_chunks():
    hr, hp = [], []
    ra = ref.BandedAligner(W=256, mode="tglocal", use_pallas=False)
    pa = port.BandedAligner(W=256, mode="tglocal", device="cpu")
    for seed in (3, 4):
        q, t, n, m, _, _ = _pairs(256, "tglocal", seed=seed)
        hr.append(ra.dispatch(q, t, n, m, want_moves="summary"))
        hp.append(pa.dispatch(q, t, n, m, want_moves="summary"))
    sr = ra.collect_summaries(hr)
    sp = port.BandedAligner.collect_summaries(hp)
    assert sorted(sr) == sorted(sp)
    for k in sr:
        assert np.array_equal(sr[k], sp[k]), k
    assert len(port.BandedAligner.collect_summaries([])["dist"]) == 0


def test_cpu_path_launches_no_kernel():
    _kernels.reset_counts()
    q, t, n, m, _, _ = _pairs(128, "tglocal", seed=5)
    port.BandedAligner(W=128, mode="tglocal", device="cpu")(q, t, n, m)
    assert all(k.launches == 0 for k in _kernels.KERNELS)


def test_kernel_wrappers_refuse_cpu_tensors():
    q, t, n, m, _, _ = _pairs(128, "global", seed=6)
    qg, trg, G = ref.prepare_batch(q, t, 128)
    with pytest.raises(ValueError):
        _kernels.banded_wavefront(
            torch.from_numpy(qg), torch.from_numpy(trg),
            torch.from_numpy(n), torch.from_numpy(m), W=128,
            Lt=t.shape[1], G=G, Dmax=64, mode="global", want_bp=True)
    with pytest.raises(ValueError):
        _kernels.traceback(torch.zeros((4, len(n), 128), dtype=torch.int32),
                           torch.from_numpy(n), torch.from_numpy(m), W=128,
                           Dmax=64, max_steps=63)


def test_unpack_bp_inverts_packing():
    rng = np.random.default_rng(2)
    bp8 = rng.integers(0, 4, size=(37, 5, 32)).astype(np.int64)
    packed = np.zeros((3, 5, 32), np.int64)
    for d in range(37):
        packed[d // 16] |= bp8[d] << (2 * (d % 16))
    packed = np.where(packed >= 1 << 31, packed - (1 << 32), packed)
    got = port.unpack_bp(torch.from_numpy(packed.astype(np.int32)), 37)
    assert np.array_equal(got.numpy(), bp8.astype(np.int8))

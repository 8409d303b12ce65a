"""Port banded DP (plain torch path) == JAX scan path == numpy oracle.

Inputs are made from seeds with numpy and go through both packages.
Every comparison is bit-exact (integer DP): dist, end cells, every
backpointer, the traceback moves, the packed moves and the 7-int
summaries, also through the plain compositions that stand behind the CUDA
traceback's fused epilogues.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from falcon_unzip_tpu.ops import banded_align as ref
from falcon_unzip_tpu.oracle import align as oa
from falcon_unzip_tpu.seq import PAD, SeqBatch
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


# the card kernels' own layout widths and ragged widths (odd, under a warp,
# between layouts), which the kernels run on a wider layout
@pytest.mark.parametrize("W", [1, 2, 33, 96, 128, 200, 256, 384, 512, 768])
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


def _hard_pairs(W: int, mode: str, seed: int):
    """Seeded pairs in one long bucket (512): short pairs (n + m far under
    half of the schedule), an n = 0 and an m = 0 pair (the latter an
    all-insertion path: every move is MOVE_UP), a pair that cannot align
    (dist INF in the local modes) and two full-length ones."""
    rng = np.random.default_rng(seed)
    qs, ts = [], []
    for k in range(4):                                    # short pairs
        t = random_genome(int(rng.integers(40, 90)), seed * 50 + k)
        src = t if mode == "global" else t[: int(rng.integers(20, len(t)))]
        qs.append(mutate_read(src, 0.15 * (k % 2), rng))
        ts.append(t)
    for k in range(2):                                    # full length
        t = random_genome(int(rng.integers(440, 500)), seed * 60 + k)
        src = t if mode == "global" else t[30 : int(rng.integers(300, 400))]
        qs.append(mutate_read(src, 0.15 * k, rng))
        ts.append(t)
    qs.append(qs[0][:0])                                  # n = 0
    ts.append(ts[0])
    qs.append(random_genome(70, seed + 1))                # m = 0
    ts.append(ts[0][:0])
    qs.append(random_genome(W + 200, seed + 2))           # cannot align
    ts.append(random_genome(50, seed + 3))
    q = np.full((len(qs), 512), PAD, np.int8)
    t = np.full((len(ts), 512), PAD, np.int8)
    for k in range(len(qs)):
        q[k, : len(qs[k])] = qs[k]
        t[k, : len(ts[k])] = ts[k]
    return (q, t, np.array([len(x) for x in qs], np.int32),
            np.array([len(x) for x in ts], np.int32))


def _both(W, mode, seed):
    """The JAX scan and the port's plain wavefront on _hard_pairs."""
    q, t, n, m = _hard_pairs(W, mode, seed)
    Dmax, lo = ref.build_schedule(q.shape[1], t.shape[1], W)
    qg, trg, G = ref.prepare_batch(q, t, W)
    r = ref.banded_align_batch(
        jnp.asarray(qg), jnp.asarray(trg), jnp.asarray(n), jnp.asarray(m),
        jnp.asarray(lo), W=W, Lt=t.shape[1], G=G, mode=mode)
    p = port.banded_align_batch_plain(
        torch.from_numpy(qg), torch.from_numpy(trg), torch.from_numpy(n),
        torch.from_numpy(m), lo, W=W, Lt=t.shape[1], G=G, mode=mode)
    return n, m, Dmax, lo, r, p


@pytest.mark.parametrize("W", [2, 33, 128, 200, 256])
@pytest.mark.parametrize("mode", MODES)
def test_epilogue_compositions_match_jax(W, mode):
    """The plain versions behind the kernel's packed and summary
    epilogues == the JAX package's pack_moves2 / _combine_results /
    _summarize_moves over traceback_batch, bit for bit."""
    n, m, Dmax, lo, r, p = _both(W, mode, seed=W + 3 * len(mode))
    assert int((n + m)[:4].max()) < Dmax // 2
    if mode != "global":
        assert int(p["dist"][-1]) == int(oa.INF)
        assert int(p["end_j"][-1]) == -1
    for steps in (Dmax - 1, 100):
        mr = ref.traceback_batch(r["bp"], jnp.asarray(lo), r["end_i"],
                                 r["end_j"], max_steps=steps)
        want_packed = np.asarray(ref._combine_results(
            ref.pack_moves2(mr), r["dist"], r["end_i"], r["end_j"]))
        want_summary = np.asarray(ref._summarize_moves(
            mr, r["dist"], r["end_i"], r["end_j"]))
        ends = (p["dist"], p["end_i"], p["end_j"])
        for fn in (port.traceback_packed, port.traceback_packed_plain):
            got = fn(p["bp"], lo, *ends, max_steps=steps)
            assert got.dtype == torch.int32
            assert np.array_equal(got.numpy(), want_packed), fn.__name__
        for fn in (port.traceback_summary, port.traceback_summary_plain):
            got = fn(p["bp"], lo, *ends, max_steps=steps)
            assert got.dtype == torch.int32
            assert np.array_equal(got.numpy(), want_summary), fn.__name__
    # the all-insertion pair (m = 0): every move MOVE_UP, so the leading
    # and the trailing run are the whole path (where its corner (70, 0) is
    # in the band; a narrower band leaves it without a path)
    s = port.traceback_summary(p["bp"], lo, p["dist"], p["end_i"],
                               p["end_j"], max_steps=Dmax - 1).numpy()[-2]
    if 70 - int(lo[70]) < W:
        assert (s[2], s[3], s[4], s[5]) == (0, 70, 70, 70)
    else:
        assert (s[2], s[3], s[4], s[5]) == (0, 0, 0, 0)


@pytest.mark.parametrize("mode", MODES)
def test_plain_bp_past_the_corner_is_move_none(mode):
    """Past a pair's corner d = n + m every backpointer of the plain
    version (and of the JAX scan) is MOVE_NONE up to the schedule's end:
    the kernel stores these words without computing them."""
    n, m, Dmax, lo, r, p = _both(128, mode, seed=31)
    bp = port.unpack_bp(p["bp"], Dmax).numpy()
    assert np.array_equal(np.asarray(r["bp"]), bp)
    seen = 0
    for k in range(len(n)):
        past = bp[int(n[k] + m[k]) + 1 :, k, :]
        assert (past == port.MOVE_NONE).all(), k
        seen += past.shape[0]
    assert seen > len(n) * Dmax // 2
    # the bits of d >= Dmax in the last packed word stay 0
    used = 2 * (Dmax % 16)
    if used:
        assert not (p["bp"][-1].numpy().view(np.uint32) >> used).any()


def test_cpu_path_launches_no_kernel():
    _kernels.reset_counts()
    q, t, n, m, _, _ = _pairs(128, "tglocal", seed=5)
    aligner = port.BandedAligner(W=128, mode="tglocal", device="cpu")
    for want in (True, "summary", False):
        aligner(q, t, n, m, want_moves=want)
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
    for epilogue in ("packed", "summary"):
        with pytest.raises(ValueError):
            _kernels.traceback(
                torch.zeros((4, len(n), 128), dtype=torch.int32),
                torch.from_numpy(n), torch.from_numpy(m), W=128, Dmax=64,
                max_steps=63, epilogue=epilogue, dist=torch.from_numpy(n))


def test_unpack_bp_inverts_packing():
    rng = np.random.default_rng(2)
    bp8 = rng.integers(0, 4, size=(37, 5, 32)).astype(np.int64)
    packed = np.zeros((3, 5, 32), np.int64)
    for d in range(37):
        packed[d // 16] |= bp8[d] << (2 * (d % 16))
    packed = np.where(packed >= 1 << 31, packed - (1 << 32), packed)
    got = port.unpack_bp(torch.from_numpy(packed.astype(np.int32)), 37)
    assert np.array_equal(got.numpy(), bp8.astype(np.int8))


@pytest.mark.parametrize("W", [0, 4097, 8192])
def test_kernel_wrappers_refuse_widths_outside_the_builds(W):
    """The card kernels take every band width from 1 to 4096 and refuse
    the others, naming W and the limit, before looking at the tensors."""
    x8 = torch.zeros((2, 64), dtype=torch.int8)
    i32 = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match=f"W={W} is outside 1..4096"):
        _kernels.banded_wavefront(x8, x8, i32, i32, W=W, Lt=16, G=4,
                                  Dmax=33, mode="global", want_bp=True)
    with pytest.raises(ValueError, match=f"W={W} is outside 1..4096"):
        _kernels.traceback(torch.zeros((3, 2, 4), dtype=torch.int32), i32,
                           i32, W=W, Dmax=33, max_steps=32)
    with pytest.raises(ValueError, match=f"W={W} is outside 1..4096"):
        _kernels.pairhmm_forward(x8, x8, i32, i32, [0.0] * 10, W=W, Lt=16,
                                 G=4, Dmax=33)
    assert _kernels.MAX_W == 4096

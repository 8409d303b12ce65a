"""Port collectives on logical CPU shards == the JAX package's on its
8-device CPU mesh: the all_to_all regroup (recv, counts and dropped,
including a forced overflow), the window halo exchange and
``regroup_partition`` over a mesh, each equal to the JAX one and to a
host group-by.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from falcon_unzip_tpu.parallel import collectives as ref_coll
from falcon_unzip_tpu.parallel import mesh as ref_mesh
from falcon_unzip_tpu_torch.parallel import collectives as coll
from falcon_unzip_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def mesh8():
    return make_mesh(8, device="cpu")


@pytest.mark.parametrize("cap", [16, 2])      # 2 forces an overflow
def test_all_to_all_regroup_matches_jax(mesh8, cap):
    n_dev, feat, R = 8, 4, 64                 # 8 rows per shard
    rng = np.random.default_rng(0)
    payload = rng.integers(0, 1000, size=(R, feat)).astype(np.int32)
    owner = rng.integers(-1, n_dev, size=(R,)).astype(np.int32)
    recv, counts, dropped = coll.make_regroup(mesh8, cap=cap, feat=feat)(
        payload, owner)
    want = ref_coll.make_regroup(ref_mesh.make_mesh(8), cap=cap, feat=feat)(
        jnp.asarray(payload), jnp.asarray(owner))
    for g, w in zip((recv, counts, dropped), want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and np.array_equal(g.numpy(), w)
    # host group-by: shard dst receives, from each source shard, the
    # first cap rows it routed to dst, in row order
    recv = recv.numpy().reshape(n_dev, n_dev, cap, feat)
    counts = counts.numpy().reshape(n_dev, n_dev)
    n_dropped = 0
    for dst in range(n_dev):
        for src in range(n_dev):
            rows = [tuple(payload[i]) for i in range(src * 8, src * 8 + 8)
                    if owner[i] == dst]
            assert counts[dst, src] == min(len(rows), cap)
            assert list(map(tuple, recv[dst, src, :counts[dst, src]])) \
                == rows[:cap]
            assert (recv[dst, src, counts[dst, src]:] == -1).all()
            n_dropped += max(0, len(rows) - cap)
    assert int(dropped.sum()) == n_dropped
    assert (n_dropped > 0) == (cap == 2)


@pytest.mark.parametrize("n,wp", [(8, 2), (8, 8), (3, 3)])
def test_halo_exchange_matches_jax(n, wp):
    m = make_mesh(n, wp, device="cpu")
    nw = m.shape["window"]
    L, F, halo = nw * 8, 4, 2
    x = np.arange(L * F, dtype=np.float32).reshape(L, F)
    lg, rg = (v.numpy() for v in coll.make_halo_exchange(m, halo=halo)(x))
    want = ref_coll.make_halo_exchange(ref_mesh.make_mesh(n, wp),
                                       halo=halo)(jnp.asarray(x))
    assert np.array_equal(lg, np.asarray(want[0]))
    assert np.array_equal(rg, np.asarray(want[1]))
    shard = x.reshape(nw, 8, F)
    for w in range(nw):
        assert np.array_equal(lg.reshape(nw, halo, F)[w],
                              shard[(w - 1) % nw][-halo:])
        assert np.array_equal(rg.reshape(nw, halo, F)[w],
                              shard[(w + 1) % nw][:halo])


@pytest.mark.parametrize("n", [1, 3, 8])
def test_regroup_partition_matches_jax_and_host(n):
    """regroup_partition over a mesh must reproduce the host groupby
    exactly (per-group indices in input order) for uneven group sizes,
    with the cap doubling on overflow (5 groups, 203 rows)."""
    rng = np.random.default_rng(3)
    n_groups = 5
    ctg = rng.integers(-1, n_groups, 203).astype(np.int64)
    got = coll.regroup_partition(ctg, n_groups, make_mesh(n, device="cpu"))
    want = ref_coll.regroup_partition(ctg, n_groups, ref_mesh.make_mesh(n))
    for g in range(n_groups):
        assert got[g].dtype == np.int64
        np.testing.assert_array_equal(got[g], want[g], err_msg=f"group {g}")
        np.testing.assert_array_equal(got[g], np.nonzero(ctg == g)[0])


def test_regroup_partition_overflow_retries(mesh8):
    """All rows to one owner: the first cap overflows and doubles."""
    ctg = np.full(100, 3, np.int64)
    got = coll.regroup_partition(ctg, 4, mesh8)
    assert [len(g) for g in got] == [0, 0, 0, 100]
    np.testing.assert_array_equal(got[3], np.arange(100))


def test_regroup_partition_without_mesh_is_host_groupby():
    ctg = np.array([2, -1, 0, 2, 7, 0], np.int64)
    got = coll.regroup_partition(ctg, 3)
    assert [g.tolist() for g in got] == [[2, 5], [], [0, 3]]
    assert [g.tolist() for g in coll.regroup_partition(ctg[:0], 2)] \
        == [[], []]

"""The device twins of ``ops.consensus`` in the port == the JAX
package's (twins of tests/test_ops_consensus.py's
test_device_masks_match_host and test_votes_scatter_matches_vote_matrix):
``consensus_masks_device`` compacts to the oracle's consensus, and
``votes_scatter`` equals the JAX scatter and ``vote_matrix`` bit for bit.
"""
import numpy as np
import pytest
import torch

from falcon_unzip_tpu.oracle import consensus as oc
from falcon_unzip_tpu.ops import consensus as ref_opc
from falcon_unzip_tpu_torch.ops import consensus as opc

torch.set_num_threads(1)


def _rand_votes(rng, t_len, D=oc.MAX_DELTA + 1, max_cov=12, p_zero=0.5):
    v = rng.integers(0, max_cov, size=(t_len, D, 5)).astype(np.int32)
    mask = rng.random((t_len, D, 5)) < p_zero
    v[mask] = 0
    v[:, 1:, 4] = 0  # deletion votes only occur at delta 0
    return v


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("min_cov", [1, 2, 6])
def test_device_masks_match_jax_and_host(seed, min_cov):
    rng = np.random.default_rng(seed)
    votes = _rand_votes(rng, 64)
    tmpl = rng.integers(0, 4, 64).astype(np.int8)
    for t in (tmpl, None):
        e, b, c = opc.consensus_masks_device(torch.from_numpy(votes), t,
                                             min_cov=min_cov)
        assert e.dtype == torch.bool and b.dtype == c.dtype == torch.int32
        re, rb, rc = ref_opc.consensus_masks_device(votes, t,
                                                    min_cov=min_cov)
        assert np.array_equal(e.numpy(), np.asarray(re))
        # base and cov are read only where a cell is emitted
        sel = e.numpy()
        assert np.array_equal(b.numpy()[sel], np.asarray(rb)[sel])
        assert np.array_equal(c.numpy()[sel], np.asarray(rc)[sel])
        got = opc.compact_masks(e, b, c)
        ref = oc.consensus_from_votes(votes, t, min_cov=min_cov)
        np.testing.assert_array_equal(ref[0], got[0])
        np.testing.assert_array_equal(ref[1], got[1])


def test_device_masks_guards_match_host_masks():
    """With a template and del_min_cov, the torch twin equals the host
    ``_masks`` cell for cell (the del / sub guards)."""
    rng = np.random.default_rng(8)
    votes = _rand_votes(rng, 200, max_cov=5)
    tmpl = rng.integers(0, 5, 200).astype(np.int8)
    want = opc._masks(np, votes, tmpl, 2, 4)
    got = opc._masks_torch(torch.from_numpy(votes), tmpl, 2, 4)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w).astype(g.numpy().dtype))


def test_votes_scatter_matches_jax_and_vote_matrix():
    rng = np.random.default_rng(5)
    tags = rng.integers(-3, 40, size=(301, 3)).astype(np.int32)
    tags[:, 1] = rng.integers(0, 10, 301)   # some deltas exceed MAX_DELTA
    tags[:, 2] = rng.integers(0, 5, 301)
    t_len = 32
    ref = oc.vote_matrix([tags[tags[:, 0] >= 0]], t_len)
    dev = opc.votes_scatter(*(torch.from_numpy(tags[:, k].copy())
                              for k in range(3)), t_len=t_len)
    jx = np.asarray(ref_opc.votes_scatter(tags[:, 0], tags[:, 1],
                                          tags[:, 2], t_len=t_len))
    assert dev.dtype == torch.int32
    np.testing.assert_array_equal(ref, dev.numpy())
    np.testing.assert_array_equal(jx, dev.numpy())
    np.testing.assert_array_equal(
        opc.vote_matrix([tags[tags[:, 0] >= 0]], t_len), dev.numpy())

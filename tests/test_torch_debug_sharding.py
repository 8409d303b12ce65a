"""The port's sharding-invariant debug mode, twin of
tests/test_debug_sharding.py.

Both directions: (1) the mesh-sharded ops pass their single-device
invariant checks on real inputs, and (2) a seeded inconsistency — the
class of bug the mode exists for — is caught (not silently accepted),
while with the mode off the same corruption goes unchecked.
"""
import numpy as np
import pytest
import torch

from falcon_unzip_tpu_torch.parallel import debug
from falcon_unzip_tpu_torch.parallel.mesh import make_mesh, shard_rows
from falcon_unzip_tpu_torch.parallel.sharding import (ShardedPairHMMScorer,
                                                      ShardedPhaseOps,
                                                      ShardedWindowVotes)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def mesh8():
    return make_mesh(8, device="cpu")


@pytest.fixture()
def debug_mode():
    debug.enable(True)
    yield
    debug.enable(None)


def test_phase_ops_pass_invariants(mesh8, debug_mode):
    rng = np.random.default_rng(0)
    ops = ShardedPhaseOps(mesh8)
    pos = rng.integers(0, 300, 2000).astype(np.int32)
    base = rng.integers(0, 5, 2000).astype(np.int32)
    counts = ops.pileup(pos, base, t_len=300)
    assert counts.sum() == 2000
    M = rng.integers(-1, 2, size=(64, 48)).astype(np.int8)
    ops.association(M, max_span=8)          # raises on violation


def test_scorer_and_votes_pass_invariants(mesh8, debug_mode):
    rng = np.random.default_rng(1)
    s = ShardedPairHMMScorer(mesh8, W=16)
    q = rng.integers(0, 4, size=(5, 64)).astype(np.int8)
    t = rng.integers(0, 4, size=(5, 64)).astype(np.int8)
    n = np.full(5, 60, np.int32)
    m = np.full(5, 62, np.int32)
    ll = s(q, t, n, m)
    assert np.isfinite(ll).all()
    v = ShardedWindowVotes(mesh8)
    pos = rng.integers(0, 1024, 500).astype(np.int32)
    delta = rng.integers(0, 3, 500).astype(np.int32)
    base = rng.integers(0, 5, 500).astype(np.int32)
    v.blocks(pos, delta, base, t_len=1024, window=128)


def test_contig_without_tags_passes_invariants(mesh8, debug_mode):
    """A contig that no read reaches (no tags) leaves the padded input
    empty; the split checks must hold and the counts stay zero."""
    z = np.zeros(0, np.int32)
    assert ShardedPhaseOps(mesh8).pileup(z, z, t_len=40).sum() == 0
    blocks, seg = ShardedWindowVotes(mesh8).blocks(z, z, z, t_len=1024,
                                                   window=128)
    assert seg == 512 and blocks.shape == (2, 640, 9, 5)
    assert not blocks.any()


def test_seeded_inconsistency_is_caught(mesh8, debug_mode, monkeypatch):
    """Corrupt the sharded pileup's merged result (a stand-in for a
    wrong-split / lost-shard bug): the invariant check must fire; a row
    split that drifts onto other rows must fail the spec check."""
    ops = ShardedPhaseOps(mesh8)
    real = ops._pileup_shards

    def corrupted(gp, gb, t_len):
        out = real(gp, gb, t_len).clone()
        out[3, 2] += 1          # one shard "lost" / double-counted a vote
        return out

    monkeypatch.setattr(ops, "_pileup_shards", corrupted)
    pos = np.arange(100, dtype=np.int32)
    base = np.zeros(100, np.int32)
    with pytest.raises(debug.ShardingInvariantError, match="pileup"):
        ops.pileup(pos, base, t_len=100)
    split = shard_rows(mesh8, np.arange(16, dtype=np.int32))
    debug.check_spec("rows", split, mesh8.row_spec(("data", "window"), 16))
    split.parts[1] = split.parts[1][:1]
    with pytest.raises(debug.ShardingInvariantError, match="drifted"):
        debug.check_spec("rows", split,
                         mesh8.row_spec(("data", "window"), 16))


def test_disabled_mode_skips_checks(mesh8, monkeypatch):
    debug.enable(False)
    try:
        ops = ShardedPhaseOps(mesh8)
        real = ops._pileup_shards
        monkeypatch.setattr(ops, "_pileup_shards",
                            lambda gp, gb, t: real(gp, gb, t) + 1)
        out = ops.pileup(np.zeros(10, np.int32), np.zeros(10, np.int32),
                         t_len=50)
        assert out is not None   # no invariant error when mode is off
        assert out.sum() == 10 + 50 * 5
    finally:
        debug.enable(None)


def test_env_switch_is_the_reference_one(monkeypatch):
    monkeypatch.setenv("FALCON_UNZIP_TPU_DEBUG_SHARDING", "1")
    assert debug.enabled()
    monkeypatch.setenv("FALCON_UNZIP_TPU_DEBUG_SHARDING", "0")
    assert not debug.enabled()

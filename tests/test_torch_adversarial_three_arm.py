"""Adversarial parity: the three-arm branch through both packages' walk.

The fixture of ``tests/test_unzip_adversarial.py::
test_three_arm_branch_resolves`` (six reads of a 12 kb random sequence,
seed 41: one read, three diverged arms out of it that reconverge, two
reads after; a hand-built dovetail OverlapSet; arms 1 and 2 phased in one
block) goes through the JAX package's ``Unzipper`` and the port's.  Every
primary (name, sequence, read path) and every haplotig (all seven fields)
must be equal, and the walk must resolve the branch as the reference's
test asks.
"""
import numpy as np
import pytest

from falcon_unzip_tpu.models.overlapper import OverlapSet as RefOverlapSet
from falcon_unzip_tpu.models.unzipper import UnzipConfig as RefUnzipConfig
from falcon_unzip_tpu.models.unzipper import Unzipper as RefUnzipper
from falcon_unzip_tpu.seq import SeqBatch as RefSeqBatch
from falcon_unzip_tpu_torch.models.overlapper import OverlapSet
from falcon_unzip_tpu_torch.models.unzipper import UnzipConfig, Unzipper
from falcon_unzip_tpu_torch.seq import SeqBatch

HAPLOTIG_FIELDS = ("name", "seq", "primary", "p_start", "p_end", "reads",
                   "phase")


def _fixture():
    """The reference test's reads, overlap rows, phases and blocks."""
    rng = np.random.default_rng(41)
    base = rng.integers(0, 4, 12000).astype(np.int8)
    r0 = base[0:2000]
    arms = []
    for v in range(3):
        seg = base[1200:3200].copy()
        seg[400:1600] = (seg[400:1600] + 1 + v) % 4   # diverged middles
        arms.append(seg)
    seqs = [r0, *arms, base[2400:4400], base[3600:5600]]
    rows = []

    def dovetail(a, b, ov):
        la, lb = len(seqs[a]), len(seqs[b])
        rows.append((a, b, 0, la - ov, la, 0, ov, la, lb, 0))
    for arm_id in (1, 2, 3):
        dovetail(0, arm_id, 800)
        dovetail(arm_id, 4, 800)
    dovetail(4, 5, 800)
    phase = np.array([-1, 0, 1, -1, -1, -1], np.int8)
    block = np.array([-1, 0, 0, -1, -1, -1], np.int64)
    return seqs, np.array(rows, np.int32), phase, block


def _unzip(seq_batch, overlap_set, unzipper, cfg):
    seqs, arr, phase, block = _fixture()
    reads = seq_batch.from_strs(seqs)
    ovl = overlap_set(
        a_id=arr[:, 0], b_id=arr[:, 1], strand=arr[:, 2].astype(np.int8),
        a_start=arr[:, 3], a_end=arr[:, 4], b_start=arr[:, 5],
        b_end=arr[:, 6], a_len=arr[:, 7], b_len=arr[:, 8], dist=arr[:, 9])
    uz = unzipper(reads, block, phase, cfg=cfg(drop_chimers=False))
    return uz.unzip(ovl, np.ones(len(ovl), bool))


@pytest.fixture(scope="module")
def both():
    return (_unzip(RefSeqBatch, RefOverlapSet, RefUnzipper, RefUnzipConfig),
            _unzip(SeqBatch, OverlapSet, Unzipper, UnzipConfig))


def test_walk_resolves_the_branch(both):
    _, res = both
    assert len(res.p_ctg) == 1
    assert len(res.h_ctg) == 2
    path = res.p_ctg[0][2]
    assert path[0] == 0 and path[-1] == 5
    for h in res.h_ctg:
        assert len(h.seq) > 0
        assert h.primary == res.p_ctg[0][0]


def test_primaries_equal(both):
    ref, port = both
    assert len(port.p_ctg) == len(ref.p_ctg)
    for (rn, rs, rp), (pn, ps, pp) in zip(ref.p_ctg, port.p_ctg):
        assert pn == rn
        assert np.array_equal(np.asarray(ps), np.asarray(rs))
        assert list(pp) == list(rp)


@pytest.mark.parametrize("field", HAPLOTIG_FIELDS)
def test_haplotigs_equal(both, field):
    ref, port = both
    assert len(port.h_ctg) == len(ref.h_ctg)
    for rh, ph in zip(ref.h_ctg, port.h_ctg):
        a, b = getattr(rh, field), getattr(ph, field)
        if field == "seq":
            assert np.array_equal(np.asarray(b), np.asarray(a))
        else:
            assert b == a

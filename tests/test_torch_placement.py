"""Haplotig placement parity: ``tests/test_placement.py`` through both
packages.

Its four placements (a 6 kb haplotig cut from hap1 of a 20 kb diploid,
seed 11; a reverse-strand 5 kb one, seed 12; an unrelated 2 kb sequence
that must keep its walk estimate; a 30 kb haplotig on a 60 kb primary,
seed 21, placed through the chunk-sampled path) go through the JAX
package's ``place_haplotigs`` and the port's on the CPU.  The m4 records
and the ``p_start`` / ``p_end`` written back into each haplotig must be
equal, and within the reference test's fuzz of the truth.
"""
import dataclasses

import numpy as np
import pytest
import torch

from falcon_unzip_tpu.models.unzipper import Haplotig as RefHaplotig
from falcon_unzip_tpu.models.unzipper import \
    place_haplotigs as ref_place_haplotigs
from falcon_unzip_tpu_torch import device
from falcon_unzip_tpu_torch.models.unzipper import Haplotig, place_haplotigs
from falcon_unzip_tpu_torch.seq import revcomp
from falcon_unzip_tpu_torch.utils.simulate import make_diploid

# one intra-op thread: the suite runs several pytest workers on one host
torch.set_num_threads(1)


def _forward():
    dip = make_diploid(length=20000, het_rate=0.015, seed=11,
                       het_span=(0.35, 0.65))
    return ("000000F", dip.hap0), ("000000F_001", dip.hap1[7000:13000]), \
        (0, 0), (7000, 13000, 64)


def _reverse():
    dip = make_diploid(length=15000, het_rate=0.01, seed=12,
                       het_span=(0.3, 0.7))
    return ("p", dip.hap0), ("h", revcomp(dip.hap1[5000:10000])), (0, 0), \
        (5000, 10000, 64)


def _unaligned():
    rng = np.random.default_rng(0)
    p_seq = rng.integers(0, 4, 5000).astype(np.int8)
    alien = rng.integers(0, 4, 2000).astype(np.int8)
    return ("p", p_seq), ("h", alien), (111, 222), None


def _long():
    dip = make_diploid(length=60000, het_rate=0.01, seed=21,
                       het_span=(0.2, 0.8))
    return ("p", dip.hap0), ("h", dip.hap1[15000:45000]), (0, 0), \
        (15000, 45000, 128)


CASES = {"forward": _forward, "reverse": _reverse, "unaligned": _unaligned,
         "long_chunked": _long}


def _place(haplotig_cls, place, case):
    (pname, pseq), (hname, hseq), (s0, e0), _ = CASES[case]()
    h = haplotig_cls(name=hname, seq=np.asarray(hseq).copy(), primary=pname,
                     p_start=s0, p_end=e0, reads=[], phase=1)
    m4 = place([(pname, pseq, [])], [h])
    return h, m4


@pytest.fixture(scope="module", params=list(CASES))
def both(request):
    case = request.param
    ref = _place(RefHaplotig, ref_place_haplotigs, case)
    with device.scope("cpu"):
        port = _place(Haplotig, place_haplotigs, case)
    return case, ref, port


def test_m4_records_equal(both):
    _, (_, ref_m4), (_, port_m4) = both
    assert [dataclasses.astuple(r) for r in port_m4] == \
        [dataclasses.astuple(r) for r in ref_m4]


def test_placement_written_back_equal(both):
    case, (ref_h, _), (port_h, port_m4) = both
    assert (port_h.p_start, port_h.p_end) == (ref_h.p_start, ref_h.p_end)
    truth = CASES[case]()[3]
    if truth is None:                      # keeps its walk estimate
        assert all(r.q_name != port_h.name for r in port_m4)
        assert (port_h.p_start, port_h.p_end) == (111, 222)
    else:
        lo, hi, fuzz = truth
        assert len(port_m4) == 1
        assert abs(port_h.p_start - lo) <= fuzz
        assert abs(port_h.p_end - hi) <= fuzz

"""Port FalconSense (models/consensus.py) == the JAX package's, and the
dedup gate of the port's 3-unzip.

The same seeded template and reads go through both packages (the JAX side
on the CPU through its XLA path, the port's through the plain torch
versions of the banded kernels); the consensus must be byte-equal.  The
twins of tests/test_falcon_sense_model.py hold the port to the truth and
to oracle.consensus.falcon_sense.
"""
import numpy as np
import pytest
import torch

from falcon_unzip_tpu.models.consensus import FalconSense as RefFalconSense
from falcon_unzip_tpu_torch import device
from falcon_unzip_tpu_torch.models.consensus import (ConsensusConfig,
                                                     FalconSense)
from falcon_unzip_tpu_torch.oracle.consensus import falcon_sense as oracle
from falcon_unzip_tpu_torch.seq import SeqBatch, revcomp
from falcon_unzip_tpu_torch.utils.simulate import mutate_read, random_genome

# one intra-op thread: the suite runs several pytest workers on one host
torch.set_num_threads(1)


def test_consensus_recovers_truth():
    """Twin of test_falcon_sense_model.py::test_device_consensus_recovers_
    truth: 3 kb, 24 reads at 8%; the interior (all but 16 columns at each
    end, which the anchored alignments cannot fix) is an exact substring
    of the truth."""
    rng = np.random.default_rng(0)
    truth = random_genome(3000, 1)
    template = mutate_read(truth, 0.02, rng)
    reads = [mutate_read(truth, 0.08, rng) for _ in range(24)]
    cns = FalconSense(ConsensusConfig(min_cov=2), device="cpu")(template,
                                                                 reads)
    assert abs(len(cns) - len(truth)) <= 16
    assert truth.tobytes().find(cns[16:-16].tobytes()) >= 0


def test_consensus_matches_oracle_small():
    """Twin of test_falcon_sense_model.py::test_device_matches_oracle_small
    (400 bp, 12 reads at 6%, min_cov 1)."""
    rng = np.random.default_rng(3)
    truth = random_genome(400, 4)
    template = mutate_read(truth, 0.02, rng)
    reads = [mutate_read(truth, 0.06, rng) for _ in range(12)]
    got = FalconSense(ConsensusConfig(min_cov=1), device="cpu")(template,
                                                                 reads)
    assert np.array_equal(got, oracle(template, reads, W=256, min_cov=1))


@pytest.mark.parametrize("seed,rc", [(11, False), (12, False), (13, True)])
def test_consensus_byte_equal_to_jax(seed, rc):
    """2.5 kb template at 2%, 16 reads of 0.4-1.6 kb at 8% (seed 13: half
    of them reverse-complemented); equal bytes from both packages."""
    rng = np.random.default_rng(seed)
    truth = random_genome(2500, seed)
    template = mutate_read(truth, 0.02, rng)
    reads = []
    for k in range(16):
        L = int(rng.integers(400, 1600))
        s = int(rng.integers(0, len(truth) - L))
        r = mutate_read(truth[s : s + L], 0.08, rng)
        reads.append(revcomp(r) if rc and k % 2 else r)
    want = RefFalconSense()(template, reads)
    got = FalconSense(ConsensusConfig(), device="cpu")(template, reads)
    assert len(got) > 2000
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_unzip_dedup_flag():
    """Twin of test_pipeline.py::test_unzip_dedup_flag: dedup_haplotigs
    (a verbatim copy whose aligner takes the device of the enclosing
    scope) drops the haplotig near-identical to its primary."""
    from falcon_unzip_tpu_torch.models.dedup import dedup_haplotigs
    p = random_genome(3000, 1)
    dup = mutate_read(p, 0.001, np.random.default_rng(2))      # ~99.9% id
    distinct = mutate_read(p, 0.05, np.random.default_rng(3))  # ~95% id
    p_b = SeqBatch.from_strs([p])
    h_b = SeqBatch.from_strs([dup, distinct])
    with device.scope("cpu"):
        kept = dedup_haplotigs(p_b, h_b, max_identity=0.99)
    assert 1 in kept and 0 not in kept

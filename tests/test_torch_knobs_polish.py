"""Knob parity, 4-polish groups: the groups of
``falcon_unzip_tpu_torch/utils/knob_configs.py`` that run 4-polish alone,
through both packages on the CPU, with the bars of
``tests/test_torch_knobs_unzip.py``.

The JAX package's default run (3-unzip + 4-polish on the golden fixture)
is made once; each group's ``run_quiver`` in either package starts from a
copy of its 3-unzip (without its haplotigs for the collapsed input), as
``tests/test_torch_polish.py`` does (the port's own 3-unzip is
byte-identical to it, ``tests/test_torch_pipeline.py``).  Among the
groups: ``qv_per_base`` runs ``run_quiver`` with ``polish.qv_aware`` on a
fofn of a FASTQ with per-base quality tracks and a FASTA (the Arrow
sweeps' per-base tier mode, reads without a track at tier 0), beside the
same fofn flat (``fofn``); ``phase_unaware`` polishes a draft alone,
where the phase routing drops records, beside ``collapsed``.

The per-read mean-QV branch of ``run_quiver`` (``read_pvecs``) has no
effect from files in either package (a reader sets the mean QVs only
with the per-base tracks, which take precedence whenever a read has
one; with none every mean QV is 0, the global params), so it is held at
the ``Polisher`` level.

Run as a script from the repository's root
(``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_knobs_polish.py
[group ...]``)
it prints the JAX package's digests for its groups.
"""
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from falcon_unzip_tpu.models import polisher as ref_polisher
from falcon_unzip_tpu.ops.pairhmm import params_vector as ref_params_vector
from falcon_unzip_tpu.oracle.hmm import params_for_read_qv as ref_for_qv
from falcon_unzip_tpu_torch.models import aligner as port_aligner
from falcon_unzip_tpu_torch.models import polisher as port_polisher
from falcon_unzip_tpu_torch.ops.pairhmm import params_vector
from falcon_unzip_tpu_torch.oracle.hmm import params_for_read_qv
from falcon_unzip_tpu_torch.utils import knob_configs as kc

from test_torch_knobs_unzip import (check_group, check_stored, print_digests,
                                    run_group, same_files)
from test_torch_polish import _window_aln

# one intra-op thread: the suite runs several pytest workers on one host
torch.set_num_threads(1)

GROUPS = tuple(g.name for g in kc.GROUPS if g.stages == ("quiver",))


@pytest.fixture(scope="module")
def default_run(tmp_path_factory):
    """The inputs and the JAX package's default run."""
    d = str(tmp_path_factory.mktemp("knobs_polish"))
    kc.write_inputs(d)
    run_group("ref", kc.BY_NAME["default"], d, f"{d}/default")
    return d, f"{d}/default"


def test_default_run_matches_jax(default_run):
    d, ref_out = default_run
    port_out = f"{d}/default_port"
    run_group("port", kc.BY_NAME["default"], d, port_out, ref_out,
              stages=("quiver",))
    same_files(ref_out, port_out, "quiver")
    for stage in ("unzip", "quiver"):
        check_stored("default", stage, kc.snapshot(ref_out, stage))


@pytest.mark.parametrize("name", GROUPS)
def test_knob_group_matches_jax(name, default_run):
    d, default_out = default_run
    g = kc.BY_NAME[name]
    ref_out, port_out = f"{d}/{name}/ref", f"{d}/{name}/port"
    run_group("ref", g, d, ref_out, default_out)
    run_group("port", g, d, port_out, default_out)
    check_group(g, ref_out, port_out)
    shutil.rmtree(f"{d}/{name}")


def test_polisher_mean_qv_tiers_match_jax():
    """Per-read params from distinct mean QVs (run_quiver's read_pvecs
    branch) on the multi-error window of
    tests/test_torch_polish.py::test_polisher_matches_jax: the same
    consensus (the truth) and QVs within 1 from both packages' Polisher,
    and other QVs than the flat polish's."""
    truth, draft, aln = _window_aln(60)
    port_aln = port_aligner.AlnSet.from_bytes(aln.to_bytes())
    qv = np.random.default_rng(62).uniform(
        6.0, 30.0, int(aln.read_id.max()) + 1).astype(np.float32)
    pvecs = np.stack([params_vector(params_for_read_qv(float(q)))
                      for q in qv])
    ref_pvecs = np.stack([ref_params_vector(ref_for_qv(float(q)))
                          for q in qv])
    assert np.array_equal(pvecs, ref_pvecs)
    assert len(np.unique(pvecs, axis=0)) == len(qv)
    # one Arrow round: the JAX package compiles its splice anew each round
    kw = dict(window=512, arrow_rounds=1, margin_frac=0.9)
    want = ref_polisher.Polisher(ref_polisher.PolisherConfig(**kw),
                                 read_pvecs=ref_pvecs).polish_contig(
        "w", draft, aln, 0)
    got = port_polisher.Polisher(port_polisher.PolisherConfig(**kw),
                                 read_pvecs=pvecs, device="cpu").polish_contig(
        "w", draft, port_aln, 0)
    assert np.array_equal(got.seq, want.seq)
    assert np.array_equal(got.seq, truth)
    assert np.abs(got.qv.astype(int) - want.qv.astype(int)).max() <= 1
    flat = port_polisher.Polisher(port_polisher.PolisherConfig(**kw),
                                  device="cpu").polish_contig(
        "w", draft, port_aln, 0)
    assert not np.array_equal(got.qv, flat.qv)


if __name__ == "__main__":
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        print_digests(sys.argv[1:] or ("default",) + GROUPS,
                      os.path.join(tmp, "in"))

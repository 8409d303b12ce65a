"""Knob parity, 3-unzip groups: ``PipelineConfig`` fields off their
defaults through both packages on the CPU.

The groups of ``falcon_unzip_tpu_torch/utils/knob_configs.py`` that run
3-unzip: here the aligner's (``align_exec``: ``batch_pairs`` and the
unread ``max_hits``, through unzip and quiver; ``align_sem``) and the
overlap compute on the main thread (``no_prefetch``);
``tests/test_torch_knobs_hasm.py`` holds the overlap and graph groups.
Each group runs through the JAX package's ``run_unzip`` (and
``run_quiver``) and the port's on the golden fixture.  Bars, per stage:

- every file the stage writes (``knob_configs.PATTERNS``: the 3-unzip
  files with the 1-align AlnSet and preads.ovl, the 4-polish files with
  the consensus and the 1-track AlnSet) byte-identical between the
  packages;
- the JAX package's snapshot equal to the digest and QV lines stored for
  the group (so the card's comparison cannot go stale);
- the group's kind: an execution group equal to the baseline run of its
  inputs, a semantic group different from it.

Run as a script from the repository's root
(``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_knobs_unzip.py
[group ...]``)
it prints the JAX package's digests for its groups, in the form of
``knob_configs.DIGESTS`` and ``QV_TRACKS``.
"""
import os
import shutil
import sys

import pytest
import torch

from falcon_unzip_tpu.config import PipelineConfig as RefConfig
from falcon_unzip_tpu.pipeline.quiver import run_quiver as ref_run_quiver
from falcon_unzip_tpu.pipeline.unzip import run_unzip as ref_run_unzip
from falcon_unzip_tpu_torch.config import PipelineConfig
from falcon_unzip_tpu_torch.pipeline.quiver import run_quiver
from falcon_unzip_tpu_torch.pipeline.unzip import run_unzip
from falcon_unzip_tpu_torch.utils import knob_configs as kc
from falcon_unzip_tpu_torch.utils.fixtures import run_artifacts

# one intra-op thread: the suite runs several pytest workers on one host
torch.set_num_threads(1)

GROUPS = ("align_exec", "align_sem", "no_prefetch")


def run_group(pkg, group, d, out, default_out=None, stages=None):
    """group's stages (default: all of them) through the JAX package
    (pkg "ref") or the port on the CPU into out; a 4-polish-only run
    starts from default_out's 3-unzip."""
    stages = stages or group.stages
    if stages[0] == "quiver":
        kc.seed_unzip(group, default_out, out)
    cfg = kc.configure(RefConfig() if pkg == "ref" else PipelineConfig(),
                       group, d, out)
    for stage in stages:
        if pkg == "ref":
            (ref_run_unzip if stage == "unzip" else ref_run_quiver)(cfg)
        else:
            (run_unzip if stage == "unzip" else run_quiver)(cfg,
                                                            device="cpu")


def same_files(ref_out, port_out, stage):
    """Every file the stage wrote, byte-identical between the packages."""
    want = run_artifacts(ref_out, kc.PATTERNS[stage])
    got = run_artifacts(port_out, kc.PATTERNS[stage])
    assert want, f"{ref_out}: nothing written by {stage}"
    differ = sorted(k for k in set(want) | set(got)
                    if want.get(k) != got.get(k))
    assert not differ, f"{stage}: the packages differ in {differ}"


def check_stored(name, stage, snap):
    """The JAX package's snapshot of a run equals the stored one."""
    assert name in kc.DIGESTS and stage in kc.DIGESTS[name], \
        f"no digest stored for {name} {stage}; the JAX package gave " \
        f"{kc.stored(snap, stage)[0]!r}"
    want = kc.expected(name, stage)
    assert (snap["files"], snap["qv"]) == (want["files"], want["qv"]), \
        f"stored digest of {name} {stage} is {kc.DIGESTS[name][stage]!r}; " \
        f"the JAX package gave {kc.stored(snap, stage)[0]!r}"
    assert snap["qv_lines"] == want["qv_lines"]


def check_kind(group, snaps):
    """snaps {stage: snapshot}: an execution group equal to its inputs'
    baseline run in every stage, a semantic group different in one."""
    base = kc.BASELINE[group.inputs]
    same = all((snaps[s]["files"], snaps[s]["qv"])
               == (kc.expected(base, s)["files"], kc.expected(base, s)["qv"])
               for s in group.stages)
    if group.kind == "execution":
        assert same, f"{group.name} changed an artifact against {base}"
    elif group.kind == "semantic":
        assert not same, f"{group.name} changed no artifact against {base}"


def check_group(group, ref_out, port_out):
    snaps = {}
    for stage in group.stages:
        same_files(ref_out, port_out, stage)
        snaps[stage] = kc.snapshot(ref_out, stage)
        check_stored(group.name, stage, snaps[stage])
    check_kind(group, snaps)


def print_digests(names, d):
    """The JAX package's digests and QV lines of the named runs, as
    ``knob_configs.DIGESTS`` and ``QV_TRACKS`` entries."""
    kc.write_inputs(d)
    default_out = f"{d}/default"
    run_group("ref", kc.BY_NAME["default"], d, default_out)
    tracks = {}
    for name in names:
        g = kc.BY_NAME[name]
        out = default_out if name == "default" else f"{d}/{name}"
        if name != "default":
            run_group("ref", g, d, out, default_out)
        entry = {}
        for stage in g.stages:
            entry[stage], blob = kc.stored(kc.snapshot(out, stage), stage)
            if blob:
                tracks[entry[stage][1]] = blob
        print(f"    {name!r}: {entry!r},")
    for qv, blob in tracks.items():
        print(f"    {qv!r}: (")
        print("\n".join(f"        {part!r}" for part in blob) + "),")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("knobs_unzip"))
    kc.write_inputs(d)
    return d


@pytest.mark.parametrize("name", GROUPS)
def test_knob_group_matches_jax(name, inputs):
    g = kc.BY_NAME[name]
    ref_out, port_out = f"{inputs}/{name}/ref", f"{inputs}/{name}/port"
    run_group("ref", g, inputs, ref_out)
    run_group("port", g, inputs, port_out)
    check_group(g, ref_out, port_out)
    shutil.rmtree(f"{inputs}/{name}")


if __name__ == "__main__":
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        print_digests(sys.argv[1:] or GROUPS, os.path.join(tmp, "in"))

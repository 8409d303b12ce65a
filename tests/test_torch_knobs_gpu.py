"""Knob parity on the card: every group of
``falcon_unzip_tpu_torch/utils/knob_configs.py`` (and smoke phase 3e's
two band configurations) through the port's ``run_unzip`` /
``run_quiver`` on cuda, each stage's files equal to the JAX package's
stored digest and the consensus QVs within 1 of its stored QV lines; the
4-polish-only groups start from the default run's 3-unzip, itself held
to its digest.  Also the builds the groups exist to reach: the wavefront
at P=24, the Arrow sweeps at P=12 in the 8-warp build, their wide build
at C=12 and LJ=768 and their per-base tier mode.

Marked ``gpu``: these need an NVIDIA GPU and nvcc and skip elsewhere.
Run them on a GPU machine with
``python -m pytest --noconftest -m gpu tests/test_torch_knobs_gpu.py``
(the repository's conftest imports JAX; this file imports only the port).
"""
import pytest
import torch

from falcon_unzip_tpu_torch.config import PipelineConfig
from falcon_unzip_tpu_torch.pipeline.quiver import run_quiver
from falcon_unzip_tpu_torch.pipeline.unzip import run_unzip
from falcon_unzip_tpu_torch.utils import knob_configs as kc

pytestmark = pytest.mark.gpu

NAMES = [g.name for g in kc.GROUPS + kc.BAND_GROUPS if g.name != "default"]


def _run(group, d, out, default_out=None):
    if group.stages[0] == "quiver":
        kc.seed_unzip(group, default_out, out)
    cfg = kc.configure(PipelineConfig(), group, d, out)
    for stage in group.stages:
        (run_unzip if stage == "unzip" else run_quiver)(cfg, device="cuda")
    for stage in group.stages:
        kc.check(group.name, stage, out)      # raises on a difference


@pytest.fixture(scope="module")
def default_run(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    d = str(tmp_path_factory.mktemp("knobs_gpu"))
    kc.write_inputs(d)
    _run(kc.BY_NAME["default"], d, f"{d}/default")
    return d, f"{d}/default"


@pytest.mark.parametrize("name", NAMES)
def test_knob_group_on_card_matches_jax_digest(name, default_run):
    d, default_out = default_run
    with kc.launch_log() as log:
        _run(kc.BY_NAME[name], d, f"{d}/{name}", default_out)
    assert kc.missed_build(name, log) is None

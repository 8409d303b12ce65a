"""Knob parity, 3-hasm groups: the overlap filters (``overlap_sem``) and
the graph walk, dedup and phasing link knobs (``graph_sem``) of
``falcon_unzip_tpu_torch/utils/knob_configs.py`` through both packages'
``run_unzip`` on the golden fixture, with the bars of
``tests/test_torch_knobs_unzip.py``; and the stored digests of smoke phase
3e's two band configurations (``knob_configs.BAND_GROUPS``) against the
JAX package's run (``tests/test_torch_band_widths.py`` holds the port at
those bands on the CPU).

Run as a script from the repository's root
(``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_knobs_hasm.py
[group ...]``)
it prints the JAX package's digests for its groups.
"""
import os
import shutil
import sys

import pytest
import torch

from falcon_unzip_tpu_torch.utils import knob_configs as kc

from test_torch_knobs_unzip import (check_group, check_stored, print_digests,
                                    run_group)

# one intra-op thread: the suite runs several pytest workers on one host
torch.set_num_threads(1)

GROUPS = ("overlap_sem", "graph_sem")
BANDS = tuple(g.name for g in kc.BAND_GROUPS)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("knobs_hasm"))
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


@pytest.mark.parametrize("name", BANDS)
def test_band_group_digest_matches_jax(name, inputs):
    g = kc.BY_NAME[name]
    out = f"{inputs}/{name}/ref"
    run_group("ref", g, inputs, out)
    for stage in g.stages:
        check_stored(name, stage, kc.snapshot(out, stage))
    shutil.rmtree(f"{inputs}/{name}")


if __name__ == "__main__":
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        print_digests(sys.argv[1:] or GROUPS + BANDS, os.path.join(tmp, "in"))

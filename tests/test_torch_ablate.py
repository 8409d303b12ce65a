"""The port's pair-HMM step ablation == the TPU ablation kernel.

``scripts/ablate_pallas.py`` is loaded as it is, its module constants set
small (Dmax, PB, LQG) and its Pallas calls run in interpret mode on the
CPU; the same seeded inputs go through ``pairhmm_ablate_plain`` (the
function the CUDA kernel is held to on the card), for all five feature
sets, at Dmax 33 (the band never moves off column 0) and Dmax 385 (lo > 0
and a window base of 128).  Tolerance 0, every output element equal,
except for the sets with the logaddexps at the probe: there 1e-6
relative, since XLA's exp and log1p and torch's differ in the last bit.

Two inputs.  The script's own (seeded rows, every state plane NEG), where
out is NEG everywhere.  And ``probe_inputs``, where the script's six
scratch planes start from a seeded plane instead of NEG (their first
write, the kernel's NEG fill, is redirected to an extra input; nothing of
the script is edited): there the shift, the window and the logaddexps
each change out, which ``test_each_part_changes_the_probe_output`` holds.
"""
import functools
import importlib.util
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from falcon_unzip_tpu_torch.ops import _kernels
from falcon_unzip_tpu_torch.ops.pairhmm_ablate import (FEATURE_SETS,
                                                        neg_init,
                                                        pairhmm_ablate,
                                                        pairhmm_ablate_plain,
                                                        probe_inputs)

torch.set_num_threads(1)

SCRIPT = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                      "scripts", "ablate_pallas.py")
P, PB, LQG, W = 16, 8, 512, 128
FEATS_IDS = dict(ids=lambda f: "+".join(f) or "none")


class _Seeded:
    """A scratch ref whose first write (the kernel's NEG fill) stores the
    block of the init plane instead; every later access passes through."""

    def __init__(self, ref, init_ref):
        self.ref, self.init, self.fresh = ref, init_ref, True

    def __getitem__(self, idx):
        return self.ref[idx]

    def __setitem__(self, idx, val):
        if self.fresh:
            self.fresh, val = False, self.init[:]
        self.ref[idx] = val


def _seeded_call(kern, *, grid, in_specs, out_specs, out_shape,
                 scratch_shapes, init):
    """pl.pallas_call in interpret mode with the scratch planes seeded
    from ``init`` (P, W), fed as one more input blocked like the output."""
    def seeded(qg_ref, init_ref, out_ref, *scratch):
        kern(qg_ref, out_ref, *(_Seeded(r, init_ref) for r in scratch))

    call = pl.pallas_call(
        seeded, grid=grid,
        in_specs=[*in_specs, pl.BlockSpec((PB, W), lambda g: (g, 0))],
        out_specs=out_specs, out_shape=out_shape,
        scratch_shapes=scratch_shapes, interpret=True)
    return lambda qg: call(qg, init)


def _script(Dmax, init=None):
    spec = importlib.util.spec_from_file_location("_ablate_pallas", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.Dmax, mod.PB, mod.LQG = Dmax, PB, LQG
    call = functools.partial(pl.pallas_call, interpret=True)
    if init is not None:
        call = functools.partial(_seeded_call, init=jnp.asarray(init))
    mod.pl = types.SimpleNamespace(
        pallas_call=call, BlockSpec=pl.BlockSpec, ds=pl.ds,
        multiple_of=pl.multiple_of)
    return mod


def _rows(seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 5, size=(P, LQG)).astype(np.int32)


def _plain(qg, init, feats, Dmax):
    return pairhmm_ablate_plain(torch.from_numpy(qg),
                                torch.from_numpy(init), feats,
                                Dmax=Dmax).numpy()


@pytest.mark.parametrize("Dmax", [33, 385])
@pytest.mark.parametrize("feats", FEATURE_SETS, **FEATS_IDS)
def test_plain_ablation_equals_tpu_kernel(Dmax, feats):
    mod = _script(Dmax)
    assert mod.W == W
    qg = _rows(Dmax)
    want = np.asarray(mod.make(frozenset(feats))(jnp.asarray(qg)))
    got = _plain(qg, neg_init(P, W), feats, Dmax)
    assert got.shape == want.shape == (P, W)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)          # tolerance 0


@pytest.mark.parametrize("Dmax", [33, 385])
@pytest.mark.parametrize("feats", FEATURE_SETS, **FEATS_IDS)
def test_plain_ablation_equals_tpu_kernel_at_probe(Dmax, feats):
    qg, init = probe_inputs(P, LQG, W, Dmax)
    mod = _script(Dmax, init)
    want = np.asarray(mod.make(frozenset(feats))(jnp.asarray(qg)))
    got = _plain(qg, init, feats, Dmax)
    assert np.isfinite(want).all() and (want > -1e29).all()
    if "lse" in feats:     # XLA's exp/log1p and torch's differ in the ulp
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    else:
        np.testing.assert_array_equal(got, want)      # tolerance 0


@pytest.mark.parametrize("Dmax", [385, 1025])
def test_each_part_changes_the_probe_output(Dmax):
    """At the probe every feature set gives its own out, and the window
    decides where load's out is -3 rather than -0.1 above init."""
    qg, init = probe_inputs(P, 1024, W, Dmax)
    outs = {f: _plain(qg, init, f, Dmax) for f in FEATURE_SETS}
    for a in FEATURE_SETS:
        for b in FEATURE_SETS:
            if a < b:
                assert not np.array_equal(outs[a], outs[b]), (a, b)
    # no shift, max form: each column keeps its init; M = em + init
    em = outs[("load",)] - init
    lo_last = max(0, Dmax // 2 - W // 2)
    hit = np.stack([(qg[:, w : w + lo_last + 1] < 4).any(1)
                    for w in range(W)], 1)
    np.testing.assert_allclose(em, np.where(hit, -0.1, -3.0), atol=1e-5)
    assert 0 < hit.sum() < hit.size


@pytest.mark.parametrize("lo", [0, 5, 127, 128, 200])
def test_window_roll_is_lo_plus_w(lo):
    """The script's window expression (:40-44) reads qg[row, lo + w]."""
    qg = _rows(lo)

    def kern(qg_ref, out_ref):
        N = W + 128
        base = pl.multiple_of((lo // 128) * 128, 128)
        win = qg_ref[:, pl.ds(base, N)]
        r = lo - base
        out_ref[:] = pltpu.roll(win, (N - r) % N, axis=1)[:, :W]

    got = pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct((P, W), jnp.int32),
        interpret=True)(jnp.asarray(qg))
    np.testing.assert_array_equal(np.asarray(got), qg[:, lo : lo + W])


def test_cpu_ablation_launches_no_kernel():
    _kernels.reset_counts()
    out = pairhmm_ablate(torch.from_numpy(_rows(1)),
                         torch.from_numpy(neg_init(P, W)), ("lse",), Dmax=9)
    assert out.shape == (P, W)
    assert _kernels.ABLATE.launches == 0


def test_ablation_kernel_rejects_cpu_and_unbuilt_sets():
    qg = torch.from_numpy(_rows(2))
    init = torch.from_numpy(neg_init(P, W))
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.pairhmm_ablate(qg, init, ("lse",), Dmax=9)
    with pytest.raises(ValueError, match="not built"):
        _kernels.pairhmm_ablate(qg, init, ("shift", "lse"), Dmax=9)

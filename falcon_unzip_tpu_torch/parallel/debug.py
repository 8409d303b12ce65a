"""Sharding-invariant debug mode — the race-detection analogue.

Port of ``falcon_unzip_tpu.parallel.debug``.  Sharding bugs (rows split
onto the wrong devices, a reduction that stops being order-free, a pad
row that votes) show up as cross-shard disagreement.  This mode makes
that class of bug loud:

- every mesh-sharded op (pileup, association, pair-HMM scoring, Arrow
  splice, window-sharded votes) re-executes its single-device op and
  asserts EXACT equality for integer ops / tight-tolerance equality for
  the float HMM sweeps;
- row-split inputs are checked against the split they were built with
  (the devices and the rows of each shard) before dispatch.

Enable with FALCON_UNZIP_TPU_DEBUG_SHARDING=1 (the same switch as the
JAX package's) or by calling ``enable(True)``; zero overhead when off.
``enable``, ``enabled``, ``ShardingInvariantError`` and ``check_equal``
are verbatim copies.
"""
from __future__ import annotations

import os

import numpy as np

_FORCED: bool | None = None


def enable(on: bool | None = True) -> None:
    """True/False force the mode; None restores the env-var default."""
    global _FORCED
    _FORCED = on


def enabled() -> bool:
    if _FORCED is not None:
        return _FORCED
    return os.environ.get("FALCON_UNZIP_TPU_DEBUG_SHARDING", "") not in (
        "", "0", "false")


class ShardingInvariantError(AssertionError):
    """A mesh-sharded op disagreed with its single-device reference."""


def check_equal(name: str, sharded, reference, atol: float = 0.0) -> None:
    """Assert sharded == reference (exact for integers, atol for floats)."""
    s = np.asarray(sharded)
    r = np.asarray(reference)
    if s.shape != r.shape:
        raise ShardingInvariantError(
            f"[{name}] shape drift: sharded {s.shape} vs reference "
            f"{r.shape}")
    if atol == 0.0:
        bad = s != r
    else:
        bad = ~np.isclose(s, r, atol=atol, rtol=1e-6)
    if bad.any():
        idx = tuple(int(i[0]) for i in np.nonzero(bad))
        raise ShardingInvariantError(
            f"[{name}] {int(bad.sum())}/{bad.size} elements disagree with "
            f"the single-device reference (first at {idx}: "
            f"sharded={s[idx]!r} ref={r[idx]!r}) — sharding invariant "
            f"violated (wrong spec / non-order-free reduction / stale "
            f"jit cache)")


def check_spec(name: str, arr, expected_spec) -> None:
    """Assert a row-split input (``parallel.mesh.Shards``) carries the
    split it was built with: its spec is (axes, the device of each shard,
    the rows of each shard), as ``Mesh.row_spec`` derives it."""
    spec = getattr(arr, "spec", None)
    if spec is None:
        return
    if tuple(spec) != tuple(expected_spec):
        raise ShardingInvariantError(
            f"[{name}] input sharding drifted: {spec} != {expected_spec}")

"""The least time a kernel launch needs: operations and bytes from the
launch's own pairs, over the card's peaks.

A frozen copy of ``falcon_unzip_tpu_torch/bench.py``'s work arithmetic
(operations per cell from the reference algorithm, not from a kernel's
instructions), applied to each launch of the real traffic.  One change:
the input bytes are the pairs' own bases (each read once) and the moves
written are each pair's own antidiagonals, not the padded rows and
``Dmax`` of the launch, so that trimming padding moves the device time and
not the yardstick.

Peaks of one H100 SXM: 67 TFLOP/s float32 outside the tensor cores and
3.35 TB/s HBM are NVIDIA's published figures (at 700 W).  The int32 rate
is not published: it is derived here as 132 SMs x 64 INT32 lanes x the
1.98 GHz boost clock (16.7 TOP/s).
"""
from __future__ import annotations

import numpy as np

FP32_PEAK = 67e12
INT32_PEAK = 132 * 64 * 1.98e9          # derived, not published
HBM_BYTES_PER_S = 3.35e12

# bench.py: the edit recurrence's int32 operations at an inner cell, and
# those an antidiagonal and pair costs at the band's edges
WAVEFRONT_OPS_PER_CELL = 14
WAVEFRONT_OPS_PER_ANTIDIAGONAL = 19
# bench.py: the Arrow sweeps' operations per swept cell, forward and
# backward averaged
ARROW_OPS_PER_CELL = 66


def least_s(ops: float, nbytes: float, ops_per_s: float) -> float:
    """The larger of the operations over their peak and the bytes over the
    memory rate, in seconds."""
    return max(ops / ops_per_s, nbytes / HBM_BYTES_PER_S)


def wavefront(n, m, *, Dmax: int, W: int, want_bp: bool) -> dict:
    """Cells, int32 operations and bytes of one banded wavefront launch:
    each pair's antidiagonals up to its (n, m) corner, W cells each; the
    pairs' bases read, the three int32 results and (with moves) the packed
    2-bit moves of the antidiagonals it needs written."""
    n = np.asarray(n, np.int64)
    m = np.asarray(m, np.int64)
    diags = np.minimum(Dmax, n + m + 1)
    cells = int(diags.sum()) * W
    nbytes = int((n + m).sum()) + 8 * len(n) + 12 * len(n)
    if want_bp:
        nbytes += 4 * int((-(-diags // 16)).sum()) * W
    ops = cells * WAVEFRONT_OPS_PER_CELL + int(diags.sum()) * \
        WAVEFRONT_OPS_PER_ANTIDIAGONAL
    return {"cells": cells, "ops": ops, "bytes": nbytes,
            "least_s": least_s(ops, nbytes, INT32_PEAK)}


def arrow(n, m, *, Lq: int, C: int) -> dict:
    """Swept cells, operations and bytes of one Arrow sweep launch: rows
    0..n and columns 0..m of each pair, forward and backward; the pairs'
    bases, candidates and parameters read, the sweeps' outputs written in
    full (the caller reads them all)."""
    n = np.asarray(n, np.int64)
    m = np.asarray(m, np.int64)
    P = len(n)
    R = Lq + 1
    cells = 2 * int(((n + 1) * (m + 1)).sum())
    nbytes = (int((n + m).sum()) + 8 * P + 4 * P * C + 40 * P
              + 4 * P * C * R * (3 + 2 * 3) + 4 * P)
    ops = cells * ARROW_OPS_PER_CELL
    return {"cells": cells, "ops": ops, "bytes": nbytes,
            "least_s": least_s(ops, nbytes, FP32_PEAK)}

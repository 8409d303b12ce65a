"""What the timing scripts share: the card timer and ``--root``'s loader."""
from __future__ import annotations

import os
import sys

import torch

SPIN_CYCLES = 10_000_000    # ~5 ms at the H100's 1.98 GHz


def time_ms(fn, reps: int, spin: bool = True) -> float:
    """Device ms a call of ``fn``: CUDA events around ``reps`` calls after
    one warm-up call.  With ``spin`` the calls queue behind a ~5 ms spin of
    the card, so that the host's time a call (tens of microseconds, more
    than the shortest kernels take) leaves no gap between them."""
    fn()
    if spin:
        torch.cuda._sleep(SPIN_CYCLES)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def load_package(root) -> None:
    """Make the next imports of ``falcon_unzip_tpu_torch`` come from the
    checkout ``root`` (None: stay with this one), so that a script times
    another checkout's package.  The modules imported so far are dropped
    from ``sys.modules``; what the caller has already bound stays this
    checkout's."""
    if root is None:
        return
    sys.path.insert(0, os.path.abspath(root))
    for name in [k for k in sys.modules
                 if k.split(".")[0] == "falcon_unzip_tpu_torch"]:
        del sys.modules[name]

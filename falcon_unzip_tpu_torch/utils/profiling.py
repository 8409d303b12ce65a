"""Tracing/profiling hooks (torch.profiler + stage wall-clock).

Port of ``falcon_unzip_tpu.utils.profiling``: ``device_trace`` records
the enclosed block with ``torch.profiler`` (host ops always, and the
CUDA kernels and copies of every thread when the device is a GPU) and
writes one Chrome trace a run into ``out_dir``; open it in Perfetto
(ui.perfetto.dev) or chrome://tracing.  ``StageTimer`` is a verbatim
copy.
"""
from __future__ import annotations

import contextlib
import logging
import os
import time

logger = logging.getLogger(__name__)


@contextlib.contextmanager
def device_trace(out_dir: str, device, name: str):
    """Capture a torch.profiler trace of the enclosed block on ``device``
    into ``out_dir/<name>.<pid>.<ns>.pt.trace.json`` (a file of its own
    for each run, so that runs sharing ``out_dir`` keep every trace)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..device import resolve

    activities = [ProfilerActivity.CPU]
    if resolve(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(
        out_dir, f"{name}.{os.getpid()}.{time.time_ns()}.pt.trace.json")
    prof = profile(activities=activities, record_shapes=False,
                   with_stack=False)
    prof.start()
    try:
        yield
    finally:
        if ProfilerActivity.CUDA in activities:
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(path)
        logger.info("profiler trace written to %s", path)


class StageTimer:
    """Accumulates named wall-clock spans; .summary() -> {name: seconds}."""

    def __init__(self):
        self.spans: dict[str, float] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans[name] = self.spans.get(name, 0.0) + (
                time.perf_counter() - t0)

    def summary(self) -> dict[str, float]:
        return {k: round(v, 4) for k, v in sorted(self.spans.items())}

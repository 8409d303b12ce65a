"""Device busy time from the slots' torch.profiler traces.

Each slot traces the device's work over its jobs (``Tracer``: CUDA
activity only, so that the host's operations do not swell the trace) and
marks the trace with the wall clock at the window's start: after a
synchronise it reads ``time.time()``, runs one short spin kernel,
synchronises and reads the clock again.  ``read`` maps every device event
of a trace onto the wall clock through the marker kernel (to within half
that round trip), and ``merge`` takes the union of the kernel, memcpy and
memset intervals of all slots inside the window (the arithmetic of
``chip_smoke.py`` phase 5c, divided by the measured window rather than by
the trace's own span).

The marks are also the check that the slots' device timestamps share one
clock: every slot marks at the same wall time, and the offsets from trace
time to wall time have to agree between the slots to within the marks'
round trips.  On the CPU there is no device to trace and the tracer
records nothing.
"""
from __future__ import annotations

import json
import os
import time

MARK = "spin_kernel"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Tracer:
    """torch.profiler's CUDA activity over a slot's jobs."""

    def __init__(self, torch, device):
        self.torch, self.device = torch, device
        self.prof = None
        if device.type == "cuda":
            from torch.profiler import ProfilerActivity, profile
            self.prof = profile(activities=[ProfilerActivity.CUDA],
                                record_shapes=False, with_stack=False)
        self.wall = None

    def start(self) -> None:
        """Start tracing; a few spin kernels let the tracer's first-launch
        costs fall before the mark."""
        if self.prof:
            self.prof.start()
            for _ in range(3):
                self.torch.cuda._sleep(1000)
            self.torch.cuda.synchronize()

    def mark(self) -> None:
        """The wall-clock mark: call at the window's start."""
        torch = self.torch
        if not self.prof:
            self.wall = (time.time(), time.time())
            return
        torch.cuda.synchronize()
        a = time.time()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        self.wall = (a, time.time())

    def stop(self, path: str) -> str | None:
        if not self.prof:
            return None
        self.torch.cuda.synchronize()
        self.prof.stop()
        self.prof.export_chrome_trace(path)
        return path


def read(path: str | None, wall: tuple) -> dict:
    """{"offset_s": wall minus trace time at the marker kernel's middle,
    "round_trip_s": the mark's, "events": [(start, end, name)] of the
    device events in wall seconds, "bytes": the trace's size}."""
    if path is None:
        return {"offset_s": 0.0, "round_trip_s": 0.0, "events": [],
                "bytes": 0}
    with open(path) as fh:
        events = [e for e in json.load(fh)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e
                  and e.get("cat") in DEVICE_CATS]
    marks = [e for e in events if MARK in e["name"]]
    if not marks:
        raise RuntimeError(f"{path}: no {MARK} marker kernel")
    mk = marks[-1]
    offset = (wall[0] + wall[1]) / 2 - (mk["ts"] + mk["dur"] / 2) / 1e6
    return {"offset_s": offset, "round_trip_s": wall[1] - wall[0],
            "events": [(e["ts"] / 1e6 + offset,
                        (e["ts"] + e["dur"]) / 1e6 + offset, e["name"])
                       for e in events if e is not mk],
            "bytes": os.path.getsize(path)}


def union(intervals: list) -> list:
    """Disjoint, sorted union of (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def merge(traces: list, t0: float, t1: float) -> dict:
    """Busy seconds of the device inside [t0, t1] over all traces, the
    device time by event name and the idle gaps, longest first."""
    clipped = [(max(a, t0), min(b, t1), name) for tr in traces
               for a, b, name in tr["events"] if b > t0 and a < t1]
    busy = union([(a, b) for a, b, _ in clipped])
    by_name: dict = {}
    for a, b, name in clipped:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    return {"busy_s": sum(b - a for a, b in busy), "window_s": t1 - t0,
            "by_name": by_name, "gaps": gaps}

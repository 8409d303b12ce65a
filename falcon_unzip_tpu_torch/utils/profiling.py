"""Tracing hooks: torch.profiler traces and the port's host spans.

``device_trace`` records the enclosed block with ``torch.profiler`` (host
ops always, and the CUDA kernels and copies of every thread when the
device is a GPU) and writes one Chrome trace a run into ``out_dir``; open
it in Perfetto (ui.perfetto.dev) or chrome://tracing.

``span(name, **attrs)`` times a block of the port's host work.  Its
object holds the block's duration in seconds (``.s``), which is what the
pipelines' ``metrics.jsonl`` rows report.  The recorder is on while a
``torch.profiler`` session records in this process (``device_trace``, or
any profiler a caller starts); the flag is torch's process-wide one, so
spans on the overlap prefetch's thread count too.  Off, a span costs one
read of that flag and two clock reads, and keeps nothing.  On, each span
also keeps a record and opens a ``record_function`` range of its name, so
the profiler's own trace shows it.  A record:

* ``stage``: the name; ``id``; ``parent``: the id of the span open around
  it on its thread, or, on a thread with none open, of the innermost root
  span open in the process (None for a root);
* ``t0`` and ``ts``: start and end in wall-clock seconds to the
  microsecond (``time.perf_counter_ns`` mapped onto ``time.time`` through
  one anchor a process); ``s``: the duration;
* ``thread``: the thread's name; ``cpu_s``: the thread's CPU time over
  the span; a root also ``proc_cpu_s``, the whole process's;
* the span's ``attrs``.

When a root span ends, the records of its tree also go into the
recording profiler's own trace, as the metadata key ``fu_spans.<root id>``
(a list of records): the exported Chrome trace carries them whoever
started the profiler.  ``drain()`` returns the kept records, oldest end
first, and clears them; ``log_spans(metrics)`` appends them to a
``MetricsLog``, one row a span.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import logging
import os
import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler

logger = logging.getLogger(__name__)

# the wall clock of perf_counter_ns()'s zero, read once a process
_WALL_NS = time.time_ns() - time.perf_counter_ns()

# the recorder is one a process: spans open anywhere in the port, on any
# thread, and the pipelines and the benchmark drain what they kept
_lock = threading.Lock()          # guards _records and _roots
_records: list = []
_kept = 0                         # records ever appended to _records
_roots: list = []                 # ids of the open root spans, innermost last
_ids = itertools.count(1)
_local = threading.local()        # .stack: ids of this thread's open spans


def enabled() -> bool:
    """Whether a torch.profiler session records in this process."""
    return _autograd_profiler._is_profiler_enabled


def _wall(ns: int) -> float:
    return round((_WALL_NS + ns) / 1e9, 6)


class Span:
    """One timed block; ``.s`` is its duration once it has ended."""

    __slots__ = ("name", "attrs", "s", "_t0", "_rec", "_fn", "_cpu",
                 "_proc", "_id", "_parent", "_mark")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        self.s = 0.0
        self._rec = False

    def __enter__(self) -> "Span":
        if enabled():
            self._open()
            self._t0 = time.perf_counter_ns()
            self._cpu = time.thread_time()      # read inside the wall span
        else:
            self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        if self._rec:
            cpu = time.thread_time() - self._cpu
            t1 = time.perf_counter_ns()
            self.s = (t1 - self._t0) / 1e9
            self._close(t1, cpu)
        else:
            self.s = (time.perf_counter_ns() - self._t0) / 1e9

    def _open(self) -> None:
        self._rec = True
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self._id = next(_ids)
        if stack:
            self._parent = stack[-1]
        else:
            with _lock:
                self._parent = _roots[-1] if _roots else None
                if self._parent is None:
                    _roots.append(self._id)
                    self._mark = _kept
        if self._parent is None:
            self._proc = time.process_time()
        stack.append(self._id)
        self._fn = _autograd_profiler.record_function(self.name)
        self._fn.__enter__()

    def _close(self, t1: int, cpu: float) -> None:
        global _kept
        self._fn.__exit__(None, None, None)
        rec = {"stage": self.name, "id": self._id, "parent": self._parent,
               "thread": threading.current_thread().name,
               "t0": _wall(self._t0), "ts": _wall(t1), "s": self.s,
               "cpu_s": cpu}
        if self._parent is None:
            rec["proc_cpu_s"] = time.process_time() - self._proc
        rec.update(self.attrs)
        _local.stack.pop()
        with _lock:
            if self._parent is None:
                _roots.remove(self._id)
            _records.append(rec)
            _kept += 1
        if self._parent is None:
            _to_trace(rec, self._mark)


TRACE_KEY = "fu_spans."


def _to_trace(root: dict, mark: int) -> None:
    """Add the kept records of the root's tree to the recording
    profiler's trace, under the metadata key ``fu_spans.<root id>``;
    ``mark``: the records kept before the root began."""
    tree, rows = {root["id"]}, []
    with _lock:
        # those kept since the root began, newest first: a parent ends
        # after its children
        for rec in _records[: -(_kept - mark) - 1 : -1]:
            if rec is root or rec["parent"] in tree:
                tree.add(rec["id"])
                rows.append(rec)
    torch._C._autograd._add_metadata_json(f"{TRACE_KEY}{root['id']}",
                                          json.dumps(rows[::-1]))


def span(name: str, **attrs) -> Span:
    """Time the enclosed block (``with span("x") as sp: ...; sp.s``)."""
    return Span(name, attrs)


def drain() -> list:
    """The records kept since the last drain; clears them."""
    global _records
    with _lock:
        out, _records = _records, []
    return out


def log_spans(metrics) -> None:
    """Append the drained records to a ``utils.metrics.MetricsLog``, one
    row a span (nothing when the recorder was off)."""
    for rec in drain():
        metrics.log(rec.pop("stage"), **rec)


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

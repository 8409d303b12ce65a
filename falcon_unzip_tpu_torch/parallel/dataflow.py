"""Host-side streaming dataflow engine.

Role parity: [U] pypeFLOW's PypeProcWatcherWorkflow + pwatcher — a DAG of
tasks fanned out as cluster jobs with heartbeat files and sentinel-based
failure detection (SURVEY.md §1 L5/L7, §5 failure detection).

Re-design: an in-process pipeline of stages connected by bounded queues.
Each stage runs worker threads (host parse/stitch work releases the GIL
in numpy, and device dispatch overlaps host work); items carry retry
budgets; a heartbeat thread detects stalled stages.  Device batches flow
through unchanged — this engine feeds them, it does not schedule chips
(XLA owns the device).
"""
from __future__ import annotations

import dataclasses
import logging
import queue
import threading
import time
from typing import Any, Callable, Iterable

logger = logging.getLogger(__name__)

_STOP = object()


@dataclasses.dataclass
class StageSpec:
    name: str
    fn: Callable[[Any], Any]         # item -> result (None = drop)
    workers: int = 1
    max_retries: int = 1
    queue_size: int = 64


class StageError(RuntimeError):
    def __init__(self, stage: str, item, exc: Exception):
        super().__init__(f"stage '{stage}' failed on {item!r}: {exc}")
        self.stage = stage
        self.item = item
        self.cause = exc


class Pipeline:
    """Linear pipeline of StageSpecs: source -> s1 -> ... -> sink list."""

    def __init__(self, stages: list[StageSpec],
                 heartbeat_s: float = 30.0):
        self.stages = stages
        self.heartbeat_s = heartbeat_s
        self._progress = [0] * len(stages)
        self._errors: list[StageError] = []
        self._lock = threading.Lock()

    def run(self, source: Iterable[Any]) -> list[Any]:
        qs = [queue.Queue(maxsize=s.queue_size) for s in self.stages]
        out_q: queue.Queue = queue.Queue()
        threads: list[threading.Thread] = []
        stop_hb = threading.Event()

        def worker(si: int, spec: StageSpec):
            in_q = qs[si]
            nxt = qs[si + 1] if si + 1 < len(self.stages) else out_q
            while True:
                item = in_q.get()
                if item is _STOP:
                    in_q.put(_STOP)  # release sibling workers
                    return
                payload, _ = item
                # retries run inline: re-queueing would land behind _STOP
                for attempt in range(spec.max_retries + 1):
                    try:
                        res = spec.fn(payload)
                    except Exception as exc:  # noqa: BLE001
                        if attempt < spec.max_retries:
                            logger.warning("[%s] retry %d after: %s",
                                           spec.name, attempt + 1, exc)
                            continue
                        with self._lock:
                            self._errors.append(
                                StageError(spec.name, payload, exc))
                        res = None
                    break
                with self._lock:
                    self._progress[si] += 1
                if res is not None:
                    nxt.put((res, 0) if nxt is not out_q else res)

        def heartbeat():
            last = list(self._progress)
            while not stop_hb.wait(self.heartbeat_s):
                with self._lock:
                    cur = list(self._progress)
                for si, spec in enumerate(self.stages):
                    if cur[si] == last[si] and not qs[si].empty():
                        logger.warning(
                            "[heartbeat] stage '%s' made no progress in "
                            "%.0fs (%d done)", spec.name, self.heartbeat_s,
                            cur[si])
                last = cur

        for si, spec in enumerate(self.stages):
            for _ in range(spec.workers):
                t = threading.Thread(target=worker, args=(si, spec),
                                     daemon=True, name=f"df-{spec.name}")
                t.start()
                threads.append(t)
        hb = threading.Thread(target=heartbeat, daemon=True, name="df-hb")
        hb.start()

        for item in source:
            qs[0].put((item, 0))
        qs[0].put(_STOP)

        # drain stage by stage: when all workers of stage i exit, signal i+1
        widx = 0
        for si, spec in enumerate(self.stages):
            for _ in range(spec.workers):
                threads[widx].join()
                widx += 1
            if si + 1 < len(self.stages):
                qs[si + 1].put(_STOP)
        stop_hb.set()

        if self._errors:
            raise self._errors[0]
        results = []
        while not out_q.empty():
            results.append(out_q.get())
        return results


class Prefetch:
    """Background evaluation of one callable on the dataflow engine.

    The pypeFLOW role this fills: a DAG node whose inputs are already
    satisfied runs concurrently with the rest of the flow (SURVEY.md §2c
    dataflow row) — e.g. the hasm overlap compute depends only on the
    preads, so the unzip driver starts it here while stages 1-2
    (align + phasing) run, and hasm joins via ``get()``.  Runs through
    Pipeline, so stage heartbeat/retry semantics apply.
    """

    def __init__(self, name: str, fn: Callable[[], Any],
                 max_retries: int = 0):
        self._pipe = Pipeline([StageSpec(name=name,
                                         fn=lambda _x: (fn(),),
                                         max_retries=max_retries)])
        self._result: Any = None
        self._exc: Exception | None = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"prefetch-{name}")
        self._thread.start()

    def _run(self):
        try:
            out = self._pipe.run([None])
            self._result = out[0][0] if out else None
        except Exception as exc:  # noqa: BLE001 - surfaced in get()
            self._exc = exc

    def get(self):
        """Join the background work; re-raises its failure."""
        self._thread.join()
        if self._exc is not None:
            raise self._exc
        return self._result

"""Stage-level checkpoint/resume: the filesystem is the checkpoint.

Role parity: the reference's recovery model — every pypeFLOW task writes
durable outputs into its own directory and a re-run skips tasks whose
outputs exist (Makefile semantics; SURVEY.md §5 checkpoint/resume).
Here each pipeline stage is wrapped in ``Stage``: outputs + a done-marker
manifest (inputs hash, wall time, metrics) make re-execution idempotent
at stage granularity.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import time
from typing import Callable

logger = logging.getLogger(__name__)


def _fingerprint(parts) -> str:
    h = hashlib.sha256()
    for p in parts:
        h.update(str(p).encode())
        if isinstance(p, str) and os.path.exists(p):
            st = os.stat(p)
            h.update(f"{st.st_size}:{st.st_mtime_ns}".encode())
    return h.hexdigest()[:16]


class Stage:
    """A resumable pipeline stage.

    run(fn) executes fn() unless the stage's done marker matches the
    current input fingerprint and all declared outputs exist.
    """

    def __init__(self, out_dir: str, name: str, inputs=(), outputs=(),
                 resume: bool = True, sync=None):
        self.dir = os.path.join(out_dir, name)
        self.name = name
        self.inputs = list(inputs)
        self.outputs = [os.path.join(self.dir, o) for o in outputs]
        self.resume = resume
        # multi-host: the skip/run decision must be identical on every
        # process (the stage body issues collectives) — `sync` maps host
        # 0's decision onto all hosts (parallel.distributed.sync_stage_done)
        self.sync = sync
        self.marker = os.path.join(self.dir, "stage.done.json")

    def out(self, rel: str) -> str:
        return os.path.join(self.dir, rel)

    def is_done(self) -> bool:
        if not self.resume or not os.path.exists(self.marker):
            return False
        try:
            with open(self.marker) as fh:
                meta = json.load(fh)
        except Exception:
            return False
        if meta.get("fingerprint") != _fingerprint(self.inputs):
            return False
        return all(os.path.exists(o) for o in self.outputs)

    def metrics(self) -> dict:
        """Metrics stored by the last completed run (empty if none)."""
        try:
            with open(self.marker) as fh:
                return json.load(fh).get("metrics", {})
        except Exception:
            return {}

    def run(self, fn: Callable[["Stage"], dict | None]) -> bool:
        """Execute the stage body; returns True if it ran, False if skipped."""
        done = self.is_done()
        if self.sync is not None:
            done = self.sync(done)
        if done:
            logger.info("[%s] up to date -- skipped", self.name)
            return False
        os.makedirs(self.dir, exist_ok=True)
        t0 = time.time()
        metrics = fn(self) or {}
        meta = {
            "fingerprint": _fingerprint(self.inputs),
            "wall_s": round(time.time() - t0, 3),
            "metrics": metrics,
        }
        tmp = self.marker + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(meta, fh, indent=1)
        os.replace(tmp, self.marker)
        logger.info("[%s] done in %.1fs %s", self.name, meta["wall_s"],
                    metrics)
        return True

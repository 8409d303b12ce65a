"""A job slot: one worker process on the card, driven through a pipe.

The protocol, parent to slot: the slot's spec (process arguments), then the
driver's shared inputs, then ``("go", t0, t1)``.  Slot to parent:
``("ready", info)`` once set-up and warm-up are done, then ``("done",
result)``, or ``("error", text)`` at any point.

In the window the slot starts jobs until ``t1`` (at least one, and
while the driver's ``owed`` says that requests the check judges are not
yet taken) and lets the last one finish.  Traced, it starts
torch.profiler before it reports ready, records the window
(``trace.Tracer``), times every launch of the port's kernels with their
CUDA events and keeps each wavefront and Arrow launch's pair lengths
(``KernelSpy``), so that the parent can work out the least time the
launches need.
"""
from __future__ import annotations

import importlib.util
import os
import sys
import time
import traceback

FORBIDDEN = ("jax", "jaxlib", "flax", "falcon_unzip_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the benchmark may not
    load (the port's name begins with the JAX package's: names compare
    whole)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_file(path: str, name: str):
    """Import a module of the benchmark's folder from its file."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class KernelSpy:
    """Wraps the port's wavefront and Arrow launch functions: keeps each
    launch's pair lengths (device tensors, read after the window) and turns
    on the kernels' own CUDA-event timing."""

    def __init__(self):
        from falcon_unzip_tpu_torch.ops import _kernels
        self.k = _kernels
        self.orig = (_kernels.banded_wavefront, _kernels.arrow_sweeps)
        self.wavefront, self.arrow = [], []

        def wavefront(qg, trg, n, m, **kw):
            self.wavefront.append((n, m, kw["W"], kw["Dmax"], kw["want_bp"]))
            return self.orig[0](qg, trg, n, m, **kw)

        def arrow(q, t, n, m, *args, **kw):
            self.arrow.append((n, m, q.shape[1], kw["C"]))
            return self.orig[1](q, t, n, m, *args, **kw)

        for kern in (_kernels.WAVEFRONT, _kernels.ARROW):
            kern.timed = True
        _kernels.reset_counts()
        _kernels.banded_wavefront, _kernels.arrow_sweeps = wavefront, arrow

    def close(self) -> dict:
        """Restore the launch functions; {kernel: {launches, device_s,
        least_s, cells}} of the launches since the spy was set."""
        from . import work
        k = self.k
        k.banded_wavefront, k.arrow_sweeps = self.orig
        out = {}
        for kern, caps, fn in (
                (k.WAVEFRONT, self.wavefront,
                 lambda n, m, W, Dmax, bp: work.wavefront(
                     n, m, Dmax=Dmax, W=W, want_bp=bp)),
                (k.ARROW, self.arrow,
                 lambda n, m, Lq, C: work.arrow(n, m, Lq=Lq, C=C))):
            kern.timed = False
            least = cells = 0
            for n, m, *rest in caps:
                w = fn(n.cpu().numpy(), m.cpu().numpy(), *rest)
                least += w["least_s"]
                cells += w["cells"]
            out[kern.name] = {"launches": kern.launches,
                              "device_s": kern.elapsed_ms() / 1e3
                              if kern.launches else 0.0,
                              "least_s": least, "cells": cells}
        return out


def worker(conn, counter, spec: dict) -> None:
    """Process target: set up, warm up, run the window, report."""
    try:
        _run(conn, counter, spec)
    except BaseException:                      # report, then exit non-zero
        conn.send(("error", traceback.format_exc()))
        raise
    finally:
        conn.close()


def _run(conn, counter, spec: dict) -> None:
    slot = spec["slot"]
    if spec["cores"]:
        os.sched_setaffinity(0, spec["cores"])
    import torch
    torch.set_num_threads(max(1, len(spec["cores"]) or os.cpu_count()))
    device = torch.device(spec["device"])
    if device.type == "cuda":
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    print(f"[slot {slot}] pid {os.getpid()} cores {spec['cores']} threads "
          f"{torch.get_num_threads()} device {device}", file=sys.stderr,
          flush=True)
    driver = load_file(spec["driver_file"], f"fu_bench_driver_{slot}")
    shared = conn.recv()
    t = time.time()
    ctx = {**spec, "device": device, "shared": shared, "counter": counter}
    state = driver.setup(ctx)
    if device.type == "cuda":
        torch.cuda.synchronize()
    tracer = spy = None
    if spec["traced"]:                 # started before the window opens
        from .trace import Tracer
        spy = KernelSpy() if device.type == "cuda" else None
        tracer = Tracer(torch, device)
        tracer.start()
    conn.send(("ready", {"setup_s": time.time() - t}))
    _, t0, t1 = conn.recv()
    time.sleep(max(0.0, t0 - time.time()))
    if tracer:
        tracer.mark()
    owed = getattr(driver, "owed", lambda state: False)
    records = []
    k = 0
    while k == 0 or time.time() < t1 or owed(state):
        start = time.time()
        try:
            info = driver.job(state, k)
        except Exception:
            print(f"[slot {slot}] job {k} failed:\n{traceback.format_exc()}",
                  file=sys.stderr, flush=True)
            records.append({"k": k, "start": start, "end": time.time(),
                            "failed": True})
            break
        records.append({"k": k, "start": start, "end": time.time(),
                        "failed": False, **info})
        k += 1
    result = {"slot": slot, "records": records, "cores": spec["cores"]}
    if tracer:
        path = os.path.join(spec["dir"], f"trace.slot{slot}.json")
        result["trace"] = {"path": tracer.stop(path), "wall": tracer.wall}
    if spy:
        result["kernels"] = spy.close()
    result["outputs"] = driver.finish(state)
    result["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                   if device.type == "cuda" else 0)
    result["kind"] = (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu")
    result["forbidden"] = forbidden_modules()
    conn.send(("done", result))

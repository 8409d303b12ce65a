"""What the per-layer metrics' readers (``metrics/<name>.py``) share.

Each reader is ``read(ctx) -> number or None``; ``ctx`` holds the cell's
spec, each slot's job records (with the stage rows of each job's
``metrics.jsonl``), the window's start and its traced end, the merged
device trace (``trace.merge``) and each kernel's launches, device seconds
(its CUDA events) and least seconds (``work.py``).  A reader that finds
nothing to read returns None, and the metric is left out of the line.
"""
from __future__ import annotations


def stage_s_per_mb(ctx: dict, part: str, stage: str):
    """Seconds of ``stage`` rows logged by ``part`` ("unzip" or "quiver")
    per Mb of draft, over every job that logged one."""
    secs = bp = 0
    for res in ctx["results"]:
        for rec in res["records"]:
            rows = [r for r in rec.get("stages", {}).get(part, [])
                    if r.get("stage") == stage and "s" in r]
            if not rec["failed"] and rows:
                secs += sum(r["s"] for r in rows)
                bp += rec["bp"]
    return secs / (bp / 1e6) if bp else None


def idle_pct(ctx: dict):
    """100 minus the device's busy share of the traced window, % (the
    union of every slot's kernel, memcpy and memset intervals)."""
    tr = ctx["trace"]
    if ctx["device"] != "cuda" or tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def roofline_pct(ctx: dict, kernel: str):
    """The least time of the kernel's launches in the window over their
    device time, %."""
    k = (ctx["kernels"] or {}).get(kernel)
    if not k or not k["launches"] or k["device_s"] <= 0:
        return None
    return 100.0 * k["least_s"] / k["device_s"]


def rate(ctx: dict):
    """The cell's rate: all the work of the jobs started in the window over
    the slot-seconds from the window's start to each slot's last job end,
    times the slots."""
    t0, res = ctx["t0"], ctx["results"]
    secs = sum(max((r["end"] for r in x["records"]), default=t0) - t0
               for x in res)
    work = sum(r["bp"] for x in res for r in x["records"] if not r["failed"])
    return len(res) * work / secs if secs > 0 else None

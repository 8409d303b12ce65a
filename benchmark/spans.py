"""What the readers of the port's host spans share.

A traced run's spans (``falcon_unzip_tpu_torch.utils.profiling``) reach
the readers two ways.  The assembly's jobs carry them in their ``unzip``
and ``quiver`` stage rows (each job's ``metrics.jsonl``).  FalconSense
has no output of its own: the port adds each request's spans to the
slot's torch.profiler trace, as metadata keys ``fu_spans.<id>``, and the
readers take them from the trace file (the part ``TRACE``).  Each row has
``stage`` (the span's name), ``s`` (its seconds) and, for a root span
(``run_unzip``, ``run_quiver``, ``falconsense``), ``proc_cpu_s``: the
process's CPU seconds over it; a ``falconsense`` root also ``bp``, its
seed read's length.  A port without the recorder, or an untraced run,
leaves no such rows, and every reader here returns None.
"""
from __future__ import annotations

import json

TRACE = "trace"
TRACE_KEY = "fu_spans."


def trace_rows(res: dict) -> list:
    """The span rows the port added to the slot's trace (none where the
    slot traced nothing)."""
    path = (res.get("trace") or {}).get("path")
    if not path:
        return []
    with open(path) as fh:
        meta = json.load(fh)
    return [r for k, v in meta.items()
            if k.startswith(TRACE_KEY) and isinstance(v, list) for r in v]


def slot_rows(res: dict, part: str, name: str) -> list:
    """The slot's rows of span ``name``: those of its jobs that did not
    fail logged by ``part``, or with ``part`` ``TRACE`` its trace's."""
    if part == TRACE:
        rows = trace_rows(res)
    else:
        rows = [r for rec in res["records"] if not rec["failed"]
                for r in rec.get("stages", {}).get(part, [])]
    return [r for r in rows if r.get("stage") == name and "s" in r]


def total_s(ctx: dict, part: str, name: str):
    """Seconds of span ``name`` over every slot, or None where none
    logged it."""
    got = [r["s"] for res in ctx["results"]
           for r in slot_rows(res, part, name)]
    return sum(got) if got else None


def ratio_pct(ctx: dict, part: str, num: str, den: str):
    """100 x the seconds of span ``num`` over those of span ``den``."""
    a, b = total_s(ctx, part, num), total_s(ctx, part, den)
    return 100.0 * a / b if a is not None and b else None


def trace_s_per_mb(ctx: dict, name: str, root: str):
    """Seconds of the traces' span ``name`` per Mb of the ``bp`` of their
    ``root`` spans, over the slots that traced one."""
    secs = bp = 0
    for res in ctx["results"]:
        got = slot_rows(res, TRACE, name)
        if got:
            secs += sum(r["s"] for r in got)
            bp += sum(r.get("bp", 0) for r in slot_rows(res, TRACE, root))
    return secs / (bp / 1e6) if bp else None


def host_cpu_pct(ctx: dict, roots: list):
    """The process's CPU seconds over the root spans ``roots`` ([(part,
    name)]) over their seconds times the slot's cores, %."""
    cpu = wall = 0.0
    for res in ctx["results"]:
        cores = len(res.get("cores") or [])
        for part, name in roots if cores else []:
            for r in slot_rows(res, part, name):
                if "proc_cpu_s" in r:
                    cpu += r["proc_cpu_s"]
                    wall += r["s"] * cores
    return 100.0 * cpu / wall if wall > 0 else None

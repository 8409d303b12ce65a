"""What the readers of the four-host cell share: the port's collectives
and each card alone.

Each rank's job record carries that rank's stage rows (its own
``metrics.jsonl``).  In a traced run they hold the port's spans, among
them a ``dist.<helper>`` row for each collective helper a rank ran.
Helpers nest (``dist.exchange_to_owners`` runs ``dist.allgather_bytes``
once a destination, which runs ``dist.all_gather_rows`` twice), so the
seconds count only the rows with no ``dist.*`` ancestor, found through
the rows' ``parent`` ids; the bytes are the leaves' own, since only the
leaf helpers carry ``bytes_in`` (what the rank received, padding
included).  A port without
these spans, or an untraced run, leaves no such rows, and every reader
returns None.
"""
from __future__ import annotations

DIST = "dist."
ROOTS = ("run_unzip", "run_quiver")


def outermost(rows: list) -> list:
    """The ``dist.*`` rows of one process's rows that have no ``dist.*``
    ancestor."""
    by_id = {r["id"]: r for r in rows if "id" in r}

    def under_dist(r) -> bool:
        seen = set()
        p = r.get("parent")
        while p is not None and p in by_id and p not in seen:
            seen.add(p)
            if by_id[p]["stage"].startswith(DIST):
                return True
            p = by_id[p].get("parent")
        return False
    return [r for r in rows if r.get("stage", "").startswith(DIST)
            and not under_dist(r)]


def totals(ctx: dict):
    """Over every rank's jobs that did not fail and logged a collective:
    {"s": seconds in the outermost ``dist.*`` spans, "bytes_in": the
    bytes their leaves received, "root_s": seconds of the ranks' ``run_unzip`` and
    ``run_quiver`` spans, "mb": Mb of genome (the ranks' records' shares
    summed)}, or None where no rank logged a collective."""
    out = {"s": 0.0, "bytes_in": 0, "root_s": 0.0, "mb": 0.0}
    for res in ctx["results"]:
        for rec in res["records"]:
            if rec["failed"]:
                continue
            rows = [r for part in rec.get("stages", {}).values()
                    for r in part]
            top = outermost(rows)
            if not top:
                continue
            out["s"] += sum(r["s"] for r in top)
            out["bytes_in"] += sum(r.get("bytes_in", 0) for r in rows
                                   if r.get("stage", "").startswith(DIST))
            out["root_s"] += sum(r["s"] for r in rows
                                 if r.get("stage") in ROOTS)
            out["mb"] += rec["bp"] / 1e6
    return out if out["mb"] > 0 else None


def idle_pct_each(ctx: dict):
    """The mean over the slots of each one's card idle share of the traced
    window, %: each slot's trace merged alone (the result line's own
    merge takes the union over the slots, which counts a card busy
    whenever any card is)."""
    from benchmark import trace
    if ctx["device"] != "cuda" or ctx["trace"] is None:
        return None
    shares = []
    for res in ctx["results"]:
        tr = res.get("trace") or {}
        if not tr.get("path"):
            return None
        m = trace.merge([trace.read(tr["path"], tr["wall"])], ctx["t0"],
                        ctx["t_last"])
        if m["window_s"] <= 0:
            return None
        shares.append(100.0 * (1.0 - m["busy_s"] / m["window_s"]))
    return sum(shares) / len(shares) if shares else None

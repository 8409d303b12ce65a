"""Slot driver of the consensus cells: falcon_sense read correction.

The parent simulates one genome's raw reads from the run's seed
(``sim.genome_reads``).  Every read is a seed read: a request is the seed
read as the template and every other read whose truth span overlaps the
seed's by ``min_overlap`` bases or more, as falcon_sense corrects a seed
read from the reads that overlap it.  The requests go out in a seeded
order from one counter that the slots share: a slot takes the next request
whenever it is free, and the order starts again when it runs out.  A job
is one request, ``FalconSense.__call__(seed, reads)``, and counts the
seed's bases.

Warm-up runs one request of the cell's own in each slot.  The first
``scored`` requests handed out are judged after the window (``check``):
each consensus against the truth that its seed read came from, on the
seed's strand.  The slots take them all even if the window closes first
(``owed``).
"""
from __future__ import annotations

import os
import sys

import numpy as np

RATE = "cns_bp_per_s"


def members(start: np.ndarray, end: np.ndarray, min_overlap: int) -> list:
    """For each read, the other reads whose spans overlap its span by
    min_overlap bases or more."""
    order = np.argsort(start, kind="stable")
    s_sorted = start[order]
    longest = int((end - start).max())
    out = []
    for i in range(len(start)):
        lo = np.searchsorted(s_sorted, start[i] - longest, "left")
        hi = np.searchsorted(s_sorted, end[i] - min_overlap, "right")
        cand = order[lo:hi]
        ov = np.minimum(end[cand], end[i]) - np.maximum(start[cand], start[i])
        out.append(np.sort(cand[(ov >= min_overlap) & (cand != i)]))
    return out


def prepare(spec: dict, seed: int, run_dir: str) -> tuple:
    """Simulate the reads and form the requests.  Returns (what the slots
    get: the path of ``run_dir/requests.npz``, what the check keeps: the
    truth, each read's span and strand, and the order)."""
    from benchmark import sim
    cfg, traffic = spec["config"], spec["traffic"]
    data = sim.genome_reads(cfg["length"], cfg["coverage"], cfg["read_len"],
                            cfg["read_error"], seed)
    reads = data["reads"]
    mem = members(data["start"], data["end"], traffic["min_overlap"])
    r_off = np.cumsum([0] + [len(r) for r in reads])
    m_off = np.cumsum([0] + [len(m) for m in mem])
    order = np.random.default_rng(sim.seed_of(seed, 7)).permutation(
        len(reads))
    path = os.path.join(run_dir, "requests.npz")
    np.savez(path, reads=np.concatenate(reads), r_off=r_off,
             members=np.concatenate(mem), m_off=m_off, order=order)
    return {"path": path}, {"truth": data["truth"], "start": data["start"],
                            "end": data["end"], "strand": data["strand"],
                            "order": order}


def _request(state: dict, idx: int) -> tuple:
    z = state["z"]
    p = int(z["order"][idx % len(z["order"])])
    r_off, flat = z["r_off"], z["reads"]
    ids = z["members"][z["m_off"][p] : z["m_off"][p + 1]]
    reads = [flat[r_off[i] : r_off[i + 1]] for i in ids]
    return flat[r_off[p] : r_off[p + 1]], reads


def setup(ctx: dict) -> dict:
    import torch  # noqa: F401
    from falcon_unzip_tpu_torch.models.consensus import (ConsensusConfig,
                                                         FalconSense)
    cfg = ctx["config"]
    z = np.load(ctx["shared"]["path"])
    state = {"ctx": ctx, "z": {k: z[k] for k in z.files}, "scored": {},
             "control": ctx["control"]}
    state["fs"] = FalconSense(ConsensusConfig(**cfg.get("consensus", {})),
                              ctx["device"])
    n = len(state["z"]["order"])
    tpl, reads = _request(state, n - 1 - ctx["slot"] % n)
    state["fs"](tpl, reads)                       # warm-up
    return state


def job(state: dict, k: int) -> dict:
    import torch
    ctx = state["ctx"]
    with ctx["counter"].get_lock():
        idx = ctx["counter"].value
        ctx["counter"].value += 1
    tpl, reads = _request(state, idx)
    if state["control"]:
        cns = tpl.copy()                # the template returned unchanged
    else:
        cns = state["fs"](tpl, reads)
    if ctx["device"].type == "cuda":
        torch.cuda.synchronize()
    if idx < ctx["traffic"]["scored"]:
        state["scored"][idx] = np.asarray(cns, np.int8)
    return {"bp": int(len(tpl)), "request": int(idx)}


def owed(state: dict) -> bool:
    """Whether requests the check judges are still to be handed out."""
    return state["ctx"]["counter"].value < state["ctx"]["traffic"]["scored"]


def finish(state: dict) -> dict:
    path = os.path.join(state["ctx"]["dir"], "scored.npz")
    np.savez(path, **{str(i): c for i, c in state["scored"].items()})
    return {"scored": path}


def check(spec: dict, results: list, shared: dict) -> tuple:
    from benchmark import reference as ref
    from benchmark.sim import revcomp
    n = spec["traffic"]["scored"]
    got: dict = {}
    for res in results:
        z = np.load(res["outputs"]["scored"])
        got.update({int(k): z[k] for k in z.files})
    order, truth = shared["order"], shared["truth"]
    answers, truths = [], []
    for idx in range(n):
        p = int(order[idx % len(order)])
        t = truth[shared["start"][p] : shared["end"][p]]
        answers.append(got.get(idx))
        truths.append(revcomp(t) if shared["strand"][p] else t)
    sc = ref.score_pieces(answers, truths)
    print(f"[check] {n} requests, {sc['bases']} truth bp, {sc['errors']} "
          f"edit distance, {sc['missing']} unanswered", file=sys.stderr,
          flush=True)
    err_pct = 100.0 * sc["errors"] / max(sc["bases"], 1)
    limit = spec["config"]["limits"]["cns_err_pct"]
    return ({"cns_qv": ref.phred(sc["errors"], sc["bases"])},
            {"cns_err_pct": (err_pct, limit)})

"""Seeded inputs, output snapshots and an independent identity score,
shared by ``chip_smoke.py`` and the port's tests.

``mutate`` is ``utils.simulate.mutate_read``'s error model in numpy (the
per-base loop takes minutes at genome scale); ``template_reads`` builds
FalconSense's inputs (BASELINE config 1) from a seed; ``dir_bytes`` and
``run_artifacts`` snapshot what a command or a run wrote, for
byte-for-byte comparisons; ``edit_identity`` scores a consensus against
its truth with a plain PyTorch edit distance that uses neither the port's
kernels nor its aligner.
"""
from __future__ import annotations

import glob
import json
import os

import numpy as np
import torch

from ..seq import revcomp
from .simulate import random_genome


def mutate(rng, seq: np.ndarray, rate: float) -> np.ndarray:
    """Each base mismatched, followed by a random inserted base, or
    deleted, each with probability rate / 3 (int8 codes)."""
    r = rng.random(len(seq))
    sub = r < rate / 3
    ins = (r >= rate / 3) & (r < 2 * rate / 3)
    dele = (r >= 2 * rate / 3) & (r < rate)
    out = seq.astype(np.int8)
    out[sub] = (out[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
    reps = 1 - dele.astype(np.int64) + ins
    res = np.repeat(out, reps)
    # an insertion's random base takes the second of its base's two slots
    res[np.cumsum(reps)[ins] - 1] = rng.integers(0, 4, int(ins.sum()))
    return res


def template_reads(length: int, n_reads: int, seed: int, rc: bool = True):
    """A random contig (the truth), the template (the truth at 2%) and
    n_reads reads of 10 kb mean (0.7-1.3x, as simulate_reads draws
    lengths, cut to length) at 8% error, every second one
    reverse-complemented when rc.  Returns (truth, template, reads, the
    reads' truth spans)."""
    rng = np.random.default_rng(seed)
    truth = random_genome(length, seed)
    template = mutate(rng, truth, 0.02)
    reads, spans = [], []
    for k in range(n_reads):
        L = int(min(10_000 * (0.7 + 0.6 * rng.random()), length))
        s = int(rng.integers(0, length - L + 1))
        r = mutate(rng, truth[s : s + L], 0.08)
        reads.append(revcomp(r) if rc and k % 2 else r)
        spans.append((s, s + L))
    return truth, template, reads, spans


def dir_bytes(root: str) -> dict:
    """{relative path: bytes} of every file under root."""
    got = {}
    for base, _, names in os.walk(root):
        for nm in names:
            with open(os.path.join(base, nm), "rb") as fh:
                got[os.path.relpath(os.path.join(base, nm), root)] = fh.read()
    return got


def run_artifacts(out_dir: str,
                  patterns=("3-unzip/**/*", "4-polish/cns_*")) -> dict:
    """{path relative to out_dir: comparable bytes} of a run's files
    matching patterns; each stage marker without its wall time and input
    fingerprint (they differ between runs by design)."""
    got = {}
    for path in sorted(p for pat in patterns
                       for p in glob.glob(f"{out_dir}/{pat}", recursive=True)):
        if os.path.isdir(path):
            continue
        with open(path, "rb") as fh:
            data = fh.read()
        if path.endswith("stage.done.json"):
            meta = json.loads(data)
            meta.pop("wall_s")
            meta.pop("fingerprint")
            data = json.dumps(meta, sort_keys=True).encode()
        got[os.path.relpath(path, out_dir)] = data
    return got


def edit_identity(cns: np.ndarray, truth: np.ndarray, device,
                  piece: int = 10_000, margin: int = 256,
                  k: int = 24) -> dict:
    """Identity of a consensus to its truth.  Each piece of the consensus
    (piece bases; a tail shorter than half a piece joins the last) is
    placed on the truth by the first of its disjoint k-mers that occurs
    exactly once there, and scored against the truth from margin bases
    before that place to margin after its end by unit-cost edit distance
    with free truth ends: the DP's rows in plain torch ops, all pieces at
    once on ``device``.

    Returns {"identity": 1 - summed distance / summed placed length,
    "placed": the consensus bases placed, "pieces", "unplaced": counts,
    "dist": each placed piece's distance}."""
    cns = np.asarray(cns, np.int8)
    tb = np.asarray(truth, np.int8).tobytes()
    cuts = list(range(0, len(cns), piece))
    if len(cuts) > 1 and len(cns) - cuts[-1] < piece // 2:
        cuts.pop()                         # a short tail joins the last piece
    qs, ws = [], []
    for i, e in zip(cuts, cuts[1:] + [len(cns)]):
        p = cns[i:e]
        for off in range(0, max(len(p) - k, 0) + 1, k):
            at = tb.find(p[off : off + k].tobytes())
            if at >= 0 and tb.find(p[off : off + k].tobytes(), at + 1) < 0:
                pos = at - off
                qs.append(p)
                ws.append(np.frombuffer(tb[max(pos - margin, 0) :
                                           pos + len(p) + margin], np.int8))
                break
    n_pieces = len(cuts)
    if not qs:
        return {"identity": 0.0, "placed": 0, "pieces": n_pieces,
                "unplaced": n_pieces, "dist": []}
    B, Lq, Lt = len(qs), max(map(len, qs)), max(map(len, ws))
    Q = np.full((B, Lq), -2, np.int8)
    T = np.full((B, Lt), -1, np.int8)      # padding matches nothing
    for b in range(B):
        Q[b, : len(qs[b])] = qs[b]
        T[b, : len(ws[b])] = ws[b]
    Q = torch.from_numpy(Q).to(device)
    T = torch.from_numpy(T).to(device)
    lens = torch.tensor([len(q) for q in qs], device=device)
    ar = torch.arange(Lt + 1, device=device, dtype=torch.int32)
    D = torch.zeros((B, Lt + 1), dtype=torch.int32, device=device)
    best = torch.zeros(B, dtype=torch.int32, device=device)
    for i in range(1, Lq + 1):
        step = torch.minimum(D[:, :-1] + (T != Q[:, i - 1 : i]),
                             D[:, 1:] + 1)
        t = torch.cat([torch.full((B, 1), i, dtype=torch.int32,
                                  device=device), step], 1)
        # an insertion run within the row: D[j] = min_{k <= j} t[k] + j - k
        D = torch.cummin(t - ar, 1).values + ar
        best = torch.where(lens == i, D.min(1).values, best)
    dist = best.cpu().numpy()
    placed = int(sum(len(q) for q in qs))
    return {"identity": 1.0 - int(dist.sum()) / placed, "placed": placed,
            "pieces": n_pieces, "unplaced": n_pieces - B,
            "dist": dist.tolist()}

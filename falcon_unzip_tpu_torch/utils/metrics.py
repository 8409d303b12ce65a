"""Structured per-stage metrics (JSONL) + assembly stats.

Role parity: the reference has only task logs; SURVEY.md §5 mandates the
rebuild emit structured per-stage metrics (reads/s, bases/s/chip, phase
block N50, ...) feeding the BASELINE metrics directly.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np


class MetricsLog:
    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def log(self, stage: str, **kv) -> None:
        rec = {"ts": round(time.time(), 3), "stage": stage, **kv}
        with open(self.path, "a") as fh:
            fh.write(json.dumps(rec) + "\n")


def n50(lengths) -> int:
    ls = sorted((int(x) for x in lengths), reverse=True)
    if not ls:
        return 0
    half = sum(ls) / 2
    acc = 0
    for l in ls:
        acc += l
        if acc >= half:
            return l
    return ls[-1]


def assembly_stats(seqs) -> dict:
    lens = [len(s) for s in seqs]
    return {
        "n_seqs": len(lens),
        "total_bp": int(sum(lens)),
        "n50": n50(lens),
        "max_len": int(max(lens)) if lens else 0,
    }


def phase_block_stats(block_id: np.ndarray, het_pos: np.ndarray) -> dict:
    """Span-based stats of phase blocks over het site positions."""
    spans = []
    for b in np.unique(block_id[block_id >= 0]):
        pos = het_pos[block_id == b]
        if len(pos) >= 2:
            spans.append(int(pos.max() - pos.min()))
    return {
        "n_blocks": int(len(spans)),
        "block_n50": n50(spans),
        "n_phased_sites": int((block_id >= 0).sum()),
    }

"""Ablation timing of the pair-HMM step on one NVIDIA GPU.

    python -m falcon_unzip_tpu_torch.scripts.ablate_pairhmm

The twin of the reference's ``scripts/ablate_pallas.py``: the
antidiagonal step of the pair-HMM forward cut to its parts (band shift,
windowed base load, logaddexp; ``ops/pairhmm_ablate.py``) and timed one
feature set at a time through the kernel of ``csrc/pairhmm_ablate.cu``,
at the same constants (P=256 rows, W=128, Dmax=1025, LQG=1024, seeded
int32 bases 0..4).  Each set is timed twice: from the reference's start
(every state plane NEG, so every exp and log1p sees the same argument)
and from a seeded finite start (``seeded_init``: the values vary as in a
real forward).  Each time is taken with CUDA events over REPS launches
after one warm-up launch, and printed in ms and microseconds per
antidiagonal step beside the card's name and power limit.  Needs a GPU:
without one it raises.
"""
from __future__ import annotations

import numpy as np
import torch

from ..bench import card_label
from ..device import resolve
from ..ops.pairhmm_ablate import (FEATURE_SETS, neg_init, pairhmm_ablate,
                                  seeded_init)

P, W, Dmax, LQG = 256, 128, 1025, 1024
REPS = 20


def rows(seed: int = 0) -> np.ndarray:
    """The (P, LQG) int32 bases of the reference script (values 0..4)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 5, size=(P, LQG)).astype(np.int32)


def _time_ms(qg, init, feats) -> float:
    pairhmm_ablate(qg, init, feats, Dmax=Dmax)             # warm-up
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(REPS):
        pairhmm_ablate(qg, init, feats, Dmax=Dmax)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / REPS


def measure() -> list:
    """[{feats, ms, us_per_step, ms_seeded, us_per_step_seeded}] for the
    five feature sets on the card: ms from the NEG start, ms_seeded from
    the seeded one."""
    dev = resolve("cuda")
    qg = torch.from_numpy(rows()).to(dev)
    starts = {"": torch.from_numpy(neg_init(P, W)).to(dev),
              "_seeded": torch.from_numpy(seeded_init(P, W, 0)).to(dev)}
    out = []
    for feats in FEATURE_SETS:
        r = {"feats": list(feats)}
        for tag, init in starts.items():
            ms = _time_ms(qg, init, feats)
            r["ms" + tag] = ms
            r["us_per_step" + tag] = 1e3 * ms / Dmax
        out.append(r)
    return out


def main() -> list:
    res = measure()
    card = card_label()
    for r in res:
        print(f"{tuple(r['feats'])}: {r['ms']:.4f} ms "
              f"({r['us_per_step']:.4f} us/step for {P} rows) from NEG, "
              f"{r['ms_seeded']:.4f} ms ({r['us_per_step_seeded']:.4f} "
              f"us/step) from the seeded start | {card}", flush=True)
    return res


if __name__ == "__main__":
    main()

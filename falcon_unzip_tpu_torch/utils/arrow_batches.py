"""Seeded batches of the Arrow splice sweeps and the bar they are held to.

The card kernel's checks (its GPU tests, ``chip_smoke.py`` phase 3 and
``scripts/tune_arrow.py``) and the CPU tests of its yardstick build their
inputs here: ``pack`` turns specs ``[(n, m, [cand, ...]), ...]`` into the
sweeps' numpy arguments, ``edge_specs`` and ``polish_specs`` give the specs
of the edge shapes and of the polish's shape, ``to_device`` makes them
tensors of one mode, and ``max_rel_err`` measures a result against the
plain version.
"""
from __future__ import annotations

import numpy as np
import torch

from falcon_unzip_tpu_torch.models.polisher import tier_table
from falcon_unzip_tpu_torch.ops.pairhmm import params_vector
from falcon_unzip_tpu_torch.oracle.hmm import HMMParams
from falcon_unzip_tpu_torch.utils.simulate import mutate_read, random_genome

# n and m at the kernel's warp edges (32 rows) and at the stripe edges of
# its 2-warp (64 rows) and 8-warp (256 rows) builds
EDGES = (31, 32, 33, 63, 64, 65, 127, 128, 129, 255, 256, 257)
EDGE_KINDS = ("padding", "stripe_edges", "n_gt_m", "n_lt_m", "m_small",
              "m_full")


def _pair(rng, n: int, m: int, err: float, seed: int) -> tuple:
    """A template of m bases and a read of exactly n bases drawn from it
    (mutated at err, then cut or extended with random bases)."""
    t = random_genome(m, seed) if m else np.zeros(0, np.int8)
    q = mutate_read(t, err, rng)[:n] if m else np.zeros(0, np.int8)
    if len(q) < n:
        q = np.concatenate([q, rng.integers(0, 4, n - len(q)).astype(np.int8)])
    return q.astype(np.int8), t.astype(np.int8)


def pack(rng, specs, *, Lq: int, LJ: int, C: int, P: int | None = None):
    """PAD-filled batch of P >= len(specs) pairs (the rest padding, n = m
    = 0) from specs [(n, m, [cand, ...]), ...].  Returns numpy (q, t, n, m,
    cand, pvec, qt, tiers): per-pair params at the global defaults, one
    pair at other params, and a seeded per-base tier track over the
    polisher's tier table."""
    P = len(specs) if P is None else P
    q = np.full((P, Lq), 4, np.int8)
    t = np.full((P, LJ), 4, np.int8)
    n = np.zeros(P, np.int32)
    m = np.zeros(P, np.int32)
    cand = np.full((P, C), -1, np.int32)
    for k, (nk, mk, cc) in enumerate(specs):
        qk, tk = _pair(rng, nk, mk, (0.0, 0.05, 0.15)[k % 3],
                       int(rng.integers(1 << 30)))
        q[k, :nk] = qk
        t[k, :mk] = tk
        n[k], m[k] = nk, mk
        cand[k, : len(cc)] = cc[:C]
    pvec = np.tile(params_vector(), (P, 1)).astype(np.float32)
    pvec[P // 2] = params_vector(HMMParams(e_sub=0.1, p_del=0.1))
    tiers = tier_table().astype(np.float32)
    qt = rng.integers(0, len(tiers), size=(P, Lq + 1)).astype(np.int8)
    return q, t, n, m, cand, pvec, qt, tiers


def edge_specs(kind: str, *, LJ: int, edges=EDGES) -> list:
    """(n, m, candidates) of the edge shapes of one kind: padding pairs,
    n and m at the given edges (those that fit LJ), n > m and n < m, m
    much smaller than LJ, and m = LJ - 1 with the candidates whose slots
    s = 1, 2 clip."""
    top = LJ - 1
    if kind == "padding":
        return [(0, 0, [0, -1]), (0, 9, [0, 8]), (9, 0, [0, 3]),
                (0, 0, []), (12, 15, [14, 0, 7])]
    if kind == "stripe_edges":
        return [(e, e2, [e2 - 1, 0, e2 // 2, -1])
                for e in edges for e2 in (e - 1, e, e + 1)
                if 0 < e2 <= top and e <= LJ]
    if kind == "n_gt_m":
        return [(min(LJ, 2 * x + 5), x, [x - 1, 1, x // 2])
                for x in (7, LJ // 4, LJ // 2 - 3)]
    if kind == "n_lt_m":
        return [(x, min(top, 2 * x + 5), [0, x, 2 * x + 4])
                for x in (7, LJ // 4, LJ // 2 - 3)]
    if kind == "m_small":
        return [(x, 5, [4, 0, 2]) for x in (4, 9, LJ // 3)]
    if kind == "m_full":
        return [(top - 2, top, [top - 1, top - 2, 0, 3]),
                (top, top, [top - 2, top - 1]),
                (LJ, top, [top - 1, -1, top - 2])]
    raise ValueError(f"unknown edge kind {kind!r}")


def polish_specs(rng, P: int, *, LJ: int, C: int) -> list:
    """P pairs of the polish's shape: lengths 300-420, one candidate the
    terminal deletion (m - 1), slots 1..C used in turn."""
    specs = []
    for k in range(P):
        mk = int(rng.integers(300, 421))
        nk = int(np.clip(mk + rng.integers(-20, 21), 1, LJ))
        cols = rng.choice(mk, size=C, replace=False)
        cols[0] = mk - 1
        specs.append((nk, mk, [int(c) for c in cols[: 1 + k % C]]))
    return specs


def wide_specs(rng, *, LJ: int, C: int) -> list:
    """Pairs with up to C candidates each, for C past the 8 whose 3C
    backward slots fit the kernel's first column word: m from 20 to LJ - 1
    (the last pair's slots s = 1, 2 clip), candidates distinct, some slots
    unused."""
    top = LJ - 1
    specs = []
    for k, mk in enumerate((20, LJ // 3, LJ // 2, top - 3, top)):
        nk = int(np.clip(mk + rng.integers(-9, 10), 1, LJ))
        cols = [int(c) for c in rng.choice(mk, size=min(C, mk),
                                           replace=False)]
        cols[0] = mk - 1
        specs.append((nk, mk, cols[: C - k % 3]))
    return specs


def to_device(arrays, mode: str, dev) -> list:
    """The numpy batch as the sweeps' arguments on dev: per-pair mode
    drops qt and tiers."""
    q, t, n, m, cand, pvec, qt, tiers = arrays
    dt = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    args = [dt(x) for x in (q, t, n, m, cand, pvec)]
    return args + ([dt(qt), dt(tiers)] if mode == "per-base"
                   else [None, None])


def max_rel_err(got, want) -> float:
    """Largest |got - want| / max(1, |want|) over the non-NEG slots, and
    inf if the NEG slots differ."""
    got, want = got.double().cpu(), want.double().cpu()
    if not torch.equal(got < -1e29, want < -1e29):
        return float("inf")
    ok = want > -1e29
    if not bool(ok.any()):
        return 0.0
    err = (got - want).abs()[ok] / want.abs()[ok].clamp(min=1.0)
    return float(err.max())

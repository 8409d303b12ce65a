"""Numpy oracle for banded edit-distance alignment + alignment tags.

This module is the executable SPEC for the device kernels in
``falcon_unzip_tpu.ops.banded_align``:

- ``edit_dp_full``       : full O(nm) edit-distance DP (ground truth)
- ``banded_dp``          : the exact banded antidiagonal-wavefront recurrence
                           the TPU kernel implements (slope-1/2 band,
                           data-independent shift schedule)
- ``traceback_*``        : deterministic tie-broken traceback -> moves
- ``moves_to_tags``      : falcon_sense-style (t_pos, delta, base) align tags
- ``moves_to_cigar``     : CIGAR string for aligner output

Role parity: [U] falcon-kit DW_banded.c::align (O(nd) banded diff alignment)
and the alignment-tag generation inside [U] falcon-kit falcon.c::
get_align_tags / generate_consensus.  The banded DP here is a re-design:
fixed-width slope-1/2 band so the batched wavefront is shift+compare only.

Semantics:
  costs: match 0, mismatch 1, insertion(q base vs gap) 1, deletion 1.
  mode 'global':  align all of q to all of t; answer D[n, m].
  mode 'qglocal': align all of q, free tail of t; answer min_j D[n, j].
  mode 'tglocal': align all of q, free start AND tail of t (D[0, j] = 0);
                  answer min_j D[n, j]; traceback stops at row i == 0.
  traceback tie-break: diag > up(q-consuming) > left(t-consuming).
Moves encoding: 0 = diag, 1 = up (insertion in q), 2 = left (deletion).
"""
from __future__ import annotations

import numpy as np

from ..seq import PAD

INF = np.int32(1 << 20)
GAP = 4  # vote symbol for deletion (same code as PAD; never a real base)

MOVE_DIAG, MOVE_UP, MOVE_LEFT = 0, 1, 2


def edit_dp_full(q: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Full (n+1)x(m+1) edit-distance DP table."""
    n, m = len(q), len(t)
    D = np.zeros((n + 1, m + 1), dtype=np.int32)
    D[0, :] = np.arange(m + 1)
    D[:, 0] = np.arange(n + 1)
    for i in range(1, n + 1):
        sub = (q[i - 1] != t) | (q[i - 1] >= 4) | (t >= 4)
        for j in range(1, m + 1):
            D[i, j] = min(
                D[i - 1, j - 1] + sub[j - 1],
                D[i - 1, j] + 1,
                D[i, j - 1] + 1,
            )
    return D


def traceback_full(q, t, D, end: tuple[int, int] | None = None) -> np.ndarray:
    """Deterministic traceback of the full DP. Returns moves (left→right)."""
    n, m = len(q), len(t)
    i, j = end if end is not None else (n, m)
    moves = []
    while i > 0 or j > 0:
        if i > 0 and j > 0:
            sub = 0 if (q[i - 1] == t[j - 1] and q[i - 1] < 4) else 1
            if D[i, j] == D[i - 1, j - 1] + sub:
                moves.append(MOVE_DIAG); i -= 1; j -= 1; continue
        if i > 0 and D[i, j] == D[i - 1, j] + 1:
            moves.append(MOVE_UP); i -= 1; continue
        moves.append(MOVE_LEFT); j -= 1
    return np.array(moves[::-1], dtype=np.int8)


# ---------------------------------------------------------------------------
# Banded spec (mirrors the device wavefront exactly)
# ---------------------------------------------------------------------------

def band_lo(d: int, W: int) -> int:
    """Band start row for antidiagonal d: slope-1/2 center, clipped at 0.

    Cell (i, j=d-i) is computed iff i in [band_lo(d), band_lo(d)+W).
    Data-independent: all pairs in a batch share the schedule.
    """
    return max(0, (d + 1) // 2 - W // 2)


def banded_dp(q, t, W: int, mode: str = "global"):
    """Banded antidiagonal DP; returns (dist, (i_end, j_end), bp, lo_arr).

    bp: (Dmax, W) int8 backpointers, 3 = invalid/unset.
    Matches the full DP whenever the optimal path stays inside the band.
    """
    n, m = len(q), len(t)
    Dmax = n + m + 1
    V2 = np.full(W, INF, dtype=np.int32)  # antidiag d-2
    V1 = np.full(W, INF, dtype=np.int32)  # antidiag d-1
    bp = np.full((Dmax, W), 3, dtype=np.int8)
    lo_arr = np.array([band_lo(d, W) for d in range(Dmax + 1)], dtype=np.int32)

    best = INF
    best_ij = (-1, -1)
    final = INF
    w_idx = np.arange(W)

    for d in range(Dmax):
        lo = lo_arr[d]
        i = lo + w_idx          # rows of this antidiagonal
        j = d - i
        valid = (i >= 0) & (i <= n) & (j >= 0) & (j <= m)

        # neighbor values from V1/V2, shifted into this band frame
        s1 = lo - lo_arr[d - 1] if d >= 1 else 0
        s2 = lo - lo_arr[d - 2] if d >= 2 else 0

        def shifted(V, s):
            out = np.full(W, INF, dtype=np.int32)
            src = w_idx + s
            ok = (src >= 0) & (src < W)
            out[ok] = V[src[ok]]
            return out

        # cell (i-1, j) lives on d-1 at w' = (i-1) - lo[d-1] = w + s1 - 1
        up = shifted(V1, s1 - 1)
        left = shifted(V1, s1)      # (i, j-1) on d-1 at w' = w + s1
        diag = shifted(V2, s2 - 1)  # (i-1, j-1) on d-2 at w' = w + s2 - 1

        qi = np.where((i >= 1) & (i <= n), q[np.clip(i - 1, 0, n - 1)] if n else PAD, PAD)
        tj = np.where((j >= 1) & (j <= m), t[np.clip(j - 1, 0, m - 1)] if m else PAD, PAD)
        sub = np.where((qi == tj) & (qi < 4), 0, 1).astype(np.int32)

        cand_diag = np.where((i >= 1) & (j >= 1), diag + sub, INF)
        cand_up = np.where(i >= 1, up + 1, INF)
        cand_left = np.where(j >= 1, left + 1, INF)

        V = np.minimum(np.minimum(cand_diag, cand_up), cand_left)
        mv = np.where(cand_diag <= V, MOVE_DIAG,
                      np.where(cand_up <= V, MOVE_UP, MOVE_LEFT)).astype(np.int8)
        # seed origin (free-start modes seed the whole i == 0 row)
        if mode == "tglocal":
            origin = (i == 0)
        else:
            origin = (i == 0) & (j == 0)
        V = np.where(origin, 0, V)
        V = np.where(valid, V, INF).astype(np.int32)
        V = np.minimum(V, INF)
        bp[d] = np.where(valid & ~origin & (V < INF), mv, 3)

        # answers
        if mode in ("qglocal", "tglocal"):
            at_end = valid & (i == n) & (V < best)
            if at_end.any():
                w_best = int(np.argmin(np.where(at_end, V, INF)))
                if V[w_best] < best:
                    best = int(V[w_best]); best_ij = (n, int(d - (lo + w_best)))
        if d == n + m:
            hit = valid & (i == n)
            if hit.any():
                final = int(V[hit][0])

        V2, V1 = V1, V

    if mode == "global":
        return final, (n, m), bp, lo_arr
    return best, best_ij, bp, lo_arr


def traceback_banded(bp, lo_arr, end: tuple[int, int]):
    """Traceback through band backpointers from cell ``end`` to (0, 0)."""
    i, j = end
    moves = []
    while i > 0 or j > 0:
        d = i + j
        w = i - lo_arr[d]
        if not (0 <= w < bp.shape[1]):
            raise ValueError(f"traceback left the band at ({i},{j})")
        mv = int(bp[d, w])
        if mv == 3 and i == 0:
            break  # free-start origin row (tglocal)
        if mv == MOVE_DIAG:
            i -= 1; j -= 1
        elif mv == MOVE_UP:
            i -= 1
        elif mv == MOVE_LEFT:
            j -= 1
        else:
            raise ValueError(f"invalid backpointer at ({i},{j})")
        moves.append(mv)
    return np.array(moves[::-1], dtype=np.int8)


# ---------------------------------------------------------------------------
# Tags + CIGAR
# ---------------------------------------------------------------------------

def moves_to_tags(q, moves, t_offset: int = 0) -> np.ndarray:
    """Moves -> falcon_sense-style align tags (t_pos, delta, base).

    diag  : (j-1, 0, q[i-1])
    up    : (last t_pos, delta+=1, q[i-1])   [insertion after t_pos]
    left  : (j-1, 0, GAP)                    [deletion]
    """
    i = j = 0
    cur_tpos, delta = -1, 0
    tags = []
    for mv in moves:
        if mv == MOVE_DIAG:
            tags.append((t_offset + j, 0, int(q[i])))
            cur_tpos, delta = j, 0
            i += 1; j += 1
        elif mv == MOVE_UP:
            delta += 1
            tags.append((t_offset + cur_tpos, delta, int(q[i])))
            i += 1
        else:
            tags.append((t_offset + j, 0, GAP))
            cur_tpos, delta = j, 0
            j += 1
    return np.array(tags, dtype=np.int32).reshape(-1, 3)


_CIG = {MOVE_DIAG: "M", MOVE_UP: "I", MOVE_LEFT: "D"}


def moves_to_cigar(moves) -> str:
    out = []
    prev, run = None, 0
    for mv in moves:
        c = _CIG[int(mv)]
        if c == prev:
            run += 1
        else:
            if prev is not None:
                out.append(f"{run}{prev}")
            prev, run = c, 1
    if prev is not None:
        out.append(f"{run}{prev}")
    return "".join(out)


def align(q, t, W: int = 128, mode: str = "global"):
    """Convenience: banded align -> dict(dist, moves, tags, cigar, end)."""
    dist, end, bp, lo_arr = banded_dp(q, t, W, mode=mode)
    if dist >= INF:
        return None
    moves = traceback_banded(bp, lo_arr, end)
    return {
        "dist": int(dist),
        "end": end,
        "moves": moves,
        "tags": moves_to_tags(q, moves),
        "cigar": moves_to_cigar(moves),
    }

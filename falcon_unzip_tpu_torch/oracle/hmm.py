"""Numpy oracle for the Arrow-style pair-HMM (polish likelihood core).

Role parity: [U] ConsensusCore2 / GenomicConsensus "Arrow" — per-window
template-vs-read forward likelihood with iterative template mutation
testing (SURVEY.md §2b, §3.4).  This oracle defines the exact numeric
spec (op order included) for ``ops.pairhmm``:

States: M (match/mismatch), I (insertion in read), D (deletion in read).
  M[i,j] = em(i,j) + lse(M[i-1,j-1]+tMM, I[i-1,j-1]+tIM, D[i-1,j-1]+tDM)
  I[i,j] = log(1/4) + lse(M[i-1,j]+tMI, I[i-1,j]+tII)
  D[i,j] =            lse(M[i,j-1]+tMD, D[i,j-1]+tDD)
  lse(a, b, c) = logaddexp(logaddexp(a, b), c)   [fixed nesting order]
  loglik = lse(M[n,m], I[n,m], D[n,m])
Initialization: M[0,0] = 0, everything else -inf.
"""
from __future__ import annotations

import dataclasses

import numpy as np

NEG = np.float32(-1e30)


@dataclasses.dataclass
class HMMParams:
    e_sub: float = 0.02      # substitution emission error
    p_ins: float = 0.05      # M->I
    p_del: float = 0.05      # M->D
    eps_ins: float = 0.20    # I->I
    eps_del: float = 0.20    # D->D

    def logs(self):
        l = np.log
        return {
            "em_match": np.float32(l(1.0 - self.e_sub)),
            "em_mis": np.float32(l(self.e_sub / 3.0)),
            "em_ins": np.float32(l(0.25)),
            "tMM": np.float32(l(1.0 - self.p_ins - self.p_del)),
            "tMI": np.float32(l(self.p_ins)),
            "tMD": np.float32(l(self.p_del)),
            "tIM": np.float32(l(1.0 - self.eps_ins)),
            "tII": np.float32(l(self.eps_ins)),
            "tDM": np.float32(l(1.0 - self.eps_del)),
            "tDD": np.float32(l(self.eps_del)),
        }


def params_for_read_qv(qv: float, base: HMMParams | None = None
                       ) -> HMMParams:
    """Base-quality-conditioned HMM tier (SURVEY.md §2b variantCaller
    row: real Arrow conditions emissions on per-read features).

    The read's mean phred QV sets its total error budget
    p_err = 10^(-qv/10), split across error channels in the base
    params' proportions; qv <= 0 (no quality track) keeps the base
    params.  A per-READ scalar tier — coarser than per-base
    conditioning, but it already down-weights noisy reads against
    clean ones in mutation scoring.
    """
    base = base or HMMParams()
    if qv <= 0:
        return base
    # clamp: a mean-QV read tier shouldn't claim per-base certainty
    p_err = min(10.0 ** (-min(qv, 35.0) / 10.0), 0.45)
    tot = base.e_sub + base.p_ins + base.p_del
    scale = p_err / tot
    return HMMParams(
        e_sub=min(base.e_sub * scale, 0.24),
        p_ins=min(base.p_ins * scale, 0.24),
        p_del=min(base.p_del * scale, 0.24),
        eps_ins=base.eps_ins, eps_del=base.eps_del)


def forward_full(q: np.ndarray, t: np.ndarray,
                 params: HMMParams | None = None) -> float:
    """Full O(nm) forward log-likelihood (float32 accumulation)."""
    params = params or HMMParams()
    L = params.logs()
    n, m = len(q), len(t)
    M = np.full((n + 1, m + 1), NEG, np.float32)
    I = np.full((n + 1, m + 1), NEG, np.float32)
    D = np.full((n + 1, m + 1), NEG, np.float32)
    M[0, 0] = 0.0
    for i in range(n + 1):
        for j in range(m + 1):
            if i > 0 and j > 0:
                em = L["em_match"] if (q[i - 1] == t[j - 1] and q[i - 1] < 4) \
                    else L["em_mis"]
                M[i, j] = em + np.logaddexp(
                    np.logaddexp(M[i - 1, j - 1] + L["tMM"],
                                 I[i - 1, j - 1] + L["tIM"]),
                    D[i - 1, j - 1] + L["tDM"])
            if i > 0:
                I[i, j] = L["em_ins"] + np.logaddexp(
                    M[i - 1, j] + L["tMI"], I[i - 1, j] + L["tII"])
            if j > 0:
                D[i, j] = np.logaddexp(M[i, j - 1] + L["tMD"],
                                       D[i, j - 1] + L["tDD"])
    return float(np.logaddexp(np.logaddexp(M[n, m], I[n, m]), D[n, m]))


def score_templates(reads: list[np.ndarray], template: np.ndarray,
                    params: HMMParams | None = None) -> float:
    """Total log-likelihood of all reads given a template."""
    return float(sum(forward_full(r, template, params) for r in reads))


def forward_backward_full(q: np.ndarray, t: np.ndarray,
                          params: HMMParams | None = None):
    """Full forward AND backward matrices (the ConsensusCore2 alpha/beta
    pair, [U] variantCaller/ConsensusCore2 — SURVEY.md §3.4 "iterative
    mutation proposal/testing": real Arrow scores a point mutation by
    splicing cached alpha/beta instead of a full re-forward).

    Conventions:
      A_S[i, j]  — forward: all path prefixes ending in state S at (i, j),
                   the cell's own emission INCLUDED (same as forward_full).
      B_S[i, j]  — backward: all path suffixes starting FROM state S at
                   (i, j), the cell's own emission NOT included, so
                   A_S[i,j] + B_S[i,j] sums every path through (S, i, j)
                   exactly once.  B_M[0, 0] == total loglik.

    Returns ((A_M, A_I, A_D), (B_M, B_I, B_D)), all (n+1, m+1) float32.
    """
    params = params or HMMParams()
    L = params.logs()
    n, m = len(q), len(t)
    A_M = np.full((n + 1, m + 1), NEG, np.float32)
    A_I = np.full((n + 1, m + 1), NEG, np.float32)
    A_D = np.full((n + 1, m + 1), NEG, np.float32)
    A_M[0, 0] = 0.0
    for i in range(n + 1):
        for j in range(m + 1):
            if i > 0 and j > 0:
                em = L["em_match"] if (q[i - 1] == t[j - 1] and q[i - 1] < 4) \
                    else L["em_mis"]
                A_M[i, j] = em + np.logaddexp(
                    np.logaddexp(A_M[i - 1, j - 1] + L["tMM"],
                                 A_I[i - 1, j - 1] + L["tIM"]),
                    A_D[i - 1, j - 1] + L["tDM"])
            if i > 0:
                A_I[i, j] = L["em_ins"] + np.logaddexp(
                    A_M[i - 1, j] + L["tMI"], A_I[i - 1, j] + L["tII"])
            if j > 0:
                A_D[i, j] = np.logaddexp(A_M[i, j - 1] + L["tMD"],
                                         A_D[i, j - 1] + L["tDD"])
    B_M = np.full((n + 1, m + 1), NEG, np.float32)
    B_I = np.full((n + 1, m + 1), NEG, np.float32)
    B_D = np.full((n + 1, m + 1), NEG, np.float32)
    B_M[n, m] = B_I[n, m] = B_D[n, m] = 0.0
    for i in range(n, -1, -1):
        for j in range(m, -1, -1):
            if i == n and j == m:
                continue
            acc_m, acc_i, acc_d = NEG, NEG, NEG
            if i < n and j < m:
                em = L["em_match"] if (q[i] == t[j] and q[i] < 4) \
                    else L["em_mis"]
                go_m = em + B_M[i + 1, j + 1]
                acc_m = np.logaddexp(acc_m, L["tMM"] + go_m)
                acc_i = np.logaddexp(acc_i, L["tIM"] + go_m)
                acc_d = np.logaddexp(acc_d, L["tDM"] + go_m)
            if i < n:
                go_i = L["em_ins"] + B_I[i + 1, j]
                acc_m = np.logaddexp(acc_m, L["tMI"] + go_i)
                acc_i = np.logaddexp(acc_i, L["tII"] + go_i)
            if j < m:
                acc_d = np.logaddexp(acc_d, L["tDD"] + B_D[i, j + 1])
            B_D[i, j] = acc_d
            if j < m:
                acc_m = np.logaddexp(acc_m, L["tMD"] + B_D[i, j + 1])
            B_M[i, j] = acc_m
            B_I[i, j] = acc_i
    return (A_M, A_I, A_D), (B_M, B_I, B_D)


def splice_scores(q: np.ndarray, t: np.ndarray, fb, p: int,
                  params: HMMParams | None = None) -> np.ndarray:
    """Log-likelihoods of all 9 single-base mutations at template pos p
    from cached forward/backward matrices — NO re-forward.

    Identity used: every complete path crosses the boundary between
    template column p and the next column exactly once, via an M step
    (emits the next template base) or a D step (deletes it).  Gluing the
    unchanged prefix columns (forward, cols 0..p use t[:p]) to the
    unchanged suffix columns (backward, col p+k uses t[p+k:]) across a
    mutated middle column scores sub/ins/del in O(n) each.

    Returns (9,) float32: [sub base 0..3, ins base 0..3, del].  The
    "sub" to the template's own base equals the unmutated loglik (a
    built-in consistency check).
    """
    params = params or HMMParams()
    L = params.logs()
    (A_M, A_I, A_D), (B_M, B_I, B_D) = fb
    n, m = len(q), len(t)
    assert 0 <= p < m
    # launch values: paths at column p about to cross via an M or D step
    ax_m = np.logaddexp(np.logaddexp(A_M[:, p] + L["tMM"],
                                     A_I[:, p] + L["tIM"]),
                        A_D[:, p] + L["tDM"])            # (n+1,)
    ax_d = np.logaddexp(A_M[:, p] + L["tMD"], A_D[:, p] + L["tDD"])

    def em_vs(base: int) -> np.ndarray:
        # emission of read base q[i] against a template base (i = 0..n-1)
        return np.where((q == base) & (q < 4),
                        L["em_match"], L["em_mis"]).astype(np.float32)

    def lse(a):
        out = NEG
        for v in a:
            out = np.logaddexp(out, v)
        return out

    def cross(em_row: np.ndarray | None, col: int) -> float:
        """Join column-p launches through one emitted/deleted base into
        backward column `col` (entry-state convention)."""
        terms = [ax_d + B_D[:, col]]
        if em_row is not None:
            terms.append(ax_m[:n] + em_row + B_M[1:, col])
        return float(lse(np.concatenate(terms)))

    out = np.full(9, NEG, np.float32)
    for b in range(4):
        out[b] = cross(em_vs(b), p + 1)            # sub t[p] -> b
        out[4 + b] = cross(em_vs(b), p)            # ins b before p
    if p == m - 1:   # delete the last base: column p becomes terminal
        out[8] = lse([A_M[n, p], A_I[n, p], A_D[n, p]])
    else:            # cross from col p straight into base t[p+1]
        out[8] = cross(em_vs(int(t[p + 1])), p + 2)
    return out


def _pb_at(pb: np.ndarray, i: int) -> np.ndarray:
    """Param row of read base i, clipped into [0, n-1]."""
    return pb[min(max(i, 0), len(pb) - 1)]


# ops.pairhmm.params_vector column order
_K = {"em_match": 0, "em_mis": 1, "em_ins": 2, "tMM": 3, "tMI": 4,
      "tMD": 5, "tIM": 6, "tII": 7, "tDM": 8, "tDD": 9}


def forward_full_pb(q: np.ndarray, t: np.ndarray,
                    pb: np.ndarray) -> float:
    """Per-BASE-conditioned forward loglik (real Arrow's IQV/DQV tiers,
    SURVEY.md §2b variantCaller row).

    pb: (n, 10) float32 log-params per read base, ops.pairhmm
    params_vector column order.  Convention: every HMM edge takes its
    params from the tier of the read base it CONSUMES; D-only edges
    within row i (which consume no read base) take base i-1's tier,
    clipped at 0 — so the forward recurrence of row i reads exactly one
    param row, pb[i-1]."""
    n, m = len(q), len(t)
    M = np.full((n + 1, m + 1), NEG, np.float32)
    I = np.full((n + 1, m + 1), NEG, np.float32)
    D = np.full((n + 1, m + 1), NEG, np.float32)
    M[0, 0] = 0.0
    for i in range(n + 1):
        L = _pb_at(pb, i - 1)
        for j in range(m + 1):
            if i > 0 and j > 0:
                em = L[_K["em_match"]] \
                    if (q[i - 1] == t[j - 1] and q[i - 1] < 4) \
                    else L[_K["em_mis"]]
                M[i, j] = em + np.logaddexp(
                    np.logaddexp(M[i - 1, j - 1] + L[_K["tMM"]],
                                 I[i - 1, j - 1] + L[_K["tIM"]]),
                    D[i - 1, j - 1] + L[_K["tDM"]])
            if i > 0:
                I[i, j] = L[_K["em_ins"]] + np.logaddexp(
                    M[i - 1, j] + L[_K["tMI"]],
                    I[i - 1, j] + L[_K["tII"]])
            if j > 0:
                D[i, j] = np.logaddexp(M[i, j - 1] + L[_K["tMD"]],
                                       D[i, j - 1] + L[_K["tDD"]])
    return float(np.logaddexp(np.logaddexp(M[n, m], I[n, m]), D[n, m]))


def forward_backward_full_pb(q: np.ndarray, t: np.ndarray,
                             pb: np.ndarray):
    """Per-base-conditioned alpha/beta pair (see forward_backward_full
    for the A/B conventions and forward_full_pb for the edge-tier
    convention).  Numeric spec for ops.arrow per-base mode."""
    n, m = len(q), len(t)
    A_M = np.full((n + 1, m + 1), NEG, np.float32)
    A_I = np.full((n + 1, m + 1), NEG, np.float32)
    A_D = np.full((n + 1, m + 1), NEG, np.float32)
    A_M[0, 0] = 0.0
    for i in range(n + 1):
        L = _pb_at(pb, i - 1)
        for j in range(m + 1):
            if i > 0 and j > 0:
                em = L[_K["em_match"]] \
                    if (q[i - 1] == t[j - 1] and q[i - 1] < 4) \
                    else L[_K["em_mis"]]
                A_M[i, j] = em + np.logaddexp(
                    np.logaddexp(A_M[i - 1, j - 1] + L[_K["tMM"]],
                                 A_I[i - 1, j - 1] + L[_K["tIM"]]),
                    A_D[i - 1, j - 1] + L[_K["tDM"]])
            if i > 0:
                A_I[i, j] = L[_K["em_ins"]] + np.logaddexp(
                    A_M[i - 1, j] + L[_K["tMI"]],
                    A_I[i - 1, j] + L[_K["tII"]])
            if j > 0:
                A_D[i, j] = np.logaddexp(A_M[i, j - 1] + L[_K["tMD"]],
                                         A_D[i, j - 1] + L[_K["tDD"]])
    B_M = np.full((n + 1, m + 1), NEG, np.float32)
    B_I = np.full((n + 1, m + 1), NEG, np.float32)
    B_D = np.full((n + 1, m + 1), NEG, np.float32)
    B_M[n, m] = B_I[n, m] = B_D[n, m] = 0.0
    for i in range(n, -1, -1):
        Li = _pb_at(pb, i)        # M/I edges out of row i consume q[i]
        Lm1 = _pb_at(pb, i - 1)   # within-row D edges: base i-1
        for j in range(m, -1, -1):
            if i == n and j == m:
                continue
            acc_m, acc_i, acc_d = NEG, NEG, NEG
            if i < n and j < m:
                em = Li[_K["em_match"]] \
                    if (q[i] == t[j] and q[i] < 4) else Li[_K["em_mis"]]
                go_m = em + B_M[i + 1, j + 1]
                acc_m = np.logaddexp(acc_m, Li[_K["tMM"]] + go_m)
                acc_i = np.logaddexp(acc_i, Li[_K["tIM"]] + go_m)
                acc_d = np.logaddexp(acc_d, Li[_K["tDM"]] + go_m)
            if i < n:
                go_i = Li[_K["em_ins"]] + B_I[i + 1, j]
                acc_m = np.logaddexp(acc_m, Li[_K["tMI"]] + go_i)
                acc_i = np.logaddexp(acc_i, Li[_K["tII"]] + go_i)
            if j < m:
                acc_d = np.logaddexp(acc_d,
                                     Lm1[_K["tDD"]] + B_D[i, j + 1])
            B_D[i, j] = acc_d
            if j < m:
                acc_m = np.logaddexp(acc_m,
                                     Lm1[_K["tMD"]] + B_D[i, j + 1])
            B_M[i, j] = acc_m
            B_I[i, j] = acc_i
    return (A_M, A_I, A_D), (B_M, B_I, B_D)


def splice_scores_pb(q: np.ndarray, t: np.ndarray, fb, p: int,
                     pb: np.ndarray) -> np.ndarray:
    """Per-base-conditioned mutation splice (see splice_scores).

    Launch row i crosses the mutated column by consuming q[i] (M step:
    base i's tier) or by a row-i D step (base i-1's tier)."""
    (A_M, A_I, A_D), (B_M, B_I, B_D) = fb
    n, m = len(q), len(t)
    assert 0 <= p < m
    idx = np.arange(n + 1)
    Li = pb[np.clip(idx, 0, n - 1)]           # (n+1, 10) base i
    Lm1 = pb[np.clip(idx - 1, 0, n - 1)]      # (n+1, 10) base i-1
    ax_m = np.logaddexp(
        np.logaddexp(A_M[:, p] + Li[:, _K["tMM"]],
                     A_I[:, p] + Li[:, _K["tIM"]]),
        A_D[:, p] + Li[:, _K["tDM"]])
    ax_d = np.logaddexp(A_M[:, p] + Lm1[:, _K["tMD"]],
                        A_D[:, p] + Lm1[:, _K["tDD"]])

    def em_vs(base: int) -> np.ndarray:
        return np.where((q == base) & (q < 4),
                        Li[:n, _K["em_match"]],
                        Li[:n, _K["em_mis"]]).astype(np.float32)

    def lse(a):
        out = NEG
        for v in a:
            out = np.logaddexp(out, v)
        return out

    def cross(em_row, col: int) -> float:
        terms = [ax_d + B_D[:, col]]
        if em_row is not None:
            terms.append(ax_m[:n] + em_row + B_M[1:, col])
        return float(lse(np.concatenate(terms)))

    out = np.full(9, NEG, np.float32)
    for b in range(4):
        out[b] = cross(em_vs(b), p + 1)
        out[4 + b] = cross(em_vs(b), p)
    if p == m - 1:
        out[8] = lse([A_M[n, p], A_I[n, p], A_D[n, p]])
    else:
        out[8] = cross(em_vs(int(t[p + 1])), p + 2)
    return out


def mutations_of(template: np.ndarray, pos: int):
    """All single-base variants at pos: 3 subs, 1 del, 4 ins (before pos)."""
    out = []
    for b in range(4):
        if b != template[pos]:
            v = template.copy()
            v[pos] = b
            out.append((f"sub{pos}:{b}", v))
    v = np.delete(template, pos)
    out.append((f"del{pos}", v))
    for b in range(4):
        v = np.insert(template, pos, b)
        out.append((f"ins{pos}:{b}", v))
    return out


def polish_window_oracle(template: np.ndarray, reads: list[np.ndarray],
                         candidate_pos: list[int],
                         params: HMMParams | None = None,
                         max_rounds: int = 5) -> np.ndarray:
    """Greedy mutation search: apply the best improving single mutation per
    round among candidates until no improvement (Arrow's outer loop)."""
    params = params or HMMParams()
    cur = template.copy()
    cur_ll = score_templates(reads, cur, params)
    for _ in range(max_rounds):
        best = None
        for p in candidate_pos:
            if p >= len(cur):
                continue
            for name, v in mutations_of(cur, p):
                ll = score_templates(reads, v, params)
                if ll > cur_ll + 1e-3 and (best is None or ll > best[0]):
                    best = (ll, name, v)
        if best is None:
            break
        cur_ll, _, cur = best
    return cur

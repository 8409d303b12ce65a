"""The lane schedule of ``csrc/pairhmm_ablate.cu`` == ``pairhmm_ablate_plain``.

A numpy model of the CUDA kernel, lane by lane: one block a row, 4 warps
of 32 lanes, one band cell a lane; the band shifts as constants of each
phase (every step shifts up to d = W, then the odd step keeps and the even
one shifts); the shift's values crossing lanes by a shuffle within a warp
and by one shared-memory word a warp across warps, double-buffered by
exchange parity.  Between two barriers the warps run one after another,
each reading the last exchange's words before it writes the next ones, so
a slot reused too early shows as a wrong value.  Held against the plain
version for all five feature sets at P = 8 and Dmax around the phase
boundaries (d = W, W + 1, W + 2, an odd and an even tail), from the probe
and from the NEG start: bit-exact without the logaddexps; with them within
1e-6 relative (the model takes numpy's exp and log1p, the plain version
torch's).
"""
import numpy as np
import pytest
import torch

from falcon_unzip_tpu_torch.ops.pairhmm_ablate import (FEATURE_SETS,
                                                        neg_init,
                                                        pairhmm_ablate_plain,
                                                        probe_inputs)

torch.set_num_threads(1)

W, NW, P, LQG = 128, 4, 8, 512
NEG = np.float32(-1e30)
F = np.float32
DMAXES = [1, 2, 128, 129, 130, 131, 385]
PLANES = ("M1", "I1", "D1", "M2", "I2", "D2")


def program(Dmax: int, shift: bool) -> list:
    """The kernel's loop for one block, in order: ("step", lo, S) with S
    the phase's shift constant, each followed by ("xchg",) when the set
    shifts (the step's M handed to the cell above)."""
    xchg = [("xchg",)] if shift else []
    prog, d = [], 0
    while d <= min(W, Dmax - 1):
        prog += [("step", 0, True), *xchg]
        d += 1
    while d + 1 < Dmax:
        lo = (d + 1) // 2 - W // 2
        prog += [("step", lo, False), *xchg, ("step", lo, True), *xchg]
        d += 2
    if d < Dmax:
        prog += [("step", (d + 1) // 2 - W // 2, False), *xchg]
    return prog


def _lae(a, b):
    return np.maximum(a, b) + np.log1p(np.exp(-np.abs(a - b)))


def _step(r, row, lo, S, feats):
    """One antidiagonal for one warp's 32 lanes (r: its registers)."""
    Md, Mu = (r["uM2"], r["uM1"]) if S and "shift" in feats else \
        (r["M2"], r["M1"])
    em = F(-0.1)
    if "load" in feats:
        em = np.where(row[:, lo + r["w"]] < 4, F(-0.1), F(-3.0))
    if "lse" in feats:
        M = em + _lae(_lae(Md - F(0.1), r["I2"] - F(3.0)),
                      r["D2"] - F(3.0))
        I = _lae(Mu - F(3.0), r["I1"] - F(1.6))
        D = _lae(r["M1"] - F(3.0), r["D1"] - F(1.6))
    else:
        M = em + np.maximum(np.maximum(Md, r["I2"]), r["D2"])
        I = np.maximum(Mu, r["I1"])
        D = np.maximum(r["M1"], r["D1"])
    r["acc"] = np.maximum(r["acc"], M)
    r["M2"], r["I2"], r["D2"] = r["M1"], r["I1"], r["D1"]
    r["M1"], r["I1"], r["D1"] = M, I, D


def model(qg: np.ndarray, init: np.ndarray, feats, Dmax: int) -> tuple:
    """(out, planes) of the kernel's schedule, warp by warp between
    barriers: out (P, W) and the state planes M1 I1 D1 M2 I2 D2 at the
    end, each (P, W)."""
    feats = frozenset(feats)
    warps = []
    for k in range(NW):
        w = np.arange(32 * k, 32 * k + 32)
        seed = init[:, w]
        # the shifted M planes start at init[w - 1], NEG at w = 0
        u = np.where(w > 0, init[:, np.maximum(w - 1, 0)], NEG).astype(F)
        warps.append(dict(w=w, M1=seed, I1=seed, D1=seed, M2=seed,
                          I2=seed, D2=seed, uM1=u, uM2=u,
                          acc=np.full_like(seed, NEG)))
    # the program cut at its barriers: each piece is a run of steps and
    # the exchange that ends it (None for the last piece)
    pieces, steps = [], []
    for op in program(Dmax, "shift" in feats):
        if op[0] == "step":
            steps.append(op)
        else:
            pieces.append((steps, op))
            steps = []
    pieces.append((steps, None))
    edge = [[np.full(P, np.nan, F)] * NW for _ in range(2)]   # [par][warp]
    par, last = 0, None
    for steps, op in pieces:
        for k, r in enumerate(warps):
            if last is not None:       # after the barrier: lane 0's word
                u = r["sent"].copy()
                u[:, 0] = edge[last][k - 1] if k > 0 else NEG
                r["uM2"], r["uM1"] = r["uM1"], u
            for _, lo, S in steps:
                _step(r, qg, lo, S, feats)
            if op is not None:         # before the barrier: shuffle, word
                r["sent"] = np.concatenate([r["M1"][:, :1],
                                            r["M1"][:, :-1]], axis=1)
                edge[par][k] = r["M1"][:, 31]
        if op is not None:
            last, par = par, par ^ 1
    cat = lambda key: np.concatenate([r[key] for r in warps], axis=1)
    return cat("acc"), [cat(key) for key in PLANES]


def plane_loop(qg, init, feats, Dmax) -> tuple:
    """(out, planes) of the plain version's loop on whole (P, W) planes:
    out and the state planes M1 I1 D1 M2 I2 D2 after Dmax steps."""
    feats = frozenset(feats)
    r = dict(w=np.arange(W), acc=np.full_like(init, NEG),
             **{key: init for key in PLANES})
    shift = lambda V: np.concatenate([np.full((P, 1), NEG), V[:, :-1]], 1)
    for d in range(Dmax):
        lo = max(0, (d + 1) // 2 - W // 2)
        s1 = lo - max(0, d // 2 - W // 2)
        r["uM1"], r["uM2"] = shift(r["M1"]), shift(r["M2"])
        _step(r, qg, lo, s1 == 0, feats)
    return r["acc"], [r[key] for key in PLANES]


def _plain(qg, init, feats, Dmax):
    return pairhmm_ablate_plain(torch.from_numpy(qg),
                                torch.from_numpy(init), feats,
                                Dmax=Dmax).numpy()


@pytest.mark.parametrize("Dmax", DMAXES)
@pytest.mark.parametrize("feats", FEATURE_SETS,
                         ids=lambda f: "+".join(f) or "none")
def test_lane_schedule_equals_plain(feats, Dmax):
    qg, init = probe_inputs(P, LQG, W, Dmax)
    rows = np.random.default_rng(Dmax).integers(0, 5, (P, LQG)).astype(
        np.int32)
    neg = neg_init(P, W)
    np.testing.assert_array_equal(model(rows, neg, feats, Dmax)[0],
                                  _plain(rows, neg, feats, Dmax))
    got, want = model(qg, init, feats, Dmax)[0], _plain(qg, init, feats,
                                                        Dmax)
    assert (want > -1e29).all()
    if "lse" in feats:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    else:
        np.testing.assert_array_equal(got, want)        # tolerance 0


@pytest.mark.parametrize("Dmax,shifts", [(1, 1), (129, 129), (130, 129),
                                         (131, 130), (385, 257)])
def test_program_shifts_where_the_band_stands(Dmax, shifts):
    """The phase constants give s1 = lo(d) - lo(d-1) = 0 exactly at the
    steps marked to shift, and lo(d) at every step."""
    steps = [op for op in program(Dmax, True) if op[0] == "step"]
    assert len(steps) == Dmax
    lo = lambda d: max(0, (d + 1) // 2 - W // 2)
    for d, (_, lo_d, S) in enumerate(steps):
        assert lo_d == lo(d)
        assert S == (lo(d) == max(0, d // 2 - W // 2))
    assert sum(S for _, _, S in steps) == shifts


@pytest.mark.parametrize("Dmax", [130, 131, 385])
@pytest.mark.parametrize("feats", [("shift",), ("shift", "load", "lse")],
                         ids=lambda f: "+".join(f))
def test_lane_schedule_state_planes_equal_plane_loop(feats, Dmax):
    """out is set by the first steps (the band has carried every value
    across it by d = W, and the logaddexps only decay), so a fault in the
    steady phase's shifts would not show there; the state planes after
    the last step show it."""
    qg, init = probe_inputs(P, LQG, W, Dmax)
    got = model(qg, init, feats, Dmax)
    want = plane_loop(qg, init, feats, Dmax)
    np.testing.assert_allclose(want[0], _plain(qg, init, feats, Dmax),
                               rtol=1e-6, atol=0)
    for g, x in zip([got[0], *got[1]], [want[0], *want[1]]):
        if "lse" in feats:
            np.testing.assert_allclose(g, x, rtol=1e-6, atol=0)
        else:
            np.testing.assert_array_equal(g, x)

"""Build, load and launch the hand-written CUDA kernels (``csrc/``).

Each source is compiled with ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface at first use (all sources at once, one
``nvcc`` process each), cached by the hash of its content and of the
shared header's (``HEADERS``) in ``falcon_unzip_tpu_torch/_build/``
(listed in ``.gitignore``), and bound with ctypes.  Each C entry point launches on the calling thread's current
stream of the tensor's device and returns ``cudaGetLastError()``; a
nonzero code raises.  A failed build raises: there is no fallback.

Every kernel carries a plain-integer launch count (``Kernel.launches``),
bumped where the kernel is launched and nowhere else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = [os.path.join(_PKG, "csrc", f"{stem}.cu")
           for stem in ("banded_align", "pairhmm", "arrow_splice",
                        "pairhmm_ablate")]
# included by the sources: their contents join every source's hash
HEADERS = [os.path.join(_PKG, "csrc", "logaddexp2.cuh")]
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict = {}
BUILD_LOG = ""    # nvcc's output of the builds this process ran (ptxas -v)


class Kernel:
    """Launch counter of one CUDA kernel (thread-safe).

    With ``timed`` set, each launch is bracketed by CUDA events on its
    stream (no synchronisation); ``elapsed_ms`` sums them."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0
        self.cells = 0     # DP cells the launches covered (wavefront)
        self.timed = False
        self._spans: list = []
        self._lock = threading.Lock()

    def count(self, cells: int = 0, span=None) -> None:
        with self._lock:
            self.launches += 1
            self.cells += cells
            if span is not None:
                self._spans.append(span)

    def reset(self) -> None:
        with self._lock:
            self.launches = 0
            self.cells = 0
            self._spans = []

    def elapsed_ms(self) -> float:
        """Device time of the timed launches since the last reset."""
        with self._lock:
            spans = list(self._spans)
        torch.cuda.synchronize()
        return float(sum(a.elapsed_time(b) for a, b in spans))

    def _start(self, stream):
        if not self.timed:
            return None
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record(stream)
        return ev


WAVEFRONT = Kernel("banded_wavefront")
TRACEBACK = Kernel("traceback")
PAIRHMM = Kernel("pairhmm_forward")
ARROW = Kernel("arrow_splice")
ABLATE = Kernel("pairhmm_ablate")
KERNELS = (WAVEFRONT, TRACEBACK, PAIRHMM, ARROW, ABLATE)


def reset_counts() -> None:
    for k in KERNELS:
        k.reset()


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build() -> dict:
    """Compile every source not yet cached, all at once, and return
    {source stem: library path}."""
    global BUILD_LOG
    libs, procs = {}, []
    for src in SOURCES:
        stem = os.path.splitext(os.path.basename(src))[0]
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for path in (*HEADERS, src):
            with open(path, "rb") as fh:
                h.update(fh.read())
        lib = os.path.join(BUILD_DIR, f"lib{stem}_{h.hexdigest()[:16]}.so")
        libs[stem] = lib
        if os.path.exists(lib):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.tmp"
        procs.append((lib, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, src], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    failed = []
    for lib, tmp, proc in procs:
        out, _ = proc.communicate()
        BUILD_LOG += out
        if proc.returncode != 0:
            failed.append(f"{lib}: nvcc exit {proc.returncode}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed: " + "; ".join(failed) + "\n"
                           + BUILD_LOG)
    return libs


def _load() -> dict:
    with _lock:
        if not _libs:
            paths = build()
            vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib = ctypes.CDLL(paths["banded_align"])
            lib.fu_banded_wavefront.argtypes = [
                vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci,
                vp, vp, vp, vp, vp]
            lib.fu_banded_wavefront.restype = ci
            lib.fu_traceback.argtypes = [vp, ci, ci, ci, vp, vp, ci, vp, vp,
                                         ci, vp]
            lib.fu_traceback.restype = ci
            lib.fu_wavefront_layout_width.argtypes = [ci]
            lib.fu_wavefront_layout_width.restype = ci
            hmm = ctypes.CDLL(paths["pairhmm"])
            hmm.fu_pairhmm_forward.argtypes = (
                [vp, vp, vp, vp] + [ci] * 7 + [cf] * 10 + [vp, vp])
            hmm.fu_pairhmm_forward.restype = ci
            hmm.fu_pairhmm_forward_cells.argtypes = (
                [ci, vp, vp, vp, vp] + [ci] * 7 + [cf] * 10 + [vp, vp])
            hmm.fu_pairhmm_forward_cells.restype = ci
            hmm.fu_pairhmm_cells.argtypes = [ci, ci]
            hmm.fu_pairhmm_cells.restype = ci
            hmm.fu_pairhmm_layout_width.argtypes = [ci]
            hmm.fu_pairhmm_layout_width.restype = ci
            arrow = ctypes.CDLL(paths["arrow_splice"])
            arrow.fu_arrow_sweeps.argtypes = (
                [vp] * 8 + [ci] * 5 + [vp] * 7)
            arrow.fu_arrow_sweeps.restype = ci
            arrow.fu_arrow_warps.argtypes = [ci]
            arrow.fu_arrow_warps.restype = ci
            abl = ctypes.CDLL(paths["pairhmm_ablate"])
            abl.fu_pairhmm_ablate.argtypes = [vp, vp] + [ci] * 5 + [vp, vp]
            abl.fu_pairhmm_ablate.restype = ci
            _libs.update(banded_align=lib, pairhmm=hmm, arrow_splice=arrow,
                         pairhmm_ablate=abl)
    return _libs


def _check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")


def _need(x: torch.Tensor, dtype: torch.dtype, shape: tuple, name: str,
          device: torch.device) -> None:
    if x.device != device or x.dtype != dtype or tuple(x.shape) != shape \
            or not x.is_contiguous():
        raise ValueError(f"{name}: want contiguous {dtype} {shape} on "
                         f"{device}, got {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}")


MODES = {"global": 0, "qglocal": 1, "tglocal": 2}
# The widest band the three band kernels take.  Each runs any W from 1 to
# MAX_W: on a built layout 32 C NW lanes wide exactly, else on the
# narrowest wider one with its cells past W held out of the band.  At
# W = 4096 one 256-pair chunk's packed moves are already 1.2 GB.
MAX_W = 4096


def _width(W: int, what: str) -> None:
    if not 1 <= W <= MAX_W:
        raise ValueError(f"{what}: band width W={W} is outside 1..{MAX_W}, "
                         f"the widths the kernel is built for")


def banded_wavefront(qg: torch.Tensor, trg: torch.Tensor, n: torch.Tensor,
                     m: torch.Tensor, *, W: int, Lt: int, G: int, Dmax: int,
                     mode: str, want_bp: bool) -> dict:
    """Launch kernel 1 on CUDA tensors.  Returns dist/end_i/end_j (P,)
    int32 and, if want_bp, bp (ceil(Dmax/16), P, W) int32 packed moves."""
    _width(W, "banded_wavefront")
    dev = qg.device
    if dev.type != "cuda":
        raise ValueError(f"banded_wavefront needs CUDA tensors, got {dev}")
    P, LQG = qg.shape
    LTG = trg.shape[1]
    _need(qg, torch.int8, (P, LQG), "qg", dev)
    _need(trg, torch.int8, (P, LTG), "trg", dev)
    _need(n, torch.int32, (P,), "n", dev)
    _need(m, torch.int32, (P,), "m", dev)
    # every base read must stay inside the guarded rows
    d_last = Dmax - 1
    lo_last = max(0, (d_last + 1) // 2 - W // 2)
    if lo_last + W > LQG or G + Lt - d_last + lo_last < 0 \
            or G + Lt + W > LTG:
        raise ValueError("guarded rows too short for the band schedule")
    dist = torch.empty(P, dtype=torch.int32, device=dev)
    end_i = torch.empty(P, dtype=torch.int32, device=dev)
    end_j = torch.empty(P, dtype=torch.int32, device=dev)
    bp = (torch.empty((-(-Dmax // 16), P, W), dtype=torch.int32, device=dev)
          if want_bp else None)
    out = {"dist": dist, "end_i": end_i, "end_j": end_j}
    if want_bp:
        out["bp"] = bp
    if P == 0:
        return out
    lib = _load()["banded_align"]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        span = WAVEFRONT._start(stream)
        code = lib.fu_banded_wavefront(
            qg.data_ptr(), trg.data_ptr(), n.data_ptr(), m.data_ptr(),
            P, LQG, LTG, Lt, G, Dmax, W, MODES[mode],
            bp.data_ptr() if want_bp else None, dist.data_ptr(),
            end_i.data_ptr(), end_j.data_ptr(), stream.cuda_stream)
        _check(code, "banded_wavefront launch")
        if span is not None:
            span[1].record(stream)
    WAVEFRONT.count(P * Dmax * W, span)
    return out


EPILOGUES = {"moves": 0, "packed": 1, "summary": 2}


def traceback(bp: torch.Tensor, end_i: torch.Tensor, end_j: torch.Tensor,
              *, W: int, Dmax: int, max_steps: int, epilogue: str = "moves",
              dist: torch.Tensor | None = None) -> torch.Tensor:
    """Launch kernel 2 with one of its epilogues:

    "moves": reverse-order moves (P, max_steps) int8;
    "packed": (P, ceil(max_steps / 16) + 3) int32, the moves 2 bits each,
    then dist, end_i, end_j;
    "summary": (P, 7) int32: dist, end_j, n_t, lead, trail, n_up, end_i.
    The last two read dist (P,) int32."""
    _width(W, "traceback")
    dev = bp.device
    if dev.type != "cuda":
        raise ValueError(f"traceback needs CUDA tensors, got {dev}")
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown traceback epilogue {epilogue!r}")
    P = bp.shape[1]
    _need(bp, torch.int32, (-(-Dmax // 16), P, W), "bp", dev)
    _need(end_i, torch.int32, (P,), "end_i", dev)
    _need(end_j, torch.int32, (P,), "end_j", dev)
    if epilogue == "moves":
        out = torch.empty((P, max_steps), dtype=torch.int8, device=dev)
    else:
        if dist is None:
            raise ValueError(f"the {epilogue} epilogue needs dist")
        _need(dist, torch.int32, (P,), "dist", dev)
        cols = 7 if epilogue == "summary" else -(-max_steps // 16) + 3
        out = torch.empty((P, cols), dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    lib = _load()["banded_align"]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        span = TRACEBACK._start(stream)
        code = lib.fu_traceback(bp.data_ptr(), P, W, Dmax,
                                end_i.data_ptr(), end_j.data_ptr(),
                                max_steps, out.data_ptr(),
                                stream.cuda_stream, EPILOGUES[epilogue],
                                None if dist is None else dist.data_ptr())
        _check(code, "traceback launch")
        if span is not None:
            span[1].record(stream)
    TRACEBACK.count(0, span)
    return out


def pairhmm_forward(qg: torch.Tensor, trg: torch.Tensor, n: torch.Tensor,
                    m: torch.Tensor, params, *, W: int, Lt: int, G: int,
                    Dmax: int) -> torch.Tensor:
    """Launch the pair-HMM forward kernel on CUDA tensors.  params: the
    ten log-params (ops.pairhmm.params_vector order).  Returns ll (P,)
    float32."""
    _width(W, "pairhmm_forward")
    dev = qg.device
    if dev.type != "cuda":
        raise ValueError(f"pairhmm_forward needs CUDA tensors, got {dev}")
    P, LQG = qg.shape
    LTG = trg.shape[1]
    _need(qg, torch.int8, (P, LQG), "qg", dev)
    _need(trg, torch.int8, (P, LTG), "trg", dev)
    _need(n, torch.int32, (P,), "n", dev)
    _need(m, torch.int32, (P,), "m", dev)
    pv = [float(x) for x in params]
    if len(pv) != 10:
        raise ValueError(f"want 10 log-params, got {len(pv)}")
    d_last = Dmax - 1
    lo_last = max(0, (d_last + 1) // 2 - W // 2)
    if lo_last + W > LQG or G + Lt - d_last + lo_last < 0 \
            or G + Lt + W > LTG:
        raise ValueError("guarded rows too short for the band schedule")
    ll = torch.empty(P, dtype=torch.float32, device=dev)
    if P == 0:
        return ll
    lib = _load()["pairhmm"]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        span = PAIRHMM._start(stream)
        code = lib.fu_pairhmm_forward(
            qg.data_ptr(), trg.data_ptr(), n.data_ptr(), m.data_ptr(),
            P, LQG, LTG, Lt, G, Dmax, W, *pv, ll.data_ptr(),
            stream.cuda_stream)
        _check(code, "pairhmm_forward launch")
        if span is not None:
            span[1].record(stream)
    PAIRHMM.count(P * Dmax * W, span)
    return ll


def layout_width(kernel: str, W: int) -> int:
    """The width 32 C NW of the built layout that band width W runs on in
    ``kernel`` ("banded_wavefront" or "pairhmm_forward"): W itself, or the
    narrowest wider layout, whose cells past W are held out of the band.
    The traceback takes any W as it is."""
    _width(W, kernel)
    libs = _load()
    if kernel == "banded_wavefront":
        return libs["banded_align"].fu_wavefront_layout_width(W)
    if kernel == "pairhmm_forward":
        return libs["pairhmm"].fu_pairhmm_layout_width(W)
    raise ValueError(f"no layouts for {kernel!r}")


def pairhmm_cells(W: int, P: int, device=None) -> int:
    """The band cells a lane (1 to 8; the layout's width / (32 cells) warps
    a block) that ``pairhmm_forward`` launches a batch of P pairs at band
    width W with on a CUDA device."""
    _width(W, "pairhmm_cells")
    lib = _load()["pairhmm"]
    with torch.cuda.device(device):
        c = lib.fu_pairhmm_cells(W, P)
    _check(max(0, -c), "pairhmm_cells")
    return c


def arrow_sweeps(q: torch.Tensor, t: torch.Tensor, n: torch.Tensor,
                 m: torch.Tensor, cand: torch.Tensor, pvec: torch.Tensor,
                 qt: torch.Tensor | None, tiers: torch.Tensor | None, *,
                 C: int) -> tuple:
    """Launch the Arrow splice sweep kernel on CUDA tensors.

    q (P, Lq) / t (P, LJ) int8, n, m (P,) int32, cand (P, C) int32,
    pvec (P, 10) float32; per-base tier mode: qt (P, Lq + 1) int8 tier ids
    and tiers (T, 10) float32 (both None otherwise).  Returns
    (afM, afI, afD (P, C, R), bM, bD (P, 3, C, R), ll_cur (P,)) float32,
    R = Lq + 1."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"arrow_sweeps needs CUDA tensors, got {dev}")
    P, Lq = q.shape
    LJ = t.shape[1]
    R = Lq + 1
    _need(q, torch.int8, (P, Lq), "q", dev)
    _need(t, torch.int8, (P, LJ), "t", dev)
    _need(n, torch.int32, (P,), "n", dev)
    _need(m, torch.int32, (P,), "m", dev)
    _need(cand, torch.int32, (P, C), "cand", dev)
    _need(pvec, torch.float32, (P, 10), "pvec", dev)
    if (qt is None) != (tiers is None):
        raise ValueError("qt and tiers come together")
    T = 0
    if qt is not None:
        T = tiers.shape[0]
        _need(qt, torch.int8, (P, R), "qt", dev)
        _need(tiers, torch.float32, (T, 10), "tiers", dev)
        if T < 1:
            raise ValueError("empty tier table")
    if LJ < 1 or C < 1:
        raise ValueError(f"need LJ >= 1 and C >= 1, got {LJ}, {C}")
    f32 = dict(dtype=torch.float32, device=dev)
    afM, afI, afD = (torch.empty((P, C, R), **f32) for _ in range(3))
    bM, bD = (torch.empty((P, 3, C, R), **f32) for _ in range(2))
    ll_cur = torch.empty(P, **f32)
    out = (afM, afI, afD, bM, bD, ll_cur)
    if P == 0:
        return out
    lib = _load()["arrow_splice"]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        span = ARROW._start(stream)
        code = lib.fu_arrow_sweeps(
            q.data_ptr(), t.data_ptr(), n.data_ptr(), m.data_ptr(),
            cand.data_ptr(), pvec.data_ptr(),
            None if qt is None else qt.data_ptr(),
            None if tiers is None else tiers.data_ptr(), T, P, Lq, LJ, C,
            *(x.data_ptr() for x in out), stream.cuda_stream)
        _check(code, "arrow_sweeps launch")
        if span is not None:
            span[1].record(stream)
    ARROW.count(2 * P * R * LJ, span)
    return out


def arrow_warps(P: int, device=None) -> int:
    """The warps a block (8 or 2) that ``arrow_sweeps`` launches a batch
    of P pairs with on a CUDA device."""
    lib = _load()["arrow_splice"]
    with torch.cuda.device(device):
        nw = lib.fu_arrow_warps(P)
    _check(max(0, -nw), "arrow_warps")
    return nw


ABLATE_FEATS = {"shift": 1, "load": 2, "lse": 4}
ABLATE_SETS = ((), ("shift",), ("load",), ("lse",), ("shift", "load", "lse"))


def pairhmm_ablate(qg: torch.Tensor, init: torch.Tensor, feats, *,
                   Dmax: int) -> torch.Tensor:
    """Launch the pair-HMM step ablation kernel on CUDA tensors.  qg
    (P, LQG) int32 base codes; init (P, W) float32, the six state planes'
    start; feats one of ``ABLATE_SETS``.  Returns out (P, W) float32."""
    feats = tuple(sorted(feats))
    if feats not in {tuple(sorted(f)) for f in ABLATE_SETS}:
        raise ValueError(f"feature set {feats} is not built")
    dev = qg.device
    if dev.type != "cuda":
        raise ValueError(f"pairhmm_ablate needs CUDA tensors, got {dev}")
    P, LQG = qg.shape
    W = init.shape[-1]
    if W != 128:
        raise ValueError(f"band width W={W} not supported by the kernel")
    _need(qg, torch.int32, (P, LQG), "qg", dev)
    _need(init, torch.float32, (P, W), "init", dev)
    # the TPU kernel's window: 128-aligned, W + 128 columns wide
    lo_last = max(0, Dmax // 2 - W // 2)
    if Dmax < 1 or (lo_last // 128) * 128 + W + 128 > LQG:
        raise ValueError("rows too short for the last window")
    out = torch.empty((P, W), dtype=torch.float32, device=dev)
    if P == 0:
        return out
    lib = _load()["pairhmm_ablate"]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        span = ABLATE._start(stream)
        code = lib.fu_pairhmm_ablate(
            qg.data_ptr(), init.data_ptr(), P, LQG, Dmax, W,
            sum(ABLATE_FEATS[f] for f in feats), out.data_ptr(),
            stream.cuda_stream)
        _check(code, "pairhmm_ablate launch")
        if span is not None:
            span[1].record(stream)
    ABLATE.count(P * Dmax * W, span)
    return out

"""Build, load and launch the hand-written CUDA kernels (``csrc/``).

The sources are compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface at first use, cached by content hash in
``falcon_unzip_tpu_torch/_build/`` (listed in ``.gitignore``), and bound
with ctypes.  Each C entry point launches on the calling thread's current
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
SOURCES = [os.path.join(_PKG, "csrc", "banded_align.cu")]
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
BUILD_LOG = ""    # nvcc's output of the build this process ran (ptxas -v)


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
KERNELS = (WAVEFRONT, TRACEBACK)


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


def build() -> str:
    """Compile the kernels (if not cached) and return the library path."""
    global BUILD_LOG
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        with open(src, "rb") as fh:
            h.update(fh.read())
    lib = os.path.join(BUILD_DIR, f"libfalcon_unzip_kernels_"
                                  f"{h.hexdigest()[:16]}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *SOURCES],
                          capture_output=True, text=True)
    BUILD_LOG = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{BUILD_LOG}")
    os.replace(tmp, lib)
    return lib


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.fu_banded_wavefront.argtypes = [
                vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci,
                vp, vp, vp, vp, vp]
            lib.fu_banded_wavefront.restype = ci
            lib.fu_traceback.argtypes = [vp, ci, ci, ci, vp, vp, ci, vp, vp]
            lib.fu_traceback.restype = ci
            _lib = lib
    return _lib


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


def banded_wavefront(qg: torch.Tensor, trg: torch.Tensor, n: torch.Tensor,
                     m: torch.Tensor, *, W: int, Lt: int, G: int, Dmax: int,
                     mode: str, want_bp: bool) -> dict:
    """Launch kernel 1 on CUDA tensors.  Returns dist/end_i/end_j (P,)
    int32 and, if want_bp, bp (ceil(Dmax/16), P, W) int32 packed moves."""
    dev = qg.device
    if dev.type != "cuda":
        raise ValueError(f"banded_wavefront needs CUDA tensors, got {dev}")
    if W not in (32, 64, 128, 256, 512):
        raise ValueError(f"band width W={W} not supported by the kernel")
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
    lib = _load()
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


def traceback(bp: torch.Tensor, end_i: torch.Tensor, end_j: torch.Tensor,
              *, W: int, Dmax: int, max_steps: int) -> torch.Tensor:
    """Launch kernel 2: reverse-order moves (P, max_steps) int8."""
    dev = bp.device
    if dev.type != "cuda":
        raise ValueError(f"traceback needs CUDA tensors, got {dev}")
    P = bp.shape[1]
    _need(bp, torch.int32, (-(-Dmax // 16), P, W), "bp", dev)
    _need(end_i, torch.int32, (P,), "end_i", dev)
    _need(end_j, torch.int32, (P,), "end_j", dev)
    out = torch.empty((P, max_steps), dtype=torch.int8, device=dev)
    if P == 0 or max_steps == 0:
        return out
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        span = TRACEBACK._start(stream)
        code = lib.fu_traceback(bp.data_ptr(), P, W, Dmax,
                                end_i.data_ptr(), end_j.data_ptr(),
                                max_steps, out.data_ptr(),
                                stream.cuda_stream)
        _check(code, "traceback launch")
        if span is not None:
            span[1].record(stream)
    TRACEBACK.count(0, span)
    return out

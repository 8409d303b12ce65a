"""Explicit device resolution.

Every entry point takes a ``device`` argument.  There is no fallback: a
CUDA device on a machine without one raises.  ``scope`` binds a device
for the length of a ``with`` block in the current thread of execution;
it exists for the modules kept verbatim from the reference
(``models.unzipper.place_haplotigs``, ``models.dedup``), which build
aligners without a device argument.  Outside a scope, a missing device
is an error.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

_SCOPE: contextvars.ContextVar = contextvars.ContextVar(
    "falcon_unzip_tpu_torch_device", default=None)


def resolve(device=None) -> torch.device:
    """``device`` (str or torch.device) -> torch.device; None -> the
    enclosing ``scope``.  Raises when no device is given or CUDA is asked
    for without a GPU."""
    if device is None:
        device = _SCOPE.get()
        if device is None:
            raise ValueError("no device given and no device scope active")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not "
                               "available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


@contextlib.contextmanager
def scope(device):
    """Bind ``device`` for code that resolves ``device=None``."""
    token = _SCOPE.set(resolve(device))
    try:
        yield _SCOPE.get()
    finally:
        _SCOPE.reset(token)

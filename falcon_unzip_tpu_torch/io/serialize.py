"""Serialization helpers: msgpack/json by extension + atomic writes.

Role parity: [U] falcon_unzip/io.py::serialize/deserialize (msgpack or
json chosen by filename extension) used for read_to_contig_map,
rawread_to_contigs and friends (SURVEY.md §2a IO utils).  Atomic
write-tmp-then-rename matches the reference's crash-safety convention
(SURVEY.md §5 race detection).
"""
from __future__ import annotations

import json
import os

import numpy as np

try:
    import msgpack
    HAVE_MSGPACK = True
except ImportError:          # pragma: no cover
    HAVE_MSGPACK = False


def _to_plain(obj):
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, dict):
        return {k: _to_plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_plain(v) for v in obj]
    return obj


def serialize(path: str, obj) -> None:
    """Write obj to path (.msgpack or .json), atomically."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    obj = _to_plain(obj)
    if path.endswith(".msgpack") and HAVE_MSGPACK:
        with open(tmp, "wb") as fh:
            fh.write(msgpack.packb(obj, use_bin_type=True))
    else:
        with open(tmp, "w") as fh:
            json.dump(obj, fh)
    os.replace(tmp, path)


def deserialize(path: str):
    if path.endswith(".msgpack") and HAVE_MSGPACK:
        with open(path, "rb") as fh:
            return msgpack.unpackb(fh.read(), raw=False,
                                   strict_map_key=False)
    with open(path) as fh:
        return json.load(fh)


def packb(obj) -> bytes:
    """In-memory msgpack (bytes values preserved); json-bytes fallback."""
    if HAVE_MSGPACK:
        return msgpack.packb(obj, use_bin_type=True)
    return json.dumps(_jsonable(obj)).encode()       # pragma: no cover


def unpackb(blob: bytes):
    if HAVE_MSGPACK:
        return msgpack.unpackb(blob, raw=False, strict_map_key=False)
    return _unjsonable(json.loads(blob.decode()))    # pragma: no cover


def _jsonable(obj):                                  # pragma: no cover
    import base64
    if isinstance(obj, bytes):
        return {"__b64__": base64.b64encode(obj).decode()}
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    return obj


def _unjsonable(obj):                                # pragma: no cover
    import base64
    if isinstance(obj, dict):
        if set(obj) == {"__b64__"}:
            return base64.b64decode(obj["__b64__"])
        return {k: _unjsonable(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_unjsonable(v) for v in obj]
    return obj

"""Array (de)serialisation for moving host columns between processes.

The port keeps ``pack_arrays`` and ``unpack_arrays`` of the
reference's ``parallel/distributed.py``; the multi-process set-up and
collectives there wait for the port of ``parallel/``.
"""
from __future__ import annotations


def pack_arrays(cols: dict) -> bytes:
    """msgpack a dict of numpy arrays (dtype+shape preserved)."""
    import numpy as np

    from ..io.serialize import packb
    out = {}
    for k, v in cols.items():
        v = np.ascontiguousarray(v)
        out[k] = (str(v.dtype), list(v.shape), v.tobytes())
    return packb(out)


def unpack_arrays(blob: bytes) -> dict:
    import numpy as np

    from ..io.serialize import unpackb
    raw = unpackb(blob)
    return {k: np.frombuffer(b, dtype=np.dtype(dt)).reshape(shape)
            for k, (dt, shape, b) in raw.items()}

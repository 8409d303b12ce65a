"""ctypes bindings for the native IO library (libfalcon_io.so).

Loads the C++ FASTX parser when built (``make -C falcon_unzip_tpu/native``)
and transparently builds it on first use if a compiler is available.
``read_fasta_native`` mirrors io.fasta.read_fasta (same SeqBatch output,
conformance-tested); callers fall back to the pure-Python path when the
library is unavailable.
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

from ..seq import SeqBatch

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libfalcon_io.so")

_lib = None


class _FastxResult(ctypes.Structure):
    _fields_ = [
        ("seq", ctypes.POINTER(ctypes.c_int8)),
        ("offsets", ctypes.POINTER(ctypes.c_int64)),
        ("names", ctypes.POINTER(ctypes.c_char)),
        ("names_len", ctypes.c_int64),
        ("n", ctypes.c_int64),
        ("total", ctypes.c_int64),
        ("quals", ctypes.POINTER(ctypes.c_char)),
    ]


def _build() -> bool:
    try:
        subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                       capture_output=True, timeout=120)
        return os.path.exists(_LIB_PATH)
    except Exception:
        return False


class _BamResult(ctypes.Structure):
    _fields_ = [
        ("text", ctypes.POINTER(ctypes.c_char)),
        ("text_len", ctypes.c_int64),
        ("ref_names", ctypes.POINTER(ctypes.c_char)),
        ("ref_names_len", ctypes.c_int64),
        ("ref_lens", ctypes.POINTER(ctypes.c_int64)),
        ("n_ref", ctypes.c_int64),
        ("n_rec", ctypes.c_int64),
        ("names", ctypes.POINTER(ctypes.c_char)),
        ("names_len", ctypes.c_int64),
        ("flag", ctypes.POINTER(ctypes.c_int32)),
        ("ref_id", ctypes.POINTER(ctypes.c_int32)),
        ("pos", ctypes.POINTER(ctypes.c_int32)),
        ("mapq", ctypes.POINTER(ctypes.c_int32)),
        ("cigar", ctypes.POINTER(ctypes.c_uint32)),
        ("cigar_off", ctypes.POINTER(ctypes.c_int64)),
        ("seq", ctypes.POINTER(ctypes.c_int8)),
        ("qual", ctypes.POINTER(ctypes.c_uint8)),
        ("seq_off", ctypes.POINTER(ctypes.c_int64)),
        ("error", ctypes.c_int32),
    ]


class _BgzfBuf(ctypes.Structure):
    _fields_ = [
        ("data", ctypes.POINTER(ctypes.c_uint8)),
        ("len", ctypes.c_int64),
        ("error", ctypes.c_int32),
    ]


def load_library():
    """Load (building if needed) the native library; None if unavailable."""
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH) and not _build():
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    lib.fastx_parse.argtypes = [ctypes.c_char_p]
    lib.fastx_parse.restype = ctypes.POINTER(_FastxResult)
    lib.fastx_free.argtypes = [ctypes.POINTER(_FastxResult)]
    lib.fastx_free.restype = None
    lib.bam_decode.argtypes = [ctypes.c_char_p, ctypes.c_int32]
    lib.bam_decode.restype = ctypes.POINTER(_BamResult)
    lib.bam_result_free.argtypes = [ctypes.POINTER(_BamResult)]
    lib.bam_result_free.restype = None
    lib.bgzf_encode.argtypes = [ctypes.POINTER(ctypes.c_uint8),
                                ctypes.c_int64, ctypes.c_int32,
                                ctypes.c_int32]
    lib.bgzf_encode.restype = ctypes.POINTER(_BgzfBuf)
    lib.bgzf_buf_free.argtypes = [ctypes.POINTER(_BgzfBuf)]
    lib.bgzf_buf_free.restype = None
    _lib = lib
    return lib


def available() -> bool:
    return load_library() is not None


def read_fasta_native(path: str, align: int = 128) -> SeqBatch:
    """Parse FASTA/FASTQ via the C++ library -> SeqBatch."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native IO library unavailable")
    rp = lib.fastx_parse(path.encode())
    if not rp:
        raise IOError(f"fastx_parse failed for {path}")
    try:
        r = rp.contents
        n = int(r.n)
        total = int(r.total)
        offsets = np.ctypeslib.as_array(r.offsets, shape=(n + 1,)).copy()
        flat = np.ctypeslib.as_array(r.seq, shape=(max(total, 1),)).copy()
        names_blob = ctypes.string_at(r.names, r.names_len)
        names = names_blob.decode("ascii").split("\x00")[:n] if n else []
        seqs = [flat[offsets[i]:offsets[i + 1]] for i in range(n)]
        return SeqBatch.from_strs(seqs, names=names, align=align)
    finally:
        lib.fastx_free(rp)


# ---------------------------------------------------------------------------
# BAM (columnar decode — the htslib role; conformance-tested vs io.bamlite)
# ---------------------------------------------------------------------------

class BamColumns:
    """Columnar view of a decoded BAM: numpy vectors + flat blobs.

    Mirrors io.bamlite.BamFile content without per-record Python
    objects; the pipeline feeds these arrays straight into the packed
    int8 device layout.  to_bamfile() materializes the record-object
    view for code written against the pure-Python codec.
    """

    def __init__(self, text, refs, names, flag, ref_id, pos, mapq,
                 cigar, cigar_off, seq, qual, seq_off):
        self.text = text
        self.refs = refs                  # list[(name, length)]
        self.names = names                # list[str]
        self.flag = flag                  # int32 (n,)
        self.ref_id = ref_id
        self.pos = pos
        self.mapq = mapq
        self.cigar = cigar                # uint32 flat (len<<4 | op)
        self.cigar_off = cigar_off        # int64 (n+1,)
        self.seq = seq                    # int8 flat (framework codes)
        self.qual = qual                  # uint8 flat
        self.seq_off = seq_off            # int64 (n+1,)

    def __len__(self):
        return len(self.flag)

    def record_seq(self, i: int) -> np.ndarray:
        return self.seq[self.seq_off[i]:self.seq_off[i + 1]]

    def record_cigar(self, i: int):
        words = self.cigar[self.cigar_off[i]:self.cigar_off[i + 1]]
        return [(int(w) >> 4, int(w) & 0xF) for w in words]

    def to_bamfile(self):
        from .bamlite import BamFile, BamRecord
        records = []
        for i in range(len(self)):
            records.append(BamRecord(
                name=self.names[i], flag=int(self.flag[i]),
                ref_id=int(self.ref_id[i]), pos=int(self.pos[i]),
                mapq=int(self.mapq[i]), cigar=self.record_cigar(i),
                seq=self.record_seq(i).copy(),
                qual=self.qual[self.seq_off[i]:self.seq_off[i + 1]].copy()))
        return BamFile(text=self.text, refs=self.refs, records=records)


_BAM_ERRORS = {1: "io error", 2: "bad BGZF framing", 3: "inflate failed",
               4: "bad BAM record"}


def read_bam_native(path: str, n_threads: int = 0) -> BamColumns:
    """Decode a BAM via the C++ library (multithreaded BGZF inflate)."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native IO library unavailable")
    rp = lib.bam_decode(path.encode(), n_threads)
    if not rp:
        raise IOError(f"bam_decode failed for {path}")
    try:
        r = rp.contents
        if r.error:
            raise IOError(f"bam_decode({path}): "
                          f"{_BAM_ERRORS.get(r.error, r.error)}")
        n = int(r.n_rec)

        def arr(p, count, dt):
            if count == 0:
                return np.zeros(0, dt)
            return np.ctypeslib.as_array(p, shape=(count,)).astype(dt,
                                                                   copy=True)

        text = ctypes.string_at(r.text, r.text_len).decode("ascii",
                                                           "replace")
        ref_names = (ctypes.string_at(r.ref_names, r.ref_names_len)
                     .decode("ascii").split("\x00")[:int(r.n_ref)])
        ref_lens = arr(r.ref_lens, int(r.n_ref), np.int64)
        refs = [(nm, int(ln)) for nm, ln in zip(ref_names, ref_lens)]
        names = (ctypes.string_at(r.names, r.names_len)
                 .decode("ascii").split("\x00")[:n] if n else [])
        cigar_off = arr(r.cigar_off, n + 1, np.int64)
        seq_off = arr(r.seq_off, n + 1, np.int64)
        return BamColumns(
            text=text, refs=refs, names=names,
            flag=arr(r.flag, n, np.int32), ref_id=arr(r.ref_id, n, np.int32),
            pos=arr(r.pos, n, np.int32), mapq=arr(r.mapq, n, np.int32),
            cigar=arr(r.cigar, int(cigar_off[-1]) if n else 0, np.uint32),
            cigar_off=cigar_off,
            seq=arr(r.seq, int(seq_off[-1]) if n else 0, np.int8),
            qual=arr(r.qual, int(seq_off[-1]) if n else 0, np.uint8),
            seq_off=seq_off)
    finally:
        lib.bam_result_free(rp)


def bgzf_compress_native(payload: bytes, level: int = 6,
                         n_threads: int = 0) -> bytes:
    """Multithreaded BGZF encode (writer fast path); incl. EOF block."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native IO library unavailable")
    buf = (ctypes.c_uint8 * max(len(payload), 1)).from_buffer_copy(
        payload or b"\x00")
    rp = lib.bgzf_encode(buf, len(payload), level, n_threads)
    if not rp:
        raise IOError("bgzf_encode failed")
    try:
        r = rp.contents
        if r.error:
            raise IOError("bgzf_encode failed")
        return ctypes.string_at(r.data, r.len)
    finally:
        lib.bgzf_buf_free(rp)

"""FASTA/FASTQ readers and writers (plain or gzip).

Role parity: [U] falcon-kit FastaReader / FastaRandomReader used throughout
the reference's mains (e.g. graphs_to_h_tigs_2, dedup_h_tigs).  Here the
parse target is the tensor data plane (`seq.SeqBatch`) rather than strings.

A native C++ fast path (falcon_unzip_tpu.io.native) is used automatically
for large plain files when the shared library has been built; this pure
Python path is the always-available fallback and the conformance oracle.
"""
from __future__ import annotations

import gzip
import io as _io
import os
from typing import Iterator

import numpy as np

from ..seq import SeqBatch, encode


def _open(path: str):
    if str(path).endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def iter_fasta(path: str) -> Iterator[tuple[str, bytes]]:
    """Yield (name, seq_bytes) from a FASTA file."""
    name = None
    chunks: list[bytes] = []
    with _open(path) as fh:
        for line in fh:
            line = line.rstrip()
            if not line:
                continue
            if line.startswith(b">"):
                if name is not None:
                    yield name, b"".join(chunks)
                name = line[1:].split()[0].decode("ascii")
                chunks = []
            else:
                chunks.append(line)
        if name is not None:
            yield name, b"".join(chunks)


def iter_fastq(path: str) -> Iterator[tuple[str, bytes, bytes]]:
    """Yield (name, seq_bytes, qual_bytes) from a FASTQ file."""
    with _open(path) as fh:
        while True:
            hdr = fh.readline().rstrip()
            if not hdr:
                return
            seq = fh.readline().rstrip()
            fh.readline()  # '+'
            qual = fh.readline().rstrip()
            yield hdr[1:].split()[0].decode("ascii"), seq, qual


def read_fasta(path: str, align: int = 128,
               use_native: bool = True) -> SeqBatch:
    if use_native and not str(path).endswith(".gz"):
        try:
            from . import native
            if native.available():
                return native.read_fasta_native(path, align=align)
        except Exception:
            pass  # fall through to the pure-Python reader
    names, seqs = [], []
    for name, s in iter_fasta(path):
        names.append(name)
        seqs.append(encode(s))
    return SeqBatch.from_strs(seqs, names=names, align=align)


def read_fastq(path: str, align: int = 128) -> tuple[SeqBatch, list[bytes]]:
    import numpy as np
    names, seqs, quals = [], [], []
    for name, s, q in iter_fastq(path):
        names.append(name)
        seqs.append(encode(s))
        quals.append(q)
    batch = SeqBatch.from_strs(seqs, names=names, align=align)
    # per-read mean phred (the QV-aware polish tier reads this) and the
    # raw per-base phred tracks (per-base tier conditioning)
    batch.base_qv = [
        (np.frombuffer(q, np.uint8).astype(np.uint8) - 33) if q
        else np.zeros(0, np.uint8) for q in quals]
    batch.mean_qv = np.array(
        [float(t.mean()) if len(t) else 0.0 for t in batch.base_qv],
        np.float32)
    return batch, quals


def write_fasta(path: str, records, width: int = 80) -> None:
    """records: iterable of (name, seq_str)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        for name, s in records:
            fh.write(f">{name}\n")
            for i in range(0, len(s), width):
                fh.write(s[i : i + width])
                fh.write("\n")


def write_fastq(path: str, records) -> None:
    """records: iterable of (name, seq_str, qual_str)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        for name, s, q in records:
            fh.write(f"@{name}\n{s}\n+\n{q}\n")


def write_batch_fasta(path: str, batch: SeqBatch) -> None:
    names = batch.names or [f"seq/{i}" for i in range(len(batch))]
    write_fasta(path, ((n, batch.to_str(i)) for i, n in enumerate(names)))

"""Unified read ingestion: FASTA / FASTQ / BAM / FOFN -> SeqBatch.

Role parity: [U] falcon_unzip/io.py::yield_bam_fn + the quiver flow's
``input_bam_fofn`` config key (SURVEY.md §2a BAM partitioner row, §3.4
step 2) — the reference polishes from a file-of-filenames of raw subread
BAMs.  Here any mix of FASTA(.gz)/FASTQ(.gz)/BAM files, given directly
or via a .fofn, lands in one packed SeqBatch for the device data plane.
"""
from __future__ import annotations

import os

import numpy as np

from ..seq import PAD, SeqBatch, revcomp, round_up


def _is_fastq(path: str) -> bool:
    p = path.lower()
    return p.endswith((".fastq", ".fq", ".fastq.gz", ".fq.gz"))


def _is_bam(path: str) -> bool:
    return path.lower().endswith(".bam")


def _is_fofn(path: str) -> bool:
    return path.lower().endswith(".fofn")


def read_bam_seqs(path: str) -> SeqBatch:
    """BAM -> SeqBatch of the ORIGINAL reads (reverse records un-flipped).

    Uses the native columnar decoder when built; aligned BAMs store the
    sequence in reference orientation, so flag-16 records are
    reverse-complemented back to read orientation (the reference's
    select_reads path re-extracts reads the same way).
    """
    from . import native
    if native.available():
        cols = native.read_bam_native(path)
        names = cols.names
        seqs = []
        for i in range(len(cols)):
            s = cols.record_seq(i)
            if int(cols.flag[i]) & 16:
                s = revcomp(s)
            seqs.append(s)
    else:
        from .bamlite import read_bam
        bam = read_bam(path)
        names = [r.name for r in bam.records]
        seqs = [revcomp(r.seq) if r.is_reverse else r.seq
                for r in bam.records]
    return SeqBatch.from_strs(seqs, names=names)


def concat_batches(batches: list[SeqBatch]) -> SeqBatch:
    """Stack SeqBatches (repadding to the widest row)."""
    batches = [b for b in batches if len(b)]
    if not batches:
        return SeqBatch(data=np.full((0, 128), PAD, np.int8),
                        lengths=np.zeros(0, np.int32), names=[])
    if len(batches) == 1:
        return batches[0]
    lmax = round_up(max(int(b.lengths.max()) for b in batches), 128)
    n = sum(len(b) for b in batches)
    data = np.full((n, lmax), PAD, np.int8)
    lengths = np.zeros(n, np.int32)
    names: list[str] = []
    at = 0
    for b in batches:
        for i in range(len(b)):
            L = int(b.lengths[i])
            data[at, :L] = b.data[i, :L]
            lengths[at] = L
            at += 1
        names.extend(b.names if b.names else
                     [f"read/{j}" for j in range(len(b))])
    mean_qv = None
    if any(b.mean_qv is not None for b in batches):
        # reads without a quality track get qv 0 = "no information";
        # the QV-aware tier treats <=0 as "use global params"
        mean_qv = np.concatenate([
            b.mean_qv if b.mean_qv is not None
            else np.zeros(len(b), np.float32) for b in batches])
    base_qv = None
    if any(b.base_qv is not None for b in batches):
        base_qv = []
        for b in batches:
            base_qv.extend(b.base_qv if b.base_qv is not None
                           else [np.zeros(0, np.uint8)] * len(b))
    return SeqBatch(data=data, lengths=lengths, names=names,
                    mean_qv=mean_qv, base_qv=base_qv)


def read_seqs(path: str) -> SeqBatch:
    """Any supported input (or .fofn of them) -> one SeqBatch.

    A .fofn fans out across the host dataflow engine
    (parallel.dataflow.Pipeline): files parse on worker threads with
    retry + heartbeat — the pypeFLOW task fan-out role (SURVEY.md §2c
    row 1) applied to the IO-bound ingest edge.  Results are re-ordered
    to fofn order, so the packed batch is identical to a serial parse.
    """
    if _is_fofn(path):
        base = os.path.dirname(os.path.abspath(path))
        paths = []
        with open(path) as fh:
            for line in fh:
                p = line.strip()
                if not p or p.startswith("#"):
                    continue
                if not os.path.isabs(p):
                    p = os.path.join(base, p)
                paths.append(p)
        if len(paths) > 1:
            from ..parallel.dataflow import Pipeline, StageSpec
            pipe = Pipeline([StageSpec(
                "ingest", lambda it: (it[0], read_seqs(it[1])),
                workers=min(4, len(paths)), max_retries=1)])
            results = pipe.run(enumerate(paths))
            parts = [b for _, b in sorted(results, key=lambda r: r[0])]
        else:
            parts = [read_seqs(p) for p in paths]
        return concat_batches(parts)
    if _is_bam(path):
        return read_bam_seqs(path)
    if _is_fastq(path):
        from .fasta import read_fastq
        batch, _ = read_fastq(path)
        return batch
    from .fasta import read_fasta
    return read_fasta(path)

"""Sequence data plane: packed integer base tensors + ragged batching.

TPU-first design: sequences live as dense ``int8`` arrays (A=0, C=1, G=2,
T=3, N/pad=4) with explicit length vectors, never Python strings, so every
downstream op (pileup scatter, match-matrix compare, DP wavefront) is a
fixed-shape vector op.  Ragged read sets are carried as
``(data[N, Lmax], lengths[N])`` padded batches with power-of-two length
buckets to bound pad waste (SURVEY.md §7 "hard parts (a)").

Role parity: replaces the string-based FastaReader/DAZZ_DB sequence access
of the reference stack ([U] falcon-kit FastaReader, DAZZ_DB .db) with a
tensor-native layout.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np

# Base encoding. PAD doubles as "N"/unknown: it never matches anything.
A, C, G, T, PAD = 0, 1, 2, 3, 4
NBASE = 4

_ENCODE = np.full(256, PAD, dtype=np.int8)
for _i, _ch in enumerate("ACGT"):
    _ENCODE[ord(_ch)] = _i
    _ENCODE[ord(_ch.lower())] = _i

_DECODE = np.frombuffer(b"ACGTN", dtype=np.uint8)

# complement: A<->T, C<->G, PAD->PAD
_COMPLEMENT = np.array([T, G, C, A, PAD], dtype=np.int8)


def encode(seq: str | bytes) -> np.ndarray:
    """ASCII sequence -> int8 codes."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    return _ENCODE[np.frombuffer(seq, dtype=np.uint8)]


def decode(codes: np.ndarray, length: int | None = None) -> str:
    """int8 codes -> ASCII string (truncated to ``length`` if given)."""
    codes = np.asarray(codes, dtype=np.int8)
    if length is not None:
        codes = codes[:length]
    return _DECODE[np.clip(codes, 0, 4)].tobytes().decode("ascii")


def revcomp(codes: np.ndarray, length: int | None = None) -> np.ndarray:
    """Reverse complement of an encoded sequence (ignores trailing pad)."""
    codes = np.asarray(codes, dtype=np.int8)
    if length is None:
        length = len(codes)
    out = np.full_like(codes, PAD)
    out[:length] = _COMPLEMENT[codes[:length][::-1]]
    return out


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def bucket_length(n: int, minimum: int = 128) -> int:
    """Power-of-two-ish padded length bucket (128-aligned for TPU lanes)."""
    b = max(minimum, 128)
    while b < n:
        b *= 2
    return b


@dataclasses.dataclass
class SeqBatch:
    """Padded ragged batch of sequences.

    data:    (N, Lmax) int8, PAD beyond each row's length
    lengths: (N,) int32
    names:   optional list of sequence ids (host-side only)
    """

    data: np.ndarray
    lengths: np.ndarray
    names: list[str] | None = None
    mean_qv: np.ndarray | None = None
    # optional (N,) float32 mean phred base quality per read (FASTQ/BAM
    # tracks) — feeds the base-quality-conditioned pair-HMM tier
    # (SURVEY.md §2b variantCaller row); None when the source has no
    # quality track (FASTA)
    base_qv: list | None = None
    # optional per-read np.uint8 PHRED arrays (len == read length) —
    # feeds the PER-BASE tier conditioning in the Arrow splice kernel
    # (real Arrow's IQV/DQV per-base features); None without a track

    def __len__(self) -> int:
        return self.data.shape[0]

    @property
    def lmax(self) -> int:
        return self.data.shape[1]

    def row(self, i: int) -> np.ndarray:
        return self.data[i, : self.lengths[i]]

    def to_str(self, i: int) -> str:
        return decode(self.data[i], int(self.lengths[i]))

    @staticmethod
    def from_strs(
        seqs: Sequence[str | bytes | np.ndarray],
        names: Sequence[str] | None = None,
        pad_to: int | None = None,
        align: int = 128,
    ) -> "SeqBatch":
        rows = [s if isinstance(s, np.ndarray) else encode(s) for s in seqs]
        lengths = np.array([len(r) for r in rows], dtype=np.int32)
        lmax = pad_to if pad_to is not None else round_up(
            max((int(l) for l in lengths), default=1), align)
        lmax = max(lmax, align)
        data = np.full((len(rows), lmax), PAD, dtype=np.int8)
        for i, r in enumerate(rows):
            data[i, : len(r)] = r
        return SeqBatch(data=data, lengths=lengths,
                        names=list(names) if names is not None else None)

    def buckets(self, min_bucket: int = 256) -> dict[int, np.ndarray]:
        """Group row indices by padded-length bucket: {bucket_len: idx[...]}.

        Bounds pad waste to <2x per bucket while keeping a small number of
        distinct compiled shapes.
        """
        out: dict[int, list[int]] = {}
        for i, l in enumerate(self.lengths):
            b = bucket_length(int(l), min_bucket)
            out.setdefault(b, []).append(i)
        return {b: np.array(ix, dtype=np.int32) for b, ix in sorted(out.items())}


def concat_flat(seqs: Iterable[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    """Flatten sequences into (flat_data, offsets); offsets has N+1 entries."""
    rows = [np.asarray(s, dtype=np.int8) for s in seqs]
    offsets = np.zeros(len(rows) + 1, dtype=np.int64)
    np.cumsum([len(r) for r in rows], out=offsets[1:])
    flat = np.concatenate(rows) if rows else np.zeros(0, dtype=np.int8)
    return flat, offsets

"""Minimal BGZF + BAM codec (pure Python + zlib, no pysam/htslib).

Role parity: [U] samtools/htslib + pysam usage across the reference —
BAM iteration for phasing pileups ([U] phasing.py) and the two-stage BAM
partitioner ([U] mains/select_reads_from_bam.py, SURVEY.md §2a).  The
environment has no pysam (SURVEY.md §7 hard part (e)), so this module
implements the subset the pipeline needs: BGZF block framing, BAM header
+ alignment record decode (name, flag, ref, pos, CIGAR, seq, qual), and
a writer able to emit valid BAM files for per-contig partitions.

The on-device data plane never touches BAM — records are converted to
packed int8 tensors at this boundary.
"""
from __future__ import annotations

import dataclasses
import struct
import zlib
from typing import Iterator

import numpy as np

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")

# BAM 4-bit base nibbles "=ACMGRSVTWYHKDBN" -> our int8 codes (PAD=4)
_NIB2CODE = np.full(16, 4, dtype=np.int8)
_NIB2CODE[1] = 0  # A
_NIB2CODE[2] = 1  # C
_NIB2CODE[4] = 2  # G
_NIB2CODE[8] = 3  # T
_CODE2NIB = np.array([1, 2, 4, 8, 15], dtype=np.uint8)

CIGAR_OPS = "MIDNSHP=X"


# ---------------------------------------------------------------------------
# BGZF
# ---------------------------------------------------------------------------

def bgzf_decompress(path: str) -> bytes:
    """Decode all BGZF blocks of a file into one bytes blob."""
    out = []
    with open(path, "rb") as fh:
        data = fh.read()
    pos = 0
    n = len(data)
    while pos < n:
        if data[pos : pos + 2] != b"\x1f\x8b":
            raise ValueError(f"not a BGZF block at offset {pos}")
        xlen = struct.unpack_from("<H", data, pos + 10)[0]
        extra = data[pos + 12 : pos + 12 + xlen]
        bsize = None
        e = 0
        while e < len(extra):
            si1, si2, slen = extra[e], extra[e + 1], struct.unpack_from(
                "<H", extra, e + 2)[0]
            if si1 == 66 and si2 == 67:
                bsize = struct.unpack_from("<H", extra, e + 4)[0] + 1
            e += 4 + slen
        if bsize is None:
            raise ValueError("missing BGZF BC subfield")
        comp = data[pos + 12 + xlen : pos + bsize - 8]
        out.append(zlib.decompress(comp, wbits=-15))
        pos += bsize
    return b"".join(out)


def bgzf_compress(payload: bytes, level: int = 6) -> bytes:
    """Encode a blob as BGZF blocks (<=64KB payload each) + EOF block."""
    out = []
    for i in range(0, len(payload), 0xFF00):
        chunk = payload[i : i + 0xFF00]
        co = zlib.compressobj(level, zlib.DEFLATED, -15)
        comp = co.compress(chunk) + co.flush()
        bsize = len(comp) + 25 + 1
        block = (b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
                 + struct.pack("<H", 6)
                 + b"BC" + struct.pack("<H", 2)
                 + struct.pack("<H", bsize - 1)
                 + comp
                 + struct.pack("<I", zlib.crc32(chunk))
                 + struct.pack("<I", len(chunk)))
        out.append(block)
    out.append(BGZF_EOF)
    return b"".join(out)


# ---------------------------------------------------------------------------
# BAM records
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BamRecord:
    name: str
    flag: int
    ref_id: int
    pos: int                 # 0-based leftmost
    mapq: int
    cigar: list[tuple[int, int]]     # (op_len, op_idx into CIGAR_OPS)
    seq: np.ndarray          # int8 codes (our encoding)
    qual: np.ndarray         # uint8 phred, 0xFF if absent

    @property
    def is_unmapped(self) -> bool:
        return bool(self.flag & 4)

    @property
    def is_reverse(self) -> bool:
        return bool(self.flag & 16)


@dataclasses.dataclass
class BamFile:
    text: str
    refs: list[tuple[str, int]]      # (name, length)
    records: list[BamRecord]


def read_bam(path: str) -> BamFile:
    blob = bgzf_decompress(path)
    if blob[:4] != b"BAM\x01":
        raise ValueError("missing BAM magic")
    off = 4
    l_text = struct.unpack_from("<i", blob, off)[0]; off += 4
    text = blob[off : off + l_text].decode("ascii", "replace"); off += l_text
    n_ref = struct.unpack_from("<i", blob, off)[0]; off += 4
    refs = []
    for _ in range(n_ref):
        l_name = struct.unpack_from("<i", blob, off)[0]; off += 4
        name = blob[off : off + l_name - 1].decode("ascii"); off += l_name
        l_ref = struct.unpack_from("<i", blob, off)[0]; off += 4
        refs.append((name, l_ref))
    records = []
    n = len(blob)
    while off < n:
        block_size = struct.unpack_from("<i", blob, off)[0]; off += 4
        end = off + block_size
        (ref_id, pos, l_rn, mapq, _bin, n_cig, flag, l_seq,
         _nref, _npos, _tlen) = struct.unpack_from("<iiBBHHHiiii", blob, off)
        o = off + 32
        name = blob[o : o + l_rn - 1].decode("ascii"); o += l_rn
        cigar = []
        for k in range(n_cig):
            v = struct.unpack_from("<I", blob, o)[0]; o += 4
            cigar.append((v >> 4, v & 0xF))
        nseq = (l_seq + 1) // 2
        packed = np.frombuffer(blob[o : o + nseq], dtype=np.uint8); o += nseq
        nib = np.empty(nseq * 2, dtype=np.uint8)
        nib[0::2] = packed >> 4
        nib[1::2] = packed & 0xF
        seq = _NIB2CODE[nib[:l_seq]]
        qual = np.frombuffer(blob[o : o + l_seq], dtype=np.uint8).copy()
        o += l_seq
        records.append(BamRecord(name=name, flag=flag, ref_id=ref_id,
                                 pos=pos, mapq=mapq, cigar=cigar,
                                 seq=seq, qual=qual))
        off = end
    return BamFile(text=text, refs=refs, records=records)


def write_bam(path: str, bam: BamFile) -> None:
    out = [b"BAM\x01"]
    text = bam.text.encode("ascii")
    out.append(struct.pack("<i", len(text)))
    out.append(text)
    out.append(struct.pack("<i", len(bam.refs)))
    for name, l_ref in bam.refs:
        nb = name.encode("ascii") + b"\x00"
        out.append(struct.pack("<i", len(nb)))
        out.append(nb)
        out.append(struct.pack("<i", l_ref))
    for r in bam.records:
        nb = r.name.encode("ascii") + b"\x00"
        l_seq = len(r.seq)
        nib = _CODE2NIB[np.clip(r.seq, 0, 4)]
        if l_seq % 2:
            nib = np.concatenate([nib, np.zeros(1, np.uint8)])
        packed = ((nib[0::2] << 4) | nib[1::2]).astype(np.uint8)
        qual = r.qual if len(r.qual) == l_seq else np.full(
            l_seq, 0xFF, np.uint8)
        body = (struct.pack("<iiBBHHHiiii", r.ref_id, r.pos, len(nb),
                            r.mapq, 0, len(r.cigar), r.flag, l_seq,
                            -1, -1, 0)
                + nb
                + b"".join(struct.pack("<I", (ln << 4) | op)
                           for ln, op in r.cigar)
                + packed.tobytes()
                + qual.astype(np.uint8).tobytes())
        out.append(struct.pack("<i", len(body)))
        out.append(body)
    payload = b"".join(out)
    try:  # multithreaded C++ BGZF encoder when built (io.native)
        from .native import available, bgzf_compress_native
        blob = bgzf_compress_native(payload) if available() else \
            bgzf_compress(payload)
    except Exception:
        blob = bgzf_compress(payload)
    with open(path, "wb") as fh:
        fh.write(blob)


def iter_bam(path: str) -> Iterator[BamRecord]:
    yield from read_bam(path).records


def select_reads_by_contig(path: str, read_to_ctg: dict[str, int],
                           out_pattern: str, n_ctg: int) -> list[str]:
    """Partition a BAM into per-contig BAMs (select_reads_from_bam role).

    out_pattern: e.g. "part/ctg_{}.bam".  Unassigned reads are dropped.
    The read->contig-owner routing runs through the mesh all_to_all
    regroup (parallel.collectives.regroup_partition — the reference's
    `max_n_open_files` two-stage partition re-mapped per SURVEY.md §2c
    row 5); records land in input order, so the output bytes match a
    host scan exactly.  Partitions are buffered in memory (columnar
    framework scale; no open-file budget needed).
    """
    import numpy as np

    from ..parallel.collectives import regroup_partition

    bam = read_bam(path)
    ctg_ids = np.array([read_to_ctg.get(rec.name, -1)
                        for rec in bam.records], np.int64)
    outs = []
    for ctg, idx in enumerate(regroup_partition(ctg_ids, n_ctg)):
        if not len(idx):
            continue
        out_path = out_pattern.format(ctg)
        write_bam(out_path, BamFile(text=bam.text, refs=bam.refs,
                                    records=[bam.records[i] for i in idx]))
        outs.append(out_path)
    return outs

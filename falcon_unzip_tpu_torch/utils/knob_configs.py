"""Knob groups of ``PipelineConfig``, shared by the knob-parity tests and
``chip_smoke.py``.

Each group is a ``{section: {key: value}}`` overlay on the golden fixture
of ``tests/test_golden.py`` (a 6 kb diploid, 2% het, seeds 77-79), run
through the stages it names (a 4-polish-only group starts from the
default run's 3-unzip).  Its kind says what it is held to against the
baseline run of its inputs (the default config on the same inputs):

- *execution* groups change how the work is cut, never what it computes:
  every artifact equals the baseline's;
- *semantic* groups change what is computed: at least one artifact
  differs from the baseline's;
- *baseline* runs are the default config on each of the three inputs:
  the golden fixture (``default``); its raw reads replaced by a fofn of
  a FASTQ with per-base quality tracks and a FASTA without
  (``fofn``); the default 3-unzip with its haplotigs removed, a draft
  polished alone (``collapsed``).

``DIGESTS`` holds what the JAX package wrote for each run, and
``QV_TRACKS`` its consensus QV lines; ``tests/test_torch_knobs_*.py``
hold both packages to them on the CPU (run as scripts, they print them
anew from the JAX package), ``chip_smoke.py`` holds the port on the card
to them.  ``BAND_GROUPS`` are smoke phase 3e's two band configurations,
held to their digests only.

Values that act on their own on this fixture were picked where one
exists.  Knobs that change nothing on their own at the chosen values:

- ``align.max_hits``: read by neither package's pipeline, which builds
  ``AlignerConfig`` without it (the aligner keeps its own 64);
- ``align.k = 15`` and ``align.window_pad = 8``: the preads are
  error-free, so k = 11 and 15 seed the same placements and they align
  end to end inside any pad (in 4-polish, on the 3% raw reads, k = 11,
  15, 19 and 21 give the same alignments too, and a pad of 8 changes
  them);
- ``overlap.k = 15``: the same candidates as 13 from error-free preads
  (9 changes them, at twice the run time);
- ``overlap.end_fuzz = 30``: error-free overlaps end at the read ends,
  so any fuzz from 1 keeps them (0 drops the haplotig);
- ``graph.max_bubble_steps = 8``: the phase-filtered graph of this
  fixture has no branch to walk (0, 1 and 8 all leave it unchanged);
- ``polish.arrow_candidates = 12``: the candidate queue cycles in full
  whatever its chunk, so the same mutations are accepted (it reaches the
  Arrow sweeps' wide build on the card);
- ``polish.hmm_band`` is stored in ``PolisherConfig`` and read nowhere;
  ``polish.score_batch`` is read only by the re-forward scorer's
  ``Polisher._score_pairs``, which no pipeline path injects;
- ``polish.phase_aware = false`` on the golden fixture: every raw read
  maps to its own haplotype's contig, so the routing drops none (on the
  collapsed draft it drops 25 records and moves the QVs);
- ``overlap.prefetch``, ``align.batch_pairs`` and ``polish.splice_chunk``
  move work between threads and launches (execution groups by design).
"""
from __future__ import annotations

import base64
import contextlib
import dataclasses
import hashlib
import json
import os
import shutil
import zlib

import numpy as np

from .fixtures import run_artifacts


@dataclasses.dataclass(frozen=True)
class KnobGroup:
    name: str
    kind: str           # "baseline", "execution", "semantic" (or "band")
    stages: tuple       # ("unzip",), ("quiver",) or ("unzip", "quiver")
    sections: dict      # {section: {key: value}} over the default config
    inputs: str = "golden"      # "golden", "fofn" or "collapsed"


# the baseline run of each input
BASELINE = {"golden": "default", "fofn": "fofn", "collapsed": "collapsed"}

GROUPS = (
    KnobGroup("default", "baseline", ("unzip", "quiver"), {}),
    # 4-polish's raw reads as a fofn of a FASTQ with per-base quality
    # tracks and a FASTA without (the fofn fan-out; reads with no track
    # take tier 0 when qv_aware)
    KnobGroup("fofn", "baseline", ("quiver",), {}, inputs="fofn"),
    # a draft polished with no haplotig beside it: both phases' reads map
    # to it, so the phase routing drops records
    KnobGroup("collapsed", "baseline", ("quiver",), {}, inputs="collapsed"),
    # wavefront and traceback at P = 24, every bucket's last chunk ragged
    KnobGroup("align_exec", "execution", ("unzip", "quiver"),
              {"align": {"batch_pairs": 24, "max_hits": 8}}),
    KnobGroup("align_sem", "semantic", ("unzip",),
              {"align": {"k": 15, "window_pad": 8, "min_identity": 0.985}}),
    KnobGroup("overlap_sem", "semantic", ("unzip",),
              {"overlap": {"k": 15, "min_overlap": 1000, "min_identity": 0.99,
                           "end_fuzz": 30, "max_diff": 5, "bestn": 3}}),
    # dedup's alignments (it drops the haplotig at 0.95)
    KnobGroup("graph_sem", "semantic", ("unzip",),
              {"graph": {"reduction_fuzz": 0, "max_bubble_steps": 8,
                         "dedup": True, "dedup_max_identity": 0.95},
               "phase": {"min_link": 20}}),
    # the overlap shard on the main thread
    KnobGroup("no_prefetch", "execution", ("unzip",),
              {"overlap": {"prefetch": False}}),
    # the Arrow sweeps at P = 12 (the default's 16 pairs in two launches,
    # the last one ragged), the 8-warp build (P <= 132)
    KnobGroup("polish_exec", "execution", ("quiver",),
              {"polish": {"splice_chunk": 12, "score_batch": 1024,
                          "hmm_band": 32}}),
    # the Arrow sweeps' wide build (C = 12) at LJ = len_cap() = 768
    KnobGroup("polish_sem", "semantic", ("quiver",),
              {"polish": {"window": 512, "overlap": 96,
                          "arrow_candidates": 12, "del_min_cov": 3,
                          "arrow_min_cov": 3, "het_skip_frac": 0.5}}),
    # the Arrow sweeps' per-base tier mode through run_quiver
    KnobGroup("qv_per_base", "semantic", ("quiver",),
              {"polish": {"qv_aware": True}}, inputs="fofn"),
    KnobGroup("phase_unaware", "semantic", ("quiver",),
              {"polish": {"phase_aware": False}}, inputs="collapsed"),
)
# smoke phase 3e's band configurations (the wavefront at each configured
# width and at placement's max(512, band))
BAND_GROUPS = (
    KnobGroup("align384_overlap200", "band", ("unzip", "quiver"),
              {"align": {"band": 384}, "overlap": {"band": 200}}),
    KnobGroup("align768", "band", ("unzip", "quiver"),
              {"align": {"band": 768}}),
)
BY_NAME = {g.name: g for g in GROUPS + BAND_GROUPS}

# What each stage writes that the comparison reads: every 3-unzip file
# (among them the 1-align AlnSet, 1-align/aln_set.msgpack, and the
# OverlapSet, preads.ovl), and every 4-polish file (the consensus, the
# 1-track AlnSet and the read map).
PATTERNS = {"unzip": ("3-unzip/**/*",),
            "quiver": ("4-polish/**/*",)}

def write_inputs(d: str) -> None:
    """Every input of the groups in d: the golden fixture (preads.fa,
    raw.fa, draft.fa with the draft contig named d0) and the fofn
    input's raw reads: the same diploid's 20x reads at 3% with the
    hotspot quality profile, half reverse-complemented (seed 80), the
    first half as raw_q.fastq with their per-base tracks and the rest as
    raw_n.fa, listed in raw.fofn."""
    from ..io.fasta import write_fasta, write_fastq
    from ..seq import decode
    from .simulate import make_diploid, simulate_reads
    os.makedirs(d, exist_ok=True)
    dip = make_diploid(length=6000, het_rate=0.02, seed=77,
                       het_span=(0.3, 0.7))
    pr = simulate_reads(dip, coverage=14.0, read_len=1800, error_rate=0.0,
                        seed=78)
    raw = simulate_reads(dip, coverage=16.0, read_len=1500, error_rate=0.03,
                         seed=79)
    for fn, b in (("preads.fa", pr.batch), ("raw.fa", raw.batch)):
        write_fasta(f"{d}/{fn}", ((b.names[i], b.to_str(i))
                                  for i in range(len(b))))
    write_fasta(f"{d}/draft.fa", [("d0", decode(dip.hap0))])
    hot = simulate_reads(dip, coverage=20.0, read_len=1500, error_rate=0.03,
                         seed=80, rc_frac=0.5, qv_profile="hotspot")
    b, half = hot.batch, len(hot.batch) // 2
    write_fastq(f"{d}/raw_q.fastq",
                ((b.names[i], b.to_str(i),
                  (hot.quals[i] + 33).tobytes().decode("latin1"))
                 for i in range(half)))
    write_fasta(f"{d}/raw_n.fa", ((b.names[i], b.to_str(i))
                                  for i in range(half, len(b))))
    with open(f"{d}/raw.fofn", "w") as fh:
        fh.write("raw_q.fastq\nraw_n.fa\n")


def run_config(group: KnobGroup, d: str, out_dir: str) -> dict:
    """group's run on the inputs in d, writing to out_dir, as the
    sections of a run.json (``load_config``'s JSON form)."""
    reads = "raw.fofn" if group.inputs == "fofn" else "raw.fa"
    run = {"preads": f"{d}/preads.fa", "draft": f"{d}/draft.fa",
           "reads": f"{d}/{reads}", "out_dir": out_dir}
    run.update(group.sections)
    return run


def configure(cfg, group: KnobGroup, d: str, out_dir: str):
    """cfg (either package's PipelineConfig) set to ``run_config``."""
    for key, val in run_config(group, d, out_dir).items():
        if isinstance(val, dict):
            sec = getattr(cfg, key)
            for k, v in val.items():
                if not hasattr(sec, k):
                    raise KeyError(f"[{key}] {k}")
                setattr(sec, k, v)
        else:
            setattr(cfg, key, val)
    return cfg


def seed_unzip(group: KnobGroup, default_out: str, out_dir: str) -> None:
    """The 3-unzip a 4-polish-only group starts from: a copy of the
    default run's, without its haplotigs for the collapsed input."""
    shutil.copytree(f"{default_out}/3-unzip", f"{out_dir}/3-unzip")
    if group.inputs == "collapsed":
        open(f"{out_dir}/3-unzip/all_h_ctg.fa", "w").close()


def _canonical(rel: str, data: bytes) -> bytes:
    """A file's bytes in a form that does not depend on whether msgpack is
    installed (without it ``.msgpack`` files are JSON)."""
    if not rel.endswith(".msgpack"):
        return data
    from ..io.serialize import HAVE_MSGPACK, unpackb
    if rel.endswith("aln_set.msgpack"):
        from ..parallel.distributed import unpack_arrays
        cols = unpack_arrays(data)
        return json.dumps({k: [str(v.dtype), list(v.shape),
                               hashlib.sha256(v.tobytes()).hexdigest()]
                           for k, v in cols.items()}, sort_keys=True).encode()
    obj = unpackb(data) if HAVE_MSGPACK else json.loads(data)
    return json.dumps({str(k): v for k, v in obj.items()},
                      sort_keys=True).encode()


def snapshot(out_dir: str, stage: str) -> dict:
    """What ``stage`` ("unzip" or "quiver") wrote under out_dir:
    {"files": digest, "qv": digest, "qv_lines": {fastq: QV lines}}.
    "files" covers every file of ``PATTERNS[stage]`` byte for byte (stage
    markers without wall time and fingerprint, msgpack files decoded)
    except the consensus QVs, which "qv" covers: the fastq QV lines and
    the mean QV in 2-polish's marker.  The QV lines are kept whole, since
    the card's float sweeps may move a truncated QV by one."""
    files, qvs = hashlib.sha256(), hashlib.sha256()
    qv_lines = {}
    for rel, data in sorted(run_artifacts(out_dir, PATTERNS[stage]).items()):
        if rel.endswith(".fastq"):
            lines = data.decode().splitlines()
            qv_lines[rel] = lines[3::4]
            qvs.update(rel.encode() + b"\0"
                       + "\n".join(lines[3::4]).encode() + b"\0")
            data = "\n".join(lines[i] for i in range(len(lines))
                             if i % 4 != 3).encode()
        elif rel.endswith("2-polish/stage.done.json"):
            meta = json.loads(data)
            qvs.update(repr(meta["metrics"].pop("mean_qv")).encode())
            data = json.dumps(meta, sort_keys=True).encode()
        files.update(rel.encode() + b"\0" + _canonical(rel, data) + b"\0")
    return {"files": files.hexdigest()[:16], "qv": qvs.hexdigest()[:16],
            "qv_lines": qv_lines}


EMPTY_QV = hashlib.sha256().hexdigest()[:16]


def qv_diffs(got: dict, want: dict) -> int:
    """The number of consensus QVs that differ between two snapshots'
    QV lines; raises ValueError if any differs by more than 1 or their
    shapes differ."""
    if sorted(got) != sorted(want):
        raise ValueError(f"fastq files {sorted(got)} != {sorted(want)}")
    n = 0
    for rel in want:
        if [len(s) for s in got[rel]] != [len(s) for s in want[rel]]:
            raise ValueError(f"{rel}: QV line lengths differ")
        for a, b in zip(got[rel], want[rel]):
            d = np.abs(np.frombuffer(a.encode(), np.uint8).astype(int)
                       - np.frombuffer(b.encode(), np.uint8).astype(int))
            if d.max(initial=0) > 1:
                raise ValueError(f"{rel}: a QV differs by {d.max()}")
            n += int((d > 0).sum())
    return n


def expected(name: str, stage: str) -> dict:
    """The JAX package's snapshot of run ``name``'s stage as stored:
    {"files", "qv", "qv_lines"} ("qv" and "qv_lines" empty for 3-unzip)."""
    want = DIGESTS[name][stage]
    if stage == "unzip":
        return {"files": want, "qv": EMPTY_QV, "qv_lines": {}}
    files, qv = want
    lines = json.loads(zlib.decompress(base64.b64decode(QV_TRACKS[qv])))
    return {"files": files, "qv": qv, "qv_lines": lines}


def check(name: str, stage: str, out_dir: str) -> int:
    """What ``stage`` wrote under out_dir against the JAX package's stored
    snapshot of run ``name``: the files' digest equal and every consensus
    QV within 1 (ValueError otherwise, naming each file's digest).
    Returns the number of QVs that differ."""
    got, want = snapshot(out_dir, stage), expected(name, stage)
    if got["files"] != want["files"]:
        files = {rel: hashlib.sha256(b).hexdigest()[:16] for rel, b in
                 run_artifacts(out_dir, PATTERNS[stage]).items()}
        raise ValueError(f"{name} {stage}: digest {got['files']}, the JAX "
                         f"package's {want['files']}; the files' {files}")
    return qv_diffs(got["qv_lines"], want["qv_lines"])


def stored(snap: dict, stage: str):
    """A snapshot in ``DIGESTS``'s form, and its QV lines in
    ``QV_TRACKS``'s (None for 3-unzip)."""
    if stage == "unzip":
        return snap["files"], None
    blob = base64.b64encode(zlib.compress(json.dumps(
        snap["qv_lines"], sort_keys=True).encode(), 9)).decode()
    return (snap["files"], snap["qv"]), [blob[i : i + 68]
                                          for i in range(0, len(blob), 68)]


@contextlib.contextmanager
def launch_log():
    """The shapes of the banded wavefront's and the Arrow sweeps' card
    launches made inside the block: {"wavefront": [(P, W)], "arrow": [(P,
    warps a block, C, LJ, per-base tier mode)]}."""
    from ..ops import _kernels
    log = {"wavefront": [], "arrow": []}
    wavefront, sweeps = _kernels.banded_wavefront, _kernels.arrow_sweeps

    def spy_wavefront(qg, *a, **kw):
        log["wavefront"].append((qg.shape[0], kw["W"]))
        return wavefront(qg, *a, **kw)

    def spy_sweeps(q, t, n, m, cand, pvec, qt, tiers, *, C):
        P = q.shape[0]
        log["arrow"].append((P, _kernels.arrow_warps(P, q.device), C,
                             t.shape[1], qt is not None))
        return sweeps(q, t, n, m, cand, pvec, qt, tiers, C=C)
    _kernels.banded_wavefront = spy_wavefront
    _kernels.arrow_sweeps = spy_sweeps
    try:
        yield log
    finally:
        _kernels.banded_wavefront, _kernels.arrow_sweeps = wavefront, sweeps


def missed_build(name: str, log: dict) -> str | None:
    """What group ``name`` exists to launch on the card and ``log``
    (``launch_log``'s) lacks, or None: the wavefront at P=24
    (align_exec), the Arrow sweeps at P=12 in the 8-warp build in two
    launches or more (polish_exec), their wide build at C=12 and LJ=768
    (polish_sem), their per-base tier mode (qv_per_base)."""
    arrow = log["arrow"]
    need = {
        "align_exec": 24 in {p for p, _ in log["wavefront"]},
        "polish_exec": len(arrow) >= 2
        and {(p, w) for p, w, _, _, _ in arrow} == {(12, 8)},
        "polish_sem": (12, 768) in {(c, lj) for _, _, c, lj, _ in arrow},
        "qv_per_base": any(tier for *_, tier in arrow)}
    if need.get(name, True):
        return None
    return f"{name} did not reach its build: {log}"


# {run: {"unzip": files digest, "quiver": (files digest, QV digest)}}
# from the JAX package (``snapshot``)
DIGESTS: dict = {
    'default': {'unzip': 'a75f8413cc4dba47',
                'quiver': ('6c27c497cb639d83', '6afb5f2700b14cd3')},
    'fofn': {'quiver': ('1e5d5f490c575e67', 'd4bdac6e8c33078e')},
    'collapsed': {'quiver': ('3e71da4cba03657a', '226b15c986ef28f1')},
    'align_exec': {'unzip': 'a75f8413cc4dba47',
                   'quiver': ('6c27c497cb639d83', '6afb5f2700b14cd3')},
    'align_sem': {'unzip': '47f3543a0370b873'},
    'overlap_sem': {'unzip': 'f7ae97e70db13840'},
    'graph_sem': {'unzip': '0bb1bbc723389e21'},
    'no_prefetch': {'unzip': 'a75f8413cc4dba47'},
    'polish_exec': {'quiver': ('6c27c497cb639d83', '6afb5f2700b14cd3')},
    'polish_sem': {'quiver': ('5ea88914d37a7380', '5f60691b6675d79a')},
    'qv_per_base': {'quiver': ('44bdc55f65acdbac', '12e3263a13227a82')},
    'phase_unaware': {'quiver': ('3e71da4cba03657a', '843482f46f10e82b')},
    'align384_overlap200': {
        'unzip': 'a75f8413cc4dba47',
        'quiver': ('6c27c497cb639d83', '6afb5f2700b14cd3')},
    'align768': {'unzip': 'a75f8413cc4dba47',
                 'quiver': ('6c27c497cb639d83', '6afb5f2700b14cd3')},
}
# {QV digest: the QV lines, zlib-compressed JSON in base64}
QV_TRACKS: dict = {
    '6afb5f2700b14cd3': (
        'eNrtWtuK2zAQ/ZWyz71QKAZ3+yLchyoDhjXm6KGUpSy0Wyjtlt230n9vYsuWRhrJdrJJ'
        '9pIhsa2RNLo4njNznL9n717d/P754/b6zdWv28vry6u776+/fb29+3P2/sXnM/2UhXop'
        'KRar+7RETGUEWfUn5R1HWRfHPkqFPZUJuyqTEK+pYqZsXyX1pLQdK7VUrKOa2r+q+0On'
        'dBX9Mon4+CRNhXiJuo8wbxIWlDdI/Ve5NjRjTwYT5KpVZts286WcOYoqgvVyw5Sb12zx'
        '+iPZaKjRfQnQXA+40nBct8JQQGC7V+jsoKM1iM2AsGU/iC1oeVXIqDF2R3pHIE8huYjR'
        'HmIDOrXDfLuG3pBns1GHVVaFxHx0vMnJRfZjaD4h7S7Bl7dIWvvNb6EwP7gV29uu3bbB'
        'zcx+wc2ALWOsRK/Sk0/DtGCugXanZxezLGPBBWQ95nsTCpwZhb7Gw4QAHmKprLIIME5F'
        'IBj6XdXrVQSfanoRKoG8knMPkb2KLsTinCkoaez1nlW1gLw138iawW9t9iPgvg3STy72'
        'Zff7DCySJr5qotpmqu+jkmaHts22ttqj3OD2cPbbhza5drtx/cjMi57WIAgXhgjhgQ+/'
        'm0gvilogBTyZqa222ieIRfDYAZrXbQHstFukPWQZfgivxBCcxLHGBMPPHyg/FMtLagcR'
        'm8tKzOUGOK4ziR4DbYc0dQ6OfRT9qBgmVpUHjDFEVpPwWU1qWCJeRKm5nOQn0v4yxQaU'
        'pV9Z5q14pdJqSqG+zHUvZ5jvyoN9fZKTnGSfcvbl5QvOmd48I8408Dyl7L+mnG3MnRbW'
        'aReBCx/0m9PbwLcXgc8v0v4/Gi0FFgsSNzPmnt2xtGeVJHQ7RekpyuGgYhAmTgWSclm2'
        'zy6ue573AUeQk0ctjVBLCZIwzxbTJF1q5rHNxudUTSLIw2yWZXEcvYqC0fZgAf3qgNnQ'
        'AVPveeE87v1WCjoYgbaeYKNnEn42cwqp6yFdAvZ+S7OpfbMonwdMwPQyjhUhi+0zqUnG'
        'HDGzix1/NIKN1TZkrHU4yP0wI0IfUVo5ktMIGTE9+RbDvogYbGuZp0WSuZ90rps5ddNQ'
        'Io+HaNvaY7iJR8q1LZt/k2t9TzvAXs2027mX9lDblVvzxQO5l82OsE3b3kaoAV8CHHHw'
        'ErpWRu7p0C0j6jGcfdfgPJCGgwAEPTJ8HyD5aYSvJ1X0wqADH8Hb6tD3IfalH4TF4Xju'
        'gByzR7nQdgkV6Uf8PitIbEtJjudrOdSn6cHDvycwtnIgHVXchDfjXYxHbaq9PUMpyOV4'
        'Bxm2wbpDiuMgojKC2ECOAAGDqQAYUvgY/GUBLmawGA/vQcZRH4IjhwUX5iT7ktPePtM7'
        'pIO/Nmk58dO2yuUZGnH+Zp2f9vwUprKcFBRQ/Bat8pCvTv8dQ5kk16XkoqPz0uBVnQvv'
        'qhKKSmrTnT1usphBYhb9Cy5Oupale+X09Bn5f/8Bq2Cnvw=='),
    'd4bdac6e8c33078e': (
        'eNrtGu9r1DD0Xxn3RRhTEc6OevghBrS9QG6WkseUY8hAJ4hOtm/i/26Sps17adJ27m6e'
        '2rc1yfuRl7SX5v1IfyyWj6+/ffl8c/X08uvNxdXF5e2nJx8/3Nx+X7w4er8oZ5hhHASF'
        'XBQtZPrPNXDV1c8KRMg6DkSAY4QxjLirQ0MmAmkuaSsIOdLxMVFDb3DSASs2IJpCNI0O'
        'BGIKT3NtfTuPzC3ZfyZYw2O2tihkTt72YKIEpUxHXTNlEH2Va4B6XevCcGp7HR/r2tLW'
        'teFZFqw1aQsjsIYpUMGOoNr7CL+hcg9jzzDDn4cisbaLSb1V2ygVIijwmKKNEW3qEB5J'
        'aecybcpTdo4q2EAedi95O6/xf++VnR8BwMb+A7jKFBtD2xQtvRVxaLGJP8KN7VcgvKmI'
        '2hlm+O+gHqPVcY8AGU4bnag2/iqTPkRjbhXpqVq6Cs2xIoKkWVIpRXAv2yoo/QS820I1'
        'hi6MGriHng/jZuqG3p9/I0jVthmOSWU0dEURLgwLRFRI20sSARQmyyAuRwE5jsZfxojM'
        'oSwM3L1GzvU4r1xErhF9nXKcJeDwBmUMTLnifNUgK0R13V3DwMrUONxv5E9XPJqN4InM'
        'QKc9Io+n2TQLBFkRgqdkfWYrkQ0oIKSMJGWSslE+TfGIHhrQ0vS8p+LvSXUttidHNGd6'
        'fWA50+bBJvJmdCHy1LbCE3Vk+U4AHibuUPYu/p73iWwQDzAWY6+SWjvx1x0hNitGt0uZ'
        '3h/3DmIgmvamWIWWixg4YwLLiCV1RTnBKcBR7ZwqOwSQQ0tydJmeAWwJBtth6RlmmGGG'
        'g4bqXtapmmDdqrsr3InBrHYykaBdjc60us8U99Snl4tQvZwEjtVVNJL3Xo9CaYnS5yOi'
        'fab6aYLUpkRuukj5duggmbj1SfsuBw29jHoD9OS7OYlmEB5xd3J38Hc76c5xll4NHVZK'
        'jhMWsu+zRFxuqXv1ogzZDYJTEUuWmzLPc2bAlHlu7tYSctB/pjAcaETMU3AFGKbm6EIr'
        '0gKmubSlFTdcsGrBtvOlGaDhRUMK5oOj8UhqNTXe4iOBXDJzwXoJIZTkkekRpF8jjShH'
        'v237CwW5HZqkwt9vsIEIMKBxIDmnBLBUMBdd+EDzZjJ2z5KS3K3KaW52Kq2G3n4BzG0O'
        'dBsQya0ulqdUu9piq+Ewr9rXJn44MJ8C3ctDOtRjS/stVE2yGmuf6Sj1W6jce/iufUW1'
        'KT43L6I4Cb7vQhYdIUKcIdudnMjDnNSLB1Es2l0Xn0uMDc1i7o0A/DQ7f0nENkK/W7Jw'
        'UoJKiN6k0Od6IrHjyojJYNhXiposHjSaKvaxI03gD6XlU7g/GcgGzgEwUQxAPkrK40ju'
        '6zyU2l+++/li+/MXeVu7Jg=='),
    '226b15c986ef28f1': (
        'eNrtmM8LgjAUx/8V8dyPSwjWSXZpDIoOPQ8hEkIZRBl6i/731LXaYqmJSdn7qHvb3pyi'
        '2x77ns1RPzrud3E4DA6xH/pBsh1s1nFyMsfGyusZqj9S/SbtMEzBtpnNps9Y6VGM+4AI'
        'Q+SiZO8N3InsULN5gWgdukqiedI7MJYbJ89X7gcgTahUQUUCpffOa7kQBEG6Cv29V4b2'
        'Pg6IEIX84/9HkOaHIbQ9ynHCFPN1Kzz7xZdueZw2OqiXOAkQpAZdk04Wn9pmgbRmgbrt'
        'AqWZULP4ReGpGWQn3Pu8uQFKFsVXIYXrcIqXy3AznpIKAcgpiU2i6DjlwYtMNDrgiwqi'
        'a5NbSUktElIt2WZirKrM8mKW0o5jepcrK27nzQ=='),
    '5f60691b6675d79a': (
        'eNrtWm1r2zAQ/iulX9d1GxSDNxgI78OUA0ODefRhjDEKWwdj62i/jf33JbZsSaeTbCdN'
        '0pcciW2dpNOL43vuHufv6cXLm98/f9xev7r6dfvl+svV3ffzb19v7/6cvj35dKqfslAn'
        'JcVidR/niKmMIGV3Ut5xEDVUr64V76kM76pMQrymKjBl+yqpJ6XtWKmlYh3V1P5V3R1a'
        'pavotoYoHJ+kqVBYovYjzJuEBeUNUvdVrg1N2JPeBLlqldm29XwpZ46iCrbe0DDl5jVZ'
        'vP5INuprdFcCdKgHXKk/rlqhL4DZ7hQ6O+hgDWIzgLfsBrEFLa8KGTWG7kjvCOQpJBcx'
        '2ENsQKd2ONyuvjfk2azVvMqqkJiPjjc5uchuDB1OSLtLhMubJY395rdQmB/ciu1t127b'
        '4GZmvwjNIFjGUIlOpUefhnHBVAPNVs8uJlnGjAvIekz3JsScGXFf42ECg4dYKqssGMap'
        'CAS531WdXkXwqcYXoRLIKzl3juxVdCEWp0xBSWOv9qyqBeStw42sA/itzW4EoW+D9JOL'
        'fdn9PgOzZBlfLaPa5VjfRyXLLdouN7XVHOQGN/uz3zy0yTWbjetHZl70tAJBuDBECA98'
        '+F1HelHUAingyUxtsdE+QSwijB2gw7oNgJ22i7T7LMMP4ZUYgpM41pBg+PkD5YcK8pLa'
        'QcT6shJzuR6O60yiF4C2Q5o6B8c+in5QASZWlQeMMURWo/BZjWqCRLyIUnM5yU+k/WWK'
        'DShLv7LMW/FKpdWUQn2Z615OMN+We/v6KEc5yi7l9PPZSciZ3jwjzpR5nlL2X2PONuZO'
        'C+u0C+bCe/369Ib59oL5/CLt/6PRUmAxI3EzQ+7ZHs/tWSUJ3VbxwlOcrQ8Xg42aIbwf'
        'R5ByWbbPLq56vu4CDpaTRy2NUEsJkjDPFtMoXWqmsc3G51RNIsjDZJZldhy9iILRZm8B'
        '/WKP2dAeU+9p4Tzu/VYKOhiBth5hoycSfjZz4tR1ny4BO7+l2dR+OSufBwxjegOOFZzF'
        '9pnUJGOOmNnFlj8awcZiEzLWOhzkfpgRoY8orRzIaXBGTI++xbAvInrbWuZpkWTuR53r'
        'ek7tNJTI4yHatuYQbuKRcm3z5r/Mtb6nHQhezTSbuZdmX9uVW/PlA7mXyy1hmza9jVA9'
        'vjAccfDCXWtA7mnulhH16M++a3AeSMNBAFiPDN8HSH4a/PWkil4YtOAjeFvNfR9iX/pe'
        'WBwO5w7IMXuUC23nUJF+xO+zghRsKcnxfC2H+jQ+OP97QsBW9qSjipuEzcIuxqM21c6e'
        'oRTkhngHGbYRdIcUx0FEZbDYQI4AAYOxABhS+Mj+sgAXM1iMh/cg46APwYHDgktzlF3J'
        'cW+f6R3S7K9NWk78tK1yeYZGnL9Z56c9P4WxLCcFBRS/Ras85KvTf8dQJsl1Kbno6Lw0'
        'eFXvhHdVCUUltWnPHjdZTCAxi+4FV0i6lqV75fTkCfl//wEH06cn'),
    '12e3263a13227a82': (
        'eNrtGl1v0zDwr0x9HiCkkimreDB+IKklF6LKh4SqCU2CISEY2t4Q/x1/Jb5z7CSj7SiQ'
        'a2P7Pnx2Usf34f5YLJ/cfvvy+e7m2fXXu6ubq+v7T08/fri7/764PHu/qGeYYRwEhVJU'
        'LRT64xu46urnFSIUHQcSwDHCGEb81aExE4E0l7QVxBzp+ZiooTc46YAVGxCuEK7RgUBM'
        'EWi+rW/n0tyS/TLBHI/Z2qJQeHnbg4kalDIddc2UQfRVrwG2660uDGfrrp2+LG29NTzL'
        'grUm7WAE1jAFGjgQNEcf4TdUHmHsGWb481Bl1nY1qbdqG7VCBAUBU7Qxok2dwiOp7Vym'
        'TXnKztFEG8jj7iVv5zX+772y8yMA2NgvgK9MsTG0TdXSWxGPVpv0I9zYfhXCXUXUzjDD'
        'fwfbMdo27REgw2mjE9XGX3XWh3DmVpGeqqWr2BwrIkiaNZVSBA+yrYI6TCC4LVRj7MKo'
        'gXvo+TB+pn7o4/k3glRtm+GYVCZDVxThwrBAQoW0vSQRQGGyjOJyFJDjaPxlisg8yuLA'
        'PWjkXI/zykfkGtHXBcdZAg6vUcbAlCvOVw5ZIarv7hsGVqbG4b6Tv1jxZDaCZzIDnfaE'
        'PJ6ma1YIiiqGQCn6zFaiGFBASAVJymRlk3ya4hE9NKLl6WVPxd+T6lrszs9ozvT2xHKm'
        '7sFm8mZ0IfLctsIzdWL5TgAeJ+5Q9i79nveJbBCPMJZiy6zWTvxdR0jNitHtUub3x6OD'
        'GIimgylWseUiBs6YwDphSX1RT3AKcFQ7p8pOAeTQkhxdpm8AdgSD3bD0DDPMMMNJQ7OX'
        'dWomWLfm4QoPYjCbg0wkajejM232meKR+vRyEaqXk8CxukpG8sHrUSgtUYd8RLLPVD9N'
        'kNqUyE0XOd8OHSQTtz5r3+WgoZdJb4CefLuTaAbxEXcn9wB/t5PuHGcZ1NBhpeQ4YSH7'
        'PkvC5Za6Vy/KkN0gOBWxZKUpy7JkBkxZluZuLaEE/TGF4YATMU/BF2CYmqMLrUgLmObS'
        'llbccMGqBdsul2YAx0uGFCwER+OR1GpqvMVHArls5oL1EkIoySPzI8iwRpwoR79t+wtF'
        'uR3nVzKa1YnjODYSFXIgOacMsFwwl1z4QPNmMnXPkpL8rcppbnYurYbefgHMbw50GxDZ'
        'rS6Vp1SH2mKb4TCvOdYmfjownwLt5SGd6rGl/S/UlmQ11iHTUeu3UPn3cNe+osK09Yso'
        'zqP/dyGLjhAh0Euct9yPc1IvHkWxaHddfC4xNjRLuTcC8NPs/CWR2gjDbsniSQkqIXqT'
        'Qn/XE5kdVyZMBsO+UtJk8ajhqtSfHWkCfygtn8PDyUAxcA6AiWIAylFSmUbKUJex1PHy'
        '3S8Wu5+/AM2hu94='),
    '843482f46f10e82b': (
        'eNqrVjLRLcjPySzO0E/OK47PiE8uSddLSywuKVSyUoiO1VFAlS9AlVfyHMbAGwVYWnpb'
        'enugAzMgxA/CEcAZRjkjc5FouIJwO2QJVCaY44xVApugMxabSAHe3mDKEcyGipkR1BUW'
        'BiQ8kQQ8YUQYQb3+ZEmNglEwCkbBcAV2RKu0HwhLyXKJHdXstgIjstxHSnA50yhy3Wim'
        'mEYgFotYKEYjAHudTbAS9/cnTq0nMS51gtIxMYMvTzvTL4UNCs8N9pKTLK1WVHSq/UD6'
        '3Y4qwWdPfJbEH3722JLQoMsetuSnDwoi22qAfW1PioeomqhDR1uCo2AUkAGG29hJIG2M'
        '9QQ3W8PgTVhPzBYtTBlsOAuCPcPQlIWBUBjcTKh0WBiaSejAG5e4N4YspDb0g5C4q0ZH'
        'LCzsAjCuoyNOHQjLrbFUxzgEnLGpAdNIQ6n4RlLNkGnQaCzq0CyECyI9hzlQiq0FAO+u'
        '5O8='),
}

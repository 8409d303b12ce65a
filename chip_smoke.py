"""GPU smoke run of the PyTorch + CUDA port (falcon_unzip_tpu_torch).

    python3 chip_smoke.py [--genome-bp N]

Needs one NVIDIA GPU, nvcc and the repository beside this script; imports
nothing of JAX.  Phases, one line each or more, any failure exits
non-zero:

1. card: name and power limit (nvidia-smi), torch / CUDA / nvcc versions;
2. build the CUDA kernels from falcon_unzip_tpu_torch/csrc/ (one nvcc per
   source, all at once);
3. kernel parity: each kernel against its plain torch version on the card
   at the main path's shapes.  Banded wavefront and traceback (the moves
   and the fused packed and summary epilogues against traceback_batch_plain
   and its compositions with pack_moves2 / _combine_results and
   _summarize_moves): P=256; W 128/256/512; global, qglocal and tglocal;
   query buckets 1024/2048/4096 with their target buckets; then a batch of
   short pairs in a long bucket (n + m under half of Dmax: the early stop
   and the MOVE_NONE tail), a batch of pairs that cannot align (dist
   INF), and FalconSense's launches (W=128 tglocal, P=64, 7-13 kb reads
   at 8% in the query buckets 8192 and 16384, rows staged in shared
   memory), each time beside its bound; all bit-exact.  Pair-HMM forward: P=256, 512 bp
   windows (Dmax 1025), W 64/128/256, each time beside its bound and SFU
   floor; then the edge batches of
   falcon_unzip_tpu_torch/utils/hmm_batches.py (corners out of the band,
   n = 0 or m = 0, n + m around the prologue's end, a cut schedule,
   corners at the band's edges, mixed lengths, P = 1 and 37) in every
   build, W 32/64/128/256/512, and 50 kb rows, out-of-band pairs exactly
   NEG.  Arrow
   splice sweeps: P=512,
   Lq=LJ=640, C=4, per-pair params and per-base tiers (T=6): the raw sweep
   outputs and the splice scores, then the edge shapes of
   falcon_unzip_tpu_torch/utils/arrow_batches.py (padding pairs, n and m
   at the warp edges and the stripe edges, n > m, n < m, small m, m = LJ -
   1 with clipped slots) and a batch of C = 12 candidates a pair, each
   padded to P = 64 and to P = 256 so that both warp counts (8 and 2 warps
   a block) run them.
   Seeded pairs at 0% and 15% error; the float kernels within
   |kernel - plain| <= 1e-3 * max(1, |plain|).  Pair-HMM step ablation:
   the five feature sets at the constants of scripts/ablate_pallas.py
   (P=256, W=128, Dmax=1025, LQG=1024), from the script's NEG start equal
   (tolerance 0), and at a seeded probe where each part changes the
   output, equal without the logaddexps and within 1e-5 relative with
   them; each set's time from the NEG and from a seeded start beside its
   SFU floor and the card's name and power limit;
3e. band widths off the main path's: the wavefront and traceback (moves,
   packed, summary) at W = 2, 16, 33, 48, 96, 200, 384, 640, 768, 1024,
   2048 and 4096 (the built layouts' own widths and ragged ones, run on
   the narrowest wider layout), each mode, timed at P=64 in query bucket
   1024 (2048 at W = 4096, which is wider than bucket 1024's guarded
   rows) beside the bound, and held bit-exact against their plain
   versions on every fourth pair of that batch (16 pairs; bands up to
   256 wide on 16 pairs of bucket 256), and at W = 200 on phase 3's
   short and unalignable batches; the pair-HMM forward at W = 16, 48,
   96, 200, 384 and 1024, timed at P=256 on 512 bp windows beside its
   bound and SFU floor and held on every edge batch within 1e-3
   relative, out-of-band pairs exactly NEG; the golden fixture through
   the command line on cuda at [align] band 384 / [overlap] band 200 and
   at [align] band 768 (the wavefront launched at each configured width
   and at placement's max(512, band)), its 3-unzip and 4-polish files
   equal to the JAX package's digests of the same config
   (falcon_unzip_tpu_torch/utils/knob_configs.py) and its consensus QVs
   within 1;
4. golden fixture: 3-unzip and 4-polish on cuda through the port's
   command line must reproduce the five golden hashes of
   tests/test_golden.py, and every file they write must equal the JAX
   package's digest of the default run in
   falcon_unzip_tpu_torch/utils/knob_configs.py, consensus QVs within 1;
4k. the knob groups of falcon_unzip_tpu_torch/utils/knob_configs.py
   (pipeline config fields off their defaults, on the golden fixture,
   its raw reads as a fofn of a FASTQ with per-base quality tracks and a
   FASTA, or its draft polished without haplotigs) through the command
   line on cuda, the 4-polish-only groups from phase 4's 3-unzip: each
   stage's files equal to the JAX package's digest, the consensus QVs
   within 1 of its QV lines; each group's seconds, launches, the
   wavefront's P and the Arrow sweeps' warps a block, candidates C, row
   length LJ and tier mode, which must show the wavefront at P=24
   (align_exec), the Arrow sweeps at P=12 in the 8-warp build, the last
   launch ragged (polish_exec), their wide build at C=12 and LJ=768
   (polish_sem) and their per-base tier mode (qv_per_base);
4b. re-forward polish: the golden fixture's contigs and raw-read AlnSet
   polished with Polisher(scorer=PairHMMScorer(device="cuda")), every
   covered column a mutation candidate (margin_frac 1.01), equal the
   same run with the scorer's plain version on the card, and the window
   of tests/test_polisher.py::test_arrow_matches_window_oracle equals
   oracle.hmm.polish_window_oracle; the P, Lq, Lt and W of each pair-HMM
   launch, and at the largest the kernel held against its plain version
   (within 1e-3 relative, out-of-band pairs exactly NEG) and timed: the
   kernels line's pair-HMM entry;
4c. the command line: the nine subcommands phase, ovlp-filter, track,
   dedup, graph, gen-gfa, readmap, select-reads (over a BAM of the tracked
   raw reads) and bam2m4 on the golden fixture with --device cuda, each
   one's seconds and launches; the five that align again with --device
   cpu, their output files byte-identical;
5. the main path at size: 3-unzip then 4-polish on cuda over a diploid
   genome of --genome-bp (default 1 Mb) with the n50 contig profile, 25x
   preads and 29x raw reads at 3% error (the recipe of
   scripts/e2e_bench.py); per-stage seconds, kernel launches, device ms,
   cell rate, peak device memory and the cns statistics;
5c. the traced unzip: run_unzip again on phase 5's inputs with
   cfg.profile_dir set; its 3-unzip/ byte-identical to phase 5's, the
   trace's wavefront and traceback kernels as many as the launch counts,
   and the device's busy share (the union of the trace's kernel and
   memcpy intervals over its span) with the kernel and memcpy ms;
5d. phase 5's consensus against its simulated truth:
   falcon_unzip_tpu_torch/scripts/e2e_bench.py's _truth_qv on cns_p and
   cns_h, re-aligning on cuda and on the CPU (QV and breakdown equal),
   then the qv_calibrate and qv_attrib twins on phase 5's directory on
   cuda (qv_attrib's sample rows counted, not printed) and profile_align
   at its default 300 kb on cuda;
10. parallel/ on the card, after 5d: (a) a mesh of 4 logical shards (2 x
   2) on cuda:0 with the sharding debug checks on: ShardedPhaseOps'
   pileup and association at a 1 Mb contig's tag count (25 M tags;
   11,360 reads x 7,200 sites) bit-exact to the single-device ops,
   ShardedWindowVotes at 500 kb (14.5 M tags) equal to vote_matrix in
   every polish window, regroup_partition of 16,109 reads into 23
   contigs equal to a host group-by, a forced regroup overflow and the
   halo exchange exact, ShardedArrowSplicer (P=512, Lq=LJ=640, C=4) and
   ShardedPairHMMScorer (phase 4b's P=7095, Lq=Lt=512, W=128) within
   1e-3 * max(1, |single|) of the single-device op, out-of-band pairs
   exactly NEG; each line with the launches of the sharded call and the
   warp / cells-a-lane builds unsharded and a shard; (b) run_unzip then
   run_quiver with cfg.mesh.multihost on phase 5's inputs in two
   processes of one gloo world sharing cuda:0: the canonical 3-unzip/
   files and cns_* byte-identical to phase 5's (else the first differing
   contig and column), a resume pass that skips every stage on both
   ranks, each rank's walls and launches beside phase 5's walls (the
   distributed layer's cost, not scaling);
11. the scaling bench's phase step, after phase 10:
   falcon_unzip_tpu_torch/scripts/scaling_bench.py's phase-step worker
   over 1 and 2 gloo ranks sharing cuda:0 (8192 rows a rank, T = 64,
   t_len 4096); rank 0's digest of the step's seven outputs equal to a
   one-process make_phase_step's over the same rows on cuda:0 and on the
   CPU; reads/s for each (ranks share one card: the layer's cost);
5b. the per-base-quality hotspot polish of
   tests/test_qv_aware.py::test_polish_per_base_profile_qv on cuda (15 kb,
   20x reads of 2000 bp at 5% error, arrow_rounds 3), flat and with
   per-base tiers: Arrow launches (3 each) and their device ms; the
   tiered consensus must equal the truth and the flat one the port's flat
   polish of the same alignments on the CPU;
6. the ablation path: python -m falcon_unzip_tpu_torch.scripts.ablate_pairhmm
   (each set's time beside its SFU floor and the card's name and power
   limit);
7. the kernel bench: python -m falcon_unzip_tpu_torch.cli bench, its JSON
   line printed as it is;
9. FalconSense (BASELINE config 1) at E. coli K-12 MG1655's length,
   4,641,652 bp: a random contig, its template at 2%, 20x reads of 10 kb
   mean at 8% (half reverse-complemented) on cuda; the wall split into
   seed, dispatch / collect and vote / emit, launches, device ms, peak
   device memory and the identity to the truth (floor 99.9%) from a plain
   torch edit distance of every 10 kb piece (utils/fixtures.py
   edit_identity: neither the port's kernels nor its aligner); then a
   100 kb cut, card and CPU consensus byte-equal;
8. the kernels line (each kernel's launches on its path, its time at the
   main path's shape beside its plain version's and its bound) and the
   result line.
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def phase_card(torch) -> str:
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false")
    from falcon_unzip_tpu_torch.bench import card_label
    from falcon_unzip_tpu_torch.ops import _kernels
    smi = card_label()
    nvcc = subprocess.run([_kernels._nvcc(), "--version"],
                          capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[1 card] {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {nvcc}", flush=True)
    return smi


def phase_build() -> None:
    """Build every CUDA source (ptxas -v): the seconds, the kernels
    compiled, their registers and those that spill."""
    import re
    from falcon_unzip_tpu_torch.ops import _kernels
    t0 = time.perf_counter()
    _kernels._load()
    secs = time.perf_counter() - t0
    entries = re.split(r"Compiling entry function '", _kernels.BUILD_LOG)[1:]
    regs, spills = [], []
    for e in entries:
        used = re.search(r"Used (\d+) registers", e)
        regs.append(int(used.group(1)) if used else 0)
        sp = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                       e)
        if sp and sp.groups() != ("0", "0"):
            spills.append(f"{e.split(chr(39))[0]} ({sp.group(0)})")
    print(f"[2 build] {secs:.2f} s | {len(entries)} kernels compiled, "
          f"{min(regs, default=0)}-{max(regs, default=0)} registers a "
          f"thread | spills: {'; '.join(spills) or 'none'}", flush=True)


def _pairs(rng, P, bq, mode):
    """P seeded (query, target) pairs for query bucket bq: half exact,
    half at 15% error; query lengths in (bq/2, bq].  Returns lists of
    int8 base-code arrays."""
    from falcon_unzip_tpu_torch.utils.simulate import (mutate_read,
                                                       random_genome)
    qs, ts = [], []
    for k in range(P):
        err = 0.0 if k < P // 2 else 0.15
        L = int(rng.integers(bq // 2 + 1, bq + 1))
        if mode == "global":
            t = random_genome(L, int(rng.integers(1 << 30)))
            q = mutate_read(t, err, rng)[:bq]
        else:
            pad = int(rng.integers(40, 300))
            t = random_genome(L + pad, int(rng.integers(1 << 30)))
            off = int(rng.integers(0, pad))
            q = mutate_read(t[off : off + L], err, rng)[:bq]
        qs.append(q)
        ts.append(t)
    return qs, ts


def _padded(np, seqs, width):
    """PAD-filled (len(seqs), width) int8 batch and its lengths."""
    out = np.full((len(seqs), width), 4, np.int8)     # 4: PAD / N
    for k, s in enumerate(seqs):
        out[k, : len(s)] = s
    return out, np.array([len(s) for s in seqs], np.int32)


def _short_pairs(rng, P, bq, mode):
    """Mostly short pairs (60 .. 400 bases, so n + m is far under half of
    the schedule) beside eight full-length ones that keep the bucket's
    schedule long."""
    qs, ts = _pairs(rng, 8, bq, mode)
    q2, t2 = _pairs(rng, P - 8, 400, mode)
    return qs + [q[:400] for q in q2], ts + t2


def _fs_pairs(rng, P, bq, mode):
    """P reads of FalconSense's query bucket bq (7-13 kb, 8% error) against
    their template windows (the source at 2%, padded by 48 bases each
    side, as FalconSense cuts them)."""
    from falcon_unzip_tpu_torch.utils.fixtures import mutate
    from falcon_unzip_tpu_torch.utils.simulate import random_genome
    lo, hi = max(7000, bq // 2 + 1), min(13000, bq)
    qs, ts = [], []
    for _ in range(P):
        L = int(rng.integers(lo, hi + 1))
        src = random_genome(L + 96, int(rng.integers(1 << 30)))
        qs.append(mutate(rng, src[48 : 48 + L], 0.08)[:bq])
        ts.append(mutate(rng, src, 0.02))
    return qs, ts


def _unalignable_pairs(rng, P, bq, mode):
    """Queries near the bucket's length against unrelated targets of a
    few hundred bases: row n never enters the band, so the local modes
    find no end (dist INF, end_j -1)."""
    from falcon_unzip_tpu_torch.utils.simulate import random_genome
    qs = [random_genome(int(rng.integers(bq - 200, bq + 1)),
                        int(rng.integers(1 << 30))) for _ in range(P)]
    ts = [random_genome(int(rng.integers(100, 400)),
                        int(rng.integers(1 << 30))) for _ in range(P)]
    return qs, ts


def _align_case(torch, np, W, mode, bq, qs, ts, tag, P, plain=True) -> dict:
    """The banded wavefront and traceback (moves, packed and summary
    epilogues) on one batch of pairs in query bucket bq, against their
    plain versions on the card, bit-exact (a difference fails); the times
    of kernel and plain version and the work of both kernels.  With plain
    False the kernels are only timed."""
    from falcon_unzip_tpu_torch.scripts.common import time_ms
    from falcon_unzip_tpu_torch import bench
    from falcon_unzip_tpu_torch.models.aligner import _t_bucket
    from falcon_unzip_tpu_torch.ops import banded_align as ba
    dev = torch.device("cuda")
    bt = _t_bucket(max(len(x) for x in ts), bq)
    q, n = _padded(np, qs, bq)
    t, m = _padded(np, ts, bt)
    # the schedule exactly as BandedAligner.dispatch cuts it
    Dmax, lo = ba.build_schedule(bq, bt, W)
    need = int((n + m).max()) + 1
    Dmax = min(Dmax, -(-need // 1024) * 1024)
    lo = lo[:Dmax]
    qg, trg, G = ba.prepare_batch(q, t, W)
    args = (torch.from_numpy(qg).to(dev),
            torch.from_numpy(trg).to(dev),
            torch.from_numpy(n).to(dev),
            torch.from_numpy(m).to(dev), lo)
    kw = dict(W=W, Lt=bt, G=G, mode=mode)
    where = f"W={W} {mode} bq={bq}{tag}"
    steps = Dmax - 1
    k = ba.banded_align_batch(*args, **kw)
    ends = (k["dist"], k["end_i"], k["end_j"])
    tk = ba.traceback_batch(k["bp"], lo, *ends[1:], max_steps=steps)
    n_moves = int((tk != ba.MOVE_NONE).sum())
    res = dict(bt=bt, Dmax=Dmax, n_moves=n_moves,
               finite=int((k["dist"] < 1 << 20).sum()),
               wf_work=bench.wavefront_work(
                   n, m, Dmax=Dmax, W=W, LQG=qg.shape[1], LTG=trg.shape[1]),
               tb_work=bench.traceback_work(n_moves, P=P, max_steps=steps))
    if plain:
        t0 = time.perf_counter()
        p = ba.banded_align_batch_plain(*args, **kw)
        torch.cuda.synchronize()
        res["wf_plain_ms"] = 1e3 * (time.perf_counter() - t0)
        wf_err = max(int((k[key] - p[key]).abs().max())
                     for key in ("dist", "end_i", "end_j"))
        res["wf_err"] = max(wf_err, int(
            (ba.unpack_bp(k["bp"], Dmax).int()
             - ba.unpack_bp(p["bp"], Dmax).int()).abs().max()))
        for key in ("dist", "end_i", "end_j", "bp"):
            if not torch.equal(k[key], p[key]):
                _fail(f"wavefront {key} differs at {where}")
        t0 = time.perf_counter()
        tp = ba.traceback_batch_plain(p["bp"], lo, p["end_i"], p["end_j"],
                                      max_steps=steps)
        torch.cuda.synchronize()
        res["tb_plain_ms"] = 1e3 * (time.perf_counter() - t0)
        res["tb_err"] = int((tk.int() - tp.int()).abs().max())
        if not torch.equal(tk, tp):
            _fail(f"traceback differs at {where}")
        # the plain compositions, over the plain moves made just above
        # (what traceback_packed_plain / traceback_summary_plain compute)
        plain_ends = (p["dist"], p["end_i"], p["end_j"])
        wants = {"packed": ba._combine_results(ba.pack_moves2(tp),
                                               *plain_ends),
                 "summary": ba._summarize_moves(tp, *plain_ends)}
        for name, want in wants.items():
            got = getattr(ba, f"traceback_{name}")(k["bp"], lo, *ends,
                                                   max_steps=steps)
            if not torch.equal(got, want):
                _fail(f"traceback {name} epilogue differs at {where}")
    if tag.endswith("short pairs") and 2 * int(np.sort(n + m)[-9]) >= Dmax:
        _fail(f"the short pairs are not short: Dmax {Dmax}")
    if tag.endswith("unalignable pairs") and res["finite"]:
        _fail(f"{res['finite']} of the unalignable pairs aligned")
    res["epi_ms"] = {name: time_ms(lambda: getattr(
        ba, f"traceback_{name}")(k["bp"], lo, *ends, max_steps=steps), 3)
        for name in ("packed", "summary")}
    res["wf_ms"] = time_ms(lambda: ba.banded_align_batch(*args, **kw), 3)
    res["tb_ms"] = time_ms(lambda: ba.traceback_batch(
        k["bp"], lo, k["end_i"], k["end_j"], max_steps=steps), 3)
    return res


def _align_line(W, mode, bq, tag, P, r) -> str:
    """Phase 3's line of one batch: the kernels' times beside their bounds,
    and beside their plain versions' where the batch was held against
    them."""
    from falcon_unzip_tpu_torch import bench
    bounds = [bench.bound_ms(w["ops"], w["bytes"], w["peak"])[0]
              for w in (r["wf_work"], r["tb_work"])]
    held = "wf_plain_ms" in r
    plain = [f"plain {r[k]:.1f} ms, " if held else ""
             for k in ("wf_plain_ms", "tb_plain_ms")]
    return (f"W={W} {mode} bq={bq} bt={r['bt']} Dmax={r['Dmax']}{tag} P={P} "
            f"finite={r['finite']}/{P} {'exact' if held else 'timed'} | "
            f"wavefront {r['wf_ms']:.3f} ms ({plain[0]}bound "
            f"{bounds[0]:.4f} ms) | traceback {r['tb_ms']:.3f} ms "
            f"({plain[1]}bound {bounds[1]:.5f} ms), packed "
            f"{r['epi_ms']['packed']:.3f} ms, summary "
            f"{r['epi_ms']['summary']:.3f} ms")


def phase_parity_align(torch, np) -> dict:
    rng = np.random.default_rng(2024)
    shapes = {}
    cases = [(W, mode, bq, _pairs, "", 256)
             for W in (128, 256, 512)
             for mode in ("global", "qglocal", "tglocal")
             for bq in (1024, 2048, 4096)]
    # appended, so that the seeded pairs of the 27 shapes stay what they were
    cases += [(256, mode, 2048, _short_pairs, " short pairs", 256)
              for mode in ("global", "tglocal")]
    cases += [(256, mode, 2048, _unalignable_pairs, " unalignable pairs", 256)
              for mode in ("qglocal", "tglocal")]
    # FalconSense's launches (phase 9): W = 128 tglocal, 64 pairs, reads of
    # 7-13 kb in the query buckets 8192 and 16384
    cases += [(128, "tglocal", bq, _fs_pairs, " FalconSense", 64)
              for bq in (8192, 16384)]
    for W, mode, bq, make, tag, P in cases:
        qs, ts = make(rng, P, bq, mode)
        r = _align_case(torch, np, W, mode, bq, qs, ts, tag, P)
        if tag and tag != " FalconSense":
            print(f"[3 parity] W={W} {mode} bq={bq} bt={r['bt']} "
                  f"Dmax={r['Dmax']}{tag}: finite={r['finite']}/{P}, "
                  f"{r['n_moves']} moves exact | wavefront {r['wf_ms']:.3f} "
                  f"ms | traceback moves {r['tb_ms']:.3f} ms, packed "
                  f"{r['epi_ms']['packed']:.3f} ms, summary "
                  f"{r['epi_ms']['summary']:.3f} ms", flush=True)
            continue
        shapes[(W, mode, bq) + ((P,) if tag else ())] = r
        print(f"[3 parity] {_align_line(W, mode, bq, tag, P, r)}", flush=True)
    return shapes


def _bar(torch, k, p):
    """(max abs err, max rel err) of kernel k against plain p, and whether
    every element is within |k - p| <= 1e-3 * max(1, |p|)."""
    k = k.double()
    p = p.double()
    err = (k - p).abs()
    rel = err / p.abs().clamp(min=1.0)
    return float(err.max()), float(rel.max()), bool((rel <= 1e-3).all())


def _windows(np, rng, P, win, tlen):
    """P seeded (read, template) pairs: template of tlen (lo, hi) bases,
    half the reads exact copies, half at 15% error, cut to win.  Returns
    PAD-filled int8 (P, win) reads and (P, win) templates and lengths."""
    from falcon_unzip_tpu_torch.utils.simulate import (mutate_read,
                                                       random_genome)
    qs, ts = [], []
    for k in range(P):
        t = random_genome(int(rng.integers(*tlen)), int(rng.integers(1 << 30)))
        err = 0.0 if k % 2 == 0 else 0.15
        qs.append(mutate_read(t, err, rng)[:win])
        ts.append(t)
    q, n = _padded(np, qs, win)
    t, m = _padded(np, ts, win)
    return q, n, t, m


def phase_parity_hmm(torch, np) -> None:
    """Pair-HMM forward kernel against pairhmm_forward_plain on the card
    at the bench shape (P=256, 512 bp windows, Dmax 1025), then on the edge
    batches of utils/hmm_batches.py in every build."""
    from falcon_unzip_tpu_torch.scripts.common import time_ms
    from falcon_unzip_tpu_torch import bench
    from falcon_unzip_tpu_torch.ops import banded_align as ba
    from falcon_unzip_tpu_torch.ops import _kernels
    from falcon_unzip_tpu_torch.ops import pairhmm as ph
    from falcon_unzip_tpu_torch.utils import hmm_batches as hb
    dev = torch.device("cuda")
    rng = np.random.default_rng(2025)
    P, WIN = 256, 512
    q, n, t, m = _windows(np, rng, P, WIN, (400, 501))
    pvec = ph.params_vector()
    for W in (64, 128, 256):
        qg, trg, G = ba.prepare_batch(q, t, W)
        Dmax, lo = ba.build_schedule(WIN, WIN, W)
        args = (torch.from_numpy(qg).to(dev), torch.from_numpy(trg).to(dev),
                torch.from_numpy(n).to(dev), torch.from_numpy(m).to(dev), lo,
                pvec)
        kw = dict(W=W, Lt=WIN, G=G)
        k = ph.pairhmm_forward(*args, **kw)
        t0 = time.perf_counter()
        p = ph.pairhmm_forward_plain(*args, **kw)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        if not torch.equal(k <= -1e29, p <= -1e29):
            _fail(f"pairhmm W={W}: kernel and plain leave the band at "
                  "different pairs")
        ok = p > -1e29
        err, rel, within = _bar(torch, k[ok], p[ok])
        if not within or not bool(torch.isfinite(k).all()):
            _fail(f"pairhmm W={W}: max abs err {err} rel {rel} over the bar")
        ms = time_ms(lambda: ph.pairhmm_forward(*args, **kw), 5)
        work = bench.pairhmm_work(n, m, Dmax=Dmax, W=W, LQG=qg.shape[1],
                                  LTG=trg.shape[1])
        bound = bench.bound_ms(work["ops"], work["bytes"], work["peak"])[0]
        print(f"[3 parity] pairhmm_forward W={W} P={P} win={WIN} Dmax={Dmax}"
              f" in-band {int(ok.sum())}/{P} | max abs err {err:.3g} rel "
              f"{rel:.3g} (bar 1e-3) | kernel {ms:.3f} ms (plain "
              f"{plain_ms:.1f} ms) | bound {bound:.4f} ms, SFU floor "
              f"{work['sfu_ms']:.4f} ms", flush=True)
    # the edge batches in every build (a band width, and at W = 128 both
    # cells a lane: the batches repeated to P = 600 for two), then rows too
    # long for the shared-memory stage (the builds reading device memory)
    worst = 0.0
    builds = ((32, None, 1), (64, None, 2), (128, None, 1), (128, 600, 2),
              (256, None, 2), (512, None, 2))
    L = 50_000
    for W, Pb, cells in builds:
        specs = [(0, 0), (5, 9), (700, 690), (W + 3, W), (400, 395)]
        q, t, n, m = hb.pack(rng, (specs * (Pb or 5))[: Pb or 5], Lq=L, Lt=L)
        for kind, b in ([(kd, hb.edge_batch(kd, W, P=Pb))
                         for kd in hb.EDGE_KINDS]
                        + [("rows_50kb", {"q": q, "t": t, "n": n, "m": m,
                                          "Dmax": 2 * L + 1})]):
            if _kernels.pairhmm_cells(W, len(b["n"])) != cells:
                _fail(f"pairhmm W={W} P={len(b['n'])}: not {cells} cells a "
                      "lane")
            args, kw = hb.to_device(b, W, pvec, dev)
            k = ph.pairhmm_forward(*args, **kw)
            p = ph.pairhmm_forward_plain(*args, **kw)
            rel = hb.max_rel_err(k, p)
            if not rel <= 1e-3 or not bool((k[p < -1e29] == -1e30).all()):
                _fail(f"pairhmm edge batch {kind} W={W} P={len(b['n'])}: rel "
                      f"err {rel} over the bar, or an out-of-band pair not "
                      "exactly NEG")
            worst = max(worst, rel)
    print(f"[3 parity] pairhmm_forward edge batches {', '.join(hb.EDGE_KINDS)}"
          f" and 50 kb rows in every build (W = 32/64/128/256/512; W = 128 "
          f"also at P = 600, two cells a lane) | max rel err {worst:.3g} (bar "
          "1e-3), out-of-band pairs exactly NEG", flush=True)


def phase_parity_arrow(torch, np) -> dict:
    """Arrow splice sweep kernel against arrow_sweeps_plain on the card at
    the production polish shape (P=512, Lq=LJ=640, C=4): the raw sweep
    outputs and the splice scores built on them; then the edge shapes of
    utils/arrow_batches.py and a batch of C = 12 candidates a pair, in
    each warp count of the kernel (8 warps a block at P = 64, 2 at
    P = 256)."""
    from falcon_unzip_tpu_torch.scripts.common import time_ms
    from falcon_unzip_tpu_torch import bench
    from falcon_unzip_tpu_torch.models.polisher import (PolisherConfig,
                                                         tier_table)
    from falcon_unzip_tpu_torch.ops import arrow as ar
    from falcon_unzip_tpu_torch.ops import pairhmm as ph
    from falcon_unzip_tpu_torch.ops import _kernels
    from falcon_unzip_tpu_torch.utils import arrow_batches as ab
    dev = torch.device("cuda")
    rng = np.random.default_rng(2026)
    pc = PolisherConfig()
    P, L, C = pc.splice_chunk, pc.len_cap(), pc.arrow_candidates
    q, n, t, m = _windows(np, rng, P, L, (300, 421))
    cand = np.full((P, C), -1, np.int32)
    for k in range(P):
        cols = rng.choice(int(m[k]), size=C, replace=False)
        cols[0] = m[k] - 1                         # the terminal deletion
        cand[k, : 1 + k % C] = cols[: 1 + k % C]   # and unused slots
    pvec = np.tile(ph.params_vector(), (P, 1))
    tiers = tier_table()
    qt = rng.integers(0, len(tiers), size=(P, L + 1)).astype(np.int8)
    res = {}
    for mode in ("per-pair", "per-base"):
        args = ab.to_device((q, t, n, m, cand, pvec, qt, tiers), mode, dev)
        k_sw = ar.arrow_sweeps(*args, C=C)
        t0 = time.perf_counter()
        p_sw = ar.arrow_sweeps_plain(*args, C=C)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        ar.arrow_splice_plain(*args, C=C)
        torch.cuda.synchronize()
        plain_all_ms = 1e3 * (time.perf_counter() - t0)
        raw_rel = max(ab.max_rel_err(a, b) for a, b in zip(k_sw, p_sw))
        if not raw_rel <= 1e-3:
            _fail(f"arrow {mode}: raw sweep outputs rel err {raw_rel} over "
                  "the bar (or NEG slots differ)")
        k_cur, k_mut = ar.splice_from_sweeps(*args, k_sw, C=C)
        p_cur, p_mut = ar.splice_from_sweeps(*args, p_sw, C=C)
        k_all = torch.cat([k_cur[:, None], k_mut.reshape(P, -1)], dim=1)
        p_all = torch.cat([p_cur[:, None], p_mut.reshape(P, -1)], dim=1)
        if not torch.equal(k_all <= -1e29, p_all <= -1e29):
            _fail(f"arrow {mode}: kernel and plain disagree on NEG slots")
        ok = p_all > -1e29
        err, rel, within = _bar(torch, k_all[ok], p_all[ok])
        if not within or not bool(torch.isfinite(k_all).all()):
            _fail(f"arrow {mode}: max abs err {err} rel {rel} over the bar")
        ms = time_ms(lambda: ar.arrow_sweeps(*args, C=C), 5)
        all_ms = time_ms(lambda: ar.arrow_splice(*args, C=C), 5)
        res[mode] = dict(ms=ms, plain_ms=plain_ms, err=err, rel=rel,
                         work=bench.arrow_work(n, m, Lq=L, LJ=L, C=C))
        print(f"[3 parity] arrow_splice {mode} P={P} Lq=LJ={L} C={C} | raw "
              f"sweep outputs max rel err {raw_rel:.3g} | {int(ok.sum())} "
              f"scores, max abs err {err:.3g} rel {rel:.3g} (bar 1e-3) | "
              f"sweep kernel {ms:.3f} ms (plain sweeps {plain_ms:.1f} ms) | "
              f"with splice assembly {all_ms:.3f} ms (plain "
              f"{plain_all_ms:.1f} ms)", flush=True)
    batches = [(kind, C, ab.edge_specs(kind, LJ=L)) for kind in ab.EDGE_KINDS]
    batches.append(("C=12", 12, ab.wide_specs(rng, LJ=L, C=12)))
    worst = 0.0
    for nw, Pb in ((8, 64), (2, 256)):
        if _kernels.arrow_warps(Pb) != nw:
            _fail(f"arrow: P={Pb} launches {_kernels.arrow_warps(Pb)} warps "
                  f"a block, not {nw}")
        for kind, Cb, specs in batches:
            arrays = ab.pack(rng, specs, Lq=L, LJ=L, C=Cb, P=Pb)
            for mode in ("per-pair", "per-base"):
                args = ab.to_device(arrays, mode, dev)
                k_sw = ar.arrow_sweeps(*args, C=Cb)
                p_sw = ar.arrow_sweeps_plain(*args, C=Cb)
                rel = max(ab.max_rel_err(a, b) for a, b in zip(
                    k_sw + ar.splice_from_sweeps(*args, k_sw, C=Cb),
                    p_sw + ar.splice_from_sweeps(*args, p_sw, C=Cb)))
                if not rel <= 1e-3:
                    _fail(f"arrow edge shapes {kind} {mode} {nw} warps: rel "
                          f"err {rel} over the bar (or NEG slots differ)")
                worst = max(worst, rel)
    print(f"[3 parity] arrow_splice edge shapes {', '.join(ab.EDGE_KINDS)} "
          f"and C=12, both modes, 8 warps a block (P=64) and 2 (P=256), "
          f"Lq=LJ={L} | raw outputs and scores max rel err {worst:.3g} "
          "(bar 1e-3)", flush=True)
    return res


def phase_parity_ablate(torch, smi) -> dict:
    """Pair-HMM step ablation kernel against pairhmm_ablate_plain on the
    card at the constants of the ablation script, every feature set, at
    two inputs: the script's (state planes NEG: out is NEG everywhere),
    equal; and the probe (seeded state planes, rows of N with two bases),
    where every set gives its own out: the sets without the logaddexps
    equal, those with them within 1e-5 relative.  Each set is timed from
    the NEG start and from a seeded one."""
    from falcon_unzip_tpu_torch.scripts.common import time_ms
    from falcon_unzip_tpu_torch import bench
    from falcon_unzip_tpu_torch.ops import pairhmm_ablate as pa
    from falcon_unzip_tpu_torch.scripts import ablate_pairhmm as ab
    dt = lambda x: torch.from_numpy(x).to("cuda")
    qg = dt(ab.rows())
    neg = dt(pa.neg_init(ab.P, ab.W))
    seeded = dt(pa.seeded_init(ab.P, ab.W, 0))
    probe_q, probe_i = (dt(x) for x in pa.probe_inputs(ab.P, ab.LQG, ab.W, 1))
    res, probe_outs = {}, []
    for feats in pa.FEATURE_SETS:
        k = pa.pairhmm_ablate(qg, neg, feats, Dmax=ab.Dmax)
        t0 = time.perf_counter()
        p = pa.pairhmm_ablate_plain(qg, neg, feats, Dmax=ab.Dmax)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        if not torch.equal(k, p):
            _fail(f"pairhmm_ablate {feats} from NEG: kernel and plain differ")
        k = pa.pairhmm_ablate(probe_q, probe_i, feats, Dmax=ab.Dmax)
        p = pa.pairhmm_ablate_plain(probe_q, probe_i, feats, Dmax=ab.Dmax)
        if not bool((p > -1e29).all()) or not bool(torch.isfinite(k).all()):
            _fail(f"pairhmm_ablate {feats}: probe output not finite")
        err = float((k.double() - p.double()).abs().max())
        rel = float(((k.double() - p.double()).abs()
                     / p.double().abs().clamp_min(1e-30)).max())
        if ("lse" in feats and rel > 1e-5) or \
                ("lse" not in feats and not torch.equal(k, p)):
            _fail(f"pairhmm_ablate {feats} at the probe: max abs err {err} "
                  f"rel {rel}")
        probe_outs.append(k)
        ms = time_ms(lambda: pa.pairhmm_ablate(
            qg, neg, feats, Dmax=ab.Dmax), 20)
        ms_seeded = time_ms(lambda: pa.pairhmm_ablate(
            qg, seeded, feats, Dmax=ab.Dmax), 20)
        res[feats] = dict(ms=ms, ms_seeded=ms_seeded, plain_ms=plain_ms,
                          err=err)
        sfu = bench.ablate_work(feats, P=ab.P, Dmax=ab.Dmax, W=ab.W,
                                LQG=ab.LQG)["sfu_ms"]
        print(f"[3 parity] pairhmm_ablate {feats} P={ab.P} W={ab.W} "
              f"Dmax={ab.Dmax} LQG={ab.LQG} | from NEG equal | at the probe "
              f"max abs err {err:.3g} rel {rel:.3g} (bar "
              f"{'1e-5 rel' if 'lse' in feats else '0'}) | kernel {ms:.4f} "
              f"ms, {1e3 * ms / ab.Dmax:.4f} us/step from NEG, "
              f"{ms_seeded:.4f} ms, {1e3 * ms_seeded / ab.Dmax:.4f} us/step "
              f"from the seeded start, SFU floor {sfu:.4f} ms (plain "
              f"{plain_ms:.1f} ms) | {smi}", flush=True)
    for a in range(len(probe_outs)):
        for b in range(a):
            if torch.equal(probe_outs[a], probe_outs[b]):
                _fail("pairhmm_ablate: two feature sets give the same out "
                      "at the probe")
    return res


GOLDEN = {"3-unzip/all_p_ctg.fa": "2864673ab4dc9bf2",
          "3-unzip/all_h_ctg.fa": "70b2521a58bd85f1",
          "3-unzip/all_phased_reads": "3c3f04ee8364d5f6",
          "4-polish/cns_p_ctg.fasta": "2864673ab4dc9bf2",
          "4-polish/cns_h_ctg.fasta": "70b2521a58bd85f1"}


def _read_fasta(np, path) -> list:
    """[(name, int8 base codes)] of a FASTA file (A C G T = 0..3, else 4)."""
    lut = np.full(256, 4, np.int8)
    for k, c in enumerate(b"ACGT"):
        lut[c] = k
    recs = []
    with open(path) as fh:
        for ln in fh:
            if ln.startswith(">"):
                recs.append((ln[1:].split()[0], []))
            else:
                recs[-1][1].append(ln.strip())
    return [(nm, lut[np.frombuffer("".join(parts).encode(), np.uint8)])
            for nm, parts in recs]


def _fasta_lengths(path) -> list:
    lens = []
    with open(path) as fh:
        for ln in fh:
            if ln.startswith(">"):
                lens.append(0)
            else:
                lens[-1] += len(ln.strip())
    return lens


def _write_inputs(d, draft, preads, raw) -> None:
    """Phase 5's inputs and run.json in d (also scripts/mesh_cards.py's).
    draft: [(name, Diploid)]; preads / raw: [(name_prefix, SeqBatch)]."""
    from falcon_unzip_tpu_torch.io.fasta import write_fasta
    from falcon_unzip_tpu_torch.seq import decode
    for fn, reads in (("preads.fa", preads), ("raw.fa", raw)):
        write_fasta(f"{d}/{fn}", ((pre + b.names[i], b.to_str(i))
                                  for pre, b in reads for i in range(len(b))))
    write_fasta(f"{d}/draft.fa",
                [(name, decode(dip.hap0)) for name, dip in draft])
    with open(f"{d}/run.json", "w") as fh:
        json.dump({"preads": f"{d}/preads.fa", "reads": f"{d}/raw.fa",
                   "draft": f"{d}/draft.fa", "out_dir": f"{d}/out"}, fh)


def _cli(d, cmd) -> None:
    """One stage on the card through the port's command line."""
    from falcon_unzip_tpu_torch.cli import main as cli_main
    if cli_main([cmd, f"{d}/run.json", "--device", "cuda"]) != 0:
        _fail(f"{cmd} exited non-zero in {d}")


def _launches(kernels):
    return {k.name: k.launches for k in kernels}


def phase_golden(tmp) -> str:
    """The golden fixture (and the fofn input of utils/knob_configs.py)
    through the command line on cuda: the default run of phase 4k."""
    from falcon_unzip_tpu_torch.ops import _kernels
    from falcon_unzip_tpu_torch.utils import knob_configs as kc
    d = os.path.join(tmp, "golden")
    kc.write_inputs(d)
    with open(f"{d}/run.json", "w") as fh:
        json.dump(kc.run_config(kc.BY_NAME["default"], d, f"{d}/out"), fh)
    align = (_kernels.WAVEFRONT, _kernels.TRACEBACK)
    _kernels.reset_counts()
    t0 = time.perf_counter()
    _cli(d, "unzip")
    unzip_s = time.perf_counter() - t0
    unzip_launches = _launches(align)
    _kernels.reset_counts()
    t0 = time.perf_counter()
    _cli(d, "quiver")
    quiver_s = time.perf_counter() - t0
    quiver_launches = _launches(align + (_kernels.ARROW,))
    got = {}
    for rel, want in GOLDEN.items():
        with open(f"{d}/out/{rel}", "rb") as fh:
            got[rel] = hashlib.sha256(fh.read()).hexdigest()[:16]
        if got[rel] != want:
            _fail(f"golden {rel}: got {got[rel]}, want {want}")
    if min(unzip_launches.values()) <= 0:
        _fail(f"golden unzip did not launch both DP kernels: "
              f"{unzip_launches}")
    if min(quiver_launches[k.name] for k in align) <= 0:
        _fail(f"golden quiver did not align on the card: {quiver_launches}")
    n_qv = 0
    for stage in ("unzip", "quiver"):
        try:
            n_qv += kc.check("default", stage, f"{d}/out")
        except ValueError as e:
            _fail(f"golden on cuda: {e}")
    print(f"[4 golden] unzip {unzip_s:.1f} s, quiver {quiver_s:.1f} s | "
          f"hashes match {got} | launches unzip {unzip_launches}, quiver "
          f"{quiver_launches} | 3-unzip and 4-polish equal to the JAX "
          f"package's digests, {n_qv} consensus QVs differ (by at most 1)",
          flush=True)
    return d


# Phase 3e: band widths off the main path's 128 / 256 / 512.  The
# wavefront and traceback at built layouts' own widths and at ragged ones
# (odd, under a warp, between layouts), which run on the narrowest wider
# layout with the cells past W held out of the band; the pair-HMM forward
# likewise; the golden fixture at two band configurations.
WIDTHS = (2, 16, 33, 48, 96, 200, 384, 640, 768, 1024, 2048, 4096)
HMM_WIDTHS = (16, 48, 96, 200, 384, 1024)


def phase_widths(torch, np) -> dict:
    """Phase 3e: the band kernels at widths the main path does not run,
    each against its plain version on the card, and the golden fixture at
    [align] band 384 / [overlap] band 200 and at [align] band 768 through
    the command line on cuda against the JAX package's digests.  Returns
    each width's check for the kernels line."""
    from falcon_unzip_tpu_torch.scripts.common import time_ms
    from falcon_unzip_tpu_torch import bench
    from falcon_unzip_tpu_torch.ops import banded_align as ba
    from falcon_unzip_tpu_torch.ops import _kernels
    from falcon_unzip_tpu_torch.ops import pairhmm as ph
    from falcon_unzip_tpu_torch.utils import hmm_batches as hb
    from falcon_unzip_tpu_torch.utils import knob_configs as kc
    t_phase = time.perf_counter()
    rng = np.random.default_rng(2026)
    res = {"cases": {}}
    for W in WIDTHS:
        built = _kernels.layout_width("banded_wavefront", W)
        # timed at P = 64 in bucket 1024 (a 4096-wide band is wider than
        # that bucket's rows, prepare_batch's in both packages: 2048) and
        # held against the plain versions, whose time is their host's
        # launches a step, on every fourth pair of the batch (8 exact, 8
        # at 15%); a band up to 256 wide on 16 pairs of bucket 256, whose
        # 129-256 query rows it still slides over
        bq = 1024 if W <= 2048 else 2048
        for mode in ("global", "qglocal", "tglocal"):
            qs, ts = _pairs(rng, 64, bq, mode)
            r = _align_case(torch, np, W, mode, bq, qs, ts, "", 64,
                            plain=False)
            cq = 256 if W <= 256 else bq
            if cq == bq:
                qs, ts = qs[::4], ts[::4]
            else:
                qs, ts = _pairs(rng, 16, cq, mode)
            c = res["cases"][(W, mode)] = _align_case(
                torch, np, W, mode, cq, qs, ts, " check", 16)
            print(f"[3e widths] layout {built} | "
                  f"{_align_line(W, mode, bq, '', 64, r)} | held against "
                  f"the plain versions on "
                  f"{'every fourth pair' if cq == bq else '16 pairs'} "
                  f"(bq={cq} bt={c['bt']} Dmax={c['Dmax']}): "
                  f"finite={c['finite']}/16, {c['n_moves']} moves exact, "
                  f"plain wavefront {c['wf_plain_ms']:.1f} ms, traceback "
                  f"{c['tb_plain_ms']:.1f} ms", flush=True)
    # a ragged width on phase 3's short and unalignable batches
    for mode, make, tag in (
            ("global", _short_pairs, " short pairs"),
            ("tglocal", _short_pairs, " short pairs"),
            ("qglocal", _unalignable_pairs, " unalignable pairs"),
            ("tglocal", _unalignable_pairs, " unalignable pairs")):
        qs, ts = make(rng, 256, 2048, mode)
        r = res["cases"][(200, mode, tag)] = _align_case(
            torch, np, 200, mode, 2048, qs, ts, tag, 256)
        print(f"[3e widths] W=200 {mode} bq=2048 Dmax={r['Dmax']}{tag}: "
              f"finite={r['finite']}/256, {r['n_moves']} moves exact",
              flush=True)
    # the pair-HMM forward: timed at the bench shape of phase 3 (P =
    # 256, 512 bp windows), then on every edge batch
    pvec = ph.params_vector()
    P, WIN = 256, 512
    q, n, t, m = _windows(np, rng, P, WIN, (400, 501))
    worst = 0.0
    for W in HMM_WIDTHS:
        qg, trg, G = ba.prepare_batch(q, t, W)
        Dmax, lo = ba.build_schedule(WIN, WIN, W)
        args = (torch.from_numpy(qg).to("cuda"),
                torch.from_numpy(trg).to("cuda"),
                torch.from_numpy(n).to("cuda"),
                torch.from_numpy(m).to("cuda"), lo, pvec)
        kw = dict(W=W, Lt=WIN, G=G)
        k = ph.pairhmm_forward(*args, **kw)
        t0 = time.perf_counter()
        p = ph.pairhmm_forward_plain(*args, **kw)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        rel = hb.max_rel_err(k, p)
        if not rel <= 1e-3 or not bool((k[p < -1e29] == -1e30).all()):
            _fail(f"pairhmm W={W} P={P}: rel err {rel} over the bar, or "
                  "an out-of-band pair not exactly NEG")
        ms = time_ms(lambda: ph.pairhmm_forward(*args, **kw), 3)
        work = bench.pairhmm_work(n, m, Dmax=Dmax, W=W, LQG=qg.shape[1],
                                  LTG=trg.shape[1])
        bound = bench.bound_ms(work["ops"], work["bytes"], work["peak"])[0]
        for kind in hb.EDGE_KINDS:
            b = hb.edge_batch(kind, W)
            a_e, kw_e = hb.to_device(b, W, pvec, "cuda")
            k_e = ph.pairhmm_forward(*a_e, **kw_e)
            p_e = ph.pairhmm_forward_plain(*a_e, **kw_e)
            rel_e = hb.max_rel_err(k_e, p_e)
            if not rel_e <= 1e-3 or \
                    not bool((k_e[p_e < -1e29] == -1e30).all()):
                _fail(f"pairhmm edge batch {kind} W={W}: rel err {rel_e} "
                      "over the bar, or an out-of-band pair not exactly "
                      "NEG")
            worst = max(worst, rel_e)
        print(f"[3e widths] pairhmm_forward W={W} layout "
              f"{_kernels.layout_width('pairhmm_forward', W)} "
              f"({_kernels.pairhmm_cells(W, P)} cells a lane) P={P} "
              f"win={WIN} | max rel err {rel:.3g}, edge batches "
              f"{len(hb.EDGE_KINDS)} kinds within the bar | kernel "
              f"{ms:.3f} ms (plain {plain_ms:.1f} ms) | bound "
              f"{bound:.4f} ms, SFU floor {work['sfu_ms']:.4f} ms",
              flush=True)
    print(f"[3e widths] pairhmm_forward edge batches at W = "
          f"{'/'.join(map(str, HMM_WIDTHS))}: max rel err {worst:.3g} "
          "(bar 1e-3), out-of-band pairs exactly NEG", flush=True)
    # the golden fixture at each band configuration on cuda against the
    # JAX package's digests, the band widths of its wavefront launches
    # recorded
    tmp = tempfile.mkdtemp(prefix="chip_smoke_widths_")
    try:
        kc.write_inputs(f"{tmp}/in")
        for g in kc.BAND_GROUPS:
            with kc.launch_log() as log:
                r = _knob_run(g, f"{tmp}/in", f"{tmp}/{g.name}", None)
            sections = g.sections
            want_w = {sections["align"]["band"],
                      sections.get("overlap", {}).get("band", 256),
                      max(512, sections["align"]["band"])}
            seen_w = {w for _, w in log["wavefront"]}
            if not want_w <= seen_w or min(
                    r["launches"][k] for k in ("banded_wavefront",
                                               "traceback")) <= 0:
                _fail(f"golden {g.name}: wavefront widths {sorted(seen_w)}, "
                      f"want {sorted(want_w)}; launches {r['launches']}")
            print(f"[3e widths] golden {g.name} on cuda in "
                  f"{sum(r['seconds'].values()):.1f} s: wavefront widths "
                  f"{sorted(seen_w)}, launches {r['launches']} | 3-unzip "
                  f"and 4-polish equal to the JAX package's digests, "
                  f"{r['qv_diffs']} consensus QVs differ (by at most 1)",
                  flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[3e widths] phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return res


def _knob_run(group, inputs, d, default_out) -> dict:
    """One group of utils/knob_configs.py through the port's command line
    on cuda, each stage's artifacts held to the JAX package's digest (the
    consensus QVs within 1).  Returns the stages' seconds, the kernels'
    launches and the number of QVs that differ."""
    from falcon_unzip_tpu_torch.ops import _kernels
    from falcon_unzip_tpu_torch.utils import knob_configs as kc
    out = f"{d}/out"
    if group.stages[0] == "quiver":
        kc.seed_unzip(group, default_out, out)
    os.makedirs(d, exist_ok=True)
    with open(f"{d}/run.json", "w") as fh:
        json.dump(kc.run_config(group, inputs, out), fh)
    _kernels.reset_counts()
    seconds = {}
    for stage in group.stages:
        t0 = time.perf_counter()
        _cli(d, stage)
        seconds[stage] = time.perf_counter() - t0
    launches = _launches((_kernels.WAVEFRONT, _kernels.TRACEBACK,
                          _kernels.ARROW))
    n_qv = 0
    for stage in group.stages:
        try:
            n_qv += kc.check(group.name, stage, out)
        except ValueError as e:
            _fail(f"{group.name} on cuda: {e}")
    return {"seconds": seconds, "launches": launches, "qv_diffs": n_qv}


def phase_knobs(golden_dir) -> None:
    """Phase 4k: every knob group of utils/knob_configs.py through the
    port's command line on cuda, each stage's artifacts against the JAX
    package's digest; the 4-polish-only groups start from phase 4's
    3-unzip.  Each group's line: its stages' seconds, its launches, the
    wavefront's P and the Arrow sweeps' builds (warps a block, C, tier
    mode)."""
    from falcon_unzip_tpu_torch.utils import knob_configs as kc
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_knobs_")
    try:
        for g in kc.GROUPS:
            if g.name == "default":
                continue
            with kc.launch_log() as log:
                r = _knob_run(g, golden_dir, f"{tmp}/{g.name}",
                              f"{golden_dir}/out")
            missed = kc.missed_build(g.name, log)
            if missed:
                _fail(missed)
            arrow = log["arrow"]
            wf_p = sorted({p for p, _ in log["wavefront"]})
            builds = sorted({(p, w, c, lj) for p, w, c, lj, _ in arrow})
            tiers = any(t for *_, t in arrow)
            secs = ", ".join(f"{stage} {v:.2f} s"
                             for stage, v in r["seconds"].items())
            print(f"[4k knobs] {g.name} ({g.kind}, {g.inputs}) {secs} | "
                  f"launches {r['launches']} | wavefront P {wf_p} | Arrow "
                  f"{len(arrow)} launches, (P, warps, C, LJ) {builds}, "
                  f"per-base tiers {'yes' if tiers else 'no'} | equal to "
                  f"the JAX package's digests, {r['qv_diffs']} consensus "
                  f"QVs differ (by at most 1)", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[4k knobs] {len(kc.GROUPS)} runs; the default's is phase 4's "
          f"| phase {time.perf_counter() - t_phase:.1f} s", flush=True)


class _PlainScorer:
    """PairHMMScorer's interface over pairhmm_forward_plain on the card."""

    def __init__(self, torch, W):
        from falcon_unzip_tpu_torch.ops.pairhmm import params_vector
        self.torch = torch
        self.W = W
        self.pvec = params_vector()

    def __call__(self, q, t, n, m):
        import numpy as np
        from falcon_unzip_tpu_torch.ops import banded_align as ba
        from falcon_unzip_tpu_torch.ops.pairhmm import pairhmm_forward_plain
        qg, trg, G = ba.prepare_batch(q, t, self.W)
        _, lo = ba.build_schedule(q.shape[1], t.shape[1], self.W)
        dt = lambda x: self.torch.from_numpy(
            np.ascontiguousarray(x)).to("cuda")
        return pairhmm_forward_plain(
            dt(qg), dt(trg), dt(n.astype(np.int32)), dt(m.astype(np.int32)),
            lo, self.pvec, W=self.W, Lt=t.shape[1], G=G).cpu().numpy()


class _ShapeLog:
    """A scorer that records the (P, Lq, Lt) of each call and keeps the
    inputs of the largest, then hands the call on."""

    def __init__(self, inner):
        self.inner = inner
        self.shapes = []
        self.largest = None

    def __call__(self, q, t, n, m):
        self.shapes.append((q.shape[0], q.shape[1], t.shape[1]))
        if self.largest is None or q.shape[0] > self.largest[0].shape[0]:
            self.largest = (q, t, n, m)
        return self.inner(q, t, n, m)


def phase_reforward(torch, np, d) -> dict:
    """Re-forward polish through the pair-HMM kernel on the golden
    fixture's contigs and raw-read AlnSet, against the same polish with
    the scorer's plain version, and the oracle window."""
    from falcon_unzip_tpu_torch.scripts.common import time_ms
    from falcon_unzip_tpu_torch.models.aligner import AlnSet
    from falcon_unzip_tpu_torch.models.polisher import (Polisher,
                                                         PolisherConfig,
                                                         _WinState)
    from falcon_unzip_tpu_torch.ops import _kernels
    from falcon_unzip_tpu_torch.ops.pairhmm import PairHMMScorer
    from falcon_unzip_tpu_torch.oracle.hmm import polish_window_oracle
    from falcon_unzip_tpu_torch.utils.simulate import (mutate_read,
                                                       random_genome)
    contigs = []
    for fn in ("all_p_ctg.fa", "all_h_ctg.fa"):
        contigs += _read_fasta(np, f"{d}/out/3-unzip/{fn}")
    with open(f"{d}/out/4-polish/1-track/aln_set.msgpack", "rb") as fh:
        aln = AlnSet.from_bytes(fh.read())
    W = 128
    # margin_frac > 1 makes every covered column a candidate, so every
    # window with enough reads scores its mutations through the scorer
    pcfg = PolisherConfig(margin_frac=1.01)
    log = _ShapeLog(PairHMMScorer(W=W, device="cuda"))
    _kernels.reset_counts()
    t0 = time.perf_counter()
    got = Polisher(pcfg, scorer=log).polish_all(contigs, aln)
    kernel_s = time.perf_counter() - t0
    launches = _kernels.PAIRHMM.launches
    cells = _kernels.PAIRHMM.cells
    t0 = time.perf_counter()
    want = Polisher(pcfg, scorer=_PlainScorer(torch, W)
                    ).polish_all(contigs, aln)
    plain_s = time.perf_counter() - t0
    if launches <= 0:
        _fail("the re-forward polish did not launch the pair-HMM kernel")
    for a, b in zip(got, want):
        if not np.array_equal(a.seq, b.seq):
            _fail(f"re-forward polish of {a.name}: kernel and plain "
                  "consensus differ")
    # the window of tests/test_polisher.py::test_arrow_matches_window_oracle
    rng = np.random.default_rng(7)
    truth = random_genome(48, 7)
    draft = truth.copy()
    draft[10] = (draft[10] + 1) % 4
    draft[30] = (draft[30] + 2) % 4
    reads = [mutate_read(truth, 0.03, rng) for _ in range(8)]
    ref = polish_window_oracle(draft, reads, [10, 30], max_rounds=8)
    st = _WinState(cns=draft.copy(), votes=np.zeros((48, 9, 5), np.int32),
                   segs=reads, active=True, cand=[10, 30])
    Polisher(PolisherConfig(arrow_rounds=8),
             scorer=PairHMMScorer(W=W, device="cuda"))._refine_windows([st])
    if not (np.array_equal(st.cns, ref) and np.array_equal(st.cns, truth)):
        _fail("re-forward window differs from polish_window_oracle")
    n_bp = sum(len(c.seq) for c in got)
    print(f"[4b reforward] {len(got)} contigs, {n_bp} bp | kernel run "
          f"{kernel_s:.1f} s, {launches} pair-HMM launches, {cells} band "
          f"cells | plain run {plain_s:.1f} s | consensus equal | oracle "
          f"window equal", flush=True)
    # the launches' shapes, and the kernel timed at the largest one
    from collections import Counter
    from falcon_unzip_tpu_torch import bench
    from falcon_unzip_tpu_torch.ops import pairhmm as ph
    from falcon_unzip_tpu_torch.utils import hmm_batches as hb
    shapes = ", ".join(f"{k} x P={a} Lq={b} Lt={c}" for (a, b, c), k in
                       sorted(Counter(log.shapes).items()))
    q, t, n, m = log.largest
    b = {"q": q, "t": t, "n": n.astype(np.int32), "m": m.astype(np.int32),
         "Dmax": q.shape[1] + t.shape[1] + 1}
    args, kw = hb.to_device(b, W, ph.params_vector(), torch.device("cuda"))
    # that launch held against the plain version on the same inputs
    k = ph.pairhmm_forward(*args, **kw)
    t0 = time.perf_counter()
    p = ph.pairhmm_forward_plain(*args, **kw)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    rel = hb.max_rel_err(k, p)
    if not rel <= 1e-3 or not bool((k[p < -1e29] == -1e30).all()) \
            or not bool(torch.isfinite(k).all()):
        _fail(f"pairhmm at the re-forward launch shape: rel err {rel} over "
              "the bar, or an out-of-band pair not exactly NEG")
    ok = p > -1e29
    err = float((k[ok].double() - p[ok].double()).abs().max()) \
        if bool(ok.any()) else 0.0
    ms = time_ms(lambda: ph.pairhmm_forward(*args, **kw), 10)
    work = bench.pairhmm_work(b["n"], b["m"], Dmax=b["Dmax"], W=W,
                              LQG=args[0].shape[1], LTG=args[1].shape[1])
    bound = bench.bound_ms(work["ops"], work["bytes"], work["peak"])[0]
    print(f"[4b reforward] launch shapes at W={W}: {shapes} | largest "
          f"P={q.shape[0]} Lq={q.shape[1]} Lt={t.shape[1]} ("
          f"{_kernels.pairhmm_cells(W, q.shape[0])} cells a lane): in-band "
          f"{int(ok.sum())}/{q.shape[0]}, max abs err {err:.3g} rel "
          f"{rel:.3g} (bar 1e-3) | kernel {ms:.4f} ms (plain {plain_ms:.1f} "
          f"ms) | bound {bound:.4f} ms, SFU floor {work['sfu_ms']:.4f} ms",
          flush=True)
    return {"launches": launches, "err": err, "ms": ms, "plain_ms": plain_ms,
            "work": work}


def _write_track_bam(np, r2c_path, reads_path, ref_path, bam_path):
    """A BAM of the reads the track map places: each read at its contig
    and start, one M op of its length, flag 16 on the reverse strand."""
    from falcon_unzip_tpu_torch.io import bamlite as bl
    from falcon_unzip_tpu_torch.io.fasta import read_fasta
    from falcon_unzip_tpu_torch.io.serialize import deserialize
    reads = read_fasta(reads_path)
    refs = read_fasta(ref_path)
    recs = []
    for k, (ctg, t0, _t1, strand) in sorted(
            (int(k), v) for k, v in deserialize(r2c_path).items()):
        seq = reads.row(k)
        recs.append(bl.BamRecord(
            name=reads.names[k], flag=16 if strand else 0, ref_id=int(ctg),
            pos=int(t0), mapq=60, cigar=[(len(seq), 0)], seq=seq,
            qual=np.full(len(seq), 30, np.uint8)))
    bl.write_bam(bam_path, bl.BamFile(
        text="@HD\tVN:1.6\n",
        refs=[(refs.names[i], int(refs.lengths[i])) for i in range(len(refs))],
        records=recs))
    return len(recs)


def phase_cli(np, d) -> dict:
    """The nine subcommands of the port's command line on the golden
    fixture on the card, each with the counts set to 0 just before it and
    read just after; the five that align run again with --device cpu (the
    plain versions) and their output files must be byte-identical."""
    from falcon_unzip_tpu_torch.cli import main as cli_main
    from falcon_unzip_tpu_torch.ops import _kernels
    from falcon_unzip_tpu_torch.utils.fixtures import dir_bytes
    u = f"{d}/out/3-unzip"
    c = f"{d}/cli"
    bam = f"{c}/track.bam"
    argv = {
        "phase": ["--preads", f"{d}/preads.fa", "--draft", f"{d}/draft.fa",
                  "--out", "{o}/phased_reads"],
        "ovlp-filter": ["--preads", f"{d}/preads.fa", "--phased-reads",
                        f"{u}/all_phased_reads", "--out",
                        "{o}/filtered.json"],
        "track": ["--reads", f"{d}/raw.fa", "--contigs", f"{u}/all_p_ctg.fa",
                  "--out", "{o}/r2c.msgpack"],
        "dedup": ["--p-ctg", f"{u}/all_p_ctg.fa", "--h-ctg",
                  f"{u}/all_h_ctg.fa", "--out", "{o}/h.dedup.fa"],
        "graph": ["--preads", f"{d}/preads.fa", "--phased-reads",
                  f"{u}/all_phased_reads", "--out-dir", "{o}/graph"],
        "gen-gfa": ["--unzip-dir", u, "--out", "{o}/asm.gfa"],
        "readmap": [f"{c}/card/phase/phased_reads", f"{u}/all_phased_reads",
                    "--out", "{o}/rid_to_phase.all"],
        "select-reads": ["--bam", bam, "--map",
                         f"{c}/card/track/r2c.msgpack", "--reads",
                         f"{d}/raw.fa", "--out-pattern", "{o}/ctg_{{}}.bam"],
        "bam2m4": ["--bam", bam, "--out", "{o}/aln.m4"],
    }
    aligns = ("phase", "ovlp-filter", "track", "dedup", "graph")
    align = (_kernels.WAVEFRONT, _kernels.TRACEBACK)
    rows = {}
    for cmd, args in argv.items():
        if cmd == "select-reads":
            n_rec = _write_track_bam(np, f"{c}/card/track/r2c.msgpack",
                                     f"{d}/raw.fa", f"{u}/all_p_ctg.fa", bam)
        outs = {}
        runs = (("card", "cuda"), ("host", "cpu"))
        for tag, dev in runs if cmd in aligns else runs[:1]:
            o = f"{c}/{tag}/{cmd}"
            os.makedirs(o)
            extra = ["--device", dev] if cmd in aligns else []
            _kernels.reset_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                code = cli_main([cmd] + [a.format(o=o) for a in args]
                                + extra)
            wall = time.perf_counter() - t0
            if code != 0:
                _fail(f"cli {cmd} --device {dev} exited {code}")
            outs[tag] = dir_bytes(o)
            if tag == "card":
                rows[cmd] = {"s": round(wall, 2), **_launches(align)}
            else:
                rows[cmd]["cpu_s"] = round(wall, 2)
        if not any(len(v) for v in outs["card"].values()):
            _fail(f"cli {cmd}: no output")
        if cmd in aligns:
            if outs["card"] != outs["host"]:
                _fail(f"cli {cmd}: card and CPU outputs differ")
            if min(rows[cmd][k.name] for k in align) <= 0:
                _fail(f"cli {cmd} did not align on the card: {rows[cmd]}")
    print(f"[4c cli] nine subcommands on the golden fixture, --device cuda "
          f"(seconds, launches; cpu_s: the same with --device cpu, outputs "
          f"byte-identical): {rows} | select-reads and bam2m4 over a BAM of "
          f"{n_rec} tracked raw reads", flush=True)
    return rows


def _stats(lens) -> dict:
    lens = sorted(lens, reverse=True)
    total, acc, n50 = sum(lens), 0, 0
    for x in lens:
        acc += x
        if 2 * acc >= total:
            n50 = x
            break
    return {"n_seqs": len(lens), "total_bp": total, "n50": n50,
            "max_len": lens[0] if lens else 0}


def _stage_rows(path, skip: int = 0, stop: int | None = None) -> dict:
    """{stage: row} of the timed rows of metrics.jsonl from line skip up
    to line stop."""
    stages = {}
    with open(path) as fh:
        for ln in list(fh)[skip:stop]:
            row = json.loads(ln)
            if "s" in row:
                row.pop("ts")
                stages[row.pop("stage")] = row
    return stages


def _timed_run(d, cmd, kernels) -> tuple:
    """One stage of the main path through the e2e bench's timed_stage
    (the counts set to 0 just before it and read just after); returns
    (wall s, launches, device ms, cells) of `kernels`."""
    from falcon_unzip_tpu_torch.scripts.e2e_bench import timed_stage
    _, wall, *rows = timed_stage(lambda: _cli(d, cmd), True)
    return (wall, *({k.name: row[k.name] for k in kernels} for row in rows))


def phase_main(torch, tmp, genome_bp) -> dict:
    from falcon_unzip_tpu_torch.ops import _kernels
    from falcon_unzip_tpu_torch.scripts.e2e_bench import (contig_lengths,
                                                          simulate)
    d = os.path.join(tmp, "main")
    os.makedirs(d)
    t0 = time.perf_counter()
    draft, preads, raw = [], [], []
    # the e2e bench's contigs at 25x, simulated side by side
    sims = simulate(contig_lengths(genome_bp, "n50"), 25.0)
    for ci, (dip, pr, rw) in enumerate(sims):
        draft.append((f"draft{ci}", dip))
        preads.append((f"c{ci}/", pr))
        raw.append((f"c{ci}/", rw))
    _write_inputs(d, draft, preads, raw)
    n_preads = sum(len(b) for _, b in preads)
    n_raw = sum(len(b) for _, b in raw)
    sim_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    align = (_kernels.WAVEFRONT, _kernels.TRACEBACK)
    unzip_s, u_launch, u_ms, u_cells = _timed_run(d, "unzip", align)
    p_ctg = _stats(_fasta_lengths(f"{d}/out/3-unzip/all_p_ctg.fa"))
    h_ctg = _stats(_fasta_lengths(f"{d}/out/3-unzip/all_h_ctg.fa"))
    with open(f"{d}/out/3-unzip/all_phased_reads") as fh:
        n_phased = sum(1 for _ in fh)
    rate = (u_cells["banded_wavefront"]
            / max(u_ms["banded_wavefront"], 1e-9) / 1e6)
    stages = _stage_rows(f"{d}/out/metrics.jsonl")
    with open(f"{d}/out/metrics.jsonl") as fh:
        n_rows = sum(1 for _ in fh)
    print(f"[5 main unzip] genome {genome_bp} bp n50 profile, {n_preads} "
          f"preads 25x | sim {sim_s:.1f} s | unzip {unzip_s:.1f} s | stages"
          f" {stages} | launches {u_launch} | DP cells "
          f"{u_cells['banded_wavefront']} | kernel device ms {u_ms} | "
          f"{rate:.2f} Gcell/s in the wavefront kernel | p_ctg {p_ctg} | "
          f"h_ctg {h_ctg} | phased reads {n_phased}", flush=True)
    quiver_s, q_launch, q_ms, q_cells = _timed_run(
        d, "quiver", align + (_kernels.ARROW,))
    peak = torch.cuda.max_memory_allocated()
    q_stages = _stage_rows(f"{d}/out/metrics.jsonl", n_rows)
    cns_p = _stats(_fasta_lengths(f"{d}/out/4-polish/cns_p_ctg.fasta"))
    cns_h = _stats(_fasta_lengths(f"{d}/out/4-polish/cns_h_ctg.fasta"))
    with open(f"{d}/out/4-polish/2-polish/stage.done.json") as fh:
        mean_qv = json.load(fh).get("metrics", {}).get("mean_qv")
    print(f"[5 main quiver] {n_raw} raw reads 29x 3% error | quiver "
          f"{quiver_s:.1f} s | stages {q_stages} | launches {q_launch} | "
          f"kernel device ms {q_ms} | splice rows x columns "
          f"{q_cells['arrow_splice']} | mean_qv {mean_qv} | cns_p {cns_p} |"
          f" cns_h {cns_h} | peak device memory {peak / 2**30:.3f} GiB",
          flush=True)
    if p_ctg["total_bp"] < 0.9 * genome_bp:
        _fail(f"primary bp {p_ctg['total_bp']} < 90% of {genome_bp}")
    if h_ctg["n_seqs"] < 1:
        _fail("no haplotig")
    if n_phased == 0:
        _fail("all_phased_reads is empty")
    if min(u_launch.values()) <= 0:
        _fail(f"main unzip did not launch every DP kernel: {u_launch}")
    if cns_p["total_bp"] < 0.9 * genome_bp:
        _fail(f"polished primary bp {cns_p['total_bp']} < 90% of "
              f"{genome_bp}")
    if min(q_launch.values()) <= 0:
        _fail(f"main quiver did not launch every kernel: {q_launch}")
    return {"launches": {**u_launch, "arrow_splice":
                         q_launch["arrow_splice"]}, "dir": d,
            "unzip_s": unzip_s, "quiver_s": quiver_s,
            "haps": [h for _, dip in draft for h in (dip.hap0, dip.hap1)]}


def phase_truth(main_run, genome_bp) -> None:
    """Phase 5d: phase 5's consensus scored against its simulated truth
    by the e2e bench's _truth_qv, re-aligning on the card and on the CPU
    (QV and breakdown must be equal), then the QV calibration and
    attribution twins on phase 5's directory on the card and the 1-align
    profile at its default 300 kb."""
    from falcon_unzip_tpu_torch.ops import _kernels
    from falcon_unzip_tpu_torch.scripts import (e2e_bench, profile_align,
                                                qv_attrib, qv_calibrate)
    d, haps = main_run["dir"], main_run["haps"]
    t_all = time.perf_counter()
    for stem in ("cns_p_ctg", "cns_h_ctg"):
        path = f"{d}/out/4-polish/{stem}.fasta"
        _kernels.reset_counts()
        t0 = time.perf_counter()
        card = e2e_bench._truth_qv(path, haps, device="cuda")
        card_s = time.perf_counter() - t0
        launches = _launches((_kernels.WAVEFRONT, _kernels.TRACEBACK))
        t0 = time.perf_counter()
        host = e2e_bench._truth_qv(path, haps, device="cpu")
        host_s = time.perf_counter() - t0
        if card != host:
            _fail(f"truth QV of {stem}: card {card} != CPU {host}")
        print(f"[5d truth] {stem}: truth QV {card[0]} | breakdown {card[1]} "
              f"| card {card_s:.2f} s, launches {launches} | CPU "
              f"{host_s:.2f} s, equal", flush=True)
    argv = [str(genome_bp), "25", "n50", "--device", "cuda", "--scratch", d]
    t0 = time.perf_counter()
    qv_calibrate.main(argv)
    cal_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        qv_attrib.main(argv)
    att_s = time.perf_counter() - t0
    att = json.loads(buf.getvalue().strip().splitlines()[-1])
    att["sample"] = f"{len(att['sample'])} rows, not printed"
    print(json.dumps(att), flush=True)
    t0 = time.perf_counter()
    profile_align.main(["--device", "cuda"])
    prof_s = time.perf_counter() - t0
    wall = time.perf_counter() - t_all
    print(f"[5d truth] qv_calibrate {cal_s:.1f} s, qv_attrib {att_s:.1f} s, "
          f"profile_align {prof_s:.1f} s | phase 5d {wall:.1f} s", flush=True)


def _union_us(spans) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for a, b in sorted(spans):
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def phase_traced(torch, d) -> dict:
    """run_unzip again on phase 5's inputs into a fresh out_dir with
    cfg.profile_dir set: its 3-unzip/ must equal phase 5's, and the trace
    must hold as many wavefront and traceback kernels as the launch
    counts.  The device's busy share: the union of the kernel and memcpy
    intervals of the trace over the trace's span."""
    from falcon_unzip_tpu_torch.config import load_config
    from falcon_unzip_tpu_torch.ops import _kernels
    from falcon_unzip_tpu_torch.pipeline.unzip import run_unzip
    from falcon_unzip_tpu_torch.utils.fixtures import run_artifacts
    cfg = load_config(f"{d}/run.json")
    cfg.out_dir = f"{d}/traced"
    cfg.profile_dir = f"{d}/prof"
    align = (_kernels.WAVEFRONT, _kernels.TRACEBACK)
    _kernels.reset_counts()
    t0 = time.perf_counter()
    run_unzip(cfg, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches(align)
    if run_artifacts(f"{d}/traced", ("3-unzip/**/*",)) != run_artifacts(
            f"{d}/out", ("3-unzip/**/*",)):
        _fail("the traced unzip's 3-unzip/ differs from phase 5's")
    traces = [f for f in os.listdir(cfg.profile_dir)
              if f.startswith("unzip.") and f.endswith(".pt.trace.json")]
    if len(traces) != 1:
        _fail(f"traced unzip wrote {traces}, not one unzip trace")
    path = os.path.join(cfg.profile_dir, traces[0])
    size_mb = os.path.getsize(path) / 1e6
    t0 = time.perf_counter()
    with open(path) as fh:
        events = [e for e in json.load(fh)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    parse_s = time.perf_counter() - t0
    span = (max(e["ts"] + e["dur"] for e in events)
            - min(e["ts"] for e in events))
    kern = [e for e in events if e.get("cat") == "kernel"]
    copy = [e for e in events if e.get("cat") == "gpu_memcpy"]
    ours = {k.name: sum(1 for e in kern if f"{k.name}_kernel" in e["name"])
            for k in align}
    busy = _union_us([(e["ts"], e["ts"] + e["dur"]) for e in kern + copy])
    kern_ms = sum(e["dur"] for e in kern) / 1e3
    ours_ms = sum(e["dur"] for e in kern
                  if any(f"{k}_kernel" in e["name"] for k in ours)) / 1e3
    copy_ms = sum(e["dur"] for e in copy) / 1e3
    print(f"[5c traced] run_unzip with profile_dir: wall {wall:.1f} s "
          f"(trace written in it), 3-unzip/ equal to phase 5's | trace "
          f"{size_mb:.1f} MB, parsed in {parse_s:.1f} s, span "
          f"{span / 1e6:.3f} s | kernels {len(kern)} ({kern_ms:.1f} ms; "
          f"wavefront + traceback {ours} = launch counts {launches}, "
          f"{ours_ms:.1f} ms), memcpy {len(copy)} ({copy_ms:.1f} ms) | "
          f"device busy share {busy / span:.5f} ({busy / 1e3:.1f} ms of "
          f"kernel and memcpy union over the trace's span)", flush=True)
    if ours != launches or min(launches.values()) <= 0:
        _fail(f"the trace holds {ours} wavefront and traceback kernels, the "
              f"launch counts are {launches}")
    return {"busy_share": busy / span, "span_s": span / 1e6, "wall_s": wall}


def phase_sharded_ops(torch, np, devices=("cuda:0",) * 4) -> dict:
    """Phase 10 (a): every sharded op of parallel/ on a 2 x 2 mesh of
    ``devices`` (4 logical shards on cuda:0) with the debug checks on,
    held against the single-device op on cuda:0 at the main path's
    sizes; each line prints the launches of the sharded call (its
    shards' and the debug check's single-device one)."""
    from falcon_unzip_tpu_torch.models.polisher import PolisherConfig
    from falcon_unzip_tpu_torch.ops import _kernels
    from falcon_unzip_tpu_torch.ops import pairhmm as ph
    from falcon_unzip_tpu_torch.ops.arrow import ArrowSplicer
    from falcon_unzip_tpu_torch.ops.association import \
        association_band_batch
    from falcon_unzip_tpu_torch.ops.pileup import pileup_batch
    from falcon_unzip_tpu_torch.parallel import collectives, debug, sharding
    from falcon_unzip_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(window_par=2, device=list(devices))
    rng = np.random.default_rng(1010)
    dev = torch.device("cuda:0")
    debug.enable(True)
    res = {}

    def launched():
        return {k.name: k.launches for k in _kernels.KERNELS if k.launches}

    try:
        # pileup and association at a 1 Mb contig's tag count: 25x 2200
        # bp preads (11,360), 1.2% het over 60% of it (7,200 sites)
        t_len, n_tags, R, S, span = 1_000_000, 25_000_000, 11_360, 7_200, 64
        pos = rng.integers(-1, t_len, n_tags).astype(np.int32)
        base = rng.integers(0, 5, n_tags).astype(np.int32)
        ops = sharding.ShardedPhaseOps(mesh)
        _kernels.reset_counts()
        t0 = time.perf_counter()
        counts = ops.pileup(pos, base, t_len=t_len)
        pile_s = time.perf_counter() - t0
        want = pileup_batch(torch.from_numpy(pos[None]).to(dev),
                            torch.from_numpy(base[None]).to(dev),
                            t_len=t_len)[0].cpu().numpy()
        if not np.array_equal(counts, want):
            _fail("sharded pileup differs from the single-device pileup")
        M = np.zeros((R, S), np.int8)
        start = rng.integers(0, S - 20, R)
        cols = start[:, None] + np.arange(20)[None, :]
        M[np.arange(R)[:, None], cols] = rng.choice(
            np.array([-1, 0, 1], np.int8), size=(R, 20), p=[0.45, 0.1, 0.45])
        t0 = time.perf_counter()
        score, cov = ops.association(M, max_span=span)
        assoc_s = time.perf_counter() - t0
        ws, wc = association_band_batch(torch.from_numpy(M[None]).to(dev),
                                        max_span=span)
        if not (np.array_equal(score, ws[0].cpu().numpy())
                and np.array_equal(cov, wc[0].cpu().numpy())):
            _fail("sharded association differs from the single-device one")
        print(f"[10a sharded] mesh {dict(mesh.shape)} on {devices}, debug "
              f"checks on | pileup of {n_tags} tags over "
              f"{t_len} bp {pile_s:.2f} s, association of {R} reads x {S} "
              f"sites, span {span}, {assoc_s:.2f} s: bit-exact | launches "
              f"{launched()}", flush=True)
        # window-sharded votes at phase 5's largest contig (500 kb, 29x
        # 1800 bp raw reads: ~1 tag a read base)
        t_len, n_tags = 500_000, 14_500_000
        window = PolisherConfig().window
        pos = rng.integers(-1, t_len, n_tags).astype(np.int32)
        delta = np.minimum(rng.geometric(0.7, n_tags) - 1, 10).astype(
            np.int32)
        base = rng.integers(0, 5, n_tags).astype(np.int32)
        votes = sharding.ShardedWindowVotes(mesh)
        _kernels.reset_counts()
        t0 = time.perf_counter()
        blocks, seg = votes.blocks(pos, delta, base, t_len=t_len,
                                   window=window)
        votes_s = time.perf_counter() - t0
        # the debug check held each segment against vote_matrix; each
        # halo must be the next segment's head, so every polish window
        # sliced from one block equals vote_matrix
        for s in range(votes.nw - 1):
            if not np.array_equal(blocks[s, seg:], blocks[s + 1, :window]):
                _fail(f"window-sharded votes: segment {s}'s halo differs "
                      f"from segment {s + 1}'s head")
        print(f"[10a sharded] window votes of {n_tags} tags over {t_len} bp"
              f" ({mesh.shape['window']} segments of {seg}, halo {window})"
              f" {votes_s:.2f} s: every segment equal to vote_matrix (the "
              f"debug check), every halo the next segment's head | launches"
              f" {launched()}", flush=True)
        # the all_to_all regroup of phase 5's 16,109 raw reads by contig
        # (6 primaries + 17 haplotigs), and the halo exchange
        ctg = rng.integers(-1, 23, 16_109).astype(np.int64)
        t0 = time.perf_counter()
        groups = collectives.regroup_partition(ctg, 23, mesh)
        regroup_s = time.perf_counter() - t0
        if any(not np.array_equal(g, np.nonzero(ctg == k)[0])
               for k, g in enumerate(groups)):
            _fail("regroup_partition over the mesh differs from the host "
                  "group-by")
        recv, counts, dropped = collectives.make_regroup(
            mesh, cap=2, feat=2)(np.stack([np.arange(16), np.arange(16)],
                                          axis=1).astype(np.int32),
                                 np.zeros(16, np.int32))   # all to shard 0
        if int(dropped.sum()) != 8 or int(counts.sum()) != 8:
            _fail(f"regroup overflow: dropped {dropped.tolist()}")
        x = torch.arange(2 * 50 * 3, dtype=torch.int32).reshape(100, 3)
        lg, rg = collectives.make_halo_exchange(mesh, halo=7)(x)
        if not (torch.equal(lg.cpu(), torch.cat([x[-7:], x[43:50]]))
                and torch.equal(rg.cpu(), torch.cat([x[50:57], x[:7]]))):
            _fail("halo exchange differs from the shards' edge rows")
        print(f"[10a sharded] regroup_partition of {len(ctg)} reads into 23 "
              f"contigs {regroup_s:.2f} s: equal to the host group-by | "
              f"forced overflow counted | halo exchange exact", flush=True)
        # Arrow splice at the production polish shape, pairs split 4 ways
        pc = PolisherConfig()
        P, L, C = pc.splice_chunk, pc.len_cap(), pc.arrow_candidates
        q, n, t, m = _windows(np, rng, P, L, (300, 421))
        qs = [q[k, :n[k]] for k in range(P)]
        ts = [t[k, :m[k]] for k in range(P)]
        cands = [list(rng.choice(int(m[k]), size=1 + k % C, replace=False))
                 for k in range(P)]
        kw = dict(max_cand=C, chunk=P, fixed_lq=L, fixed_lj=L)
        sp = sharding.ShardedArrowSplicer(mesh, **kw)
        _kernels.reset_counts()
        got = sp(qs, ts, cands)
        sp_launch = launched()
        want = ArrowSplicer(device="cuda", **kw)(qs, ts, cands)
        g_all = np.concatenate([got[0][:, None], got[1].reshape(P, -1)], 1)
        w_all = np.concatenate([want[0][:, None], want[1].reshape(P, -1)], 1)
        rel_a = _rel_bar(np, g_all, w_all)
        warps = (_kernels.arrow_warps(P), _kernels.arrow_warps(P // 4))
        other = P if warps[0] != warps[1] else 0
        print(f"[10a sharded] ShardedArrowSplicer P={P} Lq=LJ={L} C={C}: "
              f"max rel err {rel_a:.3g} (bar 1e-3), NEG slots equal | "
              f"warps a block: {warps[0]} unsharded (P={P}), {warps[1]} a "
              f"shard (P={P // 4}): {other} pairs on the other build | "
              f"launches {sp_launch} (4 shards + the debug check's one)",
              flush=True)
        # pair-HMM at phase 4b's launch shape, pairs split 4 ways
        Pn, W = 7095, 128
        q, n, t, m = _windows(np, rng, Pn, 512, (300, 500))
        m[::97] = np.minimum(m[::97], 100)     # corners out of the band
        sc = sharding.ShardedPairHMMScorer(mesh, W=W)
        _kernels.reset_counts()
        got = sc(q, t, n, m)
        sc_launch = launched()
        want = ph.PairHMMScorer(W=W, device="cuda")(q, t, n, m)
        rel_h = _rel_bar(np, got, want)
        if not (got[want < -1e29] == np.float32(-1e30)).all():
            _fail("sharded pair-HMM: an out-of-band pair is not exactly NEG")
        print(f"[10a sharded] ShardedPairHMMScorer P={Pn} Lq=Lt=512 W={W}: "
              f"{int((want < -1e29).sum())} pairs out of the band, exactly "
              f"NEG; max rel err {rel_h:.3g} (bar 1e-3) | cells a lane "
              f"{_kernels.pairhmm_cells(W, Pn)} unsharded, "
              f"{_kernels.pairhmm_cells(W, -(-Pn // 4))} a shard | launches "
              f"{sc_launch} (4 shards + the debug check's one)", flush=True)
        res = {"arrow_launches": sp_launch.get("arrow_splice", 0),
               "pairhmm_launches": sc_launch.get("pairhmm_forward", 0)}
    finally:
        debug.enable(None)
    return res


def _rel_bar(np, got, want) -> float:
    """max |got - want| / max(1, |want|); fails over 1e-3 or where the
    NEG slots differ."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    neg = want < -1e29
    if not np.array_equal(got < -1e29, neg) or not np.isfinite(got).all():
        _fail("sharded and single-device NEG slots differ")
    rel = (np.abs(got - want) / np.maximum(1.0, np.abs(want)))[~neg]
    worst = float(rel.max()) if rel.size else 0.0
    if worst > 1e-3:
        _fail(f"sharded op off the single-device op by {worst} relative")
    return worst


_RANK_WORKER = r"""
import json, os, sys, time
import torch
from falcon_unzip_tpu_torch.config import load_config
from falcon_unzip_tpu_torch.ops import _kernels
from falcon_unzip_tpu_torch.parallel import distributed as dist
from falcon_unzip_tpu_torch.parallel.checkpoint import Stage
from falcon_unzip_tpu_torch.pipeline.quiver import run_quiver
from falcon_unzip_tpu_torch.pipeline.unzip import run_unzip
cfg = load_config(sys.argv[1])
cfg.out_dir = sys.argv[2]
cfg.mesh.multihost = True
torch.backends.cuda.matmul.allow_tf32 = False
res = {}
for stage, run in (("unzip", run_unzip), ("quiver", run_quiver)):
    _kernels.reset_counts()
    t0 = time.perf_counter()
    run(cfg, device="cuda")
    torch.cuda.synchronize()
    res[stage + "_s"] = time.perf_counter() - t0
    res[stage + "_launches"] = {k.name: k.launches for k in _kernels.KERNELS
                                if k.launches}
    if stage == "unzip" and dist.is_primary_host():
        with open(os.path.join(cfg.out_dir, "metrics.jsonl")) as fh:
            res["unzip_rows"] = sum(1 for _ in fh)
skipped = []
real = Stage.run
def spy(self, fn):
    ran = real(self, fn)
    if not ran:
        skipped.append(self.name)
    return ran
Stage.run = spy
t0 = time.perf_counter()
run_unzip(cfg, device="cuda")
run_quiver(cfg, device="cuda")
res["resume_s"] = time.perf_counter() - t0
res["skipped"] = sorted(skipped)
res["rank"] = dist.process_index()
res["device"] = str(torch.device("cuda", torch.cuda.current_device()))
print("RANK-RESULT " + json.dumps(res), flush=True)
"""

_STAGES = ["0-draft", "1-align", "1-track", "2-phasing", "2-polish",
           "3-hasm"]


def _first_diff(np, a, b):
    """(contig, column) of the first difference of two FASTA / FASTQ
    texts, by record."""
    ra = a.decode().splitlines()
    rb = b.decode().splitlines()
    step = 4 if ra and ra[0].startswith("@") else 2
    for k in range(0, max(len(ra), len(rb)), step):
        x = ra[k:k + step]
        y = rb[k:k + step]
        if x != y:
            name = (x or y)[0][1:]
            for line_x, line_y in zip(x[1:], y[1:]):
                if line_x != line_y:
                    col = next((i for i, (c, d) in enumerate(
                        zip(line_x, line_y)) if c != d),
                        min(len(line_x), len(line_y)))
                    return name, col
            return name, 0
    return None, None


def phase_two_ranks(torch, np, main_run) -> dict:
    """Phase 10 (b): run_unzip then run_quiver with cfg.mesh.multihost on
    phase 5's 1 Mb inputs in two processes of one gloo world that share
    cuda:0; the canonical 3-unzip/ and cns_* files must be byte-identical
    to phase 5's, and a resume pass must skip every stage on both ranks.
    Two ranks on one card measure the distributed layer's cost, not
    scaling."""
    import socket
    from falcon_unzip_tpu_torch.utils.fixtures import run_artifacts
    d = main_run["dir"]
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    here = os.path.dirname(os.path.abspath(__file__))
    procs = []
    t0 = time.perf_counter()
    for rank in range(2):
        env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   WORLD_SIZE="2", RANK=str(rank), LOCAL_RANK=str(rank),
                   LOCAL_WORLD_SIZE="2", PYTHONPATH=here)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _RANK_WORKER, f"{d}/run.json", f"{d}/mp"],
            cwd=d, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=420)[0])
    except subprocess.TimeoutExpired:
        _fail("a rank of the two-process run timed out")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall = time.perf_counter() - t0
    ranks = []
    for i, (p, out) in enumerate(zip(procs, outs)):
        line = [ln for ln in out.splitlines()
                if ln.startswith("RANK-RESULT ")]
        if p.returncode != 0 or not line:
            print(out[-4000:], flush=True)
            _fail(f"rank {i} of the two-process run exited {p.returncode}")
        ranks.append(json.loads(line[-1][len("RANK-RESULT "):]))
    got = run_artifacts(f"{d}/mp", ("3-unzip/*", "4-polish/cns_*"))
    want = run_artifacts(f"{d}/out", ("3-unzip/*", "4-polish/cns_*"))
    if sorted(got) != sorted(want):
        _fail(f"two-rank files {sorted(got)} != phase 5's {sorted(want)}")
    differ = [rel for rel in want if got[rel] != want[rel]]
    for rel in differ:
        if "/cns_" in rel:
            ctg, col = _first_diff(np, want[rel], got[rel])
            print(f"[10b two ranks] {rel} differs from phase 5's: first at "
                  f"contig {ctg}, column {col}", flush=True)
    if differ:
        _fail(f"two-rank run differs from phase 5's in {differ}")
    for r in ranks:
        if r["skipped"] != _STAGES:
            _fail(f"rank {r['rank']} resume skipped {r['skipped']}, not "
                  f"every stage {_STAGES}")
    n = ranks[0]["unzip_rows"]
    u_rows = _stage_rows(f"{d}/mp/metrics.jsonl", 0, n)
    q_rows = _stage_rows(f"{d}/mp/metrics.jsonl", n)
    print(f"[10b two ranks] run_unzip + run_quiver with multihost on phase "
          f"5's 1 Mb inputs, 2 gloo ranks sharing cuda:0 (the distributed "
          f"layer's cost, not scaling) | wall {wall:.1f} s with process "
          f"start | rank 0: unzip {ranks[0]['unzip_s']:.1f} s, quiver "
          f"{ranks[0]['quiver_s']:.1f} s, resume {ranks[0]['resume_s']:.1f}"
          f" s; rank 1: unzip {ranks[1]['unzip_s']:.1f} s, quiver "
          f"{ranks[1]['quiver_s']:.1f} s | phase 5 in this call: unzip "
          f"{main_run['unzip_s']:.1f} s, quiver {main_run['quiver_s']:.1f} "
          f"s | rank 0 stages: unzip {u_rows}, quiver {q_rows}", flush=True)
    print(f"[10b two ranks] launches rank 0 unzip "
          f"{ranks[0]['unzip_launches']} quiver "
          f"{ranks[0]['quiver_launches']}; rank 1 unzip "
          f"{ranks[1]['unzip_launches']} quiver {ranks[1]['quiver_launches']}"
          f" | devices {[r['device'] for r in ranks]} | {len(want)} "
          f"canonical files byte-identical to phase 5's | resume skipped "
          f"every stage on both ranks", flush=True)
    launches = {}
    for r in ranks:
        for stage in ("unzip_launches", "quiver_launches"):
            for k, v in r[stage].items():
                launches[k] = launches.get(k, 0) + v
    if min(launches.get(k, 0) for k in ("banded_wavefront", "traceback",
                                         "arrow_splice")) <= 0:
        _fail(f"the two ranks did not launch every main-path kernel: "
              f"{launches}")
    return {"launches": launches, "ranks": ranks}


def phase_scaling() -> dict:
    """Phase 11: the scaling bench's phase step across 1 and 2 gloo ranks
    sharing cuda:0 (8192 rows a rank, T = 64, t_len 4096); rank 0's
    digest must equal a one-process step's over the same rows on cuda:0
    and on the CPU.  Ranks sharing one card measure the layer's cost,
    not scaling."""
    from falcon_unzip_tpu_torch.parallel.mesh import make_mesh
    from falcon_unzip_tpu_torch.scripts import scaling_bench as sb
    res = {}
    for n in (1, 2):
        t0 = time.perf_counter()
        got = sb.measure_multiprocess(n, 1, device="cuda", cards=1)
        wall = time.perf_counter() - t0
        R = sb.r_per_dev() * n
        want = {}
        for dev in ("cuda:0", "cpu"):
            step, tagpos, tagbase = sb.run_phase_step(
                make_mesh(1, 1, device=[dev]), R)
            want[dev] = sb.phase_digest(step(tagpos, tagbase))
        if not got["digest"] == want["cuda:0"] == want["cpu"]:
            _fail(f"phase step over {n} ranks: digest {got['digest']} != "
                  f"one process's {want}")
        print(f"[11 scaling] phase step over {n} gloo rank(s) sharing "
              f"cuda:0 (ranks share one card: the layer's cost), {R} rows"
              f" | {got['reads_per_sec']:.1f} reads/s | digest "
              f"{got['digest'][:16]} equal to one process's on cuda:0 and "
              f"on the CPU | {wall:.1f} s with process start", flush=True)
        res[n] = got
    return res


def phase_hotspot(torch, np) -> dict:
    """The per-base-quality hotspot polish of
    tests/test_qv_aware.py::test_polish_per_base_profile_qv on the card:
    flat params, then per-base tiers, each with the counts set to 0 just
    before it and read just after; each launches the Arrow kernel 3 times.
    The tiered consensus must equal the truth, and the flat one the port's
    flat polish of the same alignments on the CPU (its plain versions)."""
    from falcon_unzip_tpu_torch.models.aligner import (AlignerConfig,
                                                       ReadToContigAligner)
    from falcon_unzip_tpu_torch.models.polisher import (Polisher,
                                                         PolisherConfig,
                                                         phred_to_tiers)
    from falcon_unzip_tpu_torch.ops import _kernels
    from falcon_unzip_tpu_torch.utils.simulate import (Diploid,
                                                       random_genome,
                                                       simulate_reads)
    L = 15000
    truth = random_genome(L, 97)
    dip = Diploid(hap0=truth, hap1=truth.copy(),
                  snp_pos=np.zeros(0, np.int64), snp_alt=np.zeros(0, np.int8))
    sim = simulate_reads(dip, coverage=20.0, read_len=2000, error_rate=0.05,
                         seed=98, rc_frac=0.65, qv_profile="hotspot")
    rng = np.random.default_rng(99)
    draft = truth.copy()
    err = rng.choice(L - 200, size=12, replace=False) + 100
    draft[err] = (draft[err] + 1 + rng.integers(0, 3, 12)) % 4
    aln = ReadToContigAligner([draft], AlignerConfig(),
                              device="cuda").align_batch(sim.batch)
    cfg = PolisherConfig(arrow_rounds=3)
    tiers = [phred_to_tiers(x) for x in sim.quals]
    res = {}
    for mode, qtiers in (("flat", None), ("per-base", tiers)):
        _kernels.ARROW.timed = True
        _kernels.reset_counts()
        t0 = time.perf_counter()
        c = Polisher(cfg, read_qtiers=qtiers, device="cuda").polish_contig(
            "c", draft, aln, 0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _kernels.ARROW.launches
        dev_ms = _kernels.ARROW.elapsed_ms()
        _kernels.ARROW.timed = False
        seq = np.asarray(c.seq)
        mism = (int((seq != truth).sum()) if len(seq) == L
                else f"length {len(seq)}")
        res[mode] = dict(launches=launches, ms=dev_ms, mismatches=mism,
                         seq=seq)
        print(f"[5b hotspot] {mode}: polish {wall:.1f} s | {launches} Arrow "
              f"launches, {dev_ms:.3f} ms of device time | consensus of "
              f"{len(seq)} bp vs truth: {mism} mismatches", flush=True)
    if res["per-base"]["mismatches"] != 0:
        _fail(f"hotspot polish with per-base tiers differs from the truth: "
              f"{res['per-base']['mismatches']}")
    launches = {k: r["launches"] for k, r in res.items()}
    if set(launches.values()) != {3}:
        _fail(f"hotspot polish did not launch the Arrow kernel 3 times a "
              f"mode: {launches}")
    t0 = time.perf_counter()
    cpu = np.asarray(Polisher(cfg, device="cpu").polish_contig(
        "c", draft, aln, 0).seq)
    same = len(cpu) == len(res["flat"]["seq"]) and bool(
        (cpu == res["flat"]["seq"]).all())
    print(f"[5b hotspot] flat on the CPU: {time.perf_counter() - t0:.1f} s, "
          f"{len(cpu)} bp, {'equal to' if same else 'DIFFERS from'} the "
          "card's flat consensus", flush=True)
    if not same:
        _fail("the flat hotspot consensus on the card differs from the "
              "port's on the CPU")
    return res


def phase_ablate_path() -> dict:
    """The ablation script's entry point with the counts set to 0 just
    before it and read just after."""
    from falcon_unzip_tpu_torch.ops import _kernels
    from falcon_unzip_tpu_torch.scripts import ablate_pairhmm
    _kernels.reset_counts()
    rows = ablate_pairhmm.main()
    launches = _kernels.ABLATE.launches
    if launches <= 0 or len(rows) != 5:
        _fail(f"the ablation script launched its kernel {launches} times "
              f"over {len(rows)} feature sets")
    print(f"[6 ablate] {len(rows)} feature sets, {launches} kernel launches",
          flush=True)
    return {"launches": launches}


def phase_bench() -> dict:
    """The kernel bench through the port's command line, counts set to 0
    just before it and read just after; its JSON line printed as it is."""
    from falcon_unzip_tpu_torch.cli import main as cli_main
    from falcon_unzip_tpu_torch.ops import _kernels
    kernels = (_kernels.PAIRHMM, _kernels.ARROW, _kernels.WAVEFRONT)
    _kernels.reset_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = cli_main(["bench"])
    launches = _launches(kernels)
    line = buf.getvalue().strip().splitlines()[-1]
    print(line, flush=True)
    res = json.loads(line)
    if code != 0 or min(launches.values()) <= 0:
        _fail(f"bench exited {code} with launches {launches}")
    rates = ("value", "gcells_per_sec", "pct_fp32_peak",
             "splice_mutations_per_sec", "splice_pairs_per_sec",
             "editdp_gcells_per_sec")
    if not all(isinstance(res[k], float) and res[k] > 0 for k in rates):
        _fail(f"bench rates not positive: {res}")
    print(f"[7 bench] launches {launches}", flush=True)
    return res


ECOLI_BP = 4_641_652    # E. coli K-12 MG1655, the length of its genome


@contextlib.contextmanager
def _clock(module, names, spent):
    """Wrap module.<name> for each name with a host clock that adds its
    seconds to spent[name]; restore on exit."""
    saved = {nm: vars(module)[nm] for nm in names}

    def timed(nm, fn):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[nm] = spent.get(nm, 0.0) + time.perf_counter() - t0
        # a class's static method stays static
        return staticmethod(call) if isinstance(module, type) else call
    try:
        for nm, fn in saved.items():
            setattr(module, nm, timed(nm, fn))
        yield spent
    finally:
        for nm, fn in saved.items():
            setattr(module, nm, fn)


def phase_falcon_sense(torch) -> dict:
    """FalconSense (BASELINE config 1) on the card at E. coli length, the
    counts set to 0 just before it and read just after, its identity to
    the truth from fixtures.edit_identity; then a 100 kb cut of the same
    template with the reads inside it, the card's consensus against the
    CPU's (the plain versions) byte for byte."""
    from falcon_unzip_tpu_torch.models import consensus as fs
    from falcon_unzip_tpu_torch.scripts.e2e_bench import timed_stage
    from falcon_unzip_tpu_torch.utils.fixtures import (edit_identity,
                                                       template_reads)
    t0 = time.perf_counter()
    truth, template, reads, spans = template_reads(
        ECOLI_BP, 20 * ECOLI_BP // 10_000, seed=9)
    sim_s = time.perf_counter() - t0
    spent: dict = {}

    def consensus():
        with _clock(fs, ("seed_batch", "vote_matrix",
                         "consensus_from_votes"), spent), \
                _clock(fs.KmerIndex, ("build",), spent):
            return fs.FalconSense(fs.ConsensusConfig(), "cuda")(template,
                                                                 reads)
    torch.cuda.reset_peak_memory_stats()
    cns, wall, launches, dev_ms, _ = timed_stage(consensus, True)
    launches, dev_ms = ({k: row[k] for k in ("banded_wavefront", "traceback")}
                        for row in (launches, dev_ms))
    peak = torch.cuda.max_memory_allocated()
    seed_s = spent["build"] + spent["seed_batch"]
    vote_s = spent["vote_matrix"] + spent["consensus_from_votes"]
    t0 = time.perf_counter()
    score = edit_identity(cns, truth, "cuda")
    score_s = time.perf_counter() - t0
    ident, covered = score["identity"], score["placed"] / len(truth)
    print(f"[9 falcon_sense] template {len(template)} bp (truth "
          f"{ECOLI_BP} bp at 2%), {len(reads)} reads 20x 10 kb mean at 8%, "
          f"half reverse-complemented | sim {sim_s:.1f} s | wall {wall:.1f} "
          f"s: seed {seed_s:.1f} s, dispatch / collect "
          f"{wall - seed_s - vote_s:.1f} s, vote / emit {vote_s:.1f} s | "
          f"launches {launches}, device ms {dev_ms} | peak device memory "
          f"{peak / 2**30:.3f} GiB | consensus {len(cns)} bp, identity to "
          f"the truth {ident:.6f} (floor 0.999; plain edit distance of "
          f"{score['pieces']} pieces of 10 kb, {score['unplaced']} unplaced, "
          f"summed distance {sum(score['dist'])}, {score_s:.1f} s), placed "
          f"bases {covered:.4f} of the truth's length", flush=True)
    if min(launches.values()) <= 0:
        _fail(f"FalconSense did not launch both DP kernels: {launches}")
    if ident < 0.999 or score["unplaced"] or covered < 0.99:
        _fail(f"FalconSense identity {ident}, {score['unplaced']} pieces "
              f"unplaced, {covered} of the truth placed")
    cut = 100_000
    sub = [r for r, (a, b) in zip(reads, spans) if b <= cut]
    t0 = time.perf_counter()
    card = fs.FalconSense(fs.ConsensusConfig(), "cuda")(template[:cut], sub)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = fs.FalconSense(fs.ConsensusConfig(), "cpu")(template[:cut], sub)
    cpu_s = time.perf_counter() - t0
    same = card.dtype == cpu.dtype and card.tobytes() == cpu.tobytes()
    print(f"[9 falcon_sense] {cut // 1000} kb cut, {len(sub)} reads: card "
          f"{card_s:.1f} s, CPU {cpu_s:.1f} s, consensus of {len(card)} bp "
          f"{'byte-equal' if same else 'DIFFERS'}", flush=True)
    if not same:
        _fail(f"FalconSense on the {cut // 1000} kb cut: card and CPU "
              "consensus differ")
    return {"launches": launches, "ms": dev_ms, "identity": ident}


def _entry(name, source, replaces, launches, err, ms, plain_ms, work,
           **builds):
    """One kernel of the kernels line; its bound from this run's work;
    builds: the band widths it takes and the layouts built for them."""
    from falcon_unzip_tpu_torch import bench
    bound, by = bench.bound_ms(work["ops"], work["bytes"], work["peak"])
    entry = {"name": name, "route": "cuda",
             "source": "falcon_unzip_tpu_torch/csrc/" + source,
             "replaces": replaces, "launches": launches, "max_abs_err": err,
             "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
             "bound_by": by, "library_ms": None, **builds}
    return entry


def _band_builds(kernel) -> dict:
    """The band widths a band kernel takes on the card and the layout
    widths built for them (the traceback takes W at run time)."""
    from falcon_unzip_tpu_torch.ops import _kernels
    widths = f"1..{_kernels.MAX_W}"
    if kernel == "traceback":
        return {"widths": widths, "layouts": None}
    return {"widths": widths, "layouts": sorted(
        {_kernels.layout_width(kernel, W)
         for W in range(1, _kernels.MAX_W + 1)})}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--genome-bp", type=int, default=1_000_000)
    args = ap.parse_args(argv)
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "falcon_unzip_tpu_torch")):
        _fail("run from a checkout: falcon_unzip_tpu_torch/ is not beside "
              "this script")
    sys.path.insert(0, here)
    import numpy as np
    import torch

    smi = phase_card(torch)
    phase_build()
    shapes = phase_parity_align(torch, np)
    phase_parity_hmm(torch, np)
    arrow = phase_parity_arrow(torch, np)
    ablate = phase_parity_ablate(torch, smi)
    widths = phase_widths(torch, np)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        golden_dir = phase_golden(tmp)
        phase_knobs(golden_dir)
        reforward = phase_reforward(torch, np, golden_dir)
        phase_cli(np, golden_dir)
        main_run = phase_main(torch, tmp, args.genome_bp)
        phase_traced(torch, main_run["dir"])
        phase_truth(main_run, args.genome_bp)
        phase_sharded_ops(torch, np)
        phase_two_ranks(torch, np, main_run)
        phase_scaling()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase_hotspot(torch, np)
    ablate_run = phase_ablate_path()
    phase_bench()
    phase_falcon_sense(torch)
    from falcon_unzip_tpu_torch import bench
    from falcon_unzip_tpu_torch.scripts import ablate_pairhmm as ab
    at = shapes[(256, "tglocal", 2048)]
    full = ("shift", "load", "lse")
    kernels = [
        _entry("banded_wavefront", "banded_align.cu",
               "falcon_unzip_tpu/ops/pallas_align.py:41",
               main_run["launches"]["banded_wavefront"],
               max(v["wf_err"] for v in (*shapes.values(),
                                          *widths["cases"].values())),
               at["wf_ms"], at["wf_plain_ms"], at["wf_work"],
               **_band_builds("banded_wavefront")),
        _entry("traceback", "banded_align.cu",
               "falcon_unzip_tpu/ops/banded_align.py:180",
               main_run["launches"]["traceback"],
               max(v["tb_err"] for v in (*shapes.values(),
                                          *widths["cases"].values())),
               at["tb_ms"], at["tb_plain_ms"], at["tb_work"],
               **_band_builds("traceback")),
        _entry("pairhmm_forward", "pairhmm.cu",
               "falcon_unzip_tpu/ops/pallas_pairhmm.py:41",
               reforward["launches"], reforward["err"], reforward["ms"],
               reforward["plain_ms"], reforward["work"],
               **_band_builds("pairhmm_forward")),
        _entry("arrow_splice", "arrow_splice.cu",
               "falcon_unzip_tpu/ops/arrow.py:88",
               main_run["launches"]["arrow_splice"],
               max(v["err"] for v in arrow.values()),
               arrow["per-pair"]["ms"], arrow["per-pair"]["plain_ms"],
               arrow["per-pair"]["work"]),
        _entry("pairhmm_ablate", "pairhmm_ablate.cu",
               "scripts/ablate_pallas.py:17", ablate_run["launches"],
               max(v["err"] for v in ablate.values()), ablate[full]["ms"],
               ablate[full]["plain_ms"],
               bench.ablate_work(full, P=ab.P, Dmax=ab.Dmax, W=ab.W,
                                 LQG=ab.LQG)),
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

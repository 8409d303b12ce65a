"""End-to-end unzip + polish wall-clock bench of the port.

Simulates a diploid genome at the given scale (the seeds and recipe of
the JAX package's ``scripts/e2e_bench.py``, so the three input FASTAs are
byte-identical to its), runs ``run_unzip`` then ``run_quiver`` on
``--device``, scores the polished contigs against the simulated truth,
and prints one JSON line with stage wall-clocks, bases/s, contig
statistics, truth QV and each kernel's launches and device ms for the
unzip and the quiver apart.  Before it, a line with the truth scoring's
own seconds and (on cuda) the peak device memory and the card's name and
power limit.

  python -m falcon_unzip_tpu_torch.scripts.e2e_bench [genome_bp] \\
      [coverage] [profile] [--device cuda|cpu] [--scratch DIR]

``profile`` defaults to ``$E2E_PROFILE``, else uniform.  ``--scratch``
defaults to ``$TMPDIR/e2e_bench_torch_<bp>[_<profile>]``; with
``E2E_KEEP=1`` an existing scratch directory of the same simulation is
reused and its completed stages resume.  ``--device`` defaults to cuda
and raises without a GPU.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import sys
import tempfile
import time

if __name__ == "__main__":      # run as a file: this checkout first
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))


def _truth_qv(cns_path: str, haps: list, chunk: int = 500, *, device):
    """Mean phred QV of polished contigs vs the SIMULATED TRUTH
    (north-star metric 3), mosaic-aware: FALCON primaries are
    pseudo-haplotypes that legitimately SWITCH haplotype between phase
    blocks, so the contig is scored in `chunk`-bp pieces, each against
    its best-matching haplotype (exact-substring fast path, banded
    re-alignment fallback on `device`).  Base errors raise the chunk's
    edit distance; phase switches cost at most the few het sites inside
    the single chunk containing the junction."""
    import numpy as np

    from falcon_unzip_tpu_torch.io.fasta import read_fasta
    from falcon_unzip_tpu_torch.models.aligner import (AlignerConfig,
                                                       ReadToContigAligner)
    from falcon_unzip_tpu_torch.seq import SeqBatch, decode

    batch = read_fasta(cns_path)
    if not len(batch):
        return None, None
    hap_strs = [decode(h) for h in haps]
    qvs: list[float] = []
    al = None
    # error attribution (VERDICT r2 weak #5): how much of the residual
    # edit distance sits in haplotype-SWITCH chunks (legitimate mosaic
    # junctions of a FALCON pseudo-haplotype primary) vs interior base
    # errors vs unalignable sequence
    bd = {"n_chunks": 0, "n_exact": 0, "n_switch": 0, "n_interior": 0,
          "n_unaligned": 0, "err_switch": 0.0, "err_interior": 0.0,
          "err_unaligned": 0.0}

    def _chunk_kind(p: str) -> str:
        probe = min(150, max(50, len(p) // 3))
        head = {h for h, hs in enumerate(hap_strs) if p[:probe] in hs}
        tail = {h for h, hs in enumerate(hap_strs) if p[-probe:] in hs}
        if head and tail and not (head & tail):
            return "switch"
        return "interior"

    rc_tr = str.maketrans("ACGT", "TGCA")

    for i in range(len(batch)):
        s = batch.to_str(i)
        # orientation: graph walks legitimately emit reverse-complement
        # contigs; score whichever orientation matches the truth (probe
        # three interior chunks, majority wins)
        s_r = s.translate(rc_tr)[::-1]
        probes = [s[o : o + chunk] for o in
                  (0, max(0, len(s) // 2), max(0, len(s) - chunk))]
        n_f = sum(any(p in h for h in hap_strs) for p in probes if p)
        probes_r = [s_r[o : o + chunk] for o in
                    (0, max(0, len(s) // 2), max(0, len(s) - chunk))]
        n_r = sum(any(p in h for h in hap_strs) for p in probes_r if p)
        if n_r > n_f:
            s = s_r
        if any(s in h for h in hap_strs):
            qvs.append(60.0)
            bd["n_chunks"] += max(1, len(s) // chunk)
            bd["n_exact"] += max(1, len(s) // chunk)
            continue
        pieces = [s[o : o + chunk] for o in range(0, len(s), chunk)]
        pieces = [p for p in pieces if len(p) >= 50]
        resid_idx = [k for k, p in enumerate(pieces)
                     if not any(p in h for h in hap_strs)]
        bd["n_chunks"] += len(pieces)
        bd["n_exact"] += len(pieces) - len(resid_idx)
        err = 0.0
        if resid_idx:
            if al is None:
                al = ReadToContigAligner(haps, AlignerConfig(band=256),
                                         device=device)
            sub = SeqBatch.from_strs([pieces[k] for k in resid_idx])
            res = al.align_batch(sub)
            best = {r: float("inf") for r in range(len(sub))}
            for a in range(len(res)):
                best[int(res.read_id[a])] = min(
                    best[int(res.read_id[a])], float(res.dist[a]))
            for r in range(len(sub)):
                if np.isfinite(best[r]):
                    err += best[r]
                    kind = _chunk_kind(pieces[resid_idx[r]])
                    bd[f"n_{kind}"] += 1
                    bd[f"err_{kind}"] += best[r]
                else:
                    # unalignable chunk counts fully wrong
                    err += len(sub.row(r))
                    bd["n_unaligned"] += 1
                    bd["err_unaligned"] += len(sub.row(r))
        rate = err / max(len(s), 1)
        qvs.append(float(min(60.0, -10.0 * np.log10(max(rate, 1e-6)))))
    return round(float(np.mean(qvs)), 1), bd


def contig_lengths(genome_bp: int, profile: str) -> list[int]:
    """Per-contig lengths for a simulation profile.

    uniform : historical shape — equal ~50 kb contigs (fast, but a toy
              for a tool whose reference assembled multi-Mb contigs).
    n50     : realistic FALCON-primary shape (VERDICT r3 next #2) — a
              few contigs spanning ~half the genome down to ~5%, e.g.
              10 Mb -> [5 Mb, 2 Mb, 1 Mb, 650 kb, 650 kb, 700 kb].
    fungal  : BASELINE.json config-5 shape — a ~40 Mb-class diploid
              fungal draft as FALCON emits it: 16 contigs from 15% of
              the genome down to ~2%, N50 ≈ 7.5% of genome (3 Mb at
              40 Mb, matching published fungal FALCON assemblies).
    """
    if profile == "n50":
        fr = [0.5, 0.2, 0.1, 0.065, 0.065, 0.07]
        lens = [int(genome_bp * f) for f in fr[:-1]]
        return lens + [genome_bp - sum(lens)]
    if profile == "fungal":
        fr = [0.15, 0.125, 0.1, 0.0875, 0.075, 0.075, 0.0625, 0.0625,
              0.05, 0.05, 0.0375, 0.0375, 0.025, 0.025, 0.02]
        lens = [int(genome_bp * f) for f in fr]
        return lens + [genome_bp - sum(lens)]
    n_ctg = max(1, genome_bp // 50_000)
    return [genome_bp // n_ctg] * n_ctg


def _stage_metrics(out_dir: str) -> dict:
    """Last metrics row per stage key from the run's metrics.jsonl."""
    path = os.path.join(out_dir, "metrics.jsonl")
    rows: dict = {}
    try:
        with open(path) as fh:
            for line in fh:
                r = json.loads(line)
                k = r.pop("stage", None)
                r.pop("ts", None)
                if not k or k == "phasing":  # phasing is per-contig
                    continue
                while k in rows:             # unzip + quiver both log
                    k += "+"                 # align_compute etc.
                rows[k] = r
    except OSError:
        pass
    return rows


def truth_haps(genome_bp: int, profile: str) -> list:
    """The simulated haplotypes (hap0, hap1 of each contig in turn)."""
    from falcon_unzip_tpu_torch.utils.simulate import make_diploid
    haps = []
    for ci, per in enumerate(contig_lengths(genome_bp, profile)):
        dip = make_diploid(length=per, het_rate=0.012, seed=100 + ci,
                           het_span=(0.2, 0.8))
        haps += [dip.hap0, dip.hap1]
    return haps


def sim_contig(job):
    """One contig of the bench's genome from its own seeds: its diploid,
    error-free 2200 bp preads at ``coverage`` and 1800 bp raw reads at
    ``coverage + 4`` with 3% error (run in a worker process)."""
    ci, per, coverage = job
    from falcon_unzip_tpu_torch.utils.simulate import (make_diploid,
                                                       simulate_reads)
    dip = make_diploid(length=per, het_rate=0.012, seed=100 + ci,
                       het_span=(0.2, 0.8))
    pr = simulate_reads(dip, coverage=coverage, read_len=2200,
                        error_rate=0.0, seed=200 + ci)
    rw = simulate_reads(dip, coverage=coverage + 4, read_len=1800,
                        error_rate=0.03, seed=300 + ci)
    return dip, pr.batch, rw.batch


def simulate(lens: list, coverage: float) -> list:
    """[(Diploid, preads, raw reads)] of each contig, the contigs
    simulated side by side in spawned processes (each from its own
    seeds, so the result does not depend on the process count)."""
    import multiprocessing
    jobs = [(ci, per, coverage) for ci, per in enumerate(lens)]
    n_proc = min(len(jobs), os.cpu_count() or 1)
    with multiprocessing.get_context("spawn").Pool(n_proc) as pool:
        return pool.map(sim_contig, jobs)


def timed_stage(run, cuda: bool) -> tuple:
    """run() with every kernel's count set to 0 just before it and read
    just after (launches bracketed by CUDA events on cuda): its result,
    wall s, {kernel: launches}, {kernel: device ms} (None on the CPU) and
    {kernel: DP cells}."""
    import torch

    from falcon_unzip_tpu_torch.ops import _kernels
    for k in _kernels.KERNELS:
        k.timed = cuda
    _kernels.reset_counts()
    try:
        t0 = time.perf_counter()
        res = run()
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for k in _kernels.KERNELS:
            k.timed = False
    launches = {k.name: k.launches for k in _kernels.KERNELS}
    ms = ({k.name: k.elapsed_ms() for k in _kernels.KERNELS}
          if cuda else None)
    cells = {k.name: k.cells for k in _kernels.KERNELS}
    return res, wall, launches, ms, cells


def scratch_dir(genome_bp: int, profile: str) -> str:
    """The default scratch directory of a run (never the JAX bench's)."""
    return os.path.join(tempfile.gettempdir(), f"e2e_bench_torch_{genome_bp}"
                        + (f"_{profile}" if profile != "uniform" else ""))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("genome_bp", nargs="?", type=int, default=150_000)
    ap.add_argument("coverage", nargs="?", type=float, default=14.0)
    ap.add_argument("profile", nargs="?",
                    default=os.environ.get("E2E_PROFILE", "uniform"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scratch", default=None)
    args = ap.parse_args(argv)
    genome_bp, coverage, profile = args.genome_bp, args.coverage, args.profile

    import torch

    from falcon_unzip_tpu_torch.bench import card_label
    from falcon_unzip_tpu_torch.config import PipelineConfig
    from falcon_unzip_tpu_torch.device import resolve
    from falcon_unzip_tpu_torch.io.fasta import write_fasta
    from falcon_unzip_tpu_torch.pipeline.quiver import run_quiver
    from falcon_unzip_tpu_torch.pipeline.unzip import run_unzip
    from falcon_unzip_tpu_torch.seq import decode
    from falcon_unzip_tpu_torch.utils import simulate as sim_mod

    dev = resolve(args.device)
    cuda = dev.type == "cuda"
    d = args.scratch or scratch_dir(genome_bp, profile)
    # sim identity: params + simulator source hash; a keep-dir whose
    # fingerprint mismatches is discarded instead of silently scoring
    # truth QV against the wrong haplotypes
    with open(sim_mod.__file__, "rb") as fh:
        sim_src = hashlib.sha256(fh.read()).hexdigest()[:16]
    fp = {"genome_bp": genome_bp, "coverage": coverage,
          "profile": profile, "sim_src": sim_src, "v": 2}
    fp_path = f"{d}/sim_params.json"
    # E2E_KEEP=1: reuse an existing scratch dir — the sim is re-derived
    # (seeded, for truth QV) but input files are not rewritten, so the
    # pipelines' Stage markers resume completed stages (mtime-fingerprint
    # semantics).  Interrupted big runs continue instead of restarting.
    keep = bool(os.environ.get("E2E_KEEP")) and os.path.isdir(d)
    if keep:
        try:
            with open(fp_path) as fh:
                keep = json.load(fh) == fp
        except (OSError, ValueError):
            keep = False
    if not keep:
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
        with open(fp_path, "w") as fh:
            json.dump(fp, fh)
    lens = contig_lengths(genome_bp, profile)
    n_ctg = len(lens)

    t0 = time.perf_counter()
    sims = simulate(lens, coverage)
    true_haps = [h for dip, _, _ in sims for h in (dip.hap0, dip.hap1)]
    if not (keep and os.path.exists(f"{d}/preads.fa")):
        for fn, k in (("preads.fa", 1), ("raw.fa", 2)):
            write_fasta(f"{d}/{fn}", ((f"c{ci}/{s[k].names[i]}",
                                       s[k].to_str(i))
                                      for ci, s in enumerate(sims)
                                      for i in range(len(s[k]))))
        write_fasta(f"{d}/draft.fa", [(f"draft{ci}", decode(s[0].hap0))
                                      for ci, s in enumerate(sims)])
    del sims
    sim_s = time.perf_counter() - t0

    cfg = PipelineConfig(preads=f"{d}/preads.fa", reads=f"{d}/raw.fa",
                         draft=f"{d}/draft.fa", out_dir=f"{d}/out")

    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    u, unzip_s, u_launch, u_ms, _ = timed_stage(lambda: run_unzip(cfg, dev),
                                                cuda)
    q, polish_s, q_launch, q_ms, _ = timed_stage(
        lambda: run_quiver(cfg, dev), cuda)
    total = unzip_s + polish_s
    if cuda:
        print(f"[device] {card_label()} | peak device memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB",
              flush=True)
    t0 = time.perf_counter()
    qv_p, bd_p = _truth_qv(f"{d}/out/4-polish/cns_p_ctg.fasta", true_haps,
                           device=dev)
    qv_h, bd_h = _truth_qv(f"{d}/out/4-polish/cns_h_ctg.fasta", true_haps,
                           device=dev)
    print(f"[truth] truth QV scoring {time.perf_counter() - t0:.2f} s on "
          f"{dev}", flush=True)
    print(json.dumps({
        "metric": "e2e_unzip_polish_wall_s",
        "genome_bp": genome_bp,
        "n_contigs": n_ctg,
        "profile": profile,
        "contig_lens": lens if n_ctg <= 16 else None,
        "coverage": coverage,
        "stage_metrics": _stage_metrics(f"{d}/out"),
        "device": card_label() if cuda else "cpu",
        "sim_s": round(sim_s, 1),
        "unzip_s": round(unzip_s, 1),
        "polish_s": round(polish_s, 1),
        "total_s": round(total, 1),
        "genome_bases_per_sec": round(genome_bp / total, 1),
        "p_ctg": u["p_ctg"], "h_ctg": u["h_ctg"],
        "mean_qv": q.get("mean_qv"),
        "truth_qv_p": qv_p, "truth_qv_h": qv_h,
        "qv_breakdown_p": bd_p, "qv_breakdown_h": bd_h,
        "launches": {"unzip": u_launch, "quiver": q_launch},
        "device_ms": {"unzip": u_ms, "quiver": q_ms},
    }))


if __name__ == "__main__":
    main()

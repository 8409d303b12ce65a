"""Emitted-QV reliability vs simulated truth, on the port.

Reads a finished e2e scratch directory's cns FASTQs (``scripts.e2e_bench``
of this package), re-derives the seeded truth haplotypes, and compares
PREDICTED errors (sum of 10^(-q/10) over emitted per-base qualities)
against OBSERVED errors (chunk edit distance vs the best-matching
haplotype, re-aligned on ``--device``) — overall and binned by
chunk-mean emitted QV.  A calibrated emitter has predicted ~= observed
in every bin.  Prints one JSON line.

  python -m falcon_unzip_tpu_torch.scripts.qv_calibrate [genome_bp] \\
      [coverage] [profile] [--device cuda|cpu] [--scratch DIR]

``--scratch`` defaults to the e2e bench's default for the same genome
size and profile.  ``--device`` defaults to cuda and raises without a GPU.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

if __name__ == "__main__":      # run as a file: this checkout first
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))


def chunk_stats(cns_path: str, fastq_path: str, haps: list,
                chunk: int = 500, *, device):
    from falcon_unzip_tpu_torch.io.fasta import read_fasta
    from falcon_unzip_tpu_torch.models.aligner import (AlignerConfig,
                                                       ReadToContigAligner)
    from falcon_unzip_tpu_torch.seq import SeqBatch, decode

    batch = read_fasta(cns_path)
    # per-base qualities from the fastq
    quals = []
    with open(fastq_path) as fh:
        lines = fh.read().splitlines()
    for i in range(0, len(lines), 4):
        quals.append(np.frombuffer(
            lines[i + 3].encode(), np.uint8).astype(np.int32) - 33)
    hap_strs = [decode(h) for h in haps]
    rc_tr = str.maketrans("ACGT", "TGCA")
    rows = []           # (chunk_mean_q, predicted, observed)
    al = None
    for ci in range(len(batch)):
        s = batch.to_str(ci)
        q = quals[ci]
        s_r = s.translate(rc_tr)[::-1]
        probes = [s[o : o + chunk] for o in
                  (0, max(0, len(s) // 2), max(0, len(s) - chunk))]
        n_f = sum(any(p in h for h in hap_strs) for p in probes if p)
        probes_r = [s_r[o : o + chunk] for o in
                    (0, max(0, len(s) // 2), max(0, len(s) - chunk))]
        n_r = sum(any(p in h for h in hap_strs) for p in probes_r if p)
        if n_r > n_f:
            s = s_r
            q = q[::-1]
        pieces = [(o, s[o : o + chunk]) for o in range(0, len(s), chunk)]
        pieces = [(o, p) for o, p in pieces if len(p) >= 50]
        resid = [(o, p) for o, p in pieces
                 if not any(p in h for h in hap_strs)]
        obs = {o: 0.0 for o, _ in pieces}
        if resid:
            if al is None:
                al = ReadToContigAligner(haps, AlignerConfig(band=256),
                                         device=device)
            sub = SeqBatch.from_strs([p for _, p in resid])
            res = al.align_batch(sub)
            best = {r: None for r in range(len(sub))}
            for a in range(len(res)):
                r = int(res.read_id[a])
                if best[r] is None or res.dist[a] < best[r]:
                    best[r] = float(res.dist[a])
            for r, (o, p) in enumerate(resid):
                obs[o] = best[r] if best[r] is not None else float(len(p))
        for o, p in pieces:
            qc = q[o : o + len(p)]
            rows.append((float(qc.mean()),
                         float(np.sum(10.0 ** (-qc / 10.0))),
                         obs[o]))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("genome_bp", nargs="?", type=int, default=1_000_000)
    ap.add_argument("coverage", nargs="?", type=float, default=14.0)
    ap.add_argument("profile", nargs="?", default="uniform")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scratch", default=None)
    args = ap.parse_args(argv)
    genome_bp, profile = args.genome_bp, args.profile
    from falcon_unzip_tpu_torch.device import resolve
    from falcon_unzip_tpu_torch.scripts.e2e_bench import (scratch_dir,
                                                          truth_haps)

    dev = resolve(args.device)
    d = args.scratch or scratch_dir(genome_bp, profile)
    true_haps = truth_haps(genome_bp, profile)
    rows = []
    for stem in ("cns_p_ctg", "cns_h_ctg"):
        fa = f"{d}/out/4-polish/{stem}.fasta"
        fq = f"{d}/out/4-polish/{stem}.fastq"
        if os.path.exists(fa):
            rows += chunk_stats(fa, fq, true_haps, device=dev)
    rows = np.array(rows)          # (n, 3): mean_q, predicted, observed
    bins = [0, 20, 30, 40, 45, 50, 55, 61]
    table = []
    for lo, hi in zip(bins[:-1], bins[1:]):
        sel = (rows[:, 0] >= lo) & (rows[:, 0] < hi)
        if not sel.any():
            continue
        pred = rows[sel, 1].sum()
        obs = rows[sel, 2].sum()
        bases = sel.sum() * 500
        table.append({
            "q_bin": f"{lo}-{hi}", "n_chunks": int(sel.sum()),
            "predicted_errs": round(pred, 1),
            "observed_errs": round(obs, 1),
            "pred_qv": round(-10 * np.log10(max(pred / bases, 1e-9)), 1),
            "obs_qv": round(-10 * np.log10(max(obs / bases, 1e-9)), 1)})
    print(json.dumps({
        "metric": "qv_reliability",
        "genome_bp": genome_bp, "profile": profile,
        "total_predicted": round(float(rows[:, 1].sum()), 1),
        "total_observed": round(float(rows[:, 2].sum()), 1),
        "bins": table}))


if __name__ == "__main__":
    main()

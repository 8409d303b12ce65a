"""Attribute residual consensus errors below chunk level, on the port:
for every interior-error chunk of a finished e2e run
(``scripts.e2e_bench`` of this package), align it to the best truth
haplotype WITH traceback on ``--device``, recover base-level error
positions, and classify each against polish-window geometry and
het-site proximity.  Prints one JSON line.

  python -m falcon_unzip_tpu_torch.scripts.qv_attrib [genome_bp] \\
      [coverage] [profile] [--device cuda|cpu] [--scratch DIR]

``--scratch`` defaults to the e2e bench's default for the same genome
size and profile.  ``--device`` defaults to cuda and raises without a GPU.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from collections import Counter

import numpy as np

if __name__ == "__main__":      # run as a file: this checkout first
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("genome_bp", nargs="?", type=int, default=1_000_000)
    ap.add_argument("coverage", nargs="?", type=float, default=14.0)
    ap.add_argument("profile", nargs="?", default="uniform")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scratch", default=None)
    args = ap.parse_args(argv)
    genome_bp, profile = args.genome_bp, args.profile
    from falcon_unzip_tpu_torch.config import PipelineConfig
    from falcon_unzip_tpu_torch.device import resolve
    from falcon_unzip_tpu_torch.io.fasta import read_fasta
    from falcon_unzip_tpu_torch.models.aligner import (AlignerConfig,
                                                       ReadToContigAligner)
    from falcon_unzip_tpu_torch.scripts.e2e_bench import (contig_lengths,
                                                          scratch_dir)
    from falcon_unzip_tpu_torch.seq import SeqBatch, decode
    from falcon_unzip_tpu_torch.utils.simulate import make_diploid

    dev = resolve(args.device)
    d = args.scratch or scratch_dir(genome_bp, profile)
    lens = contig_lengths(genome_bp, profile)
    true_haps, het_sets = [], []
    for ci, per in enumerate(lens):
        dip = make_diploid(length=per, het_rate=0.012, seed=100 + ci,
                           het_span=(0.2, 0.8))
        true_haps += [dip.hap0, dip.hap1]
        het_sets += [dip.snp_pos, dip.snp_pos]
    hap_strs = [decode(h) for h in true_haps]
    pcfg = PipelineConfig(preads="x", out_dir="x")
    step = pcfg.polish.window - pcfg.polish.overlap
    rc_tr = str.maketrans("ACGT", "TGCA")
    chunk = 500
    rows = []
    al = ReadToContigAligner(true_haps, AlignerConfig(band=256), device=dev)
    for stem in ("cns_p_ctg", "cns_h_ctg"):
        path = f"{d}/out/4-polish/{stem}.fasta"
        if not os.path.exists(path):
            continue
        batch = read_fasta(path)
        for ci in range(len(batch)):
            s = batch.to_str(ci)
            s_r = s.translate(rc_tr)[::-1]
            probes = [s[o : o + chunk] for o in
                      (0, len(s) // 2, max(0, len(s) - chunk))]
            n_f = sum(any(p in h for h in hap_strs) for p in probes if p)
            probes_r = [s_r[o : o + chunk] for o in
                        (0, len(s_r) // 2, max(0, len(s_r) - chunk))]
            n_r = sum(any(p in h for h in hap_strs) for p in probes_r if p)
            rc = n_r > n_f
            ss = s_r if rc else s
            pieces = [(o, ss[o : o + chunk])
                      for o in range(0, len(ss), chunk)]
            resid = [(o, p) for o, p in pieces if len(p) >= 50
                     and not any(p in h for h in hap_strs)]
            if not resid:
                continue
            sub = SeqBatch.from_strs([p for _, p in resid])
            res = al.align_batch(sub)
            best = {}
            for a in range(len(res)):
                r = int(res.read_id[a])
                if r not in best or res.dist[a] < res.dist[best[r]]:
                    best[r] = a
            for r, (o, p) in enumerate(resid):
                if r not in best:
                    rows.append({"kind": "unaligned", "ctg": batch.names[ci],
                                 "off": o, "n_err": len(p)})
                    continue
                a = best[r]
                hap = int(res.ctg[a])
                tags = res.tags[a]
                # error positions: chunk-local q coords of edits
                t0 = int(res.t_start[a])
                hs = true_haps[hap]
                # walk tags: mismatches where base != hap[t_pos];
                # deletions (base==4); insertion deltas>0
                mm = (tags[:, 2] < 4) & (tags[:, 1] == 0) & \
                     (hs[np.clip(tags[:, 0], 0, len(hs) - 1)] != tags[:, 2])
                dl = tags[:, 2] == 4
                ins = tags[:, 1] > 0
                errs = [(int(tp), k) for sel, k in
                        ((mm, "sub"), (dl, "cns_missing_base"),
                         (ins, "cns_extra_base"))
                        for tp in tags[sel, 0]]
                het = het_sets[hap]
                for tp, ek in errs:
                    # chunk-local consensus offset (approx == t offset)
                    c_off = o + (tp - t0)
                    d_win = min(c_off % step, step - (c_off % step))
                    d_het = (int(np.min(np.abs(het - tp)))
                             if len(het) else -1)
                    rows.append({
                        "kind": "err", "etype": ek,
                        "ctg": batch.names[ci],
                        "cns_off": int(c_off), "hap": hap,
                        "dist_to_window_edge": int(d_win),
                        "dist_to_het": d_het,
                        "dist_to_ctg_end": int(min(c_off,
                                                   len(ss) - c_off))})
    errs = [r for r in rows if r["kind"] == "err"]
    dw = np.array([r["dist_to_window_edge"] for r in errs])
    dh = np.array([r["dist_to_het"] for r in errs if r["dist_to_het"] >= 0])
    de = np.array([r["dist_to_ctg_end"] for r in errs])
    out = {
        "metric": "qv_attribution", "genome_bp": genome_bp,
        "profile": profile, "n_errors": len(errs),
        "by_type": dict(Counter(r["etype"] for r in errs)),
        "near_window_edge_lt16": int((dw < 16).sum()),
        "near_het_lt8": int((dh < 8).sum()),
        "near_ctg_end_lt500": int((de < 500).sum()),
        "median_dist_to_window_edge": float(np.median(dw)) if len(dw) else None,
        "median_dist_to_het": float(np.median(dh)) if len(dh) else None,
        # background: uniform errors would sit ~step/4 from an edge
        "expected_uniform_window_edge": step / 4,
        "sample": errs[:600],
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()

"""Split the 1-align stage wall into seed / DP dispatch / collect / host
post (anchor_trim + tag emission) at a given genome scale, on the port.

  python -m falcon_unzip_tpu_torch.scripts.profile_align [genome_bp] \\
      [coverage] [--device cuda|cpu]

It wraps the aligner's hooks (``models.aligner.seed_batch``,
``ops.banded_align.BandedAligner.dispatch`` and ``collect``,
``models.aligner.anchor_trim``) with host clocks for one
``align_batch`` of error-free preads against the contigs, and prints one
JSON line with the seconds of each and the device (on cuda the card's
name and power limit).  On cuda ``dispatch`` queues the kernels and
returns before they end, so the wait for the card falls into
``collect``.  ``--device`` defaults to cuda and raises without a GPU.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

if __name__ == "__main__":      # run as a file: this checkout first
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("genome_bp", nargs="?", type=int, default=300_000)
    ap.add_argument("coverage", nargs="?", type=float, default=14.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    genome_bp, coverage = args.genome_bp, args.coverage
    from falcon_unzip_tpu_torch.bench import card_label
    from falcon_unzip_tpu_torch.device import resolve
    from falcon_unzip_tpu_torch.models.aligner import (AlignerConfig,
                                                       ReadToContigAligner)
    from falcon_unzip_tpu_torch.seq import SeqBatch
    from falcon_unzip_tpu_torch.utils.simulate import (make_diploid,
                                                       simulate_reads)

    dev = resolve(args.device)
    n_ctg = max(1, genome_bp // 50_000)
    per = genome_bp // n_ctg
    contigs, seqs = [], []
    for ci in range(n_ctg):
        dip = make_diploid(length=per, het_rate=0.012, seed=100 + ci,
                           het_span=(0.2, 0.8))
        pr = simulate_reads(dip, coverage=coverage, read_len=2200,
                            error_rate=0.0, seed=200 + ci)
        seqs += [pr.batch.to_str(i) for i in range(len(pr.batch))]
        contigs.append(dip.hap0)
    reads = SeqBatch.from_strs(seqs)

    t0 = time.time()
    al = ReadToContigAligner(contigs, AlignerConfig(), device=dev)
    t_index = time.time() - t0

    import falcon_unzip_tpu_torch.models.aligner as A
    from falcon_unzip_tpu_torch.ops import banded_align as BA

    # NOTE: wrappers assume the patched functions never nest (true for
    # align_batch's straight-line stage structure); "other" is the
    # remainder — host prep fill loops, bucketing, result assembly
    times = {"seed": 0.0, "dispatch": 0.0, "collect": 0.0, "post": 0.0}

    def timed(fn, key):
        def wrapped(*a, **k):
            t = time.time()
            r = fn(*a, **k)
            times[key] += time.time() - t
            return r
        return wrapped

    hooks = [(A, "seed_batch", "seed"),
             (BA.BandedAligner, "dispatch", "dispatch"),
             (BA.BandedAligner, "collect", "collect"),
             (A, "anchor_trim", "post")]
    saved = [(owner, name, getattr(owner, name)) for owner, name, _ in hooks]
    for owner, name, key in hooks:
        setattr(owner, name, timed(getattr(owner, name), key))
    try:
        t0 = time.time()
        aln = al.align_batch(reads)
        wall = time.time() - t0
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)
    other = wall - sum(times.values())
    times["other"] = other if other >= 0 else float("nan")  # nan = nested
    print(json.dumps({
        "genome_bp": genome_bp, "n_reads": len(reads),
        "n_aligned": len(aln), "index_s": round(t_index, 2),
        "align_wall_s": round(wall, 2),
        **{k: round(v, 2) for k, v in times.items()},
        "device": card_label() if dev.type == "cuda" else "cpu"}))


if __name__ == "__main__":
    main()

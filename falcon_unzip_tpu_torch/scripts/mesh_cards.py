"""The port over a mesh of NVIDIA GPUs against one GPU, at the 1 Mb run of
``chip_smoke.py``.

    python -m falcon_unzip_tpu_torch.scripts.mesh_cards [--cards 4]

Needs ``--cards`` GPUs (an even number) and the checkout's
``chip_smoke.py`` beside the package.  It runs the smoke's phase 10 (a)
over a 2-row mesh of the cards (every sharded op of ``parallel/`` against
the single-device op on cuda:0, the debug checks on), then the smoke's
phase 5 inputs (a 1 Mb n50-profile diploid, 25x preads, 29x raw reads)
through ``run_unzip`` + ``run_quiver`` on one card (``cfg.mesh.n_devices
= 1``) and over a mesh of the cards (``n_devices = cards``), both with
the debug checks off, as the default ``n_devices = 0`` runs on a machine
with several cards.  It fails unless the canonical 3-unzip files and
``cns_*`` of the two runs are byte-identical.  It prints each run's walls, stages and launches and the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
import time


def _run(torch, cfg, tag):
    """run_unzip + run_quiver on cuda, the counts set to 0 just before;
    returns (unzip s, quiver s, launches)."""
    from falcon_unzip_tpu_torch.ops import _kernels
    from falcon_unzip_tpu_torch.pipeline.quiver import run_quiver
    from falcon_unzip_tpu_torch.pipeline.unzip import run_unzip
    _kernels.reset_counts()
    walls = []
    for run in (run_unzip, run_quiver):
        t0 = time.perf_counter()
        run(cfg, device="cuda")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    launches = {k.name: k.launches for k in _kernels.KERNELS if k.launches}
    print(f"[mesh_cards] {tag}: unzip {walls[0]:.1f} s, quiver "
          f"{walls[1]:.1f} s | launches {launches}", flush=True)
    return walls, launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cards", type=int, default=4)
    args = ap.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from falcon_unzip_tpu_torch.config import load_config
    from falcon_unzip_tpu_torch.parallel import debug
    from falcon_unzip_tpu_torch.scripts.e2e_bench import (contig_lengths,
                                                          simulate)
    from falcon_unzip_tpu_torch.utils.fixtures import run_artifacts
    if torch.cuda.device_count() < args.cards or args.cards % 2:
        cs._fail(f"--cards {args.cards}: {torch.cuda.device_count()} cards "
                 "visible (an even number of them is needed)")
    cs.phase_card(torch)
    cs.phase_build()
    cs.phase_sharded_ops(torch, np,
                         devices=[f"cuda:{i}" for i in range(args.cards)])
    tmp = tempfile.mkdtemp(prefix="mesh_cards_")
    try:
        sims = simulate(contig_lengths(1_000_000, "n50"), 25.0)
        cs._write_inputs(tmp, [(f"draft{ci}", dip)
                               for ci, (dip, _, _) in enumerate(sims)],
                         [(f"c{ci}/", pr) for ci, (_, pr, _) in
                          enumerate(sims)],
                         [(f"c{ci}/", rw) for ci, (_, _, rw) in
                          enumerate(sims)])
        files, walls = {}, {}
        debug.enable(False)     # timed with the checks off, whatever the env
        for n in (1, args.cards):
            tag = f"n_devices={n}, debug checks off"
            cfg = load_config(f"{tmp}/run.json")
            cfg.out_dir = f"{tmp}/cards{n}"
            cfg.mesh.n_devices = n
            walls[tag], _ = _run(torch, cfg, tag)
            files[tag] = run_artifacts(cfg.out_dir,
                                       ("3-unzip/*", "4-polish/cns_*"))
            print(f"[mesh_cards] {tag} stages "
                  f"{cs._stage_rows(f'{cfg.out_dir}/metrics.jsonl')}",
                  flush=True)
        debug.enable(None)
        one = files[next(iter(files))]
        for tag, got in files.items():
            differ = sorted(k for k in set(one) | set(got)
                            if one.get(k) != got.get(k))
            if differ:
                cs._fail(f"the run with {tag} differs from one card in "
                         f"{differ}")
        print(f"[mesh_cards] {len(one)} canonical files byte-identical "
              f"between the runs | unzip / quiver s: "
              + "; ".join(f"{t}: {w[0]:.1f} / {w[1]:.1f}"
                          for t, w in walls.items()), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

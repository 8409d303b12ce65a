"""Run a cell with its control in the program's place, on several seeds.

    python3 -m benchmark.control --workload <cell> --seeds 11,12,13 \\
        [--seconds 10]

The control is what the cell's configuration names under ``control``
(and describes under ``control_about``): for the assembly cell the
program with 2-phasing and 4-polish's consensus switched off by its own
knobs (``pipeline`` overrides), for the consensus cell each request's
seed read returned unchanged.  Each seed is one run of ``run.main`` at
the cell's own size and load; its checks have to come out failed.  The
benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import sys

from benchmark import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    rc = 0
    for seed in args.seeds.split(","):
        print(f"[control] {args.workload} seed {seed}", file=sys.stderr,
              flush=True)
        rc |= run.main(["--workload", args.workload, "--seed", seed,
                        "--seconds", str(args.seconds), "--trace", "0"],
                       control=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())

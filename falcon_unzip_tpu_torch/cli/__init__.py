"""Command-line layer of the port: the ``unzip`` (fc_unzip.py role),
``quiver`` (fc_quiver.py role) and ``bench`` (the kernel bench, one JSON
line, GPU only) subcommands.  The other subcommands of the reference's
command line are not ported yet.

    python -m falcon_unzip_tpu_torch.cli unzip run.json [--device cuda]
    python -m falcon_unzip_tpu_torch.cli quiver run.json [--device cuda]
    python -m falcon_unzip_tpu_torch.cli bench
"""
from __future__ import annotations

import argparse
import logging


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="falcon-unzip-torch",
        description="phased diploid assembly (FALCON_unzip capabilities, "
                    "PyTorch + CUDA compute)")
    ap.add_argument("-v", "--verbose", action="store_true")
    sub = ap.add_subparsers(dest="cmd", required=True)
    for cmd, what in (("unzip", "3-unzip"), ("quiver", "4-polish")):
        p = sub.add_parser(cmd, help=f"run the {what} pipeline")
        p.add_argument("config",
                       help="config file (.json or fc_unzip.cfg INI)")
        p.add_argument("--device", default="cuda",
                       help="torch device (default cuda; raises without a "
                            "GPU)")
    sub.add_parser("bench", help="kernel bench on the GPU (one JSON line)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    if args.cmd == "bench":
        from ..bench import main as bench_main
        return bench_main()
    from ..config import load_config
    cfg = load_config(args.config)
    if args.cmd == "unzip":
        from ..pipeline.unzip import run_unzip
        print(run_unzip(cfg, device=args.device))
    else:
        from ..pipeline.quiver import run_quiver
        print(run_quiver(cfg, device=args.device))
    return 0

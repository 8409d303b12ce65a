"""Command-line layer of the port: the ``unzip`` subcommand (fc_unzip.py
role).  The other subcommands of ``falcon_unzip_tpu.cli`` are not ported
yet.

    python -m falcon_unzip_tpu_torch.cli unzip run.json [--device cuda]
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
    p = sub.add_parser("unzip", help="run the 3-unzip pipeline")
    p.add_argument("config", help="config file (.json or fc_unzip.cfg INI)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without a GPU)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    if args.cmd == "unzip":
        from falcon_unzip_tpu.config import load_config
        from ..pipeline.unzip import run_unzip
        print(run_unzip(load_config(args.config), device=args.device))
    return 0

"""Reference fc_*.py console-script compatibility shims.

Role parity: [U] setup.py entry_points (SURVEY.md §1 L4) — each legacy
tool name forwards to the corresponding subcommand of the unified CLI.
"""
from __future__ import annotations

import sys

from . import main


def _fwd(cmd: str):
    return main([cmd] + sys.argv[1:])


def fc_unzip() -> int:
    return _fwd("unzip")


def fc_quiver() -> int:
    return _fwd("quiver")


def fc_phasing() -> int:
    return _fwd("phase")


def fc_ovlp_filter() -> int:
    return _fwd("ovlp-filter")


def fc_track() -> int:
    return _fwd("track")


def fc_dedup() -> int:
    return _fwd("dedup")


def fc_gen_gfa() -> int:
    return _fwd("gen-gfa")


def fc_phasing_readmap() -> int:
    return _fwd("readmap")


def fc_phased_ovlp_to_graph() -> int:
    return _fwd("graph")


def fc_graphs_to_h_tigs_2() -> int:
    return _fwd("graph")


def fc_rr_hctg_track() -> int:
    return _fwd("track")


def fc_rr_hctg_track2() -> int:
    return _fwd("track")


def fc_get_read2ctg() -> int:
    return _fwd("track")


def fc_get_read_hctg_map() -> int:
    return _fwd("track")


def fc_select_reads_from_bam() -> int:
    return _fwd("select-reads")


def fc_unzip_gen_gfa_v1() -> int:
    return _fwd("gen-gfa")

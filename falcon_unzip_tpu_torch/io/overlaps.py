"""Overlap record text IO (LA4Falcon/m4-style dump parity).

Role parity: [U] LA4Falcon -mo text dumps — the interchange format the
reference's ovlp_filter_with_phase and rr_hctg_track stream (SURVEY.md
§2b DALIGNER row: ".las ingestion only needed for conformance tests
against reference intermediates").

Record line (m4-flavored, falcon overlap order):
  a_name b_name score identity strand_a a_start a_end a_len \
  strand_b b_start b_end b_len

strand_a is always 0 (a forward); strand_b 1 means b was
reverse-complemented for the match, with b coordinates in the MATCH
orientation (same convention as models.overlapper.OverlapSet).
"""
from __future__ import annotations

import os

import numpy as np

from ..models.overlapper import OverlapSet


def write_overlaps(path: str, ovl: OverlapSet,
                   names: list[str] | None = None) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    idt = ovl.identity()
    with open(path, "w") as fh:
        for o in range(len(ovl)):
            a, b = int(ovl.a_id[o]), int(ovl.b_id[o])
            an = names[a] if names else f"{a:09d}"
            bn = names[b] if names else f"{b:09d}"
            fh.write(
                f"{an} {bn} {-int(ovl.a_end[o] - ovl.a_start[o])} "
                f"{idt[o] * 100:.2f} 0 {int(ovl.a_start[o])} "
                f"{int(ovl.a_end[o])} {int(ovl.a_len[o])} "
                f"{int(ovl.strand[o])} {int(ovl.b_start[o])} "
                f"{int(ovl.b_end[o])} {int(ovl.b_len[o])}\n")


def read_overlaps(path: str,
                  name_to_id: dict[str, int] | None = None) -> OverlapSet:
    cols = {k: [] for k in ("a_id", "b_id", "strand", "a_start", "a_end",
                            "b_start", "b_end", "a_len", "b_len", "dist")}
    with open(path) as fh:
        for line in fh:
            f = line.split()
            if len(f) < 12:
                continue
            if name_to_id is not None:
                a = name_to_id.get(f[0], -1)
                b = name_to_id.get(f[1], -1)
                if a < 0 or b < 0:
                    continue
            else:
                a, b = int(f[0]), int(f[1])
            idt = float(f[3]) / 100.0
            a_s, a_e = int(f[5]), int(f[6])
            cols["a_id"].append(a)
            cols["b_id"].append(b)
            cols["strand"].append(int(f[8]))
            cols["a_start"].append(a_s)
            cols["a_end"].append(a_e)
            cols["a_len"].append(int(f[7]))
            cols["b_start"].append(int(f[9]))
            cols["b_end"].append(int(f[10]))
            cols["b_len"].append(int(f[11]))
            cols["dist"].append(int(round((1.0 - idt) * max(a_e - a_s, 1))))
    return OverlapSet(**{k: np.array(v, np.int32 if k != "strand"
                                     else np.int8)
                         for k, v in cols.items()})

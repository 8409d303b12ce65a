"""Stand-ins and faults for the harness's CPU tests.

Each is installed in the slot processes by a driver file of its own,
which ``driver_file`` writes into a copy of the benchmark: drivers are
found by name, so the benchmark's own files carry no seam for them.

``asm_oracle`` replaces the port's ``run_unzip`` and ``run_quiver`` with
a program that knows the slot's simulated truth (the port's plain DP
takes minutes a kilobase on the CPU): its 3-unzip writes the truth with
errors at the draft's rate, as an assembly of preads carries them, and
its 4-polish writes the truth.  The other ``asm_*`` faults break that
program one way each.  The ``cns_*`` faults break the port's own
FalconSense.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np

DRIVER = '''"""Slot driver {base!r} with the test fault {fault!r} installed."""
import os

from benchmark import slots

_base = slots.load_file(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "{base}.py"),
    "fu_bench_fault_base")
RATE = _base.RATE
prepare, job, finish, check = _base.prepare, _base.job, _base.finish, \\
    _base.check
owed = getattr(_base, "owed", lambda state: False)


def setup(ctx):
    from benchmark.tests import faults
    faults.{fault}(ctx)
    return _base.setup(ctx)
'''


def driver_file(bench_dir: str, base: str, fault: str) -> str:
    """Write ``drivers/<fault>.py`` into a copy of the benchmark: the driver
    ``base`` with ``fault`` installed in each slot.  Returns its name."""
    with open(os.path.join(bench_dir, "drivers", f"{fault}.py"), "w") as fh:
        fh.write(DRIVER.format(base=base, fault=fault))
    return fault


def _truth(slot_dir: str) -> dict:
    z = np.load(os.path.join(slot_dir, "truth.npz"))
    cuts = np.cumsum(z["lens"])[:-1]
    return {"hap0": np.split(z["hap0"], cuts),
            "hap1": np.split(z["hap1"], cuts),
            "names": [str(n) for n in z["names"]], "origin": z["origin"]}


def _fasta(path: str, recs) -> None:
    from benchmark.sim import fasta_bytes
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as fh:
        fh.write(fasta_bytes(recs))


def _log(out_dir: str, *stages) -> None:
    with open(os.path.join(out_dir, "metrics.jsonl"), "a") as fh:
        for st in stages:
            fh.write(json.dumps({"ts": time.time(), "stage": st, "s": 0.01})
                     + "\n")


def _contigs(t: dict) -> tuple:
    """The assembly the oracle's 4-polish writes: hap0 as the primaries,
    hap1's het stretch (20-80%) as a haplotig of each."""
    p = [(f"{ci:06d}F", h) for ci, h in enumerate(t["hap0"])]
    h = [(f"{ci:06d}F_01", h[len(h) // 5 : 4 * len(h) // 5])
         for ci, h in enumerate(t["hap1"])]
    return p, h


def asm_oracle(ctx: dict, break_unzip=None, break_polish=None) -> None:
    from falcon_unzip_tpu_torch.pipeline import quiver, unzip

    from benchmark import sim

    def run_unzip(cfg, device):
        t = _truth(ctx["dir"])
        rng = np.random.default_rng(7)
        out = os.path.join(cfg.out_dir, "3-unzip")
        p, h = _contigs(t)
        p, h = ([(n, sim.mutate(rng, s, ctx["config"]["draft_error"])[0])
                 for n, s in recs] for recs in (p, h))
        rows = [(int(c), 0, int(hp), n)
                for n, (c, hp) in zip(t["names"], t["origin"])]
        if break_unzip:
            p, h, rows = break_unzip(t, p, h, rows)
        _fasta(os.path.join(out, "all_p_ctg.fa"), p)
        _fasta(os.path.join(out, "all_h_ctg.fa"), h)
        with open(os.path.join(out, "all_phased_reads"), "w") as fh:
            for c, b, ph, n in rows:
                fh.write(f"{c:06d}F {b} {ph} {n}\n")
        _log(cfg.out_dir, "align_compute", "hasm_overlaps")
        return {}

    def run_quiver(cfg, device):
        from benchmark.drivers.assembly import read_fasta
        src = os.path.join(cfg.out_dir, "3-unzip")
        out = os.path.join(cfg.out_dir, "4-polish")
        p, h = _contigs(_truth(ctx["dir"]))
        if break_polish:
            p, h = break_polish(src, p, h)
        _fasta(os.path.join(out, "cns_p_ctg.fasta"), p)
        _fasta(os.path.join(out, "cns_h_ctg.fasta"), h)
        _log(cfg.out_dir, "align_compute", "polish_windows")
        return {}

    unzip.run_unzip, quiver.run_quiver = run_unzip, run_quiver


def _every(seq: np.ndarray, step: int) -> np.ndarray:
    out = np.array(seq, np.int8)
    out[::step] = (out[::step] + 1) % 4
    return out


def asm_unphased(ctx):
    """3-unzip's phasing returns its state unchanged: nothing phased."""
    asm_oracle(ctx, break_unzip=lambda t, p, h, rows: (p, h, []))


def asm_phase_swapped(ctx):
    """The phase of every second read of a block answered wrong."""
    asm_oracle(ctx, break_unzip=lambda t, p, h, rows: (p, h, [
        (c, b, 1 - ph if i % 2 else ph, n)
        for i, (c, b, ph, n) in enumerate(rows)]))


def asm_half(ctx):
    """Half of the contigs left out of 4-polish."""
    asm_oracle(ctx, break_polish=lambda src, p, h: (p[: len(p) // 2],
                                                    h[: len(h) // 2]))


def asm_altered(ctx):
    """Bases altered where the consensus is produced, at three times the
    rate that the cell's limit allows."""
    step = int(1e6 / (3 * ctx["config"]["limits"]["cns_err_per_mb"]))
    asm_oracle(ctx, break_polish=lambda src, p, h: (
        [(n, _every(s, step)) for n, s in p],
        [(n, _every(s, step)) for n, s in h]))


def asm_polish_returns_input(ctx):
    """4-polish returns the 3-unzip contigs it was given, unpolished."""
    def same(src, p, h):
        from benchmark.drivers.assembly import read_fasta
        return (read_fasta(os.path.join(src, "all_p_ctg.fa")),
                read_fasta(os.path.join(src, "all_h_ctg.fa")))
    asm_oracle(ctx, break_polish=same)


def asm_haplotig_primary_alleles(ctx):
    """Each haplotig carries its primary's alleles (hap0's) instead of the
    other haplotype's."""
    asm_oracle(ctx, break_polish=lambda src, p, h: (p, [
        (n, s[len(s) // 5 : len(s) // 5 + len(hs)])
        for (n, hs), (_, s) in zip(h, p)]))


def _wrap_falconsense(change):
    from falcon_unzip_tpu_torch.models import consensus
    call = consensus.FalconSense.__call__

    def broken(self, template, reads):
        return change(np.asarray(call(self, template, reads)),
                      np.asarray(template, np.int8))
    consensus.FalconSense.__call__ = broken


def cns_unchanged(ctx):
    """The consensus step returns the template unchanged."""
    _wrap_falconsense(lambda cns, tpl: tpl)


def cns_half(ctx):
    """Half of the template left out of the consensus."""
    _wrap_falconsense(lambda cns, tpl: cns[: len(cns) // 2])


def cns_altered(ctx):
    """Bases altered where the consensus is produced, at three times the
    rate that the cell's limit allows above the sound consensus."""
    step = int(100 / (3 * ctx["config"]["limits"]["cns_err_pct"]))
    _wrap_falconsense(lambda cns, tpl: _every(cns, step))

"""Stand-in and faults for the four-host cell's CPU tests.

Each is installed in the rank processes by a driver file of its own,
which ``driver_file`` writes into a copy of the benchmark (the benchmark's
own files carry no seam for them), over ``drivers/assembly_ranks.py``.

``ranks_oracle`` replaces the port's ``run_unzip`` and ``run_quiver``
(the port's plain DP takes minutes a kilobase on the CPU) with a program
that knows the simulated truth and runs the port's own collectives as the
pipelines do: each rank takes its ``host_shard`` of the preads, routes
each read to the rank that owns its contig (``contig_owners``,
``exchange_to_owners``), phases the reads it received onto their
haplotype of origin, and gathers them to host 0 (``gather_to_primary``),
which writes the 3-unzip outputs (the truth at the draft's error rate);
its 4-polish gathers the numbers of each rank's owned contigs to host
0, which writes those contigs (the truth).  Stage rows and, traced, the
spans (under a CPU profiler of its own) go to each rank's
``metrics.jsonl``.  The other ``ranks_*`` functions break it, or the
port's collectives under it, one way each.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np

from benchmark.tests import faults

DRIVER = '''"""Slot driver 'assembly_ranks' with the test fault {fault!r} installed."""
import os

from benchmark import slots

_base = slots.load_file(
    os.path.join(os.path.dirname(os.path.abspath(__file__)),
                 "assembly_ranks.py"), "fu_bench_ranks_base")
RATE = _base.RATE
prepare, job, finish, check, owed = (_base.prepare, _base.job, _base.finish,
                                     _base.check, _base.owed)


def setup(ctx):
    from benchmark.tests import ranks_faults
    ranks_faults.{fault}(ctx)
    return _base.setup(ctx)
'''


def driver_file(bench_dir: str, fault: str) -> str:
    """Write ``drivers/<fault>.py`` into a copy of the benchmark; returns
    its name."""
    with open(os.path.join(bench_dir, "drivers", f"{fault}.py"), "w") as fh:
        fh.write(DRIVER.format(fault=fault))
    return fault


def _blob(obj) -> bytes:
    return json.dumps(obj).encode()


def _unblob(b: bytes):
    return json.loads(b) if b else []


def ranks_oracle(ctx: dict, after_polish=None, fail_at=None) -> None:
    """The stand-in; ``after_polish(rank)`` runs at the end of each
    4-polish, ``fail_at`` (rank, job directory name) raises there."""
    from falcon_unzip_tpu_torch.parallel import distributed as dist
    from falcon_unzip_tpu_torch.pipeline import quiver, unzip
    from falcon_unzip_tpu_torch.utils.metrics import MetricsLog
    from falcon_unzip_tpu_torch.utils.profiling import log_spans, span

    from benchmark import sim

    def world():
        return ctx["shared"]["world"]

    def traced(part, cfg, body):
        dist.initialize()
        me, P = dist.process_index(), dist.process_count()
        if fail_at == (me, os.path.basename(cfg.out_dir)):
            raise RuntimeError(f"rank {me} fails in {part}")
        root = cfg.out_dir if me == 0 else os.path.join(cfg.out_dir,
                                                        f".host{me}")
        metrics = MetricsLog(os.path.join(root, "metrics.jsonl"))
        t = faults._truth(world())
        owners = dist.contig_owners([len(h) for h in t["hap0"]], P)
        prof = None
        if ctx["traced"]:
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[ProfilerActivity.CPU])
            prof.start()
        try:
            with span(f"run_{part}", rank=me, world=P):
                body(cfg, me, P, t, owners)
                dist.barrier(f"{part}-done")
        finally:
            if prof:
                prof.stop()
        metrics.log(f"{part}_oracle", s=0.01)
        log_spans(metrics)

    def unzip_body(cfg, me, P, t, owners):
        a, b = dist.host_shard(len(t["names"]))
        blobs = [[] for _ in range(P)]
        for name, (c, hp) in zip(t["names"][a:b], t["origin"][a:b]):
            blobs[owners[c]].append([int(c), int(hp), name])
        got = [r for blob in dist.exchange_to_owners(
            [_blob(x) for x in blobs]) for r in _unblob(blob)]
        gathered = dist.gather_to_primary(_blob(got))
        if gathered is None:
            return
        rows = sorted(r for blob in gathered for r in _unblob(blob))
        rng = np.random.default_rng(7)
        p, h = faults._contigs(t)
        p, h = ([(n, sim.mutate(rng, s, ctx["config"]["draft_error"])[0])
                 for n, s in recs] for recs in (p, h))
        out = os.path.join(cfg.out_dir, "3-unzip")
        faults._fasta(os.path.join(out, "all_p_ctg.fa"), p)
        faults._fasta(os.path.join(out, "all_h_ctg.fa"), h)
        with open(os.path.join(out, "all_phased_reads"), "w") as fh:
            for c, hp, n in rows:
                fh.write(f"{c:06d}F 0 {hp} {n}\n")

    def quiver_body(cfg, me, P, t, owners):
        mine = [ci for ci in range(len(owners)) if owners[ci] == me]
        gathered = dist.gather_to_primary(_blob(mine))
        if gathered is not None:
            got = sorted(ci for blob in gathered for ci in _unblob(blob))
            p, h = faults._contigs(t)
            out = os.path.join(cfg.out_dir, "4-polish")
            faults._fasta(os.path.join(out, "cns_p_ctg.fasta"),
                          [p[ci] for ci in got])
            faults._fasta(os.path.join(out, "cns_h_ctg.fasta"),
                          [h[ci] for ci in got])
        if after_polish:
            after_polish(me)

    unzip.run_unzip = lambda cfg, device: traced("unzip", cfg, unzip_body)
    quiver.run_quiver = lambda cfg, device: traced("quiver", cfg,
                                                   quiver_body)


def ranks_straggler(ctx):
    """Rank 3 ends each job 1.5 s after the others: its clock passes the
    window's end while theirs has not."""
    ranks_oracle(ctx, after_polish=lambda me: time.sleep(1.5 * (me == 3)))


def ranks_rank_raises(ctx):
    """Rank 2 raises as its first timed job starts."""
    ranks_oracle(ctx, fail_at=(2, "job0"))


def ranks_exchange_keeps_own(ctx):
    """Rank 1's ``exchange_to_owners`` keeps only the blob it sent itself:
    the reads the other ranks routed to its contigs are lost."""
    from falcon_unzip_tpu_torch.parallel import distributed as dist
    real = dist.exchange_to_owners

    def exchange(blobs):
        got = real(blobs)
        me = dist.process_index()
        return [g if s == me or me != 1 else b"" for s, g in enumerate(got)]
    dist.exchange_to_owners = exchange
    ranks_oracle(ctx)


def ranks_primary_keeps_own(ctx):
    """Host 0 keeps only its own blob of each gather: it emits its own
    contigs only."""
    from falcon_unzip_tpu_torch.parallel import distributed as dist
    real = dist.gather_to_primary

    def gather(payload):
        got = real(payload)
        return None if got is None else got[:1] + [b""] * (len(got) - 1)
    dist.gather_to_primary = gather
    ranks_oracle(ctx)

"""Slot driver of the four-host cell: FALCON-Unzip over one world of ranks.

The slots are the ranks of one torch.distributed world on gloo (the
port's ``cfg.mesh.multihost`` path): slot s is rank s, on card s, pinned
to the first ``cores`` of its share of the host's cores.  The parent
(``prepare``) picks a free local port and simulates the genome once, each
contig in a spawned process from ``sim.seed_of(seed, 0, 0, ci, .)``, with
the configuration's recipe (as the assembly cell's ``_sim``), and writes
the three input FASTAs and ``truth.npz`` under the run's directory for
every rank to read.

Set-up joins the world (``dist.initialize`` with the mix's timeout, well
inside the run's drain limit, so that a rank that dies ends the run) and
warms up with one four-rank job on a small genome of the same recipe
that gives every rank a contig of its own.  A job is one whole assembly
over the world, ``run_unzip`` then ``run_quiver`` in a fresh directory
all ranks share: host 0 writes the canonical outputs, host k its scratch
under ``.host<k>/``.  Each rank's record counts a quarter of the genome,
so that the harness's rate reads genome bases a second of the world's
job; it carries the rank's own stage rows (its ``metrics.jsonl``) and
its own card's peak memory.

The ranks agree on how many jobs they run: before each job they vote
(one gloo all-reduce of the max of one int).  A rank whose clock is
before the window's end votes 1 as its job starts; a rank past it votes
0 in ``owed``, and runs the job that the vote asks for without voting
again.  A job that raises ends the slot's run (``RankFailed``): the
world cannot go on without the rank, and the run gives no result.

After the window host 0's first job is judged (``check``): the assembly
cell's comparison with the reference, on the canonical outputs.
"""
from __future__ import annotations

import os
import shutil
import socket
import sys
import time

import numpy as np

from benchmark.drivers import assembly

RATE = "contig_bp_per_s"


class RankFailed(BaseException):
    """A rank's job raised: the slot ends its run instead of recording a
    failed job and going on alone (its peers would block in their next
    collective)."""


# ---- parent side: the shared inputs

def _contig(args: tuple) -> dict:
    """One contig of the configuration's recipe: its haplotypes, SNPs,
    preads (with their haplotype of origin and span), raw reads and
    draft (spawned-process target)."""
    from benchmark import sim
    cfg, length, seed, tag, ci = args
    dip = sim.make_diploid(length, cfg["het_rate"],
                           sim.seed_of(seed, 0, tag, ci, 0),
                           tuple(cfg["het_span"]))
    out = {"hap0": dip.hap0, "hap1": dip.hap1, "snp": dip.snp_pos}
    for kind, key, part in (("preads", "pread", 1), ("raw", "raw", 2)):
        rd = sim.simulate_reads([dip.hap0, dip.hap1], cfg[f"{key}_coverage"],
                                cfg[f"{key}_len"], cfg[f"{key}_error"],
                                sim.seed_of(seed, 0, tag, ci, part))
        out[kind] = [(f"c{ci}/{kind[0]}{i}", s) for i, s in enumerate(rd.seqs)]
        if kind == "preads":
            out["origin"] = [(ci, int(h)) for h in rd.hap]
            out["span"] = list(zip(rd.start.tolist(), rd.end.tolist()))
    out["draft"] = (f"draft{ci}", sim.mutate(
        np.random.default_rng(sim.seed_of(seed, 0, tag, ci, 3)), dip.hap0,
        cfg["draft_error"])[0])
    return out


def _simulate(cfg: dict, genome_bp: int, fractions: list, seed: int,
              tag: int, pool) -> dict:
    """The genome, contig by contig on ``pool``, gathered in contig order
    into the assembly driver's layout."""
    from benchmark import sim
    from benchmark.drivers import assembly_ranks as me   # picklable by name
    lens = sim.contig_lengths(genome_bp, fractions)
    parts = pool.map(me._contig, [(cfg, n, seed, tag, ci)
                                  for ci, n in enumerate(lens)])
    genome = {k: [] for k in ("hap0", "hap1", "snp", "preads", "raw",
                              "origin", "span", "draft")}
    for p in parts:
        for k in ("hap0", "hap1", "snp"):
            genome[k].append(p[k])
        for k in ("preads", "raw", "origin", "span"):
            genome[k] += p[k]
        genome["draft"].append(p["draft"])
    return genome


def _write_truth(path: str, genome: dict) -> None:
    np.savez(path, hap0=np.concatenate(genome["hap0"]),
             hap1=np.concatenate(genome["hap1"]),
             lens=np.array([len(h) for h in genome["hap0"]]),
             names=np.array([n for n, _ in genome["preads"]]),
             origin=np.array(genome["origin"], np.int64),
             span=np.array(genome["span"], np.int64),
             snp=np.concatenate(genome["snp"]),
             snp_lens=np.array([len(x) for x in genome["snp"]]))


def prepare(spec: dict, seed: int, run_dir: str) -> tuple:
    """A free local port for the world, and the genome and the warm-up
    genome written once under the run's directory, shared by the ranks."""
    import multiprocessing
    cfg, traffic = spec["config"], spec["traffic"]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    world = os.path.join(run_dir, "world")
    n_warm = traffic["warmup_contigs"]
    with multiprocessing.get_context("spawn").Pool(
            min(len(cfg["contig_fractions"]),
                len(os.sched_getaffinity(0)))) as pool:
        genome = _simulate(cfg, cfg["genome_bp"], cfg["contig_fractions"],
                           seed, 0, pool)
        warm = _simulate(cfg, traffic["warmup_bp"], [1 / n_warm] * n_warm,
                         seed, 1, pool)
    paths = assembly._write_inputs(os.path.join(world, "inputs"), genome)
    _write_truth(os.path.join(world, "truth.npz"), genome)
    warm_paths = assembly._write_inputs(os.path.join(world, "warm_inputs"),
                                        warm)
    shared = {"port": port, "world": world, "paths": paths,
              "warm_paths": warm_paths}
    return shared, {}


# ---- slot side: one rank

def _vote(want: int) -> bool:
    """Whether any rank wants another job (every rank must call)."""
    import torch
    import torch.distributed as tdist
    flag = torch.tensor([want], dtype=torch.int32)
    tdist.all_reduce(flag, op=tdist.ReduceOp.MAX)
    return bool(int(flag[0]))


def _world_job(ctx: dict, paths: dict, d: str) -> dict:
    """One assembly over the world in directory d; this rank's stage rows
    (from its own ``metrics.jsonl``) and its card's peak memory."""
    import torch
    from falcon_unzip_tpu_torch.parallel import distributed as dist
    from falcon_unzip_tpu_torch.pipeline.quiver import run_quiver
    from falcon_unzip_tpu_torch.pipeline.unzip import run_unzip
    cfg = assembly._pipeline_cfg(ctx, paths, d)
    rank = dist.process_index()
    mine = d if rank == 0 else os.path.join(d, f".host{rank}")
    cuda = ctx["device"].type == "cuda"
    dev = "cuda" if cuda else "cpu"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    stages, skip = {}, 0
    for part, call in (("unzip", run_unzip), ("quiver", run_quiver)):
        call(cfg, dev)
        if cuda:
            torch.cuda.synchronize()
        stages[part] = assembly._rows(mine, skip)
        skip += len(stages[part])
    return {"stages": stages, "rank": rank,
            "card": torch.cuda.current_device() if cuda else None,
            "card_memory_peak_bytes": torch.cuda.max_memory_allocated()
            if cuda else 0}


def setup(ctx: dict) -> dict:
    import torch
    from falcon_unzip_tpu_torch.parallel import distributed as dist
    traffic, shared = ctx["traffic"], ctx["shared"]
    cores = ctx["cores"][: traffic["cores"]]
    if cores:
        os.sched_setaffinity(0, cores)
        torch.set_num_threads(len(cores))
    n, s = ctx["n_slots"], ctx["slot"]
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(shared["port"]),
                      WORLD_SIZE=str(n), RANK=str(s), LOCAL_RANK=str(s),
                      LOCAL_WORLD_SIZE=str(n))
    dist.initialize(timeout_s=traffic["timeout_s"])
    if dist.process_count() != n or dist.process_index() != s:
        raise RuntimeError(f"slot {s} joined as rank {dist.process_index()} "
                           f"of {dist.process_count()}")
    t = time.time()
    warm = _world_job(ctx, shared["warm_paths"],
                      os.path.join(shared["world"], "warm"))
    print(f"[rank {s}] card {warm['card']} cores {cores} warm-up "
          f"{time.time() - t:.2f} s", file=sys.stderr, flush=True)
    return {"ctx": ctx, "rank": s, "voted": False,
            "bp": ctx["config"]["genome_bp"] / n}


def owed(state: dict) -> bool:
    """Past the window's end: whether another rank still starts a job."""
    state["voted"] = _vote(0)
    return state["voted"]


def job(state: dict, k: int) -> dict:
    ctx = state["ctx"]
    shared = ctx["shared"]
    try:
        if not state["voted"]:
            _vote(1)
        state["voted"] = False
        if state["rank"] == 0 and k > 1:   # every rank has read job k - 1
            shutil.rmtree(os.path.join(shared["world"], f"job{k - 1}"),
                          ignore_errors=True)
        info = _world_job(ctx, shared["paths"],
                          os.path.join(shared["world"], f"job{k}"))
    except Exception as e:
        raise RankFailed(f"rank {state['rank']} job {k}: {e!r}") from e
    return {"bp": state["bp"], **info}


def finish(state: dict) -> dict:
    """Host 0's directory holds the truth and the first job's canonical
    outputs; the other ranks' hold nothing to judge."""
    world = state["ctx"]["shared"]["world"]
    return {"dir": world if state["rank"] == 0 else None}


# ---- parent side: the comparison with the reference

def check(spec: dict, results: list, shared: dict) -> tuple:
    """(end-to-end metrics, compared numbers): the assembly cell's
    comparison on host 0's first job, the whole genome."""
    for res in results:
        recs = res["records"]
        peak = max((r.get("card_memory_peak_bytes", 0) for r in recs),
                   default=0)
        print(f"[rank {res['slot']}] card {recs[0].get('card') if recs else None}"
              f", peak memory {peak} B, jobs "
              f"{[round(r['end'] - r['start'], 2) for r in recs]} s",
              file=sys.stderr, flush=True)
    return assembly.check(spec, [r for r in results
                                 if r["outputs"]["dir"] is not None], shared)

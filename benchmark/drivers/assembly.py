"""Slot driver of the assembly cells: whole FALCON-Unzip assemblies.

Each slot simulates its own genome from the run's seed and its slot
number (the configuration's contig shapes, heterozygosity, reads and a
draft that carries the preads' error rate, as a FALCON draft assembled
from preads does), writes the three input FASTAs once, and then runs
jobs, each in a fresh directory: ``run_unzip`` then ``run_quiver``.

Warm-up runs the same job on a small one-contig genome of the same
recipe.  A job counts the draft's bases.  The first job of each slot is
kept and judged after the window (``check``): its polished primaries and
haplotigs against the simulated haplotypes, each piece against its best
haplotype; the het SNPs whose other allele none of them carries; its
phased reads against their haplotype of origin (a pread spanning two het
sites or more that is not phased counts as wrong); and the primaries'
span against the genome.
"""
from __future__ import annotations

import json
import os
import shutil
import sys

import numpy as np

RATE = "contig_bp_per_s"


def _sim(cfg: dict, genome_bp: int, fractions: list, seed: int, slot: int,
         tag: int) -> dict:
    """A genome of the configuration's recipe: its haplotypes, preads (with
    their haplotype of origin), raw reads and draft."""
    from benchmark import sim
    lens = sim.contig_lengths(genome_bp, fractions)
    out = {"hap0": [], "hap1": [], "preads": [], "raw": [], "origin": [],
           "span": [], "snp": [], "draft": []}
    for ci, length in enumerate(lens):
        dip = sim.make_diploid(length, cfg["het_rate"],
                               sim.seed_of(seed, slot, tag, ci, 0),
                               tuple(cfg["het_span"]))
        out["hap0"].append(dip.hap0)
        out["hap1"].append(dip.hap1)
        out["snp"].append(dip.snp_pos)
        for kind, key in (("preads", "pread"), ("raw", "raw")):
            rd = sim.simulate_reads(
                [dip.hap0, dip.hap1], cfg[f"{key}_coverage"],
                cfg[f"{key}_len"], cfg[f"{key}_error"],
                sim.seed_of(seed, slot, tag, ci, 1 if kind == "preads" else 2))
            out[kind] += [(f"c{ci}/{kind[0]}{i}", s)
                          for i, s in enumerate(rd.seqs)]
            if kind == "preads":
                out["origin"] += [(ci, int(h)) for h in rd.hap]
                out["span"] += list(zip(rd.start.tolist(), rd.end.tolist()))
        draft, _ = sim.mutate(
            np.random.default_rng(sim.seed_of(seed, slot, tag, ci, 3)),
            dip.hap0, cfg["draft_error"])
        out["draft"].append((f"draft{ci}", draft))
    return out


def _write_inputs(d: str, genome: dict) -> dict:
    from benchmark import sim
    os.makedirs(d, exist_ok=True)
    paths = {k: os.path.join(d, f"{k}.fa") for k in ("preads", "raw", "draft")}
    records = {k: genome[k] for k in ("preads", "raw", "draft")}
    for k, path in paths.items():
        with open(path, "wb") as fh:
            fh.write(sim.fasta_bytes(records[k]))
    return paths


def _pipeline_cfg(ctx: dict, paths: dict, out_dir: str):
    from falcon_unzip_tpu_torch.config import PipelineConfig
    cfg = PipelineConfig(preads=paths["preads"], reads=paths["raw"],
                         draft=paths["draft"], out_dir=out_dir)
    knobs = dict(ctx["config"].get("pipeline", {}))
    if ctx["control"]:
        for sec, kv in ctx["config"]["control"].get("pipeline", {}).items():
            knobs[sec] = {**knobs.get(sec, {}), **kv}
    for sec, kv in knobs.items():
        for key, val in kv.items():
            setattr(getattr(cfg, sec), key, val)
    return cfg


def _rows(out_dir: str, skip: int) -> list:
    path = os.path.join(out_dir, "metrics.jsonl")
    with open(path) as fh:
        return [json.loads(x) for x in fh.read().splitlines()[skip:]]


def _job(ctx: dict, paths: dict, d: str) -> dict:
    """One job in directory d; its stage rows."""
    import torch
    from falcon_unzip_tpu_torch.pipeline.quiver import run_quiver
    from falcon_unzip_tpu_torch.pipeline.unzip import run_unzip
    cfg = _pipeline_cfg(ctx, paths, d)
    dev = ctx["device"]
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    stages = {}
    for part, call in (("unzip", run_unzip), ("quiver", run_quiver)):
        skip = sum(len(v) for v in stages.values())
        call(cfg, dev)
        sync()
        stages[part] = _rows(d, skip)
    return {"stages": stages}


def setup(ctx: dict) -> dict:
    cfg, traffic = ctx["config"], ctx["traffic"]
    genome = _sim(cfg, cfg["genome_bp"], cfg["contig_fractions"],
                  ctx["seed"], ctx["slot"], 0)
    d = ctx["dir"]
    paths = _write_inputs(os.path.join(d, "inputs"), genome)
    np.savez(os.path.join(d, "truth.npz"),
             hap0=np.concatenate(genome["hap0"]),
             hap1=np.concatenate(genome["hap1"]),
             lens=np.array([len(h) for h in genome["hap0"]]),
             names=np.array([n for n, _ in genome["preads"]]),
             origin=np.array(genome["origin"], np.int64),
             span=np.array(genome["span"], np.int64),
             snp=np.concatenate(genome["snp"]),
             snp_lens=np.array([len(x) for x in genome["snp"]]))
    state = {"ctx": ctx, "paths": paths, "bp": int(cfg["genome_bp"])}
    del genome
    warm = _sim(cfg, traffic["warmup_bp"], [1.0], ctx["seed"], ctx["slot"],
                1)
    _job(ctx, _write_inputs(os.path.join(d, "warm_inputs"), warm),
         os.path.join(d, "warm"))
    return state


def job(state: dict, k: int) -> dict:
    ctx = state["ctx"]
    d = os.path.join(ctx["dir"], f"job{k}")
    info = _job(ctx, state["paths"], d)
    if k > 0:                         # only the first job is judged
        shutil.rmtree(d, ignore_errors=True)
    return {"bp": state["bp"], **info}


def finish(state: dict) -> dict:
    return {"dir": state["ctx"]["dir"]}


# ---- parent side: the comparison with the reference

def prepare(spec: dict, seed: int, run_dir: str) -> tuple:
    """Nothing shared: each slot simulates its own genome."""
    return {}, {}


def read_fasta(path: str) -> list:
    """[(name, int8 codes)] of a FASTA file (plain parser)."""
    from benchmark.sim import ASCII
    table = np.full(256, 4, np.int8)
    for code, ch in enumerate(ASCII[:4]):
        table[ch] = code
        table[ord(chr(ch).lower())] = code
    out = []
    with open(path, "rb") as fh:
        for rec in fh.read().split(b">")[1:]:
            head, _, body = rec.partition(b"\n")
            seq = np.frombuffer(body.replace(b"\n", b""), np.uint8)
            out.append((head.split()[0].decode(), table[seq]))
    return out


def check(spec: dict, results: list, shared: dict) -> tuple:
    """(end-to-end metrics, compared numbers) from each slot's first job."""
    from benchmark import reference as ref
    limits = spec["config"]["limits"]
    errors = bases = reads = wrong = p_bp = genome_bp = shown = missing = 0
    for res in results:
        d = res["outputs"]["dir"]
        truth = np.load(os.path.join(d, "truth.npz"))
        cuts = np.cumsum(truth["lens"])[:-1]
        hap0, hap1 = (np.split(truth[h], cuts) for h in ("hap0", "hap1"))
        snps = np.split(truth["snp"], np.cumsum(truth["snp_lens"])[:-1])
        genome_bp += sum(len(h) for h in hap0)
        job0 = os.path.join(d, "job0")
        recs_all = []
        for part in ("p", "h"):
            path = os.path.join(job0, "4-polish", f"cns_{part}_ctg.fasta")
            recs = read_fasta(path) if os.path.exists(path) else []
            recs_all += recs
            if part == "p":
                p_bp += sum(len(s) for _, s in recs)
        seqs = [s for _, s in recs_all]
        sc = ref.score_assembly(seqs, hap0, hap1)
        errors += sc["errors"]
        bases += sc["bases"]
        al = ref.score_alleles(seqs, hap0, hap1, snps)
        shown += al["shown"]
        missing += al["missing"]
        origin = {str(n): (int(c), int(h)) for n, (c, h)
                  in zip(truth["names"], truth["origin"])}
        phaseable = {str(n) for n, (c, _), (a, b) in zip(
            truth["names"], truth["origin"], truth["span"])
            if np.searchsorted(snps[c], b) - np.searchsorted(snps[c], a) >= 2}
        rows = []
        path = os.path.join(job0, "3-unzip", "all_phased_reads")
        if os.path.exists(path):
            with open(path) as fh:
                for line in fh:
                    ctg, blk, phs, name = line.split()
                    rows.append((int(ctg.rstrip("F")), int(blk), int(phs),
                                 name))
        ph = ref.score_phasing(rows, origin, phaseable)
        reads += ph["reads"]
        wrong += ph["wrong"] + ph["unphased"]
        for (name, s), e in zip(recs_all, sc["each"]):
            if e > 50:
                print(f"[check] slot {res['slot']} {name} ({len(s)} bp): "
                      f"{e} errors", file=sys.stderr, flush=True)
    metrics = {"asm_qv": ref.phred(errors, bases)}
    checks = {
        "cns_err_per_mb": (1e6 * errors / bases if bases else float("inf"),
                           limits["cns_err_per_mb"]),
        "allele_miss_pct": (100.0 * missing / shown if shown else 100.0,
                            limits["allele_miss_pct"]),
        "phase_err_pct": (100.0 * wrong / reads if reads else 100.0,
                          limits["phase_err_pct"]),
        "p_span_err_pct": (100.0 * abs(p_bp - genome_bp) / genome_bp,
                           limits["p_span_err_pct"]),
    }
    print(f"[check] polished p + h {bases} bp, {errors} errors; het SNPs "
          f"shown {shown}, {missing} with one allele only; preads "
          f"phaseable or phased {reads}, {wrong} wrong or unphased; "
          f"primaries {p_bp} bp of {genome_bp}", file=sys.stderr, flush=True)
    return metrics, checks

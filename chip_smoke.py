"""GPU smoke run of the PyTorch + CUDA port (falcon_unzip_tpu_torch).

    python3 chip_smoke.py [--genome-bp N]

Needs one NVIDIA GPU, nvcc and the repository beside this script; imports
nothing of JAX.  Phases, one line each, any failure exits non-zero:

1. card: name and power limit (nvidia-smi), torch / CUDA / nvcc versions;
2. build the CUDA kernels from falcon_unzip_tpu_torch/csrc/;
3. kernel parity: each kernel against its plain torch version on the card
   at the main path's shapes (P=256; W 128/256/512; global, qglocal and
   tglocal; query buckets 1024/2048/4096 with their target buckets; seeded
   pairs at 0% and 15% error).  dist, end_i, end_j, every packed
   backpointer and every traceback move must be bit-exact;
4. golden fixture: 3-unzip on cuda (the port's command line, which calls
   run_unzip) must reproduce the golden hashes of tests/test_golden.py
   through both kernels;
5. the main path at size: 3-unzip on cuda over a diploid genome of
   --genome-bp (default 1 Mb) with the n50 contig profile and 25x preads
   (the recipe of scripts/e2e_bench.py); per-stage seconds, kernel
   launches, DP cells, cell rate and peak device memory;
6. the result line.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def phase_card(torch) -> str:
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false")
    smi = _smi()
    from falcon_unzip_tpu_torch.ops import _kernels
    nvcc = subprocess.run([_kernels._nvcc(), "--version"],
                          capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[1 card] {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {nvcc}", flush=True)
    return smi


def phase_build() -> None:
    from falcon_unzip_tpu_torch.ops import _kernels
    t0 = time.perf_counter()
    _kernels._load()
    ptxas = [ln.strip() for ln in _kernels.BUILD_LOG.splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"[2 build] {time.perf_counter() - t0:.2f} s | "
          + " | ".join(ptxas), flush=True)


def _pairs(rng, P, bq, mode):
    """P seeded (query, target) pairs for query bucket bq: half exact,
    half at 15% error; query lengths in (bq/2, bq].  Returns lists of
    int8 base-code arrays."""
    from falcon_unzip_tpu_torch.utils.simulate import (mutate_read,
                                                       random_genome)
    qs, ts = [], []
    for k in range(P):
        err = 0.0 if k < P // 2 else 0.15
        L = int(rng.integers(bq // 2 + 1, bq + 1))
        if mode == "global":
            t = random_genome(L, int(rng.integers(1 << 30)))
            q = mutate_read(t, err, rng)[:bq]
        else:
            pad = int(rng.integers(40, 300))
            t = random_genome(L + pad, int(rng.integers(1 << 30)))
            off = int(rng.integers(0, pad))
            q = mutate_read(t[off : off + L], err, rng)[:bq]
        qs.append(q)
        ts.append(t)
    return qs, ts


def _padded(np, seqs, width):
    """PAD-filled (len(seqs), width) int8 batch and its lengths."""
    out = np.full((len(seqs), width), 4, np.int8)     # 4: PAD / N
    for k, s in enumerate(seqs):
        out[k, : len(s)] = s
    return out, np.array([len(s) for s in seqs], np.int32)


def _time_ms(torch, fn, reps):
    fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def phase_parity(torch, np) -> dict:
    from falcon_unzip_tpu_torch.models.aligner import _t_bucket
    from falcon_unzip_tpu_torch.ops import banded_align as ba
    dev = torch.device("cuda")
    rng = np.random.default_rng(2024)
    P = 256
    shapes = {}
    for W in (128, 256, 512):
        for mode in ("global", "qglocal", "tglocal"):
            for bq in (1024, 2048, 4096):
                qs, ts = _pairs(rng, P, bq, mode)
                bt = _t_bucket(max(len(x) for x in ts), bq)
                q, n = _padded(np, qs, bq)
                t, m = _padded(np, ts, bt)
                # the schedule exactly as BandedAligner.dispatch cuts it
                Dmax, lo = ba.build_schedule(bq, bt, W)
                need = int((n + m).max()) + 1
                Dmax = min(Dmax, -(-need // 1024) * 1024)
                lo = lo[:Dmax]
                qg, trg, G = ba.prepare_batch(q, t, W)
                args = (torch.from_numpy(qg).to(dev),
                        torch.from_numpy(trg).to(dev),
                        torch.from_numpy(n).to(dev),
                        torch.from_numpy(m).to(dev), lo)
                kw = dict(W=W, Lt=bt, G=G, mode=mode)
                k = ba.banded_align_batch(*args, **kw)
                t0 = time.perf_counter()
                p = ba.banded_align_batch_plain(*args, **kw)
                torch.cuda.synchronize()
                plain_ms = 1e3 * (time.perf_counter() - t0)
                wf_err = max(int((k[key] - p[key]).abs().max())
                             for key in ("dist", "end_i", "end_j"))
                wf_err = max(wf_err, int((ba.unpack_bp(k["bp"], Dmax).int()
                                          - ba.unpack_bp(p["bp"], Dmax).int()
                                          ).abs().max()))
                for key in ("dist", "end_i", "end_j", "bp"):
                    if not torch.equal(k[key], p[key]):
                        _fail(f"wavefront {key} differs at W={W} {mode} "
                              f"bq={bq}")
                steps = Dmax - 1
                tk = ba.traceback_batch(k["bp"], lo, k["end_i"], k["end_j"],
                                        max_steps=steps)
                t0 = time.perf_counter()
                tp = ba.traceback_batch_plain(p["bp"], lo, p["end_i"],
                                              p["end_j"], max_steps=steps)
                torch.cuda.synchronize()
                plain_tb_ms = 1e3 * (time.perf_counter() - t0)
                tb_err = int((tk.int() - tp.int()).abs().max())
                if not torch.equal(tk, tp):
                    _fail(f"traceback differs at W={W} {mode} bq={bq}")
                wf_ms = _time_ms(torch, lambda: ba.banded_align_batch(
                    *args, **kw), 3)
                tb_ms = _time_ms(torch, lambda: ba.traceback_batch(
                    k["bp"], lo, k["end_i"], k["end_j"], max_steps=steps), 3)
                finite = int((k["dist"] < 1 << 20).sum())
                shapes[(W, mode, bq)] = dict(
                    wf_ms=wf_ms, wf_plain_ms=plain_ms, tb_ms=tb_ms,
                    tb_plain_ms=plain_tb_ms, wf_err=wf_err, tb_err=tb_err)
                print(f"[3 parity] W={W} {mode} bq={bq} bt={bt} Dmax={Dmax}"
                      f" finite={finite}/{P} exact | wavefront {wf_ms:.3f} ms"
                      f" (plain {plain_ms:.1f} ms) | traceback {tb_ms:.3f} ms"
                      f" (plain {plain_tb_ms:.1f} ms)", flush=True)
    return shapes


GOLDEN = {"all_p_ctg.fa": "2864673ab4dc9bf2",
          "all_h_ctg.fa": "70b2521a58bd85f1",
          "all_phased_reads": "3c3f04ee8364d5f6"}


def _decode(codes) -> str:
    """int8 base codes (A C G T N = 0..4) -> ASCII."""
    import numpy as np
    return np.frombuffer(b"ACGTN", np.uint8)[codes].tobytes().decode()


def _write_fasta(path, records) -> None:
    with open(path, "w") as fh:
        for name, seq in records:
            fh.write(f">{name}\n")
            for i in range(0, len(seq), 80):
                fh.write(seq[i : i + 80] + "\n")


def _fasta_lengths(path) -> list:
    lens = []
    with open(path) as fh:
        for ln in fh:
            if ln.startswith(">"):
                lens.append(0)
            else:
                lens[-1] += len(ln.strip())
    return lens


def _write_inputs(d, draft, reads) -> None:
    """draft: [(name, Diploid)]; reads: [(name_prefix, SeqBatch)]."""
    _write_fasta(f"{d}/preads.fa",
                 ((pre + b.names[i], b.to_str(i)) for pre, b in reads
                  for i in range(len(b))))
    _write_fasta(f"{d}/draft.fa",
                 [(name, _decode(dip.hap0)) for name, dip in draft])


def _run(d) -> None:
    """3-unzip on the card through the port's command line."""
    from falcon_unzip_tpu_torch.cli import main as cli_main
    with open(f"{d}/run.json", "w") as fh:
        json.dump({"preads": f"{d}/preads.fa", "draft": f"{d}/draft.fa",
                   "out_dir": f"{d}/out"}, fh)
    if cli_main(["unzip", f"{d}/run.json", "--device", "cuda"]) != 0:
        _fail(f"unzip exited non-zero in {d}")


def phase_golden(tmp) -> None:
    from falcon_unzip_tpu_torch.ops import _kernels
    from falcon_unzip_tpu_torch.utils.simulate import (make_diploid,
                                                       simulate_reads)
    d = os.path.join(tmp, "golden")
    os.makedirs(d)
    dip = make_diploid(length=6000, het_rate=0.02, seed=77,
                       het_span=(0.3, 0.7))
    pr = simulate_reads(dip, coverage=14.0, read_len=1800, error_rate=0.0,
                        seed=78)
    # the golden draft is named d0 (tests/test_golden.py)
    _write_inputs(d, [("d0", dip)], [("", pr.batch)])
    _kernels.reset_counts()
    t0 = time.perf_counter()
    _run(d)
    wall = time.perf_counter() - t0
    got = {}
    for rel, want in GOLDEN.items():
        with open(f"{d}/out/3-unzip/{rel}", "rb") as fh:
            got[rel] = hashlib.sha256(fh.read()).hexdigest()[:16]
        if got[rel] != want:
            _fail(f"golden {rel}: got {got[rel]}, want {want}")
    launches = {k.name: k.launches for k in _kernels.KERNELS}
    if min(launches.values()) <= 0:
        _fail(f"golden run did not launch every kernel: {launches}")
    print(f"[4 golden] {wall:.1f} s | hashes match {got} | launches "
          f"{launches}", flush=True)


def _n50_lengths(genome_bp):
    """scripts/e2e_bench.py::contig_lengths, profile n50."""
    fr = [0.5, 0.2, 0.1, 0.065, 0.065, 0.07]
    lens = [int(genome_bp * f) for f in fr[:-1]]
    return lens + [genome_bp - sum(lens)]


def _stats(lens) -> dict:
    lens = sorted(lens, reverse=True)
    total, acc, n50 = sum(lens), 0, 0
    for x in lens:
        acc += x
        if 2 * acc >= total:
            n50 = x
            break
    return {"n_seqs": len(lens), "total_bp": total, "n50": n50,
            "max_len": lens[0] if lens else 0}


def phase_main(torch, tmp, genome_bp) -> dict:
    from falcon_unzip_tpu_torch.ops import _kernels
    from falcon_unzip_tpu_torch.utils.simulate import (make_diploid,
                                                       simulate_reads)
    d = os.path.join(tmp, "main")
    os.makedirs(d)
    t0 = time.perf_counter()
    draft, reads = [], []
    for ci, per in enumerate(_n50_lengths(genome_bp)):
        dip = make_diploid(length=per, het_rate=0.012, seed=100 + ci,
                           het_span=(0.2, 0.8))
        pr = simulate_reads(dip, coverage=25.0, read_len=2200,
                            error_rate=0.0, seed=200 + ci)
        draft.append((f"draft{ci}", dip))
        reads.append((f"c{ci}/", pr.batch))
    _write_inputs(d, draft, reads)
    n_preads = sum(len(b) for _, b in reads)
    sim_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    for k in _kernels.KERNELS:
        k.timed = True
    _kernels.reset_counts()
    t0 = time.perf_counter()
    _run(d)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in _kernels.KERNELS}
    cells = _kernels.WAVEFRONT.cells
    dev_ms = {k.name: k.elapsed_ms() for k in _kernels.KERNELS}
    for k in _kernels.KERNELS:
        k.timed = False
    peak = torch.cuda.max_memory_allocated()
    stages = {}
    with open(f"{d}/out/metrics.jsonl") as fh:
        for ln in fh:
            row = json.loads(ln)
            if "s" in row:
                row.pop("ts")
                stages[row.pop("stage")] = row
    p_ctg = _stats(_fasta_lengths(f"{d}/out/3-unzip/all_p_ctg.fa"))
    h_ctg = _stats(_fasta_lengths(f"{d}/out/3-unzip/all_h_ctg.fa"))
    with open(f"{d}/out/3-unzip/all_phased_reads") as fh:
        n_phased = sum(1 for _ in fh)
    rate = cells / max(dev_ms["banded_wavefront"], 1e-9) / 1e6
    print(f"[5 main] genome {genome_bp} bp n50 profile, {n_preads} preads "
          f"25x | sim {sim_s:.1f} s | unzip {wall:.1f} s | stages "
          f"{stages} | launches {launches} | DP cells {cells} | kernel "
          f"device ms {dev_ms} | {rate:.2f} Gcell/s in the wavefront "
          f"kernel | peak device memory {peak / 2**30:.3f} GiB | p_ctg "
          f"{p_ctg} | h_ctg {h_ctg} | phased reads {n_phased}", flush=True)
    if p_ctg["total_bp"] < 0.9 * genome_bp:
        _fail(f"primary bp {p_ctg['total_bp']} < 90% of {genome_bp}")
    if h_ctg["n_seqs"] < 1:
        _fail("no haplotig")
    if n_phased == 0:
        _fail("all_phased_reads is empty")
    if min(launches.values()) <= 0:
        _fail(f"main path did not launch every kernel: {launches}")
    return {"launches": launches, "dev_ms": dev_ms}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--genome-bp", type=int, default=1_000_000)
    args = ap.parse_args(argv)
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "falcon_unzip_tpu_torch")):
        _fail("run from a checkout: falcon_unzip_tpu_torch/ is not beside "
              "this script")
    sys.path.insert(0, here)
    import numpy as np
    import torch

    smi = phase_card(torch)
    phase_build()
    shapes = phase_parity(torch, np)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        phase_golden(tmp)
        main_run = phase_main(torch, tmp, args.genome_bp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    at = shapes[(256, "tglocal", 2048)]
    src = "falcon_unzip_tpu_torch/csrc/banded_align.cu"
    kernels = [
        {"name": "banded_wavefront", "route": "cuda", "source": src,
         "replaces": "falcon_unzip_tpu/ops/pallas_align.py:41",
         "launches": main_run["launches"]["banded_wavefront"],
         "max_abs_err": max(v["wf_err"] for v in shapes.values()),
         "ms": at["wf_ms"], "plain_ms": at["wf_plain_ms"]},
        {"name": "traceback", "route": "cuda", "source": src,
         "replaces": "falcon_unzip_tpu/ops/banded_align.py:180",
         "launches": main_run["launches"]["traceback"],
         "max_abs_err": max(v["tb_err"] for v in shapes.values()),
         "ms": at["tb_ms"], "plain_ms": at["tb_plain_ms"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

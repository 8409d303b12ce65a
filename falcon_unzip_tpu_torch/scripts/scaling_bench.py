"""Scaling harness of the port: reads/s efficiency 1 -> N, three ways.

North-star gate (BASELINE.md): >= 80% reads/s scaling efficiency from 1
host to N hosts.  Each host is an OS process of one torch.distributed
world on gloo (MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK /
LOCAL_RANK / LOCAL_WORLD_SIZE), pinned to its own equal set of cores,
with one card of its own (``CUDA_VISIBLE_DEVICES``) while there are
cards enough; past that, ranks share cards (``ranks_per_card``), and the
walls then measure the gloo layer and rank start-up, not scaling.

1. full-pipeline weak scaling: ``run_unzip`` + ``run_quiver`` with
   ``cfg.mesh.multihost`` over N processes, the genome growing with N
   (``SCALING_PIPE_BP`` bp a host, default 80000), each rank's wall,
   host CPU seconds, peak RSS and kernel launches;
2. the phase step across processes: ``make_phase_step`` on a mesh with
   one slot a process (``SCALING_R_PER_DEV`` rows a process, default
   8192), its psum a gloo all_reduce; rank 0's reads/s and a digest of
   the step's outputs, equal to a one-process step's over the same rows;
3. the in-process mesh: the same step over 1, 2, 4 and 8 slots of one
   process (on the CPU logical shards of the one device; on cuda the
   cards, up to those visible).

  python -m falcon_unzip_tpu_torch.scripts.scaling_bench \\
      [--device cuda|cpu] [--scratch DIR]

``--device`` defaults to cuda and raises without a GPU; ``--scratch``
defaults to ``$TMPDIR/scaling_bench_torch``.  The workers are this module
run as ``--worker pipeline|phase``.  The last line is the JSON result.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import resource
import shutil
import socket
import subprocess
import sys
import tempfile
import time

if __name__ == "__main__":      # run as a file: this checkout first
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

MODULE = "falcon_unzip_tpu_torch.scripts.scaling_bench"
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PER_CTG = 40_000                # bp a simulated contig
T, T_LEN = 64, 4096             # phase step: tags a read, template length
PHASE_OUTPUTS = ("counts", "is_het", "b1", "b2", "score", "cov", "M")


def r_per_dev() -> int:
    return int(os.environ.get("SCALING_R_PER_DEV", "8192"))


def phase_inputs(R: int):
    """(tagpos, tagbase) (R, T) int32 rows of the phase step, rng(0)."""
    import numpy as np
    rng = np.random.default_rng(0)
    tagpos = rng.integers(0, T_LEN, size=(R, T)).astype(np.int32)
    tagbase = rng.integers(0, 4, size=(R, T)).astype(np.int32)
    return tagpos, tagbase


def run_phase_step(mesh, R: int):
    """The step on ``mesh`` (``make_phase_step`` at the reference's sizes)
    and its inputs on the mesh's first device: (step, tagpos, tagbase)."""
    import torch

    from falcon_unzip_tpu_torch.parallel.sharding import make_phase_step
    step = make_phase_step(mesh, t_len=T_LEN, s_cap=128, max_span=32,
                           min_depth=2)
    tagpos, tagbase = (torch.from_numpy(x).to(mesh.first)
                       for x in phase_inputs(R))
    return step, tagpos, tagbase


def phase_digest(outputs) -> str:
    """sha256 of the phase step's seven outputs (torch or numpy arrays,
    each with its dtype and shape), in ``PHASE_OUTPUTS`` order."""
    import numpy as np
    import torch
    h = hashlib.sha256()
    for a in outputs:
        a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        a = np.ascontiguousarray(a)
        h.update(f"{a.dtype.str}{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _sync(torch, dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def thread_cores() -> list:
    """The cores any thread of this process may run on."""
    return sorted(set().union(*(os.sched_getaffinity(int(t))
                                for t in os.listdir("/proc/self/task"))))


def life_s() -> float:
    """Seconds since this process started (its imports and set-up too,
    which its CPU seconds include and its timed wall does not)."""
    with open("/proc/self/stat") as fh:
        start = int(fh.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as fh:
        up = float(fh.read().split()[0])
    return round(up - start / os.sysconf("SC_CLK_TCK"), 2)


def pinned_cores(pid: int, per: int) -> set:
    """The ``per`` cores of rank ``pid`` (the same number at every world
    size: per-host resources constant as hosts grow); with more hosts
    than cores the pins wrap and hosts share cores, and the cpu-seconds
    efficiency is then the meaningful number."""
    cores = sorted(os.sched_getaffinity(0))
    return {cores[(pid * per + i) % len(cores)] for i in range(per)}


def phase_worker(args) -> None:
    """One rank of the phase step across processes: a mesh of one slot a
    process, warmed once, then the best of 5; rank 0 prints RESULT."""
    import torch

    from falcon_unzip_tpu_torch.parallel import distributed as dist
    from falcon_unzip_tpu_torch.parallel.mesh import make_mesh
    torch.set_num_threads(args.per)
    dist.initialize()
    pid, nproc = dist.process_index(), dist.process_count()
    mesh = make_mesh(nproc, window_par=1, device=args.device)
    R = r_per_dev() * nproc
    step, tagpos, tagbase = run_phase_step(mesh, R)

    def call():
        out = step(tagpos, tagbase)
        out[0].cpu()                # counts to the host: the barrier
        _sync(torch, mesh.first)
        return out

    out = call()                    # warm
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        call()
        best = min(best, time.perf_counter() - t0)
    if pid == 0:
        print("RESULT " + json.dumps({
            "n": nproc, "reads_per_sec": R / best,
            "digest": phase_digest(out), "cores": thread_cores()}),
            flush=True)


def pipeline_worker(args) -> None:
    """One rank of the full-pipeline run: run_unzip + run_quiver on
    ``args.device``, with multihost over more than one process; prints
    HOSTSTAT with its wall, peak RSS, host CPU seconds, process life,
    cores, launches and its stage seconds (the ``s`` / ``*_s`` fields of
    its ``metrics.jsonl``)."""
    import torch

    from falcon_unzip_tpu_torch.config import PipelineConfig
    from falcon_unzip_tpu_torch.pipeline.quiver import run_quiver
    from falcon_unzip_tpu_torch.pipeline.unzip import run_unzip
    from falcon_unzip_tpu_torch.scripts.e2e_bench import (_stage_metrics,
                                                          timed_stage)
    torch.set_num_threads(args.per)
    pid, nproc = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    d = args.scratch
    cfg = PipelineConfig(preads=f"{d}/preads.fa", reads=f"{d}/raw.fa",
                         draft=f"{d}/draft.fa", out_dir=f"{d}/out_n{nproc}",
                         resume=False)
    cfg.mesh.multihost = nproc > 1
    cuda = args.device == "cuda"
    _, wall, launches, ms, _ = timed_stage(
        lambda: (run_unzip(cfg, args.device), run_quiver(cfg, args.device)),
        cuda)
    ru = resource.getrusage(resource.RUSAGE_SELF)
    root = cfg.out_dir if pid == 0 else os.path.join(cfg.out_dir,
                                                     f".host{pid}")
    stages = {k: {f: v for f, v in row.items()
                  if f == "s" or f.endswith("_s")}
              for k, row in _stage_metrics(root).items()}
    print("HOSTSTAT " + json.dumps({
        "pid": pid, "n": nproc, "wall_s": round(wall, 2),
        "maxrss_mb": round(ru.ru_maxrss / 1024, 1),
        "cpu_s": round(ru.ru_utime + ru.ru_stime, 2), "life_s": life_s(),
        "cores": thread_cores(), "launches": launches, "device_ms": ms,
        "stages": {k: v for k, v in stages.items() if v}}), flush=True)


WORKERS = {"phase": phase_worker, "pipeline": pipeline_worker}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def card_count(device: str) -> int:
    import torch
    return torch.cuda.device_count() if device == "cuda" else 0


def worker_env(pid: int, nproc: int, port: int, cards: int) -> dict:
    """A rank's environment: its place in the world and, with cards, the
    one card it sees (``pid % cards`` of the cards visible here)."""
    env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port),
               WORLD_SIZE=str(nproc), RANK=str(pid), LOCAL_RANK=str(pid),
               LOCAL_WORLD_SIZE=str(nproc))
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p])
    if cards:
        visible = os.environ.get("CUDA_VISIBLE_DEVICES")
        ids = visible.split(",") if visible else [str(i)
                                                  for i in range(cards)]
        env["CUDA_VISIBLE_DEVICES"] = ids[pid % cards]
    return env


def ranks_per_card(nproc: int, cards: int):
    return -(-nproc // cards) if cards else None


def _launch(kind: str, nproc: int, per: int, device: str, extra=(),
            cards: int | None = None) -> list:
    """Start ``nproc`` ranks of a worker; [(Popen, log file)]."""
    port = _free_port()
    cards = card_count(device) if cards is None else cards
    procs = []
    for pid in range(nproc):
        log = tempfile.TemporaryFile(mode="w+")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", MODULE, "--worker", kind, "--per",
             str(per), "--device", device, *extra],
            cwd=REPO, env=worker_env(pid, nproc, port, cards), stdout=log,
            stderr=subprocess.STDOUT, text=True), log))
    return procs


def _collect(procs, timeout: float, what: str) -> list:
    """Every rank's output once all have exited 0; a rank that exits
    otherwise (or the timeout) raises with its output's tail, and every
    rank still running is killed."""
    deadline = time.monotonic() + timeout

    def text(i):
        log = procs[i][1]
        log.seek(0)
        return log.read()

    try:
        while True:
            codes = [p.poll() for p, _ in procs]
            bad = [i for i, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                raise RuntimeError(f"{what} worker {bad[0]} exited "
                                   f"{codes[bad[0]]}:\n{text(bad[0])[-3000:]}")
            if all(c == 0 for c in codes):
                return [text(i) for i in range(len(procs))]
            if time.monotonic() > deadline:
                raise RuntimeError(f"{what} workers timed out after "
                                   f"{timeout} s:\n{text(0)[-3000:]}")
            time.sleep(0.2)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()


def _lines(out: str, tag: str) -> list:
    return [json.loads(ln[len(tag) + 1:]) for ln in out.splitlines()
            if ln.startswith(tag + " ")]


def measure_pipeline(nproc: int, cores_per_host: int, genome_per_host: int,
                     coverage: float, *, device: str, scratch: str) -> dict:
    """Weak-scaling full-pipeline run: genome grows with host count, so
    per-host work is constant; efficiency = wall_1 / wall_N.  Also
    returns per-host peak RSS, host-CPU seconds and kernel launches."""
    from falcon_unzip_tpu_torch.io.fasta import write_fasta
    from falcon_unzip_tpu_torch.seq import decode
    from falcon_unzip_tpu_torch.utils.simulate import (make_diploid,
                                                       simulate_reads)

    d = os.path.join(scratch, f"scaling_pipe_{nproc}")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    per_ctg = PER_CTG
    n_ctg = max(2, (genome_per_host * nproc) // per_ctg)
    pread_rows, raw_rows, drafts = [], [], []
    for ci in range(n_ctg):
        dip = make_diploid(length=per_ctg, het_rate=0.012, seed=500 + ci,
                           het_span=(0.2, 0.8))
        pr = simulate_reads(dip, coverage=coverage, read_len=2200,
                            error_rate=0.0, seed=600 + ci)
        rw = simulate_reads(dip, coverage=coverage + 2, read_len=1800,
                            error_rate=0.03, seed=700 + ci)
        pread_rows += [(f"c{ci}/{pr.batch.names[i]}", pr.batch.to_str(i))
                       for i in range(len(pr.batch))]
        raw_rows += [(f"c{ci}/{rw.batch.names[i]}", rw.batch.to_str(i))
                     for i in range(len(rw.batch))]
        drafts.append((f"draft{ci}", decode(dip.hap0)))
    write_fasta(f"{d}/preads.fa", pread_rows)
    write_fasta(f"{d}/raw.fa", raw_rows)
    write_fasta(f"{d}/draft.fa", drafts)

    outs = _collect(_launch("pipeline", nproc, cores_per_host, device,
                            ("--scratch", d)), 3600, "pipeline")
    hosts = [h for out in outs for h in _lines(out, "HOSTSTAT")]
    return {"n": nproc, "n_reads": len(pread_rows) + len(raw_rows),
            "genome_bp": per_ctg * n_ctg, "hosts": hosts,
            "wall_s": max(h["wall_s"] for h in hosts)}


def measure_multiprocess(nproc: int, cores_per_host: int, *, device: str,
                         cards: int | None = None) -> dict:
    """The phase step over ``nproc`` ranks: rank 0's {"reads_per_sec",
    "digest", "cores"} (the cores its threads may run on).  ``cards``:
    spread the ranks over this many cards (default all visible)."""
    out0 = _collect(_launch("phase", nproc, cores_per_host, device,
                            cards=cards), 600, "phase step")[0]
    res = _lines(out0, "RESULT")
    if not res:
        raise RuntimeError(f"no RESULT line:\n{out0[-1000:]}")
    return {"reads_per_sec": float(res[-1]["reads_per_sec"]),
            "digest": res[-1]["digest"], "cores": res[-1]["cores"]}


def measure_virtual(n_devices: int, R_per_dev: int = 512, reps: int = 3,
                    *, device: str) -> float:
    """The phase step over an in-process mesh of ``n_devices`` slots (the
    cards on cuda, logical shards of the CPU device on the CPU)."""
    import torch

    from falcon_unzip_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(n_devices, window_par=1, device=device)
    R = R_per_dev * n_devices
    step, tagpos, tagbase = run_phase_step(mesh, R)

    def call():
        step(tagpos, tagbase)
        for dev in set(mesh.local):
            _sync(torch, dev)

    call()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        call()
        best = min(best, time.perf_counter() - t0)
    return R / best     # reads/s (weak scaling: R grows with devices)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scratch", default=None)
    ap.add_argument("--worker", choices=sorted(WORKERS))
    ap.add_argument("--per", type=int, default=1)
    args = ap.parse_args(argv)
    if args.worker:
        # pin before numpy or torch is imported: the threads they start
        # (numpy's BLAS pool starts at import) inherit the pin, threads
        # started before it would not; torch sizes its pool from the
        # machine, so each worker sets it to ``per``
        os.sched_setaffinity(0, pinned_cores(int(os.environ["RANK"]),
                                             args.per))
        WORKERS[args.worker](args)
        return

    from falcon_unzip_tpu_torch.bench import card_label
    from falcon_unzip_tpu_torch.device import resolve
    from falcon_unzip_tpu_torch.ops import _kernels

    dev = resolve(args.device).type
    cards = card_count(dev)
    if dev == "cuda":
        _kernels._load()    # build once, before any rank starts
    scratch = args.scratch or os.path.join(tempfile.gettempdir(),
                                           "scaling_bench_torch")
    cores = len(os.sched_getaffinity(0))
    # N=4 runs even on a 2-core box (pins wrap): its WALL efficiency is
    # bounded by cores/N there, so the JSON also carries per-host
    # cpu-seconds — flat cpu_s per host across N is the evidence that
    # the distributed design adds no per-host work
    plan = [1, 2, 4]
    per = 1                              # constant cores per "host"

    # ---- full-pipeline weak scaling (the north-star pipeline number)
    genome_per_host = int(os.environ.get("SCALING_PIPE_BP", "80000"))
    pipe = {}
    for n in plan:
        pipe[n] = measure_pipeline(n, per, genome_per_host, coverage=10.0,
                                   device=dev, scratch=scratch)
    pipe_out = {
        "per_hosts": {str(n): v for n, v in pipe.items()},
        "note": ("weak scaling: full unzip+polish pipelines, genome grows "
                 "with hosts, contig-owner dataflow, 1 pinned core + 1 "
                 "device per host" + ("; ranks share a card where "
                                      "ranks_per_card > 1"
                                      if cards else "")),
    }
    if 1 in pipe:
        pipe_out["scaling_efficiency"] = {
            str(n): round(pipe[1]["wall_s"] / v["wall_s"], 3)
            for n, v in pipe.items()}
        # oversubscription-independent: per-host CPU seconds vs 1 host
        # (weak scaling -> flat per-host work = 1.0)
        c1 = pipe[1]["hosts"][0]["cpu_s"]
        pipe_out["cpu_s_efficiency"] = {
            str(n): round(c1 / (sum(h["cpu_s"] for h in v["hosts"])
                                / len(v["hosts"])), 3)
            for n, v in pipe.items()}
        pipe_out["wall_bound_by_cores"] = {
            str(n): min(1.0, cores / n) for n in pipe}
        pipe_out["host_cpu_s"] = {
            str(n): [h["cpu_s"] for h in sorted(v["hosts"],
                                                key=lambda h: h["pid"])]
            for n, v in pipe.items()}
        pipe_out["host_maxrss_mb"] = {
            str(n): [h["maxrss_mb"] for h in sorted(v["hosts"],
                                                    key=lambda h: h["pid"])]
            for n, v in pipe.items()}

    mp_results = {}
    for n in plan:
        mp_results[n] = measure_multiprocess(n, per, device=dev)
    out = {
        "metric": "phase_step_reads_per_sec",
        "device": card_label() if dev == "cuda" else "cpu",
        "ranks_per_card": {str(n): ranks_per_card(n, cards) for n in plan},
        "pipeline": pipe_out,
        "multiprocess": {
            "per_hosts": {str(n): round(v["reads_per_sec"], 1)
                          for n, v in mp_results.items()},
            "digest": {str(n): v["digest"] for n, v in mp_results.items()},
            "cores_per_host": per,
            "note": ("N OS processes, disjoint equal core pins, a "
                     "torch.distributed gloo world, one mesh slot a "
                     "process: the multi-host phase step on "
                     + ("one card a rank (ranks share a card where "
                        "ranks_per_card > 1)" if cards else "the CPU")),
        },
    }
    base = mp_results.get(1)
    if base:
        out["multiprocess"]["scaling_efficiency"] = {
            str(n): round(v["reads_per_sec"] / (base["reads_per_sec"] * n), 3)
            for n, v in mp_results.items()}

    avail = cards if dev == "cuda" else 8
    v_results = {}
    for n in (1, 2, 4, 8):
        if n > avail:
            break
        v_results[n] = measure_virtual(n, device=dev)
    vbase = v_results.get(1)
    out["virtual_mesh"] = {
        "per_devices": {str(n): round(v, 1) for n, v in v_results.items()},
        "caveat": ("a mesh of the cards in one process, a slot a card, "
                   "every shard launched from one host thread"
                   if dev == "cuda" else
                   "logical shards of the one CPU device in one process "
                   "share its cores: efficiency reflects host "
                   "oversubscription, not the SPMD design"),
    }
    if vbase:
        out["virtual_mesh"]["scaling_efficiency"] = {
            str(n): round(v / (vbase * n), 3) for n, v in v_results.items()}
    print(json.dumps(out))


if __name__ == "__main__":
    main()

"""Run one cell of the benchmark of the PyTorch and CUDA port once.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout on a machine with the cards the cell asks
for.  Everything is found by name: the cell in ``BENCHMARK.json``, its
configuration in the file the manifest names, its traffic mix in
``benchmark/traffic/<traffic>.json``, the slot driver that mix names in
``benchmark/drivers/<driver>.py`` and each per-layer metric's reader in
``benchmark/metrics/<metric>.py``.

The run: build the port's kernels (into the port's own fixed build
directory: only a checkout's first run compiles), start the mix's job
slots, one worker process each on the card, pinned to its own share of
the host's cores (``slots.py``); let the driver make the shared inputs
meanwhile; wait until every slot has set up and warmed up; open the
window.  Each slot starts jobs until the window ends and finishes the
last one.  Set-up time is process start to window open.  The rate is all
the work of the jobs started in the window over the slot-seconds from the
window's start to each slot's last job end, times the slot count.  After
the slots have exited, the driver's ``check`` compares what the first jobs
produced with the plain reference (``reference.py``).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device`` and, traced,
``breakdown``; last in it ``checks``, each compared number beside its
limit, which also end standard error.  Without the cards the cell asks for,
or with JAX or the JAX package loaded, it prints no result and exits
non-zero.
"""
from __future__ import annotations

import time

_STARTS = [time.time()]      # process start: the first run's set-up begins

import argparse  # noqa: E402
import json  # noqa: E402
import multiprocessing  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

from benchmark import readers, slots, spans, trace  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
SETUP_LIMIT_S = 240          # a slot's set-up, after which the run gives up
DRAIN_LIMIT_S = 200          # the window and the last jobs
THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")
MAIN = "MainThread"          # the thread a slot runs its jobs on


class RunError(RuntimeError):
    """The run cannot give a result."""


def load_json(path: str):
    with open(path) as fh:
        return json.load(fh)


def by_name(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise RunError(f"no {what} named {name!r} in BENCHMARK.json")


def cell_spec(workload: str, root: str = ROOT, overrides=None) -> dict:
    """The cell's manifest entries and files, found by name.  overrides:
    {"config": {...}, "traffic": {...}} merged over the files (tests)."""
    bench = os.path.join(root, "benchmark")
    man = load_json(os.path.join(root, "BENCHMARK.json"))
    cell = by_name(man["workloads"], workload, "workload")
    conf = by_name(man["configs"], cell["config"], "config")
    config = load_json(os.path.join(root, conf["file"]))
    traffic = load_json(os.path.join(bench, "traffic",
                                     f"{cell['traffic']}.json"))
    for key, part in (overrides or {}).items():
        {"config": config, "traffic": traffic}[key].update(part)

    def mine(m):
        return workload in m.get("workloads", [workload])
    e2e = [m for m in man["end_to_end"] if mine(m)]
    names = {m["name"] for m in e2e}
    layer = [m for m in man["per_layer"]
             if mine(m) and m["moves"] in names]
    return {"root": root, "bench": bench, "cell": cell, "config": config,
            "traffic": traffic, "end_to_end": e2e, "per_layer": layer,
            "driver_file": os.path.join(bench, "drivers",
                                        f"{traffic['driver']}.py")}


def _recv(conn, want: str, deadline: float):
    if not conn.poll(max(0.0, deadline - time.time())):
        raise RunError(f"a slot sent no {want!r} in time")
    kind, body = conn.recv()
    if kind != want:
        raise RunError(f"a slot failed:\n{body}")
    return body


def start_slots(spec: dict, seed: int, run_dir: str, device: str,
                control: bool, traced: bool) -> tuple:
    """Start the mix's slots; returns (processes, pipes, shared counter)."""
    n = spec["traffic"]["slots"]
    cores = sorted(os.sched_getaffinity(0))
    per = len(cores) // n
    mp = multiprocessing.get_context("spawn")
    counter = mp.Value("q", 0)
    procs, conns = [], []
    saved = {v: os.environ.get(v) for v in THREAD_VARS}
    try:
        for s in range(n):
            mine = cores[s * per : (s + 1) * per] if per else []
            for v in THREAD_VARS:
                os.environ[v] = str(len(mine) or len(cores))
            sdir = os.path.join(run_dir, f"slot{s}")
            os.makedirs(sdir)
            sspec = {"slot": s, "n_slots": n, "cores": mine,
                     "device": device, "driver_file": spec["driver_file"],
                     "dir": sdir, "seed": seed, "config": spec["config"],
                     "traffic": spec["traffic"], "control": control,
                     "traced": traced}
            parent, child = mp.Pipe()
            p = mp.Process(target=slots.worker, args=(child, counter, sspec))
            p.start()
            child.close()
            procs.append(p)
            conns.append(parent)
    finally:
        for v, val in saved.items():
            if val is None:
                os.environ.pop(v, None)
            else:
                os.environ[v] = val
    return procs, conns, counter


def stop(procs: list) -> None:
    """Wait for every slot to end; end those that do not."""
    for p in procs:
        p.join(timeout=30)
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join(timeout=10)
        if p.is_alive():
            p.kill()
            p.join()


def host_spans(res: dict) -> list:
    """A slot's host intervals, (name, start, end, thread): its jobs, on
    the main thread, and the port's span rows in the slot's trace
    (``fu_spans.*``; a traced run's only)."""
    return [("job", r["start"], r["end"], MAIN) for r in res["records"]] + [
        (r["stage"], r["t0"], r["ts"], r["thread"])
        for r in spans.trace_rows(res)]


def _label(hosts: list, t: float) -> str:
    """What the slots' hosts were doing at time t: the innermost interval
    holding t on each thread of each slot (``host_spans``), else "no job"."""
    names = set()
    for intervals in hosts:
        inner: dict = {}
        for name, a, b, thread in intervals:
            if a <= t <= b and (thread not in inner
                                or b - a < inner[thread][0]):
                inner[thread] = (b - a, name)
        names.update(n for _, n in inner.values())
        if not inner:
            names.add("no job")
    return "+".join(sorted(names))


def run_cell(spec: dict, seed: int, seconds: float, traced: bool,
             device: str, run_dir: str, control=False) -> dict:
    drv = slots.load_file(spec["driver_file"], "fu_bench_driver")
    procs, conns, _counter = start_slots(spec, seed, run_dir, device,
                                         control, traced)
    try:
        to_slots, keep = drv.prepare(spec, seed, run_dir)
        for c in conns:
            c.send(to_slots)
        deadline = time.time() + SETUP_LIMIT_S
        ready = [_recv(c, "ready", deadline) for c in conns]
        t0 = time.time() + 0.2
        t1 = t0 + seconds
        for c in conns:
            c.send(("go", t0, t1))
        deadline = t1 + DRAIN_LIMIT_S
        results = [_recv(c, "done", deadline) for c in conns]
    finally:
        stop(procs)
    return {"t0": t0, "t1": t1, "ready": ready, "results": results,
            "keep": keep, "driver": drv}


def card_limit() -> str | None:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def summarize(spec: dict, run: dict, traced: bool, device: str,
              start: float) -> dict:
    """The result line's content (checks last)."""
    results, t0 = run["results"], run["t0"]
    drv = run["driver"]
    recs = [r for res in results for r in res["records"]]
    t_last = max((r["end"] for r in recs), default=t0)
    ctx = {"spec": spec, "results": results, "t0": t0, "t_last": t_last,
           "device": device, "trace": None, "kernels": None}
    values = {"setup_s": t0 - start, drv.RATE: readers.rate(ctx)}
    e2e, checks = drv.check(spec, results, run["keep"])
    values.update(e2e)
    out_device = {"platform": "gpu" if device == "cuda" else "cpu",
                  "kind": results[0].get("kind", device),
                  "count": spec["cell"]["chips"],
                  "memory_peak_bytes": int(sum(r["memory_peak_bytes"]
                                               for r in results))}
    breakdown = None
    if traced:
        trs = [trace.read(res["trace"]["path"], res["trace"]["wall"])
               for res in results]
        offs = [tr["offset_s"] for tr in trs]
        merged = trace.merge(trs, t0, t_last)
        print(f"[trace] {len(trs)} traces, {sum(t['bytes'] for t in trs)} "
              f"bytes; trace-to-wall offsets spread "
              f"{1e6 * (max(offs) - min(offs)):.1f} us over the slots, marks' "
              f"round trips up to "
              f"{1e6 * max(t['round_trip_s'] for t in trs):.1f} us; busy "
              f"{merged['busy_s']:.6f} s of {merged['window_s']:.3f} s",
              file=sys.stderr, flush=True)
        ctx["trace"] = merged
        out_device["busy_s"] = merged["busy_s"]
        out_device["window_s"] = merged["window_s"]
        kern: dict = {}
        for res in results:
            for name, k in (res.get("kernels") or {}).items():
                acc = kern.setdefault(name, dict.fromkeys(k, 0))
                for f, v in k.items():
                    acc[f] += v
        ctx["kernels"] = kern or None
        ops = sorted(merged["by_name"].items(), key=lambda kv: -kv[1])[:10]
        hosts = [host_spans(res) for res in results]
        breakdown = {"device_ops": [[n[:160], s] for n, s in ops],
                     "idle_gaps": [[_label(hosts, (a + b) / 2), b - a]
                                   for a, b in merged["gaps"][:10]]}
        metrics = {}
        for m in spec["per_layer"]:
            reader = slots.load_file(
                os.path.join(spec["bench"], "metrics", f"{m['name']}.py"),
                "fu_bench_metric")
            v = reader.read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in spec["end_to_end"]}
    ok = all(v <= lim for v, lim in checks.values())
    failed = sum(r["failed"] for r in recs)
    correct = ok and failed == 0 and all(res["records"] for res in results)
    out = {"correct": bool(correct), "attempted": len(recs),
           "failed": failed, "metrics": metrics, "device": out_device}
    if breakdown:
        out["breakdown"] = breakdown
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    return out


def main(argv=None, *, device: str = "cuda", overrides=None,
         control: bool = False, root: str = ROOT) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    start = _STARTS.pop() if _STARTS else time.time()
    try:
        spec = cell_spec(args.workload, root, overrides)
        chips = spec["cell"]["chips"]
        if device == "cuda":
            import torch
            if not torch.cuda.is_available() or \
                    torch.cuda.device_count() < chips:
                raise RunError(f"the cell needs {chips} CUDA device(s); "
                               "this machine has none or fewer")
            from falcon_unzip_tpu_torch.ops import _kernels
            _kernels.build()
            print(f"[card] {card_limit()}", file=sys.stderr, flush=True)
        run_dir = tempfile.mkdtemp(prefix="fu_bench_")
        try:
            run = run_cell(spec, args.seed, args.seconds, bool(args.trace),
                           device, run_dir, control)
            out = summarize(spec, run, bool(args.trace), device, start)
        finally:
            shutil.rmtree(run_dir, ignore_errors=True)
    except RunError as e:
        print(f"[run] no result: {e}", file=sys.stderr, flush=True)
        return 2
    bad = sorted(set(slots.forbidden_modules()).union(
        *(res["forbidden"] for res in run["results"])))
    if bad:
        print(f"[run] no result: loaded {bad}, which the benchmark may not "
              "load", file=sys.stderr, flush=True)
        return 4
    for res, rdy in zip(run["results"], run["ready"]):
        secs = sorted(r["end"] - r["start"] for r in res["records"])
        print(f"[slot {res['slot']}] cores {res['cores']} set-up "
              f"{rdy['setup_s']:.2f} s, jobs {len(secs)}: "
              + (", ".join(f"{x:.2f}" for x in secs) if len(secs) <= 12 else
                 f"{secs[0]:.4f} / {secs[len(secs) // 2]:.4f} / "
                 f"{secs[-1]:.4f} (least / median / most)") + " s",
              file=sys.stderr, flush=True)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']} "
              f"{'ok' if c['value'] <= c['limit'] else 'FAILED'}",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

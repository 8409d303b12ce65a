"""The slots' CPU use over their jobs: each process's CPU seconds over
run_unzip and run_quiver over their seconds times the slot's cores, %."""
from benchmark.spans import host_cpu_pct


def read(ctx):
    return host_cpu_pct(ctx, [("unzip", "run_unzip"),
                              ("quiver", "run_quiver")])

"""The slots' CPU use over their requests: each process's CPU seconds
over its falconsense spans over their seconds times the slot's cores, %."""
from benchmark.spans import TRACE, host_cpu_pct


def read(ctx):
    return host_cpu_pct(ctx, [(TRACE, "falconsense")])

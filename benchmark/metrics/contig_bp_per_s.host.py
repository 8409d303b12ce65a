"""Draft bases assembled a second, every slot's jobs together, in the
traced run: the cell's rate on the host's clock, too noisy from run to
run on a shared host to bound end to end."""
from benchmark.readers import rate


def read(ctx):
    return rate(ctx)

"""The share of 3-unzip's overlap compute that 1-align and 2-phasing hid:
100 x (1 - the hasm join's wait over the overlap compute), hasm.join_wait
and overlap.compute spans, %."""
from benchmark.spans import ratio_pct


def read(ctx):
    waited = ratio_pct(ctx, "unzip", "hasm.join_wait", "overlap.compute")
    return None if waited is None else 100.0 - waited

"""Seconds a Mb of seed reads in FalconSense's banded DP: packing and
launching the chunks, waiting for them and the host's anchor trim, identity
filter and tags (cns.dp spans)."""
from benchmark.spans import trace_s_per_mb


def read(ctx):
    return trace_s_per_mb(ctx, "cns.dp", "falconsense")

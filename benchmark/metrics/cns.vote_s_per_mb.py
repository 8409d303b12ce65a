"""Seconds a Mb of seed reads in FalconSense's vote and consensus call
(cns.vote spans)."""
from benchmark.spans import trace_s_per_mb


def read(ctx):
    return trace_s_per_mb(ctx, "cns.vote", "falconsense")

"""The banded wavefront's share of its roofline, %: the least time its
launches need by their pairs' own antidiagonals (int32 operations over a
derived 16.7 TOP/s, or bytes over 3.35 TB/s) over their device time."""
from benchmark.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "banded_wavefront")

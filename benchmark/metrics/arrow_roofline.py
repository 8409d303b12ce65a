"""The Arrow sweep kernel's share of its roofline, %: the least time its
launches need by their pairs' swept cells (float32 operations over 67
TFLOP/s, or bytes over 3.35 TB/s) over their device time."""
from benchmark.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "arrow_splice")

"""The share of FalconSense's DP spent blocked on the device's results
(cns.dp.wait over cns.dp spans), %."""
from benchmark.spans import TRACE, ratio_pct


def read(ctx):
    return ratio_pct(ctx, TRACE, "cns.dp.wait", "cns.dp")

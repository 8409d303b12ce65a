"""Seconds a Mb of draft in 4-polish's Arrow scoring: packing, the sweep
launches and their fetch (polish.arrow spans; the rest of polish_windows is
the host's window work)."""
from benchmark.readers import stage_s_per_mb


def read(ctx):
    return stage_s_per_mb(ctx, "quiver", "polish.arrow")

"""The ranks' seconds in the port's collectives (outermost ``dist.*``
spans) over their ``run_unzip`` and ``run_quiver`` seconds, %: the share
of a rank's job spent moving records or waiting on other ranks."""
from benchmark.collectives import totals


def read(ctx):
    t = totals(ctx)
    return 100.0 * t["s"] / t["root_s"] if t and t["root_s"] > 0 else None

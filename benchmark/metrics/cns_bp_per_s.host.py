"""Seed-read bases corrected a second, every slot's requests together, in
the traced run: the traced twin of the end-to-end ``cns_bp_per_s``, read
the same way (``readers.rate``) from the untraced run.  Its ratio to the
untraced rate is what tracing costs."""
from benchmark.readers import rate


def read(ctx):
    return rate(ctx)

"""Read regrouping by owner (the reference's ``parallel/collectives.py``,
one-device part).

The port keeps ``regroup_partition``'s one-device branch: a host
group-by of row indices by group (contig) id, the rows of each group in
input order, as the reference computes when it has no mesh.  The
all_to_all regroup across devices (``make_regroup``), the reference's
``mesh`` argument and the window halo exchange wait for the port of
``parallel/``.
"""
from __future__ import annotations

import numpy as np


def regroup_partition(ctg_ids: np.ndarray, n_groups: int) -> list[np.ndarray]:
    """Partition row indices by group (contig) id on one device: a list
    of n_groups int64 index arrays, each in input order (rows with an id
    outside [0, n_groups) are dropped)."""
    ctg_ids = np.asarray(ctg_ids, np.int64)
    return [np.nonzero(ctg_ids == g)[0] for g in range(n_groups)]

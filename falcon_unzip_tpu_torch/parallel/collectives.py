"""Collective building blocks over a ``parallel.mesh.Mesh``.

Port of ``falcon_unzip_tpu.parallel.collectives`` without shard_map.
Inside one process a collective is a set of explicit tensor moves
between the shards' devices; a mesh that spans processes finishes its
``psum`` / ``all_gather`` with a gloo collective on the host
(``parallel.distributed``):

- psum: every shard's integer partial, summed on the mesh's first
  device (integer adds are order-free, so the sum is bit-exact);
- all_gather: the shards concatenated in mesh order;
- all_to_all (``make_regroup``): per-(src, dst) slices of the rows each
  shard routes to each owner, with the reference's cap / counts /
  dropped semantics — the reference's ``max_n_open_files`` BAM partition
  re-mapped as a regroup of reads to their contig-owner device;
- ppermute halo (``make_halo_exchange``): each window shard's edge rows
  copied to its ring neighbours over the 'window' axis.

``regroup_partition`` regroups over a mesh only when its caller passes
one; without one it is the host group-by.
"""
from __future__ import annotations

import numpy as np
import torch

from . import distributed as dist
from .mesh import Mesh, shard_rows


def psum(mesh: Mesh, parts) -> torch.Tensor:
    """Sum of every shard's partial (each on its slot's device), on the
    mesh's first device; over every process when the mesh spans them."""
    out = parts[0].to(mesh.first, copy=True)
    for p in parts[1:]:
        out += p.to(mesh.first)
    if mesh.spans_processes:
        out = dist.all_reduce_sum(out)
    return out


def all_gather(mesh: Mesh, parts) -> torch.Tensor:
    """The shards' blocks concatenated in mesh order on the first device."""
    out = torch.cat([p.to(mesh.first) for p in parts])
    if mesh.spans_processes:
        out = dist.all_gather_rows(out)
    return out


def _local(mesh: Mesh, what: str) -> None:
    if mesh.spans_processes:
        raise ValueError(f"{what} runs on a process-local mesh")


def _route(payload: torch.Tensor, owner: torch.Tensor, n_dev: int,
           cap: int):
    """One shard's send buffer: rows bucketed by destination in row
    order, the first ``cap`` of each kept.  Returns send (n_dev, cap,
    feat) -1 padded, counts (n_dev,), dropped (1,)."""
    dev = payload.device
    live = owner >= 0
    d = owner.clamp(min=0).long()
    onehot = (d[:, None] == torch.arange(n_dev, device=dev)[None, :]) \
        & live[:, None]
    slot = (onehot.to(torch.int32).cumsum(0) - 1).gather(1, d[:, None])[:, 0]
    ok = live & (slot < cap)
    send = torch.full((n_dev, cap, payload.shape[1]), -1, dtype=torch.int32,
                      device=dev)
    send[d[ok], slot[ok].long()] = payload[ok].to(torch.int32)
    total = onehot.to(torch.int32).sum(0)
    counts = total.clamp(max=cap)
    dropped = (total - counts).sum().reshape(1)
    return send, counts.to(torch.int32), dropped.to(torch.int32)


def make_regroup(mesh: Mesh, *, cap: int, feat: int):
    """Regroup rows to owner devices over the flattened mesh axis.

    Input: payload (R, feat) int32, owner (R,) int32, rows split over
      every shard (R a multiple of the shard count; owner in [0, n_dev),
      rows with owner -1 are dropped).
    Output, the shards concatenated in mesh order on the first device:
      recv (n_dev * n_dev, cap, feat) int32 — shard dst's block holds,
      for each source shard, the rows it now owns, -1 padded;
      counts (n_dev * n_dev,) and dropped (n_dev,).
    cap bounds rows sent PER (src, dst) pair; overflow is counted in
    ``dropped`` so callers can re-run with a larger cap.
    """
    _local(mesh, "make_regroup")
    n_dev = mesh.size

    def regroup(payload, owner):
        if payload.shape[1] != feat:
            raise ValueError(f"payload rows of {payload.shape[1]}, not "
                             f"feat={feat}")
        pay = shard_rows(mesh, payload).parts
        own = shard_rows(mesh, owner).parts
        sends = [_route(p, o, n_dev, cap) for p, o in zip(pay, own)]
        recv, counts = [], []
        for dst in range(n_dev):            # the all_to_all
            to = mesh.device_of(dst)
            recv.append(torch.stack([s[0][dst].to(to) for s in sends]))
            counts.append(torch.stack([s[1][dst].to(to) for s in sends]))
        return (all_gather(mesh, recv), all_gather(mesh, counts),
                all_gather(mesh, [s[2] for s in sends]))

    return regroup


def regroup_partition(ctg_ids: np.ndarray, n_groups: int,
                      mesh: Mesh | None = None) -> list[np.ndarray]:
    """Partition row indices by group (contig) id through the mesh
    all_to_all regroup — the production entry of make_regroup.

    Each read's record is routed to its contig-owner device (owner = ctg
    % n_dev); the returned per-group row lists are read back from the
    owner shards and restored to input order, so consumers emit
    byte-identical partitions to a host scan.

    Returns a list of n_groups int64 index arrays.  Without a mesh,
    the host groupby.
    """
    ctg_ids = np.asarray(ctg_ids, np.int64)
    n = len(ctg_ids)
    if mesh is None or n == 0:
        return [np.nonzero(ctg_ids == g)[0] for g in range(n_groups)]

    n_dev = mesh.size
    rows_per_shard = -(-n // n_dev)
    pad = n_dev * rows_per_shard - n
    payload = np.stack([np.arange(n, dtype=np.int64),
                        ctg_ids], axis=1).astype(np.int32)
    owner = np.where(ctg_ids >= 0, ctg_ids % n_dev, -1).astype(np.int32)
    if pad:
        payload = np.concatenate(
            [payload, np.full((pad, 2), -1, np.int32)])
        owner = np.concatenate([owner, np.full(pad, -1, np.int32)])

    cap = max(8, 2 * rows_per_shard)
    while True:
        recv, counts, dropped = make_regroup(mesh, cap=cap, feat=2)(
            payload, owner)
        if int(dropped.sum()) == 0:
            break
        cap *= 2          # capacity overflow: retry with a larger cap
    recv = recv.cpu().numpy().reshape(n_dev, n_dev, cap, 2)
    counts = counts.cpu().numpy().reshape(n_dev, n_dev)
    groups: list[list[np.ndarray]] = [[] for _ in range(n_groups)]
    for dst in range(n_dev):
        for src in range(n_dev):
            rows = recv[dst, src, : counts[dst, src]]
            for g in range(dst, n_groups, n_dev):
                sel = rows[:, 1] == g
                if sel.any():
                    groups[g].append(rows[sel, 0].astype(np.int64))
    return [np.sort(np.concatenate(g)) if g else
            np.zeros(0, np.int64) for g in groups]


def halo_exchange(mesh: Mesh, blocks, halo: int):
    """Ring halo exchange of per-window-shard blocks (``blocks[w]``, on
    any device): returns (left, right) lists, ``left[w]`` the last
    ``halo`` rows of block w - 1 and ``right[w]`` the first ``halo`` rows
    of block w + 1 (ring indices, as the reference's ppermute wraps),
    each on block w's device."""
    nw = mesh.shape["window"]
    left = [blocks[(w - 1) % nw][-halo:].to(blocks[w].device)
            for w in range(nw)]
    right = [blocks[(w + 1) % nw][:halo].to(blocks[w].device)
             for w in range(nw)]
    return left, right


def make_halo_exchange(mesh: Mesh, *, halo: int):
    """Ring halo exchange over the 'window' axis.

    x: (L, F) rows split over 'window' (L a multiple of n_window) —
    returns the (n_window * halo, F) left ghosts and right ghosts of the
    window shards, concatenated in window order on the first device.
    """
    _local(mesh, "make_halo_exchange")

    def exchange(x):
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(x))
        nw = mesh.shape["window"]
        seg = t.shape[0] // nw
        home = [mesh.device_of(w) for w in range(nw)]   # data row 0
        blocks = [t[w * seg:(w + 1) * seg].to(home[w]) for w in range(nw)]
        left, right = halo_exchange(mesh, blocks, halo)
        return (torch.cat([v.to(mesh.first) for v in left]),
                torch.cat([v.to(mesh.first) for v in right]))

    return exchange

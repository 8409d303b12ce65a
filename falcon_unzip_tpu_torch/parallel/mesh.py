"""Device mesh construction for the unzip dataflow.

Port of ``falcon_unzip_tpu.parallel.mesh`` without ``jax.sharding``:

  axis 'data'   — read-batch data parallelism
  axis 'window' — contig-window sharding, the sequence-parallel analogue

A ``Mesh`` is an (n_data, n_window) grid of torch devices in row-major
("mesh") order.  The devices may repeat: on the CPU, torch has one
device, so an n-device mesh is n logical shards on it (the counterpart
of the JAX tests' ``--xla_force_host_platform_device_count=8``), and an
explicit list such as ``["cuda:0"] * 4`` puts 4 logical shards on one
card.  Over a world of processes (``parallel.distributed``) a mesh may
span them: the global slots are process-major, and each process holds
only its own contiguous block of slots (``Mesh.slots``).

``shard_rows`` and ``replicate`` are the counterparts of the reference's
``data_sharding`` and ``replicated``: a row split over both axes (or one
axis) onto the shards' devices, and a copy of an input on each.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import distributed as dist

ALL = ("data", "window")


class Mesh:
    """(n_data, n_window) grid of torch devices, axes ("data", "window").

    devices: this process's devices, one per slot it holds, in mesh
    order; the global mesh has ``n_processes * len(devices)`` slots, of
    which process p holds slots [p * len(devices), (p + 1) * len(devices)).
    """

    axis_names = ALL

    def __init__(self, devices, window_par: int, n_processes: int = 1,
                 process_index: int = 0):
        self.local = [torch.device(d) for d in devices]
        n = len(self.local) * n_processes
        if not self.local or n % window_par:
            raise ValueError(f"{n} devices do not split into rows of "
                             f"window_par={window_par}")
        self.n_processes = n_processes
        self.process_index = process_index
        self.shape = {"data": n // window_par, "window": window_par}
        self.size = n
        lo = process_index * len(self.local)
        self.slots = range(lo, lo + len(self.local))
        self.first = self.local[0]

    @property
    def spans_processes(self) -> bool:
        return self.n_processes > 1

    @property
    def devices(self) -> np.ndarray:
        """The (n_data, n_window) grid of this process-local mesh."""
        if self.spans_processes:
            raise ValueError("the mesh spans processes: only its local "
                             "devices (Mesh.local) are known here")
        arr = np.empty(len(self.local), dtype=object)
        arr[:] = self.local
        return arr.reshape(self.shape["data"], self.shape["window"])

    def coords(self, slot: int) -> tuple[int, int]:
        """(data, window) index of a global slot."""
        return divmod(slot, self.shape["window"])

    def device_of(self, slot: int) -> torch.device:
        return self.local[slot - self.slots.start]

    def n_parts(self, axes) -> int:
        return int(np.prod([self.shape[a] for a in _axes(axes)]))

    def part_of(self, slot: int, axes) -> int:
        """Which row block of a split over ``axes`` a slot holds."""
        d, w = self.coords(slot)
        axes = _axes(axes)
        if axes == ALL:
            return slot
        return d if axes == ("data",) else w

    def row_spec(self, axes, n_rows: int) -> tuple:
        """The spec a row split of n_rows over ``axes`` carries here:
        (axes, the device of each local shard, the rows of each)."""
        per = n_rows // self.n_parts(axes)
        return (_axes(axes), tuple(str(d) for d in self.local),
                (per,) * len(self.local))

    def __repr__(self) -> str:
        return (f"Mesh({dict(self.shape)}, local={self.local}, "
                f"process {self.process_index}/{self.n_processes})")


def _axes(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


@dataclasses.dataclass
class Shards:
    """A row split of one array: ``parts[k]`` is the block of local slot
    ``mesh.slots[k]``, on that slot's device."""

    axes: tuple
    parts: list

    @property
    def spec(self) -> tuple:
        return (self.axes, tuple(str(p.device) for p in self.parts),
                tuple(int(p.shape[0]) for p in self.parts))


def _tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(x))


def shard_rows(mesh: Mesh, x, axes=ALL) -> Shards:
    """Split the rows of ``x`` (numpy or tensor; rows a multiple of the
    number of blocks) over ``axes`` onto the local slots' devices."""
    axes = _axes(axes)
    k = mesh.n_parts(axes)
    t = _tensor(x)
    if t.shape[0] % k:
        raise ValueError(f"{t.shape[0]} rows do not split into {k} blocks")
    per = t.shape[0] // k
    parts = []
    for slot in mesh.slots:
        b = mesh.part_of(slot, axes)
        parts.append(t[b * per:(b + 1) * per].to(mesh.device_of(slot)))
    return Shards(axes, parts)


def replicate(mesh: Mesh, x) -> list:
    """``x`` on each local slot's device (one copy a distinct device)."""
    t = _tensor(x)
    on: dict = {}
    return [on.setdefault(d, t.to(d)) for d in mesh.local]


def make_mesh(n_devices: int | None = None, window_par: int | None = None,
              *, device, local_only: bool = False) -> Mesh:
    """Build a ('data', 'window') mesh of n devices.

    device: "cuda" (the first n visible cards; in a world of processes,
    each process's own cards), "cpu" (n logical shards on the one CPU
    device) or an explicit list of devices (repeats allowed).  In a
    world of more than one process the mesh spans the processes (n
    global slots, n / world on each) unless ``local_only``.
    window_par defaults to 2 when n is even and > 2 (so both axes are
    exercised), else 1.
    """
    world = 1 if local_only else dist.process_count()
    if isinstance(device, (list, tuple)):
        local = [torch.device(d) for d in device]
        n = len(local) * world
    else:
        dev = torch.device(device)
        if dev.type == "cuda":
            cards = dist.local_devices()
            n = n_devices or len(cards) * world
            local = cards[: n // world]
            if len(local) * world != n:
                raise ValueError(f"{n} devices asked, {len(cards)} cards "
                                 f"visible to each of {world} processes")
        else:
            n = n_devices or world
            local = [dev] * (n // world)
    if window_par is None:
        window_par = 2 if (n % 2 == 0 and n > 2) else 1
    if world > 1:
        return Mesh(local, window_par, world, dist.process_index())
    return Mesh(local, window_par)

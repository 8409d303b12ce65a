"""Multi-process initialization + host-role helpers on torch.distributed.

Port of ``falcon_unzip_tpu.parallel.distributed``.  Every process runs
the same program; ``initialize()`` joins them into one torch.distributed
world on the **gloo** backend, and every collective here moves host
bytes in CPU tensors:

- in the pipelines nothing on a device crosses processes: each process
  runs its per-contig device work on its own mesh (``local_only``), and
  only host records (alignments, overlaps, phased tables, polished
  contigs) travel;
- two ranks may share one card (one GPU, two processes), which NCCL
  refuses.

Host-side division of labor:
- every host aligns / overlaps its shard of the reads (``host_shard``),
- records are routed to their contig's owner host (``exchange_to_owners``,
  ``contig_owners``),
- host 0 gathers the final FASTA emission (``is_primary_host``).

Each collective helper that moves data or waits runs inside a
``dist.<helper>`` span (``utils.profiling.span``, recorded only while a
profiler records).  Helpers nest (``exchange_to_owners`` runs
``allgather_bytes`` once a destination, which runs ``all_gather_rows``
twice), so only the leaves (``all_gather_rows``, ``all_reduce_sum``,
``sync_stage_done``, ``barrier``) carry ``bytes_out`` (this host's
payload) and ``bytes_in`` (what it received, padding included);
``allgather_bytes`` adds the ``pad_bytes`` it chose.  In a one-process
world the helpers return before any span.

``contig_owners``, ``pack_arrays`` and ``unpack_arrays`` are verbatim
copies.  Launch with ``torchrun --nproc-per-node N`` (or set
MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK); rank r runs on card
``LOCAL_RANK % device_count``.
"""
from __future__ import annotations

import atexit
import datetime
import logging
import os
import socket

import numpy as np
import torch

from ..utils.profiling import span

logger = logging.getLogger(__name__)

# a rank that dies must not hang the others forever; long enough for the
# longest stage one host runs while the others wait at a collective
TIMEOUT_S = 3600


def _tdist():
    import torch.distributed as tdist
    return tdist


def initialize(timeout_s: float = TIMEOUT_S) -> None:
    """Join the gloo world from torchrun's env vars.

    MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK; with MASTER_ADDR
    unset, this builds a one-process world on a free local port.  On a
    machine with cards, the process's current card becomes
    ``local_device()``.  A backend that fails to come up raises.
    """
    tdist = _tdist()
    if tdist.is_initialized():
        return      # already initialized (drivers call this idempotently)
    if os.environ.get("MASTER_ADDR"):
        address = (f"{os.environ['MASTER_ADDR']}:"
                   f"{os.environ.get('MASTER_PORT', '29500')}")
        world, rank = _int_env("WORLD_SIZE") or 1, _int_env("RANK") or 0
    else:
        with socket.socket() as s:     # grab a free local port
            s.bind(("localhost", 0))
            address = f"localhost:{s.getsockname()[1]}"
        world, rank = 1, 0
    tdist.init_process_group(
        "gloo", init_method=f"tcp://{address}", world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    atexit.register(_shutdown)
    if torch.cuda.is_available():
        torch.cuda.set_device(local_device())
    logger.info("torch.distributed (gloo) up: process %d/%d",
                process_index(), process_count())


def _shutdown() -> None:
    """Tear the world down before the interpreter does: a gloo group
    left to interpreter exit can abort the process ("terminate called
    without an active exception") once a peer has gone."""
    tdist = _tdist()
    if tdist.is_initialized():
        tdist.destroy_process_group()


def _int_env(name: str) -> int | None:
    v = os.environ.get(name)
    return int(v) if v else None


def _up() -> bool:
    tdist = _tdist()
    return tdist.is_available() and tdist.is_initialized()


def process_count() -> int:
    return _tdist().get_world_size() if _up() else 1


def process_index() -> int:
    return _tdist().get_rank() if _up() else 0


def is_primary_host() -> bool:
    return process_index() == 0


def local_devices() -> list:
    """The cards this process owns: those whose index is its local rank
    modulo the ranks on its host, or, with fewer cards than ranks, card
    LOCAL_RANK % device_count (ranks share it)."""
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device visible")
    lr = _int_env("LOCAL_RANK") or 0
    lw = _int_env("LOCAL_WORLD_SIZE") or 1
    own = [torch.device("cuda", i) for i in range(n) if i % lw == lr % lw]
    return own or [torch.device("cuda", lr % n)]


def local_device() -> torch.device:
    return local_devices()[0]


def host_shard(n_items: int) -> tuple[int, int]:
    """[start, end) slice of n_items owned by this host (contiguous)."""
    p = process_index()
    np_ = process_count()
    per = -(-n_items // np_)
    return min(p * per, n_items), min((p + 1) * per, n_items)


def barrier(tag: str) -> None:
    """Block until every process reaches this point (driver boundaries:
    host k must not read host 0's canonical artifacts mid-write)."""
    if process_count() == 1:
        return
    logger.debug("barrier %s", tag)
    with span("dist.barrier", tag=tag, bytes_out=0, bytes_in=0):
        _tdist().barrier()


def sync_stage_done(done: bool) -> bool:
    """Make a Stage skip/run decision identical on every host.

    Host 0's checkpoint state is authoritative (it owns the canonical
    artifacts; other hosts write scratch) — if the decisions diverged,
    the host that runs the stage would block in its first collective
    while the skipping host never joins, deadlocking the job.
    """
    if process_count() == 1:
        return done
    flag = torch.tensor([1 if done else 0], dtype=torch.int32)
    primary = is_primary_host()
    with span("dist.sync_stage_done",
              bytes_out=flag.nbytes if primary else 0,
              bytes_in=0 if primary else flag.nbytes):
        _tdist().broadcast(flag, src=0)
    return bool(int(flag[0]))


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum an integer tensor over every process (on the host; returned
    on x's device).  Integer adds are order-free, so the sum is exact."""
    if process_count() == 1:
        return x
    h = x.cpu().clone()
    with span("dist.all_reduce_sum", bytes_out=h.nbytes, bytes_in=h.nbytes):
        _tdist().all_reduce(h)
    return h.to(x.device)


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Concatenate equal-shaped tensors of every process in process
    order (on the host; returned on x's device)."""
    if process_count() == 1:
        return x
    h = x.cpu().contiguous()
    out = [torch.empty_like(h) for _ in range(process_count())]
    with span("dist.all_gather_rows", bytes_out=h.nbytes,
              bytes_in=h.nbytes * len(out)):
        _tdist().all_gather(out, h)
    return torch.cat(out).to(x.device)


def allgather_bytes(payload: bytes) -> list[bytes]:
    """Gather one bytes blob per process, returned in process order.

    The host-shard merge primitive: each host serializes the records it
    computed for its input shard; every host receives all shards and
    reconstructs the full (canonically re-sorted) record set.  Lengths
    travel first, then the blobs padded to the longest.
    """
    P = process_count()
    if P == 1:
        return [payload]
    with span("dist.allgather_bytes") as sp:
        lens = all_gather_rows(torch.tensor([len(payload)],
                                            dtype=torch.int64))
        cap = max(int(lens.max()), 1)
        sp.attrs["pad_bytes"] = P * cap - int(lens.sum())
        buf = torch.zeros(cap, dtype=torch.uint8)
        if payload:
            buf[: len(payload)] = torch.from_numpy(
                np.frombuffer(payload, np.uint8).copy())
        stacked = all_gather_rows(buf).reshape(P, cap).numpy()
    return [stacked[i, : int(lens[i])].tobytes() for i in range(P)]


def exchange_to_owners(blobs: list[bytes]) -> list[bytes]:
    """All-to-all byte exchange: ``blobs[d]`` is this host's payload for
    destination host d; returns the payloads every host addressed to
    SELF, in source-process order.

    One allgather round per destination, retaining only the round
    addressed to this host: each host's RETAINED working set is
    O(owned contigs), the transient per-round buffer O(total / n_hosts).
    """
    P = process_count()
    if P == 1:
        return [blobs[0]]
    if len(blobs) != P:
        raise ValueError(f"{len(blobs)} blobs for {P} processes")
    me = process_index()
    mine: list[bytes] = []
    with span("dist.exchange_to_owners"):
        for dest in range(P):
            got = allgather_bytes(blobs[dest])
            if dest == me:
                mine = got
    return mine


def gather_to_primary(payload: bytes) -> list[bytes] | None:
    """Gather one blob per host; only host 0 returns the list (others
    return None and retain nothing).  Collective — every host must call."""
    if process_count() == 1:
        return [payload]
    with span("dist.gather_to_primary"):
        got = allgather_bytes(payload)
    return got if is_primary_host() else None


def contig_owners(lengths, n_hosts: int):
    """Deterministic length-balanced contig -> owner-host partition.

    Greedy LPT bin packing over contig lengths (ties and assignment order
    fixed by contig index), so every host derives the identical map with
    no communication.  Returns (n_ctg,) int32 of host ids.
    """
    import numpy as np
    lengths = np.asarray(lengths, np.int64)
    owners = np.zeros(len(lengths), np.int32)
    if n_hosts <= 1:
        return owners
    order = np.argsort(-lengths, kind="stable")   # longest first
    load = [0] * n_hosts
    for ci in order:
        h = int(np.argmin(load))                  # first least-loaded host
        owners[ci] = h
        load[h] += int(lengths[ci])
    return owners


def pack_arrays(cols: dict) -> bytes:
    """msgpack a dict of numpy arrays (dtype+shape preserved)."""
    import numpy as np

    from ..io.serialize import packb
    out = {}
    for k, v in cols.items():
        v = np.ascontiguousarray(v)
        out[k] = (str(v.dtype), list(v.shape), v.tobytes())
    return packb(out)


def unpack_arrays(blob: bytes) -> dict:
    import numpy as np

    from ..io.serialize import unpackb
    raw = unpackb(blob)
    return {k: np.frombuffer(b, dtype=np.dtype(dt)).reshape(shape)
            for k, (dt, shape, b) in raw.items()}

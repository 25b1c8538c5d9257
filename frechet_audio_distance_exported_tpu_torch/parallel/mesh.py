"""Process groups for data-parallel FAD: one process per card.

The counterpart of frechet_audio_distance_exported_tpu/parallel/mesh.py.
JAX drives every local chip from one controller over a 1-D ``Mesh``.
PyTorch's idiom is one process per card under ``torch.distributed``, and the
port needs it: host preparation is most of a pass (PERF.md §5), so each rank
decodes and prepares only its own share of the files, and host work grows
with the number of cards. Between ranks move only the statistics
``(N, Σx, Σxxᵀ)`` and, on the host path, the embedding rows.

``DataMesh`` is what a caller passes where the JAX package takes a ``Mesh``:
the process group, this rank, the group's size (the counterpart of
``mesh.devices.size``) and this rank's device, with the few collectives the
port uses. Every rank enters them in the same order. A local step that may
raise runs inside ``agree``, ``gather`` or ``from_rank0``, which tell every
rank whether any rank failed: a failure on one rank then raises on all of
them at the same point, where it would otherwise leave the others waiting
in the next collective until the group's timeout.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from datetime import timedelta
from typing import Callable, List, Optional, TypeVar

import torch
import torch.distributed as dist

from ..config import resolve_device

T = TypeVar("T")

# Seconds any collective may wait for the other ranks before it raises.
DEFAULT_TIMEOUT_S = 600.0


def pad_to_shards(n: int, num_shards: int) -> int:
    """Smallest multiple of num_shards >= n (batch padding for even sharding)."""
    return ((n + num_shards - 1) // num_shards) * num_shards


def _default_device() -> torch.device:
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device=None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> None:
    """Join the default process group (torch.distributed.init_process_group).

    With ``coordinator_address`` ("host:port") the group meets there over
    TCP, and ``num_processes`` and ``process_id`` name its size and this
    process's rank. Without it, the ``env://`` variables that torchrun sets
    (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK) are read.

    ``device`` defaults to a card where CUDA is available, else the CPU. A
    card without an index is this process's own: LOCAL_RANK (torchrun's), or
    the rank, modulo the card count; torch.cuda.set_device runs before the
    group starts, so NCCL and the object collectives use that card. The
    backend follows the device (NCCL for a card, gloo for the CPU) unless
    ``backend`` names one. ``timeout_s`` bounds every collective.
    """
    device = resolve_device(device) if device is not None else _default_device()
    if device.type == "cuda":
        if device.index is None:
            local = int(os.environ.get("LOCAL_RANK", process_id or 0))
            device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    kwargs = {}
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    dist.init_process_group(
        backend=backend,
        init_method=f"tcp://{coordinator_address}" if coordinator_address else "env://",
        timeout=timedelta(seconds=timeout_s),
        **kwargs,
    )


@dataclass(frozen=True)
class DataMesh:
    """A process group seen from one rank, and the collectives the port uses."""

    group: Optional[dist.ProcessGroup]  # None: the default group
    rank: int
    size: int
    device: torch.device

    def share(self, n: int) -> slice:
        """This rank's block of n items in input order; the blocks of ranks
        0, 1, ... cover 0..n-1 once, in order. A rank may get none."""
        return slice(self.rank * n // self.size, (self.rank + 1) * n // self.size)

    def all_reduce(self, tensor: torch.Tensor) -> torch.Tensor:
        """Sum ``tensor`` over the ranks, in place; returns it."""
        dist.all_reduce(tensor, group=self.group)
        return tensor

    def agree(self, fn: Callable[[], T]) -> T:
        """fn() on this rank, then every rank learns whether any rank raised,
        by one all-reduce of a flag; if one did, every rank raises."""
        out, err = None, None
        try:
            out = fn()
        except Exception as e:  # re-raised below, on every rank
            err = e
        flag = torch.tensor([0.0 if err is None else 1.0], device=self.device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=self.group)
        if flag.item():
            raise err if err is not None else RuntimeError("another rank failed")
        return out

    def gather(self, fn: Callable[[], List[T]]) -> List[T]:
        """fn() -> a list on each rank; every rank gets all the lists joined in
        rank order (an object all-gather, which NCCL and gloo both run). If
        any rank raised, every rank raises."""
        part, err = None, None
        try:
            part = (None, list(fn()))
        except Exception as e:  # re-raised below, on every rank
            err = e
            part = (repr(e), None)
        parts = [None] * self.size
        dist.all_gather_object(parts, part, group=self.group)
        failed = [msg for msg, _ in parts if msg is not None]
        if failed:
            raise err if err is not None else RuntimeError(f"another rank failed: {failed[0]}")
        return [item for _, items in parts for item in items]

    def from_rank0(self, fn: Callable[[], T]) -> T:
        """fn() on rank 0 alone; its value, or its failure, on every rank."""
        box, err = [None], None
        if self.rank == 0:
            try:
                box = [(None, fn())]
            except Exception as e:  # re-raised below, on every rank
                err = e
                box = [(repr(e), None)]
        src = 0 if self.group is None else dist.get_global_rank(self.group, 0)
        dist.broadcast_object_list(box, src=src, group=self.group)
        msg, value = box[0]
        if msg is not None:
            raise err if err is not None else RuntimeError(f"rank 0 failed: {msg}")
        return value


def data_mesh(group: Optional[dist.ProcessGroup] = None, device=None) -> DataMesh:
    """The DataMesh of an initialised group (initialize_distributed, or the
    caller's own init_process_group). ``device`` defaults to the current
    card where CUDA is available, else the CPU."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize_distributed() first")
    device = resolve_device(device) if device is not None else _default_device()
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if dist.get_backend(group) == "nccl" and device.type != "cuda":
        raise ValueError(f"an NCCL group needs a CUDA device, got {device}")
    return DataMesh(group, dist.get_rank(group), dist.get_world_size(group), device)

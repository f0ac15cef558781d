"""Multi-process data parallelism (counterpart of ``parallel/multihost.py``).

JAX connects hosts with ``jax.distributed.initialize`` and assembles
global arrays from each host's local data. Here every process is one
rank of a ``torch.distributed`` process group on one card (one process
per card, on one host or many): ``initialize_multihost`` joins it, each
rank loads only its slice of every global batch (``local_batch_slice``),
and ``global_batch_from_local`` keeps that slice on the rank's device.
The data-parallel steps (``train_parallel.py``) take the rank's own
rows as they are.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from .mesh import Mesh, backend_for

__all__ = ["initialize_multihost", "local_batch_slice",
           "global_batch_from_local", "MultihostBatchIterator",
           "process_index", "process_count"]


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The world size (1 without a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None, device=None,
                         init_method: str | None = None,
                         timeout_s: float | None = None) -> torch.device:
    """Join the process group and return this rank's device. A
    coordinator ``host:port`` is a TCP rendezvous (rank 0 listens there)
    with ``num_processes`` and ``process_id``; without one, torchrun's
    variables (``env://``: ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
    ``WORLD_SIZE``); ``init_method`` (a ``file://`` path, say) overrides
    both. The backend follows ``device`` (None: the card, raising without
    one): NCCL on ``cuda:<local rank>`` (``LOCAL_RANK``, else the rank
    modulo the visible cards), Gloo on the CPU. ``timeout_s`` bounds the
    rendezvous and every collective."""
    dev = resolve_device(device)
    kwargs = {}
    if init_method is None:
        if coordinator_address is not None:
            if num_processes is None or process_id is None:
                raise ValueError("a coordinator needs num_processes and "
                                 "process_id")
            init_method = f"tcp://{coordinator_address}"
        else:
            init_method = "env://"
    if init_method != "env://":
        kwargs = {"world_size": int(num_processes),
                  "rank": int(process_id)}
    if dev.type == "cuda" and dev.index is None:
        rank = int(process_id) if process_id is not None \
            else int(os.environ.get("RANK", 0))
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        dev = torch.device("cuda", local)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        kwargs["device_id"] = dev
    if timeout_s is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=float(timeout_s))
    dist.init_process_group(backend_for(dev), init_method=init_method,
                            **kwargs)
    return dev


def local_batch_slice(global_batch_size: int) -> slice:
    """The rows of each global batch this process loads: a contiguous
    block per rank, in rank order."""
    per = global_batch_size // process_count()
    start = process_index() * per
    return slice(start, start + per)


def global_batch_from_local(mesh: Mesh, local_array) -> torch.Tensor:
    """This rank's slice of a global batch as the data-parallel steps take
    it: a tensor on the rank's device (the other ranks hold the rest)."""
    return torch.as_tensor(np.asarray(local_array)).to(mesh.device)


class MultihostBatchIterator:
    """Per-rank view of a global batch stream. Wraps an iterator built
    with the GLOBAL batch size and the same seed on every rank (so every
    rank draws the same order); each batch keeps only the rank's
    ``local_batch_slice`` of ``x`` and ``labels``, on the rank's device,
    and is marked ``local`` (the manager's per-step path then takes its
    rows as the rank's). The scanned paths read the global
    ``epoch_plan`` and keep the rank's columns."""

    def __init__(self, base_iter, mesh: Mesh):
        self.base = base_iter
        self.mesh = mesh
        self.batch_size = base_iter.batch_size          # global

    @property
    def drop_last(self):
        return getattr(self.base, "drop_last", False)

    def __len__(self):
        return len(self.base)

    def epoch_plan(self):
        """The global plan (the same on every rank)."""
        return self.base.epoch_plan()

    def ordered_batches(self):
        """The base iterator's dataset-order pass, unsliced (for
        out-of-band evaluation in one process)."""
        return self.base.ordered_batches()

    def __iter__(self):
        sl = local_batch_slice(self.batch_size)
        for batch in self.base:
            if batch["x"].shape[0] != self.batch_size:
                continue        # drop_last across ranks must agree
            out = dict(batch)
            out["x"] = _local(batch["x"], sl, self.mesh)
            if "labels" in batch:
                out["labels"] = _local(batch["labels"], sl, self.mesh)
            out["local"] = True
            yield out


def _local(a, sl: slice, mesh: Mesh) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a[sl].to(mesh.device)
    return global_batch_from_local(mesh, np.ascontiguousarray(
        np.asarray(a)[sl]))

"""Data-parallel training steps (counterpart of
``parallel/train_parallel.py``).

One rank per card, over ``torch.distributed`` (``mesh.py``'s ranks'
mesh). Every rank holds the whole model and runs the port's own step
(``training/trainer.py``'s ``make_train_step``, and ``_Steps`` for the
scanned forms) on its local B scans, building its own B×B swap grid: no
grid crosses ranks. Between the backward and the updates the gradients
and the metrics are averaged as JAX's ``pmean`` does (``MeanReducer``:
one all-reduce ``SUM`` of their concatenation, then a division by the
world size), and coupled Adam then runs redundantly on every rank, on
equal values, so the replicas stay equal.

The per-step callables take the global batch ``[G, ...]`` (G = world ×
B) and keep the rank's rows ``[rank·B, (rank+1)·B)``, or the rank's own
B rows (``MultihostBatchIterator``'s). The scanned forms take the same
global plan on every rank (``idx [S, G]``, ``[E, S, G]``) and keep the
rank's columns; on the card they replay the step's CUDA graph with the
all-reduce inside it (``graphs.py``). Each rank's draws (its region and
noise) stand where JAX folds the device index into the key: the caller
hands each rank its own ``draws(step_id, rows)`` (``ModelManager``'s
fold the rank into the seed).
"""

from __future__ import annotations

import numpy as np

from ..training.trainer import (make_eval_step, make_scanned_train_epochs,
                                make_scanned_train_step, make_train_step)
from .mesh import MeanReducer, Mesh

__all__ = ["make_parallel_train_step", "make_parallel_eval_step",
           "make_scanned_parallel_step", "make_scanned_parallel_epochs",
           "local_rows"]


def local_rows(mesh: Mesh, x, batch_size: int):
    """The rank's rows of a global batch ``[world·B, ...]``; a batch of B
    rows is taken as the rank's own already. None stays None."""
    if x is None:
        return None
    n = x.shape[0]
    if n == batch_size:
        return x
    if n != mesh.world * batch_size:
        raise ValueError(f"a batch of {n} rows is neither the global "
                         f"{mesh.world}×{batch_size} nor the rank's "
                         f"{batch_size}")
    lo = mesh.rank * batch_size
    return x[lo:lo + batch_size]


def _columns(mesh: Mesh, a, batch_size: int):
    """The rank's columns of a plan's last axis (``[..., G]``)."""
    if a is None:
        return None
    a = np.asarray(a)
    if a.shape[-1] != mesh.world * batch_size:
        raise ValueError(f"a plan of {a.shape[-1]} columns is not the "
                         f"global {mesh.world}×{batch_size}")
    lo = mesh.rank * batch_size
    return np.ascontiguousarray(a[..., lo:lo + batch_size])


def make_parallel_train_step(model, weights, optimizer, batch_size: int,
                             mesh: Mesh, swap: bool = True, head=None,
                             head_optimizer=None):
    """``step(x [G or B, N, 3], region_idx=None, eps=None, generator=None,
    labels=None, class_weights=None) → metrics`` averaged over the ranks;
    the region and ``eps [B², Z]`` are the rank's own draws."""
    reduce = MeanReducer(mesh)
    inner = make_train_step(model, weights, optimizer, batch_size,
                            swap=swap, head=head,
                            head_optimizer=head_optimizer, reduce=reduce)

    def step(x, region_idx=None, eps=None, generator=None, labels=None,
             class_weights=None):
        return inner(local_rows(mesh, x, batch_size), region_idx=region_idx,
                     eps=eps, generator=generator,
                     labels=local_rows(mesh, labels, batch_size),
                     class_weights=class_weights)

    step.mesh = mesh
    return step


def make_parallel_eval_step(model, weights, batch_size: int, mesh: Mesh,
                            swap: bool = True, head=None):
    """The validation step over the rank's rows, its metrics averaged over
    the ranks; no update."""
    inner = make_eval_step(model, weights, batch_size, swap=swap, head=head,
                           reduce=MeanReducer(mesh))

    def step(x, region_idx=None, generator=None, labels=None,
             class_weights=None):
        return inner(local_rows(mesh, x, batch_size), region_idx=region_idx,
                     generator=generator,
                     labels=local_rows(mesh, labels, batch_size),
                     class_weights=class_weights)

    step.mesh = mesh
    return step


def make_scanned_parallel_step(model, weights, optimizer, batch_size: int,
                               mesh: Mesh, swap: bool = True, head=None,
                               head_optimizer=None, *, draws):
    """A whole data-parallel epoch: ``epoch(data_x [n, N, 3], idx [S, G],
    step_ids [S], labels [S, G] | None, class_weights) → metrics`` (floats,
    averaged over the ranks and the steps), the trainer's scanned epoch
    over the rank's columns of the plan, with the all-reduce inside each
    step (inside its captured graph on the card). ``draws(step_id, rows)``
    gives the rank's draws."""
    inner = make_scanned_train_step(model, weights, optimizer, batch_size,
                                    swap, head, head_optimizer, draws=draws,
                                    reduce=MeanReducer(mesh))

    def epoch(data_x, idx, step_ids, labels=None, class_weights=None):
        return inner(data_x, _columns(mesh, idx, batch_size), step_ids,
                     _columns(mesh, labels, batch_size), class_weights)

    epoch.steps = inner.steps
    epoch.mesh = mesh
    return epoch


def make_scanned_parallel_epochs(model, weights, optimizer, batch_size: int,
                                 mesh: Mesh, swap: bool = True, head=None,
                                 head_optimizer=None, *, draws):
    """E data-parallel epochs, each followed by its validation steps:
    ``epochs_fn(train_x, val_x, tr_idx [E, St, G], tr_sid, va_idx [E, Sv,
    G], va_sid, tr_labels | None, va_labels | None, class_weights) →
    (train metrics, validation metrics)``, lists of E dicts averaged over
    the ranks, the trainer's multi-epoch form over the rank's columns."""
    inner = make_scanned_train_epochs(model, weights, optimizer, batch_size,
                                      swap, head, head_optimizer,
                                      draws=draws, reduce=MeanReducer(mesh))

    def epochs_fn(train_x, val_x, tr_idx, tr_sid, va_idx, va_sid,
                  tr_labels=None, va_labels=None, class_weights=None):
        return inner(train_x, val_x, _columns(mesh, tr_idx, batch_size),
                     tr_sid, _columns(mesh, va_idx, batch_size), va_sid,
                     _columns(mesh, tr_labels, batch_size),
                     _columns(mesh, va_labels, batch_size), class_weights)

    epochs_fn.steps = inner.steps
    epochs_fn.mesh = mesh
    return epochs_fn

"""CUDA graphs of the port's loops (counterpart of the JAX package's
``lax.scan`` programs and per-shape ``jit`` caches).

The JAX package runs a whole epoch, the fit's iterations and each
serving bucket as one compiled program each. The port captures one step
of each as a ``torch.cuda.CUDAGraph`` at a fixed shape and replays it:
the step's inputs live in static tensors that the caller fills before
each replay, and its outputs in tensors that the replay overwrites. On
the host (CPU tensors) the same step runs eagerly; the CPU is never a
stand-in for the card.

``capture`` follows PyTorch's whole-network recipe: a few warm-up calls
on a side stream first, so that every kernel build, launch plan, lazily
made optimizer state and ``cudaFuncSetAttribute`` happens before the
capture, then one call recorded into the graph. A capture that fails
raises; nothing falls back to the eager step. A replay launches the
captured kernels without their wrappers' Python, so it neither adds to
``kernels.launches`` nor checks a return code: its faults surface at the
next synchronization. ``capture`` keeps what the wrappers counted while
the step was recorded (what one replay launches, by kernel), and each
``Captured.replay`` adds that to ``replayed``; the profiler's kernel
events of a replay are what hold the two equal.

``StateGuard`` keeps the warm-up's updates out of a training run: it
saves the parameters and the optimizers' states before the warm-up and
puts them back in place afterwards (the same tensors, so the graph reads
and writes the run's own state), zeroing the state the warm-up created,
which is what a fresh optimizer holds before its first step.
"""

from __future__ import annotations

import torch

from . import kernels

__all__ = ["capture", "Captured", "StateGuard", "replayed"]

#: kernel launches of the replays since its ``reset``, by kernel (each
#: replay adds what its capture recorded)
replayed = kernels.LaunchCounts()


class Captured:
    """A captured step: ``cuda_graph`` and the kernel launches its capture
    recorded (``launches``, by kernel: what one replay launches)."""

    def __init__(self, cuda_graph: torch.cuda.CUDAGraph, launches: dict):
        self.cuda_graph = cuda_graph
        self.launches = launches

    def replay(self) -> None:
        self.cuda_graph.replay()
        for name, n in self.launches.items():
            replayed.add(name, n)


def capture(step, device, warmup: int, pool=None,
            guard: "StateGuard | None" = None) -> Captured:
    """Call ``step()`` ``warmup`` times on a side stream of ``device``,
    then capture one call into a new graph (allocating from ``pool``, a
    ``torch.cuda.graph_pool_handle()``, where given) and return it. The
    captured call does not run: replay the graph for that. ``guard``
    undoes the warm-up's updates before the capture."""
    saved = guard.save() if guard is not None else None
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for _ in range(warmup):
            step()
    torch.cuda.current_stream(device).wait_stream(side)
    if saved is not None:
        guard.restore(saved)
    graph = torch.cuda.CUDAGraph()
    before = kernels.launches.snapshot()
    with torch.cuda.device(device), torch.cuda.graph(graph, pool=pool):
        step()
    after = kernels.launches.snapshot()
    return Captured(graph, {k: after[k] - before[k] for k in after
                            if after[k] != before[k]})


class StateGuard:
    """The parameters of ``modules`` and the states of ``optimizers``,
    saved by ``save`` and put back in place by ``restore``."""

    def __init__(self, modules, optimizers):
        self.params = [p for m in modules for p in m.parameters()]
        self.optimizers = list(optimizers)

    def _pairs(self):
        for opt in self.optimizers:
            for group in opt.param_groups:
                for p in group["params"]:
                    yield opt, p

    def save(self) -> tuple:
        params = [p.detach().clone() for p in self.params]
        states = [None if p not in opt.state else
                  {k: v.clone() for k, v in opt.state[p].items()}
                  for opt, p in self._pairs()]
        return params, states

    @torch.no_grad()
    def restore(self, saved: tuple) -> None:
        params, states = saved
        for p, v in zip(self.params, params):
            p.copy_(v)
        for (opt, p), st in zip(self._pairs(), states):
            for k, v in opt.state.get(p, {}).items():
                if st is None:
                    v.zero_()
                else:
                    v.copy_(st[k])

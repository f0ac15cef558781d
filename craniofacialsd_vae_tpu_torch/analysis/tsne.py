"""Exact t-SNE in torch (the counterpart of the sklearn
``TSNE(n_components=2)`` that the JAX Tester's
``plot_embeddings("tsne")`` calls; the card's machine has no sklearn).

It follows sklearn 1.9's ``method="exact"`` step for step, dtypes
included, on the inputs' device:

- squared Euclidean distances as float32, each row's Gaussian precision
  found by the binary search of ``_utils._binary_search_perplexity``
  (at most 100 steps, entropy tolerance 1e-5; rows searched together);
- ``P`` symmetrised and normalised, floored at the machine epsilon;
- gradient descent on the KL divergence to a Student-t ``Q``: 250
  iterations with ``P`` exaggerated 12× at momentum 0.5, then the rest at
  momentum 0.8, each phase with fresh gains (+0.2 / ×0.8, floored at
  0.01) and updates, ``learning_rate="auto"`` (``max(n / 48, 50)``), and
  sklearn's stops every 50 iterations: no progress for
  ``n_iter_without_progress`` iterations, or a gradient norm at most
  ``min_grad_norm``.

The JAX Tester takes sklearn's default Barnes-Hut approximation
(θ = 0.5) from an unseeded random start; this computes the exact
gradient that Barnes-Hut approximates, from a start drawn by an explicit
``torch.Generator`` (``1e-4 · N(0, 1)`` as float32, sklearn's random
init).
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["tsne", "joint_probabilities", "random_init"]

MACHINE_EPSILON = float(np.finfo(np.double).eps)
EXPLORATION_ITER = 250
ITER_CHECK = 50


def _squared_distances(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.float64)
    d = (x * x).sum(1)
    return (d[:, None] + d[None, :] - 2.0 * x @ x.T).clamp_(min=0.0) \
        .fill_diagonal_(0.0)


def joint_probabilities(x, perplexity: float = 30.0) -> torch.Tensor:
    """sklearn's ``_joint_probabilities`` of the rows of ``x`` ``[n, d]``
    as a full symmetric ``[n, n]`` float64 matrix (zero diagonal)."""
    x = torch.as_tensor(x)
    n = len(x)
    dist = _squared_distances(x).to(torch.float32).to(torch.float64)
    dev = dist.device
    beta = torch.ones(n, dtype=torch.float64, device=dev)
    lo = torch.full_like(beta, -math.inf)
    hi = torch.full_like(beta, math.inf)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    cond = torch.zeros_like(dist)
    eye = torch.eye(n, dtype=torch.bool, device=dev)
    target = math.log(perplexity)
    for _ in range(100):
        p = torch.exp(-dist * beta[:, None]).masked_fill_(eye, 0.0)
        s = p.sum(1)
        s = torch.where(s == 0.0, 1e-8, s)
        p /= s[:, None]
        diff = torch.log(s) + beta * (dist * p).sum(1) - target
        cond[active] = p[active]
        active &= diff.abs() > 1e-5
        if not bool(active.any()):
            break
        up = diff > 0
        lo = torch.where(active & up, beta, lo)
        hi = torch.where(active & ~up, beta, hi)
        new = torch.where(
            up, torch.where(hi == math.inf, beta * 2.0, (beta + hi) / 2.0),
            torch.where(lo == -math.inf, beta / 2.0, (beta + lo) / 2.0))
        beta = torch.where(active, new, beta)
    p = cond + cond.T
    p = p / p.sum().clamp(min=MACHINE_EPSILON)
    return p.clamp_(min=MACHINE_EPSILON).masked_fill_(eye, 0.0)


def _kl_and_grad(y: torch.Tensor, p: torch.Tensor, off: torch.Tensor,
                 with_error: bool) -> tuple:
    """sklearn's ``_kl_divergence`` (one degree of freedom): the KL
    divergence (float64, or NaN unless asked) and the float32 gradient.
    Every temporary is ``[n, n]``: one component at a time."""
    y64 = y.to(torch.float64)
    sq = sum((y64[:, c, None] - y64[None, :, c]) ** 2
             for c in range(y.shape[1]))
    dist = (1.0 / (1.0 + sq)).masked_fill_(~off, 0.0)
    q = (dist / dist.sum()).clamp(min=MACHINE_EPSILON)
    kl = float("nan")
    if with_error:
        kl = float((p * torch.log(p.clamp(min=MACHINE_EPSILON) / q))[off]
                   .sum())
    pqd = ((p - q) * dist).masked_fill_(~off, 0.0)
    grad = torch.stack([
        (pqd * (y[:, c, None] - y[None, :, c]).to(torch.float64)).sum(1)
        for c in range(y.shape[1])], 1).to(torch.float32)
    return kl, grad * 4.0


def _descent(y, p, off, it, max_iter, momentum, learning_rate,
             n_iter_without_progress, min_grad_norm) -> tuple:
    """sklearn's ``_gradient_descent`` (float32 embedding and gains, the
    update float64 as NumPy's promotion makes it)."""
    update = torch.zeros_like(y, dtype=torch.float64)
    gains = torch.ones_like(y)
    error = best_error = float(np.finfo(float).max)
    best_iter = i = it
    for i in range(it, max_iter):
        check = (i + 1) % ITER_CHECK == 0
        error, grad = _kl_and_grad(y, p, off, check or i == max_iter - 1)
        inc = update * grad < 0.0
        gains = torch.where(inc, gains + 0.2, gains * 0.8).clamp_(min=0.01)
        grad = grad * gains
        update = momentum * update - learning_rate * grad.to(torch.float64)
        y = (y.to(torch.float64) + update).to(torch.float32)
        if check:
            grad_norm = float(torch.linalg.vector_norm(grad))
            if error < best_error:
                best_error, best_iter = error, i
            elif i - best_iter > n_iter_without_progress:
                break
            if grad_norm <= min_grad_norm:
                break
    return y, error, i


def random_init(n: int, generator: torch.Generator | None = None,
                device=None, n_components: int = 2) -> torch.Tensor:
    """sklearn's random start, ``1e-4 · N(0, 1)`` as float32, drawn from
    ``generator`` (on its device)."""
    dev = generator.device if generator is not None else device
    return 1e-4 * torch.randn(n, n_components, generator=generator,
                              device=dev, dtype=torch.float32)


def tsne(x, init=None, generator: torch.Generator | None = None,
         perplexity: float = 30.0, early_exaggeration: float = 12.0,
         learning_rate="auto", max_iter: int = 1000,
         n_iter_without_progress: int = 300, min_grad_norm: float = 1e-7,
         device=None) -> dict:
    """Embed the rows of ``x`` ``[n, d]`` in 2-D. ``init`` ``[n, 2]``
    (else ``random_init`` from ``generator``); ``device`` defaults to
    ``x``'s. Returns ``{"embedding" [n, 2] float32 numpy, "kl_divergence",
    "n_iter", "P"}``, the last sklearn's ``kl_divergence_`` (the float
    maximum when the second phase runs no iteration, as in sklearn)."""
    x = torch.as_tensor(x)
    if device is not None:
        x = x.to(device)
    n = len(x)
    if perplexity >= n:
        raise ValueError("perplexity must be less than n_samples")
    if max_iter < EXPLORATION_ITER:
        raise ValueError(f"max_iter must be at least {EXPLORATION_ITER}")
    if learning_rate == "auto":
        learning_rate = max(n / early_exaggeration / 4, 50.0)
    y = random_init(n, generator, x.device) if init is None else \
        torch.as_tensor(init).to(x.device, torch.float32)
    p = joint_probabilities(x, perplexity)
    off = ~torch.eye(n, dtype=torch.bool, device=x.device)
    y, kl, it = _descent(y, p * early_exaggeration, off, 0,
                         EXPLORATION_ITER, 0.5, learning_rate,
                         EXPLORATION_ITER, min_grad_norm)
    if it < EXPLORATION_ITER or max_iter > EXPLORATION_ITER:
        y, kl, it = _descent(y, p, off, it + 1, max_iter, 0.8,
                             learning_rate, n_iter_without_progress,
                             min_grad_norm)
    return {"embedding": y.cpu().numpy(), "kl_divergence": kl,
            "n_iter": it, "P": p}

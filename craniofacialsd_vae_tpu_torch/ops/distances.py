"""Point-set and point-mesh distances (counterpart of ``ops/distances.py``).

``nearest_dists_sq_sym`` is kernel K8: the nearest-neighbour squared
distances of two clouds in both directions, the chamfer of the ``/fit``
intake. For a CUDA tensor it launches ``csrc/distances.cu`` (``k8_fwd``
once per direction; ``k8_bwd`` for the gradient), for a CPU tensor it
runs the plain twin, which computes what the JAX function computes in its
order: both clouds centred on ``mean(y)``, then per 4,096-column chunk of
``y`` (padded with rows at 1e9) ``‖x‖² + ‖y‖² − 2x·y``, reduced along both
axes. The argmins (the first index reaching each minimum) are kept for
the backward.

The gradient is an ``autograd.Function`` whose backward is a gather, not
a scatter: each point's share of the other direction's cotangents is
walked through a per-call CSR of the other side's argmins (a stable sort
plus segment offsets; ``argmin_csr``). JAX splits a cotangent equally
among tied minima, the first argmin gives all of it to one: the same
total wherever the tied points are identical (the fit's target padding
repeats its first point), and distinct points of continuous clouds tie
with probability 0.

``point_mesh_distance`` is host numpy, as in JAX. The Sinkhorn divergence
is not ported (no path runs it).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels

__all__ = ["nearest_dists_sq", "nearest_dists_sq_sym",
           "nearest_dists_sq_sym_plain", "nearest_sq_bwd_plain", "argmin_csr", "chamfer_distance",
           "point_mesh_distance"]

CHUNK = 4096        # JAX's column chunk
_PAD = 1e9          # JAX's padding coordinate (finite: inf − inf is NaN)


def _batched(x: torch.Tensor) -> torch.Tensor:
    return x if x.dim() == 3 else x[None]


def nearest_dists_sq_sym_plain(x: torch.Tensor, y: torch.Tensor,
                               chunk: int = CHUNK) -> tuple:
    """The plain twin of K8's forward, in the JAX function's chunk order:
    ``x [R, P, 3]``, ``y [Q, 3]`` → ``(d_x [R, P], d_y [R, Q], a [R, P],
    b [R, Q])`` with ``a``/``b`` the first argmins (int32)."""
    mu = y.mean(dim=0)
    y = y - mu
    q = y.shape[0]
    pad = (-q) % chunk
    y_pad = torch.cat([y, torch.full((pad, 3), _PAD, dtype=y.dtype,
                                     device=y.device)])
    y_chunks = y_pad.view(-1, chunk, 3)
    y2 = torch.sum(y_chunks * y_chunks, dim=-1)
    d_x, d_y, a_x, b_y = [], [], [], []
    for xr in x:
        xr = xr - mu
        x2 = torch.sum(xr * xr, dim=-1)
        best = torch.full_like(x2, float("inf"))
        arg = torch.zeros(x2.shape, dtype=torch.int64, device=x.device)
        col_min, col_arg = [], []
        for c, yc in enumerate(y_chunks):
            d2 = (x2[:, None] + y2[c][None, :]) - 2.0 * (xr @ yc.T)
            m, am = torch.min(d2, dim=1)
            take = m < best
            best = torch.where(take, m, best)
            arg = torch.where(take, am + c * chunk, arg)
            m0, am0 = torch.min(d2, dim=0)
            col_min.append(m0)
            col_arg.append(am0)
        d_x.append(torch.clamp_min(best, 0.0))
        a_x.append(arg)
        d_y.append(torch.clamp_min(torch.cat(col_min)[:q], 0.0))
        b_y.append(torch.cat(col_arg)[:q])
    return (torch.stack(d_x), torch.stack(d_y),
            torch.stack(a_x).to(torch.int32), torch.stack(b_y).to(torch.int32))


def argmin_csr(idx_v: torch.Tensor, nq: int) -> tuple:
    """``idx_v [R, nr]`` (each point's argmin among ``nq`` query points)
    → ``(perm [R, nr], offsets [R, nq + 1])``, int32: each batch's ``j``
    sorted stably by ``idx_v``, and each query point's segment of them.
    Index bookkeeping for ``k8_bwd``, on idx_v's device."""
    sorted_v, perm = torch.sort(idx_v.long(), dim=1, stable=True)
    bounds = torch.arange(nq + 1, device=idx_v.device).expand(
        idx_v.shape[0], nq + 1).contiguous()
    offsets = torch.searchsorted(sorted_v, bounds)
    return perm.to(torch.int32), offsets.to(torch.int32)


def nearest_sq_bwd_plain(query, ref, mu, g_u, d_u, idx_u, g_v, d_v, perm,
                         offsets) -> torch.Tensor:
    """The plain twin of ``k8_bwd`` (``kernels.nearest_sq_bwd``), summing
    in the kernel's order: each point's own term, then its segment of
    the other side's cotangents in increasing ``j``."""
    qb, rb = _batched(query), _batched(ref)
    batch = g_u.shape[0]
    nq = g_u.shape[1]
    out = []
    for r in range(batch):
        u = qb[min(r, qb.shape[0] - 1)] - mu
        v = rb[min(r, rb.shape[0] - 1)] - mu
        c = torch.where(d_u[r] > 0, 2.0 * g_u[r], torch.zeros_like(g_u[r]))
        acc = c[:, None] * (u - v[idx_u[r].long()])
        order = perm[r].long()
        owner = torch.repeat_interleave(
            torch.arange(nq, device=u.device),
            (offsets[r, 1:] - offsets[r, :-1]).long())
        cv = torch.where(d_v[r, order] > 0, 2.0 * g_v[r, order],
                         torch.zeros_like(g_v[r, order]))
        acc = acc.index_add(0, owner, cv[:, None] * (u[owner] - v[order]))
        out.append(acc)
    return torch.stack(out)


def _bwd(*args):
    if args[0].is_cuda:
        return kernels.nearest_sq_bwd(*args)
    return nearest_sq_bwd_plain(*args)


class _NearestSym(torch.autograd.Function):
    """``x [R, P, 3]``, ``y [Q, 3]`` → ``(d_x [R, P], d_y [R, Q])``."""

    @staticmethod
    def forward(ctx, x, y):
        x = x.contiguous()
        y = y.contiguous()
        mu = y.mean(dim=0)
        if x.is_cuda:
            d_x, a = kernels.nearest_sq(x, y, mu)
            d_y, b = kernels.nearest_sq(y, x, mu)
        else:
            d_x, d_y, a, b = nearest_dists_sq_sym_plain(x, y)
        ctx.save_for_backward(x, y, mu, d_x, d_y, a, b)
        ctx.mark_non_differentiable(a, b)
        return d_x, d_y

    @staticmethod
    def backward(ctx, g_x, g_y):
        x, y, mu, d_x, d_y, a, b = ctx.saved_tensors
        g_x = torch.zeros_like(d_x) if g_x is None else g_x.contiguous()
        g_y = torch.zeros_like(d_y) if g_y is None else g_y.contiguous()
        dx = dy = None
        if ctx.needs_input_grad[0]:
            perm, off = argmin_csr(b, x.shape[1])
            dx = _bwd(x, y, mu, g_x, d_x, a, g_y, d_y, perm, off)
        if ctx.needs_input_grad[1]:
            perm, off = argmin_csr(a, y.shape[0])
            dy = _bwd(y, x, mu, g_y, d_y, b, g_x, d_x, perm, off).sum(dim=0)
        return dx, dy


def nearest_dists_sq_sym(x: torch.Tensor, y: torch.Tensor) -> tuple:
    """Both directions (K8): ``(d_x, d_y)`` with ``d_x[p]`` the squared
    distance from ``x[p]`` to its nearest point of ``y`` and ``d_y[q]``
    likewise. ``x`` is ``[P, 3]`` (→ ``[P]``, ``[Q]``) or ``[R, P, 3]``
    against one ``y [Q, 3]`` (→ ``[R, P]``, ``[R, Q]``: the fit's
    restarts share their target). Differentiable in both."""
    if y.dim() != 2 or x.dim() not in (2, 3):
        raise ValueError(f"x must be [P, 3] or [R, P, 3] and y [Q, 3]; got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    d_x, d_y = _NearestSym.apply(_batched(x), y)
    if x.dim() == 2:
        return d_x[0], d_y[0]
    return d_x, d_y


def nearest_dists_sq(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """For each point of ``x [P, 3]``, the squared distance to its
    nearest point of ``y [Q, 3]`` (one ``k8_fwd`` launch on the card; no
    gradient: use ``nearest_dists_sq_sym`` for one)."""
    with torch.no_grad():
        if x.is_cuda:
            return kernels.nearest_sq(x.contiguous(), y.contiguous(),
                                      y.mean(dim=0))[0][0]
        return nearest_dists_sq_sym_plain(x[None], y)[0][0]


def chamfer_distance(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Symmetric chamfer ``mean_x min_y ‖·‖² + mean_y min_x ‖·‖²``
    (pytorch3d semantics): ``[P, 3]``/``[Q, 3]`` → scalar, or batched
    ``[B, P, 3]``/``[B, Q, 3]`` → ``[B]``."""
    if x.dim() == 3:
        return torch.stack([chamfer_distance(xb, yb) for xb, yb in
                            zip(x, y)])
    d_x, d_y = nearest_dists_sq_sym(x, y)
    return d_x.mean() + d_y.mean()


def point_mesh_distance(points, verts, faces) -> float:
    """Mean squared point-to-triangle distance / n_points (the reference's
    ``_point_mesh_distance``), exact, on the host."""
    from ..geometry.simplify import _point_triangle_closest

    def host(a):
        return a.detach().cpu().numpy() if torch.is_tensor(a) \
            else np.asarray(a)

    tri = host(verts)[host(faces)]
    pts = host(points)
    best = np.full(len(pts), np.inf)
    for s in range(0, len(pts), 1024):
        d2 = _point_triangle_closest(pts[s:s + 1024], tri)
        best[s:s + 1024] = d2.min(axis=1)
    return float(best.sum() / len(pts) ** 2)

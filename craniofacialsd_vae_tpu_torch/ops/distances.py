"""Point-set and point-mesh distances (counterpart of ``ops/distances.py``).

``nearest_dists_sq_sym`` is kernel K8: the nearest-neighbour squared
distances of two clouds in both directions, the chamfer of the ``/fit``
intake. For a CUDA tensor it launches ``csrc/distances.cu`` (``k8_fwd``
once, one pass over the pair matrix reducing both axes; ``k8_bwd`` once
for the gradient), for a CPU tensor it runs the plain twin, which
computes what the JAX function computes in its order: both clouds centred
on ``mean(y)``, then per 4,096-column chunk of ``y`` (padded with rows at
1e9) ``‖x‖² + ‖y‖² − 2x·y``, reduced along both axes. The argmins (the
lowest index reaching each minimum) are kept for the backward.

The gradient is an ``autograd.Function`` whose backward is a gather, not
a scatter: each point's share of the other direction's cotangents is
walked through a CSR of the other side's argmins (the entries sorted
stably by argmin, and each point's segment). On the card ``k8_bwd``
builds that CSR itself; its plain twin is ``argmin_csr`` (a stable sort
plus segment offsets), which runs for CPU tensors and in the checks. JAX
splits a cotangent equally among tied minima, the lowest argmin gives all
of it to one: the same total wherever the tied points are identical (the
fit's target padding repeats its first point), and distinct points of
continuous clouds tie with probability 0.

``point_mesh_distance`` is host numpy, as in JAX.

``sinkhorn_divergence`` is kernel K8-sinkhorn (``csrc/sinkhorn.cu``) on
the card: the log-space Sinkhorn of JAX's ``sinkhorn_divergence`` with the
``[P, Q]`` cost recomputed from the clouds in every pass and never
stored. Its forward keeps every iteration's potentials, and its backward
(an ``autograd.Function``) runs the reverse sweep over them as row and
column reductions. For CPU tensors it runs the plain twin,
``sinkhorn_divergence_plain``: JAX's function in torch over the
materialised cost, differentiable by autograd (``torch.maximum`` splits
the cotangent at the clamp's ties as JAX's ``maximum`` does). No path of
the port calls it (the reference comments its use out).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels

__all__ = ["nearest_dists_sq", "nearest_dists_sq_sym",
           "nearest_dists_sq_sym_plain", "nearest_sq_bwd_plain",
           "argmin_csr", "chamfer_distance", "point_mesh_distance",
           "sinkhorn_divergence", "sinkhorn_divergence_plain"]

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
    The plain twin of the CSR that ``k8_bwd`` builds on the card."""
    sorted_v, perm = torch.sort(idx_v.long(), dim=1, stable=True)
    bounds = torch.arange(nq + 1, device=idx_v.device).expand(
        idx_v.shape[0], nq + 1).contiguous()
    offsets = torch.searchsorted(sorted_v, bounds)
    return perm.to(torch.int32), offsets.to(torch.int32)


def nearest_sq_bwd_plain(query, ref, mu, g_u, d_u, idx_u, g_v, d_v, perm,
                         offsets) -> torch.Tensor:
    """The plain twin of ``k8_bwd`` (``kernels.nearest_sq_bwd``), over
    the CSR ``argmin_csr`` gives (the kernel builds the same one itself),
    summing in the kernel's order and rounding: each point's own term,
    then its segment of the other side's cotangents in increasing ``j``."""
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


def _bwd(query, ref, mu, g_u, d_u, idx_u, g_v, d_v, idx_v):
    if query.is_cuda:
        return kernels.nearest_sq_bwd(query, ref, mu, g_u, d_u, idx_u, g_v,
                                      d_v, idx_v)
    perm, off = argmin_csr(idx_v, g_u.shape[1])
    return nearest_sq_bwd_plain(query, ref, mu, g_u, d_u, idx_u, g_v, d_v,
                                perm, off)


class _NearestSym(torch.autograd.Function):
    """``x [R, P, 3]``, ``y [Q, 3]`` → ``(d_x [R, P], d_y [R, Q])``."""

    @staticmethod
    def forward(ctx, x, y):
        x = x.contiguous()
        y = y.contiguous()
        mu = y.mean(dim=0)
        if x.is_cuda:
            d_x, d_y, a, b = kernels.nearest_sq_sym(x, y, mu)
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
            dx = _bwd(x, y, mu, g_x, d_x, a, g_y, d_y, b)
        if ctx.needs_input_grad[1]:
            dy = _bwd(y, x, mu, g_y, d_y, b, g_x, d_x, a).sum(dim=0)
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
    nearest point of ``y [Q, 3]`` (one ``k8_fwd`` on the card, its column
    reduction off; no gradient: use ``nearest_dists_sq_sym`` for one)."""
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


def _log_weight(n: int) -> float:
    """``-log(n)`` in float32, JAX's ``jnp.log`` of the count."""
    return -float(np.log(np.float32(n)))


def sinkhorn_divergence_plain(x: torch.Tensor, y: torch.Tensor,
                              epsilon: float = 0.05,
                              n_iters: int = 50) -> torch.Tensor:
    """The plain twin of K8-sinkhorn: JAX's ``sinkhorn_divergence`` step
    for step over the materialised ``[P, Q]`` cost ``max(‖x‖² + ‖y‖² −
    2·x·yᵀ, 0)`` (a full fp32 product), ``n_iters`` log-space updates of
    f then g from zeros, then ``Σ coupling · cost``; differentiable."""
    xx = torch.sum(x * x, dim=-1)
    yy = torch.sum(y * y, dim=-1)
    raw = xx[:, None] + yy[None, :] - 2.0 * (x @ y.T)
    cost = torch.maximum(raw, torch.zeros_like(raw))
    log_mu = _log_weight(x.shape[0])
    log_nu = _log_weight(y.shape[0])
    f = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    g = torch.zeros(y.shape[0], dtype=y.dtype, device=y.device)
    for _ in range(n_iters):
        f = -epsilon * torch.logsumexp(
            (g[None, :] - cost) / epsilon + log_nu, dim=1)
        g = -epsilon * torch.logsumexp(
            (f[:, None] - cost) / epsilon + log_mu, dim=0)
    coupling = torch.exp((f[:, None] + g[None, :] - cost) / epsilon
                         + log_mu + log_nu)
    return torch.sum(coupling * cost)


class _Sinkhorn(torch.autograd.Function):
    """K8-sinkhorn: the forward kernel keeps the potentials of every
    iteration (``[n_iters + 1, P]`` and ``[n_iters + 1, Q]``), the
    backward kernel sweeps them in reverse."""

    @staticmethod
    def forward(ctx, x, y, epsilon, n_iters):
        x, y = x.contiguous(), y.contiguous()
        out, f_hist, g_hist = kernels.sinkhorn_fwd(x, y, epsilon, n_iters)
        ctx.save_for_backward(x, y, f_hist, g_hist)
        ctx.epsilon, ctx.n_iters = epsilon, n_iters
        return out

    @staticmethod
    def backward(ctx, grad):
        x, y, f_hist, g_hist = ctx.saved_tensors
        dx, dy = kernels.sinkhorn_bwd(x, y, ctx.epsilon, ctx.n_iters,
                                      f_hist, g_hist, grad.contiguous())
        return dx, dy, None, None


def sinkhorn_divergence(x: torch.Tensor, y: torch.Tensor,
                        epsilon: float = 0.05,
                        n_iters: int = 50) -> torch.Tensor:
    """Entropic OT cost between two clouds ``x [P, 3]``, ``y [Q, 3]``
    with uniform weights (JAX ``ops/distances.py::sinkhorn_divergence``),
    on the inputs' device: K8-sinkhorn's kernels on the card, the plain
    twin on the host; differentiable in both clouds."""
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != 3 or y.shape[1] != 3:
        raise ValueError(f"x and y must be [P, 3] and [Q, 3]; got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    if not x.is_cuda:
        return sinkhorn_divergence_plain(x, y, epsilon, n_iters)
    return _Sinkhorn.apply(x, y, float(epsilon), int(n_iters))

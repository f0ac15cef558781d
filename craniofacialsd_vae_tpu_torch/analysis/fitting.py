"""Latent fitting of an unregistered scan (counterpart of
``analysis/fitting.py``; the reference's test.py:336-520).

Procrustes landmark alignment onto the template frame, then Adam over a
population of latent restarts minimizing ``10·landmark-MSE + chamfer``,
keeping the best restart. The chamfer is K8 (``ops/distances.py``)
between the decoded meshes at every fourth vertex and the aligned scan's
every fourth point, the target padded to the next power of two with
copies of its first point (the gen→target minimum is unchanged; the
target→gen sum is masked and divided by the true count).

JAX runs the iterations as one scanned dispatch, cached per manager and
learning rate. Here one iteration (decode the restarts, the landmark and
chamfer losses, the decoder's backward to z with the model's weights
frozen, so that no weight gradient forms, and Adam on z) runs over
static tensors: z, its Adam state, the target, its mask, the true target
count ``q`` (a 0-d tensor, so that two scans of one padded size share
the iteration without sharing a ``q``), the landmarks and the
normalization. On the card it is captured once as a CUDA graph and
replayed ``iterations`` times; the final losses run eagerly. The
learning rate is a 0-d tensor on the card too (capturable Adam reads it
there), so the iteration is cached per (manager, restarts, padded target
size, landmarks, policy) alone, at most ``FIT_RUNS_PER_MANAGER`` of them
(the least recently used goes, its graph's memory with it): a client
that varies the request's learning rate, restarts or scan size does not
grow the device memory without bound. Each fit copies its request into
the static tensors and starts Adam from zero, so a cached iteration fits
as a fresh one does.

With a devices' ``mesh`` (``parallel.make_data_mesh``) the restarts,
rounded up to a multiple of its devices, are split over them: each device
fits its share with a replica of the model (kept per manager and device,
its weights refreshed from the manager's at every fit) and its own cached
iteration, and the best restart is taken across all of them. Each
restart's trajectory is its own, so the answer is the unsharded fit's
with the rounded restart count.
"""

from __future__ import annotations

import weakref
from collections import OrderedDict

import numpy as np
import torch

from ..graphs import capture
from ..ops.distances import nearest_dists_sq_sym
from .saliency import _norm_tensors, frozen

__all__ = ["procrustes_align", "fit_latent"]

#: iterations run on a side stream before the iteration's graph is
#: captured (the first makes z's gradient and Adam's state)
WARMUP_ITERATIONS = 2

#: cached fit iterations (each on the card with its graph) per manager
FIT_RUNS_PER_MANAGER = 4


def procrustes_align(scan: np.ndarray, landmarks: np.ndarray,
                     tpl_landmarks: np.ndarray):
    """Align an unregistered scan onto the template's landmark frame
    (reference test.py:350-373: centred, normalized orthogonal
    Procrustes, re-scaled into the template frame). Returns
    ``(aligned_scan, aligned_landmarks)``, float64."""
    from scipy.linalg import orthogonal_procrustes

    scan = np.asarray(scan, np.float64)
    landmarks = np.asarray(landmarks, np.float64)
    tpl_lnd = np.asarray(tpl_landmarks, np.float64)

    t_tpl = tpl_lnd.mean(0)
    c_tpl = tpl_lnd - t_tpl
    n_tpl = np.linalg.norm(c_tpl)
    c_tpl = c_tpl / n_tpl

    t_new = landmarks.mean(0)
    c_new = landmarks - t_new
    n_new = np.linalg.norm(c_new)
    c_new = c_new / n_new

    rotation, scale = orthogonal_procrustes(c_tpl, c_new)

    aligned = (scan - t_new) / n_new
    aligned = (aligned @ rotation.T) * scale
    aligned = aligned * n_tpl + t_tpl
    aligned_lnd = (c_new @ rotation.T) * scale * n_tpl + t_tpl
    return aligned, aligned_lnd


def _losses(model, z, mean, std, lnd_idx, target_lnd, t_padded, t_mask, q):
    """Per restart: (landmark MSE [R], chamfer [R]) in raw space."""
    gen = model.decode(z).transpose(0, 1) * std + mean        # [R, N, 3]
    lnd = torch.mean((gen[:, lnd_idx, :] - target_lnd) ** 2, dim=(1, 2))
    d_g, d_t = nearest_dists_sq_sym(gen[:, ::4].contiguous(), t_padded)
    ch = d_g.mean(dim=1) + torch.sum(d_t * t_mask, dim=1) / q
    return lnd, ch


class _FitRun:
    """One fit iteration over static tensors (see the module docstring),
    on the card captured as a CUDA graph at the first fit."""

    def __init__(self, model, restarts: int, latent: int, q_pad: int,
                 n_landmarks: int, n_vertices: int, device):
        self.model = model
        self.device = device
        self.z = torch.zeros((restarts, latent), dtype=torch.float32,
                             device=device, requires_grad=True)
        card = device.type == "cuda"
        # on the card the graph reads the learning rate from a tensor
        lr = torch.zeros((), dtype=torch.float32, device=device) if card \
            else 0.0
        self.opt = torch.optim.Adam([self.z], lr=lr, capturable=card)

        def static(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=device)

        self.mean, self.std = static(n_vertices, 3), static(n_vertices, 3)
        self.lnd_idx = static(n_landmarks, dtype=torch.long)
        self.target_lnd = static(n_landmarks, 3)
        self.t_padded, self.t_mask = static(q_pad, 3), static(q_pad)
        self.q = static()
        self.graph = None

    def args(self) -> tuple:
        return (self.mean, self.std, self.lnd_idx, self.target_lnd,
                self.t_padded, self.t_mask, self.q)

    def _iteration(self) -> None:
        lnd_loss, ch = _losses(self.model, self.z, *self.args())
        loss = torch.sum(10.0 * lnd_loss + ch)
        self.opt.zero_grad(set_to_none=False)
        loss.backward()
        self.opt.step()

    @torch.no_grad()
    def _start(self, z0) -> None:
        """z at its restarts, Adam at zero: a fresh optimizer's state."""
        self.z.copy_(z0)
        for st in self.opt.state.values():
            for v in st.values():
                v.zero_()

    def run(self, z0, inputs: tuple, lr: float, iterations: int,
            graph: bool = True) -> None:
        """``iterations`` Adam steps of rate ``lr`` on z from ``z0`` for
        the request's ``inputs`` (``args()``'s order); on the card by
        replays of the graph (``graph=False``: the same iteration launched
        eagerly, the reference the graph is held against)."""
        with torch.no_grad():
            for dst, src in zip(self.args(), inputs):
                dst.copy_(src)
            group = self.opt.param_groups[0]
            if isinstance(group["lr"], torch.Tensor):
                group["lr"].fill_(float(lr))
            else:
                group["lr"] = float(lr)
        self._start(z0)
        if graph and self.device.type == "cuda" and iterations:
            if self.graph is None:
                self.graph = capture(self._iteration, self.device,
                                     WARMUP_ITERATIONS)
                self._start(z0)
            for _ in range(int(iterations)):
                self.graph.replay()
        else:
            for _ in range(int(iterations)):
                self._iteration()


#: the fit iterations by manager (least recently used first), weakly
#: keyed as the JAX package's programs are (a new manager at a recycled
#: address gets its own)
_FIT_RUNS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _fit_run(mgr, restarts: int, q_pad: int, n_landmarks: int,
             model=None, device=None) -> _FitRun:
    """The cached iteration of the manager's model, or of one of its
    replicas (``model`` on ``device``, cached under the replica)."""
    owner = mgr if model is None else model
    model = mgr.model if model is None else model
    device = mgr.device if device is None else device
    key = (int(restarts), int(q_pad), int(n_landmarks),
           mgr.net_config.compute_dtype)
    runs = _FIT_RUNS.setdefault(owner, OrderedDict())
    if key in runs:
        runs.move_to_end(key)
    else:
        while len(runs) >= FIT_RUNS_PER_MANAGER:
            runs.popitem(last=False)
        runs[key] = _FitRun(model, restarts, mgr.model_latent_size,
                            q_pad, n_landmarks, mgr.template.num_vertices,
                            device)
    return runs[key]


#: the model's replicas on a mesh's other devices, by manager
_REPLICAS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _replicas(mgr, devices: list) -> list:
    """``(model, device)`` per device of a mesh: the manager's own model
    on its device first, then replicas (made once per manager, slot and
    device, their weights copied in place from the manager's now)."""
    from ..parallel.mesh import replicate_model, same_device

    cache = _REPLICAS.setdefault(mgr, {})
    out = []
    for i, dev in enumerate(devices):
        dev = torch.device(dev)
        if i == 0 and same_device(dev, mgr.device):
            out.append((None, dev))
            continue
        key = (i, str(dev))
        if key not in cache:
            cache[key] = replicate_model(mgr.model, dev)
        rep = cache[key]
        with torch.no_grad():
            for p, q in zip(rep.parameters(), mgr.model.parameters()):
                p.copy_(q)
        out.append((rep, dev))
    return out


def fit_latent(manager, norm: dict | None, scan: np.ndarray,
               landmarks: np.ndarray, landmarks_idx, *, lr: float = 5e-3,
               iterations: int = 250, n_restarts: int = 16, seed: int = 0,
               z_anchor: np.ndarray | None = None, mesh=None) -> dict:
    """Fit a latent to an unregistered scan ``[M, 3]`` (any M) given its
    landmarks ``[K, 3]``, which correspond to ``landmarks_idx`` on the
    template. ``z0``: ``n_restarts - 1`` standard normal draws from
    ``numpy.random.default_rng(seed)`` (the JAX package's draws) and the
    anchor (zeros, the prior mean, unless ``z_anchor``). On the card the
    iterations replay one CUDA graph. ``mesh``: a devices' data mesh to
    split the restarts over (rounded up to a multiple of its devices).
    Returns ``{z, vertices (raw scan space), chamfer_mm2,
    landmark_mse_mm2, aligned_scan, best_restart}``.
    """
    return _fit_latent(manager, norm, scan, landmarks, landmarks_idx, lr,
                       iterations, n_restarts, seed, z_anchor, graph=True,
                       mesh=mesh)


def _fit_latent(manager, norm, scan, landmarks, landmarks_idx, lr,
                iterations, n_restarts, seed, z_anchor, graph: bool,
                mesh=None) -> dict:
    """``fit_latent``; ``graph=False`` launches the iterations eagerly on
    the card too (the reference its graph is held against)."""
    mgr = manager
    dev = mgr.device
    landmarks_idx = list(landmarks_idx)
    aligned, aligned_lnd = procrustes_align(
        scan, landmarks, mgr.template.pos[landmarks_idx])

    devices = [dev] if mesh is None else list(mesh.devices)
    if mesh is not None and mesh.ranks:
        raise ValueError("the fit splits its restarts over a devices' mesh "
                         "in one process, not over ranks")
    n_dev = len(devices)
    n_restarts = -(-int(n_restarts) // n_dev) * n_dev
    per = n_restarts // n_dev
    rng = np.random.default_rng(seed)
    z0 = rng.standard_normal(
        (n_restarts - 1, mgr.model_latent_size)).astype(np.float32)
    anchor = np.zeros(mgr.model_latent_size, np.float32) \
        if z_anchor is None else np.asarray(z_anchor, np.float32)
    z0 = np.concatenate([z0, anchor[None]], axis=0)

    t_sub = np.asarray(aligned, np.float32)[::4]
    q = len(t_sub)
    q_pad = 1 << (q - 1).bit_length()
    t_padded = np.concatenate(
        [t_sub, np.broadcast_to(t_sub[:1], (q_pad - q, 3))])
    t_mask = (np.arange(q_pad) < q).astype(np.float32)
    mean, std = _norm_tensors(norm, dev)
    n = mgr.template.num_vertices
    inputs = (mean.expand(n, 3), std.expand(n, 3),
              torch.as_tensor(landmarks_idx, dtype=torch.long),
              torch.as_tensor(np.asarray(aligned_lnd, np.float32)),
              torch.as_tensor(t_padded), torch.as_tensor(t_mask),
              torch.tensor(float(q)))

    model = mgr.model
    z0 = torch.as_tensor(z0)
    runs = []
    for i, (rep, rep_dev) in enumerate(_replicas(mgr, devices)):
        run = _fit_run(mgr, per, q_pad, len(landmarks_idx), rep, rep_dev)
        with frozen(run.model):
            run.run(z0[i * per:(i + 1) * per], inputs, lr, iterations, graph)
        runs.append(run)
    lnd_parts, ch_parts = [], []
    for run in runs:
        with frozen(run.model), torch.no_grad():
            lnd_i, ch_i = _losses(run.model, run.z.detach(), *run.args())
        lnd_parts.append(lnd_i.cpu().numpy())
        ch_parts.append(ch_i.cpu().numpy())
    lnd_loss, ch = np.concatenate(lnd_parts), np.concatenate(ch_parts)
    errors = 10.0 * lnd_loss + ch
    best = int(np.argmin(errors))
    with frozen(model), torch.no_grad():
        z_best = runs[best // per].z.detach()[best % per].to(dev).clone()
        gen = model.decode(z_best[None]).transpose(0, 1)[0]
        gen = (gen * std + mean) if norm is not None else gen
    # squared distances scale with the squared linear→mm constant
    mm2 = mgr.to_mm_const ** 2
    return {"z": z_best.cpu().numpy(), "vertices": gen.cpu().numpy(),
            "chamfer_mm2": float(ch[best] * mm2),
            "landmark_mse_mm2": float(lnd_loss[best] * mm2),
            "aligned_scan": aligned, "best_restart": best}

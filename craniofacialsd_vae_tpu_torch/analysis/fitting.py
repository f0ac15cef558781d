"""Latent fitting of an unregistered scan (counterpart of
``analysis/fitting.py``; the reference's test.py:336-520).

Procrustes landmark alignment onto the template frame, then Adam over a
population of latent restarts minimizing ``10·landmark-MSE + chamfer``,
keeping the best restart. The chamfer is K8 (``ops/distances.py``)
between the decoded meshes at every fourth vertex and the aligned scan's
every fourth point, the target padded to the next power of two with
copies of its first point (the gen→target minimum is unchanged; the
target→gen sum is masked and divided by the true count).

JAX runs the iterations as one scanned dispatch. Here each iteration is
a host loop step: decode the restarts, the landmark and chamfer losses,
the decoder's backward to z (the model's weights frozen, so no weight
gradient forms), and Adam on z. Nothing is compiled, so nothing stands
in for JAX's per-manager cache of fit programs: the normalization stats
move to the device per fit (three floats a vertex against the loop's
iterations).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.distances import nearest_dists_sq_sym
from .saliency import _norm_tensors, frozen

__all__ = ["procrustes_align", "fit_latent"]


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


def fit_latent(manager, norm: dict | None, scan: np.ndarray,
               landmarks: np.ndarray, landmarks_idx, *, lr: float = 5e-3,
               iterations: int = 250, n_restarts: int = 16, seed: int = 0,
               z_anchor: np.ndarray | None = None) -> dict:
    """Fit a latent to an unregistered scan ``[M, 3]`` (any M) given its
    landmarks ``[K, 3]``, which correspond to ``landmarks_idx`` on the
    template. ``z0``: ``n_restarts - 1`` standard normal draws from
    ``numpy.random.default_rng(seed)`` (the JAX package's draws) and the
    anchor (zeros, the prior mean, unless ``z_anchor``). Returns ``{z,
    vertices (raw scan space), chamfer_mm2, landmark_mse_mm2,
    aligned_scan}``."""
    mgr = manager
    dev = mgr.device
    landmarks_idx = list(landmarks_idx)
    aligned, aligned_lnd = procrustes_align(
        scan, landmarks, mgr.template.pos[landmarks_idx])

    rng = np.random.default_rng(seed)
    z0 = rng.standard_normal(
        (n_restarts - 1, mgr.model_latent_size)).astype(np.float32)
    anchor = np.zeros(mgr.model_latent_size, np.float32) \
        if z_anchor is None else np.asarray(z_anchor, np.float32)
    z0 = np.concatenate([z0, anchor[None]], axis=0)

    t_sub = np.asarray(aligned, np.float32)[::4]
    q = len(t_sub)
    q_pad = 1 << (q - 1).bit_length()
    t_padded = torch.as_tensor(np.concatenate(
        [t_sub, np.broadcast_to(t_sub[:1], (q_pad - q, 3))]), device=dev)
    t_mask = torch.as_tensor((np.arange(q_pad) < q).astype(np.float32),
                             device=dev)
    target_lnd = torch.as_tensor(np.asarray(aligned_lnd, np.float32),
                                 device=dev)
    lnd_idx = torch.as_tensor(landmarks_idx, dtype=torch.long, device=dev)

    mean, std = _norm_tensors(norm, dev)
    model = mgr.model
    args = (mean, std, lnd_idx, target_lnd, t_padded, t_mask, float(q))
    z = torch.tensor(z0, device=dev, requires_grad=True)
    opt = torch.optim.Adam([z], lr=float(lr))
    with frozen(model):
        for _ in range(int(iterations)):
            lnd_loss, ch = _losses(model, z, *args)
            loss = torch.sum(10.0 * lnd_loss + ch)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
        with torch.no_grad():
            lnd_loss, ch = _losses(model, z, *args)
            lnd_loss, ch = lnd_loss.cpu().numpy(), ch.cpu().numpy()
            errors = 10.0 * lnd_loss + ch
            best = int(np.argmin(errors))
            z_best = z.detach()[best]
            gen = model.decode(z_best[None]).transpose(0, 1)[0]
            gen = (gen * std + mean) if norm is not None else gen
    # squared distances scale with the squared linear→mm constant
    mm2 = mgr.to_mm_const ** 2
    return {"z": z_best.cpu().numpy(), "vertices": gen.cpu().numpy(),
            "chamfer_mm2": float(ch[best] * mm2),
            "landmark_mse_mm2": float(lnd_loss[best] * mm2),
            "aligned_scan": aligned, "best_restart": best}

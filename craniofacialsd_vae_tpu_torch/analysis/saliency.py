"""Diagnostic saliency: gradient attribution of a QDA diagnosis onto the
scan surface (counterpart of ``analysis/saliency.py``).

The diagnosis of a raw scan ``x`` is ``argmax_c log p(c | mu(x))`` over
the QDA head's class Gaussians. Saliency is the gradient of the margin

    m(x) = log p(c_pred | mu(x)) - log p(c_ref | mu(x))

with respect to the raw vertex coordinates, reduced to one magnitude per
vertex (the L2 norm over xyz, in nats per millimetre). ``c_ref`` is the
healthy class, or the runner-up when the prediction is healthy.

The QDA log-posterior is a differentiable torch function of the latent
(the class factorizations padded to one ``[C, D, Rmax]`` tensor, one
einsum), equal to ``QDAClassifier.log_posteriors``. The raw-space gradient
is autograd's through normalize → encode: on the card that runs the
encoder's input gradients through the kernels' transposes. The model's
parameters are frozen meanwhile (``frozen``), so no weight gradient is
formed. Samples are independent through the encoder, so the gradient of
the batch's summed margin is each sample's own, and a bucket's padded
rows cannot reach its real rows.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

__all__ = ["qda_log_posterior_constants", "make_qda_log_posterior",
           "make_margin_fn", "make_saliency_fn", "region_attribution",
           "frozen"]


@contextlib.contextmanager
def frozen(module: torch.nn.Module):
    """Turn off ``requires_grad`` on ``module``'s parameters for the
    block, so that a gradient in the inputs forms no weight gradient."""
    params = [p for p in module.parameters() if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield module
    finally:
        for p in params:
            p.requires_grad_(True)


def qda_log_posterior_constants(qda) -> dict:
    """``means [C, D]``, ``scaled_rot [C, D, Rmax]`` (each class's
    rotations over sqrt(scalings), zero past its rank) and ``log_offsets
    [C]`` (``-0.5·Σ log s2 + log prior``), float32, such that
    ``log p(c | z) = -0.5·‖(z - mean_c) @ scaled_rot_c‖² + log_offsets_c``
    equals ``QDAClassifier.log_posteriors``."""
    qda._ensure_factors()
    means = np.asarray(qda.means, np.float32)
    n_classes, dim = means.shape
    rmax = max(r.shape[1] for r in qda.rotations)
    scaled_rot = np.zeros((n_classes, dim, rmax), np.float32)
    log_offsets = np.zeros(n_classes, np.float64)
    for i, (rot, s2) in enumerate(zip(qda.rotations, qda.scalings)):
        scaled_rot[i, :, :rot.shape[1]] = rot / np.sqrt(s2)
        log_offsets[i] = -0.5 * np.sum(np.log(s2)) + np.log(qda.priors[i])
    return {"means": means, "scaled_rot": scaled_rot,
            "log_offsets": log_offsets.astype(np.float32)}


def make_qda_log_posterior(qda, device):
    """Latents ``[B, D]`` → log-posteriors ``[B, C]`` on ``device``
    (differentiable; fp32, the einsum in full fp32: TF32 stays off)."""
    consts = qda_log_posterior_constants(qda)
    q_means = torch.as_tensor(consts["means"], device=device)
    q_srot = torch.as_tensor(consts["scaled_rot"], device=device)
    q_off = torch.as_tensor(consts["log_offsets"], device=device)

    def log_post(z):
        diff = z[:, None, :] - q_means[None]
        proj = torch.einsum("bcd,cdr->bcr", diff, q_srot)
        return -0.5 * torch.sum(proj * proj, dim=-1) + q_off

    return log_post


def _norm_tensors(normalization, device):
    if normalization is None:           # normalize_data: False → identity
        normalization = {"mean": 0.0, "std": 1.0}
    return (torch.as_tensor(np.asarray(normalization["mean"], np.float32),
                            device=device),
            torch.as_tensor(np.asarray(normalization["std"], np.float32),
                            device=device))


def make_margin_fn(manager, normalization: dict | None, qda,
                   healthy_class_idx: int):
    """``margin_fn(x)``: raw ``[B, N, 3]`` → ``(margin [B], pred_pos [B],
    ref_pos [B], log_post [B, C], mu [B, Z])``. The positions index
    ``qda.classes`` (the classes the QDA saw), not the run's label
    indices; ``healthy_class_idx`` is a label index (``manager.class2idx(
    'n')``) and raises if the QDA never saw it."""
    model = manager.model
    mean, std = _norm_tensors(normalization, manager.device)
    healthy_pos = qda._class_index(healthy_class_idx)
    log_post = make_qda_log_posterior(qda, manager.device)
    n_classes = len(qda.classes)

    def margin_fn(x_raw):
        xn = (x_raw - mean) / std
        mu, _ = model.encode(xn.transpose(0, 1))
        lp = log_post(mu)
        pred = torch.argmax(lp, dim=1)
        is_pred = torch.arange(n_classes, device=lp.device)[None] \
            == pred[:, None]
        runner = torch.argmax(torch.where(is_pred, -torch.inf, lp), dim=1)
        ref = torch.where(pred == healthy_pos, runner,
                          torch.full_like(pred, healthy_pos))
        margin = lp.gather(1, pred[:, None])[:, 0] \
            - lp.gather(1, ref[:, None])[:, 0]
        return margin, pred.to(torch.int32), ref.to(torch.int32), lp, mu

    return margin_fn


def make_saliency_fn(manager, normalization: dict | None, qda,
                     healthy_class_idx: int):
    """``fn(x)``: raw ``[B, N, 3]`` → ``(saliency [B, N] nats/mm, margin
    [B], pred_pos [B], ref_pos [B], log_post [B, C], mu [B, Z])``. Call it
    with autograd enabled (not under ``inference_mode``)."""
    margin_fn = make_margin_fn(manager, normalization, qda,
                               healthy_class_idx)
    to_mm = float(manager.to_mm_const)

    def fn(x):
        with frozen(manager.model), torch.enable_grad():
            x = x.detach().requires_grad_(True)
            margin, pred, ref, lp, mu = margin_fn(x)
            (grads,) = torch.autograd.grad(margin.sum(), [x])
        # mm = raw · to_mm ⇒ ∂/∂mm = ∂/∂raw / to_mm
        saliency = torch.sqrt(torch.sum(grads * grads, dim=-1)) / to_mm
        return (saliency, margin.detach(), pred, ref, lp.detach(),
                mu.detach())

    return fn


def region_attribution(saliency, template) -> list:
    """A per-vertex saliency map ``[N]`` summed over the template's
    regions, rows sorted by descending share: ``{region, attribute,
    share, mean_nats_per_mm, n_vertices}``; ``region`` is the region key
    (the vertex colour, first-seen order), ``attribute`` its anatomical
    name where the colour is a known region."""
    from ..geometry.template import COLOUR2ATTRIBUTE

    sal = np.asarray(saliency, np.float64).reshape(-1)
    if sal.shape[0] != template.num_vertices:
        raise ValueError(
            f"saliency has {sal.shape[0]} entries for a "
            f"{template.num_vertices}-vertex template")
    total = float(sal.sum())
    rows = []
    for name in template.region_names:
        mask = template.region_vertex_mask(name)
        mass = float(sal[mask].sum())
        rows.append({
            "region": name,
            "attribute": COLOUR2ATTRIBUTE.get(name, name),
            "share": mass / total if total > 0 else 0.0,
            "mean_nats_per_mm": float(sal[mask].mean()) if mask.any()
            else 0.0,
            "n_vertices": int(mask.sum()),
        })
    rows.sort(key=lambda r: r["share"], reverse=True)
    return rows

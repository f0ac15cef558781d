"""The training step (counterpart of ``training/trainer.py``).

One step: the on-device B→B² feature swap, forward, the losses, backward
through the precomputed transposes (K4 and its capped form, K2-dW; see
``ops/spiral_conv.py``) and the Adam update with coupled L2, as the JAX
``_build_raw_step`` and ``_compute_losses`` do. PyTorch runs it eagerly,
one launch after another; ``run_steps`` is the per-step loop that takes
the place of the JAX package's scanned epoch.

With an MLP head (``models/mlp.py``) and a classification weight, the
step adds the class-weighted cross entropy of the head's logits on the
swap grid's diagonal (the unswapped scans, rows ``(B+1)·i``) and updates
the head with its own coupled Adam, as ``_compute_losses`` and
``_build_raw_step`` do.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..data.swap import choose_region, swap_features_dynamic
from ..models.sdvae import SDVAE
from .losses import (kl_divergence_loss, laplacian_loss,
                     latent_consistency_loss, mse_loss, region_feature_mask,
                     weighted_cross_entropy)

__all__ = ["LOSS_KEYS", "LossWeights", "coupled_adam", "compute_losses",
           "make_train_step", "make_eval_step", "run_steps"]

LOSS_KEYS = ["reconstruction", "kl", "latent_consistency", "laplacian",
             "classification", "classification_acc", "tot"]


@dataclass(frozen=True)
class LossWeights:
    """Loss weighting. A term whose weight is 0 is left out of the step
    (its metric reads 0), as the JAX package does for Python floats."""
    kl: float = 1e-4
    laplacian: float = 0.1
    latent_consistency: float = 0.5
    eta1: float = 0.5
    eta2: float = 0.5
    classification: float = 0.0

    @classmethod
    def from_config(cls, opt_cfg: dict, clf_cfg: dict | None = None):
        w_class = 0.0
        if clf_cfg and clf_cfg.get("mlp_training_type") == "end2end":
            w_class = float(clf_cfg.get("mlp_loss_weight", 1.0))
        return cls(
            kl=float(opt_cfg.get("kl_weight", 0.0)),
            laplacian=float(opt_cfg.get("laplacian_weight", 0.0)),
            latent_consistency=float(
                opt_cfg.get("latent_consistency_weight", 0.0)),
            eta1=float(opt_cfg.get("latent_consistency_eta1", 0.5)),
            eta2=float(opt_cfg.get("latent_consistency_eta2", 0.5)),
            classification=w_class,
        )


def coupled_adam(params, lr: float, weight_decay: float
                 ) -> torch.optim.Adam:
    """Adam with *coupled* L2 (the decay is added to the gradient before
    the moments), as the reference's ``torch.optim.Adam(...,
    weight_decay=·)`` and the JAX ``coupled_adam``; ``AdamW`` would decay
    decoupled and change the objective."""
    return torch.optim.Adam(params, lr=float(lr),
                            weight_decay=float(weight_decay))


def compute_losses(model: SDVAE, weights: LossWeights, x_grid: torch.Tensor,
                   region_idx, batch_size: int, eps=None, generator=None,
                   training: bool = True, swap: bool = True, head=None,
                   labels=None, class_weights=None):
    """The losses of one vertex-major grid ``[N, B², 3]`` (or ``[N, B, 3]``
    without the swap): ``(total, metrics)`` keyed by ``LOSS_KEYS``. The
    classification term needs ``head``, a positive weight and ``labels
    [B]``."""
    geom, config = model.geom, model.config
    out, z, mu, logvar = model(x_grid, generator=generator,
                               training=training, eps=eps)
    zero = out.new_zeros(())
    loss_recon = mse_loss(out, x_grid)
    loss_lap = laplacian_loss(geom.laplacian, out) \
        if weights.laplacian > 0 else zero
    loss_kl = kl_divergence_loss(mu, logvar) if config.is_vae else zero
    if swap and weights.latent_consistency > 0:
        fmask = region_feature_mask(config.latent_size,
                                    geom.region_masks.shape[0], region_idx,
                                    device=z.device)
        loss_cons = latent_consistency_loss(z, fmask, batch_size,
                                            weights.eta1, weights.eta2)
    else:
        loss_cons = zero
    loss_class, acc_class = zero, zero
    if head is not None and weights.classification > 0 \
            and labels is not None:
        if swap:
            diag = (batch_size + 1) * torch.arange(batch_size,
                                                   device=z.device)
            z_diag = z.index_select(0, diag)
        else:
            z_diag = z
        logits, _ = head(z_diag)
        loss_class, acc_class = weighted_cross_entropy(
            logits, torch.as_tensor(labels, device=z.device),
            torch.as_tensor(class_weights, dtype=z.dtype, device=z.device))
    loss_tot = (loss_recon
                + weights.kl * loss_kl
                + weights.latent_consistency * loss_cons
                + weights.laplacian * loss_lap
                + weights.classification * loss_class)
    metrics = {"reconstruction": loss_recon, "kl": loss_kl,
               "latent_consistency": loss_cons, "laplacian": loss_lap,
               "classification": loss_class,
               "classification_acc": acc_class, "tot": loss_tot}
    return loss_tot, metrics


def _check(model: SDVAE, weights: LossWeights, swap: bool, head) -> None:
    if weights.classification > 0 and head is None:
        raise ValueError("a classification weight > 0 needs the MLP head "
                         "(models/mlp.py) passed as head=")
    geom = model.geom
    if weights.laplacian > 0 and geom.laplacian is None:
        raise ValueError("laplacian weight > 0 needs a geometry built with "
                         "a Laplacian (SpiralGeometry.from_bundle)")
    if swap and geom.region_masks is None:
        raise ValueError("the swap needs a geometry built with region masks")


def _grid(model: SDVAE, x, batch_size: int, swap: bool, region_idx,
          generator):
    """``[B, N, 3]`` scans → the vertex-major grid and the region."""
    geom = model.geom
    x = torch.as_tensor(x, dtype=torch.float32, device=geom.device)
    x_vm = x.transpose(0, 1)                       # [B, N, 3] → [N, B, 3]
    if not swap:
        return x_vm.contiguous(), 0
    if x.shape[0] != batch_size:
        raise ValueError(f"x holds {x.shape[0]} scans; the swap grid was "
                         f"built for batch_size {batch_size}")
    if region_idx is None:
        region_idx = choose_region(generator, geom.region_masks.shape[0],
                                   device=geom.device)
    return swap_features_dynamic(x_vm, geom.region_masks, region_idx), \
        region_idx


def make_train_step(model: SDVAE, weights: LossWeights,
                    optimizer: torch.optim.Optimizer, batch_size: int,
                    swap: bool = True, head=None, head_optimizer=None):
    """The train step ``step(x [B, N, 3], region_idx=None, eps=None,
    generator=None, labels=None, class_weights=None) → metrics`` (0-d
    tensors on the device, keyed by ``LOSS_KEYS``). The swapped region and
    the reparameterisation noise ``eps [B², Z]`` come from ``generator``
    unless given. With ``head``, a classification weight and
    ``head_optimizer``, the head is updated too, every step (from a zero
    gradient where a batch has no labels, as the JAX step does). The
    gradients stay on the parameters after the step."""
    _check(model, weights, swap, head)
    train_head = (head is not None and head_optimizer is not None
                  and weights.classification > 0)

    def step(x, region_idx=None, eps=None, generator=None, labels=None,
             class_weights=None):
        x_grid, region = _grid(model, x, batch_size, swap, region_idx,
                               generator)
        optimizer.zero_grad(set_to_none=True)
        if train_head:
            head_optimizer.zero_grad(set_to_none=True)
        loss, metrics = compute_losses(model, weights, x_grid, region,
                                       batch_size, eps=eps,
                                       generator=generator, training=True,
                                       swap=swap, head=head, labels=labels,
                                       class_weights=class_weights)
        loss.backward()
        optimizer.step()
        if train_head:
            for p in head.parameters():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            head_optimizer.step()
        return {k: v.detach() for k, v in metrics.items()}

    return step


def make_eval_step(model: SDVAE, weights: LossWeights, batch_size: int,
                   swap: bool = True, head=None):
    """Validation: the same losses, no update, ``z = mu``:
    ``step(x [B, N, 3], region_idx=None, generator=None, labels=None,
    class_weights=None) → metrics``."""
    _check(model, weights, swap, head)

    def step(x, region_idx=None, generator=None, labels=None,
             class_weights=None):
        x_grid, region = _grid(model, x, batch_size, swap, region_idx,
                               generator)
        with torch.no_grad():
            _, metrics = compute_losses(model, weights, x_grid, region,
                                        batch_size, training=False,
                                        swap=swap, head=head, labels=labels,
                                        class_weights=class_weights)
        return metrics

    return step


def run_steps(step, data: torch.Tensor, idx, region_idx=None, eps=None,
              generator=None) -> dict:
    """``S`` steps over the batches ``data[idx[t]]`` (``data [n, N, 3]``,
    ``idx [S, B]``), the metrics averaged over the steps. ``region_idx
    [S]`` and ``eps [S, B², Z]`` are injected per step where given."""
    idx = torch.as_tensor(idx, device=data.device).long()
    sums = None
    for t in range(idx.shape[0]):
        kw = {}
        if region_idx is not None:
            kw["region_idx"] = region_idx[t]
        if eps is not None:
            kw["eps"] = eps[t]
        m = step(data.index_select(0, idx[t]), generator=generator, **kw)
        sums = m if sums is None else {k: sums[k] + m[k] for k in sums}
    return {k: v / idx.shape[0] for k, v in sums.items()}

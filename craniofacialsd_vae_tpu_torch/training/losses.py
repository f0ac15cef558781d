"""Training losses (counterpart of ``training/losses.py``).

The latent-consistency loss works index-free: the swapped region is a
{0,1} feature mask over the latent dims, so the region chosen each step
can be a tensor on the device and the step never waits on the host.
"""

from __future__ import annotations

import torch

from ..ops.sparse import PaddedRowSparse, ell_matmul

__all__ = ["mse_loss", "kl_divergence_loss", "laplacian_loss",
           "latent_consistency_loss", "weighted_cross_entropy",
           "region_feature_mask"]


def mse_loss(prediction: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((prediction - target) ** 2)


def kl_divergence_loss(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """-0.5 Σ_z (1 + logvar - mu² - e^logvar), mean over batch."""
    kl = -0.5 * torch.sum(1 + logvar - mu ** 2 - torch.exp(logvar), dim=-1)
    return torch.mean(kl)


def laplacian_loss(laplacian: PaddedRowSparse,
                   prediction: torch.Tensor) -> torch.Tensor:
    """mean_b Σ_n ‖(L x̂)_n‖₂ / N for vertex-major ``[N, B, 3]``: the
    product is K4 (its backward the capped K4 through the transpose),
    then a per-vertex norm and a sum."""
    n_verts, batch = prediction.shape[0], prediction.shape[1]
    lx = ell_matmul(laplacian, prediction)            # [N, B, 3]
    per_vertex = torch.linalg.vector_norm(lx, dim=-1)  # [N, B]
    return torch.sum(per_vertex) / (n_verts * batch)


def region_feature_mask(latent_size: int, num_regions: int, region_idx,
                        device=None) -> torch.Tensor:
    """{0,1} float mask over the latent dims of region ``region_idx``'s
    contiguous slice; ``region_idx`` may be a 0-d tensor."""
    size = latent_size // num_regions
    idx = torch.as_tensor(region_idx, device=device)
    dims = torch.arange(latent_size, device=idx.device)
    return ((dims >= idx * size) & (dims < (idx + 1) * size)).float()


def latent_consistency_loss(z: torch.Tensor, feature_mask: torch.Tensor,
                            batch_size: int, eta1: float,
                            eta2: float) -> torch.Tensor:
    """Disentanglement margins over the B×B swap grid. ``z [B², Z]``, row
    i·B+j = identity i with donor j's region. With masked squared
    distances d²ᶠ (swapped-region dims) and d²ᵉ (the other dims), for
    the unordered pairs p = (a < b) of ``triu_indices``:

      lg[p, j] = d²ᶠ(z[a,j], z[b,j])   same donor    → should be 0
      dg[p, i] = d²ᶠ(z[i,a], z[i,b])   same identity → should be large
      lr[p, i] = d²ᵉ(z[i,a], z[i,b])   same identity → should be 0
      dr[p, j] = d²ᵉ(z[a,j], z[b,j])   same donor    → should be large

    loss = [Σ max(0, lg-dg+η1) + Σ max(0, lr-dr+η2)] / (B³-B²)."""
    bs = batch_size
    zg = z.reshape(bs, bs, -1)
    fmask = feature_mask.to(z.dtype)
    else_mask = 1.0 - fmask
    ia, ib = torch.triu_indices(bs, bs, offset=1, device=z.device)

    d_id = zg[ia] - zg[ib]                               # [P, B(j), Z]
    lg = torch.sum(d_id ** 2 * fmask, dim=-1)            # [P, B]
    dr = torch.sum(d_id ** 2 * else_mask, dim=-1)

    d_dn = zg[:, ia] - zg[:, ib]                         # [B(i), P, Z]
    dg = torch.sum(d_dn ** 2 * fmask, dim=-1).T          # [P, B]
    lr = torch.sum(d_dn ** 2 * else_mask, dim=-1).T

    hinge_g = torch.clamp(lg - dg + eta1, min=0.0)
    hinge_r = torch.clamp(lr - dr + eta2, min=0.0)
    return (torch.sum(hinge_g) + torch.sum(hinge_r)) / (bs ** 3 - bs ** 2)


def weighted_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                           class_weights: torch.Tensor):
    """Class-weighted cross entropy as ``torch.nn.CrossEntropyLoss(weight)``
    (weighted mean, normalizer Σ w_{y_i}). Returns (loss, accuracy %)."""
    logp = torch.log_softmax(logits, dim=-1)
    labels = labels.long()
    nll = -logp.gather(-1, labels[:, None])[:, 0]
    w = class_weights[labels]
    loss = torch.sum(w * nll) / torch.sum(w)
    acc = 100.0 * torch.mean((logits.argmax(-1) == labels).float())
    return loss, acc

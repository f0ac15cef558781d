"""On-device mini-batch feature swapping (counterpart of ``data/swap.py``).

A batch of B meshes becomes B² meshes where grid element (i, j) is mesh i
with one anatomical region's vertices replaced by mesh j's: one broadcast
and select on the device, so the host only ever ships B meshes per step.
Row i·B+j = identity i, donor j; diagonal rows are the originals.
Operands are vertex-major ``[N, B, 3]``.
"""

from __future__ import annotations

import torch

__all__ = ["swap_features", "swap_features_dynamic", "choose_region"]


def swap_features(x: torch.Tensor, region_mask: torch.Tensor) -> torch.Tensor:
    """Vertex-major ``[N, B, 3]``, ``[N]`` bool → ``[N, B², 3]`` swap grid:
    ``out[:, i·B+j] = where(region_mask, x[:, j], x[:, i])``."""
    xi = x[:, :, None, :]                    # identity  [N, B, 1, 3]
    xj = x[:, None, :, :]                    # donor     [N, 1, B, 3]
    grid = torch.where(region_mask[:, None, None, None], xj, xi)
    return grid.reshape(x.shape[0], -1, x.shape[-1])


def choose_region(generator: torch.Generator | None, num_regions: int,
                  device=None) -> torch.Tensor:
    """The region to swap this step, uniform over ``num_regions`` (the
    reference picks one random region per batch), as a 0-d int64 tensor
    on ``device``."""
    dev = generator.device if generator is not None else device
    r = torch.randint(0, num_regions, (), generator=generator, device=dev)
    return r.to(device) if device is not None else r


def swap_features_dynamic(x: torch.Tensor, region_masks: torch.Tensor,
                          region_idx) -> torch.Tensor:
    """Swap with a region index (an int or a 0-d tensor) into the
    ``[R, N]`` stacked masks."""
    idx = torch.as_tensor(region_idx, device=region_masks.device)
    mask = region_masks.index_select(0, idx.reshape(1).long())[0]
    return swap_features(x, mask)

"""Offline dataset augmentation (counterpart of ``data/augmentation.py``).

Three modes make synthetic meshes from same-class, same-age-group pairs:

  * ``interpolate``     — linear vertex interpolation x1 + t·(x2 − x1);
  * ``spectral_comb``   — a random third of the first 30 spectral
    coefficients taken from x2;
  * ``spectral_interp`` — per-coefficient Gaussian-weighted interpolation
    of the first 30 coefficients.

The spectral modes project onto the Laplacian eigenvectors and rebuild
from that basis: the augmented mesh is the k-mode reconstruction, not
``x + U (s_new − s_orig)``. The products run in full fp32 (TF32 off) on
the device of the eigenvector tensor. Every draw comes from the caller's
numpy ``Generator``, in JAX's order and shapes (``spectral_interpolation``
draws ``(P, k)`` normals though only 30 are used), so both packages leave
the generator in the same state.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.eigh import full_fp32

__all__ = ["interpolate", "spectral_combination", "spectral_interpolation",
           "augment_pairs", "SWAP_UNTIL", "INTERP_UNTIL"]

SWAP_UNTIL = 30        # reference utils.py:249
INTERP_UNTIL = 30      # reference utils.py:264


def interpolate(x1, x2, value):
    """Linear vertex interpolation, batched [..., N, 3], ``value``
    broadcast."""
    return x1 + value * (x2 - x1)


def _as_batch(x) -> np.ndarray:
    """A single [N, 3] mesh as [1, N, 3]."""
    x = np.asarray(x, np.float32)
    return x[None] if x.ndim == 2 else x


def _basis(eigvecs) -> torch.Tensor:
    """The eigenvectors as an fp32 tensor (numpy: on the host)."""
    return torch.as_tensor(eigvecs).to(torch.float32)


def _spectral_mix(u: torch.Tensor, x1, x2, take_x2: np.ndarray,
                  values: np.ndarray | None) -> np.ndarray:
    """U s4 with s1, s2 the projections of x1, x2 and s4 = s2 (``values``
    None) or s1 + values·(s2 − s1) where ``take_x2 [P, k]`` is set, s1
    elsewhere."""
    dev = u.device
    x1 = torch.from_numpy(_as_batch(x1)).to(dev)
    x2 = torch.from_numpy(_as_batch(x2)).to(dev)
    take = torch.from_numpy(take_x2).to(dev)[:, :, None]
    with full_fp32():
        s1 = torch.einsum("nk,pnc->pkc", u, x1)
        s2 = torch.einsum("nk,pnc->pkc", u, x2)
        if values is not None:
            v = torch.from_numpy(values).to(dev)[:, :, None]
            s2 = s1 + v * (s2 - s1)
        s = torch.where(take, s2, s1)
        out = torch.einsum("nk,pkc->pnc", u, s)
    return out.cpu().numpy()


def spectral_combination(eigvecs, x1, x2, rng: np.random.Generator):
    """Swap a random third of the first SWAP_UNTIL coefficients, batched
    over the leading dim."""
    u = _basis(eigvecs)
    p = _as_batch(x1).shape[0]
    selectors = np.zeros((p, u.shape[1]), bool)
    for i in range(p):
        selectors[i, rng.choice(SWAP_UNTIL, SWAP_UNTIL // 3,
                                replace=False)] = True
    return _spectral_mix(u, x1, x2, selectors, None)


def spectral_interpolation(eigvecs, x1, x2, rng: np.random.Generator):
    """Gaussian-weighted (N(0.5, 0.5)) per-coefficient interpolation of
    the first INTERP_UNTIL coefficients."""
    u = _basis(eigvecs)
    p = _as_batch(x1).shape[0]
    k = u.shape[1]
    values = rng.normal(0.5, 0.5, size=(p, k)).astype(np.float32)
    mask = np.zeros((p, k), bool)
    mask[:, :INTERP_UNTIL] = True
    return _spectral_mix(u, x1, x2, mask, values)


def augment_pairs(mode: str, x1: np.ndarray, x2: np.ndarray,
                  rng: np.random.Generator, eigvecs=None):
    """One batch of augmentation pairs → ([P, N, 3], tags)."""
    if mode == "interpolate":
        t = rng.uniform(size=(len(x1), 1, 1)).astype(np.float32)
        out = interpolate(np.asarray(x1, np.float32),
                          np.asarray(x2, np.float32), t)
        tags = [f"_interp{float(v):.2f}" for v in t[:, 0, 0]]
        return np.asarray(out), tags
    if mode == "spectral_comb":
        out = spectral_combination(eigvecs, x1, x2, rng)
        return out, ["_spectral_comb"] * len(x1)
    if mode == "spectral_interp":
        out = spectral_interpolation(eigvecs, x1, x2, rng)
        return out, ["_spectral_interp"] * len(x1)
    raise ValueError(f"unknown augmentation mode {mode}")

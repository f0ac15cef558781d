"""PyTorch/CUDA port of the SD-VAE: the serving path and the training
step.

The package mirrors the module layout of ``craniofacialsd_vae_tpu`` so a
reader can find each function's counterpart there, and imports none of it.
Activations stay vertex-major ``[N, B, C]`` end to end and the parameter
layout is the JAX one (spiral ``w`` ``[L·C_in, C_out]``), so weights carry
across with ``models.params_from_jax``.

Hand-written CUDA kernels for ``sm_90a`` carry the path (``csrc/``, built
and bound by ``kernels.py``): the spiral conv forward (K1) and its weight
gradient (K2-dW), the ELL product of the up-pools, the Laplacian and every
transpose of the backward (K4, with its overflow tiers in the same launch
for a capped table: ``ell_matmul_capped``), and the
rasterizer's z-buffer sweep (K7). Each wrapper runs its plain PyTorch twin
for a CPU tensor and launches the kernel (or raises) for a CUDA tensor.
Entry points take ``device=None``, which means ``"cuda"``.
"""

from .device import resolve_device

__all__ = ["resolve_device"]

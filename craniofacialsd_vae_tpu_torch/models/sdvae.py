"""The swap-disentangled (V)AE over mesh hierarchies (counterpart of
``models/sdvae.py``).

Four encoder blocks (spiral conv → ELU → down-selection), dense heads for
mu and logvar, and the mirrored decoder (dense → [up-pool → spiral conv →
ELU] × 4 → final spiral conv to xyz). Activations are vertex-major
``[N, B, C]``. Each encoder block's down-selection is composed into its
conv's spiral table (``enc_spirals``), so the conv runs only at the
surviving vertices. Parameters keep the JAX layout: spiral ``w``
``[L·C_in, C_out]``, dense ``w`` ``[n_in, n_out]``.

Activation policies (``compute_dtype``), as in the JAX package:
``float32``; ``mixed``, where level 0 (the first conv's 3-channel rows,
the losses, the Laplacian) and the latent heads stay fp32 and every
deeper activation is bf16; ``bfloat16``, the same with level 0 in bf16
too. Parameters, gradients and optimizer state stay fp32, and the
reconstruction is fp32 under every policy: the final conv returns its
fp32 accumulator unrounded, matmul-first (``final_out_gather``, the
default) or gather-first.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops import (PaddedRowSparse, build_pool_operator, build_spiral_op,
                   from_coo, init_spiral_conv, pool, selection_indices,
                   spiral_conv, spiral_conv_out_gather)

__all__ = ["POLICIES", "SDVAEConfig", "SpiralGeometry", "SDVAE",
           "init_sdvae", "reparameterize", "latent_regions",
           "params_from_jax", "params_to_jax"]

POLICIES = ("float32", "mixed", "bfloat16")


@dataclass(frozen=True)
class SDVAEConfig:
    in_channels: int = 3
    out_channels: tuple = (32, 32, 32, 64)
    latent_size: int = 75
    is_vae: bool = True
    pre_z_sigmoid: bool = False
    compute_dtype: str = "float32"
    # under bf16 activations, the final conv runs matmul-first
    # (ops.spiral_conv_out_gather); no effect under "float32"
    final_out_gather: bool = True

    @classmethod
    def from_dict(cls, model_cfg: dict, kl_weight: float) -> "SDVAEConfig":
        return cls(
            in_channels=model_cfg["in_channels"],
            out_channels=tuple(model_cfg["out_channels"]),
            latent_size=model_cfg["latent_size"],
            # a YAML loader may give bare scientific notation as str
            is_vae=float(kl_weight) > 0,
            pre_z_sigmoid=model_cfg.get("pre_z_sigmoid", False),
            compute_dtype=model_cfg.get("compute_dtype", "float32"),
            final_out_gather=model_cfg.get("final_out_gather", True),
        )

    @property
    def activation_dtype(self) -> torch.dtype:
        """Dtype of level-0 activations (the first conv's input)."""
        return torch.bfloat16 if self.compute_dtype == "bfloat16" \
            else torch.float32

    @property
    def deep_dtype(self) -> torch.dtype:
        """Dtype of the activations below level 0 and of the decoder."""
        return torch.bfloat16 \
            if self.compute_dtype in ("bfloat16", "mixed") else torch.float32


@dataclass
class SpiralGeometry:
    """Per-template constants on one device: spiral ops per level, the
    encoder's spiral ops composed with the down-selection, the pooling
    operators, and for training the template Laplacian (with its capped
    transpose) and the region masks."""
    spirals: list                 # SpiralOp per level
    down: list                    # GatherRows / PaddedRowSparse per level
    up: list
    enc_spirals: list             # SpiralOp per level, or None
    laplacian: PaddedRowSparse | None = None
    region_masks: torch.Tensor | None = None     # [R, N] bool

    @classmethod
    def from_bundle(cls, bundle, device=None, laplacian=None,
                    region_masks=None) -> "SpiralGeometry":
        """Build the tables on the host from a ``GeometryBundle`` and move
        them to ``device`` (None: the card). ``laplacian``: the template
        Laplacian as a COO triple ``(rows, cols, vals)`` over level 0;
        ``region_masks``: ``[R, N]`` bool. Where they are not given, both
        come from ``bundle.template`` when the bundle has one (the masks
        where it has regions), as the JAX ``from_bundle`` takes them; a
        bundle without its template needs them handed in
        (``geometry/synthetic.py`` has stand-ins)."""
        dev = resolve_device(device)
        tpl = getattr(bundle, "template", None)
        if tpl is not None:
            if laplacian is None:
                laplacian = tpl.laplacian
            if region_masks is None and tpl.feat_and_cont:
                region_masks = tpl.region_masks()
        enc_spirals = []
        for s, d in zip(bundle.spirals, bundle.down):
            sel = selection_indices(d)
            enc_spirals.append(
                build_spiral_op(np.asarray(s)[sel], n_src=s.shape[0])
                if sel is not None else None)
        n = int(np.asarray(bundle.spirals[0]).shape[0])
        lap = None
        if laplacian is not None:
            rows, cols, vals = laplacian
            lap = from_coo(rows, cols, vals, (n, n))
        masks = None
        if region_masks is not None:
            masks = torch.from_numpy(np.array(region_masks, dtype=bool))
            if masks.ndim != 2 or masks.shape[1] != n:
                raise ValueError(f"region masks {tuple(masks.shape)} are not "
                                 f"[R, {n}]")
        return cls(spirals=[build_spiral_op(s) for s in bundle.spirals],
                   down=[build_pool_operator(d) for d in bundle.down],
                   up=[build_pool_operator(u) for u in bundle.up],
                   enc_spirals=enc_spirals, laplacian=lap,
                   region_masks=masks).to(dev)

    def to(self, device) -> "SpiralGeometry":
        return SpiralGeometry(
            spirals=[s.to(device) for s in self.spirals],
            down=[d.to(device) for d in self.down],
            up=[u.to(device) for u in self.up],
            enc_spirals=[None if e is None else e.to(device)
                         for e in self.enc_spirals],
            laplacian=(None if self.laplacian is None
                       else self.laplacian.to(device)),
            region_masks=(None if self.region_masks is None
                          else self.region_masks.to(device)))

    @property
    def device(self) -> torch.device:
        return self.spirals[0].table.device

    @property
    def num_vertices(self) -> int:
        return self.spirals[0].num_vertices

    @property
    def num_latent_vertices(self) -> int:
        """Vertex count at the deepest pooling level."""
        return self.down[-1].shape[0]


class SpiralConv(nn.Module):
    def __init__(self, params: dict):
        super().__init__()
        self.w = nn.Parameter(params["w"])          # [L·C_in, C_out]
        self.b = nn.Parameter(params["b"])

    def forward(self, x: torch.Tensor, op, out_dtype=None) -> torch.Tensor:
        return spiral_conv({"w": self.w, "b": self.b}, x, op, out_dtype)

    def out_gather(self, x: torch.Tensor, op) -> torch.Tensor:
        """The same conv matmul-first (``spiral_conv_out_gather``)."""
        return spiral_conv_out_gather({"w": self.w, "b": self.b}, x, op)


class Dense(nn.Module):
    def __init__(self, generator: torch.Generator, n_in: int, n_out: int):
        super().__init__()
        limit = float(np.sqrt(6.0 / (n_in + n_out)))
        u = torch.rand((n_in, n_out), generator=generator)
        self.w = nn.Parameter(u * (2 * limit) - limit)    # [n_in, n_out]
        self.b = nn.Parameter(torch.zeros(n_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w + self.b


class SDVAE(nn.Module):
    """The model's parameters plus the geometry it runs on. The geometry
    is not a submodule: build it on the device the model goes to."""

    def __init__(self, config: SDVAEConfig, geom: SpiralGeometry,
                 generator: torch.Generator | None = None):
        super().__init__()
        if config.compute_dtype not in POLICIES:
            raise ValueError(f"compute_dtype {config.compute_dtype!r} is not "
                             f"one of {POLICIES}")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.config = config
        self.geom = geom
        chans = [config.in_channels] + list(config.out_channels)
        n = len(config.out_channels)
        flat = geom.num_latent_vertices * config.out_channels[-1]
        seq = [s.seq_length for s in geom.spirals]

        def conv(c_in, c_out, level):
            return SpiralConv(init_spiral_conv(generator, c_in, c_out,
                                               seq[level]))

        self.en_convs = nn.ModuleList(
            conv(chans[i], chans[i + 1], i) for i in range(n))
        self.mu = Dense(generator, flat, config.latent_size)
        self.de_dense = Dense(generator, config.latent_size, flat)
        # decoder block j runs at level n-1-j; widths mirror the encoder
        self.de_convs = nn.ModuleList(
            conv(config.out_channels[-1] if j == 0
                 else config.out_channels[n - j],
                 config.out_channels[n - 1 - j], n - 1 - j)
            for j in range(n))
        self.final_conv = conv(chans[1], config.in_channels, 0)
        self.logvar = Dense(generator, flat, config.latent_size) \
            if config.is_vae else None

    def encode(self, x: torch.Tensor):
        """Vertex-major ``[N, B, 3]`` → (mu [B, Z], logvar [B, Z] | None)."""
        geom, config = self.geom, self.config
        h = x.to(config.activation_dtype).contiguous()
        for i, conv in enumerate(self.en_convs):
            enc = geom.enc_spirals[i]
            if enc is not None:
                h = F.elu(conv(h, enc))
            else:
                h = pool(F.elu(conv(h, geom.spirals[i])), geom.down[i])
            if i == 0:
                # the policy's boundary: below level 0, deep_dtype
                h = h.to(config.deep_dtype)
        # vertex-major flatten, matching the reference's [B, N, C] flatten;
        # the latent heads run in fp32
        h = h.transpose(0, 1).reshape(h.shape[1], -1).float()
        mu = self.mu(h)
        if self.config.is_vae:
            return mu, self.logvar(h)
        if self.config.pre_z_sigmoid:
            mu = torch.sigmoid(mu)
        return mu, None

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """``[B, Z]`` → vertex-major ``[N, B, 3]``."""
        geom, config = self.geom, self.config
        n = len(self.de_convs)
        h = self.de_dense(z).view(z.shape[0], geom.num_latent_vertices, -1)
        h = h.transpose(0, 1).contiguous()             # vertex-major
        h = h.to(config.deep_dtype)
        for j, conv in enumerate(self.de_convs):
            level = n - 1 - j
            h = pool(h, geom.up[level])
            h = F.elu(conv(h, geom.spirals[level]))
        if config.final_out_gather and h.dtype == torch.bfloat16:
            return self.final_conv.out_gather(h, geom.spirals[0])
        return self.final_conv(h, geom.spirals[0], torch.float32)

    def forward(self, x: torch.Tensor, generator=None,
                training: bool = False, eps: torch.Tensor | None = None):
        """Vertex-major in/out. Returns (reconstruction, z, mu, logvar).
        Training a VAE samples ``z = mu + eps·exp(logvar/2)``, with
        ``eps [B, Z]`` as given or drawn from ``generator``."""
        mu, logvar = self.encode(x)
        if self.config.is_vae and training:
            z = reparameterize(mu, logvar, generator, eps)
        else:
            z = mu
        return self.decode(z), z, mu, logvar


def init_sdvae(config: SDVAEConfig, geom: SpiralGeometry,
               generator: torch.Generator | None = None) -> SDVAE:
    """A model with weights drawn on the host from ``generator`` (so one
    seed gives the same weights on every device), moved to the geometry's
    device."""
    return SDVAE(config, geom, generator).to(geom.device)


def reparameterize(mu: torch.Tensor, logvar: torch.Tensor,
                   generator: torch.Generator | None,
                   eps: torch.Tensor | None = None) -> torch.Tensor:
    """``mu + eps·exp(logvar/2)``, with ``eps`` as given or drawn from
    ``generator`` (None: PyTorch's default generator of mu's device)."""
    std = torch.exp(0.5 * logvar)
    if eps is None:
        dev = mu.device if generator is None else generator.device
        eps = torch.randn(mu.shape, generator=generator, dtype=mu.dtype,
                          device=dev)
    return mu + eps.to(mu.device, mu.dtype) * std


def latent_regions(latent_size: int, region_names: list) -> dict:
    """{region_key: (start, end)}: contiguous equal slices of the latent
    in region order."""
    if latent_size % len(region_names):
        raise ValueError(f"latent size {latent_size} is not divisible by "
                         f"the {len(region_names)} regions")
    size = latent_size // len(region_names)
    return {k: (i * size, (i + 1) * size)
            for i, k in enumerate(region_names)}


def params_from_jax(tree: dict) -> dict:
    """The JAX package's parameter tree (``en_convs``, ``mu``, ``logvar``,
    ``de_dense``, ``de_convs``, ``final_conv``; arrays as numpy) → a
    ``state_dict`` for ``SDVAE``. The layouts are the same, so this only
    renames."""
    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    sd = {}
    for name in ("en_convs", "de_convs"):
        for i, p in enumerate(tree[name]):
            sd[f"{name}.{i}.w"] = t(p["w"])
            sd[f"{name}.{i}.b"] = t(p["b"])
    for name in ("mu", "logvar", "de_dense", "final_conv"):
        if name in tree:
            sd[f"{name}.w"] = t(tree[name]["w"])
            sd[f"{name}.b"] = t(tree[name]["b"])
    return sd


def params_to_jax(state_dict: dict) -> dict:
    """An ``SDVAE`` ``state_dict`` → the JAX package's parameter tree (lists
    of ``{"w", "b"}`` for the convs, ``{"w", "b"}`` for the dense layers;
    float32 numpy arrays), the inverse of ``params_from_jax``."""
    def a(t):
        return t.detach().cpu().numpy().astype(np.float32, copy=True)

    tree = {}
    for name in ("en_convs", "de_convs"):
        n = len({k.split(".")[1] for k in state_dict
                 if k.startswith(name + ".")})
        tree[name] = [{"w": a(state_dict[f"{name}.{i}.w"]),
                       "b": a(state_dict[f"{name}.{i}.b"])}
                      for i in range(n)]
    for name in ("mu", "logvar", "de_dense", "final_conv"):
        if f"{name}.w" in state_dict:
            tree[name] = {"w": a(state_dict[f"{name}.w"]),
                          "b": a(state_dict[f"{name}.b"])}
    return tree

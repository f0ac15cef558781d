"""Spiral convolution, vertex-major (counterpart of ``ops/spiral_conv.py``).

For each output vertex the features of its spiral neighbourhood (L
indices) go through one dense projection:
``out[m] = b + Σ_l x[S[m, l]] @ W_l``, with the weight stored
``[L·C_in, C_out]`` as in the JAX package and read as ``[L, C_in, C_out]``.

``spiral_conv`` is a ``torch.autograd.Function`` in the form of the JAX
custom VJP (``_spiral_conv_core`` / ``_score_bwd``):

- forward: kernel K1 (fp32): for a CUDA tensor it launches
  ``csrc/spiral_conv.cu`` (tensor cores in 3xTF32, or a narrow kernel for
  C_out < 8), which gathers the spiral rows into shared memory or
  registers and never writes the ``[M, B, L·C]`` concatenation; for a CPU
  tensor it runs the plain twin, the fp32 branch of ``_spiral_conv_core``;
- backward: ``dx`` through the combined capped transposes (one batched
  product ``dy @ W_gᵀ`` per column group, then ``CappedEll.apply``: K4
  with the overflow tiers landed in the same launch), plus ``dy @ W_iᵀ``
  for identity columns; ``dW`` by kernel K2-dW
  (``csrc/spiral_conv_dw.cu``, tensor cores in 3xTF32), which recomputes
  the gathers; ``db = Σ dy``. On the host the same steps run with the
  plain twins.

bf16 activations (the ``mixed`` and ``bfloat16`` policies) keep the JAX
package's rounding points: ``w`` and ``b`` are cast to bf16; the forward
(K1-bf16, ``csrc/spiral_conv_bf16.cu``) accumulates ``b`` and the L
position products in fp32 and rounds once; the backward forms ``dg`` and
the identity columns' products in bf16, gathers ``dg`` with the capped
K4-bf16, sums ``dW`` (K2-dW-bf16) and ``db`` in fp32 and rounds each
once. Autograd through the casts hands fp32 gradients to the fp32
parameters. The final decoder conv returns fp32: gather-first through
``_SpiralConvF32Out`` (K3a: the accumulator unrounded; its backward
rounds ``dy`` to bf16 once), or matmul-first through
``spiral_conv_out_gather`` (one fp32 product of the bf16 values, then
kernel K3b's gather-sum, ``csrc/out_gather_sum.cu``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels
from .sparse import (CappedEll, GatherRows, capped_ell, gather_op_from_idx,
                     gather_rows)

__all__ = ["SpiralOp", "build_spiral_op", "init_spiral_conv", "spiral_conv",
           "spiral_conv_plain", "spiral_conv_dw", "spiral_conv_dw_plain",
           "spiral_conv_dw_chunked_plain", "spiral_conv_out_gather",
           "out_gather_sum_plain"]


@dataclass
class SpiralOp:
    """Per-level spiral structure.

    ``table`` is the ``[M, L]`` int32 spiral table the kernel reads;
    ``gathers`` holds one GatherRows per position (None for an identity
    position, whose rows are ``x`` itself), and ``inv_tables`` the combined
    transposes over the flat ``(l, m)`` index space that a backward pass
    reads, one per column group."""
    table: torch.Tensor            # [M, L] int32
    gathers: list                  # L × (GatherRows | None)
    inv_tables: list               # per column group: CappedEll
    group_cols: tuple              # per group: tuple of spiral positions
    identity_cols: tuple           # spiral positions that are the identity
    seq_length: int
    n_src: int                     # rows of the input (≠ M when composed)

    @property
    def num_vertices(self) -> int:
        return int(self.table.shape[0])

    def to(self, device) -> "SpiralOp":
        return SpiralOp(
            table=self.table.to(device),
            gathers=[None if g is None else g.to(device)
                     for g in self.gathers],
            inv_tables=[t.to(device) for t in self.inv_tables],
            group_cols=self.group_cols, identity_cols=self.identity_cols,
            seq_length=self.seq_length, n_src=self.n_src)


def build_spiral_op(spirals: np.ndarray,
                    bwd_group_size: int | None = None,
                    n_src: int | None = None) -> SpiralOp:
    """Host-side: ``[M, L]`` spiral table → gather operators and the
    combined transpose tables. ``n_src`` is the source vertex count of a
    table composed with a down-selection (rows M < n_src); identity
    positions exist only when ``n_src == M``."""
    spirals = np.asarray(spirals)
    m, l = spirals.shape
    n = m if n_src is None else n_src
    if spirals.size and (spirals.min() < 0 or spirals.max() >= n):
        raise ValueError(f"spiral index out of range [0, {n})")
    if bwd_group_size is None:
        bwd_group_size = l

    arange = np.arange(m)
    identity_cols = tuple(
        i for i in range(l)
        if n == m and np.array_equal(spirals[:, i], arange))
    other_cols = [i for i in range(l) if i not in identity_cols]

    inv_tables: list[CappedEll] = []
    group_cols = []
    for s in range(0, len(other_cols), bwd_group_size):
        cols = other_cols[s:s + bwd_group_size]
        # vertex m ← flat positions p = (l_local)·M + m over this group
        targets = spirals[:, cols].T.reshape(-1)
        positions = np.arange(len(cols) * m)
        inv_tables.append(capped_ell(targets, positions,
                                     np.ones(len(cols) * m), n))
        group_cols.append(tuple(cols))
    gathers: list[GatherRows | None] = [
        None if i in identity_cols else gather_op_from_idx(spirals[:, i], n)
        for i in range(l)]
    return SpiralOp(table=torch.from_numpy(spirals.astype(np.int32)),
                    gathers=gathers, inv_tables=inv_tables,
                    group_cols=tuple(group_cols),
                    identity_cols=identity_cols, seq_length=l, n_src=n)


def init_spiral_conv(generator: torch.Generator, in_channels: int,
                     out_channels: int, seq_length: int) -> dict:
    """Xavier-uniform weight ``[L·C_in, C_out]`` and a zero bias, drawn
    on the host from ``generator`` (reference model.py:23-25 init)."""
    fan_in = in_channels * seq_length
    limit = float(np.sqrt(6.0 / (fan_in + out_channels)))
    u = torch.rand((fan_in, out_channels), generator=generator,
                   dtype=torch.float32)
    return {"w": u * (2 * limit) - limit,
            "b": torch.zeros(out_channels, dtype=torch.float32)}


def spiral_conv_plain(w_l: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
                      op: SpiralOp, out_dtype: torch.dtype | None = None
                      ) -> torch.Tensor:
    """Plain twin of K1: ``out = b``, then ``out + x_l @ W_l`` for
    l = 0…L−1 (the fp32 branch of the JAX ``_spiral_conv_core``). bf16
    x, W and b (twin of K1-bf16 and K3a, its bf16 branch and
    ``_spiral_conv_core_f32out``): the same sums in fp32 from ``b``, the
    products of the bf16 values in fp32, rounded to bf16 once, or with
    ``out_dtype`` float32 returned unrounded."""
    if x.dtype == torch.bfloat16:
        out = b.float()
        for i, g in enumerate(op.gathers):
            xi = x if g is None else gather_rows(g, x)
            out = out + xi.float() @ w_l[i].float()
        return out if out_dtype == torch.float32 else out.to(x.dtype)
    out = b
    for i, g in enumerate(op.gathers):
        xi = x if g is None else gather_rows(g, x)
        out = out + xi @ w_l[i]
    return out


def spiral_conv_dw_plain(x: torch.Tensor, table: torch.Tensor,
                         dy: torch.Tensor) -> torch.Tensor:
    """Plain twin of K2-dW: ``dW[l] = x[table[:, l]]ᵀ dy`` over the
    ``M·B`` rows, one gather and one matmul per position (the fp32 branch
    of the JAX ``_score_bwd``'s dW). bf16 x and dy: the same in fp32,
    rounded to bf16 once."""
    if x.dtype == torch.bfloat16:
        return spiral_conv_dw_plain(x.float(), table, dy.float()).to(x.dtype)
    c_in, c_out = x.shape[-1], dy.shape[-1]
    d2 = dy.reshape(-1, c_out)
    return torch.stack([
        x.index_select(0, table[:, i]).reshape(-1, c_in).T @ d2
        for i in range(table.shape[1])])


_DW_SUM_RUNS = 8        # csrc/spiral_conv_dw.cu's kSumWarps


def spiral_conv_dw_chunked_plain(x: torch.Tensor, table: torch.Tensor,
                                 dy: torch.Tensor,
                                 plan: kernels.DwPlan | kernels.DwBf16Plan
                                 ) -> torch.Tensor:
    """K2-dW's sums in the order of ``plan``'s chunks: each chunk's
    partial dW over its ``tiles_per_chunk · tmv`` vertices, then, as the
    kernel's second pass adds them, eight runs (chunks w, w + 8, … in
    order) and the eight run sums in run order. A ``DwBf16Plan`` (bf16 x
    and dy): each chunk's fp32 partial over its ``chunk_v`` vertices, the
    partials added in chunk order, rounded to bf16 once."""
    if isinstance(plan, kernels.DwBf16Plan):
        x32, d32 = x.float(), dy.float()
        out = None
        for m0 in range(0, table.shape[0], plan.chunk_v):
            part = spiral_conv_dw_plain(x32, table[m0:m0 + plan.chunk_v],
                                        d32[m0:m0 + plan.chunk_v])
            out = part if out is None else out + part
        return out.to(x.dtype)
    step = plan.tiles_per_chunk * plan.tmv
    parts = [spiral_conv_dw_plain(x, table[m0:m0 + step], dy[m0:m0 + step])
             for m0 in range(0, table.shape[0], step)]
    runs = [torch.zeros_like(parts[0]) for _ in range(_DW_SUM_RUNS)]
    for c, part in enumerate(parts):
        runs[c % _DW_SUM_RUNS] = runs[c % _DW_SUM_RUNS] + part
    out = runs[0]
    for run in runs[1:]:
        out = out + run
    return out


def spiral_conv_dw(x: torch.Tensor, table: torch.Tensor,
                   dy: torch.Tensor) -> torch.Tensor:
    """``dW [L, C_in, C_out]`` of the spiral conv, in x's dtype: kernel
    K2-dW (K2-dW-bf16 for bf16) on the card, its plain twin on the
    host."""
    if not x.is_cuda:
        return spiral_conv_dw_plain(x, table, dy)
    return kernels.spiral_conv_dw(x, table, dy)


class _SpiralConv(torch.autograd.Function):
    """``out = b + Σ_l x[S[:, l]] @ W_l`` with the JAX ``_score_bwd``
    backward (see the module docstring), in x's dtype."""

    @staticmethod
    def forward(ctx, w_l, b, x, op):
        ctx.op = op
        ctx.save_for_backward(w_l, x)
        if not x.is_cuda:
            return spiral_conv_plain(w_l, b, x, op)
        return kernels.spiral_conv_fwd(x, op.table, w_l, b)

    @staticmethod
    def backward(ctx, dy):
        w_l, x = ctx.saved_tensors
        op = ctx.op
        dy = dy.contiguous()
        dw_l = db = dx = None
        if ctx.needs_input_grad[2]:
            # dg [g, M, B, C_in] = dy @ W_gᵀ, one batched product per
            # group, l-major as the tables' flat positions; the combined
            # transpose gathers it onto x's rows
            m, bsz, c_out = dy.shape
            d2 = dy.reshape(m * bsz, c_out)
            for table, cols in zip(op.inv_tables, op.group_cols):
                w_g = w_l[list(cols)].transpose(1, 2)
                dg = torch.bmm(d2.expand(len(cols), -1, -1), w_g)
                part = table.apply(dg.view(len(cols) * m, bsz, -1))
                dx = part if dx is None else dx + part
            for i in op.identity_cols:
                part = dy @ w_l[i].T
                dx = part if dx is None else dx + part
        if ctx.needs_input_grad[0]:
            dw_l = spiral_conv_dw(x, op.table, dy)
        if ctx.needs_input_grad[1]:
            # bf16: summed in fp32, rounded once
            db = dy.sum(dim=(0, 1), dtype=torch.float32).to(dy.dtype)
        return dw_l, db, dx, None


class _SpiralConvF32Out(torch.autograd.Function):
    """K3a: the bf16 conv's fp32 accumulator, unrounded (JAX
    ``_spiral_conv_core_f32out``); the backward rounds the fp32 ``dy`` to
    bf16 once and runs the bf16 backward."""

    @staticmethod
    def forward(ctx, w_l, b, x, op):
        ctx.op = op
        ctx.save_for_backward(w_l, x)
        if not x.is_cuda:
            return spiral_conv_plain(w_l, b, x, op, torch.float32)
        return kernels.spiral_conv_fwd(x, op.table, w_l, b,
                                       out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, dy):
        return _SpiralConv.backward(ctx, dy.to(ctx.saved_tensors[1].dtype))


def _check_rows(x: torch.Tensor, op: SpiralOp) -> None:
    if x.shape[0] != op.n_src:
        raise ValueError(f"x has {x.shape[0]} rows; the spiral table "
                         f"reads {op.n_src}")


def spiral_conv(params: dict, x: torch.Tensor, op: SpiralOp,
                out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Vertex-major spiral conv ``[N_src, B, C_in] → [M, B, C_out]`` in
    x's dtype (fp32 or bf16; ``w`` and ``b`` are cast to it),
    differentiable: K1 forward, the transposes (capped K4) and K2-dW
    backward on the card; the plain twins on the host. ``out_dtype``
    float32 with bf16 x: the fp32 accumulator unrounded (K3a)."""
    _check_rows(x, op)
    w = params["w"].to(x.dtype)
    b = params["b"].to(x.dtype)
    w_l = w.reshape(op.seq_length, x.shape[-1], w.shape[-1])
    if out_dtype == torch.float32 and x.dtype == torch.bfloat16:
        return _SpiralConvF32Out.apply(w_l, b, x, op)
    return _SpiralConv.apply(w_l, b, x, op)


def out_gather_sum_plain(u: torch.Tensor, table: torch.Tensor,
                         b: torch.Tensor) -> torch.Tensor:
    """Plain twin of K3b: ``out = b``, then ``out + u_l[table[:, l]]`` for
    l = 0…L−1 in fp32, for ``u [N, B, L, O]``."""
    out = b
    for i in range(table.shape[1]):
        out = out + u[:, :, i].index_select(0, table[:, i])
    return out


class _OutGatherSum(torch.autograd.Function):
    """``out = b + Σ_l u_l[S[:, l]]`` (K3b on the card), backward as JAX's
    autodiff of ``spiral_conv_out_gather`` gives it: each position's
    ``du_l`` through that gather's own capped transpose (fp32 K4), the
    identity position's ``dout`` itself, ``db = Σ dout``."""

    @staticmethod
    def forward(ctx, u, b, op):
        ctx.op = op
        if not u.is_cuda:
            return out_gather_sum_plain(u, op.table, b)
        return kernels.out_gather_sum(u, op.table, b)

    @staticmethod
    def backward(ctx, dout):
        dout = dout.contiguous()
        du = db = None
        if ctx.needs_input_grad[0]:
            du = torch.stack([dout if g is None else g.transpose.apply(dout)
                              for g in ctx.op.gathers], dim=2)
        if ctx.needs_input_grad[1]:
            db = dout.sum(dim=(0, 1))
        return du, db, None


def spiral_conv_out_gather(params: dict, x: torch.Tensor,
                           op: SpiralOp) -> torch.Tensor:
    """Matmul-first spiral conv (JAX ``spiral_conv_out_gather``): ``u =
    x @ W_l`` for every position in one plain product (fp32, from bf16 x
    and W: the fp32 copies of the bf16 values), laid out ``[N, B, L,
    C_out]``, then ``out = b + Σ_l u_l[S[:, l]]`` in fp32 (K3b on the
    card). ``b`` stays fp32; the output is fp32 for bf16 x."""
    _check_rows(x, op)
    acc = torch.float32 if x.dtype == torch.bfloat16 else x.dtype
    n, bsz, c_in = x.shape
    w = params["w"].to(x.dtype).to(acc)                 # [L·C_in, C_out]
    c_out = w.shape[-1]
    w_cat = w.reshape(op.seq_length, c_in, c_out).transpose(0, 1).reshape(
        c_in, op.seq_length * c_out)
    u = (x.reshape(n * bsz, c_in).to(acc) @ w_cat).view(
        n, bsz, op.seq_length, c_out)
    return _OutGatherSum.apply(u, params["b"].to(acc), op)

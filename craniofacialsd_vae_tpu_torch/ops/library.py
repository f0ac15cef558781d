"""The serving kernels as ``torch.library`` custom ops (namespace
``cfsdvae``).

The forwards of the spiral conv (``_SpiralConv``, ``_SpiralConvF32Out``),
the matmul-first final conv's gather-sum (``_OutGatherSum``) and the ELL
product (``sparse.ell_matmul_raw``) call these ops, so that PyTorch's
dispatcher picks the implementation from the device of the inputs:

- ``spiral_conv_fwd``: K1 (tc, narrow, narrow_tile), K1-bf16 and K3a
  (``kernels.spiral_conv_fwd``) on the card, ``spiral_conv_table_plain``
  on the host;
- ``ell_matmul_fwd``: K4 and K4-bf16 (``kernels.ell_matmul_fwd``) on the
  card, ``ell_matmul_plain`` on the host;
- ``out_gather_sum``: K3b (``kernels.out_gather_sum``) on the card,
  ``out_gather_sum_plain`` on the host.

Only CPU and CUDA have implementations, so a tensor on any other device
raises; one op call is one wrapper call, so the launch counts are the
wrappers'. Each op returns a fresh tensor. Its fake implementation gives
the output's shape and dtype to tracers (``torch.export``): it answers
fake tensors only, so a plain ``meta`` tensor raises too.

The signatures hold tensors, bools and ints: a ``SpiralOp``'s vertex
tiles (``SpiralTiles``) go in as their five int32 tensors and two sizes
(``spiral_conv.tile_args``; None and 0 for no tiles), and the CUDA
implementation packs them back, so that the planner runs inside it on
the real shapes and pointers, as the wrapper does. An exported program
holds calls of these ops, so loading one needs this module imported
(``export.OPS_MODULE``).

The ops are defined with ``torch.library.Library`` (a schema, then one
implementation for each dispatch key), not ``torch.library.custom_op``,
whose Python autograd layer adds host time to every eager call. No
autograd formula is registered: the forwards call the ops inside
``torch.autograd.Function``s, whose backwards are the port's own.
"""

import torch
from torch._subclasses.fake_tensor import FakeTensor

from .. import kernels
from .sparse import ell_matmul_plain
from .spiral_conv import (SpiralTiles, out_gather_sum_plain,
                          spiral_conv_table_plain)

__all__ = ["NAMESPACE", "spiral_conv_fwd", "ell_matmul_fwd",
           "out_gather_sum"]

NAMESPACE = "cfsdvae"
_LIB = torch.library.Library(NAMESPACE, "DEF")
_LIB.define("spiral_conv_fwd(Tensor x, Tensor table, Tensor w_l, Tensor b, "
            "bool f32_out, Tensor? verts, Tensor? starts, Tensor? src, "
            "Tensor? src_off, Tensor? local, int max_rows, int max_verts) "
            "-> Tensor")
_LIB.define("ell_matmul_fwd(Tensor cols, Tensor vals, Tensor x) -> Tensor")
_LIB.define("out_gather_sum(Tensor u, Tensor table, Tensor b) -> Tensor")


def _register(name: str, cpu, cuda, fake) -> None:
    _LIB.impl(name, cpu, "CPU")
    _LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)


def _traced_only(op: str, t: torch.Tensor) -> None:
    """A fake implementation answers tracers; a plain meta tensor (no
    CPU or CUDA implementation) raises."""
    if not isinstance(t, FakeTensor):
        raise NotImplementedError(
            f"{NAMESPACE}::{op} runs on cpu and cuda tensors only; got "
            f"{t.device}")


def _spiral_conv_cpu(x, table, w_l, b, f32_out, verts, starts, src, src_off,
                     local, max_rows, max_verts):
    return spiral_conv_table_plain(w_l, b, x, table,
                                   torch.float32 if f32_out else None)


def _spiral_conv_cuda(x, table, w_l, b, f32_out, verts, starts, src,
                      src_off, local, max_rows, max_verts):
    tiles = None if verts is None else SpiralTiles(
        verts, starts, src, src_off, local, max_rows, max_verts)
    return kernels.spiral_conv_fwd(
        x, table, w_l, b, out_dtype=torch.float32 if f32_out else None,
        tiles=tiles)


def _spiral_conv_fake(x, table, w_l, b, f32_out, *tiles):
    _traced_only("spiral_conv_fwd", x)
    return x.new_empty((table.shape[0], x.shape[1], w_l.shape[2]),
                       dtype=torch.float32 if f32_out else x.dtype)


def _ell_matmul_cpu(cols, vals, x):
    return ell_matmul_plain(cols, vals, x)


def _ell_matmul_cuda(cols, vals, x):
    # the packed [N, D] view (a copy where x's rows are not contiguous)
    out = kernels.ell_matmul_fwd(cols, vals, x.reshape(x.shape[0], -1))
    return out.view(cols.shape[0], *x.shape[1:])


def _ell_matmul_fake(cols, vals, x):
    _traced_only("ell_matmul_fwd", x)
    return x.new_empty((cols.shape[0], *x.shape[1:]))


def _out_gather_sum_cpu(u, table, b):
    # contiguous, as the kernel writes it
    return out_gather_sum_plain(u, table, b).contiguous()


def _out_gather_sum_cuda(u, table, b):
    return kernels.out_gather_sum(u, table, b)


def _out_gather_sum_fake(u, table, b):
    _traced_only("out_gather_sum", u)
    return u.new_empty((table.shape[0], u.shape[3], u.shape[1]))


_register("spiral_conv_fwd", _spiral_conv_cpu, _spiral_conv_cuda,
          _spiral_conv_fake)
_register("ell_matmul_fwd", _ell_matmul_cpu, _ell_matmul_cuda,
          _ell_matmul_fake)
_register("out_gather_sum", _out_gather_sum_cpu, _out_gather_sum_cuda,
          _out_gather_sum_fake)

#: ``spiral_conv_fwd(x, table, w_l, b, f32_out, verts, starts, src,
#: src_off, local, max_rows, max_verts)``: ``out[m] = b + Σ_l
#: x[table[m, l]] @ w_l[l]``, ``[M, B, C_out]`` in x's dtype, or fp32
#: with ``f32_out`` (bf16 x: K3a's accumulator unrounded)
spiral_conv_fwd = torch.ops.cfsdvae.spiral_conv_fwd.default
#: ``ell_matmul_fwd(cols, vals, x)``: ``out[m] = Σ_k vals[m, k] ·
#: x[cols[m, k]]`` for vertex-major ``x [N, ...]``, ``[M, ...]`` in x's
#: dtype
ell_matmul_fwd = torch.ops.cfsdvae.ell_matmul_fwd.default
#: ``out_gather_sum(u, table, b)``: ``out[m, :, o] = b[o] + Σ_l u[l, o,
#: table[m, l], :]`` in fp32 for the position-major ``u [L, O, N, B]``;
#: ``[M, B, O]``
out_gather_sum = torch.ops.cfsdvae.out_gather_sum.default

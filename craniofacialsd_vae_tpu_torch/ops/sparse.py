"""Static sparse formats (counterpart of ``ops/sparse.py``).

Every sparse operator of the model (pooling selections, barycentric
up-samplers) has a fixed structure and a small bounded number of nonzeros
per row, so it is stored in a padded row-sparse ("ELL") layout: dense
``[M, K]`` index and value arrays, padded entries pointing at row 0 with
weight 0. Operands are vertex-major ``[N, ...]``; the trailing dims are
packed into one ``[N, B·C]`` row so that each gathered row is contiguous.

The host builders give tables equal element by element to the JAX
builders'. Each operator keeps its (capped) transpose, and the backward
pass is a gather through it, never a scatter: ``ell_matmul`` and
``gather_rows`` are ``torch.autograd.Function``s whose backward is
``transpose.apply(dy)``, as the JAX custom VJPs ``_ell_bwd`` and
``_gather_rows_bwd`` are.

``ell_matmul_raw`` is kernel K4 (the custom op
``cfsdvae::ell_matmul_fwd`` of ``ops/library.py``) and ``CappedEll.apply``
of a table with overflow tiers the fused kernel ``ell_matmul_capped`` (K4
with the tiers landed in the same launch): for a CUDA tensor each
launches ``csrc/ell_matmul.cu`` (``csrc/ell_matmul_bf16.cu`` for bf16
rows), for a CPU tensor it runs its plain twin.

bf16 rows keep the JAX package's rounding points: the values are rounded
to bf16, the products and their sum are formed in fp32 and rounded once
(what XLA's bf16 ``einsum`` gives on the CPU, checked by
``tests/test_torch_mixed.py``), each overflow tier's sum is rounded, and
a tier lands with a bf16 add (``out.at[o_rows].add``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels

__all__ = ["PaddedRowSparse", "CappedEll", "GatherRows", "capped_ell",
           "from_coo", "gather_op_from_idx", "ell_matmul", "ell_matmul_raw",
           "ell_matmul_plain", "ell_tier_add_plain", "ell_matmul_capped_plain",
           "tier_links", "gather_rows"]


def _check_index_range(idx: np.ndarray, n: int, what: str) -> None:
    """Kernels read the tables without bounds checks: validate on the
    host once, when a table is built."""
    if idx.size and (idx.min() < 0 or idx.max() >= n):
        raise ValueError(f"{what} index out of range [0, {n})")


def _pad_rows(rows, cols, vals, m):
    counts = np.bincount(rows, minlength=m)
    k = max(int(counts.max()) if len(counts) else 1, 1)
    pad_cols = np.zeros((m, k), dtype=np.int32)
    pad_vals = np.zeros((m, k), dtype=np.float32)
    # entries in row order, each at its ordinal within its row
    order = np.argsort(rows, kind="stable")
    r = np.asarray(rows)[order]
    slot = np.arange(len(r)) - (np.cumsum(counts) - counts)[r]
    pad_cols[r, slot] = np.asarray(cols)[order]
    pad_vals[r, slot] = np.asarray(vals)[order]
    return pad_cols, pad_vals


def tier_links(m: int, tiers) -> tuple:
    """The walk the fused kernel takes over a table's overflow tiers:
    ``link0 [M]``, each main row's slot in tier 1 (−1 if none), then for
    each tier ``t`` its rows' slots in tier ``t + 1`` (all −1 for the
    last), int32 on the tiers' device. Raises unless each tier's rows are
    sorted, unique and among the previous tier's (``capped_ell`` builds
    them so)."""
    prev = torch.arange(m, device=tiers[0][0].device)
    links = []
    for t, (rows, _, _) in enumerate(tiers):
        rows = rows.long()
        if rows.numel() and (bool((rows[1:] <= rows[:-1]).any())
                             or int(rows.min()) < 0):
            raise ValueError(f"tier {t}: rows must be sorted and unique")
        pos = torch.searchsorted(prev, rows)
        if bool((pos >= len(prev)).any()) or not torch.equal(
                prev[pos.clamp(max=max(len(prev) - 1, 0))], rows):
            raise ValueError(f"tier {t}: rows must be among the previous "
                             "tier's")
        link = torch.full((len(prev),), -1, dtype=torch.int32,
                          device=prev.device)
        link[pos] = torch.arange(len(rows), dtype=torch.int32,
                                 device=prev.device)
        links.append(link)
        prev = rows
    links.append(torch.full((len(prev),), -1, dtype=torch.int32,
                            device=prev.device))
    return tuple(links)


@dataclass
class CappedEll:
    """ELL matrix with the per-row nnz capped; the tail of high-degree
    rows lives in small overflow tiers ``(rows [R], cols [R, K_t],
    vals [R, K_t])`` added at their (unique) rows, and ``links`` is their
    walk (``tier_links``, built here from the tiers)."""
    cols: torch.Tensor             # [M, K_cap] int32
    vals: torch.Tensor             # [M, K_cap] float32
    tiers: tuple = ()
    links: tuple = ()

    def __post_init__(self):
        if self.tiers and not self.links:
            self.links = tier_links(self.cols.shape[0], self.tiers)

    def to(self, device) -> "CappedEll":
        return CappedEll(self.cols.to(device), self.vals.to(device),
                         tuple(tuple(t.to(device) for t in tier)
                               for tier in self.tiers),
                         tuple(t.to(device) for t in self.links))

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """The main table plus each overflow tier at its rows: on the card
        one launch (K4 where there are no tiers, else ``ell_matmul_capped``,
        which lands them in the same launch); on the host K4's twin, then
        each tier added in place (``ell_tier_add_plain``), which the fused
        kernel equals bit for bit."""
        if not x.is_cuda:
            out = ell_matmul_plain(self.cols, self.vals, x)
            for o_rows, o_cols, o_vals in self.tiers:
                ell_tier_add_plain(o_rows, o_cols, o_vals, x, out)
            return out
        if not self.tiers:
            return ell_matmul_raw(self.cols, self.vals, x)
        out = kernels.ell_matmul_capped(self.cols, self.vals, self.tiers,
                                        self.links,
                                        x.reshape(x.shape[0], -1))
        return out.view(self.cols.shape[0], *x.shape[1:])


_SCATTER_PENALTY_ROWS = 4        # one scattered row ≈ 4 gathered rows


def _optimal_cap(counts: np.ndarray, m: int, k_max: int) -> int:
    """K minimizing modeled gathered-row traffic: m·K main rows plus a
    single-tier overflow model (R rows padded to k_max−K, each landing
    via a scatter-add)."""
    best_cost, best_k = m * k_max, k_max
    for k in range(1, k_max):
        r = int((counts > k).sum())
        cost = m * k + r * (k_max - k + _SCATTER_PENALTY_ROWS)
        if cost < best_cost:
            best_cost, best_k = cost, k
    return best_k


def capped_ell(rows, cols, vals, m, max_tiers: int = 3) -> CappedEll:
    """Host-side: COO → CappedEll with the traffic-optimal cap and up to
    ``max_tiers`` overflow tiers."""
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    vals = np.asarray(vals)
    order = np.argsort(rows, kind="stable")
    rows, cols, vals = rows[order], cols[order], vals[order]
    counts = np.bincount(rows, minlength=m)
    if len(rows) == 0:
        pc, pv = _pad_rows(rows, cols, vals, m)
        return CappedEll(torch.from_numpy(pc), torch.from_numpy(pv), ())
    # ordinal of each entry within its (sorted) row
    start = np.cumsum(counts) - counts
    rank = np.arange(len(rows)) - start[rows]

    k_max = int(counts.max())
    k = _optimal_cap(counts, m, k_max)
    main = rank < k
    pc, pv = _pad_rows(rows[main], cols[main], vals[main], m)

    tiers = []
    rem = ~main
    rem_rows, rem_cols = rows[rem], cols[rem]
    rem_vals, rem_rank = vals[rem], rank[rem] - k
    while len(rem_rows):
        u, inv = np.unique(rem_rows, return_inverse=True)
        t_counts = np.bincount(inv)
        t_kmax = int(t_counts.max())
        tk = (_optimal_cap(t_counts, len(u), t_kmax)
              if len(tiers) < max_tiers - 1 else t_kmax)
        tm = rem_rank < tk
        tc, tv = _pad_rows(inv[tm], rem_cols[tm], rem_vals[tm], len(u))
        tiers.append((torch.from_numpy(u.astype(np.int32)),
                      torch.from_numpy(tc), torch.from_numpy(tv)))
        keep = ~tm
        rem_rows, rem_cols = rem_rows[keep], rem_cols[keep]
        rem_vals, rem_rank = rem_vals[keep], rem_rank[keep] - tk
    return CappedEll(torch.from_numpy(pc), torch.from_numpy(pv), tuple(tiers))


@dataclass
class PaddedRowSparse:
    """ELL-format sparse matrix with its (capped) transpose:
    ``out[m] = Σ_k vals[m, k] · x[cols[m, k]]``."""
    cols: torch.Tensor             # [M, K] int32
    vals: torch.Tensor             # [M, K] float32
    n_cols: int                    # logical source dimension
    transpose: CappedEll | None = None

    @property
    def shape(self):
        return (self.cols.shape[0], self.n_cols)

    def to(self, device) -> "PaddedRowSparse":
        return PaddedRowSparse(
            self.cols.to(device), self.vals.to(device), self.n_cols,
            None if self.transpose is None else self.transpose.to(device))


def from_coo(rows, cols, vals, shape, with_transpose: bool = True
             ) -> PaddedRowSparse:
    """Host-side: COO arrays → padded layout plus its capped transpose."""
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    vals = np.asarray(vals)
    m, n = shape
    _check_index_range(rows, m, "row")
    _check_index_range(cols, n, "column")
    pad_cols, pad_vals = _pad_rows(rows, cols, vals, m)
    transpose = capped_ell(cols, rows, vals, n) if with_transpose else None
    return PaddedRowSparse(cols=torch.from_numpy(pad_cols),
                           vals=torch.from_numpy(pad_vals), n_cols=n,
                           transpose=transpose)


def ell_matmul_plain(cols: torch.Tensor, vals: torch.Tensor,
                     x: torch.Tensor) -> torch.Tensor:
    """Plain twin of K4 over the packed view, in the kernel's order:
    ``vals[:, 0]·x[cols[:, 0]]`` first, then the other k in ascending
    order, each product rounded before it is added. bf16 rows: the
    values rounded to bf16, products and sums in fp32 (the products of
    two bf16 values are exact), the sum rounded to bf16 once."""
    m, k = cols.shape
    x2 = x.reshape(x.shape[0], -1)
    g = x2.index_select(0, cols.reshape(-1)).view(m, k, -1)
    v = vals.to(x.dtype)
    if x.dtype == torch.bfloat16:
        g, v = g.float(), v.float()
    out = v[:, 0, None] * g[:, 0]
    for j in range(1, k):
        out = out + v[:, j, None] * g[:, j]
    return out.to(x.dtype).view(m, *x.shape[1:])


def ell_matmul_raw(cols: torch.Tensor, vals: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """``out[m] = Σ_k vals[m,k] · x[cols[m,k]]`` for vertex-major
    ``x [N, ...]``: the custom op ``cfsdvae::ell_matmul_fwd``
    (``ops/library.py``), kernel K4 on the card, its plain twin on the
    host."""
    return torch.ops.cfsdvae.ell_matmul_fwd.default(cols, vals, x)


def ell_tier_add_plain(rows: torch.Tensor, cols: torch.Tensor,
                       vals: torch.Tensor, x: torch.Tensor,
                       out: torch.Tensor) -> None:
    """One overflow tier landed in place, the plain form of
    ``CappedEll.apply``'s tiers: the tier's ELL product (in K4's
    order) added to ``out`` at ``rows`` with one rounding per value."""
    out.view(out.shape[0], -1).index_add_(
        0, rows, ell_matmul_plain(cols, vals, x).reshape(rows.shape[0], -1))


def ell_matmul_capped_plain(cols: torch.Tensor, vals: torch.Tensor, tiers,
                            links, x: torch.Tensor) -> torch.Tensor:
    """Plain twin of ``ell_matmul_capped`` in the kernel's order, driven by
    the walk as the kernel is (``rows`` unused): K4's twin on the main
    table, then for each tier its sums (in K4's order) added to the rows
    the walk reaches, one rounding each. Bit-equal to K4's twin followed
    by ``ell_tier_add_plain`` per tier."""
    out = ell_matmul_plain(cols, vals, x)
    flat = out.view(out.shape[0], -1)
    rows = torch.arange(out.shape[0], device=out.device)
    slots = links[0].long()
    for (_, t_cols, t_vals), nxt in zip(tiers, links[1:]):
        keep = slots >= 0
        rows, slots = rows[keep], slots[keep]
        sums = ell_matmul_plain(t_cols, t_vals, x).reshape(t_cols.shape[0], -1)
        flat[rows] = flat[rows] + sums[slots]
        slots = nxt.long()[slots]
    return out


class _EllMatmul(torch.autograd.Function):
    """Forward K4; backward ``mat.transpose.apply(dy)`` (JAX ``_ell_bwd``),
    which raises where the matrix was built without its transpose."""

    @staticmethod
    def forward(ctx, x, mat):
        ctx.mat = mat
        return ell_matmul_raw(mat.cols, mat.vals, x)

    @staticmethod
    def backward(ctx, dy):
        if ctx.mat.transpose is None:
            raise ValueError("ell_matmul backward requires transpose "
                             "structure (from_coo(with_transpose=True))")
        return ctx.mat.transpose.apply(dy.contiguous()), None


def ell_matmul(mat: PaddedRowSparse, x: torch.Tensor) -> torch.Tensor:
    """Sparse @ dense over axis 0: ``x [N, ...] → [M, ...]``, with the
    gather-only backward through the capped transpose."""
    if x.shape[0] != mat.n_cols:
        raise ValueError(f"x has {x.shape[0]} rows; the matrix has "
                         f"{mat.n_cols} columns")
    return _EllMatmul.apply(x, mat)


@dataclass
class GatherRows:
    """Pure row gather ``out = x[idx]`` with its capped transpose."""
    idx: torch.Tensor              # [M] int32
    transpose: CappedEll           # over the source row space
    n_rows: int                    # N (source dimension)

    @property
    def shape(self):
        return (self.idx.shape[0], self.n_rows)

    def to(self, device) -> "GatherRows":
        return GatherRows(self.idx.to(device), self.transpose.to(device),
                          self.n_rows)


def gather_op_from_idx(idx: np.ndarray, n_rows: int) -> GatherRows:
    """Host-side: a GatherRows op (and its transpose) from indices."""
    idx = np.asarray(idx, dtype=np.int64)
    _check_index_range(idx, n_rows, "gather")
    m = len(idx)
    transpose = capped_ell(idx, np.arange(m), np.ones(m), n_rows)
    return GatherRows(idx=torch.from_numpy(idx.astype(np.int32)),
                      transpose=transpose, n_rows=n_rows)


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    g = x.reshape(x.shape[0], -1).index_select(0, idx)
    return g.view(idx.shape[0], *x.shape[1:])


class _GatherRows(torch.autograd.Function):
    """Forward a row gather; backward ``op.transpose.apply(dy)`` (JAX
    ``_gather_rows_bwd``): a gather-sum, not a scatter."""

    @staticmethod
    def forward(ctx, x, op):
        ctx.op = op
        return _take_rows(x, op.idx)

    @staticmethod
    def backward(ctx, dy):
        return ctx.op.transpose.apply(dy.contiguous()), None


def gather_rows(op: GatherRows, x: torch.Tensor) -> torch.Tensor:
    """``x [N, ...] → x[idx] [M, ...]`` on the packed 2-D view, with the
    gather-only backward."""
    return _GatherRows.apply(x, op)

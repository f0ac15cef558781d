"""Vertex sharding: the vertex axis itself split over ranks (counterpart
of ``parallel/vertex_sharding.py``).

Each rank owns a contiguous block of vertices at every hierarchy level,
and every sparse operator becomes a halo exchange followed by a local
operator on ``[own shard ‖ received halo]``:

- the send side of a ``GatherPlan`` is a one-entry ELL table over the
  rank's rows (kernel K4, weight 1: exact copies), the rows each peer
  needs, then an ``all_to_all`` (whose backward is the reverse
  ``all_to_all``);
- the local side is the port's own operator with its table rewritten
  into positions of the local buffer: the spiral convs run K1 (tc,
  narrow, bf16, or K3a for the final conv under bf16 activations) with a
  local ``[S, L]`` spiral table, their backward the capped transposes
  (K4 capped) and K2-dW; the up-pool and the Laplacian run K4 over local
  ELL tables, their backward through capped transposes.

Every table, and every transpose, is built on the host from the static
mesh topology, as JAX builds its plans; a gather's backward is a gather
through its capped transpose (a halo row several peers need has several
entries, and a long row spills into overflow tiers), never a scatter,
and no float atomics. The encoder's down-selection is composed into its
conv's table (as ``SDVAE.encode`` composes it), so the encoder conv runs
only at the next level's vertices of the rank's block. At the deepest
level the blocks meet in an ``all_gather`` (backward: a
``reduce_scatter``), the dense heads run replicated, and the decoder's
first level takes the rank's block of the dense output.

The train step splits the losses as JAX does: reconstruction and the
Laplacian are summed over each rank's real rows, the terms on the
replicated latent (KL, latent consistency) are divided by the vertex
ranks, and the gradients and metrics are summed over the vertex ranks
(one all-reduce); on a 2-D (data × vertex) mesh they are then averaged
over the data ranks. Rank ``r`` of a 2-D mesh is data replica ``r //
D_v``, vertex block ``r % D_v``.

The JAX package lays its per-vertex tables out ``[D][K][S]``
(``arrange_per_vertex``); the same flat lists are built here and each
rank's ``[K][S]`` slice becomes its ``[S, K]`` table. Padded rows (the
blocks round up) read vertex 0 as JAX's do and are masked out of the
losses.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.pool import selection_indices
from ..ops.sparse import PaddedRowSparse, capped_ell, ell_matmul
from ..ops.spiral_conv import build_spiral_op, spiral_conv
from ..training.losses import (kl_divergence_loss, latent_consistency_loss,
                               region_feature_mask)
from ..training.trainer import LOSS_KEYS, _epoch_over, _epochs_over, _Steps
from .mesh import MeanReducer
from .train_parallel import _columns

__all__ = ["VERTEX_AXIS", "GatherPlan", "RankGather", "VertexMesh",
           "make_vertex_mesh", "apply_gather", "VertexShardedModel"]

VERTEX_AXIS = "vertex"

_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def _ceil_div(a, b):
    return -(-a // b)


def _pad_rows_np(x, rows):
    pad = rows - x.shape[0]
    if pad <= 0:
        return x
    return np.concatenate(
        [x, np.zeros((pad, *x.shape[1:]), x.dtype)], axis=0)


# ---------------------------------------------------------------- the mesh
@dataclass
class VertexMesh:
    """The ranks of a vertex-sharded run: ``n_vertex`` blocks, times
    ``n_data`` data replicas on a 2-D mesh. ``vertex_group`` joins the
    ranks of this rank's replica, ``data_group`` (None on a 1-D mesh) the
    ranks that hold this rank's block in every replica."""
    rank: int
    world: int
    device: torch.device
    n_vertex: int
    vertex_rank: int
    vertex_group: object
    n_data: int = 1
    data_rank: int = 0
    data_group: object = None


def make_vertex_mesh(n_vertex: int | None = None, n_data: int = 1,
                     device=None) -> VertexMesh:
    """The vertex mesh over the initialized process group's ranks: a
    1-D ``vertex`` mesh of every rank, or a 2-D ``data × vertex`` mesh
    (``n_data × n_vertex`` = the world size). Every rank must call it (the
    subgroups are made collectively). ``device``: the rank's device
    (default: the current card under NCCL, else the CPU)."""
    if not dist.is_initialized():
        raise RuntimeError("vertex sharding runs one rank per device: "
                           "initialize the process group first")
    world, rank = dist.get_world_size(), dist.get_rank()
    n_vertex = world // n_data if n_vertex is None else int(n_vertex)
    if n_vertex * n_data != world:
        raise ValueError(f"a {n_data} × {n_vertex} mesh needs "
                         f"{n_data * n_vertex} ranks; the group has {world}")
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device()) \
            if dist.get_backend() == "nccl" else torch.device("cpu")
    device = resolve_device(device)
    vertex_group = data_group = None
    for d in range(n_data):
        g = dist.new_group([d * n_vertex + v for v in range(n_vertex)])
        if rank // n_vertex == d:
            vertex_group = g
    if n_data > 1:
        for v in range(n_vertex):
            g = dist.new_group([d * n_vertex + v for d in range(n_data)])
            if rank % n_vertex == v:
                data_group = g
    return VertexMesh(rank=rank, world=world, device=device,
                      n_vertex=n_vertex, vertex_rank=rank % n_vertex,
                      vertex_group=vertex_group, n_data=n_data,
                      data_rank=rank // n_vertex, data_group=data_group)


# ------------------------------------------------------------ collectives
class _AllToAll(torch.autograd.Function):
    """``all_to_all`` of equal blocks along axis 0 (block p goes to rank
    p); its own transpose."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g, group=ctx.group)
        return out, None


class _AllGather(torch.autograd.Function):
    """Tiled ``all_gather`` along axis 0 in rank order; backward the
    ``reduce_scatter`` (sum) of the cotangent."""

    @staticmethod
    def forward(ctx, x, group, size):
        ctx.group, ctx.size = group, size
        x = x.contiguous()
        out = x.new_empty((size * x.shape[0], *x.shape[1:]))
        _all_gather(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        out = g.new_empty((g.shape[0] // ctx.size, *g.shape[1:]))
        _reduce_scatter(out, g, op=dist.ReduceOp.SUM, group=ctx.group)
        return out, None, None


# ------------------------------------------------------------------ plans
@dataclass
class RankGather:
    """One rank's side of a ``GatherPlan``: ``send`` ([D·K, 1] over its
    ``S_in`` rows: the rows each peer gets, block p for rank p) and
    ``local`` ([S_out, 1] over ``S_in + D·K``: each output row's place in
    ``[own ‖ halo]``), each with its capped transpose."""
    send: PaddedRowSparse
    local: PaddedRowSparse

    def to(self, device) -> "RankGather":
        return RankGather(self.send.to(device), self.local.to(device))


def _ell(cols: np.ndarray, vals: np.ndarray, n_cols: int) -> PaddedRowSparse:
    """A host ELL table ``[M, K]`` over ``n_cols`` rows with its capped
    transpose. The transpose leaves out the entries of weight 0 (the
    Laplacian's padding points at column 0 and would pile thousands of
    zero products onto that one row)."""
    m, k = cols.shape
    rows = np.repeat(np.arange(m), k)
    keep = np.asarray(vals).reshape(-1) != 0
    return PaddedRowSparse(
        cols=torch.from_numpy(np.ascontiguousarray(cols, np.int32)),
        vals=torch.from_numpy(np.ascontiguousarray(vals, np.float32)),
        n_cols=int(n_cols),
        transpose=capped_ell(cols.reshape(-1)[keep], rows[keep],
                             np.asarray(vals).reshape(-1)[keep],
                             int(n_cols)))


@dataclass
class GatherPlan:
    """Static halo-exchange plan for ``out[m] = x[idx[m]]`` with x and out
    vertex-sharded in contiguous blocks, built as JAX builds it:
      send_idx [D, D, K]   each rank's local rows to ship to each peer
      local_idx [D, S_out] positions into [own shard ‖ halo buffer]"""
    send_idx: np.ndarray
    local_idx: np.ndarray
    shard_in: int
    shard_out: int

    @property
    def halo_rows(self) -> int:
        return int(self.send_idx.shape[0] * self.send_idx.shape[2])

    @classmethod
    def build(cls, idx: np.ndarray, n_src: int, n_devices: int
              ) -> "GatherPlan":
        """idx [M] global source rows, M a multiple of n_devices (pad
        first); output row m lives on rank m // (M // D)."""
        idx = np.asarray(idx, np.int64)
        m = len(idx)
        if m % n_devices:
            raise ValueError("pad idx to a multiple of the ranks first")
        shard_out = m // n_devices
        shard_in = _ceil_div(n_src, n_devices)
        owner = idx // shard_in

        need = {}
        for d in range(n_devices):
            lo, hi = d * shard_out, (d + 1) * shard_out
            my_idx, my_owner = idx[lo:hi], owner[lo:hi]
            for p in range(n_devices):
                if p != d:
                    rows = np.unique(my_idx[my_owner == p])
                    if len(rows):
                        need[(p, d)] = rows
        k = max((len(r) for r in need.values()), default=1)

        send_idx = np.zeros((n_devices, n_devices, k), np.int32)
        halo_pos = [dict() for _ in range(n_devices)]
        for (p, d), rows in need.items():
            send_idx[p, d, :len(rows)] = rows - p * shard_in
            for j, r in enumerate(rows):
                halo_pos[d][int(r)] = p * k + j

        local_idx = np.zeros((n_devices, shard_out), np.int32)
        for d in range(n_devices):
            src = idx[d * shard_out:(d + 1) * shard_out]
            mine = src // shard_in == d
            local_idx[d, mine] = src[mine] - d * shard_in
            local_idx[d, ~mine] = [shard_in + halo_pos[d][int(s)]
                                   for s in src[~mine]]
        return cls(send_idx, local_idx, shard_in, shard_out)

    def rank_gather(self, d: int) -> RankGather:
        """Rank ``d``'s send and local tables (host)."""
        send = self.send_idx[d].reshape(-1, 1)
        local = self.local_idx[d].reshape(-1, 1)
        return RankGather(
            _ell(send, np.ones(send.shape, np.float32), self.shard_in),
            _ell(local, np.ones(local.shape, np.float32),
                 self.shard_in + self.halo_rows))

    def local_table(self, d: int, k: int) -> np.ndarray:
        """Rank ``d``'s ``[S, K]`` table of a plan over a per-vertex
        ``[D][K][S]`` list (``k`` entries per output vertex)."""
        return np.ascontiguousarray(
            self.local_idx[d].reshape(k, -1).T)


def _exchange(send: PaddedRowSparse, x: torch.Tensor, group) -> torch.Tensor:
    """``[own rows ‖ halo]``: the rows each peer needs (K4 through the
    send table), exchanged (at one rank too: the collective then copies)."""
    to_send = ell_matmul(send, x)
    return torch.cat([x, _AllToAll.apply(to_send, group)], dim=0)


def apply_gather(tables: RankGather, x: torch.Tensor,
                 group=None) -> torch.Tensor:
    """This rank's ``out`` block of a ``GatherPlan`` from its ``x`` block
    ``[S_in, ...]``: the halo exchange, then the local gather (K4 through
    the local table). Differentiable; both backward gathers run through
    the tables' capped transposes."""
    return ell_matmul(tables.local, _exchange(tables.send, x, group))


# ------------------------------------------------------------------ model
@dataclass
class _Level:
    """A local operator after a halo exchange: the send table and either
    a spiral op or an ELL table over ``[own ‖ halo]``."""
    send: PaddedRowSparse
    op: object

    def to(self, device) -> "_Level":
        return _Level(self.send.to(device), self.op.to(device))


class VertexShardedModel:
    """The SD-VAE with every hierarchy level vertex-sharded over the ranks
    of a ``VertexMesh``, built on the host from the same geometry bundle
    as the unsharded model (this rank's tables only). The methods take
    the parameters as an ``SDVAE`` module (``params``): its ``en_convs``,
    ``de_convs``, ``final_conv``, ``mu``, ``logvar`` and ``de_dense``."""

    def __init__(self, bundle, config, mesh: VertexMesh, laplacian=None,
                 region_masks=None):
        self.config = config
        self.mesh = mesh
        self._bundle = bundle
        # the step's Laplacian (COO over level 0) and region masks [R, N]:
        # the bundle's template's unless given, as SpiralGeometry takes them
        tpl = getattr(bundle, "template", None)
        self._laplacian = laplacian if laplacian is not None \
            else (tpl.laplacian if tpl is not None else None)
        self._region_masks = region_masks if region_masks is not None \
            else (tpl.region_masks() if tpl is not None else None)
        d = self.n_devices = mesh.n_vertex
        v = mesh.vertex_rank
        dev = mesh.device
        counts = list(bundle.vertex_counts)
        self.counts = counts
        self.shards = [_ceil_div(n, d) for n in counts]

        def arrange_per_vertex(table_2d, rows):
            """[M, K] per-vertex table → the flat list [D][K][S] (JAX's
            ``arrange_per_vertex``), S = rows // D."""
            k = table_2d.shape[1]
            padded = _pad_rows_np(np.asarray(table_2d, np.int64), rows)
            return padded.reshape(d, rows // d, k).transpose(0, 2, 1) \
                .reshape(-1)

        def conv_level(table, n_src, rows):
            seq = table.shape[1]
            plan = GatherPlan.build(arrange_per_vertex(table, rows), n_src, d)
            local = plan.local_table(v, seq)
            op = build_spiral_op(local, n_src=plan.shard_in + plan.halo_rows)
            return _Level(plan.rank_gather(v).send, op).to(dev)

        # the encoder's convs with the down-selection composed in
        self.enc_levels = []
        for i, (s, dn) in enumerate(zip(bundle.spirals, bundle.down)):
            sel = selection_indices(dn)
            if sel is None:
                raise ValueError("vertex sharding needs down transforms "
                                 "that are selections")
            self.enc_levels.append(conv_level(
                np.asarray(s)[sel], counts[i], self.shards[i + 1] * d))
        # the decoder's convs (and the final conv at level 0)
        self.dec_levels = [conv_level(np.asarray(s), counts[i],
                                      self.shards[i] * d)
                           for i, s in enumerate(bundle.spirals)]
        # the up-pools: three barycentric weights per vertex
        self.up_levels = []
        for i, up in enumerate(bundle.up):
            order = np.argsort(np.asarray(up.rows), kind="stable")
            cols = np.asarray(up.cols)[order].reshape(counts[i], 3)
            vals = np.asarray(up.vals)[order].reshape(counts[i], 3)
            rows = self.shards[i] * d
            plan = GatherPlan.build(arrange_per_vertex(cols, rows),
                                    counts[i + 1], d)
            lv = _pad_rows_np(vals.astype(np.float32), rows)[
                v * self.shards[i]:(v + 1) * self.shards[i]]
            self.up_levels.append(_Level(
                plan.rank_gather(v).send,
                _ell(plan.local_table(v, 3), lv,
                     plan.shard_in + plan.halo_rows)).to(dev))
        self._loss = None

    # ------------------------------------------------------------------
    def local_block(self, x, level: int = 0):
        """This rank's rows of a vertex-major ``[N or D·S, ...]`` array
        (padded first) as a tensor on its device."""
        s = self.shards[level]
        x = _pad_rows_np(np.asarray(x), s * self.n_devices)
        v = self.mesh.vertex_rank
        return torch.as_tensor(np.ascontiguousarray(
            x[v * s:(v + 1) * s])).to(self.mesh.device)

    def _ext(self, level: _Level, h: torch.Tensor) -> torch.Tensor:
        return _exchange(level.send, h, self.mesh.vertex_group)

    def _conv(self, level: _Level, conv, h: torch.Tensor,
              out_dtype=None) -> torch.Tensor:
        """A spiral conv (K1) on the rank's ``[own ‖ halo]`` rows."""
        return spiral_conv({"w": conv.w, "b": conv.b}, self._ext(level, h),
                           level.op, out_dtype)

    def encode(self, params, x: torch.Tensor):
        """The rank's block ``[S₀, B, 3]`` → (mu [B, Z], logvar | None),
        replicated over the vertex ranks."""
        cfg = self.config
        h = x.to(cfg.activation_dtype).contiguous()
        for i, conv in enumerate(params.en_convs):
            lv = self.enc_levels[i]
            h = F.elu(self._conv(lv, conv, h))
            if i == 0:
                h = h.to(cfg.deep_dtype)
        h = _AllGather.apply(h, self.mesh.vertex_group, self.n_devices)
        h = h[:self.counts[-1]]
        flat = h.transpose(0, 1).reshape(h.shape[1], -1).float()
        mu = params.mu(flat)
        if cfg.is_vae:
            return mu, params.logvar(flat)
        if cfg.pre_z_sigmoid:
            mu = torch.sigmoid(mu)
        return mu, None

    def decode(self, params, z: torch.Tensor) -> torch.Tensor:
        """Latents ``[B, Z]`` → the rank's block ``[S₀, B, 3]`` (fp32)."""
        cfg = self.config
        n_levels = len(params.de_convs)
        n_last = self.counts[-1]
        h = params.de_dense(z).view(z.shape[0], n_last, -1)
        h = h.transpose(0, 1).to(cfg.deep_dtype)
        s = self.shards[-1]
        pad = s * self.n_devices - n_last
        if pad:
            h = torch.cat([h, h.new_zeros((pad, *h.shape[1:]))], dim=0)
        v = self.mesh.vertex_rank
        h = h[v * s:(v + 1) * s].contiguous()
        for j, conv in enumerate(params.de_convs):
            level = n_levels - 1 - j
            up = self.up_levels[level]
            h = ell_matmul(up.op, self._ext(up, h))
            h = F.elu(self._conv(self.dec_levels[level], conv, h))
        return self._conv(self.dec_levels[0], params.final_conv, h,
                          torch.float32).float()

    def forward(self, params, x: torch.Tensor):
        """The rank's block ``[S₀, B, 3]`` → (out block [S₀, B, 3], mu,
        logvar or zeros), z = mu."""
        mu, logvar = self.encode(params, x)
        out = self.decode(params, mu)
        return out, mu, (logvar if logvar is not None
                         else torch.zeros_like(mu))

    def make_forward(self):
        """``fwd(params, x_block) → (out_block, mu, logvar)``, no grad."""
        def fwd(params, x):
            with torch.no_grad():
                return self.forward(params, x)
        return fwd

    # ------------------------------------------------------------------
    def _loss_tables(self) -> dict:
        """The step's extras (built once): the Laplacian's local ELL plan
        (K4 after a halo exchange), the rank's region masks ``[R, S₀]``
        and its valid-row mask ``[S₀]``."""
        if self._loss is not None:
            return self._loss
        d, v = self.n_devices, self.mesh.vertex_rank
        n, s0 = self.counts[0], self.shards[0]
        if self._laplacian is None or self._region_masks is None:
            raise ValueError("the train step needs the template's Laplacian "
                             "and region masks")
        rows, cols, vals = self._laplacian
        rows = np.asarray(rows)
        order = np.argsort(rows, kind="stable")
        rows, cols_s, vals_s = rows[order], np.asarray(cols)[order], \
            np.asarray(vals)[order]
        counts = np.bincount(rows, minlength=n)
        k = int(counts.max())
        ell_cols = np.zeros((n, k), np.int64)
        ell_vals = np.zeros((n, k), np.float32)
        pos = np.concatenate([[0], np.cumsum(counts)[:-1]])
        for j in range(k):
            sel = counts > j
            ell_cols[sel, j] = cols_s[pos[sel] + j]
            ell_vals[sel, j] = vals_s[pos[sel] + j]

        def arrange(t):
            return _pad_rows_np(np.asarray(t), s0 * d).reshape(d, s0, -1)

        plan = GatherPlan.build(
            arrange(ell_cols).transpose(0, 2, 1).reshape(-1), n, d)
        lap = _Level(plan.rank_gather(v).send,
                     _ell(plan.local_table(v, k), arrange(ell_vals)[v],
                          plan.shard_in + plan.halo_rows))
        masks = np.asarray(self._region_masks, bool)
        valid = np.zeros(d * s0, np.float32)
        valid[:n] = 1.0
        dev = self.mesh.device
        self._loss = {
            "lap": lap.to(dev),
            "masks": torch.from_numpy(np.ascontiguousarray(
                arrange(masks.T)[v].T)).to(dev),
            "valid": torch.from_numpy(valid[v * s0:(v + 1) * s0]).to(dev),
            "n_regions": int(masks.shape[0])}
        return self._loss

    def _device_loss(self, params, weights, x, batch_size, swap,
                     region_idx, eps, training: bool = True):
        """The rank's share of the loss and its metrics (JAX's
        ``device_loss``): local terms over its real rows, replicated terms
        divided by the vertex ranks."""
        lt = self._loss_tables()
        cfg = self.config
        d, n_tot = self.n_devices, self.counts[0]
        grid = batch_size * batch_size if swap else batch_size
        valid = lt["valid"]
        if swap:
            idx = torch.as_tensor(region_idx, device=x.device).reshape(1)
            m = lt["masks"].index_select(0, idx.long())[0]
            xi, xj = x[:, :, None, :], x[:, None, :, :]
            x_grid = torch.where(m[:, None, None, None], xj, xi)
            x_grid = x_grid.reshape(x.shape[0], -1, x.shape[-1])
        else:
            region_idx, x_grid = 0, x
        mu, logvar = self.encode(params, x_grid)
        if cfg.is_vae and training:
            z = mu + eps.to(mu) * torch.exp(0.5 * logvar)
        else:
            z = mu
        out = self.decode(params, z)
        vmask = valid[:, None, None]
        zero = out.new_zeros(())
        recon = torch.sum((out - x_grid) ** 2 * vmask) / (n_tot * grid * 3)
        lap = zero
        if weights.laplacian > 0:
            lv = lt["lap"]
            lx = ell_matmul(lv.op, self._ext(lv, out))
            sq = torch.sum(lx * lx, dim=-1)
            # padded rows are zero, and sqrt's derivative there is not
            safe = torch.where(valid[:, None] > 0, sq, torch.ones_like(sq))
            lap = torch.sum(torch.sqrt(safe) * valid[:, None]) / (n_tot * grid)
        kl = kl_divergence_loss(mu, logvar) if cfg.is_vae else zero
        cons = zero
        if swap and weights.latent_consistency > 0:
            fmask = region_feature_mask(cfg.latent_size, lt["n_regions"],
                                        region_idx, device=z.device)
            cons = latent_consistency_loss(z, fmask, batch_size,
                                           weights.eta1, weights.eta2)
        loss = recon + weights.laplacian * lap + \
            (weights.kl * kl + weights.latent_consistency * cons) / d
        metrics = {"reconstruction": recon, "laplacian": lap, "kl": kl / d,
                   "latent_consistency": cons / d}
        return loss, metrics

    def _combine(self, tensors: list, weights) -> dict:
        """Sum over the vertex ranks, then (2-D) average over the data
        ranks, in place: one all-reduce each; the last tensor holds the
        four metrics, returned with ``tot`` and the other keys at 0."""
        MeanReducer(group=self.mesh.vertex_group)(tensors)
        if self.mesh.n_data > 1:
            MeanReducer(group=self.mesh.data_group,
                        divisor=self.mesh.n_data)(tensors)
        vec = tensors[-1]
        m = dict(zip(("reconstruction", "laplacian", "kl",
                      "latent_consistency"), vec))
        m["tot"] = (m["reconstruction"] + weights.kl * m["kl"]
                    + weights.latent_consistency * m["latent_consistency"]
                    + weights.laplacian * m["laplacian"])
        zero = vec.new_zeros(())
        return {k: m.get(k, zero) for k in LOSS_KEYS}

    @staticmethod
    def _metric_vec(metrics: dict) -> torch.Tensor:
        return torch.stack([torch.as_tensor(metrics[k]).float() for k in (
            "reconstruction", "laplacian", "kl", "latent_consistency")])

    def make_train_step(self, params, weights, optimizer, batch_size: int,
                        swap: bool = True):
        """The vertex-sharded train step, update for update the unsharded
        one: ``step(x_block [S₀, B, 3], region_idx, eps [B², Z]) →
        metrics`` (0-d tensors keyed by ``LOSS_KEYS``; the classification
        keys read 0). On a 2-D mesh ``x_block`` is this data replica's B
        scans and the region and ``eps`` its own draws."""
        def step(x, region_idx=None, eps=None):
            optimizer.zero_grad(set_to_none=False)
            loss, metrics = self._device_loss(params, weights, x, batch_size,
                                              swap, region_idx, eps)
            loss.backward()
            grads = [p.grad for p in params.parameters()]
            out = self._combine(grads + [self._metric_vec(metrics).detach()],
                                weights)
            optimizer.step()
            return out

        return step

    def make_eval_step(self, params, weights, batch_size: int,
                       swap: bool = True):
        """Validation metrics only, summed and averaged as the train
        step's: ``step(x_block, region_idx, eps) → metrics``. As JAX's
        sharded validation does, the loss is the train step's, a VAE's z
        drawn with ``eps``; without ``eps``, z = mu."""
        def step(x, region_idx=None, eps=None):
            with torch.no_grad():
                _, metrics = self._device_loss(params, weights, x,
                                               batch_size, swap, region_idx,
                                               eps, training=eps is not None)
                return self._combine([self._metric_vec(metrics)], weights)

        return step

    # ------------------------------------------------------------------
    def _steps(self, params, weights, optimizer, batch_size, swap, draws):
        """The scanned forms' replayers (``trainer._Steps``) over this
        model's steps: the batch comes batch-major ``[B, S₀, 3]`` from the
        split and is made vertex-major here."""
        from ..graphs import StateGuard

        train = self.make_train_step(params, weights, optimizer, batch_size,
                                     swap)
        evaluate = self.make_eval_step(params, weights, batch_size, swap)
        bodies = {
            "train": [lambda x, r, e, lab, cw: train(x.transpose(0, 1), r,
                                                     e)],
            "eval": [lambda x, r, e, lab, cw: evaluate(x.transpose(0, 1), r,
                                                       e)]}
        return _Steps(self.mesh.device, batch_size,
                      batch_size ** 2 if swap else batch_size,
                      self.config.latent_size, [draws], bodies,
                      StateGuard([params], [optimizer]),
                      eps_kinds=("train", "eval"))

    def _split(self, cache: dict, data_x) -> torch.Tensor:
        """The rank's block of a vertex-major split ``[D·S₀ or N, n, 3]``,
        batch-major ``[n, S₀, 3]`` on its device; the same tensor for the
        same split (a captured step reads it at its address)."""
        if cache.get("src") is not data_x:
            s0, v = self.shards[0], self.mesh.vertex_rank
            x = data_x if isinstance(data_x, torch.Tensor) \
                else torch.as_tensor(np.asarray(data_x, np.float32))
            if x.shape[0] < s0 * self.n_devices:
                x = torch.cat([x, x.new_zeros(
                    (s0 * self.n_devices - x.shape[0], *x.shape[1:]))])
            cache["src"] = data_x
            cache["split"] = x[v * s0:(v + 1) * s0].transpose(0, 1) \
                .contiguous().to(self.mesh.device, torch.float32)
        return cache["split"]

    def _cols(self, idx, batch_size):
        """This data replica's columns of a plan ``[..., G]``."""
        mesh = self.mesh
        return _columns(_DataAxis(mesh.data_rank, mesh.n_data), idx,
                        batch_size)

    def make_scanned_epoch(self, params, weights, optimizer,
                           batch_size: int, swap: bool = True, *, draws):
        """A whole vertex-sharded epoch: ``epoch(data_x [D·S₀ or N, n, 3],
        idx [S, G], step_ids [S]) → metrics averaged over the S steps``
        (G = data replicas × B; each replica keeps its columns), the
        trainer's ``_epoch_over`` at K = 1. The steps replay one captured
        graph on the card, the collectives inside it; ``draws(step_id,
        rows)`` gives this replica's draws."""
        steps = self._steps(params, weights, optimizer, batch_size, swap,
                            draws)
        call = _epoch_over([([0], steps)])
        cache: dict = {}

        def epoch(data_x, idx, step_ids):
            return call(self._split(cache, data_x),
                        self._cols(idx, batch_size), step_ids)[0]

        epoch.steps = steps
        return epoch

    def make_scanned_epochs(self, params, weights, optimizer,
                            batch_size: int, swap: bool = True, *, draws):
        """E vertex-sharded epochs, each followed by its validation steps:
        ``epochs_fn(train_x, val_x, tr_idx [E, St, G], tr_sid [E, St],
        va_idx [E, Sv, G], va_sid [E, Sv]) → (train metrics, validation
        metrics)``, lists of E dicts (the trainer's ``_epochs_over`` at
        K = 1)."""
        steps = self._steps(params, weights, optimizer, batch_size, swap,
                            draws)
        call = _epochs_over([([0], steps)])
        caches: tuple = ({}, {})

        def epochs_fn(train_x, val_x, tr_idx, tr_sid, va_idx, va_sid):
            tr, va = call(self._split(caches[0], train_x),
                          self._split(caches[1], val_x),
                          self._cols(tr_idx, batch_size), tr_sid,
                          self._cols(va_idx, batch_size), va_sid)
            return tr[0], va[0]

        epochs_fn.steps = steps
        return epochs_fn


@dataclass
class _DataAxis:
    """A mesh's data axis as ``train_parallel._columns`` reads it: this
    rank's data replica among ``world`` of them."""
    rank: int
    world: int

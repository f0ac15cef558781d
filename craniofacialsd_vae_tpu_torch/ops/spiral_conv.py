"""Spiral convolution, vertex-major (counterpart of ``ops/spiral_conv.py``).

For each output vertex the features of its spiral neighbourhood (L
indices) go through one dense projection:
``out[m] = b + Σ_l x[S[m, l]] @ W_l``, with the weight stored
``[L·C_in, C_out]`` as in the JAX package and read as ``[L, C_in, C_out]``.

``spiral_conv`` is a ``torch.autograd.Function`` in the form of the JAX
custom VJP (``_spiral_conv_core`` / ``_score_bwd``):

- forward: kernel K1 (fp32), through the custom op
  ``cfsdvae::spiral_conv_fwd`` (``ops/library.py``): for a CUDA tensor
  it launches ``csrc/spiral_conv.cu`` (tensor cores in 3xTF32, or a
  narrow kernel for C_out < 8 that stages each vertex tile's distinct
  source rows in shared memory once, ``SpiralOp.tiles``), which never
  writes the ``[M, B, L·C]`` concatenation; for a CPU tensor it runs
  the plain twin, the fp32 branch of ``_spiral_conv_core``;
- backward: ``dx`` by kernel K2-dx (``csrc/spiral_conv_dx.cu``), which
  reassociates JAX's ``Σ (dy[n] @ W_lᵀ)`` over the combined transposes
  as ``Σ_l du_l @ W_lᵀ``: per position the gather-sum ``du_l[v] = Σ
  dy[n]`` over the ``n`` with ``S[n, l] = v`` (``SpiralDx``, built with
  the op), formed in shared memory, then one product with the stacked
  ``W_lᵀ`` on the tensor cores in 3xTF32, so no ``dy @ Wᵀ`` is ever
  written; ``dW`` by kernel K2-dW (``csrc/spiral_conv_dw.cu``, tensor
  cores in 3xTF32), which recomputes the gathers; ``db = Σ dy``. On the
  host the same steps run with the plain twins.

bf16 activations (the ``mixed`` and ``bfloat16`` policies) keep the JAX
package's rounding points: ``w`` and ``b`` are cast to bf16; the forward
(K1-bf16, ``csrc/spiral_conv_bf16.cu``) accumulates ``b`` and the L
position products in fp32 and rounds once; the backward sums ``dW``
(K2-dW-bf16) and ``db`` in fp32 and rounds each once, and K2-dx-bf16
forms ``du`` in fp32 from the bf16 ``dy``, rounds it to bf16 once for
the bf16 tensor cores and rounds ``dx`` once.
Autograd through the casts hands fp32 gradients to the fp32 parameters.
The final decoder conv returns fp32: gather-first through
``_SpiralConvF32Out`` (K3a: the accumulator unrounded, on the tensor
cores from each vertex tile's rows staged once in shared memory,
``SpiralOp.tiles``; its backward rounds ``dy`` to bf16 once), or
matmul-first through
``spiral_conv_out_gather`` (one fp32 product of the bf16 values laid out
position-major, ``[L, C_out, N, B]``, then kernel K3b's gather-sum,
``csrc/out_gather_sum.cu``, whose backward is one launch of
``out_gather_sum_bwd`` over every position's capped transpose,
``SpiralOp.out_bwd``).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels
from .sparse import (CappedEll, GatherRows, capped_ell,
                     ell_matmul_capped_plain, ell_matmul_plain,
                     gather_op_from_idx)

__all__ = ["SpiralOp", "SpiralTiles", "SpiralDx", "OutGatherBwd",
           "OutGatherRuns", "build_spiral_op", "build_spiral_tiles",
           "build_spiral_dx", "build_out_gather_bwd",
           "build_out_gather_runs", "init_spiral_conv",
           "spiral_conv", "spiral_conv_plain", "spiral_conv_table_plain",
           "tile_args", "spiral_conv_dx", "spiral_conv_dx_plain",
           "spiral_conv_dw",
           "spiral_conv_dw_plain", "spiral_conv_dw_chunked_plain",
           "spiral_conv_out_gather",
           "out_gather_sum_plain", "out_gather_sum_bwd_plain",
           "out_gather_sum_bwd_tiles_plain"]


#: the custom ops of ``ops/library.py`` (registered when ``ops`` is
#: imported), which the forwards call
_OPS = torch.ops.cfsdvae

_TILE_ROWS = 64        # most distinct source rows a K1 narrow tile stages
_TILE_VERTICES = 64    # most vertices a K1 narrow tile owns


@dataclass
class SpiralTiles:
    """The spiral kernels' vertex tiles. Tile ``t`` owns the output
    vertices ``verts[starts[t]:starts[t + 1]]`` and reads the distinct
    source rows ``src[src_off[t]:src_off[t + 1]]`` (sorted, at most
    ``max_rows``, and at most ``max_verts`` vertices); ``local [M, L]``
    holds, in tile order, each vertex's spiral entries as indices into
    its tile's list. All int32."""
    verts: torch.Tensor            # [M]
    starts: torch.Tensor           # [T + 1]
    src: torch.Tensor              # [sum of the tiles' rows]
    src_off: torch.Tensor          # [T + 1]
    local: torch.Tensor            # [M, L]
    max_rows: int
    max_verts: int

    @property
    def n_tiles(self) -> int:
        return int(self.starts.shape[0]) - 1

    def to(self, device) -> "SpiralTiles":
        return SpiralTiles(*(t.to(device) for t in (
            self.verts, self.starts, self.src, self.src_off, self.local)),
            max_rows=self.max_rows, max_verts=self.max_verts)

    def table(self) -> torch.Tensor:
        """The ``[M, L]`` spiral table the lists describe."""
        sizes = (self.starts[1:] - self.starts[:-1]).long()
        tile = torch.repeat_interleave(
            torch.arange(self.n_tiles, device=self.starts.device), sizes)
        rows = self.src[self.src_off[tile].long()[:, None]
                        + self.local.long()]
        table = torch.empty_like(self.local)
        table[self.verts.long()] = rows
        return table


def build_spiral_tiles(spirals: np.ndarray,
                       composed: bool = False) -> SpiralTiles:
    """Host-side: tiles of nearby vertices for K1 narrow and the bf16
    kernels. Each tile grows from the lowest vertex not yet taken, adding
    a vertex while the tile's distinct source rows stay within
    ``_TILE_ROWS`` (raised to L where a single vertex needs more) and its
    vertices within ``_TILE_VERTICES``: breadth-first over the table's own
    entries, a compact patch of the mesh whose rows each serve several of
    its vertices; or, for a table ``composed`` with a down-selection
    (whose entries are source rows, not its own vertices), over the
    following vertices in order."""
    spirals = np.asarray(spirals)
    m, seq = spirals.shape
    max_rows = max(_TILE_ROWS, seq)
    taken = np.zeros(m, dtype=bool)
    verts, starts, srcs, src_off = [], [0], [np.zeros(0, np.int64)], [0]
    local = [np.zeros((0, seq), np.int64)]
    seed = 0
    while seed < m:
        rows: set = set()
        tile, queue, seen = [], deque([seed]), {seed}
        while queue and len(tile) < _TILE_VERTICES:
            v = queue.popleft()
            if taken[v]:
                continue
            new = rows.union(spirals[v].tolist())
            if tile and len(new) > max_rows:
                if composed:
                    break
                continue
            rows, taken[v] = new, True
            tile.append(v)
            if composed:
                if v + 1 < m:
                    queue.append(v + 1)
                continue
            for s in spirals[v].tolist():
                if s < m and not taken[s] and s not in seen:
                    seen.add(s)
                    queue.append(s)
        uniq, inv = np.unique(spirals[tile], return_inverse=True)
        verts += tile
        starts.append(len(verts))
        srcs.append(uniq)
        src_off.append(src_off[-1] + len(uniq))
        local.append(inv.reshape(len(tile), seq))
        while seed < m and taken[seed]:
            seed += 1
    i32 = lambda a: torch.from_numpy(np.asarray(a, dtype=np.int32))  # noqa
    return SpiralTiles(
        verts=i32(verts), starts=i32(starts), src=i32(np.concatenate(srcs)),
        src_off=i32(src_off), local=i32(np.concatenate(local)),
        max_rows=max(len(u) for u in srcs),
        max_verts=int(np.diff(starts).max()))


_BWD_TIERS = 3                 # capped_ell's max_tiers
_BWD_FIELDS = 4 + 4 * _BWD_TIERS
_RUN_VERTS = 32                # most du rows a K3b backward run owns
_RUN_ROWS = 256                # most distinct dout rows a run stages
_RUN_LOCAL_BITS = 15           # an entry: local row index, then weight


@dataclass
class OutGatherRuns:
    """K3b's backward in runs of consecutive source vertices (du rows),
    the lists its kernel reads. Run ``t`` owns du rows ``starts[t]`` to
    ``starts[t + 1] - 1`` (``nv`` of them, at most ``max_verts``) and
    stages the sorted distinct ``dout`` rows ``rows[row_off[t]:row_off[t
    + 1]]`` (at most ``max_rows``). ``blob[blob_off[t]:blob_off[t + 1]]``
    (a multiple of four words, at most ``max_blob``) holds first one
    header per (position l, vertex i) at ``l · nv + i``, the offset of
    that pair's entries (in 16-bit entries after the headers) times 4
    plus the number of overflow tiers its walk reaches, then the
    entries, 16 bits each: the dout row's index in the run's list, and
    ``1 << 15`` where the weight is 1 (0 for padding). A pair's entries
    are its main row's K, padding kept, then each reached tier's, in
    the transpose's order; the identity position has one, the vertex's
    own row. ``pos [L, 4]``: each position's main K (0 for the identity
    position) and its tiers' K. All int32."""
    starts: torch.Tensor           # [T + 1]
    rows: torch.Tensor             # [sum of the runs' rows]
    row_off: torch.Tensor          # [T + 1]
    blob: torch.Tensor             # [sum of the runs' words]
    blob_off: torch.Tensor         # [T + 1]
    pos: torch.Tensor              # [L, 4]
    n_src: int
    max_rows: int
    max_verts: int
    max_blob: int

    @property
    def n_runs(self) -> int:
        return int(self.starts.shape[0]) - 1

    def to(self, device) -> "OutGatherRuns":
        return OutGatherRuns(*(t.to(device) for t in (
            self.starts, self.rows, self.row_off, self.blob, self.blob_off,
            self.pos)), n_src=self.n_src, max_rows=self.max_rows,
            max_verts=self.max_verts, max_blob=self.max_blob)

    def entries(self) -> list:
        """Per position ``l``: ``(rows [N, E], weights [N, E], tiers
        [N])`` decoded from the runs in the kernel's order: each source
        vertex's dout rows and weights (1 or 0), the main row's K entries
        then each tier's, and how many tiers its walk reaches (E: K plus
        every tier's K; −1 and 0 past the walk). numpy int64."""
        starts, row_off, blob_off = (t.cpu().numpy() for t in (
            self.starts, self.row_off, self.blob_off))
        rows, blob = self.rows.cpu().numpy(), self.blob.cpu().numpy()
        pos = self.pos.cpu().numpy().astype(np.int64)
        n, seq = self.n_src, pos.shape[0]
        # entries a pair holds, by the tiers its walk reaches
        counts = [np.ones(4, np.int64) if k == 0 else
                  k + np.concatenate([[0], np.cumsum(tk)])
                  for k, tk in zip(pos[:, 0], pos[:, 1:])]
        out = [(np.full((n, c[-1]), -1, np.int64),
                np.zeros((n, c[-1]), np.int64), np.zeros(n, np.int64))
               for c in counts]
        for t in range(len(starts) - 1):
            s, nv = int(starts[t]), int(starts[t + 1] - starts[t])
            words = blob[blob_off[t]:blob_off[t + 1]]
            head = words[:nv * seq].astype(np.int64).reshape(seq, nv)
            ent = words[nv * seq:].view(np.uint16).astype(np.int64)
            local_rows = rows[row_off[t]:row_off[t + 1]]
            for l, (r, w, nt) in enumerate(out):
                span = np.arange(r.shape[1])
                take = span[None, :] < counts[l][head[l] & 3][:, None]
                e = ent[np.where(take, (head[l] >> 2)[:, None] + span, 0)]
                r[s:s + nv] = np.where(take, local_rows[e & 0x7fff], -1)
                w[s:s + nv] = np.where(take, e >> _RUN_LOCAL_BITS, 0)
                nt[s:s + nv] = head[l] & 3
        return out


@dataclass
class OutGatherBwd:
    """K3b's backward in one table: every position's gather transpose (a
    ``CappedEll`` over the N source rows) concatenated. Row ``l`` of
    ``info [L, 16]``: the main table's offset into ``cols``/``vals`` and
    its K (0 marks the identity position), the offset of its first link
    in ``links`` (−1 without tiers) and its tier count, then per tier
    its offset, K, rows and the offset of its next links; int32 but
    ``vals``. ``runs`` are the same transposes in the runs the kernel
    reads (``build_out_gather_runs``, built with the table)."""
    info: torch.Tensor             # [L, 16]
    cols: torch.Tensor             # main tables and tiers, flat
    vals: torch.Tensor
    links: torch.Tensor            # link0 and each tier's next, flat
    n_src: int
    m: int
    runs: OutGatherRuns | None = None      # set by build_out_gather_bwd

    def to(self, device) -> "OutGatherBwd":
        return OutGatherBwd(self.info.to(device), self.cols.to(device),
                            self.vals.to(device), self.links.to(device),
                            self.n_src, self.m, self.runs.to(device))

    def tables(self) -> list:
        """Per position: None (identity) or ``(cols, vals, tiers, links)``
        as ``ell_matmul_capped_plain`` takes them, views into the flat
        arrays."""
        out = []
        for row in self.info.tolist():
            off, k, l0, n_tiers = row[:4]
            if k == 0:
                out.append(None)
                continue
            n = self.n_src
            cols = self.cols[off:off + n * k].view(n, k)
            vals = self.vals[off:off + n * k].view(n, k)
            tiers, links = [], [] if l0 < 0 else [self.links[l0:l0 + n]]
            for q in range(n_tiers):
                t_off, t_k, t_r, t_next = row[4 + 4 * q:8 + 4 * q]
                tiers.append((None, self.cols[t_off:t_off + t_r * t_k].view(
                    t_r, t_k), self.vals[t_off:t_off + t_r * t_k].view(
                    t_r, t_k)))
                links.append(self.links[t_next:t_next + t_r])
            out.append((cols, vals, tuple(tiers), tuple(links)))
        return out


def build_out_gather_bwd(gathers: list, n_src: int, m: int) -> OutGatherBwd:
    """Host-side: the per-position transposes of ``gathers`` (None for an
    identity position) in one ``OutGatherBwd``."""
    info = np.zeros((len(gathers), _BWD_FIELDS), dtype=np.int64)
    cols, vals, links = [], [], []
    off = loff = 0
    for l, g in enumerate(gathers):
        if g is None:
            info[l, 2] = -1
            continue
        t = g.transpose
        if len(t.tiers) > _BWD_TIERS:
            raise ValueError(f"position {l}: {len(t.tiers)} tiers")
        info[l, :4] = off, t.cols.shape[1], loff if t.tiers else -1, \
            len(t.tiers)
        cols.append(t.cols.reshape(-1))
        vals.append(t.vals.reshape(-1))
        off += t.cols.numel()
        if t.tiers:
            links.append(t.links[0])
            loff += t.links[0].numel()
        for q, ((_, t_cols, t_vals), nxt) in enumerate(zip(t.tiers,
                                                           t.links[1:])):
            info[l, 4 + 4 * q:8 + 4 * q] = (off, t_cols.shape[1],
                                            t_cols.shape[0], loff)
            cols.append(t_cols.reshape(-1))
            vals.append(t_vals.reshape(-1))
            off += t_cols.numel()
            links.append(nxt)
            loff += nxt.numel()
    if max(off, loff) >= 2 ** 31:
        raise ValueError("the backward tables must fit int32 offsets")
    cat = lambda ts, dt: (torch.cat(ts) if ts          # noqa: E731
                          else torch.zeros(1, dtype=dt))
    bwd = OutGatherBwd(info=torch.from_numpy(info.astype(np.int32)),
                       cols=cat(cols, torch.int32),
                       vals=cat(vals, torch.float32),
                       links=cat(links, torch.int32), n_src=n_src, m=m)
    bwd.runs = build_out_gather_runs(bwd)
    return bwd


def _walk_entries(table, n: int) -> tuple:
    """One position's transpose walked for every source vertex: ``(rows
    [N, E], vals [N, E], tiers [N], ks)``, the main row's K entries then
    each tier's where the walk reaches it (−1 and 0 elsewhere), and the
    K of the main table and of each tier. The identity position (None):
    each vertex's own row, weight 1."""
    if table is None:
        return (np.arange(n)[:, None], np.ones((n, 1)),
                np.zeros(n, np.int64), [0])
    cols, vals, tiers, links = table
    rows, ws, ks = [cols.numpy().astype(np.int64)], [vals.numpy()], \
        [cols.shape[1]]
    reached = np.zeros(n, np.int64)
    slot = links[0].numpy().astype(np.int64) if tiers else None
    for (_, t_cols, t_vals), nxt in zip(tiers, links[1:]):
        tk = t_cols.shape[1]
        hit = slot >= 0
        r = np.full((n, tk), -1, np.int64)
        w = np.zeros((n, tk), np.float32)
        r[hit] = t_cols.numpy()[slot[hit]]
        w[hit] = t_vals.numpy()[slot[hit]]
        rows.append(r)
        ws.append(w)
        ks.append(tk)
        reached += hit
        slot = np.where(hit, nxt.numpy().astype(np.int64)[
            np.maximum(slot, 0)], -1)
    return np.concatenate(rows, 1), np.concatenate(ws, 1), reached, ks


def build_out_gather_runs(bwd: OutGatherBwd, max_verts: int = _RUN_VERTS,
                          max_rows: int = _RUN_ROWS) -> OutGatherRuns:
    """Host-side: K3b backward's runs (``OutGatherRuns``) of ``bwd``'s
    transposes. A run grows over the following source vertices while it
    holds at most ``max_verts`` and its distinct dout rows (every entry's,
    padding's row 0 and the tiers' included) stay within ``max_rows``; a
    vertex that needs more alone is a run of its own. Raises where a
    weight is not 1 or 0 (a gather's transpose has no other)."""
    n, seq = bwd.n_src, bwd.info.shape[0]
    walks = [_walk_entries(t, n) for t in bwd.tables()]
    pos = np.zeros((seq, 4), np.int64)
    for l, (_, _, _, ks) in enumerate(walks):
        pos[l, :len(ks)] = ks
    rows = np.concatenate([w[0] for w in walks], 1)      # [N, sum E_l]
    vals = np.concatenate([w[1] for w in walks], 1)
    take = rows >= 0
    if not np.isin(vals[take], (0.0, 1.0)).all():
        raise ValueError("K3b's backward takes transposes of weight 1 or 0")
    reached = np.stack([w[2] for w in walks], 1)           # [N, L]
    first = np.cumsum([0] + [w[0].shape[1] for w in walks[:-1]])
    counts = np.add.reduceat(take.astype(np.int64), first, axis=1)
    flat_rows, flat_flag = rows[take], vals[take] != 0     # vertex-major
    vstart = np.concatenate([[0], np.cumsum(counts.sum(1))])
    starts, cur = [0], set()
    for v in range(n):
        mine = set(flat_rows[vstart[v]:vstart[v + 1]].tolist())
        new = cur | mine
        if v > starts[-1] and (v - starts[-1] >= max_verts
                               or len(new) > max_rows):
            starts.append(v)
            new = mine
        cur = new
    starts.append(n)
    run_rows, row_off, blobs, blob_off = [], [0], [], [0]
    for s, e in zip(starts[:-1], starts[1:]):
        seg = slice(vstart[s], vstart[e])
        uniq, local = np.unique(flat_rows[seg], return_inverse=True)
        if len(uniq) > 1 << _RUN_LOCAL_BITS:
            raise ValueError(f"vertex {s}: {len(uniq)} dout rows")
        ent = (local | (flat_flag[seg].astype(np.int64)
                        << _RUN_LOCAL_BITS)).astype(np.uint16)
        ent = np.concatenate([ent, np.zeros(len(ent) % 2, np.uint16)])
        off = (np.cumsum(counts[s:e].reshape(-1)) - counts[s:e].reshape(-1)
               ).reshape(e - s, seq)
        head = ((off << 2) | reached[s:e]).T.reshape(-1)
        words = np.concatenate([head.astype(np.int32), ent.view(np.int32)])
        blobs.append(np.concatenate([words, np.zeros(-len(words) % 4,
                                                     np.int32)]))
        run_rows.append(uniq)
        row_off.append(row_off[-1] + len(uniq))
        blob_off.append(blob_off[-1] + len(blobs[-1]))
    if blob_off[-1] >= 2 ** 31 or int(counts.sum()) >= 2 ** 29:
        raise ValueError("the runs must fit int32 offsets")
    i32 = lambda a: torch.from_numpy(np.asarray(a, dtype=np.int32))  # noqa
    return OutGatherRuns(
        starts=i32(starts), rows=i32(np.concatenate(run_rows)),
        row_off=i32(row_off), blob=torch.from_numpy(np.concatenate(blobs)),
        blob_off=i32(blob_off), pos=i32(pos), n_src=n,
        max_rows=int(np.diff(row_off).max()),
        max_verts=int(np.diff(starts).max()),
        max_blob=int(np.diff(blob_off).max()))


@dataclass
class SpiralDx:
    """K2-dx's lists: for source vertex ``v`` and spiral position ``l``,
    ``idx[ptr[v·L + l]:ptr[v·L + l + 1]]`` are the rows ``n`` of ``dy``
    with ``S[n, l] = v`` in ascending order (an identity position's one
    entry is ``v`` itself), then −1 where the combined transpose of
    ``l``'s column group pads a row of ``v`` (main table or tier) and
    ``l`` is the group's first column: JAX adds ``0 · dg[0]`` there,
    ``0 · dy[0] @ W_lᵀ``, which carries a non-finite ``dy[0]`` into
    ``dx[v]``. ``max_count``: the longest list. int32."""
    ptr: torch.Tensor              # [n_src · L + 1]
    idx: torch.Tensor              # [entries]
    n_src: int
    max_count: int

    def to(self, device) -> "SpiralDx":
        return SpiralDx(self.ptr.to(device), self.idx.to(device),
                        self.n_src, self.max_count)


def build_spiral_dx(spirals: np.ndarray, n_src: int, inv_tables: list,
                    group_cols: tuple) -> SpiralDx:
    """Host-side, vectorised: ``SpiralDx`` of an ``[M, L]`` table over
    ``n_src`` source rows, the padding entries read from the op's combined
    transposes ``inv_tables`` (one per column group ``group_cols``)."""
    spirals = np.asarray(spirals, dtype=np.int64)
    m, seq = spirals.shape
    v = spirals.reshape(-1)                        # entry (n, l) → S[n, l]
    pos = np.tile(np.arange(seq), m)
    row = np.repeat(np.arange(m), seq)
    pads_v, pads_l = [], []
    for table, cols in zip(inv_tables, group_cols):
        padded = (table.vals == 0).any(1).numpy()
        for t_rows, _, t_vals in table.tiers:
            padded[t_rows.numpy()[(t_vals == 0).any(1).numpy()]] = True
        hit = np.flatnonzero(padded)
        pads_v.append(hit)
        pads_l.append(np.full(len(hit), cols[0]))
    v = np.concatenate([v, *pads_v])
    pos = np.concatenate([pos, *pads_l])
    # the padding after the rows (key m), then −1
    key = np.concatenate([row, np.full(len(v) - len(row), m)])
    order = np.lexsort((key, v * seq + pos))
    idx = np.where(key[order] == m, -1, key[order])
    counts = np.bincount(v * seq + pos, minlength=n_src * seq)
    ptr = np.concatenate([[0], np.cumsum(counts)])
    if ptr[-1] >= 2 ** 31:
        raise ValueError("K2-dx's lists must fit int32 offsets")
    i32 = lambda a: torch.from_numpy(np.asarray(a, dtype=np.int32))  # noqa
    return SpiralDx(ptr=i32(ptr), idx=i32(idx), n_src=n_src,
                    max_count=int(counts.max()) if counts.size else 0)


@dataclass
class SpiralOp:
    """Per-level spiral structure.

    ``table`` is the ``[M, L]`` int32 spiral table the kernel reads;
    ``gathers`` holds one GatherRows per position (None for an identity
    position, whose rows are ``x`` itself), and ``inv_tables`` the combined
    transposes over the flat ``(l, m)`` index space, one per column group,
    as JAX builds them: the conv's backward reads them through ``dx``
    (K2-dx's lists, built from them with the op) and applies none. ``tiles``
    are the vertex tiles of K1 narrow, K3a, K1-bf16 and K2-dW-bf16, and
    ``out_bwd`` K3b's backward table, both built with the op."""
    table: torch.Tensor            # [M, L] int32
    gathers: list                  # L × (GatherRows | None)
    inv_tables: list               # per column group: CappedEll
    group_cols: tuple              # per group: tuple of spiral positions
    identity_cols: tuple           # spiral positions that are the identity
    seq_length: int
    n_src: int                     # rows of the input (≠ M when composed)
    tiles: SpiralTiles
    out_bwd: OutGatherBwd
    dx: SpiralDx

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
            seq_length=self.seq_length, n_src=self.n_src,
            tiles=self.tiles.to(device), out_bwd=self.out_bwd.to(device),
            dx=self.dx.to(device))


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
                    identity_cols=identity_cols, seq_length=l, n_src=n,
                    tiles=build_spiral_tiles(spirals, composed=n != m),
                    out_bwd=build_out_gather_bwd(gathers, n, m),
                    dx=build_spiral_dx(spirals, n, inv_tables,
                                       tuple(group_cols)))


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


def spiral_conv_table_plain(w_l: torch.Tensor, b: torch.Tensor,
                            x: torch.Tensor, table: torch.Tensor,
                            out_dtype: torch.dtype | None = None
                            ) -> torch.Tensor:
    """Plain twin of K1: ``out = b``, then ``out + x[table[:, l]] @ W_l``
    for l = 0…L−1 (the fp32 branch of the JAX ``_spiral_conv_core``). bf16
    x, W and b (twin of K1-bf16 and K3a, its bf16 branch and
    ``_spiral_conv_core_f32out``): the same sums in fp32 from ``b``, the
    products of the bf16 values in fp32, rounded to bf16 once, or with
    ``out_dtype`` float32 returned unrounded."""
    bf16 = x.dtype == torch.bfloat16
    x2 = x.reshape(x.shape[0], -1)
    out = b.float() if bf16 else b
    for i in range(table.shape[1]):
        xi = x2.index_select(0, table[:, i]).view(-1, *x.shape[1:])
        out = out + (xi.float() @ w_l[i].float() if bf16 else xi @ w_l[i])
    if bf16 and out_dtype != torch.float32:
        return out.to(x.dtype)
    return out


def spiral_conv_plain(w_l: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
                      op: SpiralOp, out_dtype: torch.dtype | None = None
                      ) -> torch.Tensor:
    """``spiral_conv_table_plain`` over the op's table."""
    return spiral_conv_table_plain(w_l, b, x, op.table, out_dtype)


def tile_args(tiles: SpiralTiles | None) -> tuple:
    """A ``SpiralTiles`` as the custom op ``spiral_conv_fwd`` takes it:
    ``verts, starts, src, src_off, local, max_rows, max_verts`` (None and
    0 for no tiles)."""
    if tiles is None:
        return (None,) * 5 + (0, 0)
    return (tiles.verts, tiles.starts, tiles.src, tiles.src_off,
            tiles.local, tiles.max_rows, tiles.max_verts)


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
                                 plan: kernels.DwPlan | kernels.DwBf16Plan,
                                 tiles: SpiralTiles | None = None
                                 ) -> torch.Tensor:
    """K2-dW's sums in the order of ``plan``'s chunks: each chunk's
    partial dW over its ``tiles_per_chunk · tmv`` vertices, then, as the
    kernel's second pass adds them, eight runs (chunks w, w + 8, … in
    order) and the eight run sums in run order. A ``DwBf16Plan`` (bf16 x
    and dy, with the op's ``tiles``): each chunk's fp32 partial over the
    vertices of its ``tpc`` consecutive tiles and the batch rows of its
    ``bpc`` consecutive batch tiles, the partials added in chunk order
    (tile runs major, batch runs minor), rounded to bf16 once."""
    if isinstance(plan, kernels.DwBf16Plan):
        x32, d32 = x.float(), dy.float()
        starts = tiles.starts.tolist()
        rows = plan.bpc * plan.tb
        out = None
        for t0 in range(0, tiles.n_tiles, plan.tpc):
            vs = tiles.verts[starts[t0]:starts[min(t0 + plan.tpc,
                                                    tiles.n_tiles)]].long()
            for b0 in range(0, x.shape[1], rows):
                part = spiral_conv_dw_plain(x32[:, b0:b0 + rows], table[vs],
                                            d32[vs, b0:b0 + rows])
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
                   dy: torch.Tensor,
                   tiles: SpiralTiles | None = None) -> torch.Tensor:
    """``dW [L, C_in, C_out]`` of the spiral conv, in x's dtype: kernel
    K2-dW (K2-dW-bf16 for bf16, through the op's ``tiles``) on the card,
    its plain twin on the host."""
    if not x.is_cuda:
        return spiral_conv_dw_plain(x, table, dy)
    return kernels.spiral_conv_dw(x, table, dy, tiles=tiles)


def spiral_conv_du_plain(dy: torch.Tensor, dx_tab: SpiralDx,
                         seq: int) -> torch.Tensor:
    """K2-dx's ``du`` in the kernel's order and roundings: per position
    ``l`` the gather-sum ``du_l[v]`` of ``dy``'s rows over ``dx_tab``'s
    list of ``(v, l)`` over ``seq`` positions, in list order from +0
    with one rounding per add (−1 adds ``0 · dy[0]``), in fp32; ``[n_src,
    B, L·C_out]`` (column ``l · C_out + o``), fp32, or bf16 (rounded once)
    for bf16 ``dy``."""
    m, bsz, c_out = dy.shape
    d2 = dy.reshape(m, bsz * c_out).float()
    # rows m (a +0 for the lists' ragged ends) and m + 1 (0 · dy[0])
    ext = torch.cat([d2, torch.zeros_like(d2[:1]), 0.0 * d2[:1]])
    ptr = dx_tab.ptr.long()
    counts = ptr[1:] - ptr[:-1]
    take = torch.arange(dx_tab.max_count, device=dy.device)
    at = (ptr[:-1, None] + take).clamp(max=max(dx_tab.idx.numel() - 1, 0))
    rows = dx_tab.idx.long()[at] if dx_tab.idx.numel() else at
    rows = torch.where(rows < 0, m + 1, rows)
    rows = torch.where(take < counts[:, None], rows, m)
    du = torch.zeros((rows.shape[0], bsz * c_out), dtype=torch.float32,
                     device=dy.device)
    for j in range(dx_tab.max_count):
        du = du + ext[rows[:, j]]
    # [n_src, L, B, C_out] → [n_src, B, L·C_out]
    du = du.view(-1, seq, bsz, c_out).transpose(1, 2).reshape(
        -1, bsz, seq * c_out)
    return du.to(torch.bfloat16) if dy.dtype == torch.bfloat16 else du


def spiral_conv_dx_plain(dy: torch.Tensor, w_l: torch.Tensor,
                         dx_tab: SpiralDx) -> torch.Tensor:
    """Plain twin of K2-dx, in the kernel's order and roundings: ``du``
    as ``spiral_conv_du_plain`` forms it, then ``dx = [du_0 | … |
    du_{L−1}] @ [W_0ᵀ; …; W_{L−1}ᵀ]`` in fp32. bf16 ``dy`` and ``w_l``:
    ``du`` rounded to bf16, the product in fp32, ``dx`` rounded to bf16
    once. ``dy [M, B, C_out]``, ``w_l [L, C_in, C_out]``; returns
    ``[n_src, B, C_in]`` in dy's dtype."""
    seq, c_in, c_out = w_l.shape
    du = spiral_conv_du_plain(dy, dx_tab, seq).float()
    w_t = w_l.float().permute(0, 2, 1).reshape(seq * c_out, c_in)
    if dy.dtype != torch.bfloat16:
        return du @ w_t
    return (du @ w_t).to(torch.bfloat16)


def spiral_conv_dx(dy: torch.Tensor, w_l: torch.Tensor,
                   dx_tab: SpiralDx) -> torch.Tensor:
    """``dx [n_src, B, C_in]`` of the spiral conv, in dy's dtype: kernel
    K2-dx (K2-dx-bf16 for bf16) on the card, its plain twin on the
    host."""
    if not dy.is_cuda:
        return spiral_conv_dx_plain(dy, w_l, dx_tab)
    return kernels.spiral_conv_dx(dy, w_l, dx_tab.ptr, dx_tab.idx,
                                  dx_tab.n_src)


class _SpiralConv(torch.autograd.Function):
    """``out = b + Σ_l x[S[:, l]] @ W_l`` with the JAX ``_score_bwd``
    backward (see the module docstring), in x's dtype."""

    @staticmethod
    def forward(ctx, w_l, b, x, op):
        ctx.op = op
        ctx.save_for_backward(w_l, x)
        return _OPS.spiral_conv_fwd.default(x, op.table, w_l, b, False,
                                            *tile_args(op.tiles))

    @staticmethod
    def backward(ctx, dy):
        w_l, x = ctx.saved_tensors
        op = ctx.op
        dy = dy.contiguous()
        dw_l = db = dx = None
        if ctx.needs_input_grad[2]:
            dx = spiral_conv_dx(dy, w_l, op.dx)
        if ctx.needs_input_grad[0]:
            dw_l = spiral_conv_dw(x, op.table, dy, op.tiles)
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
        return _OPS.spiral_conv_fwd.default(x, op.table, w_l, b, True,
                                            *tile_args(op.tiles))

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
    differentiable: K1 forward, K2-dx and K2-dW backward on the card;
    the plain twins on the host. ``out_dtype`` float32 with bf16 x: the
    fp32 accumulator unrounded (K3a)."""
    _check_rows(x, op)
    w = params["w"].to(x.dtype)
    b = params["b"].to(x.dtype)
    w_l = w.reshape(op.seq_length, x.shape[-1], w.shape[-1])
    if out_dtype == torch.float32 and x.dtype == torch.bfloat16:
        return _SpiralConvF32Out.apply(w_l, b, x, op)
    return _SpiralConv.apply(w_l, b, x, op)


def out_gather_sum_plain(u: torch.Tensor, table: torch.Tensor,
                         b: torch.Tensor) -> torch.Tensor:
    """Plain twin of K3b: ``out = b``, then ``out + u_l[:, table[:, l]]``
    for l = 0…L−1 in fp32, for the position-major ``u [L, O, N, B]``;
    returns ``[M, B, O]``."""
    out = b
    for i in range(table.shape[1]):
        out = out + u[i].index_select(1, table[:, i]).permute(1, 2, 0)
    return out


def out_gather_sum_bwd_plain(dout: torch.Tensor,
                             bwd: OutGatherBwd) -> torch.Tensor:
    """Plain twin of K3b's backward, ``out_gather_sum_bwd``: for each
    position its capped transpose walked from ``bwd`` in the kernel's
    order (``ell_matmul_capped_plain``; the identity position's ``dout``
    itself), laid out as ``u``, ``[L, O, N, B]``. Bit-equal to the stack
    of the positions' ``CappedEll.apply``."""
    m, bsz, o = dout.shape
    d2 = dout.reshape(m, bsz * o)
    parts = []
    for table in bwd.tables():
        if table is None:
            part = d2
        elif table[2]:
            part = ell_matmul_capped_plain(*table, d2)
        else:
            part = ell_matmul_plain(table[0], table[1], d2)
        parts.append(part.view(-1, bsz, o).permute(2, 0, 1))
    return torch.stack(parts)


def out_gather_sum_bwd_tiles_plain(dout: torch.Tensor,
                                   runs: OutGatherRuns) -> torch.Tensor:
    """K3b's backward from its runs' lists (``OutGatherRuns.entries``), in
    the kernel's order and roundings: for each position and source
    vertex, the main row's products summed one rounding each, then each
    reached tier's sum formed alike and added with one rounding; the
    identity position's own row copied. ``[L, O, N, B]``; bit-equal to
    ``out_gather_sum_bwd_plain``."""
    m, bsz, o = dout.shape
    d2 = dout.reshape(m, bsz * o)
    k = runs.pos[:, 0].tolist()
    tier_k = runs.pos[:, 1:].tolist()
    parts = []
    for l, (rows, ws, reached) in enumerate(runs.entries()):
        r = torch.from_numpy(rows).to(dout.device)
        w = torch.from_numpy(ws).to(dout)
        if k[l] == 0:
            part = d2[r[:, 0]]
        else:
            part = ell_matmul_plain(r[:, :k[l]], w[:, :k[l]], d2)
            at = k[l]
            for q, tk in enumerate(tier_k[l]):
                hit = torch.from_numpy(reached > q).to(dout.device)
                if tk == 0 or not bool(hit.any()):
                    break
                part[hit] = part[hit] + ell_matmul_plain(
                    r[hit, at:at + tk], w[hit, at:at + tk], d2)
                at += tk
        parts.append(part.view(-1, bsz, o).permute(2, 0, 1))
    return torch.stack(parts)


class _OutGatherSum(torch.autograd.Function):
    """``out = b + Σ_l u_l[S[:, l]]`` (K3b on the card), backward as JAX's
    autodiff of ``spiral_conv_out_gather`` gives it: each position's
    ``du_l`` through that gather's own capped transpose, the identity
    position's ``dout`` itself (one ``out_gather_sum_bwd`` launch on the
    card, written in ``u``'s layout), ``db = Σ dout``."""

    @staticmethod
    def forward(ctx, u, b, op):
        ctx.op = op
        return _OPS.out_gather_sum.default(u, op.table, b)

    @staticmethod
    def backward(ctx, dout):
        dout = dout.contiguous()
        du = db = None
        if ctx.needs_input_grad[0]:
            du = (kernels.out_gather_sum_bwd(dout, ctx.op.out_bwd)
                  if dout.is_cuda
                  else out_gather_sum_bwd_plain(dout, ctx.op.out_bwd))
        if ctx.needs_input_grad[1]:
            db = dout.sum(dim=(0, 1))
        return du, db, None


def spiral_conv_out_gather(params: dict, x: torch.Tensor,
                           op: SpiralOp) -> torch.Tensor:
    """Matmul-first spiral conv (JAX ``spiral_conv_out_gather``): ``u =
    x @ W_l`` for every position in one plain product (fp32, from bf16 x
    and W: the fp32 copies of the bf16 values), laid out position-major
    as JAX lays it, ``[L, C_out, N, B]`` (``W_catᵀ @ xᵀ``: its backward
    is one product each for dW and dx, with no copy of ``du``), then
    ``out = b + Σ_l u_l[S[:, l]]`` in fp32 (K3b on the card). ``b`` stays
    fp32; the output is fp32 for bf16 x."""
    _check_rows(x, op)
    acc = torch.float32 if x.dtype == torch.bfloat16 else x.dtype
    n, bsz, c_in = x.shape
    w = params["w"].to(x.dtype).to(acc)                 # [L·C_in, C_out]
    c_out = w.shape[-1]
    w_t = w.reshape(op.seq_length, c_in, c_out).transpose(1, 2).reshape(
        op.seq_length * c_out, c_in)
    u = (w_t @ x.reshape(n * bsz, c_in).to(acc).t()).view(
        op.seq_length, c_out, n, bsz)
    return _OutGatherSum.apply(u, params["b"].to(acc), op)

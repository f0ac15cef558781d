"""The launches of the tiled bf16 kernels, walked on the CPU as the
kernels walk them: K1-bf16's vector path (``csrc/spiral_conv_bf16.cu``,
``spiral_conv_bf16_vec_kernel``) and K2-dW-bf16
(``csrc/spiral_conv_dw_bf16.cu``), with the planners' plans, on the
fixture hierarchy's seven bf16 convs of the ``mixed`` model and on the
octasphere's level 0.

Each walk repeats the kernel's index arithmetic (block -> column slice
and its items, each a vertex tile's batch tile, or chunk of tiles and
batch tiles and position group; row -> vertex and batch row; staged
entry ``local[v, l]·TB + b``) and checks that the
staged entries map back to ``op.table`` and stay within the plan's
shared memory, and that every (vertex, batch, position) is covered
exactly once (K1: every output row once per column slice). Integer
arithmetic only: no tolerance.
"""

import math
import os

import numpy as np
import pytest
import torch

from craniofacialsd_vae_tpu_torch import kernels
from craniofacialsd_vae_tpu_torch import ops as tops
from craniofacialsd_vae_tpu_torch.geometry import (extract_spirals,
                                                   load_bundle, octasphere)
from craniofacialsd_vae_tpu_torch.models import SpiralGeometry

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "geometry.npz")
BF16 = torch.bfloat16
# the mixed model's bf16 convs on the fixture: (name, C_in, C_out)
CONVS = [("enc1", 32, 32), ("enc2", 32, 32), ("enc3", 32, 64),
         ("dec3", 64, 64), ("dec2", 64, 32), ("dec1", 32, 32),
         ("dec0", 32, 32)]


@pytest.fixture(scope="module")
def fixture_ops():
    geom = SpiralGeometry.from_bundle(load_bundle(FIXTURE), device="cpu")
    return {name: (geom.enc_spirals if name.startswith("enc")
                   else geom.spirals)[int(name[-1])]
            for name, _, _ in CONVS}


@pytest.fixture(scope="module")
def octa_op():
    pos, face = octasphere(6)
    table = extract_spirals(np.asarray(face), np.asarray(pos), 9)
    return table, tops.build_spiral_tiles(table)


def _arrays(tiles):
    return (t.numpy().astype(np.int64) for t in (
        tiles.verts, tiles.starts, tiles.src, tiles.src_off, tiles.local))


def k1_items(plan):
    """``(block, column slice, item)`` of a ``bf16`` launch as its
    persistent blocks walk them: block ``blk`` takes slice ``blk %
    slices`` and items ``blk // slices``, then every ``grid[0]``-th."""
    n_splits, per_slice = plan.grid[1], plan.grid[0]
    for blk in range(plan.blocks):
        split = blk % n_splits
        for q in range(blk // n_splits, plan.n_rtiles, per_slice):
            yield blk, split, q


def k1_walk(plan, tiles, table, b, c_in, c_out):
    """The ``bf16`` launch walked block by block and item by item:
    returns the count of writes of each (vertex, batch, column slice) and
    checks each staged row and entry."""
    verts, starts, src, src_off, local = _arrays(tiles)
    m, seq = table.shape
    n_splits = plan.grid[1]
    assert plan.n_rtiles == tiles.n_tiles * plan.n_btiles
    assert plan.grid[0] <= plan.n_rtiles
    writes = np.zeros((m, b, n_splits), np.int64)
    entry_cap = plan.rows * plan.tb
    index_ints = math.ceil(64 * (seq + 1) / 4) * 4
    assert (2 * seq * c_in * plan.ldw + 2 * (
        4 * index_ints + 2 * entry_cap * (c_in + 8))
        + 4 * (16 + 2 * plan.rows)) <= plan.smem <= 232448
    for _, split, q in k1_items(plan):
        t, bt = divmod(q, plan.n_btiles)
        b0 = bt * plan.tb
        tb = min(plan.tb, b - b0)
        s0, rows = src_off[t], src_off[t + 1] - src_off[t]
        v0, nv = starts[t], starts[t + 1] - starts[t]
        assert 1 <= nv <= 64 and rows <= plan.rows
        n_rows = nv * tb
        n_mt = -(-n_rows // 16)
        # each warp's groups of mi 16-row tiles; rows past n_rows clamp
        # on the read and are not written
        r = np.arange(-(-n_mt // plan.mi) * plan.mi * 16)
        rc = np.minimum(r, n_rows - 1)
        v, bb = rc // tb, rc % tb
        loc = local[v0 + v]                                   # [rows, L]
        assert loc.max() < rows
        entries = loc * plan.tb + bb[:, None]
        assert entries.max() < entry_cap
        np.testing.assert_array_equal(src[s0 + loc], table[verts[v0 + v]])
        keep = r < n_rows
        np.add.at(writes, (verts[v0 + v[keep]], b0 + bb[keep], split), 1)
        n0 = split * plan.nt
        assert n0 < c_out and n_splits == -(-c_out // plan.nt)
    return writes


def k2_walk(plan, tiles, table, b, c_in, c_out):
    """The K2-dW-bf16 launch walked block by block and k16 step by k16
    step: returns the count of products of each (vertex, batch,
    position) and checks each staged row, dy row and entry."""
    verts, starts, src, src_off, local = _arrays(tiles)
    m, seq = table.shape
    fm = -(-c_in // 16)
    seen = np.zeros((m, b, seq), np.int64)
    entry_cap = plan.rows * plan.tb
    d_cap = -(-plan.verts * plan.tb // 16) * 16
    assert plan.smem >= 2 * kernels._dw_bf16_stage(
        seq, c_in, c_out, plan.rows, plan.verts, plan.tb) + 4 * (
        16 + 2 * (plan.rows + plan.verts))
    n_bgroups = -(-plan.n_btiles // plan.bpc)
    assert plan.n_chunks == -(-tiles.n_tiles // plan.tpc) * n_bgroups
    for chunk in range(plan.n_chunks):
        tg, bg = divmod(chunk, n_bgroups)
        bts = range(bg * plan.bpc, min(plan.n_btiles, (bg + 1) * plan.bpc))
        for group in range(plan.groups):
            l0 = group * plan.positions
            pos = np.arange(l0, min(seq, l0 + plan.positions))
            units = len(pos) * fm
            assert plan.warps * plan.upw >= units
            for t in range(tg * plan.tpc,
                           min(tiles.n_tiles, (tg + 1) * plan.tpc)):
                s0, rows = src_off[t], src_off[t + 1] - src_off[t]
                v0, nv = starts[t], starts[t + 1] - starts[t]
                assert nv <= plan.verts and rows <= plan.rows
                for bt in bts:
                    b0 = bt * plan.tb
                    tb = min(plan.tb, b - b0)
                    n_r = nv * tb
                    r = np.arange(-(-n_r // 16) * 16)   # the k16 steps
                    assert r.max() < d_cap
                    r = r[r < n_r]                      # the rest: zeros
                    v, bb = r // tb, r % tb
                    loc = local[v0 + v][:, pos]         # [rows, P]
                    assert loc.max() < rows
                    assert (loc * plan.tb + bb[:, None]).max() < entry_cap
                    np.testing.assert_array_equal(
                        src[s0 + loc], table[verts[v0 + v]][:, pos])
                    np.add.at(seen, (verts[v0 + v][:, None],
                                     (b0 + bb)[:, None], pos[None, :]), 1)
    return seen


def _check_k1(tiles, table, b, c_in, c_out):
    m, seq = table.shape
    plan = kernels.plan_spiral_conv(m, b, seq, c_in, c_out, True, True, BF16,
                                    tiles.n_tiles, tiles.max_rows)
    assert plan.path == "bf16" and plan.rows == tiles.max_rows
    writes = k1_walk(plan, tiles, table, b, c_in, c_out)
    assert writes.min() == 1 and writes.max() == 1


def _check_k2(tiles, table, b, c_in, c_out):
    m, seq = table.shape
    plan = kernels.plan_spiral_conv_dw_bf16(m, b, seq, c_in, c_out,
                                            tiles.n_tiles, tiles.max_rows,
                                            tiles.max_verts)
    seen = k2_walk(plan, tiles, table, b, c_in, c_out)
    assert seen.min() == 1 and seen.max() == 1


@pytest.mark.parametrize("b", [16, 4, 3, 1])
@pytest.mark.parametrize("name,c_in,c_out", CONVS)
def test_k1_bf16_walk_reads_the_table(fixture_ops, name, c_in, c_out, b):
    """K1-bf16's tiled launch on each bf16 conv of the mixed model: every
    staged entry is the source row ``op.table`` names, and every output
    row is written once in each column slice."""
    op = fixture_ops[name]
    _check_k1(op.tiles, op.table.numpy(), b, c_in, c_out)


@pytest.mark.parametrize("b", [16, 3, 1])
def test_k1_bf16_walk_on_the_octasphere(octa_op, b):
    table, tiles = octa_op
    _check_k1(tiles, table, b, 32, 32)


@pytest.mark.parametrize("b", [16, 4, 3, 1])
@pytest.mark.parametrize("name,c_in,c_out", CONVS + [("dec0", 32, 3)])
def test_k2_dw_bf16_walk_reads_the_table(fixture_ops, name, c_in, c_out, b):
    """K2-dW-bf16's launch on each bf16 conv of the mixed model (and the
    gather-first final conv, 32 -> 3, on dec0's tables): every (vertex,
    batch, position) enters exactly one product, from the source row
    ``op.table`` names."""
    op = fixture_ops[name]
    _check_k2(op.tiles, op.table.numpy(), b, c_in, c_out)


@pytest.mark.parametrize("b", [16, 3, 1])
def test_k2_dw_bf16_walk_on_the_octasphere(octa_op, b):
    table, tiles = octa_op
    _check_k2(tiles, table, b, 32, 32)


@pytest.mark.parametrize("m,b,seq,c_in,c_out", [
    (333, 3, 7, 10, 18), (100, 2, 9, 128, 96), (20, 1, 9, 64, 3)])
def test_k2_dw_bf16_walk_at_other_widths(m, b, seq, c_in, c_out):
    """Position groups (C_in 128: one position a block), 3-channel dy
    and tables smaller than one k16 step."""
    table = np.random.default_rng(m).integers(0, m, (m, seq))
    _check_k2(tops.build_spiral_tiles(table), table, b, c_in, c_out)

"""The final decoder conv's data paths (plain versions, CPU) against the
JAX package on the same numpy inputs: the matmul-first conv of the
``mixed`` policy (K3b, with ``u`` laid out ``[L, O, N, B]``) and its
backward table, the gather-first bf16 conv (K3a) and the vertex tiles
that K1 narrow and K3a read.

Inputs are rounded to bf16 once in numpy-land where the policy takes
bf16, so both packages see the same bits. Tolerances, each with its
reason:

- an fp32 output of bf16 operands within 1e-5 of the array's max (fp32
  summation order);
- gradients within 1e-2 of each leaf's max: bf16 cotangents pass through
  rounded products, whose rounding differs where an fp32 sum lands near
  a bf16 tie;
- the backward table's twin bit-equal to the per-position transposes:
  the same operations in the same order;
- K1 narrow's fp32 twin within 1e-5 of JAX's max (fp32 summation order);
- K3a's twin (fp32 sums of bf16 products) within 1e-5 of JAX's max.
"""

import importlib
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from craniofacialsd_vae_tpu import ops as jops
from craniofacialsd_vae_tpu.ops.spiral_conv import \
    _spiral_conv_core as jax_conv_core
from craniofacialsd_vae_tpu.ops.spiral_conv import \
    _spiral_conv_core_f32out as jax_conv_core_f32out
from craniofacialsd_vae_tpu_torch import kernels
from craniofacialsd_vae_tpu_torch import ops as tops
from craniofacialsd_vae_tpu_torch.geometry import (extract_spirals,
                                                   load_bundle, octasphere)
from tests.test_training import _tiny_geometry

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "geometry.npz")
BF16 = torch.bfloat16
F32_RTOL = 1e-5
GRAD_RTOL = 1e-2


def _rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _close(got, want, rtol):
    got = (got.detach().float().numpy() if isinstance(got, torch.Tensor)
           else np.asarray(got, np.float32))
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (err, scale)


@pytest.fixture(scope="module")
def fixture_level0():
    return np.asarray(load_bundle(FIXTURE).spirals[0])


@pytest.fixture(scope="module")
def tiny_level0():
    _, bundle = _tiny_geometry(np.random.default_rng(0), return_bundle=True)
    return np.asarray(bundle.spirals[0])


@pytest.fixture(scope="module")
def octasphere_level0():
    pos, face = octasphere(6)
    return extract_spirals(np.asarray(face), np.asarray(pos), 9)


def _table(request, name, identity):
    table = request.getfixturevalue(name).copy()
    if not identity:             # position 0 another position's vertices
        table[:, 0] = table[:, 1]
    return table


# ------------------------------------------------- K3b, the matmul-first conv
@pytest.mark.parametrize("identity", [True, False])
@pytest.mark.parametrize("name,b", [("tiny_level0", 4),
                                    ("fixture_level0", 1),
                                    ("fixture_level0", 4)])
def test_out_gather_conv_matches_jax(request, name, b, identity):
    """The matmul-first conv (``u`` position-major, ``[L, O, N, B]``) and
    its gradients dx, dW and db against ``jax.vjp`` of JAX
    ``spiral_conv_out_gather``, 32 → 3 channels, on a table whose
    transposes have overflow tiers."""
    table = _table(request, name, identity)
    n, seq = table.shape
    rng = np.random.default_rng(n + b)
    w = _rand(rng, seq * 32, 3) * 0.1
    bias = _rand(rng, 3)
    x = _bf16(_rand(rng, n, b, 32))
    dy = _rand(rng, n, b, 3)
    jop = jops.build_spiral_op(table)
    out_j, vjp = jax.vjp(
        lambda w_, b_, x_: jops.spiral_conv_out_gather(
            {"w": w_, "b": b_}, x_, jop),
        jnp.asarray(w), jnp.asarray(bias), jnp.asarray(x, jnp.bfloat16))
    dw_j, db_j, dx_j = vjp(jnp.asarray(dy))
    top = tops.build_spiral_op(table)
    assert (0 in top.identity_cols) == identity
    assert any(g.transpose.tiers for g in top.gathers if g is not None)
    w_t = torch.from_numpy(w).requires_grad_()
    b_t = torch.from_numpy(bias).requires_grad_()
    x_t = torch.from_numpy(x).to(BF16).requires_grad_()
    out_t = tops.spiral_conv_out_gather({"w": w_t, "b": b_t}, x_t, top)
    out_t.backward(torch.from_numpy(dy))
    assert out_t.dtype == torch.float32
    _close(out_t, out_j, F32_RTOL)
    for got, want in ((w_t.grad, dw_j), (b_t.grad, db_j), (x_t.grad, dx_j)):
        _close(got, want, GRAD_RTOL)


def test_out_gather_product_is_position_major_without_copies():
    """``u`` is the product's own rows, ``[L, O, N, B]`` (JAX's
    position-major layout, each ``(l, o)`` a contiguous ``[N, B]`` plane),
    and autograd takes ``du`` into one product each for dW and dx: no
    copy of ``du``, and a contiguous dx."""
    rng = np.random.default_rng(3)
    table = rng.integers(0, 20, size=(20, 5))
    table[:, 0] = np.arange(20)
    op = tops.build_spiral_op(table)
    x = torch.from_numpy(_bf16(_rand(rng, 20, 4, 8))).to(BF16)
    x.requires_grad_()
    w = torch.from_numpy(_rand(rng, 5 * 8, 3)).requires_grad_()
    seen = {}

    def spy(ctx, u, b, op_):
        seen["u"] = u
        ctx.op = op_
        return tops.out_gather_sum_plain(u, op_.table, b)

    fn = importlib.import_module(
        "craniofacialsd_vae_tpu_torch.ops.spiral_conv")._OutGatherSum
    orig = fn.forward
    fn.forward = staticmethod(spy)
    try:
        out = tops.spiral_conv_out_gather({"w": w, "b": torch.zeros(3)}, x,
                                          op)
    finally:
        fn.forward = orig
    u = seen["u"]
    assert u.shape == (5, 3, 20, 4) and u.is_contiguous()
    w_l = w.detach().to(BF16).float().reshape(5, 8, 3)
    want = torch.einsum("nbc,lco->lonb", x.detach().float(), w_l)
    assert float((u - want).abs().max()) <= 1e-5 * float(want.abs().max())
    out.sum().backward()
    assert x.grad.is_contiguous() and w.grad.shape == (40, 3)


def _position_stack(op, dout):
    """The stack of every position's ``CappedEll.apply`` (``dout`` at the
    identity position), in ``u``'s layout."""
    return torch.stack([dout if g is None else g.transpose.apply(dout)
                        for g in op.gathers]).permute(0, 3, 1, 2)


@pytest.mark.parametrize("name,b,o", [("fixture_level0", 16, 3),
                                      ("fixture_level0", 1, 3),
                                      ("tiny_level0", 4, 7),
                                      ("hubs", 3, 5)])
def test_out_gather_bwd_twin_is_the_stack_of_transposes(request, name, b, o):
    """The backward table's twin (the kernel's walk over the concatenated
    per-position transposes) is bit-equal to the stack of the positions'
    ``CappedEll.apply``; ``hubs``: a skewed in-degree that gives every
    position overflow tiers, some of them two or three."""
    if name == "hubs":
        rng = np.random.default_rng(11)
        table = rng.integers(0, 400, size=(400, 9))
        table[:, 0] = np.arange(400)
        for l in range(1, 9):
            table[rng.random(400) < 0.3, l] = rng.integers(0, 4)
    else:
        table = request.getfixturevalue(name)
    op = tops.build_spiral_op(table)
    if name != "tiny_level0":
        tiers = [len(g.transpose.tiers) for g in op.gathers[1:]]
        assert min(tiers) >= 1 and max(tiers) >= 2, tiers
    n = table.shape[0]
    dout = torch.from_numpy(_rand(np.random.default_rng(b), n, b, o))
    got = tops.out_gather_sum_bwd_plain(dout, op.out_bwd)
    assert got.shape == (table.shape[1], o, n, b)
    assert torch.equal(got, _position_stack(op, dout))


def test_out_gather_bwd_table_describes_each_transpose(fixture_level0):
    """``OutGatherBwd.tables()`` gives back every position's transpose
    (main table, tiers and walk) from the flat arrays, and the identity
    position as None."""
    op = tops.build_spiral_op(fixture_level0)
    tables = op.out_bwd.tables()
    assert op.out_bwd.info.shape == (9, 16)
    assert tables[0] is None and op.identity_cols == (0,)
    for g, (cols, vals, tiers, links) in zip(op.gathers[1:], tables[1:]):
        t = g.transpose
        assert torch.equal(cols, t.cols) and torch.equal(vals, t.vals)
        assert len(tiers) == len(t.tiers) and len(links) == len(t.links)
        for (_, c, v), (_, tc, tv) in zip(tiers, t.tiers):
            assert torch.equal(c, tc) and torch.equal(v, tv)
        for a, want in zip(links, t.links):
            assert torch.equal(a, want)


# ------------------------------------------------------ K1 narrow's tiles
@pytest.mark.parametrize("name", ["fixture_level0", "octasphere_level0",
                                  "tiny_level0", "composed"])
def test_narrow_tiles_cover_and_rebuild_the_table(request, name):
    """Every spiral entry is in its tile's list, the lists rebuild the
    table, each tile's list is sorted and unique within the row cap, and
    the tiles own every vertex once."""
    if name == "composed":
        full = request.getfixturevalue("fixture_level0")
        table = full[np.random.default_rng(0).choice(len(full), 4000,
                                                     replace=False)]
        op = tops.build_spiral_op(table, n_src=len(full))
    else:
        table = request.getfixturevalue(name)
        op = tops.build_spiral_op(table)
    tiles = op.tiles
    m, seq = table.shape
    assert torch.equal(tiles.table(), torch.from_numpy(table).int())
    assert sorted(tiles.verts.tolist()) == list(range(m))
    starts, off = tiles.starts.tolist(), tiles.src_off.tolist()
    assert starts[0] == 0 and starts[-1] == m
    assert tiles.max_rows <= max(64, seq)
    for t in range(tiles.n_tiles):
        rows = tiles.src[off[t]:off[t + 1]]
        assert 0 < len(rows) <= tiles.max_rows
        assert bool((rows[1:] > rows[:-1]).all())
        verts = tiles.verts[starts[t]:starts[t + 1]].long()
        local = tiles.local[starts[t]:starts[t + 1]].long()
        assert 0 < len(verts) <= 64
        assert int(local.max()) < len(rows)
        assert torch.equal(rows[local], torch.from_numpy(table)[verts].int())


def _consecutive_tile_rows(table, max_rows=64):
    """Staged rows of tiles of consecutive vertices under the same cap."""
    total, rows = 0, set()
    for v in range(len(table)):
        new = rows.union(table[v].tolist())
        if rows and len(new) > max_rows:
            total, new = total + len(rows), set(table[v].tolist())
        rows = new
    return total + len(rows)


def test_narrow_tiles_reuse_source_rows(fixture_level0, octasphere_level0):
    """The tiles are compact patches: on both level-0 meshes a staged row
    serves more than 3.5 of its tile's spiral entries, and at least 1.5×
    as many as under tiles of consecutive vertices with the same cap."""
    for table in (fixture_level0, octasphere_level0):
        tiles = tops.build_spiral_op(table).tiles
        reuse = table.size / tiles.src.numel()
        consecutive = table.size / _consecutive_tile_rows(table)
        assert reuse > 3.5 and reuse >= 1.5 * consecutive, (reuse,
                                                            consecutive)


@pytest.mark.parametrize("c_out", [1, 3, 7])
def test_narrow_twin_matches_jax(fixture_level0, c_out):
    """K1 narrow's twin (the plain fp32 conv, which the card holds both
    narrow kernels against) against JAX ``_spiral_conv_core`` at the
    final conv's shape, 32 channels in, on the fixture's level 0 at
    B = 2, with the table read back from the op's tiles."""
    rng = np.random.default_rng(c_out)
    table = fixture_level0
    n, seq = table.shape
    w = _rand(rng, seq, 32, c_out) * 0.1
    bias = _rand(rng, c_out)
    x = _rand(rng, n, 2, 32)
    want = jax_conv_core(jnp.asarray(w), jnp.asarray(bias), jnp.asarray(x),
                         jops.build_spiral_op(table))
    rebuilt = tops.build_spiral_op(table).tiles.table().numpy()
    assert np.array_equal(rebuilt, table)
    got = tops.spiral_conv_plain(torch.from_numpy(w), torch.from_numpy(bias),
                                 torch.from_numpy(x),
                                 tops.build_spiral_op(rebuilt))
    _close(got, want, F32_RTOL)


# ----------------------------------------- K3a, the gather-first bf16 conv
@pytest.mark.parametrize("b", [1, 3, 4])
def test_gather_first_f32out_matches_jax_on_the_octasphere(
        octasphere_level0, b):
    """K3a's path (``spiral_conv(..., out_dtype=float32)`` on bf16 x, the
    final conv when ``final_out_gather`` is off) against JAX
    ``_spiral_conv_core_f32out`` on the octasphere's level 0, 32 -> 3
    channels; the op the port builds carries the tiles the card's tiled
    kernel reads."""
    table = octasphere_level0
    n, seq = table.shape
    rng = np.random.default_rng(40 + b)
    w = _bf16(_rand(rng, seq * 32, 3) * 0.1)
    bias = _bf16(_rand(rng, 3))
    x = _bf16(_rand(rng, n, b, 32))
    want = jax_conv_core_f32out(
        jnp.asarray(w.reshape(seq, 32, 3), jnp.bfloat16),
        jnp.asarray(bias, jnp.bfloat16), jnp.asarray(x, jnp.bfloat16),
        jops.build_spiral_op(table))
    op = tops.build_spiral_op(table)
    assert kernels.plan_spiral_conv(
        n, b, seq, 32, 3, True, True, BF16, op.tiles.n_tiles,
        op.tiles.max_rows).path == "bf16_tile"
    got = tops.spiral_conv({"w": torch.from_numpy(w),
                            "b": torch.from_numpy(bias)},
                           torch.from_numpy(x).to(BF16), op, torch.float32)
    assert got.dtype == torch.float32 and got.shape == (n, b, 3)
    _close(got, want, F32_RTOL)


def _tile_launch_rows(plan, tiles, b):
    """The blocks of a ``bf16_tile`` launch as the kernel walks them: for
    each block (tile, batch tile) the 16-row tiles of its (vertex, batch)
    rows, vertex-major, each row's staged entries ``local[v, l]`` mapped
    back to source rows, and the output row it writes. Returns
    ``[(vertex, batch, source rows)]`` and the most staged bytes."""
    verts, starts, src, src_off, local = (t.numpy() for t in (
        tiles.verts, tiles.starts, tiles.src, tiles.src_off, tiles.local))
    out, staged = [], 0
    for blk in range(plan.grid[0]):
        t, bt = divmod(blk, plan.n_btiles)
        b0 = bt * plan.tb
        tb = min(plan.tb, b - b0)
        s0, rows = src_off[t], src_off[t + 1] - src_off[t]
        staged = max(staged, rows * plan.tb * 80)
        v0, nv = starts[t], starts[t + 1] - starts[t]
        for r in range(nv * tb):
            v, bb = divmod(r, tb)
            assert local[v0 + v].max() < rows
            out.append((verts[v0 + v], b0 + bb, src[s0 + local[v0 + v]]))
    return out, staged


@pytest.mark.parametrize("b", [16, 4, 1])
@pytest.mark.parametrize("name", ["fixture_level0", "octasphere_level0"])
def test_bf16_tile_launch_reads_the_table(request, name, b):
    """The tiled K3a launch on both hierarchies' level 0, walked as the
    kernel walks it: every (vertex, batch) output written once, each from
    the source rows ``op.table`` names, every block's staged rows within
    its shared memory."""
    table = request.getfixturevalue(name)
    m = len(table)
    tiles = tops.build_spiral_op(table).tiles
    plan = kernels.plan_spiral_conv(m, b, 9, 32, 3, True, True, BF16,
                                    tiles.n_tiles, tiles.max_rows)
    assert plan.path == "bf16_tile"
    rows, staged = _tile_launch_rows(plan, tiles, b)
    assert staged <= plan.smem
    assert len(rows) == m * b
    assert len({(v, bb) for v, bb, _ in rows}) == m * b
    for v, bb, srcs in rows[::97]:
        assert np.array_equal(srcs, table[v])
    got = np.zeros_like(table)
    for v, _, srcs in rows:
        got[v] = srcs
    assert np.array_equal(got, table)


# ------------------------------------------------------------ the plans
@pytest.mark.parametrize("m,b,c_out", [
    (17039, 16, 3), (17039, 4, 3), (17039, 1, 3), (16386, 16, 3),
    (3000, 20, 7), (3000, 3, 1), (500, 2, 5)])
def test_narrow_tile_plan_fits_the_kernel(m, b, c_out):
    """The tiled narrow plan, at the final conv's shape (9 positions of 32
    channels), obeys csrc/spiral_conv.cu's checks: one block per tile and
    batch tile, at most 8 batch rows, the tile's rows of ``tb`` batch rows
    within its shared memory, three blocks an SM."""
    seq, c_in = 9, 32
    tiles = tops.build_spiral_op(np.random.default_rng(m).integers(
        0, m, size=(m, seq))).tiles
    plan = kernels.plan_spiral_conv(m, b, seq, c_in, c_out,
                                    n_tiles=tiles.n_tiles,
                                    tile_rows=tiles.max_rows)
    assert plan.path == "narrow_tile" and plan.kernel == "spiral_conv_narrow"
    assert 1 <= plan.tb <= min(b, 8) and plan.n_btiles == -(-b // plan.tb)
    assert plan.grid == (tiles.n_tiles * plan.n_btiles, 1)
    assert plan.rows == tiles.max_rows
    tbm = 1 if plan.tb == 1 else 4 if plan.tb <= 4 else 8
    assert 4 * plan.rows * tbm * c_in <= plan.smem <= 233472 // 3 - 1024
    assert plan.smem % 16 == 0 and plan.vec_x
    assert plan.threads == (256 if plan.tb > 4 else 128)
    ints = plan.as_ints()
    assert ints[0] == 3 and ints[-1] == plan.rows


@pytest.mark.parametrize("b", [16, 4, 1, 3, 20])
@pytest.mark.parametrize("name", ["fixture_level0", "octasphere_level0"])
def test_bf16_tile_plan_fits_the_kernel(request, name, b):
    """K3a's plan for the final conv (9 positions of 32 channels, 3 out)
    with the op's tiles on both hierarchies: the tiled kernel, one block
    per tile and batch tile, the most batch rows (at most 16, in even
    tiles) whose 80-byte staged entries let three blocks share an SM
    (8 at B = 16), four warps a block; a float32 conv keeps
    ``narrow_tile``."""
    table = request.getfixturevalue(name)
    m = len(table)
    tiles = tops.build_spiral_op(table).tiles
    plan = kernels.plan_spiral_conv(m, b, 9, 32, 3, True, True, BF16,
                                    tiles.n_tiles, tiles.max_rows)
    assert plan.path == "bf16_tile" and plan.kernel == "spiral_conv_bf16"
    assert plan.rows == tiles.max_rows and plan.threads == 128
    assert 1 <= plan.tb <= min(b, 16) and plan.n_btiles == -(-b // plan.tb)
    assert plan.grid == (tiles.n_tiles * plan.n_btiles, 1)
    assert tiles.max_verts <= 64
    assert 2560 + 4608 + 80 * plan.rows * plan.tb <= plan.smem \
        <= 233472 // 3 - 1024
    assert plan.smem % 16 == 0
    if b == 16:
        assert plan.tb == 8
    wider = kernels.bf16_tile_plan(b, tiles.n_tiles, tiles.max_rows,
                                   2 * plan.tb, 128)
    assert wider.tb == plan.tb or wider.smem > 233472 // 3 - 1024
    assert kernels.plan_spiral_conv(
        m, b, 9, 32, 3, n_tiles=tiles.n_tiles,
        tile_rows=tiles.max_rows).path == "narrow_tile"


def test_bf16_plan_without_tiles_or_at_another_shape():
    """Without tiles or with x off 4 bytes the bf16 planner takes the
    untiled kernel's element path (``_plan_bf16``); at another shape
    than K3a's tiled kernel's (9 positions of 32 channels) or at C_out
    >= 8, the tiled vector path (``_plan_bf16_vec``)."""
    assert kernels.plan_spiral_conv(3000, 16, 9, 32, 3, True, True,
                                    BF16).path == "bf16_elem"
    assert kernels.plan_spiral_conv(3000, 16, 9, 32, 3, False, True, BF16,
                                    50, 64).path == "bf16_elem"
    for seq, c_in, c_out in ((9, 16, 3), (9, 64, 3), (7, 32, 3),
                             (9, 32, 8), (9, 32, 32)):
        assert kernels.plan_spiral_conv(3000, 16, seq, c_in, c_out, True,
                                        True, BF16, 50, 64).path == "bf16"


def test_narrow_plan_without_tiles_or_at_another_shape():
    """Without tiles, or at another shape than the tiled kernel's (9
    positions of 32 channels), the planner takes the untiled narrow
    kernel."""
    assert kernels.plan_spiral_conv(3000, 16, 9, 32, 3).path == "narrow_out"
    for seq, c_in in ((9, 16), (9, 64), (7, 32)):
        assert kernels.plan_spiral_conv(3000, 16, seq, c_in, 3, n_tiles=50,
                                        tile_rows=64).path == "narrow_out"

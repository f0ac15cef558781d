"""The final decoder conv's data paths (plain versions, CPU) against the
JAX package on the same numpy inputs: the matmul-first conv of the
``mixed`` policy (K3b, with ``u`` laid out ``[L, O, N, B]``) and its
backward table, and K1 narrow's vertex tiles.

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
- K1 narrow's fp32 twin within 1e-5 of JAX's max (fp32 summation order).
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


def test_narrow_plan_without_tiles_or_at_another_shape():
    """Without tiles, or at another shape than the tiled kernel's (9
    positions of 32 channels), the planner takes the untiled narrow
    kernel."""
    assert kernels.plan_spiral_conv(3000, 16, 9, 32, 3).path == "narrow_out"
    for seq, c_in in ((9, 16), (9, 64), (7, 32)):
        assert kernels.plan_spiral_conv(3000, 16, seq, c_in, 3, n_tiles=50,
                                        tile_rows=64).path == "narrow_out"

"""The backward kernels' host side, on the CPU: K2-dW's launch plans and
the twin that sums in a plan's chunk order, and the overflow-tier walk
of the fused ELL launch (``ell_matmul_capped``) with its plain twin.

Every plan is held to the limits ``csrc/spiral_conv_dw.cu`` checks and
to covering each vertex and each spiral position once. The twins are
held against the plain versions and against the JAX package on the same
numpy inputs: dW within rtol 1e-5 of max |dW| (fp32 sums of M·B products
taken in another order), the tier walk bit for bit against K4's twin
followed by one ``index_add`` per tier (the same roundings in the same
order), and within rtol 1e-5, atol 1e-6 of JAX's ``CappedEll.apply``."""

import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from craniofacialsd_vae_tpu import ops as jops
from craniofacialsd_vae_tpu.geometry.precompute import _save_bundle
from craniofacialsd_vae_tpu.ops import sparse as jsparse
from craniofacialsd_vae_tpu.ops.spiral_conv import _spiral_conv_core
from craniofacialsd_vae_tpu_torch import kernels
from craniofacialsd_vae_tpu_torch import ops as tops
from craniofacialsd_vae_tpu_torch.geometry import (load_bundle,
                                                   standin_laplacian_coo)
from craniofacialsd_vae_tpu_torch.models import (SDVAEConfig, SpiralGeometry,
                                                 init_sdvae)
from craniofacialsd_vae_tpu_torch.ops import sparse as tsparse
from tests.test_training import _tiny_geometry

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "geometry.npz")
CSRC = os.path.join(os.path.dirname(kernels.__file__), "csrc")
RTOL = 1e-5
TOL = dict(rtol=1e-5, atol=1e-6)
SMEM_BLOCK = 232448
ONE_WAVE = 2 * 132          # K2-dW's blocks per SM times the H100's SMs

# the smoke model's convs (configurations/smoke.yaml: channels 32/32/32/64)
# on the fixture: (name, M, C_in, C_out), all with L = 9
_SMOKE_CONVS = [("enc0", 4260, 3, 32), ("enc1", 1065, 32, 32),
                ("enc2", 267, 32, 32), ("enc3", 67, 32, 64),
                ("dec3", 267, 64, 64), ("dec2", 1065, 64, 32),
                ("dec1", 4260, 32, 32), ("dec0", 17039, 32, 32),
                ("final", 17039, 32, 3)]
# the card tests' other shapes: (M, B, L, C_in, C_out)
_ODD_SHAPES = [(50, 1, 3, 1, 1), (333, 3, 7, 10, 18), (100, 2, 9, 128, 96),
               (700, 20, 5, 3, 64), (20, 1, 9, 64, 3), (90, 70, 9, 8, 8)]


def _rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _model_convs(model, geom):
    """``(name, spiral op, C_in, C_out)`` of every conv of a forward pass."""
    n = len(model.en_convs)
    convs = [(f"enc{i}", model.en_convs[i], geom.enc_spirals[i])
             for i in range(n)]
    convs += [(f"dec{n - 1 - j}", model.de_convs[j], geom.spirals[n - 1 - j])
              for j in range(n)]
    convs.append(("final", model.final_conv, geom.spirals[0]))
    return [(name, op, conv.w.shape[0] // op.seq_length, conv.w.shape[1])
            for name, conv, op in convs]


def _backward_tables(model, geom):
    """``(name, CappedEll)`` of every transpose a training step applies:
    the Laplacian's, then each conv's combined transposes (the first
    encoder conv reads the data and has none applied) and each up-pool's."""
    tables = [("lap T", geom.laplacian.transpose)]
    for name, op, _, _ in reversed(_model_convs(model, geom)):
        if name != "enc0":
            tables += [(f"{name} T", t) for t in op.inv_tables]
        if name.startswith("dec"):
            tables.append((f"up{name[3:]} T", geom.up[int(name[3:])].transpose))
    return tables


@pytest.fixture(scope="module")
def fixture_geometry():
    bundle = load_bundle(FIXTURE)
    geom = SpiralGeometry.from_bundle(
        bundle, device="cpu", laplacian=standin_laplacian_coo(bundle.spirals[0]))
    model = init_sdvae(SDVAEConfig(), geom, torch.Generator().manual_seed(0))
    return geom, model


@pytest.fixture(scope="module")
def tiny_geometry(tmp_path_factory):
    geom_j, bundle_j = _tiny_geometry(np.random.default_rng(11),
                                      return_bundle=True)
    path = str(tmp_path_factory.mktemp("bwd") / "geometry.npz")
    _save_bundle(path, bundle_j)
    geom = SpiralGeometry.from_bundle(load_bundle(path), device="cpu",
                                      laplacian=bundle_j.template.laplacian)
    model = init_sdvae(SDVAEConfig(out_channels=(8, 16), latent_size=6), geom,
                       torch.Generator().manual_seed(0))
    return geom, model


# ------------------------------------------------------------ K2-dW plans
def _built_kernels():
    """The (MI, NI) warp tiles csrc/spiral_conv_dw.cu dispatches to."""
    with open(os.path.join(CSRC, "spiral_conv_dw.cu")) as f:
        src = f.read()
    return {tuple(map(int, t)) for t in
            re.findall(r"launch_dw<(\d+), (\d+)>\(p, plan", src)}


def _check_dw_plan(plan, m, b, seq, c_in, c_out):
    """The limits csrc/spiral_conv_dw.cu checks, and coverage: every
    vertex in exactly one tile of exactly one chunk, every position in
    exactly one group, every output column in exactly one output block."""
    assert (plan.mi, plan.ni) in _built_kernels()
    assert plan.mi * plan.ni * 4 <= 32                        # accumulators
    # a warp per (position, warp block): at most nine warps a block
    assert plan.threads == 32 * plan.positions * plan.fgm * plan.fgn <= 288
    # vertices: tiles of tmv, chunks of tiles_per_chunk tiles
    assert plan.n_vtiles == -(-m // plan.tmv)
    seen = np.zeros(m, int)
    for c in range(plan.n_chunks):
        first = c * plan.tiles_per_chunk
        assert first < plan.n_vtiles
        for t in range(first, min(first + plan.tiles_per_chunk,
                                  plan.n_vtiles)):
            seen[t * plan.tmv:(t + 1) * plan.tmv] += 1
    assert (seen == 1).all()
    assert plan.n_chunks * plan.tiles_per_chunk >= plan.n_vtiles
    # positions: groups of P
    assert plan.groups * plan.positions == seq
    assert sorted(g * plan.positions + j for g in range(plan.groups)
                  for j in range(plan.positions)) == list(range(seq))
    # outputs: the wider side on the MMA's M, blocks of bm x bn
    wide, narrow = (c_in, c_out) if plan.x_on_m else (c_out, c_in)
    assert plan.x_on_m == (c_in >= c_out)
    bm, bn = 16 * plan.mi * plan.fgm, 8 * plan.ni * plan.fgn
    assert (plan.zm - 1) * bm < wide <= plan.zm * bm
    assert (plan.zn - 1) * bn < narrow <= plan.zn * bn
    cover_x, cover_d = ((plan.zm * bm, plan.zn * bn) if plan.x_on_m
                        else (plan.zn * bn, plan.zm * bm))
    for ld, cover in ((plan.ldx, cover_x), (plan.ldd, cover_d)):
        assert ld >= cover and ld % 32 in (8, 24)    # conflict-free loads
    # shared memory: the stages' mbarriers, the ring (each stage a tile of
    # every position's x rows and its dy rows) and the chunk's table slice
    assert plan.rows_p % 8 == 0 and plan.rows_p >= plan.tmv * b
    assert 2 <= plan.stages <= 8
    need = 4 * (16 + plan.stages * plan.rows_p * (plan.positions * plan.ldx
                                                  + plan.ldd)
                + plan.tiles_per_chunk * plan.tmv * plan.positions)
    assert need <= plan.smem <= SMEM_BLOCK and plan.smem % 16 == 0
    assert plan.vec_x == (c_in % 4 == 0) and plan.vec_d == (c_out % 4 == 0)
    assert plan.blocks == plan.n_chunks * plan.groups * plan.zm * plan.zn


@pytest.mark.parametrize("b", [1, 4, 16])
@pytest.mark.parametrize("name,m,c_in,c_out", _SMOKE_CONVS)
def test_dw_plan_on_the_smoke_convs(name, m, c_in, c_out, b):
    plan = kernels.plan_spiral_conv_dw(m, b, 9, c_in, c_out)
    _check_dw_plan(plan, m, b, 9, c_in, c_out)
    assert plan.blocks <= ONE_WAVE
    if m * b >= 4260 * 4:                 # the large levels fill the card
        assert plan.blocks >= 132
    if max(c_in, c_out) <= 32:            # dy staged once for all nine
        assert plan.positions == 9 and plan.groups == 1
        assert plan.blocks >= 132 or m * b < 1065 * 16
    unaligned = kernels.plan_spiral_conv_dw(m, b, 9, c_in, c_out, False,
                                            False)
    assert not unaligned.vec_x and not unaligned.vec_d


@pytest.mark.parametrize("m,b,seq,c_in,c_out", _ODD_SHAPES)
def test_dw_plan_on_other_shapes(m, b, seq, c_in, c_out):
    _check_dw_plan(kernels.plan_spiral_conv_dw(m, b, seq, c_in, c_out),
                   m, b, seq, c_in, c_out)


@pytest.mark.parametrize("b", [1, 4, 16])
def test_dw_plan_on_the_tiny_convs(tiny_geometry, b):
    geom, model = tiny_geometry
    for _, op, c_in, c_out in _model_convs(model, geom):
        m, seq = op.table.shape
        _check_dw_plan(kernels.plan_spiral_conv_dw(m, b, seq, c_in, c_out),
                       m, b, seq, c_in, c_out)


def test_dw_plan_fields_follow_the_kernel_enum():
    """DwPlan.as_ints lays its fields out in csrc/spiral_conv_dw.cu's
    DwField order."""
    with open(os.path.join(CSRC, "spiral_conv_dw.cu")) as f:
        src = f.read()
    enum = re.search(r"enum DwField \{(.*?)\};", src, re.S).group(1)
    names = [n.strip() for n in enum.split(",") if n.strip()]
    assert names[-1] == "kDwFields"
    plan = kernels.plan_spiral_conv_dw(17039, 16, 9, 32, 3)
    by_name = dict(zip(names, plan.as_ints()))
    assert len(plan.as_ints()) == len(names) - 1
    assert by_name["kXOnM"] == 1 and by_name["kMI"] == plan.mi
    assert by_name["kP"] == plan.positions
    assert by_name["kTMV"] == plan.tmv and by_name["kSmem"] == plan.smem
    assert (by_name["kChunks"], by_name["kGroups"],
            by_name["kZM"] * by_name["kZN"]) == plan.grid


def test_dw_plan_rejects_empty_shapes():
    for bad in [(0, 1, 9, 8, 8), (10, 0, 9, 8, 8), (10, 1, 9, 0, 8)]:
        with pytest.raises(ValueError):
            kernels.plan_spiral_conv_dw(*bad)


# ------------------------------------------------- K2-dW twin, chunk order
def _jax_dw(table, n_src, x, dy):
    """JAX's dW: the w_l cotangent of ``_spiral_conv_core``'s custom VJP."""
    jop = jops.build_spiral_op(table, n_src=n_src)
    seq, c_in, c_out = table.shape[1], x.shape[-1], dy.shape[-1]
    w_l = jnp.zeros((seq, c_in, c_out), jnp.float32)
    b = jnp.zeros((c_out,), jnp.float32)
    _, vjp = jax.vjp(lambda w_: _spiral_conv_core(w_, b, jnp.asarray(x), jop),
                     w_l)
    return np.asarray(vjp(jnp.asarray(dy))[0])


def _dw_case(table, n_src, b, c_in, c_out, seed):
    rng = np.random.default_rng(seed)
    x, dy = _rand(rng, n_src, b, c_in), _rand(rng, table.shape[0], b, c_out)
    m, seq = table.shape
    plan = kernels.plan_spiral_conv_dw(m, b, seq, c_in, c_out)
    xt, dyt = torch.from_numpy(x), torch.from_numpy(dy)
    tab = torch.from_numpy(table.astype(np.int32))
    got = tops.spiral_conv_dw_chunked_plain(xt, tab, dyt, plan)
    plain = tops.spiral_conv_dw_plain(xt, tab, dyt)
    want = _jax_dw(table, n_src, x, dy)
    scale = float(np.abs(want).max())
    assert got.shape == plain.shape == want.shape
    assert float((got - plain).abs().max()) <= RTOL * scale
    assert float(np.abs(got.numpy() - want).max()) <= RTOL * scale
    return plan


@pytest.mark.parametrize("b", [1, 4, 16])
def test_dw_chunk_order_twin_on_the_tiny_convs(tiny_geometry, b):
    geom, model = tiny_geometry
    for i, (_, op, c_in, c_out) in enumerate(_model_convs(model, geom)):
        _dw_case(op.table.numpy(), op.n_src, b, c_in, c_out, seed=10 * b + i)


@pytest.mark.parametrize("name,b", [("enc0", 4), ("final", 2), ("dec1", 1)])
def test_dw_chunk_order_twin_on_the_fixture(fixture_geometry, name, b):
    """Fixture levels whose plans have many chunks; the widths are the
    smoke model's."""
    geom, model = fixture_geometry
    (_, op, c_in, c_out), = [c for c in _model_convs(model, geom)
                             if c[0] == name]
    plan = _dw_case(op.table.numpy(), op.n_src, b, c_in, c_out, seed=b)
    assert plan.n_chunks > 1


# ------------------------------------------------------------ tier walk
def _check_tiers(mat):
    """Each tier's rows sorted and unique, and among the previous tier's
    (the main table's rows for the first); the walk reaches exactly them."""
    m = mat.cols.shape[0]
    prev = np.arange(m)
    for (rows, cols, vals), link, nxt in zip(mat.tiers, mat.links,
                                             mat.links[1:]):
        r = rows.numpy()
        assert (np.diff(r) > 0).all() and np.isin(r, prev).all()
        assert cols.shape == vals.shape and cols.shape[0] == len(r)
        assert link.dtype == nxt.dtype == torch.int32
        assert len(link) == len(prev) and len(nxt) == len(r)
        slots = link.numpy()
        assert np.array_equal(prev[slots >= 0], r)
        assert np.array_equal(slots[slots >= 0], np.arange(len(r)))
        prev = r
    assert (mat.links[-1].numpy() == -1).all()


def _check_fused_twin(mat, d, seed):
    """The walk-driven twin bit-equal to K4's twin plus one index_add per
    tier, and within TOL of JAX's CappedEll.apply."""
    n_src = int(mat.cols.max()) + 1
    for _, cols, _ in mat.tiers:
        n_src = max(n_src, int(cols.max()) + 1)
    x = _rand(np.random.default_rng(seed), n_src, d)
    xt = torch.from_numpy(x)
    got = tsparse.ell_matmul_capped_plain(mat.cols, mat.vals, mat.tiers,
                                          mat.links, xt)
    seq = tops.ell_matmul_plain(mat.cols, mat.vals, xt)
    for rows, cols, vals in mat.tiers:
        tsparse.ell_tier_add_plain(rows, cols, vals, xt, seq)
    assert torch.equal(got, seq)
    assert torch.equal(mat.apply(xt), seq)
    jmat = jsparse.CappedEll(
        jnp.asarray(mat.cols.numpy()), jnp.asarray(mat.vals.numpy()),
        tuple(tuple(jnp.asarray(t.numpy()) for t in tier)
              for tier in mat.tiers))
    np.testing.assert_allclose(got.numpy(), np.asarray(jmat.apply(x)), **TOL)


def test_tier_walk_on_the_fixture_tables(fixture_geometry):
    """The 13 transposes a smoke-model step applies, all with overflow
    tiers (34 in all: one fused launch each on the card)."""
    geom, model = fixture_geometry
    tables = _backward_tables(model, geom)
    assert len(tables) == 13
    assert all(mat.tiers for _, mat in tables)
    assert sum(len(mat.tiers) for _, mat in tables) == 34
    for i, (name, mat) in enumerate(tables):
        _check_tiers(mat)
        _check_fused_twin(mat, 8, seed=i)


def test_tier_walk_on_the_tiny_tables(tiny_geometry):
    geom, model = tiny_geometry
    tables = _backward_tables(model, geom)
    assert any(mat.tiers for _, mat in tables)
    for i, (name, mat) in enumerate(tables):
        if mat.tiers:
            _check_tiers(mat)
            _check_fused_twin(mat, 6, seed=i)
        else:
            assert mat.links == ()


def test_tier_walk_on_deep_random_tiers():
    """Hub rows of several degrees: three tiers, the deepest holding one
    row; the walk survives a move to another device and back."""
    rng = np.random.default_rng(3)
    m, n = 60, 500
    degrees = [300, 150, 80, 40, 20, 10, 5]
    rows = np.concatenate([np.repeat(np.arange(7) * 7 + 1, degrees),
                           rng.integers(0, m, 200)])
    cols = rng.integers(0, n, len(rows))
    mat = tsparse.capped_ell(rows, cols, _rand(rng, len(rows)), m)
    assert len(mat.tiers) == 3 and len(mat.tiers[-1][0]) >= 1
    _check_tiers(mat)
    _check_fused_twin(mat, 5, seed=4)
    moved = mat.to("cpu")
    assert all(torch.equal(a, b) for a, b in zip(moved.links, mat.links))


def test_tier_walk_rejects_tiers_capped_ell_does_not_build():
    cols = torch.zeros(6, 2, dtype=torch.int32)
    vals = torch.ones(6, 2)
    tier = lambda r: (torch.tensor(r, dtype=torch.int32),   # noqa: E731
                      torch.zeros(len(r), 1, dtype=torch.int32),
                      torch.ones(len(r), 1))
    for bad in ([tier([3, 1])],                 # not sorted
                [tier([1, 1])],                 # not unique
                [tier([1, 6])],                 # beyond the table
                [tier([1, 3]), tier([2])]):     # not among tier 1's rows
        with pytest.raises(ValueError):
            tsparse.CappedEll(cols, vals, tuple(bad))

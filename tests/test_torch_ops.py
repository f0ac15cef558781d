"""The port's ops (their plain versions, on the CPU) against the JAX ops
on the same numpy inputs.

Tolerance: rtol 1e-5, atol 1e-6 — fp32 products summed in another order
by XLA and by PyTorch on the CPU."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from craniofacialsd_vae_tpu.geometry.simplify import SparseCOO
from craniofacialsd_vae_tpu import ops as jops
from craniofacialsd_vae_tpu.ops import sparse as jsparse
from craniofacialsd_vae_tpu_torch import ops as tops
from craniofacialsd_vae_tpu_torch.geometry import load_bundle
from craniofacialsd_vae_tpu_torch.ops import sparse as tsparse

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "geometry.npz")
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def bundle():
    return load_bundle(FIXTURE)


def _rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("trailing", [(3, 5), (4,), (2, 3, 2)])
def test_ell_matmul_raw(trailing):
    rng = np.random.default_rng(0)
    m, n = 23, 41
    rows = np.repeat(np.arange(m), 3)
    cols = rng.integers(0, n, size=3 * m)
    vals = _rand(rng, 3 * m)
    mat_t = tsparse.from_coo(rows[:-1], cols[:-1], vals[:-1], (m, n))
    mat_j = jsparse.from_coo(rows[:-1], cols[:-1], vals[:-1], (m, n))
    x = _rand(rng, n, *trailing)
    out = tsparse.ell_matmul_raw(mat_t.cols, mat_t.vals, torch.from_numpy(x))
    ref = jsparse.ell_matmul_raw(mat_j.cols, mat_j.vals, jnp.asarray(x))
    assert out.shape == (m, *trailing)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_ell_matmul_padding_does_not_leak():
    """Padded entries point at row 0 with weight 0: a huge row 0 must not
    move rows that do not reference it."""
    rng = np.random.default_rng(1)
    rows = np.array([0, 0, 0, 1])
    cols = np.array([1, 2, 3, 2])
    vals = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    mat = tsparse.from_coo(rows, cols, vals, (2, 4))
    x = _rand(rng, 4, 6)
    x[0] = 1e30
    out = tsparse.ell_matmul(mat, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out[1], 4.0 * x[2], **TOL)


def test_capped_ell_apply_transpose():
    """The transposes (kept for the backward of a later slice) apply as
    the dense transpose does."""
    rng = np.random.default_rng(2)
    m, n = 30, 70
    rows, cols = [], []
    for r, d in enumerate([60, 20] + [2] * (m - 2)):
        cs = rng.choice(n, size=d, replace=False)
        rows += [r] * d
        cols += list(cs)
    rows, cols = np.asarray(rows), np.asarray(cols)
    vals = _rand(rng, len(rows))
    ce_t = tsparse.capped_ell(rows, cols, vals, m)
    ce_j = jsparse.capped_ell(rows, cols, vals, m)
    assert len(ce_t.tiers) >= 1
    x = _rand(rng, n, 3)
    np.testing.assert_allclose(ce_t.apply(torch.from_numpy(x)).numpy(),
                               np.asarray(ce_j.apply(jnp.asarray(x))), **TOL)


def test_gather_rows():
    rng = np.random.default_rng(3)
    idx = rng.integers(0, 50, size=20)
    x = _rand(rng, 50, 4, 3)
    out = tsparse.gather_rows(tsparse.gather_op_from_idx(idx, 50),
                              torch.from_numpy(x))
    ref = jsparse.gather_rows(jsparse.gather_op_from_idx(idx, 50),
                              jnp.asarray(x))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def _conv_case(rng, table, n_src, b, c_in, c_out):
    w = _rand(rng, table.shape[1] * c_in, c_out) * 0.3
    bias = _rand(rng, c_out)
    x = _rand(rng, n_src, b, c_in)
    top = tops.build_spiral_op(table, n_src=n_src)
    jop = jops.build_spiral_op(table, n_src=n_src)
    out = tops.spiral_conv({"w": torch.from_numpy(w),
                            "b": torch.from_numpy(bias)},
                           torch.from_numpy(x), top)
    ref = jops.spiral_conv({"w": jnp.asarray(w), "b": jnp.asarray(bias)},
                           jnp.asarray(x), jop)
    assert out.shape == (table.shape[0], b, c_out)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    return top


@pytest.mark.parametrize("b,c_in,c_out", [(3, 3, 8), (2, 8, 3), (4, 16, 16)])
def test_spiral_conv_identity_table(b, c_in, c_out):
    rng = np.random.default_rng(4)
    m, l = 40, 7
    table = rng.integers(0, m, size=(m, l))
    table[:, 0] = np.arange(m)
    op = _conv_case(rng, table, m, b, c_in, c_out)
    assert op.identity_cols == (0,)


def test_spiral_conv_composed_table(bundle):
    """The encoder's first conv composed with down0 (4,260 rows gathered
    from 17,039), at a narrow width."""
    rng = np.random.default_rng(5)
    sel = tops.selection_indices(bundle.down[0])
    table = bundle.spirals[0][sel]
    op = _conv_case(rng, table, 17039, 2, 3, 4)
    assert op.identity_cols == () and op.num_vertices == 4260


def test_spiral_conv_rejects_wrong_source_rows():
    op = tops.build_spiral_op(np.array([[0, 1], [1, 0]]))
    params = {"w": torch.zeros(2, 1), "b": torch.zeros(1)}
    with pytest.raises(ValueError):
        tops.spiral_conv(params, torch.zeros(3, 1, 1), op)


@pytest.mark.parametrize("level", [0, 3])
def test_pool_up_and_down(bundle, level):
    rng = np.random.default_rng(6 + level)
    n_fine, n_coarse = bundle.vertex_counts[level:level + 2]
    for coo, n_in in ((bundle.up[level], n_coarse),
                      (bundle.down[level], n_fine)):
        x = _rand(rng, n_in, 2, 3)
        out = tops.pool(torch.from_numpy(x),
                        tops.build_pool_operator(coo))
        jop = jops.build_pool_operator(
            SparseCOO(coo.rows, coo.cols, coo.vals, coo.shape))
        ref = jops.pool(jnp.asarray(x), jop)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


# the smoke model's convs (configurations/smoke.yaml: channels 32/32/32/64)
# as (name, level of M, level of the source rows, C_in, C_out)
_SMOKE_CONVS = [("enc0", 1, 0, 3, 32), ("enc1", 2, 1, 32, 32),
                ("enc2", 3, 2, 32, 32), ("enc3", 4, 3, 32, 64),
                ("dec3", 3, 3, 64, 64), ("dec2", 2, 2, 64, 32),
                ("dec1", 1, 1, 32, 32), ("dec0", 0, 0, 32, 32),
                ("final", 0, 0, 32, 3)]
_COUNTS = [17039, 4260, 1065, 267, 67]     # the fixture's vertex counts
# the card tests' odd shapes: (M, B, L, C_in, C_out)
_ODD_SHAPES = [(700, 20, 5, 16, 256), (50, 1, 3, 1, 1), (3000, 16, 9, 32, 3),
               (4260, 16, 9, 3, 32), (1065, 16, 9, 64, 32), (333, 3, 7, 10, 20),
               (123, 2, 9, 8, 64)]
_PLAN_CASES = ([pytest.param(_COUNTS[lm], b, 9, ci, co, id=f"{n}-B{b}")
                for n, lm, _, ci, co in _SMOKE_CONVS for b in (1, 4, 16)]
               + [pytest.param(*s, id="x".join(map(str, s)))
                  for s in _ODD_SHAPES])


def test_smoke_conv_shapes_match_the_fixture(bundle):
    assert bundle.vertex_counts == _COUNTS
    assert all(sp.shape[1] == 9 for sp in bundle.spirals)


@pytest.mark.parametrize("m,b,seq,c_in,c_out", _PLAN_CASES)
def test_spiral_conv_plan_fits_the_kernel(m, b, seq, c_in, c_out):
    """The host's K1 plan obeys csrc/spiral_conv.cu's limits: its path,
    shared memory within 232,448 bytes (the launcher opts in above
    48 KB), at most 256 threads, at least 132 blocks wherever the level
    has 132·16 GEMM rows, 16-byte copies only for 16-byte segments, and
    tiles that cover every output once."""
    from craniofacialsd_vae_tpu_torch.kernels import plan_spiral_conv

    plan = plan_spiral_conv(m, b, seq, c_in, c_out)
    assert plan.path == ("narrow_out" if c_out < 8 else
                         "tc_pad_k" if c_in < 8 else "tc")
    assert 0 < plan.smem <= 232448 and plan.smem % 16 == 0
    assert 32 <= plan.threads <= 256 and plan.threads % 32 == 0
    if m * b >= 132 * 16:
        assert plan.blocks >= 132
    assert 1 <= plan.tb <= b and plan.n_btiles == -(-b // plan.tb)
    unaligned = plan_spiral_conv(m, b, seq, c_in, c_out, False, False)
    if plan.path == "narrow_out":
        assert plan.tb <= 8
        assert plan.blocks * plan.threads // 32 >= m * plan.n_btiles
        assert plan.smem >= 4 * seq * c_in * c_out
        return
    rows = plan.warps_m * 16 * plan.mi
    assert plan.threads == 32 * plan.warps_m * (plan.nt // (8 * plan.ni))
    assert plan.tm * plan.tb <= rows
    assert plan.n_rtiles == -(-m // plan.tm) * plan.n_btiles
    assert plan.grid[0] <= plan.n_rtiles
    assert (plan.grid[1] - 1) * plan.nt < c_out <= plan.grid[1] * plan.nt
    assert seq % plan.positions == 0
    assert plan.kp % 8 == 0 and plan.kp >= plan.positions * c_in
    assert plan.lda % 8 == 4 and plan.ldw % 16 == 8   # conflict-free
    assert 2 <= plan.stages <= seq // plan.positions + 1
    need = 4 * (plan.stages * (rows * plan.lda + plan.kp * plan.ldw)
                + 2 * plan.tm * seq)
    assert need <= plan.smem
    # every row tile is walked by exactly one block
    walked = sorted(t for x in range(plan.grid[0])
                    for t in range(x, plan.n_rtiles, plan.grid[0]))
    assert walked == list(range(plan.n_rtiles))
    assert plan.vec_x == (c_in % 4 == 0) and plan.vec_w == (c_out % 4 == 0)
    assert not unaligned.vec_x and not unaligned.vec_w


@pytest.mark.parametrize("m,b,c_in,c_out", [
    (257, 16, 64, 64),        # the octasphere's dec3
    (1065, 4, 64, 32),        # the fixture's dec2 at B = 4
    (1025, 4, 64, 32),        # the octasphere's dec2 at B = 4
    (267, 16, 64, 64)])       # the fixture's dec3
def test_spiral_plan_covers_the_tiles_of_busy_small_levels(m, b, c_in,
                                                           c_out):
    """At a small level with 132·16 GEMM rows or more, the planner sizes
    its tile for two blocks an SM, with at least four warps, and launches
    as many blocks as two an SM hold (or one per tile): the plans
    ``k1_sweep`` timed faster than the library call on an H100, where one
    block an SM walking two tiles, or a one-warp tile, was slower
    (PERF.md)."""
    from craniofacialsd_vae_tpu_torch.kernels import plan_spiral_conv

    plan = plan_spiral_conv(m, b, 9, c_in, c_out)
    assert plan.threads >= 128
    assert plan.smem <= 233472 // 2 - 1024
    assert plan.blocks >= min(plan.n_rtiles * plan.grid[1], 2 * 132)


def test_spiral_plan_fields_follow_the_kernel_enum():
    """SpiralPlan.as_ints lays its fields out in csrc/spiral_conv.cu's
    PlanField order."""
    import re

    from craniofacialsd_vae_tpu_torch import kernels

    with open(os.path.join(os.path.dirname(kernels.__file__), "csrc",
                           "spiral_conv.cu")) as f:
        src = f.read()
    enum = re.search(r"enum PlanField \{(.*?)\};", src, re.S).group(1)
    names = [n.strip() for n in enum.split(",") if n.strip()]
    assert names[-1] == "kPlanFields"
    plan = kernels.plan_spiral_conv(1065, 16, 9, 32, 32)
    ints = plan.as_ints()
    assert len(ints) == len(names) - 1
    by_name = dict(zip(names, ints))
    assert by_name["kThreads"] == plan.threads
    assert (by_name["kGridX"], by_name["kGridY"]) == plan.grid
    assert by_name["kPositions"] == plan.positions
    assert by_name["kStages"] == plan.stages and by_name["kKP"] == plan.kp


def test_spiral_plan_rejects_shapes_no_path_takes():
    from craniofacialsd_vae_tpu_torch.kernels import plan_spiral_conv

    for bad in [(10, 1, 9, 32, 0), (10, 1, 9, 32, 257), (0, 1, 9, 8, 8),
                (10, 1, 9, 8192, 256)]:
        with pytest.raises(ValueError):
            plan_spiral_conv(*bad)


def _rna_tf32(t: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: round to nearest, ties away from zero, on the low
    13 mantissa bits (finite values)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _k1_tf32(w_l, b, x, table, passes):
    """K1 in TF32 on the tensor cores: each product of TF32 operands is
    exact in fp32 and is summed in fp32. ``passes`` 3: 3xTF32 (a_lo·w_hi
    + a_hi·w_lo + a_hi·w_hi); 1: a single TF32 pass."""
    w_hi = _rna_tf32(w_l)
    w_lo = _rna_tf32(w_l - w_hi)
    out = b.expand(table.shape[0], x.shape[1], -1)
    for i in range(table.shape[1]):
        a = x[table[:, i]]
        a_hi = _rna_tf32(a)
        a_lo = _rna_tf32(a - a_hi)
        term = a_hi @ w_hi[i]
        if passes == 3:
            term = (a_lo @ w_hi[i] + a_hi @ w_lo[i]) + term
        out = out + term
    return out


@pytest.mark.parametrize("c_in,c_out", [(32, 32), (32, 64), (64, 32),
                                        (64, 64)])
def test_3xtf32_keeps_k1_within_its_tolerance(c_in, c_out):
    """Why K1 spends three tensor-core products: at the model's widths
    (L = 9, B = 16, a few hundred vertices) 3xTF32 stays within
    chip_smoke's K1_RTOL × max|out| of the fp32 plain twin, and a single
    TF32 pass does not."""
    k1_rtol = 1e-5                       # chip_smoke.K1_RTOL
    rng = np.random.default_rng(12)
    m, seq, b = 300, 9, 16
    table = rng.integers(0, m, size=(m, seq))
    table[:, 0] = np.arange(m)
    op = tops.build_spiral_op(table)
    limit = np.sqrt(6.0 / (seq * c_in + c_out))
    w_l = torch.from_numpy(rng.uniform(-limit, limit, (seq, c_in, c_out))
                           .astype(np.float32))
    bias = torch.from_numpy(0.1 * _rand(rng, c_out))
    x = torch.from_numpy(_rand(rng, m, b, c_in))
    ref = tops.spiral_conv_plain(w_l, bias, x, op)
    tab = torch.from_numpy(table)
    scale = float(ref.abs().max())
    err3 = float((_k1_tf32(w_l, bias, x, tab, 3) - ref).abs().max())
    err1 = float((_k1_tf32(w_l, bias, x, tab, 1) - ref).abs().max())
    assert err3 <= k1_rtol * scale
    assert err1 > k1_rtol * scale
    assert err1 > 20 * err3


def test_rna_tf32_rounds_ties_away_from_zero():
    one = 1.0 + 2.0 ** -11                     # a tie at TF32's last bit
    t = torch.tensor([one, -one, 1.0 + 2.0 ** -12, 3.0], dtype=torch.float32)
    got = _rna_tf32(t).tolist()
    assert got == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0, 3.0]


# the smoke model's up-pools on the fixture: (rows out, rows in, channels)
_UP_POOLS = {"up3": (267, 67, 64), "up2": (1065, 267, 64),
             "up1": (4260, 1065, 32), "up0": (17039, 4260, 32)}


def test_up_pool_shapes_match_the_fixture(bundle):
    for level in range(4):
        m, n, _ = _UP_POOLS[f"up{level}"]
        assert bundle.up[level].shape == (m, n)


@pytest.mark.parametrize("b", [1, 4, 16])
@pytest.mark.parametrize("pool", sorted(_UP_POOLS))
def test_ell_matmul_on_the_up_pools_matches_jax(bundle, pool, b):
    """K4's plain twin on the serving path's up-pools at the service's
    batch buckets (D = B·C, as the kernel sees them) against the JAX
    package's ``ell_matmul_raw``."""
    level = int(pool[-1])
    m, n, c = _UP_POOLS[pool]
    coo = bundle.up[level]
    mat_t = tsparse.from_coo(coo.rows, coo.cols, coo.vals, coo.shape)
    mat_j = jsparse.from_coo(coo.rows, coo.cols, coo.vals, coo.shape)
    x = _rand(np.random.default_rng(10 + level), n, b * c)
    out = tsparse.ell_matmul_raw(mat_t.cols, mat_t.vals, torch.from_numpy(x))
    ref = jsparse.ell_matmul_raw(mat_j.cols, mat_j.vals, jnp.asarray(x))
    assert out.shape == (m, b * c)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)

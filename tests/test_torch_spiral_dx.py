"""K2-dx's plain twin (``ops.spiral_conv_dx_plain``, the spiral conv's
input gradient in the kernel's order) against ``jax.vjp`` of the JAX
``spiral_conv`` with respect to x, on the same numpy inputs.

Tolerances, against each array's max |value|: fp32 1e-5 (``Σ_l du_l @
W_lᵀ`` against JAX's ``Σ dy[n] @ W_lᵀ``: the same sums reassociated);
bf16 1e-2, the mixed policy's gradient tolerance
(``tests/test_torch_mixed.py::GRAD_RTOL``: JAX rounds ``dg``, each
transpose's sum and each part's add to bf16, the twin rounds each
``du_l`` and ``dx`` once). Non-finite cotangents: NaN and infinities where JAX has them."""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from craniofacialsd_vae_tpu import ops as jops
from craniofacialsd_vae_tpu_torch import ops as tops
from tests.test_torch_training import (STEP_RTOL, TRAJ_RTOL, _steps,
                                       tiny)  # noqa: F401

F32_RTOL = 1e-5
BF16_RTOL = 1e-2
_SPIRAL = importlib.import_module(
    "craniofacialsd_vae_tpu_torch.ops.spiral_conv")


def _close(got, want, rtol):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    fin = np.isfinite(want)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.array_equal(np.isposinf(got), np.isposinf(want))
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    scale = max(float(np.abs(want[fin]).max()) if fin.any() else 0.0, 1e-30)
    err = float(np.abs(got[fin] - want[fin]).max()) if fin.any() else 0.0
    assert err <= rtol * scale, (err, scale)


def _dx_both(table, n_src, b, c_in, c_out, dtype, seed=0, group=None,
             dy_edit=None):
    """dx of the JAX conv (``jax.vjp``) and the port's twin, on one op."""
    rng = np.random.default_rng(seed)
    seq = table.shape[1]
    w = (rng.normal(size=(seq * c_in, c_out)) * 0.3).astype(np.float32)
    bias = rng.normal(size=c_out).astype(np.float32)
    x = rng.normal(size=(n_src, b, c_in)).astype(np.float32)
    dy = rng.normal(size=(table.shape[0], b, c_out)).astype(np.float32)
    if dy_edit is not None:
        dy_edit(dy)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jop = jops.build_spiral_op(table, bwd_group_size=group, n_src=n_src)
    _, vjp = jax.vjp(
        lambda x_: jops.spiral_conv({"w": jnp.asarray(w),
                                     "b": jnp.asarray(bias)}, x_, jop),
        jnp.asarray(x, jdt))
    (dx_j,) = vjp(jnp.asarray(dy, jdt))
    op = tops.build_spiral_op(table, bwd_group_size=group, n_src=n_src)
    w_l = torch.from_numpy(w).to(dtype).reshape(seq, c_in, c_out)
    dx_t = tops.spiral_conv_dx(torch.from_numpy(dy).to(dtype), w_l, op.dx)
    assert dx_t.dtype == dtype and dx_j.dtype == jdt
    return op, dx_t, dx_j


def _identity_table(rng, m=60, seq=9):
    table = rng.integers(0, m, size=(m, seq))
    table[:, 0] = np.arange(m)
    return table


DTYPES = [(torch.float32, F32_RTOL), (torch.bfloat16, BF16_RTOL)]


@pytest.mark.parametrize("dtype,rtol", DTYPES)
@pytest.mark.parametrize("b,c_in,c_out", [(4, 8, 16), (1, 32, 32),
                                          (3, 3, 32), (2, 32, 3)])
def test_dx_twin_matches_jax_with_identity_columns(b, c_in, c_out, dtype,
                                                   rtol):
    """Position 0 is the identity (its list is the vertex itself); B = 1,
    the first conv's C_in = 3 and the final conv's C_out = 3."""
    op, got, want = _dx_both(_identity_table(np.random.default_rng(1)), 60,
                             b, c_in, c_out, dtype)
    assert op.identity_cols == (0,)
    _close(got, want, rtol)


@pytest.mark.parametrize("dtype,rtol", DTYPES)
def test_dx_twin_on_a_composed_table_zeroes_unreached_rows(dtype, rtol):
    """An encoder table composed with a down-selection (n_src > M): every
    source row is written, the rows no entry reaches exactly 0."""
    rng = np.random.default_rng(2)
    table = rng.integers(0, 150, size=(30, 9))
    op, got, want = _dx_both(table, 150, 4, 16, 32, dtype)
    assert op.n_src == 150 and op.num_vertices == 30
    unreached = np.setdiff1d(np.arange(150), table)
    assert len(unreached) > 10
    assert bool((got[torch.from_numpy(unreached)] == 0).all())
    _close(got, want, rtol)


@pytest.mark.parametrize("dtype,rtol", DTYPES)
def test_dx_twin_on_a_tiered_hub(dtype, rtol):
    """A hub read at one position by 150 of 200 vertices: its combined
    transpose spills into overflow tiers; its K2-dx list is one long
    list."""
    rng = np.random.default_rng(3)
    table = _identity_table(rng, m=200)
    table[:150, 4] = 9
    op, got, want = _dx_both(table, 200, 2, 8, 8, dtype)
    assert op.inv_tables[0].tiers
    ptr = op.dx.ptr.numpy()
    assert ptr[9 * 9 + 5] - ptr[9 * 9 + 4] >= 150
    _close(got, want, rtol)


@pytest.mark.parametrize("group", [2, 3])
def test_dx_twin_with_column_groups(group):
    """bwd_group_size < L: each group's padding lands at its first
    column."""
    op, got, want = _dx_both(_identity_table(np.random.default_rng(4)), 60,
                             3, 4, 6, torch.float32, group=group)
    assert len(op.inv_tables) == -(-8 // group)
    _close(got, want, F32_RTOL)


@pytest.mark.parametrize("dtype,rtol", DTYPES)
@pytest.mark.parametrize("row,value", [(0, np.nan), (0, np.inf),
                                       (7, np.nan), (7, -np.inf)])
def test_dx_twin_carries_a_non_finite_row(row, value, dtype, rtol):
    """A non-finite dy row: row 0 reaches every padded row of the combined
    transpose (JAX adds ``0 · dg[0]``, the twin ``0 · dy[0]``), another
    row only the rows that read it; NaN and ±inf where JAX has them."""
    def edit(dy):
        dy[row, 1, 2] = value

    rng = np.random.default_rng(5)
    table = rng.integers(0, 80, size=(40, 9))          # padded rows
    op, got, want = _dx_both(table, 80, 3, 8, 8, dtype, dy_edit=edit)
    assert bool((~torch.isfinite(got)).any())
    _close(got, want, rtol)


def test_dx_lists_follow_the_table():
    """``SpiralDx``: the list of (v, l) holds the n with S[n, l] = v in
    ascending order, then −1 where the combined transpose pads a row of
    v (its main row or a tier's) and l is its group's first column."""
    rng = np.random.default_rng(6)
    table = rng.integers(0, 25, size=(20, 4))
    op = tops.build_spiral_op(table, n_src=25)
    ptr, idx = op.dx.ptr.numpy(), op.dx.idx.numpy()
    t = op.inv_tables[0]
    padded = (t.vals == 0).any(1).numpy()
    for rows, _, vals in t.tiers:        # a tier's padding counts too
        padded[rows.numpy()[(vals == 0).any(1).numpy()]] = True
    for v in range(25):
        for l in range(4):
            got = idx[ptr[v * 4 + l]:ptr[v * 4 + l + 1]].tolist()
            want = np.flatnonzero(table[:, l] == v).tolist()
            if l == 0 and padded[v]:
                want.append(-1)
            assert got == want
    assert op.dx.max_count == int(np.diff(ptr).max())


def test_whole_tiny_step_runs_k2_dx_and_matches_jax(tiny,  # noqa: F811
                                                    monkeypatch):
    """The tiny step of ``tests/test_torch_training.py`` against JAX's at
    that file's tolerances (its losses at 1e-5, its gradients' updates
    through the trajectory), with K2-dx's twin called once per conv that
    needs dx: every conv but the first encoder conv."""
    calls = {"dx": 0}
    twin = _SPIRAL.spiral_conv_dx_plain

    def spy(*args):
        calls["dx"] += 1
        return twin(*args)

    monkeypatch.setattr(_SPIRAL, "spiral_conv_dx_plain", spy)
    steps, _, model = _steps(tiny, 1e-3, 0.0, 2, seed=5)
    n_convs = len(model.en_convs) + len(model.de_convs) + 1
    assert calls["dx"] == 2 * (n_convs - 1)
    for t, (m_j, m_t) in enumerate(steps):
        for k in m_t:
            np.testing.assert_allclose(float(m_t[k]), float(m_j[k]),
                                       rtol=STEP_RTOL if t == 0 else TRAJ_RTOL,
                                       err_msg=k)


# ----------------------------------------------------------------------
# K2-dx's planner (kernels.plan_spiral_conv_dx) against a mirror of the
# checks csrc/spiral_conv_dx.cu::cfs_spiral_conv_dx makes of every plan,
# and a walk of a launch's blocks on the CPU.

from craniofacialsd_vae_tpu_torch import kernels  # noqa: E402

SMEM_BLOCK = 232448          # an H100 block's shared memory, at most
SMEM_SM = 233472             # an SM's, shared by its blocks
SMEM_RESERVED = 1024         # the runtime's, a block
ROWS = 64                    # the kernel's product rows a block
# level sizes of the fixture hierarchy (tests/fixtures/geometry.npz) and
# of the octasphere of subdivision 6 sampled by 4, 4, 4
LEVELS = {"fixture": (17039, 4260, 1065, 267),
          "octasphere": (16386, 4097, 1025, 257)}
# the smoke model's convs with dx: (name, level of n_src, C_in, C_out)
SMOKE_CONVS = [("enc0", 0, 3, 32), ("enc1", 1, 32, 32), ("enc2", 2, 32, 32),
               ("enc3", 3, 32, 64), ("dec3", 3, 64, 64), ("dec2", 2, 64, 32),
               ("dec1", 1, 32, 32), ("dec0", 0, 32, 32), ("final", 0, 32, 3)]
PLAN_BATCHES = [1, 3, 4, 16, 20, 64, 65, 128]


def _plan_errors(plan, n_src, b, seq, c_in, c_out, bf16):
    """The checks cfs_spiral_conv_dx makes of a plan (with its shared
    memory formula written out again), and the launch's own limits: the
    violated ones."""
    tb, tv, pos, kc, nf, zc = (plan.tb, plan.tv, plan.positions, plan.kc,
                               plan.nf, plan.zc)
    n_tiles = -(-n_src // tv)
    chunks = -(-seq // pos)
    grid_x = plan.grid[0]
    smem = (2 * (ROWS * plan.lda + 8 * nf * plan.ldw) if bf16
            else 4 * (ROWS * plan.lda + 16 * nf * plan.ldw)) + 12 * tv * seq
    checks = {
        "tile": 1 <= tb <= ROWS and tv >= 1 and tv * tb <= ROWS,
        "positions": 1 <= pos <= seq,
        "depth": kc % 16 == 0 and pos * c_out <= kc <= 1024,
        "fragments": nf in (1, 2, 4, 8),
        "columns": zc * 8 * nf >= c_in > (zc - 1) * 8 * nf,
        # row strides of 4 mod 8 words: the fragment loads' 32 banks
        "banks": ((plan.lda % 16 == 8 and plan.ldw % 16 == 8) if bf16 else
                  (plan.lda % 8 == 4 and plan.ldw % 8 == 4)),
        "strides": (plan.lda >= kc and plan.ldw
                    >= (chunks * kc if plan.resident else kc)),
        "smem": (plan.smem == smem <= SMEM_BLOCK
                 and smem + SMEM_RESERVED <= SMEM_SM),
        "grid": (plan.grid == (grid_x, -(-b // tb), zc)
                 and 1 <= grid_x <= n_tiles < 2 ** 31
                 and (plan.resident or grid_x == n_tiles)
                 and plan.grid[1] <= 65535 and zc <= 65535),
        "threads": plan.threads == 256,
    }
    return [k for k, ok in checks.items() if not ok]


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("b", PLAN_BATCHES)
@pytest.mark.parametrize("mesh,name,level,c_in,c_out",
                         [(m,) + c for m in LEVELS for c in SMOKE_CONVS])
def test_dx_plan_passes_the_kernels_checks(mesh, name, level, c_in, c_out,
                                           b, bf16):
    """Every plan of the smoke model's convs (the fixture hierarchy's and
    the octasphere's) passes the launcher's checks; a block holds all B
    up to 64 batch rows of as many vertices as fill its 64 rows, and its
    column blocks narrow only where the grid would not fill the SMs
    twice."""
    n_src = LEVELS[mesh][level]
    plan = kernels.plan_spiral_conv_dx(n_src, b, 9, c_in, c_out, bf16)
    assert _plan_errors(plan, n_src, b, 9, c_in, c_out, bf16) == []
    assert plan.tb == min(b, ROWS) and plan.tv == ROWS // plan.tb
    widest = next(f for f in (1, 2, 4, 8) if 8 * f >= min(c_in, 64))
    blocks = lambda nf: (-(-n_src // plan.tv) * -(-b // plan.tb)  # noqa
                         * -(-c_in // (8 * nf)))
    assert plan.nf == widest or blocks(2 * plan.nf) < 2 * kernels._SMS
    assert plan.nf == 1 or blocks(plan.nf) >= 2 * kernels._SMS \
        or plan.nf == widest


@pytest.mark.parametrize("n_src,b,c_in,c_out,bf16", [
    (300, 16, 32, 32, False), (700, 4, 3, 32, True), (300, 20, 64, 64, False),
    (300, 100, 16, 8, True), (50, 7, 200, 96, False), (9, 1, 128, 512, True)])
def test_dx_plan_at_other_widths(n_src, b, c_in, c_out, bf16):
    """The card tests' shapes and wider ones: column blocks past 64
    columns, one position a chunk past 128 (bf16: 288) values, Wᵀ staged
    a chunk at a time where it does not fit whole."""
    plan = kernels.plan_spiral_conv_dx(n_src, b, 9, c_in, c_out, bf16)
    assert _plan_errors(plan, n_src, b, 9, c_in, c_out, bf16) == []


def test_dx_plan_rejects_what_does_not_fit():
    """A chunk deeper than the launcher takes (1,024), shared memory past
    a block's, and an empty shape raise in the planner, not in the
    launch."""
    with pytest.raises(ValueError):
        kernels.plan_spiral_conv_dx(10, 1, 9, 8, 1030, True)
    with pytest.raises(ValueError):
        kernels.plan_spiral_conv_dx(10, 1, 9, 8, 1100)
    with pytest.raises(ValueError):
        kernels.plan_spiral_conv_dx(0, 1, 9, 8, 8)


def _walk(plan, dx_tab, n_src, b, seq, c_in, c_out, dy):
    """The launch's blocks as the kernel walks them, in numpy: block (x, y,
    z) takes the vertex tiles x, x + grid[0], … (all of them, one each,
    where Wᵀ is not resident), batch slice y and column block z; per
    position chunk it sums each list of its tile's vertices in list order
    from +0 into du (−1 adds 0 · dy[0]). Returns du [n_src, B, L·C_out]
    as column block 0 formed it, how often each (v, b, l) was summed, and
    how often each dx element was written."""
    ptr, idx = dx_tab.ptr.numpy(), dx_tab.idx.numpy()
    tb, tv, pos = plan.tb, plan.tv, plan.positions
    n_tiles = -(-n_src // tv)
    du = np.full((n_src, b, seq * c_out), np.nan, np.float32)
    summed = np.zeros((n_src, b, seq), np.int64)
    written = np.zeros((n_src, b, c_in), np.int64)
    gx, gy, gz = plan.grid
    for x in range(gx):
        for y in range(gy):
            b0 = y * tb
            bw = min(tb, b - b0)
            for z in range(gz):
                c0 = z * 8 * plan.nf
                c1 = min(c_in, c0 + 8 * plan.nf)
                for tile in range(x, n_tiles, gx):
                    v0 = tile * tv
                    for l0 in range(0, seq, pos):
                        for vi in range(tv):
                            v = v0 + vi
                            if v >= n_src:
                                continue
                            for l in range(l0, min(l0 + pos, seq)):
                                s = v * seq + l
                                acc = np.zeros((bw, c_out), np.float32)
                                for n in idx[ptr[s]:ptr[s + 1]]:
                                    sl = dy[max(n, 0), b0:b0 + bw]
                                    acc = acc + (sl if n >= 0
                                                 else np.float32(0) * sl)
                                summed[v, b0:b0 + bw, l] += 1
                                if z == 0:
                                    du[v, b0:b0 + bw,
                                       l * c_out:(l + 1) * c_out] = acc
                    nv = min(tv, n_src - v0)
                    written[v0:v0 + nv, b0:b0 + bw, c0:c1] += 1
    return du, summed, written


@pytest.mark.parametrize("kind,n_src,b,c_in,c_out,bf16", [
    ("identity", 300, 16, 32, 32, False), ("composed", 700, 3, 32, 32, False),
    ("hub", 300, 20, 64, 64, True), ("identity", 300, 65, 8, 8, False),
    ("composed", 700, 1, 32, 3, True)])
def test_dx_walk_sums_every_list_once(kind, n_src, b, c_in, c_out, bf16):
    """The walk of the planner's launch sums every (vertex, batch row,
    position) once in each column block, writes every dx element once,
    and its du is bit-equal to the twin's (``ops.spiral_conv_du_plain``,
    in fp32)."""
    rng = np.random.default_rng(7)
    m = 200 if kind == "composed" else n_src
    table = rng.integers(0, n_src, size=(m, 9))
    if kind != "composed":
        table[:, 0] = np.arange(m)
    if kind == "hub":
        table[:180, 3] = 7
    op = tops.build_spiral_op(table, n_src=n_src if kind == "composed"
                              else None)
    dy = rng.normal(size=(m, b, c_out)).astype(np.float32)
    dy[0, 0, 0] = np.nan                 # reaches every padded list
    plan = kernels.plan_spiral_conv_dx(n_src, b, 9, c_in, c_out, bf16)
    du, summed, written = _walk(plan, op.dx, n_src, b, 9, c_in, c_out, dy)
    assert (summed == plan.zc).all()
    assert (written == 1).all()
    want = tops.spiral_conv_du_plain(torch.from_numpy(dy), op.dx, 9)
    np.testing.assert_array_equal(du, want.numpy())

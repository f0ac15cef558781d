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

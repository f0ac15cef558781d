"""The port's backward pass (plain versions, CPU) against JAX's custom
VJPs on the same numpy inputs: the spiral conv (``_score_bwd``), the ELL
product (``_ell_bwd``), the row gather (``_gather_rows_bwd``), and the
whole model's gradients against ``jax.grad`` of ``_compute_losses``.

The port's backward runs JAX's algorithm, the gathers through the capped
transposes: these tests also check that no autograd scatter
(``index_select``'s backward) is in the graph.

Tolerance: 1e-5 of each array's max |value| — fp32 sums taken in another
order by XLA and by PyTorch on the CPU."""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from craniofacialsd_vae_tpu import ops as jops
from craniofacialsd_vae_tpu.geometry.precompute import _save_bundle
from craniofacialsd_vae_tpu.models import SDVAEConfig as JConfig
from craniofacialsd_vae_tpu.models import init_sdvae as jax_init
from craniofacialsd_vae_tpu.ops import sparse as jsparse
from craniofacialsd_vae_tpu.training import LossWeights as JWeights
from craniofacialsd_vae_tpu.training.trainer import _compute_losses
from craniofacialsd_vae_tpu_torch import ops as tops
from craniofacialsd_vae_tpu_torch.geometry import load_bundle
from craniofacialsd_vae_tpu_torch.models import (SDVAE, SDVAEConfig,
                                                 SpiralGeometry,
                                                 params_from_jax)
from craniofacialsd_vae_tpu_torch.ops import sparse as tsparse
from craniofacialsd_vae_tpu_torch.training import LossWeights, compute_losses
from tests.test_training import _tiny_geometry

RTOL = 1e-5
_SPIRAL = importlib.import_module(
    "craniofacialsd_vae_tpu_torch.ops.spiral_conv")


def _close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (err, scale)


def _rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _skewed_idx(rng, n=70):
    """Gather indices whose transpose has two overflow tiers: three rows
    read 200, 60 and 20 times, the rest at most a few times."""
    idx = np.concatenate([np.zeros(200, int), np.ones(60, int),
                          np.full(20, 2), rng.integers(3, n, 120)])
    rng.shuffle(idx)
    return idx


def _spy_transposes(monkeypatch):
    """Counts of ``CappedEll.apply``, of the plain tier landing and of
    every ``index_add``."""
    calls = {"apply": 0, "tier": 0, "index_add": 0}
    apply, tier = tsparse.CappedEll.apply, tsparse.ell_tier_add_plain
    index_add_, index_add = torch.Tensor.index_add_, torch.Tensor.index_add

    def spy_apply(self, x):
        calls["apply"] += 1
        return apply(self, x)

    def spy_tier(*args):
        calls["tier"] += 1
        return tier(*args)

    def spy_index_add_(self, *args, **kw):
        calls["index_add"] += 1
        return index_add_(self, *args, **kw)

    def spy_index_add(self, *args, **kw):
        calls["index_add"] += 1
        return index_add(self, *args, **kw)

    monkeypatch.setattr(tsparse.CappedEll, "apply", spy_apply)
    monkeypatch.setattr(tsparse, "ell_tier_add_plain", spy_tier)
    monkeypatch.setattr(torch.Tensor, "index_add_", spy_index_add_)
    monkeypatch.setattr(torch.Tensor, "index_add", spy_index_add)
    return calls


def _graph_nodes(t):
    seen, todo, names = set(), [t.grad_fn], []
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.append(type(fn).__name__)
        todo += [f for f, _ in fn.next_functions]
    return names


def _conv_vjp(table, n_src, b, c_in, c_out, group=None, seed=0):
    rng = np.random.default_rng(seed)
    w = _rand(rng, table.shape[1] * c_in, c_out) * 0.3
    bias = _rand(rng, c_out)
    x = _rand(rng, n_src, b, c_in)
    dy = _rand(rng, table.shape[0], b, c_out)
    jop = jops.build_spiral_op(table, bwd_group_size=group, n_src=n_src)
    out_j, vjp = jax.vjp(
        lambda w_, b_, x_: jops.spiral_conv({"w": w_, "b": b_}, x_, jop),
        jnp.asarray(w), jnp.asarray(bias), jnp.asarray(x))
    dw_j, db_j, dx_j = vjp(jnp.asarray(dy))
    top = tops.build_spiral_op(table, bwd_group_size=group, n_src=n_src)
    w_t = torch.from_numpy(w).requires_grad_()
    b_t = torch.from_numpy(bias).requires_grad_()
    x_t = torch.from_numpy(x).requires_grad_()
    out_t = tops.spiral_conv({"w": w_t, "b": b_t}, x_t, top)
    out_t.backward(torch.from_numpy(dy))
    _close(out_t, out_j)
    _close(w_t.grad, dw_j)
    _close(b_t.grad, db_j)
    _close(x_t.grad, dx_j)
    return top, out_t


@pytest.mark.parametrize("b,c_in,c_out", [(3, 3, 8), (2, 8, 3), (4, 16, 16)])
def test_spiral_conv_backward_identity_table(b, c_in, c_out):
    rng = np.random.default_rng(4)
    m = 40
    table = rng.integers(0, m, size=(m, 7))
    table[:, 0] = np.arange(m)
    op, out = _conv_vjp(table, m, b, c_in, c_out)
    assert op.identity_cols == (0,)
    assert "IndexSelectBackward0" not in _graph_nodes(out)


@pytest.mark.parametrize("b,c_in,c_out", [(3, 3, 8), (2, 16, 32)])
def test_spiral_conv_backward_composed_table(b, c_in, c_out):
    """Encoder tables composed with a down-selection: M < n_src, no
    identity column, dx on the n_src rows."""
    rng = np.random.default_rng(5)
    table = rng.integers(0, 90, size=(25, 9))
    op, _ = _conv_vjp(table, 90, b, c_in, c_out, seed=1)
    assert op.identity_cols == () and op.n_src == 90


def _spy_dx(monkeypatch):
    """Counts of K2-dx's plain twin, which the conv's backward runs for a
    CPU tensor."""
    calls = {"dx": 0}
    twin = _SPIRAL.spiral_conv_dx_plain

    def spy(*args):
        calls["dx"] += 1
        return twin(*args)

    monkeypatch.setattr(_SPIRAL, "spiral_conv_dx_plain", spy)
    return calls


@pytest.mark.parametrize("group", [3, 4])
def test_spiral_conv_backward_column_groups(group, monkeypatch):
    """bwd_group_size < L: one combined transpose per column group, as
    JAX builds them; the backward reads their padding through K2-dx's
    lists in one call (its twin here) and applies none of them."""
    calls = _spy_transposes(monkeypatch)
    dx_calls = _spy_dx(monkeypatch)
    rng = np.random.default_rng(6)
    m = 50
    table = rng.integers(0, m, size=(m, 9))
    table[:, 0] = np.arange(m)
    op, _ = _conv_vjp(table, m, 3, 4, 6, group=group, seed=2)
    assert len(op.inv_tables) == -(-8 // group)
    assert dx_calls["dx"] == 1 and calls["apply"] == 0


def test_spiral_conv_dw_plain_matches_jax_einsum():
    """K2-dW's plain twin: Σ_{m,b} x[S[m,l], b]ᵀ dy[m, b] per position."""
    rng = np.random.default_rng(7)
    table = rng.integers(0, 30, size=(20, 5))
    x, dy = _rand(rng, 30, 4, 3), _rand(rng, 20, 4, 6)
    got = tops.spiral_conv_dw_plain(torch.from_numpy(x),
                                    torch.from_numpy(table.astype(np.int32)),
                                    torch.from_numpy(dy))
    want = np.stack([np.einsum("nbc,nbo->co", x[table[:, i]], dy)
                     for i in range(5)])
    _close(got, want)


def test_spiral_conv_skips_dx_for_data(monkeypatch):
    """The first encoder conv reads the data, which needs no gradient:
    K2-dx (its twin here) is not called, and dW and db are still
    computed; with x needing a gradient it is called once. No transpose
    is applied either way."""
    calls = _spy_transposes(monkeypatch)
    dx_calls = _spy_dx(monkeypatch)
    rng = np.random.default_rng(8)
    table = rng.integers(0, 30, size=(30, 5))
    op = tops.build_spiral_op(table)
    w = torch.randn(15, 4, requires_grad=True)
    b = torch.zeros(4, requires_grad=True)
    x = torch.from_numpy(_rand(rng, 30, 2, 3))
    tops.spiral_conv({"w": w, "b": b}, x, op).sum().backward()
    assert dx_calls["dx"] == 0 and calls["apply"] == 0
    assert w.grad is not None and b.grad is not None
    x.requires_grad_()
    tops.spiral_conv({"w": w, "b": b}, x, op).sum().backward()
    assert dx_calls["dx"] == 1 and calls["apply"] == 0
    assert x.grad is not None


def test_ell_matmul_backward_through_tiered_transpose(monkeypatch):
    calls = _spy_transposes(monkeypatch)
    rng = np.random.default_rng(9)
    m, n = 400, 70
    rows = np.arange(m)
    cols = _skewed_idx(rng, n)
    vals = _rand(rng, m)
    mat_t = tsparse.from_coo(rows, cols, vals, (m, n))
    mat_j = jsparse.from_coo(rows, cols, vals, (m, n))
    assert len(mat_t.transpose.tiers) >= 2
    x, dy = _rand(rng, n, 3, 2), _rand(rng, m, 3, 2)
    _, vjp = jax.vjp(lambda x_: jsparse.ell_matmul(mat_j, x_), jnp.asarray(x))
    x_t = torch.from_numpy(x).requires_grad_()
    out = tsparse.ell_matmul(mat_t, x_t)
    out.backward(torch.from_numpy(dy))
    _close(x_t.grad, vjp(jnp.asarray(dy))[0])
    n_tiers = len(mat_t.transpose.tiers)
    assert calls == {"apply": 1, "tier": n_tiers, "index_add": n_tiers}


def test_gather_rows_backward_through_tiered_transpose():
    rng = np.random.default_rng(10)
    idx = _skewed_idx(rng)
    op_t = tsparse.gather_op_from_idx(idx, 70)
    op_j = jsparse.gather_op_from_idx(idx, 70)
    assert len(op_t.transpose.tiers) >= 2
    x, dy = _rand(rng, 70, 4), _rand(rng, len(idx), 4)
    _, vjp = jax.vjp(lambda x_: jsparse.gather_rows(op_j, x_), jnp.asarray(x))
    x_t = torch.from_numpy(x).requires_grad_()
    out = tsparse.gather_rows(op_t, x_t)
    out.backward(torch.from_numpy(dy))
    _close(x_t.grad, vjp(jnp.asarray(dy))[0])
    assert "IndexSelectBackward0" not in _graph_nodes(out)


def test_tier_landing_equals_jax_scatter_add():
    rng = np.random.default_rng(11)
    ce_t = tsparse.capped_ell(_skewed_idx(rng), np.arange(400),
                              _rand(rng, 400), 70)
    rows, cols, vals = ce_t.tiers[0]
    x, out = _rand(rng, 400, 5), _rand(rng, 70, 5)
    want = jnp.asarray(out).at[np.asarray(rows)].add(
        jsparse.ell_matmul_raw(jnp.asarray(cols.numpy()),
                               jnp.asarray(vals.numpy()), jnp.asarray(x)))
    got = torch.from_numpy(out.copy())
    tsparse.ell_tier_add_plain(rows, cols, vals, torch.from_numpy(x), got)
    _close(got, want)


def test_ell_matmul_backward_needs_the_transpose():
    mat = tsparse.from_coo([0, 1], [1, 0], [1.0, 2.0], (2, 2),
                           with_transpose=False)
    x = torch.ones(2, 3, requires_grad=True)
    with pytest.raises(ValueError):
        tsparse.ell_matmul(mat, x).sum().backward()


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    geom_j, bundle_j = _tiny_geometry(np.random.default_rng(11),
                                      return_bundle=True)
    path = str(tmp_path_factory.mktemp("grad") / "geometry.npz")
    _save_bundle(path, bundle_j)
    geom_t = SpiralGeometry.from_bundle(
        load_bundle(path), device="cpu",
        laplacian=bundle_j.template.laplacian,
        region_masks=np.asarray(geom_j.region_masks))
    cfg_j = JConfig(out_channels=(8, 16), latent_size=6)
    params = jax_init(jax.random.PRNGKey(0), cfg_j, geom_j)
    return dict(geom_j=geom_j, geom_t=geom_t, cfg_j=cfg_j, params=params)


@pytest.mark.parametrize("swap", [True, False])
def test_model_gradients_match_jax_grad(tiny, monkeypatch, swap):
    """loss.backward() on the port's model against jax.grad of
    _compute_losses, leaf by leaf, all regularisers on; the backward
    applies the transposes and holds no autograd scatter."""
    calls = _spy_transposes(monkeypatch)
    b, z = 3, 6
    geom_j = tiny["geom_j"]
    n = geom_j.region_masks.shape[1]
    rng = np.random.default_rng(12)
    x_grid = _rand(rng, n, b * b if swap else b, 3)
    region = 1
    key = jax.random.PRNGKey(4)
    weights = dict(kl=1e-4, laplacian=0.1, latent_consistency=0.5)

    def loss_fn(p):
        return _compute_losses(p, None, geom_j, tiny["cfg_j"],
                               JWeights(**weights), jnp.asarray(x_grid),
                               jnp.int32(region), None, None, b, key,
                               training=True, swap=swap)

    (loss_j, _), grads_j = jax.value_and_grad(loss_fn, has_aux=True)(
        tiny["params"])
    eps = np.array(jax.random.normal(key, (x_grid.shape[1], z)))

    model = SDVAE(SDVAEConfig(out_channels=(8, 16), latent_size=z),
                  tiny["geom_t"])
    model.load_state_dict(params_from_jax(tiny["params"]))
    loss_t, _ = compute_losses(model, LossWeights(**weights),
                               torch.from_numpy(x_grid), region, b,
                               eps=torch.from_numpy(eps), swap=swap)
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=RTOL)
    want = params_from_jax(jax.tree.map(np.asarray, grads_j))
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    for name, g in want.items():
        assert got[name].grad is not None, name
        _close(got[name].grad, g.numpy())
    # the gradients came through the transposes: no autograd scatter in
    # the graph, and no index_add but the tiers' landing
    assert calls["apply"] > 0 and calls["tier"] > 0
    assert calls["index_add"] == calls["tier"]
    assert "IndexSelectBackward0" not in _graph_nodes(loss_t)

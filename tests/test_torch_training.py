"""The port's training slice (plain versions, CPU) against the JAX
package on the same numpy inputs: the swap, the losses, coupled Adam, the
train and eval steps on ``_tiny_geometry`` with the JAX template's
Laplacian and region masks, the per-step loop against the scanned epoch,
and the stand-in Laplacian and regions of a bundle without its template.

JAX keys and torch generators give different numbers, so the region and
the reparameterisation noise are recomputed here from JAX's key (``split``
→ ``randint`` / ``normal``) and injected into the port. Tolerances: rtol
1e-5 (against each array's max) for one step's values — fp32 sums taken
in another order by XLA and by PyTorch on the CPU; 1e-4 for a loss
trajectory over 5 Adam steps, where those differences compound."""

import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from craniofacialsd_vae_tpu.data import swap as jswap
from craniofacialsd_vae_tpu.geometry.precompute import _save_bundle
from craniofacialsd_vae_tpu.geometry.template import \
    rw_laplacian_coo as jax_rw_laplacian
from craniofacialsd_vae_tpu.geometry.template import \
    unique_edges as jax_unique_edges
from craniofacialsd_vae_tpu.models import SDVAEConfig as JConfig
from craniofacialsd_vae_tpu.models import init_sdvae as jax_init
from craniofacialsd_vae_tpu.ops import sparse as jsparse
from craniofacialsd_vae_tpu.training import LossWeights as JWeights
from craniofacialsd_vae_tpu.training import coupled_adam as jax_adam
from craniofacialsd_vae_tpu.training import losses as jlosses
from craniofacialsd_vae_tpu.training import trainer as jtrainer
from craniofacialsd_vae_tpu_torch.data import (choose_region, swap_features,
                                               swap_features_dynamic)
from craniofacialsd_vae_tpu_torch.geometry import (level0_positions,
                                                   load_bundle,
                                                   rw_laplacian_coo,
                                                   standin_laplacian_coo,
                                                   standin_region_masks,
                                                   unique_edges)
from craniofacialsd_vae_tpu_torch.models import (SDVAE, SDVAEConfig,
                                                 SpiralGeometry,
                                                 params_from_jax)
from craniofacialsd_vae_tpu_torch.ops import sparse as tsparse
from craniofacialsd_vae_tpu_torch.training import (LOSS_KEYS, LossWeights,
                                                   coupled_adam,
                                                   make_eval_step,
                                                   make_train_step, losses,
                                                   run_steps)
from tests.test_training import _tiny_geometry

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "geometry.npz")
STEP_RTOL = 1e-5
TRAJ_RTOL = 1e-4
B, Z = 3, 6
WEIGHTS = dict(kl=1e-4, laplacian=0.1, latent_consistency=0.5)


def _rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=STEP_RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rtol * scale


# ---------------------------------------------------------------- swap
@pytest.mark.parametrize("b", [3, 4])
def test_swap_features_matches_jax(b):
    rng = np.random.default_rng(b)
    x = _rand(rng, 20, b, 3)
    mask = rng.random(20) < 0.3
    got = swap_features(_t(x), _t(mask))
    want = jswap.swap_features(jnp.asarray(x), jnp.asarray(mask))
    assert got.shape == (20, b * b, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("region", [0, 2])
def test_swap_features_dynamic_matches_jax(region):
    rng = np.random.default_rng(10 + region)
    x = _rand(rng, 30, 4, 3)
    masks = rng.random((3, 30)) < 0.4
    want = jswap.swap_features_dynamic(jnp.asarray(x), jnp.asarray(masks),
                                       jnp.int32(region))
    for idx in (region, torch.tensor(region)):
        got = swap_features_dynamic(_t(x), _t(masks), idx)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_swap_diagonal_is_identity():
    rng = np.random.default_rng(5)
    b = 3
    x = _rand(rng, 10, b, 3)
    out = swap_features(_t(x), _t(rng.random(10) < 0.5))
    for i in range(b):
        np.testing.assert_array_equal(out[:, i * b + i].numpy(), x[:, i])


def test_choose_region_follows_the_generator():
    draws = [int(choose_region(torch.Generator().manual_seed(3), 15))
             for _ in range(2)]
    assert draws[0] == draws[1] and 0 <= draws[0] < 15
    many = {int(choose_region(torch.Generator().manual_seed(s), 4))
            for s in range(40)}
    assert many == {0, 1, 2, 3}


# -------------------------------------------------------------- losses
def test_mse_and_kl_match_jax():
    rng = np.random.default_rng(6)
    a, c = _rand(rng, 12, 9, 3), _rand(rng, 12, 9, 3)
    _close(losses.mse_loss(_t(a), _t(c)),
           jlosses.mse_loss(jnp.asarray(a), jnp.asarray(c)))
    mu, lv = _rand(rng, 9, 6), _rand(rng, 9, 6)
    _close(losses.kl_divergence_loss(_t(mu), _t(lv)),
           jlosses.kl_divergence_loss(jnp.asarray(mu), jnp.asarray(lv)))


def _hub_laplacian(rng, n=60):
    """An rw-Laplacian of a graph with two hubs, so that its capped
    transpose has overflow tiers."""
    edges = [(0, j) for j in range(1, n)] + [(1, j) for j in range(2, 30)]
    edges += [tuple(sorted(e)) for e in rng.integers(2, n, (40, 2))
              if e[0] != e[1]]
    edges = np.unique(np.asarray(edges), axis=0)
    return rw_laplacian_coo(n, edges), n


def test_laplacian_loss_and_its_gradient_match_jax_on_a_tiered_table():
    rng = np.random.default_rng(7)
    (rows, cols, vals), n = _hub_laplacian(rng)
    lap_t = tsparse.from_coo(rows, cols, vals, (n, n))
    lap_j = jsparse.from_coo(rows, cols, vals, (n, n))
    assert len(lap_t.transpose.tiers) >= 1
    pred = _rand(rng, n, 9, 3)
    loss_j, grad_j = jax.value_and_grad(
        lambda p: jlosses.laplacian_loss(lap_j, p))(jnp.asarray(pred))
    p_t = _t(pred).requires_grad_()
    loss_t = losses.laplacian_loss(lap_t, p_t)
    loss_t.backward()
    _close(loss_t, loss_j)
    _close(p_t.grad, grad_j)


@pytest.mark.parametrize("region", [0, 1, 4])
def test_region_feature_mask_matches_jax(region):
    got = losses.region_feature_mask(30, 5, torch.tensor(region))
    want = jlosses.region_feature_mask(30, 5, region)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bs", [3, 4])
def test_latent_consistency_loss_matches_jax(bs):
    rng = np.random.default_rng(bs)
    z = _rand(rng, bs * bs, 30)
    fmask = np.asarray(jlosses.region_feature_mask(30, 5, 2))
    want = jlosses.latent_consistency_loss(jnp.asarray(z), jnp.asarray(fmask),
                                           bs, 0.5, 0.25)
    got = losses.latent_consistency_loss(_t(z), _t(fmask), bs, 0.5, 0.25)
    _close(got, want)
    z_t = _t(z).requires_grad_()
    losses.latent_consistency_loss(z_t, _t(fmask), bs, 0.5, 0.25).backward()
    _close(z_t.grad, jax.grad(lambda q: jlosses.latent_consistency_loss(
        q, jnp.asarray(fmask), bs, 0.5, 0.25))(jnp.asarray(z)))


def test_weighted_cross_entropy_matches_jax():
    rng = np.random.default_rng(8)
    logits, labels = _rand(rng, 8, 4), rng.integers(0, 4, size=8)
    w = rng.random(4).astype(np.float32)
    loss_t, acc_t = losses.weighted_cross_entropy(_t(logits), _t(labels),
                                                  _t(w))
    loss_j, acc_j = jlosses.weighted_cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(w))
    _close(loss_t, loss_j)
    _close(acc_t, acc_j)


# -------------------------------------------------------------- optimizer
@pytest.mark.parametrize("wd", [0.0, 1e-1])
def test_coupled_adam_update_matches_optax(wd):
    """Four steps fed the same gradients, against optax's coupled_adam:
    the parameters within 1e-5 of the step's largest update, plus two
    float32 spacings of the parameters (the update is ~1e-3 of them). The
    gradients are as small as the decay term, so coupled L2 (decay before
    the moments) and AdamW's decoupled decay would differ."""
    rng = np.random.default_rng(9)
    p0 = {"a": _rand(rng, 5, 4), "b": _rand(rng, 7)}
    opt = jax_adam(1e-3, wd)
    params_j = jax.tree.map(jnp.asarray, p0)
    state = opt.init(params_j)
    params_t = {k: torch.nn.Parameter(_t(v)) for k, v in p0.items()}
    adam = coupled_adam(params_t.values(), 1e-3, wd)
    assert type(adam) is torch.optim.Adam
    for _ in range(4):
        grads = {k: 0.05 * _rand(rng, *v.shape) for k, v in p0.items()}
        upd, state = opt.update(jax.tree.map(jnp.asarray, grads), state,
                                params_j)
        params_j = optax.apply_updates(params_j, upd)
        for k, p in params_t.items():
            p.grad = _t(grads[k])
        adam.step()
        for k, p in params_t.items():
            want = np.asarray(params_j[k])
            atol = (1e-5 * float(np.abs(upd[k]).max())
                    + 2 * float(np.spacing(np.abs(want).max())))
            np.testing.assert_allclose(p.detach().numpy(), want, rtol=0,
                                       atol=atol)


def test_loss_weights_from_config_match_jax():
    opt = {"kl_weight": "1e-4", "laplacian_weight": 0.1,
           "latent_consistency_weight": 0.5, "latent_consistency_eta1": 0.3}
    for clf in (None, {"mlp_training_type": "end2end",
                       "mlp_loss_weight": 2}):
        got = LossWeights.from_config(opt, clf)
        want = JWeights.from_config(opt, clf)
        assert got.__dict__ == {k: float(v)
                                for k, v in want.__dict__.items()}


# ----------------------------------------------------------------- steps
@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    geom_j, bundle_j = _tiny_geometry(np.random.default_rng(11),
                                      return_bundle=True)
    path = str(tmp_path_factory.mktemp("train") / "geometry.npz")
    _save_bundle(path, bundle_j)
    geom_t = SpiralGeometry.from_bundle(
        load_bundle(path), device="cpu",
        laplacian=bundle_j.template.laplacian,
        region_masks=np.asarray(geom_j.region_masks))
    cfg_j = JConfig(out_channels=(8, 16), latent_size=Z)
    params = jax_init(jax.random.PRNGKey(0), cfg_j, geom_j)
    return dict(geom_j=geom_j, geom_t=geom_t, cfg_j=cfg_j, params=params,
                n=int(geom_j.region_masks.shape[1]),
                regions=int(geom_j.region_masks.shape[0]))


def _model(tiny):
    model = SDVAE(SDVAEConfig(out_channels=(8, 16), latent_size=Z),
                  tiny["geom_t"])
    model.load_state_dict(params_from_jax(tiny["params"]))
    return model


def _injected(tiny, key):
    """The region and ε the JAX step draws from ``key``."""
    k_region, k_reparam = jax.random.split(key)
    region = int(jax.random.randint(k_region, (), 0, tiny["regions"]))
    eps = np.array(jax.random.normal(k_reparam, (B * B, Z), jnp.float32))
    return region, torch.from_numpy(eps)


def _steps(tiny, lr, wd, n_steps, seed):
    """n_steps of both packages' train steps from the JAX init."""
    weights = JWeights(**WEIGHTS)
    opt = jax_adam(lr, wd)
    jstep = jtrainer.make_train_step(tiny["cfg_j"], weights, opt,
                                     batch_size=B)
    state = jtrainer.create_train_state(
        jax.tree.map(jnp.copy, tiny["params"]), opt)
    model = _model(tiny)
    tstep = make_train_step(model, LossWeights(**WEIGHTS),
                            coupled_adam(model.parameters(), lr, wd), B)
    rng = np.random.default_rng(seed)
    out = []
    for t in range(n_steps):
        x = _rand(rng, B, tiny["n"], 3)
        key = jax.random.fold_in(jax.random.PRNGKey(seed), t)
        state, m_j = jstep(state, tiny["geom_j"], jnp.asarray(x), None,
                           None, key)
        region, eps = _injected(tiny, key)
        m_t = tstep(torch.from_numpy(x), region_idx=region, eps=eps)
        out.append((m_j, m_t))
    return out, state, model


@pytest.mark.parametrize("wd", [0.0, 1e-3])
def test_train_step_matches_jax_step(tiny, wd):
    """Step 1: every LOSS_KEYS metric within rtol 1e-5; the loss
    trajectory over 5 steps within rtol 1e-4; the updated parameters
    after one step within the same 1e-4 of each leaf's max update."""
    (first, *rest), _, _ = _steps(tiny, 1e-3, wd, 5, seed=3)
    m_j, m_t = first
    assert set(m_t) == set(LOSS_KEYS)
    for k in LOSS_KEYS:
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]),
                                   rtol=STEP_RTOL, atol=0, err_msg=k)
    for m_j, m_t in rest:
        np.testing.assert_allclose(float(m_t["tot"]), float(m_j["tot"]),
                                   rtol=TRAJ_RTOL)


def test_train_step_update_matches_jax(tiny):
    """One step's parameter update, leaf by leaf, within 1e-4 of the
    leaf's max update (Adam's first update is ±lr wherever the gradient
    is not tiny, so a near-zero gradient's sign can differ)."""
    _, state, model = _steps(tiny, 1e-3, 0.0, 1, seed=4)
    before = params_from_jax(tiny["params"])
    after = params_from_jax(jax.tree.map(np.asarray, state.params))
    got = model.state_dict()
    for name in before:
        want = (after[name] - before[name]).numpy()
        _close(got[name] - before[name], want, rtol=TRAJ_RTOL)


def test_train_step_leaves_gradients_on_every_parameter(tiny):
    model = _model(tiny)
    step = make_train_step(model, LossWeights(**WEIGHTS),
                           coupled_adam(model.parameters(), 1e-3, 0.0), B)
    x = _rand(np.random.default_rng(1), B, tiny["n"], 3)
    m = step(torch.from_numpy(x), generator=torch.Generator().manual_seed(0))
    assert all(torch.isfinite(v) for v in m.values())
    for name, p in model.named_parameters():
        assert p.grad is not None and float(p.grad.abs().sum()) > 0, name


def test_eval_step_is_deterministic_and_matches_jax(tiny):
    weights = JWeights(**WEIGHTS)
    estep_j = jtrainer.make_eval_step(tiny["cfg_j"], weights, batch_size=B)
    state = jtrainer.create_train_state(tiny["params"], optax.adam(1e-3))
    x = _rand(np.random.default_rng(2), B, tiny["n"], 3)
    key = jax.random.PRNGKey(9)
    m_j = estep_j(state, tiny["geom_j"], jnp.asarray(x), None, None, key)
    region, _ = _injected(tiny, key)
    estep = make_eval_step(_model(tiny), LossWeights(**WEIGHTS), B)
    m1 = estep(torch.from_numpy(x), region_idx=region)
    m2 = estep(torch.from_numpy(x), region_idx=region)
    for k in LOSS_KEYS:
        assert float(m1[k]) == float(m2[k])
        np.testing.assert_allclose(float(m1[k]), float(m_j[k]),
                                   rtol=STEP_RTOL, err_msg=k)


def test_run_steps_matches_the_scanned_epoch(tiny):
    """The per-step loop against make_scanned_train_step with its key
    schedule (fold_in of the step id, then split): the mean metrics and
    the final parameters."""
    weights = JWeights(**WEIGHTS)
    opt = jax_adam(1e-3, 0.0)
    steps, n_data = 4, 7
    rng = np.random.default_rng(13)
    data = _rand(rng, n_data, tiny["n"], 3)
    idx = rng.integers(0, n_data, size=(steps, B)).astype(np.int32)
    key = jax.random.PRNGKey(21)
    sids = 1 + np.arange(steps)
    epoch = jtrainer.make_scanned_train_step(tiny["cfg_j"], weights, opt,
                                             batch_size=B)
    state = jtrainer.create_train_state(
        jax.tree.map(jnp.copy, tiny["params"]), opt)
    state, m_j = epoch(state, tiny["geom_j"], jnp.asarray(data),
                       jnp.asarray(idx), jnp.asarray(sids, jnp.int32), None,
                       None, key)
    injected = [_injected(tiny, jax.random.fold_in(key, int(s)))
                for s in sids]
    model = _model(tiny)
    step = make_train_step(model, LossWeights(**WEIGHTS),
                           coupled_adam(model.parameters(), 1e-3, 0.0), B)
    m_t = run_steps(step, torch.from_numpy(data), torch.from_numpy(idx),
                    region_idx=[r for r, _ in injected],
                    eps=torch.stack([e for _, e in injected]))
    for k in LOSS_KEYS:
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]),
                                   rtol=TRAJ_RTOL, err_msg=k)
    after = params_from_jax(jax.tree.map(np.asarray, state.params))
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), after[name].numpy(),
                                   rtol=0, atol=1e-5)


def test_step_without_swap_matches_jax(tiny):
    weights = JWeights(**WEIGHTS)
    opt = jax_adam(1e-3, 0.0)
    jstep = jtrainer.make_train_step(tiny["cfg_j"], weights, opt,
                                     batch_size=B, swap=False)
    state = jtrainer.create_train_state(
        jax.tree.map(jnp.copy, tiny["params"]), opt)
    x = _rand(np.random.default_rng(14), B, tiny["n"], 3)
    key = jax.random.PRNGKey(5)
    _, m_j = jstep(state, tiny["geom_j"], jnp.asarray(x), None, None, key)
    eps = np.array(jax.random.normal(jax.random.split(key)[1], (B, Z)))
    model = _model(tiny)
    step = make_train_step(model, LossWeights(**WEIGHTS),
                           coupled_adam(model.parameters(), 1e-3, 0.0), B,
                           swap=False)
    m_t = step(torch.from_numpy(x), eps=torch.from_numpy(eps))
    for k in LOSS_KEYS:
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]),
                                   rtol=STEP_RTOL, err_msg=k)


def test_step_refuses_what_is_not_ported(tiny):
    model = _model(tiny)
    adam = coupled_adam(model.parameters(), 1e-3, 0.0)
    with pytest.raises(ValueError):      # a classification weight, no head
        make_train_step(model, LossWeights(classification=1.0), adam, B)
    bare = SDVAE(SDVAEConfig(out_channels=(8, 16), latent_size=Z),
                 SpiralGeometry(tiny["geom_t"].spirals, tiny["geom_t"].down,
                                tiny["geom_t"].up,
                                tiny["geom_t"].enc_spirals))
    with pytest.raises(ValueError):
        make_train_step(bare, LossWeights(**WEIGHTS), adam, B)
    step = make_train_step(model, LossWeights(**WEIGHTS), adam, B)
    with pytest.raises(ValueError):
        step(np.zeros((B + 1, tiny["n"], 3), np.float32))


# -------------------------------------------------------------- stand-ins
def test_template_graph_helpers_match_jax():
    rng = np.random.default_rng(15)
    faces = rng.integers(0, 40, size=(60, 3))
    edges = unique_edges(faces)
    np.testing.assert_array_equal(edges, jax_unique_edges(faces))
    for got, want in zip(rw_laplacian_coo(40, edges),
                         jax_rw_laplacian(40, edges)):
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def fixture_bundle():
    return load_bundle(FIXTURE)


def test_standin_laplacian_is_a_symmetric_rw_laplacian(fixture_bundle):
    """Symmetric pattern, rows summing to 0, diagonal 1, off-diagonal
    -1/deg: the stand-in has the template Laplacian's form."""
    spiral0 = fixture_bundle.spirals[0]
    rows, cols, vals = standin_laplacian_coo(spiral0)
    n = spiral0.shape[0]
    assert rows.max() < n and cols.max() < n
    sums = np.zeros(n)
    np.add.at(sums, rows, vals.astype(np.float64))
    assert np.abs(sums).max() < 1e-6
    pairs = set(zip(rows.tolist(), cols.tolist()))
    assert all((c, r) in pairs for r, c in pairs)
    assert np.all(vals[rows == cols] == 1.0)
    deg = np.bincount(rows[rows != cols], minlength=n)
    off = rows != cols
    np.testing.assert_allclose(vals[off], -1.0 / deg[rows[off]], rtol=1e-6)
    assert 4 <= deg.mean() <= 8


def test_standin_regions_partition_the_template(fixture_bundle):
    pos = level0_positions(fixture_bundle)
    assert pos.shape == (fixture_bundle.vertex_counts[0], 3)
    masks = standin_region_masks(pos)
    assert masks.shape == (15, pos.shape[0]) and masks.dtype == bool
    np.testing.assert_array_equal(masks.sum(0), 1)
    counts = masks.sum(1)
    assert counts.max() - counts.min() <= 1
    z_mean = [pos[m, 2].mean() for m in masks]
    assert np.all(np.diff(z_mean) > 0)

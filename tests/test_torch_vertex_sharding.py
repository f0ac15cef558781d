"""The port's vertex sharding (``parallel/vertex_sharding.py``) against
the JAX package's, on the CPU, mirroring ``tests/test_vertex_sharding.py``
and the mixed policy's ``tests/test_mixed_precision.py``.

The JAX side runs ``VertexShardedModel`` on virtual CPU devices
(``conftest.py``): a 2-device vertex mesh, and a 2 × 2 data × vertex
mesh. The port's side runs as many Gloo ranks (``tests/
torch_parallel_ranks.py``), each with its own block's tables, the port's
kernels' plain twins doing the local work (K1, K4 and its capped
transposes, K2-dW) and ``all_to_all``/``all_gather`` moving the halos.
Each step's region and ε are JAX's (``split`` of the step's key, folded
with the data index on the 2-D mesh) injected.

Tolerances: fp32 as the trainer's parity tests (rtol 1e-5 of an array's
largest value for one forward or one gradient, 1e-4 for a step's
parameters and metrics after Adam); the mixed policy 3e-2, the mixed
tests' tolerance. Against the port's own per-step path the scanned
epochs are bit-equal, and at one rank (in this process) the sharded
forward equals the unsharded model's bit for bit."""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P
from craniofacialsd_vae_tpu.geometry import precompute_geometry
from craniofacialsd_vae_tpu.geometry.precompute import _save_bundle
from craniofacialsd_vae_tpu.geometry.synthetic import synthetic_template
from craniofacialsd_vae_tpu.models import SDVAEConfig as JConfig
from craniofacialsd_vae_tpu.models import SpiralGeometry as JGeometry
from craniofacialsd_vae_tpu.models import init_sdvae as jax_init
from craniofacialsd_vae_tpu.parallel import vertex_sharding as jvs
from craniofacialsd_vae_tpu.training import LossWeights as JWeights
from craniofacialsd_vae_tpu.training import coupled_adam as jax_adam
from craniofacialsd_vae_tpu.training import create_train_state
from craniofacialsd_vae_tpu_torch import parallel as tparallel
from craniofacialsd_vae_tpu_torch.geometry import load_bundle
from craniofacialsd_vae_tpu_torch.models import (SDVAE, SDVAEConfig,
                                                 SpiralGeometry,
                                                 params_from_jax)
from craniofacialsd_vae_tpu_torch.ops import CappedEll
from craniofacialsd_vae_tpu_torch.parallel import vertex_sharding as tvs
from craniofacialsd_vae_tpu_torch.training import (LossWeights,
                                                   coupled_adam,
                                                   make_train_step)
from tests import torch_parallel_ranks as ranks

STEP_RTOL = 1e-5
TRAJ_RTOL = 1e-4
MIXED_TOL = 3e-2
B, Z, LR = 2, 10, 1e-3
WEIGHTS = dict(kl=1e-4, laplacian=0.1, latent_consistency=0.5)
KEYS = ("reconstruction", "kl", "laplacian", "latent_consistency", "tot")


def max_rel(got, want):
    scale = max(float(np.abs(np.asarray(want)).max()), 1e-30)
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()) / scale


def _draw(key, regions, rows):
    k_region, k_reparam = jax.random.split(key)
    region = int(jax.random.randint(k_region, (), 0, regions))
    eps = np.array(jax.random.normal(k_reparam, (rows, Z), jnp.float32))
    return region, eps


def _port(state_params) -> dict:
    return {k: v.numpy() for k, v in params_from_jax(
        jax.tree.map(np.asarray, state_params)).items()}


def _gather_blocks(results, key, n):
    return np.concatenate([r[key] for r in results], axis=0)[:n]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("vs"))
    template = synthetic_template(subdivisions=3, n_regions=5)
    bundle = precompute_geometry(template, [2, 2], [5, 5], [1, 1])
    path = os.path.join(root, "geometry.npz")
    _save_bundle(path, bundle)
    config = JConfig(out_channels=(8, 16), latent_size=Z)
    geom = JGeometry.from_bundle(bundle)
    params = jax_init(jax.random.PRNGKey(0), config, geom)
    payload = {"bundle": path,
               "laplacian": tuple(np.asarray(a)
                                  for a in template.laplacian),
               "masks": np.asarray(template.region_masks(), bool),
               "params": jax.tree.map(np.asarray, params),
               "out_channels": (8, 16), "latent": Z, "batch": B, "lr": LR,
               "weights": WEIGHTS}
    return {"root": root, "template": template, "bundle": bundle,
            "config": config, "params": params, "payload": payload,
            "n": template.num_vertices,
            "regions": int(payload["masks"].shape[0])}


def _jax_vs(setup, mesh, compute_dtype="float32"):
    cfg = JConfig(out_channels=(8, 16), latent_size=Z,
                  compute_dtype=compute_dtype)
    return jvs.VertexShardedModel(setup["bundle"], cfg, mesh), cfg


# ------------------------------------------------------------- 1-D, D = 2
@pytest.fixture(scope="module")
def one_d(setup):
    """JAX on a 2-device vertex mesh and the port on two ranks."""
    d = 2
    n = setup["n"]
    rng = np.random.default_rng(3)
    params = setup["params"]
    p = dict(setup["payload"])
    mesh = Mesh(np.array(jax.devices()[:d]), (jvs.VERTEX_AXIS,))
    jax_out = {}

    # GatherPlan: forward and gradient
    shard = -(-n // d)
    idx = rng.integers(0, n, size=shard * d)
    gx = rng.normal(size=(shard * d, 2)).astype(np.float32)
    gx[n:] = 0.0
    gw = rng.normal(size=(shard * d, 2)).astype(np.float32)
    tables = jvs.GatherPlan.build(idx, n, d).tables()

    def loss(x):
        def dev(t, x, w):
            out = jvs.apply_gather(t, x)
            return jax.lax.psum(jnp.sum(out * w), jvs.VERTEX_AXIS)
        return shard_map(dev, mesh=mesh,
                         in_specs=(P(jvs.VERTEX_AXIS),) * 3, out_specs=P(),
                         check_vma=False)(tables, x, jnp.asarray(gw))

    jax_out["gather_grad"] = np.asarray(jax.grad(loss)(jnp.asarray(gx)))
    p.update(gather_idx=idx, gather_n=n, gather_x=gx, gather_w=gw)

    # forward and parameter gradients
    model, _ = _jax_vs(setup, mesh)
    fwd = model.make_forward()
    x = rng.normal(size=(n, B, 3)).astype(np.float32)
    xs = jnp.asarray(model.shard_vertices(x))
    out, mu, _ = fwd(params, xs)
    jax_out["fwd_out"], jax_out["fwd_mu"] = np.asarray(out)[:n], \
        np.asarray(mu)

    def loss_p(prm):
        o, m, _ = fwd(prm, xs)
        return jnp.mean(o[:n] ** 2) + jnp.mean(m ** 2)

    jax_out["grads"] = _port(jax.grad(loss_p)(params))
    p["fwd_x"] = x

    # three train steps
    weights = JWeights(**WEIGHTS)
    opt = jax_adam(LR, 0.0)
    step = model.make_train_step(weights, opt, batch_size=B, swap=True)
    state = create_train_state(jax.tree.map(jnp.array, params), opt)
    txs, draws, ms = [], [], []
    for t in range(3):
        xt = rng.normal(size=(n, B, 3)).astype(np.float32)
        key = jax.random.PRNGKey(30 + t)
        state, m = step(state, jnp.asarray(model.shard_vertices(xt)), key)
        txs.append(xt)
        draws.append(_draw(key, setup["regions"], B * B))
        ms.append({k: float(m[k]) for k in KEYS})
    jax_out["train_metrics"], jax_out["train_state"] = ms, \
        _port(state.params)
    p.update(train_x=txs, train_draws=draws)

    # the scanned epoch
    n_data, steps = 5, 3
    data = rng.normal(size=(n, n_data, 3)).astype(np.float32)
    sidx = rng.integers(0, n_data, size=(steps, B)).astype(np.int32)
    sids = np.arange(1, steps + 1, dtype=np.int32)
    key = jax.random.PRNGKey(41)
    epoch = model.make_scanned_epoch(weights, opt, batch_size=B, swap=True)
    state, m = epoch(create_train_state(jax.tree.map(jnp.array, params),
                                        opt),
                     jnp.asarray(model.shard_vertices(data)),
                     jnp.asarray(sidx), jnp.asarray(sids), key)
    jax_out["scan_metrics"] = {k: float(m[k]) for k in KEYS}
    jax_out["scan_state"] = _port(state.params)
    p.update(scan_data=data, scan_idx=sidx, scan_sids=sids, scan_draws={
        int(s): _draw(jax.random.fold_in(key, int(s)), setup["regions"],
                      B * B) for s in sids})

    # the mixed policy: forward and one step
    model_m, _ = _jax_vs(setup, mesh, "mixed")
    out, mu, _ = model_m.make_forward()(params, xs)
    jax_out["mixed_out"], jax_out["mixed_mu"] = np.asarray(out)[:n], \
        np.asarray(mu)
    step = model_m.make_train_step(weights, opt, batch_size=B, swap=True)
    state = create_train_state(jax.tree.map(jnp.array, params), opt)
    state, m = step(state, jnp.asarray(model_m.shard_vertices(txs[0])),
                    jax.random.PRNGKey(30))
    jax_out["mixed_metrics"] = {k: float(m[k]) for k in KEYS}
    jax_out["mixed_state"] = _port(state.params)

    results = ranks.spawn("vertex_worker", d,
                          os.path.join(setup["root"], "one_d"), p)
    return {"jax": jax_out, "port": results, "payload": p, "n": n}


def test_sharded_gather_matches_take(one_d):
    p = one_d["payload"]
    got = np.concatenate([r["gather"] for r in one_d["port"]])
    np.testing.assert_array_equal(got, p["gather_x"][p["gather_idx"]])


def test_gather_plan_gradients(one_d):
    """The backward of the halo exchange (the reverse all_to_all, then the
    send table's capped transpose) and of the local gather: JAX's
    gradient and ``np.add.at``'s."""
    p = one_d["payload"]
    got = np.concatenate([r["gather_grad"] for r in one_d["port"]])
    ref = np.zeros_like(p["gather_x"])
    np.add.at(ref, p["gather_idx"], p["gather_w"])
    assert max_rel(got, ref) <= STEP_RTOL
    assert max_rel(got, one_d["jax"]["gather_grad"]) <= STEP_RTOL


def test_sharded_forward_matches_jax(one_d):
    n = one_d["n"]
    got = _gather_blocks(one_d["port"], "fwd_out", n)
    assert max_rel(got, one_d["jax"]["fwd_out"]) <= STEP_RTOL
    for r in one_d["port"]:
        assert max_rel(r["fwd_mu"], one_d["jax"]["fwd_mu"]) <= STEP_RTOL


def test_sharded_gradients_match_jax(one_d):
    """Parameter gradients of mean(out²) + mean(mu²) through the halo
    exchanges, the all_gather and the local tables' transposes, summed
    over the ranks."""
    want = one_d["jax"]["grads"]
    for r in one_d["port"]:
        for name, v in want.items():
            assert max_rel(r["grads"][name], v) <= STEP_RTOL, name


def test_sharded_train_step_matches_jax(one_d):
    want = one_d["jax"]
    for r in one_d["port"]:
        for t, (mg, mw) in enumerate(zip(r["train_metrics"],
                                         want["train_metrics"])):
            for k in KEYS:
                np.testing.assert_allclose(mg[k], mw[k], rtol=TRAJ_RTOL,
                                           atol=1e-7, err_msg=f"{t} {k}")
        for name, v in want["train_state"].items():
            assert max_rel(r["train_state"][name], v) <= TRAJ_RTOL, name


def test_sharded_scanned_epoch(one_d):
    """The scanned epoch equals the port's per-step path bit for bit (the
    same steps replayed over static tensors) and JAX's scanned epoch to
    the trajectory tolerance."""
    want = one_d["jax"]
    for r in one_d["port"]:
        assert r["scan_equal"]
        for k in KEYS:
            np.testing.assert_allclose(r["scan_metrics"][k],
                                       r["per_step_means"][k], rtol=1e-6,
                                       err_msg=k)
            np.testing.assert_allclose(r["scan_metrics"][k],
                                       want["scan_metrics"][k],
                                       rtol=TRAJ_RTOL, atol=1e-7, err_msg=k)
        for name, v in want["scan_state"].items():
            assert max_rel(r["scan_state"][name], v) <= TRAJ_RTOL, name


def test_sharded_mixed_policy(one_d):
    """Under the mixed policy the deep halo rows move in bf16: the forward
    and one step track JAX's mixed sharded model; the reconstruction and
    the parameters stay fp32."""
    n, want = one_d["n"], one_d["jax"]
    got = _gather_blocks(one_d["port"], "mixed_out", n)
    np.testing.assert_allclose(got, want["mixed_out"], atol=MIXED_TOL,
                               rtol=MIXED_TOL)
    for r in one_d["port"]:
        assert r["mixed_out_dtype"] == "torch.float32"
        assert r["mixed_param_dtypes"] == ["torch.float32"]
        np.testing.assert_allclose(r["mixed_mu"], want["mixed_mu"],
                                   atol=MIXED_TOL, rtol=MIXED_TOL)
        for k in KEYS:
            np.testing.assert_allclose(r["mixed_metrics"][k],
                                       want["mixed_metrics"][k],
                                       atol=MIXED_TOL, rtol=MIXED_TOL,
                                       err_msg=k)
        for name, v in want["mixed_state"].items():
            np.testing.assert_allclose(r["mixed_state"][name], v,
                                       atol=MIXED_TOL, rtol=MIXED_TOL,
                                       err_msg=name)


def test_ranks_hold_equal_parameters(one_d):
    a, b = one_d["port"]
    for which in ("train_state", "scan_state", "mixed_state"):
        for name in a[which]:
            np.testing.assert_array_equal(a[which][name], b[which][name])


# ------------------------------------------------------ 2-D, 2 × 2 ranks
@pytest.fixture(scope="module")
def two_d(setup):
    d_data, d_vert = 2, 2
    n = setup["n"]
    rng = np.random.default_rng(6)
    params = setup["params"]
    p = dict(setup["payload"])
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(d_data, d_vert),
                ("data", jvs.VERTEX_AXIS))
    model, _ = _jax_vs(setup, mesh)
    weights = JWeights(**WEIGHTS)
    opt = jax_adam(LR, 0.0)
    jax_out = {}
    step = model.make_train_step(weights, opt, batch_size=B, swap=True)
    state = create_train_state(jax.tree.map(jnp.array, params), opt)
    txs, draws, ms = [], [[], []], []
    for t in range(2):
        xt = rng.normal(size=(n, d_data * B, 3)).astype(np.float32)
        key = jax.random.PRNGKey(50 + t)
        state, m = step(state, jnp.asarray(model.shard_vertices(xt)), key)
        txs.append(xt)
        for dr in range(d_data):
            draws[dr].append(_draw(jax.random.fold_in(key, dr),
                                   setup["regions"], B * B))
        ms.append({k: float(m[k]) for k in KEYS})
    jax_out["train_metrics"], jax_out["train_state"] = ms, \
        _port(state.params)
    p.update(train_x=txs, train_draws=draws)

    n_data, e_n, st, sv = 6, 2, 2, 1
    data = rng.normal(size=(n, n_data, 3)).astype(np.float32)
    g = d_data * B
    tr_idx = rng.integers(0, n_data, size=(e_n, st, g)).astype(np.int32)
    va_idx = rng.integers(0, n_data, size=(e_n, sv, g)).astype(np.int32)
    e_ar = np.arange(e_n)[:, None]
    tr_sid = (1 + e_ar * (st + sv) + np.arange(st)[None]).astype(np.int32)
    va_sid = (1 + e_ar * (st + sv) + st + np.arange(sv)[None]).astype(
        np.int32)
    key = jax.random.PRNGKey(61)
    epochs = model.make_scanned_epochs(weights, opt, batch_size=B,
                                       swap=True)
    padded = jnp.asarray(model.shard_vertices(data))
    state, tr_m, va_m = epochs(
        create_train_state(jax.tree.map(jnp.array, params), opt), padded,
        padded, jnp.asarray(tr_idx), jnp.asarray(tr_sid),
        jnp.asarray(va_idx), jnp.asarray(va_sid), key)
    jax_out["epochs"] = ([float(v) for v in np.asarray(tr_m["tot"])],
                         [float(v) for v in np.asarray(va_m["tot"])])
    jax_out["epochs_state"] = _port(state.params)
    sids = np.concatenate([tr_sid.reshape(-1), va_sid.reshape(-1)])
    p.update(scan_data=data, tr_idx=tr_idx, tr_sid=tr_sid, va_idx=va_idx,
             va_sid=va_sid, scan_draws=[
                 {int(s): _draw(jax.random.fold_in(
                     jax.random.fold_in(key, int(s)), dr),
                     setup["regions"], B * B) for s in sids}
                 for dr in range(d_data)])
    results = ranks.spawn("vertex2d_worker", d_data * d_vert,
                          os.path.join(setup["root"], "two_d"), p)
    return {"jax": jax_out, "port": results}


def test_2d_mesh_coordinates(two_d):
    assert [r["coords"] for r in two_d["port"]] == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_2d_train_step_matches_jax(two_d):
    """Vertex ranks sum their partitioned terms, data ranks average the
    result: JAX's composed step, per-replica draws."""
    want = two_d["jax"]
    for r in two_d["port"]:
        for t, (mg, mw) in enumerate(zip(r["train_metrics"],
                                         want["train_metrics"])):
            for k in KEYS:
                np.testing.assert_allclose(mg[k], mw[k], rtol=TRAJ_RTOL,
                                           atol=1e-7, err_msg=f"{t} {k}")
        for name, v in want["train_state"].items():
            assert max_rel(r["train_state"][name], v) <= TRAJ_RTOL, name


def test_2d_scanned_epochs(two_d):
    """The multi-epoch scan: bit-equal to the per-step path and within
    the trajectory tolerance of JAX's."""
    want = two_d["jax"]
    for r in two_d["port"]:
        assert r["epochs_equal"]
        for got, ref, jx in zip(r["epochs"], r["epochs_ref"],
                                want["epochs"]):
            np.testing.assert_allclose(got, ref, rtol=1e-6)
            np.testing.assert_allclose(got, jx, rtol=TRAJ_RTOL, atol=1e-7)
        for name, v in want["epochs_state"].items():
            assert max_rel(r["epochs_state"][name], v) <= TRAJ_RTOL, name


# ------------------------------------------------------ host-side plans
@pytest.mark.parametrize("d", [2, 3, 8])
def test_gather_plan_tables_equal_jax(setup, d):
    n = setup["n"]
    rng = np.random.default_rng(d)
    shard = -(-n // d)
    idx = rng.integers(0, n, size=shard * d)
    got = tvs.GatherPlan.build(idx, n, d)
    want = jvs.GatherPlan.build(idx, n, d)
    np.testing.assert_array_equal(got.send_idx, want.send_idx)
    np.testing.assert_array_equal(got.local_idx, want.local_idx)
    assert (got.shard_in, got.shard_out) == (want.shard_in, want.shard_out)


# --------------------------------------------------- one rank, in process
@pytest.fixture
def world_one(tmp_path):
    tparallel.initialize_multihost(
        num_processes=1, process_id=0, device="cpu",
        init_method="file://" + str(tmp_path / "rendezvous"), timeout_s=60)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _port_models(setup, compute_dtype="float32"):
    p = setup["payload"]
    bundle = load_bundle(p["bundle"])
    cfg = SDVAEConfig(out_channels=(8, 16), latent_size=Z,
                      compute_dtype=compute_dtype)
    geom = SpiralGeometry.from_bundle(bundle, device="cpu",
                                      laplacian=p["laplacian"],
                                      region_masks=p["masks"])

    def model():
        m = SDVAE(cfg, geom)
        m.load_state_dict(params_from_jax(p["params"]))
        return m

    vs = tvs.VertexShardedModel(bundle, cfg, tvs.make_vertex_mesh(),
                                laplacian=p["laplacian"],
                                region_masks=p["masks"])
    return model, vs


def test_one_rank_forward_equals_unsharded(world_one, setup):
    """D = 1: the local tables are the global ones over [rows ‖ one halo
    row], so the sharded forward is the unsharded model's, bit for bit."""
    model, vs = _port_models(setup)
    x = np.random.default_rng(1).normal(size=(setup["n"], 3, 3)).astype(
        np.float32)
    m = model()
    out, mu, lv = vs.make_forward()(m, vs.local_block(x))
    with torch.no_grad():
        mu_ref, lv_ref = m.encode(torch.from_numpy(x))
        out_ref = m.decode(mu_ref)
    assert torch.equal(out, out_ref) and torch.equal(mu, mu_ref)
    assert torch.equal(lv, lv_ref)


def test_one_rank_step_matches_unsharded(world_one, setup):
    """D = 1: one sharded train step against the unsharded step on the
    same draws (the losses' sums grouped otherwise, the transposes
    capped over every position): its metrics and the gradients it
    leaves on the parameters. (Adam's first update divides each gradient
    by its own magnitude, so where a gradient is near zero the updates
    part by up to the learning rate; the gradients are what to hold.)"""
    model, vs = _port_models(setup)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(B, setup["n"], 3)).astype(np.float32)
    eps = torch.from_numpy(rng.normal(size=(B * B, Z)).astype(np.float32))
    weights = LossWeights(**WEIGHTS)
    ma, mb = model(), model()
    m_ref = make_train_step(ma, weights, coupled_adam(ma.parameters(), LR,
                                                      0.0), B)(
        torch.from_numpy(x), region_idx=2, eps=eps)
    m_got = vs.make_train_step(mb, weights, coupled_adam(mb.parameters(),
                                                         LR, 0.0), B)(
        vs.local_block(np.swapaxes(x, 0, 1)), 2, eps)
    for k in KEYS:
        np.testing.assert_allclose(float(m_got[k]), float(m_ref[k]),
                                   rtol=STEP_RTOL, err_msg=k)
    for (name, a), c in zip(ma.named_parameters(), mb.parameters()):
        assert max_rel(c.grad.numpy(), a.grad.numpy()) <= STEP_RTOL, name


def test_backward_tables_are_capped_transposes(world_one, setup):
    """Every gather of the sharded path keeps a capped transpose (its
    backward is a gather through it; no scatter is built)."""
    _, vs = _port_models(setup)
    vs._loss_tables()
    levels = vs.enc_levels + vs.dec_levels + vs.up_levels + \
        [vs._loss["lap"]]
    for lv in levels:
        assert isinstance(lv.send.transpose, CappedEll)
    for lv in vs.enc_levels + vs.dec_levels:
        assert lv.op.inv_tables and not lv.op.identity_cols
    for lv in vs.up_levels + [vs._loss["lap"]]:
        assert isinstance(lv.op.transpose, CappedEll)

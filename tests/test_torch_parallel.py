"""The port's data parallelism (``craniofacialsd_vae_tpu_torch/parallel``)
against the JAX package's, on the CPU.

The JAX side runs on two of the virtual CPU devices ``conftest.py``
sets up (``make_data_mesh(2)``); the port's side runs two Gloo ranks
spawned with ``torch.multiprocessing`` (``tests/torch_parallel_ranks.py``,
a ``file://`` rendezvous under ``tmp_path``, joined under a timeout).
Each rank gets JAX's draws for its device (``fold_in`` of the device
index, as JAX's ``device_step`` folds it) injected. Held against JAX's
``make_parallel_train_step``, ``make_parallel_eval_step``,
``make_scanned_parallel_step`` and ``make_scanned_parallel_epochs`` on the
tiny geometry; ``MultihostBatchIterator`` and ``local_batch_slice`` as
``tests/test_multihost.py`` holds JAX's; the data-parallel manager, its
scanned and per-step paths and ``train.main --data_parallel`` on two
ranks; and at world size 1, in this process, against the port's own
single-device steps.

Tolerances: the trainer's parity tests' (``tests/test_torch_training.py``):
rtol 1e-5 of an array's largest value for one step's values, 1e-4 over a
run of Adam steps (fp32 sums taken in another order by XLA and PyTorch
compound). Against the port's own single-device run at world size 1 the
arithmetic is the same (a sum over one rank, then a division by 1), so
parameters and metrics are held bit-equal; so are the two ranks'
replicas, and the manager's scanned and per-step paths."""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import yaml

import jax
import jax.numpy as jnp
from craniofacialsd_vae_tpu.geometry.precompute import _save_bundle
from craniofacialsd_vae_tpu.models import SDVAEConfig as JConfig
from craniofacialsd_vae_tpu.models import init_sdvae as jax_init
from craniofacialsd_vae_tpu.parallel import make_data_mesh as jax_mesh
from craniofacialsd_vae_tpu.parallel import (make_parallel_eval_step as
                                             jax_eval_step)
from craniofacialsd_vae_tpu.parallel import (make_parallel_train_step as
                                             jax_train_step)
from craniofacialsd_vae_tpu.parallel import (make_scanned_parallel_epochs as
                                             jax_scanned_epochs)
from craniofacialsd_vae_tpu.parallel import (make_scanned_parallel_step as
                                             jax_scanned_step)
from craniofacialsd_vae_tpu.training import LossWeights as JWeights
from craniofacialsd_vae_tpu.training import coupled_adam as jax_adam
from craniofacialsd_vae_tpu.training import trainer as jtrainer
from craniofacialsd_vae_tpu_torch import parallel as tparallel
from craniofacialsd_vae_tpu_torch.data.dataset import (BatchIterator,
                                                       MeshArrays,
                                                       build_datasets)
from craniofacialsd_vae_tpu_torch.geometry import load_bundle
from craniofacialsd_vae_tpu_torch.manager import ModelManager
from craniofacialsd_vae_tpu_torch.models import (SDVAE, SDVAEConfig,
                                                 SpiralGeometry,
                                                 params_from_jax)
from craniofacialsd_vae_tpu_torch.parallel import multihost as tmultihost
from craniofacialsd_vae_tpu_torch.training import (LOSS_KEYS, LossWeights,
                                                   coupled_adam,
                                                   make_eval_step,
                                                   make_scanned_train_epochs,
                                                   make_scanned_train_step,
                                                   make_train_step)
from tests import torch_parallel_ranks as ranks
from tests.test_torch_manager import make_workspace
from tests.test_training import _tiny_geometry

STEP_RTOL = 1e-5
TRAJ_RTOL = 1e-4
B, Z, WORLD = 3, 6, 2
LR = 1e-3
WEIGHTS = dict(kl=1e-4, laplacian=0.1, latent_consistency=0.5)


def max_rel(got, want):
    scale = max(float(np.abs(np.asarray(want)).max()), 1e-30)
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()) / scale


def _draw(key, regions, rows=B * B):
    """The region and ε JAX's step draws from ``key``."""
    k_region, k_reparam = jax.random.split(key)
    region = int(jax.random.randint(k_region, (), 0, regions))
    eps = np.array(jax.random.normal(k_reparam, (rows, Z), jnp.float32))
    return region, eps


def _jax_state(params, opt):
    return jtrainer.create_train_state(jax.tree.map(jnp.copy, params), opt)


def _to_port(state) -> dict:
    return {k: v.numpy() for k, v in params_from_jax(
        jax.tree.map(np.asarray, state.params)).items()}


# ------------------------------------------------------------ the fixture
@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """JAX's data-parallel runs on a 2-device mesh, and the port's on two
    Gloo ranks, over the same inputs and draws."""
    root = str(tmp_path_factory.mktemp("dp"))
    geom_j, bundle_j = _tiny_geometry(np.random.default_rng(11),
                                      return_bundle=True)
    path = os.path.join(root, "geometry.npz")
    _save_bundle(path, bundle_j)
    cfg_j = JConfig(out_channels=(8, 16), latent_size=Z)
    params = jax_init(jax.random.PRNGKey(0), cfg_j, geom_j)
    regions = int(geom_j.region_masks.shape[0])
    n = int(geom_j.region_masks.shape[1])
    mesh = jax_mesh(WORLD)
    weights = JWeights(**WEIGHTS)
    opt = jax_adam(LR, 0.0)
    rng = np.random.default_rng(5)
    g = WORLD * B
    payload = {"bundle": path,
               "laplacian": tuple(np.asarray(a)
                                  for a in bundle_j.template.laplacian),
               "masks": np.asarray(geom_j.region_masks),
               "params": jax.tree.map(np.asarray, params),
               "out_channels": (8, 16), "latent": Z, "batch": B, "lr": LR,
               "weights": WEIGHTS}
    jax_out = {}

    # per-step: three steps, then an eval step
    step = jax_train_step(cfg_j, weights, opt, B, mesh)
    state = _jax_state(params, opt)
    xs, draws, ms = [], [[], []], []
    for t in range(3):
        x = rng.normal(size=(g, n, 3)).astype(np.float32)
        key = jax.random.fold_in(jax.random.PRNGKey(7), t)
        state, m = step(state, geom_j, jnp.asarray(x), None, None, key)
        xs.append(x)
        ms.append({k: float(v) for k, v in m.items()})
        for r in range(WORLD):
            draws[r].append(_draw(jax.random.fold_in(key, r), regions))
    jax_out["step_metrics"], jax_out["step_state"] = ms, _to_port(state)
    ev = jax_eval_step(cfg_j, weights, B, mesh)
    x = rng.normal(size=(g, n, 3)).astype(np.float32)
    key = jax.random.PRNGKey(8)
    jax_out["eval"] = {k: float(v) for k, v in
                       ev(state, geom_j, jnp.asarray(x), None, None,
                          key).items()}
    payload.update(step_x=xs, step_draws=draws, eval_x=x,
                   eval_region=[_draw(jax.random.fold_in(key, r),
                                      regions)[0] for r in range(WORLD)])

    # the scanned epoch
    n_data, steps = 9, 4
    data = rng.normal(size=(n_data, n, 3)).astype(np.float32)
    idx = rng.integers(0, n_data, size=(steps, g)).astype(np.int32)
    sids = (5 + np.arange(steps)).astype(np.int32)
    key = jax.random.PRNGKey(21)
    epoch = jax_scanned_step(cfg_j, weights, opt, B, mesh)
    state, m = epoch(_jax_state(params, opt), geom_j, jnp.asarray(data),
                     jnp.asarray(idx), jnp.asarray(sids), None, None, key)
    jax_out["scan_metrics"] = {k: float(v) for k, v in m.items()}
    jax_out["scan_state"] = _to_port(state)
    payload.update(data=data, scan_idx=idx, scan_sids=sids, scan_draws=[
        {int(s): _draw(jax.random.fold_in(jax.random.fold_in(key, int(s)),
                                          r), regions) for s in sids}
        for r in range(WORLD)])

    # the multi-epoch scan
    e_n, st, sv = 2, 2, 1
    tr_idx = rng.integers(0, n_data, size=(e_n, st, g)).astype(np.int32)
    va_idx = rng.integers(0, n_data, size=(e_n, sv, g)).astype(np.int32)
    e_ar = np.arange(e_n)[:, None]
    tr_sid = (1 + e_ar * (st + sv) + np.arange(st)[None]).astype(np.int32)
    va_sid = (1 + e_ar * (st + sv) + st + np.arange(sv)[None]).astype(
        np.int32)
    key = jax.random.PRNGKey(13)
    epochs = jax_scanned_epochs(cfg_j, weights, opt, B, mesh)
    state, tr_m, va_m = epochs(
        _jax_state(params, opt), geom_j, jnp.asarray(data),
        jnp.asarray(data), jnp.asarray(tr_idx), jnp.asarray(tr_sid),
        jnp.asarray(va_idx), jnp.asarray(va_sid), None, None, None, key)
    jax_out["epochs_train"] = {k: np.asarray(v) for k, v in tr_m.items()}
    jax_out["epochs_val"] = {k: np.asarray(v) for k, v in va_m.items()}
    jax_out["epochs_state"] = _to_port(state)
    all_sids = np.concatenate([tr_sid.reshape(-1), va_sid.reshape(-1)])
    payload.update(tr_idx=tr_idx, tr_sid=tr_sid, va_idx=va_idx,
                   va_sid=va_sid, epochs_draws=[
                       {int(s): _draw(jax.random.fold_in(
                           jax.random.fold_in(key, int(s)), r), regions)
                        for s in all_sids} for r in range(WORLD)])

    results = ranks.spawn("dp_worker", WORLD, os.path.join(root, "ranks"),
                          payload)
    return {"jax": jax_out, "port": results, "payload": payload}


# ------------------------------------------------------------ vs JAX
def test_ranks_form_a_two_rank_mesh(dp):
    assert [r["mesh"] for r in dp["port"]] == [(0, 2, 2), (1, 2, 2)]


def test_parallel_train_step_matches_jax(dp):
    """Three data-parallel steps: the averaged metrics of each step and
    the parameters after them."""
    got, want = dp["port"][0], dp["jax"]
    for t, (mg, mw) in enumerate(zip(got["step_metrics"],
                                     want["step_metrics"])):
        tol = STEP_RTOL if t == 0 else TRAJ_RTOL
        for k, v in mw.items():
            np.testing.assert_allclose(mg[k], v, rtol=tol, atol=1e-7,
                                       err_msg=f"step {t} {k}")
    for name, v in want["step_state"].items():
        assert max_rel(got["step_state"][name], v) <= TRAJ_RTOL, name


def test_parallel_eval_step_matches_jax(dp):
    got, want = dp["port"][0]["eval"], dp["jax"]["eval"]
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=TRAJ_RTOL, atol=1e-7,
                                   err_msg=k)


def test_scanned_parallel_step_matches_jax(dp):
    got, want = dp["port"][0], dp["jax"]
    for k, v in want["scan_metrics"].items():
        np.testing.assert_allclose(got["scan_metrics"][k], v,
                                   rtol=TRAJ_RTOL, atol=1e-7, err_msg=k)
    for name, v in want["scan_state"].items():
        assert max_rel(got["scan_state"][name], v) <= TRAJ_RTOL, name


def test_scanned_parallel_epochs_match_jax(dp):
    got, want = dp["port"][0], dp["jax"]
    for phase in ("train", "val"):
        for e, m in enumerate(got[f"epochs_{phase}"]):
            for k, v in want[f"epochs_{phase}"].items():
                np.testing.assert_allclose(m[k], float(v[e]),
                                           rtol=TRAJ_RTOL, atol=1e-7,
                                           err_msg=f"{phase} {e} {k}")
    for name, v in want["epochs_state"].items():
        assert max_rel(got["epochs_state"][name], v) <= TRAJ_RTOL, name


@pytest.mark.parametrize("which", ["step_state", "scan_state",
                                   "epochs_state"])
def test_replicas_stay_equal(dp, which):
    """Coupled Adam runs on every rank on the averaged gradients: the two
    ranks' parameters are bit-equal after every path."""
    a, b = dp["port"][0][which], dp["port"][1][which]
    for name in a:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


# ------------------------------------------- world size 1, this process
@pytest.fixture
def world_one(tmp_path):
    tparallel.initialize_multihost(
        num_processes=1, process_id=0, device="cpu",
        init_method="file://" + str(tmp_path / "rendezvous"), timeout_s=60)
    try:
        yield tparallel.make_data_mesh()
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def tiny_port(dp):
    p = dp["payload"]
    geom = SpiralGeometry.from_bundle(load_bundle(p["bundle"]), device="cpu",
                                      laplacian=p["laplacian"],
                                      region_masks=p["masks"])

    def model():
        m = SDVAE(SDVAEConfig(out_channels=(8, 16), latent_size=Z), geom)
        m.load_state_dict(params_from_jax(p["params"]))
        return m

    return p, model


def _same(a: torch.nn.Module, b: torch.nn.Module):
    for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), name


def test_world_one_steps_are_bit_equal(world_one, tiny_port):
    """At world size 1 the data-parallel train and eval steps are the
    single-device steps, bit for bit."""
    p, model = tiny_port
    weights = LossWeights(**WEIGHTS)
    ma, mb = model(), model()
    sa = make_train_step(ma, weights, coupled_adam(ma.parameters(), LR, 0.0),
                         B)
    sb = tparallel.make_parallel_train_step(
        mb, weights, coupled_adam(mb.parameters(), LR, 0.0), B, world_one)
    assert world_one.ranks and world_one.world == 1
    for t, x in enumerate(p["step_x"]):
        region, eps = p["step_draws"][0][t]
        xb = torch.from_numpy(x[:B])
        m_a = sa(xb, region_idx=region, eps=torch.from_numpy(eps))
        m_b = sb(xb, region_idx=region, eps=torch.from_numpy(eps))
        for k in LOSS_KEYS:
            assert torch.equal(m_a[k], m_b[k]), (t, k)
    _same(ma, mb)
    ea = make_eval_step(ma, weights, B)(torch.from_numpy(p["eval_x"][:B]),
                                        region_idx=1)
    eb = tparallel.make_parallel_eval_step(mb, weights, B, world_one)(
        torch.from_numpy(p["eval_x"][:B]), region_idx=1)
    for k in LOSS_KEYS:
        assert torch.equal(ea[k], eb[k]), k


def test_world_one_scanned_forms_are_bit_equal(world_one, tiny_port):
    """The scanned epoch and the multi-epoch scan at world size 1 against
    the single-device scanned forms on the same plan and draws."""
    p, model = tiny_port
    weights = LossWeights(**WEIGHTS)
    draws = ranks._lookup(p["scan_draws"][0])
    idx = p["scan_idx"][:, :B]
    data = torch.from_numpy(p["data"])
    ma, mb = model(), model()
    ea = make_scanned_train_step(ma, weights, coupled_adam(
        ma.parameters(), LR, 0.0), B, draws=draws)
    eb = tparallel.make_scanned_parallel_step(
        mb, weights, coupled_adam(mb.parameters(), LR, 0.0), B, world_one,
        draws=draws)
    assert ea(data, idx, p["scan_sids"]) == eb(data, idx, p["scan_sids"])
    _same(ma, mb)

    draws = ranks._lookup(p["epochs_draws"][0])
    ma, mb = model(), model()
    fa = make_scanned_train_epochs(ma, weights, coupled_adam(
        ma.parameters(), LR, 0.0), B, draws=draws)
    fb = tparallel.make_scanned_parallel_epochs(
        mb, weights, coupled_adam(mb.parameters(), LR, 0.0), B, world_one,
        draws=draws)
    args = (p["tr_idx"][..., :B], p["tr_sid"], p["va_idx"][..., :B],
            p["va_sid"])
    assert fa(data, data, *args) == fb(data, data, *args)
    _same(ma, mb)


def test_shard_batch_and_replicate(world_one):
    """A global batch's rows: the rank's own (here all of them) on its
    device, or one slice per device of a devices' mesh; a replica of a
    module on each device of the mesh, its parameters equal."""
    x = torch.arange(24.0).reshape(6, 4)
    got = tparallel.shard_batch(world_one, {"x": x, "labels": np.arange(6)})
    assert torch.equal(got["x"], x) and got["labels"].tolist() == list(
        range(6))
    two = tparallel.Mesh(devices=[torch.device("cpu")] * 2)
    assert not two.ranks and two.size == 2
    halves = tparallel.shard_batch(two, x)
    assert [h.tolist() for h in halves] == [x[:3].tolist(), x[3:].tolist()]
    with pytest.raises(ValueError, match="does not split"):
        tparallel.shard_batch(two, x[:5])
    lin = torch.nn.Linear(3, 2)
    reps = tparallel.replicate(two, lin)
    assert len(reps) == 2 and all(r is not lin for r in reps)
    for r in reps:
        assert torch.equal(r.weight, lin.weight)
    assert tparallel.replicate(world_one, lin) is lin


def test_local_rows_take_global_or_local_batches(world_one):
    x = torch.arange(12.0).reshape(3, 4)
    assert tparallel.train_parallel.local_rows(world_one, x, 3) is x
    with pytest.raises(ValueError, match="global"):
        tparallel.train_parallel.local_rows(world_one, x, 2)


# ------------------------------------------- multihost (test_multihost)
def test_local_batch_slice_single_process():
    assert tparallel.local_batch_slice(32) == slice(0, 32)


@pytest.mark.parametrize("count", [4, 8])
def test_local_batch_slices_tile_the_global_batch(monkeypatch, count):
    """Every rank's slice, in rank order, covers the global batch once."""
    monkeypatch.setattr(tmultihost, "process_count", lambda: count)
    covered = []
    for pid in range(count):
        monkeypatch.setattr(tmultihost, "process_index", lambda p=pid: p)
        sl = tparallel.local_batch_slice(32)
        assert sl == slice(pid * 32 // count, (pid + 1) * 32 // count)
        covered.extend(range(sl.start, sl.stop))
    assert covered == list(range(32))


def _arrays(n=24, verts=12):
    rng = np.random.default_rng(0)
    return MeshArrays(
        x=rng.normal(size=(n, verts, 3)).astype(np.float32), y=["a"] * n,
        age=np.zeros(n, np.float32), gender=["m"] * n,
        augmented=np.zeros(n, bool), names=[f"a_{i}.obj" for i in range(n)])


def test_global_batch_from_local_keeps_the_rows(world_one):
    x = np.arange(6 * 3, dtype=np.float32).reshape(6, 3)
    got = tparallel.global_batch_from_local(world_one, x)
    assert isinstance(got, torch.Tensor) and got.device == world_one.device
    np.testing.assert_array_equal(got.numpy(), x)


def test_multihost_iterator_wraps_batches(world_one):
    """One process: each batch keeps its (whole) slice as a tensor on the
    rank's device, with its labels, marked local; the plan is the base
    iterator's."""
    base = BatchIterator(_arrays(), 4, shuffle=False, class2idx={"a": 0})
    it = tparallel.MultihostBatchIterator(base, world_one)
    assert len(it) == len(base) and it.batch_size == 4 and it.drop_last
    batches = list(it)
    assert len(batches) == len(base)
    host = list(BatchIterator(_arrays(), 4, shuffle=False,
                              class2idx={"a": 0}))
    for got, want in zip(batches, host):
        assert got["local"] and isinstance(got["x"], torch.Tensor)
        np.testing.assert_array_equal(got["x"].numpy(), want["x"])
        np.testing.assert_array_equal(got["labels"].numpy(),
                                      want["labels"])
    x, idx, _ = it.epoch_plan()
    assert idx.shape == (len(base), 4)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the "
                    "behaviour without a card")
def test_parallel_entry_points_default_to_the_card(tmp_path):
    """Without ``device="cpu"`` the mesh, the process group and
    ``train.py --data_parallel`` ask for the card, and raise without
    one; nothing is written first."""
    from craniofacialsd_vae_tpu_torch import train as ttrain

    with pytest.raises(RuntimeError, match="no CUDA device"):
        tparallel.make_data_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tparallel.initialize_multihost(
            num_processes=1, process_id=0,
            init_method="file://" + str(tmp_path / "rendezvous"))
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--config", "configurations/smoke.yaml", "--id", "x",
                     "--output_path", str(tmp_path), "--data_parallel"])
    assert not os.path.exists(tmp_path / "outputs")


def test_enable_data_parallel_needs_the_process_group(tmp_path):
    config = make_workspace(str(tmp_path))
    mgr = ModelManager(config, config["data"]["precomputed_path"],
                       device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        mgr.enable_data_parallel()
    assert mgr.mesh is None and mgr._global_batch_size == mgr.batch_size


# ------------------------------------------------- the manager, 2 ranks
@pytest.fixture(scope="module")
def mgr_ranks(tmp_path_factory):
    """A data-parallel manager and ``train.main --data_parallel`` on two
    ranks over ``make_workspace``'s run (caches made here first, so the
    ranks only read them)."""
    root = str(tmp_path_factory.mktemp("dp_mgr"))
    config = make_workspace(root, per_class=14)
    config["optimization"]["epochs"] = 2
    config["logging_frequency"] = {"tb_renderings": 100, "save_weights": 100}
    path = os.path.join(root, "config.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    mgr = ModelManager(config, config["data"]["precomputed_path"],
                       device="cpu")
    build_datasets(config, mgr.template, device="cpu")
    results = ranks.spawn("manager_worker", WORLD,
                          os.path.join(root, "ranks"),
                          {"config": config, "config_path": path,
                           "root": root})
    return {"root": root, "port": results}


def test_manager_scanned_epoch_equals_per_step(mgr_ranks):
    """The scanned epoch (a global plan, each rank its columns) and the
    per-step path over ``MultihostBatchIterator`` (each rank its rows)
    take the same steps: equal losses and bit-equal parameters."""
    for r in mgr_ranks["port"]:
        assert r["states_equal"]
        for a, b in zip(r["scanned"], r["per_step"]):
            for k in LOSS_KEYS:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-6, err_msg=k)


def test_manager_ranks_slice_and_agree(mgr_ranks):
    r0, r1 = mgr_ranks["port"]
    assert r0["slice"] == (0, 2) and r1["slice"] == (2, 4)
    assert r0["local_rows_equal"] and r1["local_rows_equal"]
    assert r0["local_labels_equal"] and r1["local_labels_equal"]
    for name in r0["state"]:
        np.testing.assert_array_equal(r0["state"][name], r1["state"][name])
    assert r0["epochs"] == r1["epochs"]
    assert all(np.isfinite(m["tot"]) for m in r0["epochs"][0])


def test_entry_point_data_parallel_two_ranks(mgr_ranks):
    """``train.main --data_parallel`` in each rank: both train the same
    epochs; rank 0 alone writes the checkpoint, the scalars and the zoo,
    and counts world × B² meshes per step."""
    r0, r1 = mgr_ranks["port"]
    assert r0["entry"]["world"] == r1["entry"]["world"] == 2
    assert r1["entry"]["rank"] == 1
    h0, h1 = r0["entry"]["history"], r1["entry"]["history"]
    assert [e["train"] for e in h0] == [e["train"] for e in h1]
    run = os.path.join(mgr_ranks["root"], "outputs", "dp")
    names = os.listdir(os.path.join(run, "checkpoints"))
    assert "model_00000002.ckpt" in names and "classifiers.npz" in names
    with open(os.path.join(run, "logs", "metrics.jsonl")) as f:
        lines = [line for line in f if "train/tot" in line]
    assert len(lines) == 2                  # one writer: rank 0's
    assert "entry_state" in r0 and "entry_state" not in r1


def test_entry_point_world_one_equals_single_device(tmp_path):
    """``--data_parallel`` with one device runs in this process at world
    size 1, through the same code: the same losses and weights as the
    plain run, bit for bit."""
    from craniofacialsd_vae_tpu_torch import train as ttrain

    root = str(tmp_path)
    config = make_workspace(root)
    config["logging_frequency"] = {"tb_renderings": 100, "save_weights": 100}
    path = os.path.join(root, "cfg.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    args = ["--config", path, "--output_path", root, "--device", "cpu"]
    a = ttrain.main(args + ["--id", "plain"])
    b = ttrain.main(args + ["--id", "dp", "--data_parallel"])
    assert not dist.is_initialized()
    assert b["world"] == 1
    assert [e["train"] for e in a["history"]] == \
        [e["train"] for e in b["history"]]
    _same(a["manager"].model, b["manager"].model)


def test_entry_point_multihost_two_ranks(mgr_ranks):
    """``train.main --multihost`` in two processes meeting at a TCP
    coordinator on this host (``--coordinator``, ``--num_processes``,
    ``--process_id``): both train the same epochs at world size 2 and
    end their group; rank 0 writes the checkpoint."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    root = mgr_ranks["root"]
    res = ranks.spawn("multihost_worker", WORLD,
                      os.path.join(root, "mh_ranks"),
                      {"config_path": os.path.join(root, "config.yaml"),
                       "root": root, "coordinator": f"127.0.0.1:{port}"},
                      group=False)
    assert [r["world"] for r in res] == [2, 2]
    assert [r["rank"] for r in res] == [0, 1]
    assert res[0]["history"] == res[1]["history"]
    assert not any(r["group_left"] for r in res)
    names = os.listdir(os.path.join(root, "outputs", "mh", "checkpoints"))
    assert "model_00000002.ckpt" in names

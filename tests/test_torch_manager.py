"""The port's ``ModelManager`` and ``train`` entry point against the JAX
package's, on the ``test_manager_integration.py`` workspace (octasphere
subdivision 2, 3 regions, widths 8/16, latent 6, batch 2) with an
end-to-end MLP head.

``run_epoch`` tracks JAX's over two epochs within 1e-4: the port starts
from JAX's initial weights, iterates the same batches, and takes each
step's region and noise from JAX's key schedule (``fold_in`` of the
running step id on ``PRNGKey(seed + 1)``, then ``split`` → ``randint`` /
``normal``), monkeypatched into the port's ``_step_draws``. The
classification term and the head's step are held against JAX's
``_compute_losses`` at rtol 1e-5."""

import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp
from craniofacialsd_vae_tpu.data import dataset as jdataset
from craniofacialsd_vae_tpu.manager import ModelManager as JManager
from craniofacialsd_vae_tpu.models import SDVAEConfig as JConfig
from craniofacialsd_vae_tpu.models import init_mlp as jinit_mlp
from craniofacialsd_vae_tpu.models import init_sdvae as jinit_sdvae
from craniofacialsd_vae_tpu.training import LossWeights as JWeights
from craniofacialsd_vae_tpu.training import coupled_adam as jadam
from craniofacialsd_vae_tpu.training import trainer as jtrainer
from craniofacialsd_vae_tpu_torch import train as ttrain
from craniofacialsd_vae_tpu_torch.data import dataset as tdataset
from craniofacialsd_vae_tpu_torch.geometry import (load_bundle,
                                                   synthetic_template,
                                                   write_obj, write_ply)
from craniofacialsd_vae_tpu_torch.manager import ModelManager
from craniofacialsd_vae_tpu_torch.models import (SDVAE, SDVAEConfig,
                                                 SpiralGeometry, init_mlp,
                                                 mlp_from_jax,
                                                 params_from_jax)
from craniofacialsd_vae_tpu_torch.training import (LOSS_KEYS, LossWeights,
                                                   coupled_adam,
                                                   compute_losses,
                                                   make_train_step)
from craniofacialsd_vae_tpu_torch.training.checkpoint import \
    named_from_tree
from tests.test_training import _tiny_geometry

TRACK_RTOL = 1e-4
STEP_RTOL = 1e-5


def make_workspace(root, mlp_training_type="end2end", weight_decay=0.0,
                   per_class=8):
    """The integration workspace under ``root``: a coloured template PLY,
    ``per_class`` OBJ scans of classes a/c/n and a config dict."""
    tpl = synthetic_template(subdivisions=2, n_regions=3)
    tpl_path = os.path.join(root, "template.ply")
    write_ply(tpl_path, tpl.pos, tpl.face, tpl.colors)
    mesh_dir = os.path.join(root, "meshes")
    os.makedirs(mesh_dir, exist_ok=True)
    rng = np.random.default_rng(0)
    for c in ["a", "c", "n"]:
        for i in range(per_class):
            verts = tpl.pos + rng.normal(scale=0.03, size=tpl.pos.shape) \
                + (0.05 if c == "a" else -0.05 if c == "c" else 0.0)
            write_obj(os.path.join(mesh_dir, f"{c}_{i}.obj"), verts,
                      tpl.face)
    return {
        "data": {
            "template_path": tpl_path, "dataset_path": mesh_dir,
            "precomputed_path": os.path.join(root, "precomp"),
            "normalize_data": True, "to_mm_constant": 10.0,
            "swap_features": True, "stratified_split": True,
            "augmentation_factor": 0,
        },
        "optimization": {
            "epochs": 2, "batch_size": 2, "lr": 1e-3,
            "weight_decay": weight_decay, "laplacian_weight": 0.1,
            "kl_weight": 1e-4, "latent_consistency_weight": 0.5,
            "latent_consistency_eta1": 0.5, "latent_consistency_eta2": 0.5,
        },
        "model": {
            "sampling": {"type": "basic", "sampling_factors": [2, 2]},
            "spirals": {"length": [5, 5], "dilation": [1, 1]},
            "in_channels": 3, "out_channels": [8, 16],
            "latent_size": 6, "pre_z_sigmoid": False,
        },
        "classifier": {
            "main_model_type": "qda", "mlp_training_type": mlp_training_type,
            "mlp_hidden_features": [8], "mlp_lr": 1e-3, "mlp_epochs": 2,
            "mlp_loss_weight": 1,
        },
        "logging_frequency": {"tb_renderings": 2, "save_weights": 2},
    }


def jax_draws(seed, n_regions, latent):
    """The port's ``_step_draws`` signature, drawing what JAX's manager
    draws at each step id."""
    epoch_key = jax.random.PRNGKey(seed + 1)

    def draws(step_id, rows):
        k_region, k_reparam = jax.random.split(
            jax.random.fold_in(epoch_key, step_id))
        region = int(jax.random.randint(k_region, (), 0, n_regions))
        eps = np.array(jax.random.normal(k_reparam, (rows, latent),
                                         jnp.float32))
        return region, torch.from_numpy(eps)

    return draws


def copy_jax_state(port, jstate):
    """The JAX manager's parameters into the port's manager."""
    port.model.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, jstate.params)))
    if port.head is not None:
        port.head.load_state_dict(mlp_from_jax(
            jax.tree.map(np.asarray, jstate.clf_params)))


def max_rel(got, want):
    scale = max(float(np.abs(want).max()), 1e-30)
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()) / scale


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mgr"))
    config = make_workspace(root)
    jm = JManager(config, config["data"]["precomputed_path"])
    tm = ModelManager(config, config["data"]["precomputed_path"],
                      device="cpu")
    train, val, test, norm, weights = tdataset.build_datasets(
        config, tm.template)
    jm.set_class_conversions_and_weights(weights)
    tm.set_class_conversions_and_weights(weights)
    return dict(root=root, config=config, jm=jm, tm=tm, train=train, val=val,
                norm=norm, weights=weights)


# ------------------------------------------------------------- the epoch
def test_run_epoch_tracks_jax_over_two_epochs(ws):
    """Train and validation losses of two epochs within 1e-4, and the
    parameters after them within 1e-4 of each leaf's max."""
    jm, tm, config = ws["jm"], ws["tm"], ws["config"]
    copy_jax_state(tm, jm.state)
    tm._step_draws = jax_draws(0, len(tm.template.region_names),
                               config["model"]["latent_size"])
    c2i = jm._class2idx_dict
    its = {pkg: (mod.BatchIterator(ws["train"], 2, shuffle=True, seed=0,
                                   class2idx=c2i),
                 mod.BatchIterator(ws["val"], 2, shuffle=True, seed=0,
                                   class2idx=c2i))
           for pkg, mod in (("j", jdataset), ("t", tdataset))}
    for epoch in range(2):
        for train in (True, False):
            it_j = its["j"][0 if train else 1]
            it_t = its["t"][0 if train else 1]
            want = jm.run_epoch(it_j, train=train)
            got = tm.run_epoch(it_t, train=train)
            for k in LOSS_KEYS:
                np.testing.assert_allclose(
                    got[k], want[k], rtol=TRACK_RTOL, atol=1e-7,
                    err_msg=f"epoch {epoch} train={train} {k}")
    assert want["classification"] > 0
    assert tm._step_counter == jm._step_counter
    after = params_from_jax(jax.tree.map(np.asarray, jm.state.params))
    for name, p in tm.model.state_dict().items():
        assert max_rel(p.numpy(), after[name].numpy()) <= TRACK_RTOL, name
    head = mlp_from_jax(jax.tree.map(np.asarray, jm.state.clf_params))
    for name, p in tm.head.state_dict().items():
        assert max_rel(p.numpy(), head[name].numpy()) <= TRACK_RTOL, name


def test_default_draws_are_the_same_on_every_call():
    """Without the monkeypatch, a step's draws depend on the seed and the
    step id alone (so a card run and a host run draw alike)."""
    mgr = ModelManager.__new__(ModelManager)
    mgr._seed, mgr.device = 3, torch.device("cpu")
    mgr.geometry = type("G", (), {"region_masks": torch.ones(5, 4)})()
    mgr.net_config = SDVAEConfig(latent_size=10)
    a, b = mgr._step_draws(7, 4), mgr._step_draws(7, 4)
    assert a[0] == b[0] and torch.equal(a[1], b[1])
    assert a[1].shape == (4, 10) and 0 <= a[0] < 5
    c = mgr._step_draws(8, 4)
    assert not torch.equal(a[1], c[1])


# ------------------------------------------------------------ the surface
def test_manager_surface_matches_jax(ws):
    jm, tm = ws["jm"], ws["tm"]
    assert tm.loss_keys == jm.loss_keys
    assert tm.latent_regions == jm.latent_regions
    assert list(tm.latent_regions) == list(jm.latent_regions)
    assert tm.is_vae == jm.is_vae
    assert tm.model_latent_size == jm.model_latent_size
    assert tm.batch_diagonal_idx == jm.batch_diagonal_idx
    assert tm._count_dataset_classes() == jm._count_dataset_classes()
    assert tm._class2idx_dict == jm._class2idx_dict
    assert tm.class2idx(["a", "n"]) == jm.class2idx(["a", "n"])
    assert tm.idx2class(np.array([0, 1])) == jm.idx2class(np.array([0, 1]))
    np.testing.assert_array_equal(tm._class_weights.numpy(),
                                  np.asarray(jm._class_weights))
    assert tm.can_scan_epochs() is False
    # the zoo is built from the config as JAX builds it
    zt, zj = tm.build_classifiers(), jm.build_classifiers()
    for field in ("latent_size", "latent_regions", "mlp_hidden", "mlp_lr",
                  "mlp_epochs", "mlp_weight_decay", "mlp_batch",
                  "mlp_restarts"):
        assert getattr(zt, field) == getattr(zj, field), field
    assert zt.device == tm.device
    tm.classifiers = jm.classifiers = None


def test_inference_and_encode_all_match_jax(ws):
    jm, tm = ws["jm"], ws["tm"]
    copy_jax_state(tm, jm.state)
    x = ws["train"].x[:3]
    z_t, z_j = tm.encode(x), np.asarray(jm.encode(x))
    assert max_rel(z_t.numpy(), z_j) <= STEP_RTOL
    assert max_rel(tm.encode(x[0]).numpy(), z_j[0]) <= STEP_RTOL
    assert max_rel(tm.generate(z_j).numpy(),
                   np.asarray(jm.generate(z_j))) <= STEP_RTOL
    out_t = tm.forward(x)[0].numpy()
    out_j = np.asarray(jm.forward(x)[0])
    assert max_rel(out_t, out_j) <= STEP_RTOL
    np.testing.assert_allclose(
        tm.compute_vertex_errors(out_t, x),
        np.asarray(jm.compute_vertex_errors(out_j, x)), rtol=1e-4)
    it_t = tdataset.BatchIterator(ws["val"], 1, shuffle=False)
    it_j = jdataset.BatchIterator(ws["val"], 1, shuffle=False)
    (lat_t, lab_t), (lat_j, lab_j) = tm.encode_all(it_t), jm.encode_all(it_j)
    assert max_rel(lat_t, lat_j) <= STEP_RTOL and lab_t == lab_j


def test_log_images_renders_the_grid(ws):
    from craniofacialsd_vae_tpu_torch.viz.logging import JsonlWriter

    tm = ws["tm"]
    batch = next(iter(tdataset.BatchIterator(ws["train"], 2)))
    writer = JsonlWriter(os.path.join(ws["root"], "img_logs"))
    grid = tm.log_images(batch, writer, 0, ws["norm"], error_max_scale=2)
    writer.close()
    assert grid.shape == (3 * (256 + 10) + 10, 2 * (256 + 10) + 10, 3)
    assert np.isfinite(grid).all()
    imgs = tm.render(batch["x"], image_size=32)
    assert imgs.shape == (2, 32, 32, 3) and (imgs.sum(-1) > 0).any()


def test_log_images_does_not_swallow_a_render_fault(ws, monkeypatch):
    from craniofacialsd_vae_tpu_torch.viz import renderer

    def broken(*args, **kwargs):
        raise RuntimeError("a K7 fault")

    monkeypatch.setattr(renderer, "render_batch", broken)
    batch = next(iter(tdataset.BatchIterator(ws["train"], 2)))
    with pytest.raises(RuntimeError, match="K7"):
        ws["tm"].log_images(batch, object(), 0)


def test_entry_points_refuse_a_missing_card(ws):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        ModelManager(ws["config"], ws["config"]["data"]["precomputed_path"])
    with pytest.raises(RuntimeError, match="CUDA"):
        tdataset.DeviceBatchIterator(ws["train"], 2)


# -------------------------------------------------- the classification term
@pytest.fixture(scope="module")
def tiny():
    geom_j, bundle_j = _tiny_geometry(np.random.default_rng(11),
                                      return_bundle=True)
    return geom_j, bundle_j


def test_end_to_end_step_with_the_head_matches_jax(tiny, tmp_path):
    """``compute_losses`` with the head against JAX's ``_compute_losses``
    on a swap grid (rtol 1e-5 on every metric), then one step of each
    package's train step: the head's update within 1e-5 of its max."""
    from craniofacialsd_vae_tpu.geometry.precompute import _save_bundle

    geom_j, bundle_j = tiny
    path = str(tmp_path / "geometry.npz")
    _save_bundle(path, bundle_j)
    geom_t = SpiralGeometry.from_bundle(
        load_bundle(path), device="cpu",
        laplacian=bundle_j.template.laplacian,
        region_masks=np.asarray(geom_j.region_masks))
    b, z, n_classes = 3, 6, 4
    cfg_j = JConfig(out_channels=(8, 16), latent_size=z)
    params = jinit_sdvae(jax.random.PRNGKey(0), cfg_j, geom_j)
    clf = jinit_mlp(jax.random.PRNGKey(1), z, [8, 5], n_classes)
    w = dict(kl=1e-4, laplacian=0.1, latent_consistency=0.5,
             classification=2.0)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(b, geom_j.region_masks.shape[1], 3)).astype(
        np.float32)
    labels = np.array([0, 3, 1], np.int32)
    cw = np.array([0.1, 0.4, 0.2, 0.3], np.float32)
    key = jax.random.PRNGKey(5)
    k_region, k_reparam = jax.random.split(key)
    region = int(jax.random.randint(k_region, (), 0,
                                    geom_j.region_masks.shape[0]))
    eps = np.array(jax.random.normal(k_reparam, (b * b, z), jnp.float32))

    model = SDVAE(SDVAEConfig(out_channels=(8, 16), latent_size=z), geom_t)
    model.load_state_dict(params_from_jax(params))
    head = init_mlp(z, [8, 5], n_classes)
    head.load_state_dict(mlp_from_jax(clf))
    from craniofacialsd_vae_tpu.data.swap import swap_features_dynamic
    from craniofacialsd_vae_tpu.models.sdvae import to_vertex_major
    from craniofacialsd_vae_tpu_torch.data import swap_features_dynamic as \
        tswap

    x_grid_j = swap_features_dynamic(to_vertex_major(jnp.asarray(x)),
                                     geom_j.region_masks, region)
    _, m_j = jtrainer._compute_losses(
        params, clf, geom_j, cfg_j, JWeights(**w), x_grid_j, region,
        jnp.asarray(labels), jnp.asarray(cw), b, k_reparam, training=True,
        swap=True)
    x_grid_t = tswap(torch.from_numpy(x).transpose(0, 1),
                     geom_t.region_masks, region)
    _, m_t = compute_losses(model, LossWeights(**w), x_grid_t, region, b,
                            eps=torch.from_numpy(eps), training=True,
                            swap=True, head=head,
                            labels=torch.from_numpy(labels).long(),
                            class_weights=torch.from_numpy(cw))
    assert float(m_j["classification"]) > 0
    for k in LOSS_KEYS:
        np.testing.assert_allclose(float(m_t[k].detach()), float(m_j[k]),
                                   rtol=STEP_RTOL, err_msg=k)

    opt_j, clf_opt_j = jadam(1e-3, 0.0), jadam(1e-2, 0.0)
    step_j = jtrainer.make_train_step(cfg_j, JWeights(**w), opt_j, b,
                                      clf_optimizer=clf_opt_j)
    state = jtrainer.create_train_state(
        jax.tree.map(jnp.copy, params), opt_j, jax.tree.map(jnp.copy, clf),
        clf_opt_j)
    state, _ = step_j(state, geom_j, jnp.asarray(x), jnp.asarray(labels),
                      jnp.asarray(cw), key)
    step_t = make_train_step(model, LossWeights(**w),
                             coupled_adam(model.parameters(), 1e-3, 0.0), b,
                             head=head,
                             head_optimizer=coupled_adam(head.parameters(),
                                                         1e-2, 0.0))
    step_t(torch.from_numpy(x), region_idx=region, eps=torch.from_numpy(eps),
           labels=torch.from_numpy(labels).long(),
           class_weights=torch.from_numpy(cw))
    before = mlp_from_jax(clf)
    after = mlp_from_jax(jax.tree.map(np.asarray, state.clf_params))
    for name, p in head.state_dict().items():
        want = (after[name] - before[name]).numpy()
        got = (p - before[name]).numpy()
        assert np.abs(want).max() > 0
        assert max_rel(got, want) <= STEP_RTOL, name


def test_step_without_swap_takes_any_batch_size(tiny, tmp_path):
    """Without the swap the JAX step takes a batch of any size (a last,
    short validation batch with ``drop_last=False``), and so does the
    port's. Losses against JAX at rtol 1e-5."""
    from craniofacialsd_vae_tpu.geometry.precompute import _save_bundle

    geom_j, bundle_j = tiny
    path = str(tmp_path / "geometry.npz")
    _save_bundle(path, bundle_j)
    geom_t = SpiralGeometry.from_bundle(
        load_bundle(path), device="cpu",
        laplacian=bundle_j.template.laplacian,
        region_masks=np.asarray(geom_j.region_masks))
    cfg_j = JConfig(out_channels=(8, 16), latent_size=6)
    params = jinit_sdvae(jax.random.PRNGKey(0), cfg_j, geom_j)
    w = dict(kl=1e-4, laplacian=0.1, latent_consistency=0.0)
    x = np.random.default_rng(6).normal(
        size=(2, geom_j.region_masks.shape[1], 3)).astype(np.float32)
    key = jax.random.PRNGKey(2)
    opt = jadam(1e-3, 0.0)
    step_j = jtrainer.make_train_step(cfg_j, JWeights(**w), opt, 3,
                                      swap=False)
    state = jtrainer.create_train_state(jax.tree.map(jnp.copy, params), opt)
    _, m_j = step_j(state, geom_j, jnp.asarray(x), None, None, key)
    eps = np.array(jax.random.normal(jax.random.split(key)[1], (2, 6)))
    model = SDVAE(SDVAEConfig(out_channels=(8, 16), latent_size=6), geom_t)
    model.load_state_dict(params_from_jax(params))
    step_t = make_train_step(model, LossWeights(**w),
                             coupled_adam(model.parameters(), 1e-3, 0.0), 3,
                             swap=False)
    m_t = step_t(torch.from_numpy(x), eps=torch.from_numpy(eps))
    for k in LOSS_KEYS:
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]),
                                   rtol=STEP_RTOL, err_msg=k)


def test_head_forward_equals_jax_mlp_apply():
    from craniofacialsd_vae_tpu.models import mlp_apply

    layers = jinit_mlp(jax.random.PRNGKey(3), 6, [16, 8], 4)
    head = init_mlp(6, [16, 8], 4)
    head.load_state_dict(mlp_from_jax(layers))
    assert [tuple(layer.w.shape) for layer in head.layers] == \
        [(6, 16), (16, 8), (8, 4)]
    x = np.random.default_rng(0).normal(size=(9, 6)).astype(np.float32)
    logits_j, lab_j = mlp_apply(layers, jnp.asarray(x))
    logits_t, lab_t = head(torch.from_numpy(x))
    assert max_rel(logits_t.detach().numpy(), np.asarray(logits_j)) <= 1e-6
    np.testing.assert_array_equal(lab_t.numpy(), np.asarray(lab_j))
    assert float(logits_t.min()) >= 0.0        # ReLU after the last layer


# ----------------------------------------------------------- the entry point
def test_train_main_writes_the_run_dir_and_resumes(tmp_path):
    """``train.main([... "--device", "cpu"])`` writes the run dir with the
    cadences of the config; ``--resume --epochs 3`` restores epoch 2 (the
    parameters and Adam moments of model_00000002.ckpt) and goes on."""
    root = str(tmp_path)
    config = make_workspace(root, mlp_training_type="after", per_class=6)
    cfg_path = os.path.join(root, "run.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(config, f)
    argv = ["--config", cfg_path, "--id", "run", "--output_path", root,
            "--device", "cpu"]
    first = ttrain.main(argv)
    run = os.path.join(root, "outputs", "run")
    ckpt = os.path.join(run, "checkpoints")
    assert os.path.exists(os.path.join(run, "config.yaml"))
    assert sorted(os.listdir(ckpt)) == ["classifiers.npz",
                                        "model_00000002.ckpt",
                                        "optimizer.ckpt"]
    with open(os.path.join(run, "logs", "metrics.jsonl")) as f:
        tags = [yaml.safe_load(line)["tag"] for line in f]
    assert tags.count("perf/meshes_per_sec") == 2
    assert tags.count("train/tot") == 2 and tags.count("validation/tot") == 2
    hist = first["history"]
    assert [h["epoch"] for h in hist] == [1, 2]
    assert all(np.isfinite(h["train"]["tot"]) for h in hist)

    second = ttrain.main(argv + ["--resume", "--epochs", "3"])
    assert second["start_epoch"] == 2
    assert [h["epoch"] for h in second["history"]] == [3]
    assert "model_00000003.ckpt" in os.listdir(ckpt)

    fresh = ModelManager(config, config["data"]["precomputed_path"],
                         device="cpu")
    assert fresh.resume(ckpt) == 3
    mgr = second["manager"]
    for name, p in mgr.model.state_dict().items():
        assert torch.equal(p, fresh.model.state_dict()[name]), name
    params = dict(mgr.model.named_parameters())
    fresh_params = dict(fresh.model.named_parameters())
    for name, p in params.items():
        st, st2 = mgr.optimizer.state[p], fresh.optimizer.state[
            fresh_params[name]]
        assert float(st["step"]) == float(st2["step"]) > 0
        assert torch.equal(st["exp_avg"], st2["exp_avg"])
        assert torch.equal(st["exp_avg_sq"], st2["exp_avg_sq"])
    stored = named_from_tree(
        __import__("craniofacialsd_vae_tpu_torch.training.checkpoint",
                   fromlist=["read_checkpoint"]).read_checkpoint(
            os.path.join(ckpt, "model_00000003.ckpt"))["params"])
    assert set(stored) == set(params)

"""The diagnosis path of the port against the JAX package's, on the CPU.

A run dir trained and written by the JAX package (the ``served_run``
workspace of ``test_serving.py``: the 3-region octasphere of subdivision
2, widths 8/16, latent 6, batch 2, an MLP head fitted after training) is
served by both packages' ``DiagnosisService.from_run_dir``; a run dir
written by the port's ``train.main`` is served by both too. Held against
JAX's service: ``diagnose`` (every head, and the posterior sampling with
JAX's draws injected), ``saliency``, ``plan``, ``fit`` at 20 iterations
and the HTTP twin.

Tolerances: latents and decoded meshes rtol 1e-5 (fp32 sums in another
order by XLA and PyTorch); posteriors 1e-6 absolute, Mahalanobis and the
margin rtol 1e-4 (float64 numpy heads over those latents); saliency
within 1e-4 of its largest entry; the fit's losses rtol 1e-3 and its
latent 1e-3 absolute after 20 Adam steps (optax's and torch's Adam round
differently), with the same best restart."""

import io
import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
import yaml

import jax
from craniofacialsd_vae_tpu.serving import DiagnosisService as JService
from craniofacialsd_vae_tpu_torch import serve as tserve
from craniofacialsd_vae_tpu_torch import train as ttrain
from craniofacialsd_vae_tpu_torch.analysis import fitting as tfitting
from craniofacialsd_vae_tpu_torch.analysis.tester import \
    TEMPLATE_LANDMARKS_IDX
from craniofacialsd_vae_tpu_torch.analysis.uncertainty import \
    summarize_uncertainty
from craniofacialsd_vae_tpu_torch.serving import DiagnosisService

MAX_BATCH = 4


def _workspace(root):
    """``test_serving.py``'s workspace under ``root``: a coloured
    octasphere template, 8 OBJ scans of each of classes a/c/n, and its
    config."""
    from craniofacialsd_vae_tpu.geometry import write_obj, write_ply
    from craniofacialsd_vae_tpu.geometry.synthetic import synthetic_template

    tpl = synthetic_template(subdivisions=2, n_regions=3)
    tpl_path = os.path.join(root, "template.ply")
    write_ply(tpl_path, tpl.pos, tpl.face, tpl.colors)
    mesh_dir = os.path.join(root, "meshes")
    os.makedirs(mesh_dir)
    rng = np.random.default_rng(7)
    for c in ["a", "c", "n"]:
        for i in range(8):
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
            "epochs": 1, "batch_size": 2, "lr": 1e-3, "weight_decay": 0,
            "laplacian_weight": 0.1, "kl_weight": 1e-4,
            "latent_consistency_weight": 0.5,
            "latent_consistency_eta1": 0.5, "latent_consistency_eta2": 0.5,
        },
        "model": {
            "sampling": {"type": "basic", "sampling_factors": [2, 2]},
            "spirals": {"length": [5, 5], "dilation": [1, 1]},
            "in_channels": 3, "out_channels": [8, 16],
            "latent_size": 6, "pre_z_sigmoid": False,
        },
        "classifier": {
            "main_model_type": "qda", "mlp_training_type": "after",
            "mlp_hidden_features": [8], "mlp_lr": 1e-3, "mlp_epochs": 2,
        },
        "logging_frequency": {"tb_renderings": 100, "save_weights": 1},
    }


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A run dir written by the JAX package: one epoch, the checkpoint,
    the zoo, the config snapshot; raw scans to serve."""
    from craniofacialsd_vae_tpu.data.dataset import (BatchIterator,
                                                     build_datasets)
    from craniofacialsd_vae_tpu.manager import ModelManager

    root = str(tmp_path_factory.mktemp("jax_run"))
    config = _workspace(root)
    manager = ModelManager(config, config["data"]["precomputed_path"])
    train, val, _, norm, weights = build_datasets(config, manager.template)
    manager.set_class_conversions_and_weights(weights)
    manager.run_epoch(BatchIterator(train, 2, shuffle=True), train=True)
    run_dir = os.path.join(root, "outputs", "served")
    ckpt = os.path.join(run_dir, "checkpoints")
    os.makedirs(ckpt)
    manager.save_weights(ckpt, epoch=0)
    manager.train_and_validate_classifiers(
        BatchIterator(train, 2, shuffle=False),
        BatchIterator(val, 2, shuffle=False, drop_last=False),
        checkpoint_dir=ckpt)
    with open(os.path.join(run_dir, "config.yaml"), "w") as f:
        yaml.safe_dump(config, f)
    raw = np.asarray(train.x[:5]) * norm["std"] + norm["mean"]
    n = manager.template.num_vertices
    return {"run_dir": run_dir, "raw": raw.astype(np.float32), "n": n,
            "norm": norm, "config": config,
            "landmarks": list(range(0, n, max(n // 6, 1)))[:6]}


@pytest.fixture(scope="module")
def services(jax_run):
    j = JService.from_run_dir(jax_run["run_dir"], max_batch=MAX_BATCH)
    t = DiagnosisService.from_run_dir(jax_run["run_dir"],
                                      max_batch=MAX_BATCH, device="cpu")
    return j, t


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _same_reports(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a["label"] == b["label"]
        assert set(a["posteriors"]) == set(b["posteriors"])
        for k, v in b["posteriors"].items():
            assert a["posteriors"][k] == pytest.approx(v, abs=1e-6)
        assert a["mahalanobis_to_healthy"] == pytest.approx(
            b["mahalanobis_to_healthy"], rel=1e-4)
        if "latent" in b:
            assert _rel(a["latent"], b["latent"]) <= 1e-5


# ---------------------------------------------------------------- diagnose
@pytest.mark.parametrize("model", ["qda", "lda", "svm", "mlp"])
def test_diagnose_matches_jax(jax_run, services, model):
    js, ts = services
    raw = jax_run["raw"]
    assert _rel(ts.encode(raw), js.encode(raw)) <= 1e-5
    _same_reports(ts.diagnose(raw[:3], model=model),
                  js.diagnose(raw[:3], model=model))
    one = ts.diagnose(raw[0], model=model)
    assert isinstance(one, dict) and one["label"] == \
        js.diagnose(raw[0], model=model)["label"]


def test_posteriors_label_by_fitted_classes(services, jax_run):
    _, ts = services
    mgr = ts.manager
    rep = ts.diagnose(jax_run["raw"][0])
    fitted = {mgr.idx2class(int(c)) for c in mgr.classifiers.qda.classes}
    assert set(rep["posteriors"]) == fitted


def _jax_eps(seed, rows, k, zdim):
    """JAX's draws: row i of a chunk from ``fold_in(PRNGKey(seed), i)``."""
    key = jax.random.PRNGKey(seed)
    return np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(key, i), (k, zdim))) for i in range(rows)])


@pytest.mark.parametrize("n_samples", [8, 5])
def test_uncertainty_with_jax_draws_matches_jax(jax_run, services,
                                                n_samples):
    """JAX's noise injected: the same votes, posterior statistics and
    entropy (5 samples summarize the first 5 of an 8-sample program)."""
    js, ts = services
    raw = jax_run["raw"][:3]
    want = js.diagnose(raw, n_samples=n_samples, seed=1)
    k = 1 << (n_samples - 1).bit_length()
    got = ts.diagnose(raw, n_samples=n_samples,
                      eps=_jax_eps(1, 3, k, 6))
    _same_reports(got, want)
    for a, b in zip(got, want):
        ua, ub = a["uncertainty"], b["uncertainty"]
        assert ua["label"] == ub["label"]
        assert ua["sample_votes"] == ub["sample_votes"]
        assert ua["label_agreement"] == ub["label_agreement"]
        assert ua["n_samples"] == ub["n_samples"] == n_samples
        for f in ("posterior_mean", "posterior_std"):
            for c, v in ub[f].items():
                assert ua[f][c] == pytest.approx(v, abs=1e-5)
        assert ua["predictive_entropy_nats"] == pytest.approx(
            ub["predictive_entropy_nats"], rel=1e-4, abs=1e-6)


def test_uncertainty_program_matches_jax_program(jax_run, services):
    """The sampling program itself, on JAX's draws: mu, the log-posteriors
    of mu and of every sample, the argmax and the samples."""
    from craniofacialsd_vae_tpu.analysis.uncertainty import \
        make_uncertainty_fn as jmake
    from craniofacialsd_vae_tpu_torch.analysis.uncertainty import \
        make_uncertainty_fn as tmake

    js, ts = services
    raw = jax_run["raw"][:2]
    jfn = jax.jit(jmake(js.manager, js.normalization,
                        js.manager.classifiers.qda, 16))
    want = [np.asarray(r) for r in jfn(js.manager.state.params, raw,
                                       jax.random.PRNGKey(0))]
    tfn = tmake(ts.manager, ts.normalization, ts.manager.classifiers.qda, 16)
    with torch.no_grad():
        got = [r.numpy() for r in tfn(torch.from_numpy(raw),
                                      eps=_jax_eps(0, 2, 16, 6))]
    for name, g, w in zip(("mu", "lp_mu", "sample_lp", "sample_pred", "z"),
                          got, want):
        if name == "sample_pred":
            np.testing.assert_array_equal(g, w)
        else:
            assert _rel(g, w) <= 1e-5, name


def test_uncertainty_draws_do_not_depend_on_the_bucket(jax_run, services):
    """One scan alone (bucket 1) and as the first of three (padded into
    bucket 4) draws the same noise: the same summary. Same seed, same
    answer; another seed, other draws; the sample count is bounded and
    programs exist only at powers of two."""
    _, ts = services
    raw = jax_run["raw"]
    one = ts.diagnose(raw[0], n_samples=8, seed=3)["uncertainty"]
    three = ts.diagnose(raw[:3], n_samples=8, seed=3)
    first = three[0]["uncertainty"]
    assert one["sample_votes"] == first["sample_votes"]
    for f in ("posterior_mean", "posterior_std"):
        for c, v in first[f].items():
            assert one[f][c] == pytest.approx(v, abs=1e-6)
    again = ts.diagnose(raw[:3], n_samples=8, seed=3)
    assert [r["uncertainty"] for r in again] == \
        [r["uncertainty"] for r in three]
    other = ts.diagnose(raw[:3], n_samples=8, seed=4)
    assert any(o["uncertainty"]["posterior_mean"] !=
               r["uncertainty"]["posterior_mean"]
               for o, r in zip(other, three))
    with pytest.raises(ValueError, match="n_samples"):
        ts.diagnose(raw[:1],
                    n_samples=DiagnosisService.MAX_UNCERTAINTY_SAMPLES + 1)
    assert all(k & (k - 1) == 0 for k in ts._uncertainty)


def test_summarize_uncertainty_math():
    qda_classes = np.array([0, 2, 3])
    idx2class = {0: "a", 2: "c", 3: "n"}
    lp_mu = np.array([[0.0, 5.0, -1.0], [3.0, 0.0, 2.9]])
    big = 50.0
    sample_lp = np.stack([
        np.tile([0.0, big, 0.0], (4, 1)),
        np.array([[big, 0, 0], [0, 0, big], [big, 0, 0], [0, 0, big]]),
    ])
    pred = np.argmax(sample_lp, axis=-1).astype(np.int32)
    reps = summarize_uncertainty(lp_mu, sample_lp, pred, qda_classes,
                                 idx2class)
    assert reps[0]["label"] == "c" and reps[1]["label"] == "a"
    assert reps[0]["label_agreement"] == 1.0
    assert reps[0]["sample_votes"] == {"a": 0, "c": 4, "n": 0}
    assert reps[1]["label_agreement"] == 0.5
    assert reps[1]["predictive_entropy_nats"] == pytest.approx(
        np.log(2), rel=1e-3)


# ---------------------------------------------------------------- saliency
def test_saliency_matches_jax(jax_run, services):
    """The raw-space gradient of the QDA margin through the encoder's
    input gradients, against JAX's service (``jax.grad``), and the same
    maps whether a scan is served alone or padded into a bucket."""
    js, ts = services
    raw = jax_run["raw"][:3]
    want = js.saliency(raw)
    got = ts.saliency(raw)
    for a, b in zip(got, want):
        assert a["label"] == b["label"]
        assert a["saliency_label"] == b["saliency_label"]
        assert a["saliency_reference_class"] == \
            b["saliency_reference_class"]
        assert a["margin_nats"] == pytest.approx(b["margin_nats"], rel=1e-4)
        assert _rel(a["vertex_saliency_nats_per_mm"],
                    b["vertex_saliency_nats_per_mm"]) <= 1e-4
        assert [r["region"] for r in a["regions"]] == \
            [r["region"] for r in b["regions"]]
        np.testing.assert_allclose([r["share"] for r in a["regions"]],
                                   [r["share"] for r in b["regions"]],
                                   rtol=1e-4)
    one = ts.saliency(raw[0])
    assert _rel(one["vertex_saliency_nats_per_mm"],
                got[0]["vertex_saliency_nats_per_mm"]) <= 1e-5
    lean = ts.saliency(raw[:1], include_vertex_saliency=False)[0]
    assert "vertex_saliency_nats_per_mm" not in lean
    # no weight gradient was formed, and the weights stay trainable
    assert all(p.grad is None and p.requires_grad
               for p in ts.manager.model.parameters())


# -------------------------------------------------------------------- plan
def test_plan_matches_jax(jax_run, services):
    js, ts = services
    raw = jax_run["raw"]
    z_p = js.encode(raw[0])
    want = js.plan(latent=z_p, include_paths=True)
    got = ts.plan(latent=z_p, include_paths=True)
    for k in ("z_3std", "z_2std", "z_1std", "z_mean_target",
              "all_attributes"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    assert got["procedure_distances"] == want["procedure_distances"]
    assert set(got["procedures"]) == set(want["procedures"])
    for k in ("3std", "2std", "1std", "mean_target"):
        assert _rel(got["target_meshes"][k],
                    want["target_meshes"][k]) <= 1e-5
    assert got["diagnosis"]["label"] == want["diagnosis"]["label"]
    by_verts = ts.plan(vertices=raw[0], decode_key_meshes=False)
    step = np.abs(want["z_mean_target"] - want["z_patient"]).max() / 5000
    np.testing.assert_allclose(by_verts["z_3std"], want["z_3std"],
                               atol=max(5 * step, 1e-3), rtol=1e-2)
    assert "target_meshes" not in by_verts
    with pytest.raises(ValueError, match="exactly one"):
        ts.plan()
    with pytest.raises(ValueError, match="ONE patient"):
        ts.plan(vertices=raw[:2])
    with pytest.raises(ValueError, match="n_p_to_3std"):
        ts.plan(latent=z_p, n_p_to_3std=0)


# --------------------------------------------------------------------- fit
def test_landmarks_are_the_template_set_valid_here(jax_run, services):
    js, ts = services
    n = jax_run["n"]
    assert ts.landmark_idx == [i for i in TEMPLATE_LANDMARKS_IDX if i < n]
    assert ts.landmark_idx == js.landmark_idx


def test_fit_matches_jax(jax_run, services):
    """An unregistered scan (a scaled copy, off the template frame) fitted
    at 20 iterations over 4 restarts by both packages: the same best
    restart, its latent and losses."""
    js, ts = services
    lnd = jax_run["landmarks"]
    js.landmark_idx = ts.landmark_idx = lnd
    scan = jax_run["raw"][0] * 1.1
    want = js.fit(scan, scan[lnd], iterations=20, n_restarts=4)
    got = ts.fit(scan, scan[lnd], iterations=20, n_restarts=4)
    np.testing.assert_allclose(got["aligned_scan"], want["aligned_scan"],
                               rtol=1e-12)
    assert np.abs(got["z"] - want["z"]).max() <= 1e-3
    assert got["chamfer_mm2"] == pytest.approx(want["chamfer_mm2"],
                                               rel=1e-3)
    assert got["landmark_mse_mm2"] == pytest.approx(
        want["landmark_mse_mm2"], rel=1e-3)
    assert _rel(got["vertices"], want["vertices"]) <= 1e-3
    assert got["diagnosis"]["label"] == want["diagnosis"]["label"]
    with pytest.raises(ValueError, match="landmarks must be"):
        ts.fit(scan, scan[lnd][:2], iterations=1, n_restarts=1)
    with pytest.raises(ValueError, match="scan must be"):
        ts.fit(scan[None], scan[lnd], iterations=1, n_restarts=1)


def test_fit_mm2_units(jax_run, services, monkeypatch):
    """The fit's losses are squared distances: they scale with the square
    of the linear mm constant."""
    _, ts = services
    mgr = ts.manager
    lnd = jax_run["landmarks"]
    scan = jax_run["raw"][0]
    vals = {}
    for c in (1.0, 10.0):
        monkeypatch.setattr(mgr, "to_mm_const", c)
        vals[c] = tfitting.fit_latent(mgr, ts.normalization, scan,
                                      scan[lnd], lnd, iterations=2,
                                      n_restarts=2, seed=0)
    assert vals[10.0]["chamfer_mm2"] == pytest.approx(
        100.0 * vals[1.0]["chamfer_mm2"], rel=1e-6)
    assert vals[10.0]["landmark_mse_mm2"] == pytest.approx(
        100.0 * vals[1.0]["landmark_mse_mm2"], rel=1e-6)


def test_fit_run_is_reused_across_scans(jax_run, services, monkeypatch):
    """Scans of other sizes in one chamfer bucket run the fit at one
    shape: the same padded target size, so the loop's launches are the
    same for both."""
    _, ts = services
    mgr = ts.manager
    ts.landmark_idx = jax_run["landmarks"]
    tpl = np.asarray(mgr.template.pos, np.float32)
    lnd = tpl[ts.landmark_idx]
    seen = []
    real = tfitting.nearest_dists_sq_sym

    def spy(x, y):
        seen.append((tuple(x.shape), tuple(y.shape)))
        return real(x, y)

    monkeypatch.setattr(tfitting, "nearest_dists_sq_sym", spy)
    n = len(tpl)
    r1 = ts.fit(tpl[: n - 2] + 0.01, lnd, iterations=2, n_restarts=2)
    r2 = ts.fit(tpl[: n - 6] - 0.02, lnd, iterations=2, n_restarts=2)
    assert len(seen) == 2 * 3 and len(set(seen)) == 1
    q = len(tpl[: n - 2][::4])
    assert seen[0][1] == (1 << (q - 1).bit_length(), 3)
    assert r1["z"].shape == r2["z"].shape


def test_warmup_fit(jax_run, services):
    """warmup_fit runs a fit off the request stats; with no landmark it
    skips."""
    _, ts = services
    saved = ts.landmark_idx
    try:
        ts.landmark_idx = []
        ts.warmup_fit(scan_points=50, iterations=1, n_restarts=1)
        ts.landmark_idx = jax_run["landmarks"]
        before = ts.stats()
        ts.warmup_fit(scan_points=200, iterations=2, n_restarts=2)
        after = ts.stats()
        assert (after["requests"], after["meshes"], after["p50_ms"]) == \
            (before["requests"], before["meshes"], before["p50_ms"])
    finally:
        ts.landmark_idx = saved


# ---------------------------------------------------------------- run dirs
@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """A run dir written by the port's ``train.main`` on the CPU (its
    traversals rendered small: the images are not tested here)."""
    from tests.test_torch_tester import small_tester_renders

    root = str(tmp_path_factory.mktemp("port_run"))
    config = _workspace(root)
    cfg_path = os.path.join(root, "run.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(config, f)
    with small_tester_renders():
        out = ttrain.main(["--config", cfg_path, "--id", "port",
                           "--output_path", root, "--device", "cpu"])
    return out


def test_train_main_fits_the_zoo(port_run):
    ckpt = port_run["checkpoint_dir"]
    assert os.path.exists(os.path.join(ckpt, "classifiers.npz"))
    assert os.path.exists(os.path.join(port_run["output_dir"],
                                       "z_stats.npz"))
    assert set(port_run["classifier_accs"]) == {"mlp", "svm", "lda", "qda"}
    with np.load(os.path.join(port_run["output_dir"], "z_stats.npz")) as z:
        assert set(z) == {"means", "stds", "mins", "maxs"}
        assert z["means"].shape == (6,)


def test_port_run_dir_serves_from_both_packages(port_run):
    """The port's run dir (its msgpack checkpoint and classifiers.npz)
    served by JAX's ``from_run_dir`` and the port's: the same answers."""
    run_dir = port_run["output_dir"]
    js = JService.from_run_dir(run_dir, max_batch=MAX_BATCH)
    ts = DiagnosisService.from_run_dir(run_dir, max_batch=MAX_BATCH,
                                       device="cpu")
    mgr = port_run["manager"]
    rng = np.random.default_rng(2)
    raw = np.asarray(mgr.template.pos, np.float32)[None] + rng.normal(
        scale=0.03, size=(3, mgr.template.num_vertices, 3)).astype(
            np.float32)
    for model in ("qda", "lda", "svm", "mlp"):
        _same_reports(ts.diagnose(raw, model=model),
                      js.diagnose(raw, model=model))


def test_jax_run_dir_serves_without_the_jax_stack(jax_run):
    """In a process where JAX, the JAX package, yaml, flax, msgpack and
    sklearn cannot be imported at all, the port reads the JAX-written
    run dir (config snapshot, msgpack checkpoint, classifiers.npz,
    norm.npz, split cache) and diagnoses."""
    import subprocess
    import sys

    from tests.test_torch_isolation import FORBIDDEN, REPO

    code = (f"import sys; sys.modules.update(dict.fromkeys({FORBIDDEN!r}))\n"
            "import numpy as np\n"
            "from craniofacialsd_vae_tpu_torch.serving import "
            "DiagnosisService\n"
            f"svc = DiagnosisService.from_run_dir({jax_run['run_dir']!r}, "
            "max_batch=4, device='cpu')\n"
            f"x = np.load({jax_run['run_dir'] + '/raw.npy'!r})\n"
            "print([r['label'] for r in svc.diagnose(x)])\n")
    np.save(os.path.join(jax_run["run_dir"], "raw.npy"), jax_run["raw"][:3])
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    js = JService.from_run_dir(jax_run["run_dir"], max_batch=MAX_BATCH)
    assert res.stdout.strip() == str([r["label"] for r in
                                      js.diagnose(jax_run["raw"][:3])])


def test_from_run_dir_refusals(jax_run, tmp_path, monkeypatch):
    """No card: the default device raises. An ensemble dir, or a run with
    no zoo, is a clear error."""
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            DiagnosisService.from_run_dir(jax_run["run_dir"])
    ens = tmp_path / "ens"
    ens.mkdir()
    (ens / "config.yaml").write_text(
        open(os.path.join(jax_run["run_dir"], "config.yaml")).read())
    (ens / "ensemble.json").write_text("{}")
    with pytest.raises(ValueError, match="ensemble"):
        DiagnosisService.from_run_dir(str(ens), device="cpu")
    bare = tmp_path / "bare"
    (bare / "checkpoints").mkdir(parents=True)
    (bare / "config.yaml").write_text(
        open(os.path.join(jax_run["run_dir"], "config.yaml")).read())
    src = os.path.join(jax_run["run_dir"], "checkpoints")
    for name in os.listdir(src):
        if name != "classifiers.npz":
            with open(os.path.join(src, name), "rb") as f:
                (bare / "checkpoints" / name).write_bytes(f.read())
    with pytest.raises(RuntimeError, match="classifier zoo"):
        DiagnosisService.from_run_dir(str(bare), device="cpu")


# -------------------------------------------------------------------- HTTP
class TestHTTP:
    @pytest.fixture(scope="class")
    def server(self, services):
        _, ts = services
        srv = tserve.make_server(ts, "127.0.0.1", 0)
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        yield f"http://127.0.0.1:{srv.server_port}"
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
        assert not thread.is_alive()

    @staticmethod
    def _post(url, body, ctype="application/json"):
        data = body if isinstance(body, bytes) else json.dumps(body).encode()
        req = urllib.request.Request(url, data=data,
                                     headers={"Content-Type": ctype})
        with urllib.request.urlopen(req, timeout=120) as resp:
            return json.loads(resp.read())

    def test_healthz(self, server):
        with urllib.request.urlopen(server + "/healthz", timeout=60) as r:
            out = json.loads(r.read())
        assert out["ok"] and out["buckets"] == [1, 2, 4]
        assert out["device"] == "cpu"

    def test_diagnose_json_and_npy(self, server, services, jax_run):
        js, ts = services
        raw = jax_run["raw"][:2]
        out = self._post(server + "/diagnose", {"vertices": raw.tolist()})
        _same_reports(out["reports"], js.diagnose(raw))
        buf = io.BytesIO()
        np.save(buf, raw)
        enc = self._post(server + "/encode", buf.getvalue(),
                         ctype="application/octet-stream")
        assert _rel(enc["latent"], ts.encode(raw)) <= 1e-6
        unc = self._post(server + "/diagnose", {"vertices": raw.tolist(),
                                                "n_samples": 4, "seed": 3})
        direct = ts.diagnose(raw, n_samples=4, seed=3)
        assert [r["uncertainty"] for r in unc["reports"]] == \
            [r["uncertainty"] for r in direct]

    def test_saliency_fit_plan_decode(self, server, services, jax_run):
        _, ts = services
        raw = jax_run["raw"]
        sal = self._post(server + "/saliency", {
            "vertices": raw[:2].tolist(), "include_vertex_saliency": False})
        assert len(sal["reports"]) == 2
        assert "vertex_saliency_nats_per_mm" not in sal["reports"][0]
        ts.landmark_idx = jax_run["landmarks"]
        scan = raw[0] * 1.1
        fit = self._post(server + "/fit", {
            "vertices": scan.tolist(),
            "landmarks": scan[ts.landmark_idx].tolist(),
            "iterations": 2, "n_restarts": 2})
        assert np.asarray(fit["vertices"]).shape == (jax_run["n"], 3)
        assert "label" in fit["diagnosis"]
        plan = self._post(server + "/plan", {"vertices": raw[0].tolist(),
                                             "n_linspace": 500})
        assert np.asarray(plan["target_meshes"]["1std"]).shape == \
            (jax_run["n"], 3)
        dec = self._post(server + "/decode", {"latent": plan["z_patient"]})
        assert np.asarray(dec["vertices"]).shape == (jax_run["n"], 3)

    def test_errors(self, server):
        with pytest.raises(urllib.error.HTTPError) as e:
            self._post(server + "/encode", b'{"vertices": "nope"}')
        assert e.value.code == 400 and "error" in json.loads(e.value.read())
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(server + "/nope", timeout=60)
        assert e.value.code == 404
        with pytest.raises(urllib.error.HTTPError) as e:
            self._post(server + "/nope", {})
        assert e.value.code == 404

"""The port's evaluation harness against the JAX package's, on the CPU.

The run dir is ``tests/test_torch_diagnosis.py``'s JAX-written one (the
3-region octasphere of subdivision 2, latent 6, one epoch and a fitted
zoo). A JAX ``Tester`` and the port's ``Tester`` each evaluate it into
their own directory, from each package's datasets and iterators (the
entry points are held in ``tests/test_torch_test_entry.py``).

Tolerances are those of the tests each comparison mirrors: reconstruction
errors and diversities rtol 1e-5 (fp32 sums of two libraries); traversal
displacements rtol 1e-4; classifier reports equal (the same predictions);
plan latents rtol 1e-6 on the same patient latent (the shared planning
core); pre/post metrics rtol 1e-5 (Mahalanobis distances of latents that
agree to 1e-5); saliency within 1e-3 of its largest entry; the fit's
chamfer rtol 1e-3 after 3 Adam steps; PNG grids within 1/255.

Renders are held at small sizes (the Tester's 256² grids through the
host's plain sweep take seconds a mesh): ``small_renders`` sets both
packages' Tester to ``RENDER``² pixels."""

import contextlib
import json
import os

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (both packages in one process, JAX on the CPU)
from craniofacialsd_vae_tpu_torch.analysis import tester as tmod
from craniofacialsd_vae_tpu_torch.viz.images import to_uint8, write_png
from tests.test_torch_diagnosis import _jax_eps
from tests.test_torch_diagnosis import jax_run  # noqa: F401  (fixture)

RENDER = 32


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for torch in this module: its host ops are
    tiny, and when several test workers share the cores a spinning
    thread pool slows them many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@contextlib.contextmanager
def small_tester_renders(size: int = RENDER):
    """Both packages' Testers render at ``size``² (the standard suite's
    ``set_renderings_size(256)`` and ``train.main``'s traversals
    included): for host runs that do not test the images themselves."""
    from craniofacialsd_vae_tpu.analysis.tester import Tester as JTester

    with pytest.MonkeyPatch.context() as mp:
        for cls in (JTester, tmod.Tester):
            init = cls.__init__

            def small_init(self, *a, _init=init, **k):
                _init(self, *a, **k)
                self._image_size = size

            mp.setattr(cls, "__init__", small_init)
            mp.setattr(cls, "set_renderings_size", lambda self, s: None)
        yield


@pytest.fixture
def small_renders():
    with small_tester_renders():
        yield


def _jax_side(run_dir, out_dir, lazy=False):
    from craniofacialsd_vae_tpu.analysis.tester import Tester
    from craniofacialsd_vae_tpu.data.dataset import (BatchIterator,
                                                     build_datasets)
    from craniofacialsd_vae_tpu.manager import ModelManager
    from craniofacialsd_vae_tpu.utils import get_config

    config = get_config(os.path.join(run_dir, "config.yaml"))
    mgr = ModelManager(config, config["data"]["precomputed_path"])
    train, _, test, norm, weights = build_datasets(config, mgr.template)
    mgr.set_class_conversions_and_weights(weights)
    mgr.resume(os.path.join(run_dir, "checkpoints"))
    b = config["optimization"]["batch_size"]
    tester = Tester(mgr, norm, BatchIterator(train, b, shuffle=False),
                    BatchIterator(test, b, shuffle=False, drop_last=False),
                    out_dir, config, lazy_stats=lazy)
    return tester, mgr


def _port_side(run_dir, out_dir, lazy=False, config=None):
    from craniofacialsd_vae_tpu_torch.data.dataset import (BatchIterator,
                                                           build_datasets)
    from craniofacialsd_vae_tpu_torch.manager import ModelManager
    from craniofacialsd_vae_tpu_torch.utils import get_config

    config = config or get_config(os.path.join(run_dir, "config.yaml"))
    mgr = ModelManager(config, config["data"]["precomputed_path"],
                       device="cpu")
    train, _, test, norm, weights = build_datasets(config, mgr.template,
                                                   device="cpu")
    mgr.set_class_conversions_and_weights(weights)
    mgr.resume(os.path.join(run_dir, "checkpoints"))
    b = config["optimization"]["batch_size"]
    tester = tmod.Tester(
        mgr, norm, BatchIterator(train, b, shuffle=False),
        BatchIterator(test, b, shuffle=False, drop_last=False), out_dir,
        config, lazy_stats=lazy)
    return tester, mgr


@pytest.fixture(scope="module")
def testers(jax_run, tmp_path_factory):
    root = tmp_path_factory.mktemp("testers")
    jt, _ = _jax_side(jax_run["run_dir"], str(root / "jax"))
    tt, _ = _port_side(jax_run["run_dir"], str(root / "port"))
    for t in (jt, tt):
        t.set_renderings_size(RENDER)
        t.set_rendering_background_color(1.0)
    return jt, tt


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _patient_files(jax_run, root):
    """Three registered scans of the run as OBJ files."""
    from craniofacialsd_vae_tpu_torch.geometry import write_obj

    paths = []
    faces = None
    for i in range(3):
        if faces is None:
            from craniofacialsd_vae_tpu_torch.geometry import read_mesh
            cfg = jax_run["config"]["data"]
            faces = read_mesh(cfg["template_path"]).faces
        p = os.path.join(root, f"scan_{i}.obj")
        write_obj(p, jax_run["raw"][i], faces)
        paths.append(p)
    return paths


# ------------------------------------------------------------ the numbers
def test_latent_stats_and_reconstruction_errors_match_jax(testers):
    jt, tt = testers
    for k in ("means", "stds", "mins", "maxs"):
        assert _rel(tt.latent_stats[k], jt.latent_stats[k]) <= 1e-5, k
    got, want = tt.reconstruction_errors(), jt.reconstruction_errors()
    assert set(got) == set(want) == {"mean", "median", "max", "std"}
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-5), k


def test_diversities_match_jax(testers):
    """Both diversities (the generated pairs at seeds 2i / 2i + 1 from
    numpy, in batches of 100) rtol 1e-5."""
    jt, tt = testers
    assert tt.compute_diversity_train_set() == pytest.approx(
        jt.compute_diversity_train_set(), rel=1e-5)
    assert tt.compute_diversity(n_samples=400) == pytest.approx(
        jt.compute_diversity(n_samples=400), rel=1e-5)
    np.testing.assert_array_equal(tt.random_latent(5, seed=3),
                                  jt.random_latent(5, seed=3))


@pytest.mark.parametrize("is_vae", [True, False])
def test_module_generation_and_diversity_match_jax(testers, is_vae):
    """The module functions the Tester's draws and diversity go through:
    ``random_generation`` draws the same latents as JAX's (a stand-in
    manager whose decode is the identity, both branches), and decodes
    them as JAX's does; ``compute_diversity`` rtol 1e-6."""
    from types import SimpleNamespace

    from craniofacialsd_vae_tpu.analysis import tester as jmod

    jt, tt = testers
    stats = {k: np.asarray(v) for k, v in tt.latent_stats.items()}
    ident = SimpleNamespace(is_vae=is_vae, model_latent_size=6,
                            generate=lambda z: z)
    for seed in (0, 7):
        want = jmod.random_generation(ident, stats, 5, seed, 1.5)
        np.testing.assert_array_equal(
            tmod.random_generation(ident, stats, 5, seed, 1.5), want)
        np.testing.assert_array_equal(
            tmod.random_latent(ident, stats, 5, seed, 1.5), want)
    if is_vae:
        got = tmod.random_generation(tt._manager, None, 4, seed=2)
        want = jmod.random_generation(jt._manager, None, 4, seed=2)
        assert _rel(got, want) <= 1e-5
    rng = np.random.default_rng(int(is_vae))
    a, b = (rng.standard_normal((4, 162, 3)).astype(np.float32)
            for _ in range(2))
    assert tmod.compute_diversity(a, b, 89.11) == pytest.approx(
        jmod.compute_diversity(a, b, 89.11), rel=1e-6)


@pytest.mark.parametrize("use_z_stats", [False, True])
def test_traversal_displacements_match_jax(testers, use_z_stats):
    jt, tt = testers
    want = jt.latent_traversals(use_z_stats=use_z_stats,
                                render_videos=False)
    got = tt.latent_traversals(use_z_stats=use_z_stats,
                               render_videos=False)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-4
    table = tt.figure_data["latent_exploration.svg"]
    assert len(table) == 6 * len(tt._manager.template.feat_and_cont)


def test_midtrain_traversals_transient_for_ae(jax_run, tmp_path):
    """The twin of JAX's test: an AE's mid-training traversal takes
    transient stats — no z_stats.npz, no latents kept on the manager, no
    draw from the train iterator's generator."""
    import copy

    from craniofacialsd_vae_tpu_torch.data.dataset import (BatchIterator,
                                                           build_datasets)
    from craniofacialsd_vae_tpu_torch.manager import ModelManager

    cfg = copy.deepcopy(jax_run["config"])
    cfg["optimization"]["kl_weight"] = 0.0
    mgr = ModelManager(cfg, cfg["data"]["precomputed_path"], device="cpu")
    assert not mgr.is_vae
    train, val, _, norm, weights = build_datasets(cfg, mgr.template,
                                                  device="cpu")
    mgr.set_class_conversions_and_weights(weights)
    it = BatchIterator(train, 2, shuffle=True, seed=7)
    val_it = BatchIterator(val, 2, shuffle=False, drop_last=False)
    out = str(tmp_path / "midtrain")
    tester = tmod.Tester(mgr, norm, it, val_it, out, cfg, lazy_stats=True)
    state_before = copy.deepcopy(it._rng.bit_generator.state)
    tester.latent_traversals(use_z_stats=False, render_videos=False,
                             save_suffix="5")
    assert it._rng.bit_generator.state == state_before
    assert not os.path.exists(os.path.join(out, "z_stats.npz"))
    assert mgr._train_latents is None
    assert tester._latent_stats is None


# ------------------------------------------------------------ classifiers
def test_classifier_files_equal_jax(testers):
    """accuracies.json, classification_report.json and
    classification_report_regions.json equal JAX's (sklearn's reports),
    and the normalised confusion matrices equal sklearn's over labels
    that span the predictions."""
    from sklearn.metrics import confusion_matrix as sk_confusion

    jt, tt = testers
    want = jt.test_classifiers()
    got = tt.test_classifiers()
    assert got == want and set(got) == {"accuracy_mlp", "accuracy_svm",
                                        "accuracy_lda", "accuracy_qda"}
    for name in ("accuracies.json", "classification_report.json",
                 "classification_report_regions.json"):
        with open(os.path.join(tt._out_dir, name)) as f:
            g = json.load(f)
        with open(os.path.join(jt._out_dir, name)) as f:
            w = json.load(f)
        assert g == w, name
    mgr = tt._manager
    ts_z, ts_l = mgr.encode_all(tt._test_iter, False)
    for name, cm in tt.confusion_matrices.items():
        pred = np.asarray(mgr.idx2class(mgr.classifiers.predict(ts_z,
                                                                name)))
        assert set(pred) <= set(tt.confusion_labels)
        np.testing.assert_array_equal(
            cm, sk_confusion(ts_l["y"], pred, labels=tt.confusion_labels,
                             normalize="true"))
        assert f"confmat_{name}.svg" in tt.figure_data
        assert os.path.isfile(os.path.join(tt._out_dir,
                                           f"confmat_{name}.svg"))


def test_region_confusion_matrices_span_unseen_predictions(testers):
    """The twin of ``TestConfusionMatrixLabels``: a region head
    predicting a class absent from the test labels gives a matrix whose
    labels include it (one more row than the truth's classes)."""
    _, tt = testers
    mgr = tt._manager
    zoo = mgr.classifiers
    key, (lo, hi) = next(iter(mgr.latent_regions.items()))
    qda = zoo.region_qdas[key]
    pos = {int(c): i for i, c in enumerate(qda.classes)}
    ts_z = np.zeros((6, mgr.model_latent_size), np.float32)
    for row, c in enumerate(list(pos)[:3] * 2):
        ts_z[row, lo:hi] = qda.means[pos[c]]
    pred = np.asarray(mgr.idx2class(qda.predict(ts_z[:, lo:hi])))
    truth = np.array([pred[0]] * 6)           # one class only
    out = tt.confusion_matrices_per_region(ts_z, truth)
    labels, cm = out["qda"][key]
    assert set(pred) <= set(labels) and len(set(pred)) > 1
    assert cm.shape == (len(labels), len(labels))
    assert np.isfinite(cm).all()
    assert "region_confmats_qda.svg" in tt.figure_data


# --------------------------------------------------------------- planning
def test_plan_matches_the_jax_planner(jax_run, testers, tmp_path):
    """The port Tester's plan of a patient file, against JAX's planner on
    the same patient latent (``test_plan_matches_tester``'s bar): the key
    latents rtol 1e-6, the procedure table equal; the CSV in pandas'
    ``to_csv`` layout; the renders, PLYs and videos written."""
    import pandas as pd

    from craniofacialsd_vae_tpu.analysis.planning import (healthy_gaussian,
                                                          plan_to_healthy)

    jt, tt = testers
    patient = _patient_files(jax_run, str(tmp_path))[0]
    got = tt.interpolate_syndrome_to_normal(patient)
    jm = jt._manager
    norm = jax_run["norm"]
    z_jax = jm.encode((jax_run["raw"][0] - norm["mean"]) / norm["std"])
    assert _rel(got["z_patient"], np.asarray(z_jax)) <= 1e-5
    mean_h, cov_h = healthy_gaussian(jm.classifiers.qda, jm.class2idx("n"))
    want = plan_to_healthy(got["z_patient"], mean_h, cov_h,
                           jm.latent_regions)
    for k in ("z_3std", "z_2std", "z_1std", "z_mean_target",
              "all_attributes"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    assert got["procedure_distances"] == want["procedure_distances"]
    path = os.path.join(tt._out_dir, "interpolations",
                        "scan_0_procedure_distances.csv")
    with open(path) as f:
        text = f.read()
    assert text == pd.DataFrame(got["procedure_distances"]).to_csv()
    out = os.path.join(tt._out_dir, "interpolations",
                       "scan_0_all_attributes")
    for name in ("interpolation.png", "interpolation_errors.png",
                 "interpolation.avi", "0.ply"):
        assert os.path.isfile(os.path.join(out, name)), name


# --------------------------------------------------------------- pre/post
@pytest.fixture
def monobloc_regions(testers, monkeypatch):
    """'monobloc' mapped onto two of the workspace's regions, in both
    packages' procedure tables."""
    from craniofacialsd_vae_tpu.geometry import template as jtpl
    from craniofacialsd_vae_tpu_torch.geometry import template as ttpl

    keys = list(testers[1]._manager.latent_regions)[:2]
    for table in (jtpl.PROCEDURES2ATTRIBUTES, ttpl.PROCEDURES2ATTRIBUTES):
        monkeypatch.setitem(table, "monobloc", keys)
    return keys


def _same_prepost(got, want):
    assert got["pre_class"] == want["pre_class"]
    assert got["post_class"] == want["post_class"]
    for k in ("global_metric", "global_metric_l2",
              "global_metric_directional", "procedure_metric"):
        assert got[k] == pytest.approx(want[k], rel=1e-5, abs=1e-7), k
    assert set(got["region_metrics"]) == set(want["region_metrics"])
    for key, m in want["region_metrics"].items():
        for k, v in m.items():
            assert got["region_metrics"][key][k] == pytest.approx(
                v, rel=1e-5, abs=1e-7), (key, k)


@pytest.mark.parametrize("covariance", ["stored", "rebuilt"])
def test_pre_post_metrics_match_jax(jax_run, testers, monobloc_regions,
                                    tmp_path, monkeypatch, covariance):
    """Every pre/post metric, weighted by each region QDA's accuracy from
    ``classification_report_regions.json``; ``rebuilt``: heads without a
    stored covariance (a ``store_covariance=False`` import), rebuilt from
    their factors."""
    jt, tt = testers
    for t in (jt, tt):
        if not os.path.exists(os.path.join(
                t._out_dir, "classification_report_regions.json")):
            t.test_classifiers()
    if covariance == "rebuilt":
        for zoo in (jt._manager.classifiers, tt._manager.classifiers):
            for head in [zoo.qda, *zoo.region_qdas.values()]:
                monkeypatch.setattr(head, "covs", None)
    pre, post, _ = _patient_files(jax_run, str(tmp_path))
    got = tt.evaluate_pre_post_pair(pre, post, "p1")
    want = jt.evaluate_pre_post_pair(pre, post, "p1")
    assert set(got["region_metrics"]) == set(monobloc_regions)
    _same_prepost(got, want)
    tt.compute_and_save_postop_mesh_colourmap(pre, post)
    jt.compute_and_save_postop_mesh_colourmap(pre, post)
    with open(os.path.join(tt._out_dir, "postop_displacement.ply"),
              "rb") as f, open(os.path.join(
                  jt._out_dir, "postop_displacement.ply"), "rb") as g:
        assert f.read() == g.read()


def test_pre_post_batch_csv_matches_jax(jax_run, testers, monobloc_regions,
                                        tmp_path):
    """The batch driver over a CSV pair table: the port's
    ``<table>_with_results.csv``, parsed, against JAX's; an .xlsx table
    raises."""
    import pandas as pd

    jt, tt = testers
    paths = _patient_files(jax_run, str(tmp_path))
    names = [os.path.basename(p) for p in paths]
    table = tmp_path / "pairs.csv"
    pd.DataFrame({"PID": [1, 2], "Pre name": names[:2],
                  "Post name": names[1:3],
                  "Surgery regions": ["monobloc", "monobloc"],
                  "Procedure": ["monobloc", "le_fort_III"],
                  "Syndrome": ["Apert", "Crouzon"]}).to_csv(table,
                                                            index=False)
    out = tt.evaluate_all_pre_post_pairs_in_excel(str(tmp_path), str(table))
    jt.evaluate_all_pre_post_pairs_in_excel(str(tmp_path), str(table))
    got = pd.read_csv(os.path.join(tt._out_dir, "pre_post_eval_plots",
                                   "pairs_with_results.csv"))
    want = pd.read_csv(os.path.join(jt._out_dir, "pre_post_eval_plots",
                                    "pairs_with_results.csv"))
    assert list(got.columns) == list(want.columns)
    for col in want.columns:
        if want[col].dtype.kind == "f":
            np.testing.assert_allclose(got[col], want[col], rtol=1e-5,
                                       atol=1e-7, err_msg=col)
        else:
            assert list(got[col]) == list(want[col]), col
    assert len(out["region_metrics"]) == 2
    assert "pre_post_eval_plots/region_metrics_with_angles_apert.svg" \
        in tt.figure_data
    with pytest.raises(ValueError, match="CSV"):
        tt.evaluate_all_pre_post_pairs_in_excel(str(tmp_path),
                                                str(tmp_path / "p.xlsx"))


# ------------------------------------------------- saliency, uncertainty
def test_saliency_maps_match_jax(testers):
    """Labels, reference classes and margins, and each region's share of
    the saliency within 1e-3 of the largest; the PLYs, the PNG grid and
    the report written."""
    jt, tt = testers
    want = jt.saliency_maps(n_meshes=2)       # the whole test split
    got = tt.saliency_maps(n_meshes=2)
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert a["label"] == b["label"]
        assert a["reference_class"] == b["reference_class"]
        assert a["margin_nats"] == pytest.approx(b["margin_nats"],
                                                 rel=1e-4)
        sa = {r["region"]: r for r in a["regions"]}
        top = max(r["mean_nats_per_mm"] for r in b["regions"])
        for r in b["regions"]:
            assert abs(sa[r["region"]]["share"] - r["share"]) <= 1e-3
            assert abs(sa[r["region"]]["mean_nats_per_mm"]
                       - r["mean_nats_per_mm"]) <= 1e-3 * top
    out = os.path.join(tt._out_dir, "saliency")
    for name in ("0_saliency.ply", "saliency_maps.png", "report.json"):
        assert os.path.isfile(os.path.join(out, name)), name


def test_uncertainty_with_jax_draws_matches_jax(testers):
    """JAX's draws injected (``fold_in(PRNGKey(seed), i)`` per mesh): the
    same votes and agreement, posterior statistics within 1e-5."""
    jt, tt = testers
    want = jt.diagnosis_uncertainty(n_meshes=2, n_samples=8, seed=2)
    got = tt.diagnosis_uncertainty(n_meshes=2, n_samples=8, seed=2,
                                   eps=_jax_eps(2, 2, 8, 6))
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        for k in ("label", "sample_votes", "label_agreement", "n_samples",
                  "mesh", "flagged"):
            assert a[k] == b[k], k
        for f in ("posterior_mean", "posterior_std"):
            for c, v in b[f].items():
                assert a[f][c] == pytest.approx(v, abs=1e-5)
        assert a["predictive_entropy_nats"] == pytest.approx(
            b["predictive_entropy_nats"], rel=1e-4, abs=1e-6)
    with open(os.path.join(tt._out_dir, "uncertainty", "report.json")) as f:
        assert len(json.load(f)) == 2


# -------------------------------------------------------------------- fit
def test_fit_mesh_artifacts(jax_run, testers, tmp_path):
    """The twin of JAX's ``test_fit_mesh_artifacts`` (3 iterations, the
    fitted mesh, the aligned scan and the scalars written; Procrustes
    undoes a 1.1 scale), and the fit against JAX's: the same best restart
    and chamfer rtol 1e-3."""
    from craniofacialsd_vae_tpu_torch.geometry import read_mesh, write_obj

    jt, tt = testers
    mgr = tt._manager
    n = mgr.template.num_vertices
    idx = list(range(0, n, max(n // 6, 1)))[:6]
    jt.template_landmarks_idx = tt.template_landmarks_idx = idx
    scan_path = str(tmp_path / "scan.obj")
    write_obj(scan_path, mgr.template.pos * 1.1, mgr.template.face)
    landmarks = mgr.template.pos[idx] * 1.1
    got = tt.fit_mesh(scan_path, landmarks, iterations=3, n_restarts=2,
                      save_artifacts=True)
    fit_path, aligned_path = got["artifacts"]
    out = os.path.join(tt._out_dir, "fit")
    assert os.path.exists(os.path.join(out, "scan_fit.json"))
    assert read_mesh(fit_path).vertices.shape == (n, 3)
    aligned = read_mesh(aligned_path).vertices
    assert aligned.shape == (n, 3)
    assert np.abs(aligned - mgr.template.pos).max() < 1e-3
    want = jt.fit_mesh(scan_path, landmarks, iterations=3, n_restarts=2)
    assert got["chamfer_mm2"] == pytest.approx(want["chamfer_mm2"],
                                               rel=1e-3)
    assert got["pred_class"] == want["pred_class"]
    assert got["region_pred_classes"] == want["region_pred_classes"]


# ----------------------------------------------------------------- images
def test_generation_png_matches_jax(testers):
    """``random_generation.png`` decoded with PIL within 1/255 of JAX's
    (the same numpy draws, both grids truncated to 8 bits), and 16 PLYs."""
    from PIL import Image

    jt, tt = testers
    jt.random_generation_and_rendering(n_samples=8)
    grid = tt.random_generation_and_rendering(n_samples=8)
    tt.random_generation_and_save(n_samples=4)
    got = np.asarray(Image.open(os.path.join(tt._out_dir,
                                             "random_generation.png")))
    want = np.asarray(Image.open(os.path.join(jt._out_dir,
                                              "random_generation.png")))
    assert got.shape == want.shape == to_uint8(grid).shape
    np.testing.assert_array_equal(got, to_uint8(grid))
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert sorted(os.listdir(os.path.join(tt._out_dir, "random_meshes"))) \
        == [f"{i}.ply" for i in range(4)]


def test_write_png_round_trips_through_pil(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(0)
    img = rng.uniform(-0.1, 1.1, size=(7, 5, 3)).astype(np.float32)
    path = write_png(str(tmp_path / "a.png"), img)
    back = np.asarray(Image.open(path))
    np.testing.assert_array_equal(
        back, (np.clip(img, 0, 1) * 255).astype(np.uint8))
    with pytest.raises(ValueError):
        write_png(str(tmp_path / "b.png"), img[..., :2])


def test_save_mean_mesh_matches_jax(jax_run, tmp_path):
    from craniofacialsd_vae_tpu.data.dataset import save_mean_mesh as jsave
    from craniofacialsd_vae_tpu_torch.data.dataset import save_mean_mesh
    from craniofacialsd_vae_tpu_torch.geometry import load_template

    tpl = load_template(jax_run["config"]["data"]["template_path"])
    save_mean_mesh(jax_run["norm"], tpl, str(tmp_path / "t.ply"))
    jsave(jax_run["norm"], tpl, str(tmp_path / "j.ply"))
    assert (tmp_path / "t.ply").read_bytes() == \
        (tmp_path / "j.ply").read_bytes()

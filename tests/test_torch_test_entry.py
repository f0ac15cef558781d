"""The port's evaluation entry points on the CPU: ``python -m
craniofacialsd_vae_tpu_torch.test`` runs every experiment of the root
``test.py`` on a run dir written by the JAX package
(``tests/test_torch_diagnosis.py``'s) and on one written by the port's
manager, ``standard``'s ``eval_metrics.json`` within rtol 1e-5 of the
root ``test.py``'s on the same run; the entry points default to the card;
``train.main`` runs the latent traversals at each checkpoint and still
writes the same checkpoints, bit for bit, as without them.

The Testers render at 32² (``small_tester_renders``); the JAX entry's
figures (seaborn and matplotlib, which ``eval_metrics.json`` does not
read) are not drawn in the comparison of the standard suite."""

import csv
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch
import yaml

import jax
from craniofacialsd_vae_tpu_torch import batch_diagnose as tbatch
from craniofacialsd_vae_tpu_torch import test as ttest
from craniofacialsd_vae_tpu_torch import train as ttrain
from craniofacialsd_vae_tpu_torch.analysis import tester as tmod
from tests.test_torch_diagnosis import _workspace
from tests.test_torch_diagnosis import jax_run  # noqa: F401  (fixture)
from tests.test_torch_tester import _patient_files
from tests.test_torch_tester import one_torch_thread  # noqa: F401
from tests.test_torch_tester import small_renders  # noqa: F401 (fixture)


# ------------------------------------------------------------ entry point
@pytest.fixture(scope="module")
def port_run(jax_run, tmp_path_factory):
    """A run dir written by the port's manager (one epoch, checkpoint,
    zoo, config snapshot) beside a copy of the JAX run dir that shares
    its precomputed dir."""
    from craniofacialsd_vae_tpu_torch.data.dataset import (BatchIterator,
                                                           build_datasets)
    from craniofacialsd_vae_tpu_torch.manager import ModelManager

    root = str(tmp_path_factory.mktemp("entry"))
    config = dict(jax_run["config"])
    mgr = ModelManager(config, config["data"]["precomputed_path"],
                       device="cpu")
    train, val, _, _, weights = build_datasets(config, mgr.template,
                                               device="cpu")
    mgr.set_class_conversions_and_weights(weights)
    mgr.run_epoch(BatchIterator(train, 2, shuffle=True), train=True)
    run = os.path.join(root, "outputs", "port")
    ckpt = os.path.join(run, "checkpoints")
    os.makedirs(ckpt)
    mgr.save_weights(ckpt, epoch=0)
    mgr.train_and_validate_classifiers(
        BatchIterator(train, 2, shuffle=False),
        BatchIterator(val, 2, shuffle=False, drop_last=False),
        checkpoint_dir=ckpt)
    with open(os.path.join(run, "config.yaml"), "w") as f:
        yaml.safe_dump(config, f)
    shutil.copytree(jax_run["run_dir"], os.path.join(root, "outputs", "jax"))
    return root


def _argv(root, run, experiment, *extra):
    return ["--id", run, "--output_path", root, "--device", "cpu",
            "--experiment", experiment, *extra]


@pytest.mark.parametrize("run", ["jax", "port"])
def test_standard_suite_matches_the_jax_entry(port_run, small_renders, run,
                                              monkeypatch):
    """``test.main --experiment standard`` on a run dir of each package:
    ``eval_metrics.json`` within rtol 1e-5 of the root ``test.py``'s on
    the same run, and every JSON, PNG and PLY artifact of the suite."""
    import test as jtest
    from craniofacialsd_vae_tpu.analysis.tester import Tester as JTester

    # the JAX entry's figures: not drawn (its traversal plots skip
    # without seaborn)
    for name in ("plot_embeddings", "_plot_confusion_matrix",
                 "confusion_matrices_per_region"):
        monkeypatch.setattr(JTester, name, lambda *a, **k: None)
    monkeypatch.setitem(sys.modules, "seaborn", None)
    rd = os.path.join(port_run, "outputs", run)
    for name in ("eval_metrics.json", "z_stats.npz"):
        if os.path.exists(os.path.join(rd, name)):
            os.remove(os.path.join(rd, name))
    monkeypatch.setattr("sys.argv", ["test.py", "--id", run,
                                     "--output_path", port_run,
                                     "--platform", "cpu"])
    jtest.main()
    with open(os.path.join(rd, "eval_metrics.json")) as f:
        want = json.load(f)
    os.remove(os.path.join(rd, "z_stats.npz"))
    out = ttest.main(_argv(port_run, run, "standard"))
    with open(os.path.join(rd, "eval_metrics.json")) as f:
        got = json.load(f)
    assert got.keys() == want.keys()
    for k, v in want["recon_errors"].items():
        assert got["recon_errors"][k] == pytest.approx(v, rel=1e-5,
                                                       nan_ok=True), k
    for k in ("train_set_diversity", "diversity"):
        assert got[k] == pytest.approx(want[k], rel=1e-5), k
    for name in ("accuracies.json", "classification_report.json",
                 "classification_report_regions.json",
                 "random_generation.png", "latent_exploration.avi",
                 "latent_exploration_tiled.png",
                 "latent_exploration_tiled.avi",
                 "lda_emb_distributions.npz",
                 os.path.join("random_meshes", "15.ply")):
        assert os.path.isfile(os.path.join(rd, name)), name
    assert "lda_emb_distributions.svg" in out["tester"].figure_data


EXPERIMENTS = [e for e in ttest.EXPERIMENTS if e != "standard"]


@pytest.mark.parametrize("run", ["jax", "port"])
@pytest.mark.parametrize("experiment", EXPERIMENTS)
def test_each_experiment_runs_end_to_end(jax_run, port_run, small_renders,
                                         tmp_path, monkeypatch, run,
                                         experiment):
    """Every other experiment of the root ``test.py`` through the port's
    entry point on the host, on a run dir of each package, writing its
    files."""
    rd = os.path.join(port_run, "outputs", run)
    extra = []
    scans = _patient_files(jax_run, str(tmp_path))
    if experiment in ("classify_and_project", "planning", "prepost",
                      "fit"):
        extra += ["--mesh", scans[0]]
    if experiment == "prepost":
        extra += ["--mesh2", scans[1]]
    if experiment == "prepost_batch":
        table = tmp_path / "pairs.csv"
        with open(table, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["PID", "Pre name", "Post name", "Surgery regions"])
            w.writerow(["7", "scan_0.obj", "scan_1.obj", "monobloc"])
        extra += ["--pairs_root", str(tmp_path), "--pairs_excel",
                  str(table)]
    if experiment == "fit":
        # landmark ids of the octasphere (the template's are beyond it)
        idx = jax_run["landmarks"]
        monkeypatch.setattr(tmod, "TEMPLATE_LANDMARKS_IDX", idx)
        lnd = tmp_path / "lnd.json"
        with open(lnd, "w") as f:
            json.dump([dict(zip("xyz", map(float, jax_run["raw"][0][i])))
                       for i in idx], f)
        extra += ["--landmarks", str(lnd)]
    out = ttest.main(_argv(port_run, run, experiment, *extra))
    files = {
        "traversals": ["latent_exploration.avi"],
        "generation": ["random_generation.png", "random_meshes/0.ply"],
        "classifiers": ["accuracies.json", "classification_report.json"],
        "refit_classifiers": ["checkpoints/classifiers.npz"],
        "interpolate": ["interpolate_per_feature.png", "interpolate_all.png",
                        "interpolate_per_variable.avi"],
        "classify_and_project": ["interpolations"],
        "planning": ["interpolations/scan_0_procedure_distances.csv"],
        "prepost": ["postop_displacement.ply"],
        "prepost_batch": ["pre_post_eval_plots/pairs_with_results.csv"],
        "fit": ["fit/scan_0_fit.ply", "fit/scan_0_fit.json"],
        "saliency": ["saliency/report.json", "saliency/saliency_maps.png"],
        "uncertainty": ["uncertainty/report.json"],
    }.get(experiment, [])
    for rel in files:
        assert os.path.exists(os.path.join(rd, rel)), rel
    if experiment == "recon":
        assert np.isfinite(out["result"]["mean"])
    if experiment == "embeddings":
        assert out["result"]["train"].shape[1] == 2


def test_entry_points_default_to_the_card(port_run):
    """Without ``--device`` the entry points take the card, and raise
    where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttest.main(["--id", "port", "--output_path", port_run])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbatch.main(["--run_dir", os.path.join(port_run, "outputs", "port"),
                     "--scans", port_run, "--out", port_run])


# ------------------------------------------------- the mid-training eval
def test_train_main_traversals_leave_the_checkpoints_bit_equal(
        tmp_path, small_renders, monkeypatch):
    """``train.main`` with the traversals at each save (cadence 1, two
    epochs: chunks of one epoch) against the same run with them off: the
    checkpoints bit for bit, the traversal files at each save epoch."""
    from craniofacialsd_vae_tpu_torch.training.checkpoint import \
        read_checkpoint

    root = str(tmp_path)
    os.makedirs(os.path.join(root, "ws"))
    config = _workspace(os.path.join(root, "ws"))
    config["optimization"]["epochs"] = 2
    config["logging_frequency"] = {"tb_renderings": 100, "save_weights": 1}
    cfg = os.path.join(root, "run.yaml")
    with open(cfg, "w") as f:
        yaml.safe_dump(config, f)
    argv = ["--config", cfg, "--output_path", root, "--device", "cpu"]
    with_t = ttrain.main(argv + ["--id", "with"])
    assert len(with_t["traversal_s"]) == 2
    for e in (1, 2):
        for name in (f"latent_exploration{e}.avi",
                     f"latent_exploration_tiled{e}.png",
                     f"latent_exploration_tiled{e}.avi"):
            assert os.path.isfile(os.path.join(with_t["output_dir"], name))
    monkeypatch.setattr(tmod.Tester, "latent_traversals",
                        lambda self, **k: None)
    without = ttrain.main(argv + ["--id", "without"])
    for name in ("model_00000001.ckpt", "model_00000002.ckpt",
                 "optimizer.ckpt"):
        a = read_checkpoint(os.path.join(with_t["checkpoint_dir"], name))
        b = read_checkpoint(os.path.join(without["checkpoint_dir"], name))
        fa, fb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
        assert len(fa) == len(fb)
        for x, y in zip(fa, fb):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert [h["train"] for h in with_t["history"]] == \
        [h["train"] for h in without["history"]]

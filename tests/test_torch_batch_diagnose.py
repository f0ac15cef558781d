"""The port's batch intake (``python -m craniofacialsd_vae_tpu_torch.
batch_diagnose``) against ``tools/batch_diagnose.py`` on the CPU, in
``tests/test_serving.py::test_batch_diagnose_cli``'s case: three
registered scans and one with the wrong vertex count, ``--save_recons``.
The run dir is written by the port's manager (one epoch of
``tests/test_torch_diagnosis.py``'s workspace, the zoo fitted) and served
by both packages. The CSVs agree row for row: labels equal, errors and
posteriors within their rounding (4 and 6 decimals) plus 1e-5 relative,
Mahalanobis rtol 1e-4 (the bars of ``test_torch_diagnosis.py``)."""

import csv
import json
import os

import numpy as np
import pytest
import yaml

from craniofacialsd_vae_tpu_torch import batch_diagnose as tbatch
from craniofacialsd_vae_tpu_torch.geometry import read_mesh, write_obj
from tests.test_torch_diagnosis import _workspace


@pytest.fixture(scope="module")
def intake(tmp_path_factory):
    from craniofacialsd_vae_tpu_torch.data.dataset import (BatchIterator,
                                                           build_datasets)
    from craniofacialsd_vae_tpu_torch.manager import ModelManager

    root = str(tmp_path_factory.mktemp("intake"))
    config = _workspace(root)
    mgr = ModelManager(config, config["data"]["precomputed_path"],
                       device="cpu")
    train, val, _, norm, weights = build_datasets(config, mgr.template,
                                                  device="cpu")
    mgr.set_class_conversions_and_weights(weights)
    mgr.run_epoch(BatchIterator(train, 2, shuffle=True), train=True)
    run_dir = os.path.join(root, "outputs", "port")
    ckpt = os.path.join(run_dir, "checkpoints")
    os.makedirs(ckpt)
    mgr.save_weights(ckpt, epoch=0)
    mgr.train_and_validate_classifiers(
        BatchIterator(train, 2, shuffle=False),
        BatchIterator(val, 2, shuffle=False, drop_last=False),
        checkpoint_dir=ckpt)
    with open(os.path.join(run_dir, "config.yaml"), "w") as f:
        yaml.safe_dump(config, f)
    raw = (np.asarray(train.x[:3]) * norm["std"] + norm["mean"]) \
        .astype(np.float32)
    scans = os.path.join(root, "scans")
    os.makedirs(scans)
    faces = np.asarray(mgr.template.face)
    for i in range(3):
        write_obj(os.path.join(scans, f"patient_{i}.obj"), raw[i], faces)
    write_obj(os.path.join(scans, "unregistered.obj"), raw[0][:50],
              np.array([[0, 1, 2]]))
    return {"root": root, "run_dir": run_dir, "scans": scans, "raw": raw,
            "classes": set(mgr._class2idx_dict)}


def _rows(out_dir):
    with open(os.path.join(out_dir, "diagnoses.csv")) as f:
        reader = csv.DictReader(f)
        return reader.fieldnames, {r["file"]: r for r in reader}


def test_batch_diagnose_matches_the_jax_tool(intake):
    from tools.batch_diagnose import main as jax_main

    port_out = os.path.join(intake["root"], "port_intake")
    jax_out = os.path.join(intake["root"], "jax_intake")
    argv = ["--run_dir", intake["run_dir"], "--scans", intake["scans"],
            "--save_recons"]
    summary = tbatch.main(argv + ["--out", port_out, "--device", "cpu"])
    want_summary = jax_main(argv + ["--out", jax_out, "--platform", "cpu"])

    assert summary["n_diagnosed"] == 3 and summary["n_skipped"] == 1
    assert summary["labels"] == want_summary["labels"]
    assert summary["mean_recon_error_mm"] == pytest.approx(
        want_summary["mean_recon_error_mm"], abs=2e-4)
    with open(os.path.join(port_out, "summary.json")) as f:
        assert json.load(f)["n_scans"] == 4

    fields, got = _rows(port_out)
    want_fields, want = _rows(jax_out)
    assert fields == want_fields and set(got) == set(want)
    assert "unregistered scan" in got["unregistered.obj"]["error"]
    assert got["unregistered.obj"]["label"] == ""
    for name, w in want.items():
        g = got[name]
        assert g["label"] == w["label"]
        if not w["label"]:         # the note names each package's server
            assert "unregistered scan" in g["error"] and \
                "unregistered scan" in w["error"]
            continue
        assert g["error"] == w["error"] == ""
        assert g["label"] in intake["classes"]
        assert float(g["mean_recon_error_mm"]) == pytest.approx(
            float(w["mean_recon_error_mm"]), rel=1e-5, abs=1e-4)
        assert float(g["mahalanobis_to_healthy"]) == pytest.approx(
            float(w["mahalanobis_to_healthy"]), rel=1e-4, abs=1e-4)
        for k in fields:
            if k.startswith("p_"):
                assert float(g[k]) == pytest.approx(float(w[k]), abs=2e-6)
        rec = read_mesh(os.path.join(
            port_out, os.path.splitext(name)[0] + "_recon.obj")).vertices
        jrec = read_mesh(os.path.join(
            jax_out, os.path.splitext(name)[0] + "_recon.obj")).vertices
        assert rec.shape == jrec.shape == intake["raw"][0].shape
        np.testing.assert_allclose(rec, jrec, rtol=1e-5, atol=1e-5)


def test_batch_diagnose_labels_equal_the_service(intake):
    """Each row's label is the service's own single-scan diagnosis."""
    from craniofacialsd_vae_tpu_torch.serving import DiagnosisService

    out = os.path.join(intake["root"], "port_intake_2")
    tbatch.main(["--run_dir", intake["run_dir"], "--scans",
                 intake["scans"], "--out", out, "--device", "cpu",
                 "--max_batch", "2"])
    _, rows = _rows(out)
    svc = DiagnosisService.from_run_dir(intake["run_dir"], max_batch=4,
                                        device="cpu")
    for i in range(3):
        assert rows[f"patient_{i}.obj"]["label"] == \
            svc.diagnose(intake["raw"][i])["label"]
    post = [float(rows["patient_0.obj"][f"p_{c}"])
            for c in sorted(intake["classes"])
            if f"p_{c}" in rows["patient_0.obj"]]
    assert sum(post) == pytest.approx(1.0, abs=1e-4)


def test_batch_diagnose_refuses_bad_arguments(intake, tmp_path):
    with pytest.raises(SystemExit):
        tbatch.main(["--scans", intake["scans"], "--out", str(tmp_path)])
    with pytest.raises(SystemExit):
        tbatch.main(["--run_dir", intake["run_dir"], "--scans",
                     str(tmp_path / "none"), "--out", str(tmp_path)])
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(SystemExit, match="no .ply/.obj"):
        tbatch.main(["--run_dir", intake["run_dir"], "--scans", str(empty),
                     "--out", str(tmp_path), "--device", "cpu"])

"""The port's export (``craniofacialsd_vae_tpu_torch/export.py``,
``export_model.py``) on the CPU, against the JAX package's live programs
and the port's live service, mirroring ``tests/test_serving.py``'s export
tests.

The run dir is written by the JAX package (``tests/test_torch_diagnosis.
py``'s ``jax_run``: the 3-region octasphere of subdivision 2, widths
8/16, latent 6) and exported by the port at buckets 1, 2 and 4 on the
host, where the artifacts run the kernels' plain twins through the
custom ops of ``ops/library.py``.

Tolerances: against JAX, recon and latents rtol 1e-5 (atol 1e-6) and the
per-vertex error atol 1e-4 mm (``tests/test_torch_serving.py``'s: fp32
sums in another order by XLA and PyTorch); against the port's own live
service the answers are bit-equal (the same ops on the same inputs)."""

import json
import os
import shutil

import numpy as np
import pytest
import yaml

from craniofacialsd_vae_tpu.serving import DiagnosisService as JService
from craniofacialsd_vae_tpu_torch import export_model
from craniofacialsd_vae_tpu_torch.export import (OPS_MODULE, export_run_dir,
                                                 load_exported)
from craniofacialsd_vae_tpu_torch.serving import DiagnosisService
from tests.test_torch_diagnosis import MAX_BATCH, jax_run  # noqa: F401

BUCKETS = (1, 2, 4)
RTOL, ATOL, ERR_ATOL_MM = 1e-5, 1e-6, 1e-4


@pytest.fixture(scope="module")
def exported(jax_run, tmp_path_factory):  # noqa: F811
    out = str(tmp_path_factory.mktemp("export") / "artifact")
    manifest = export_run_dir(jax_run["run_dir"], out, buckets=BUCKETS,
                              device="cpu")
    return {"dir": out, "manifest": manifest,
            "model": load_exported(out, device="cpu")}


def _answers(model, raw, z):
    rec = model.reconstruct(raw)
    if "vertices" in rec:                       # a live service's keys
        rec = {"recon": rec["vertices"], "error_mm":
               rec["vertex_errors_mm"], "mu": rec["latent"]}
    return {"mu": model.encode(raw), "decoded": model.decode(z), **rec}


@pytest.mark.parametrize("b", [1, 2, 3, 4, 5])
def test_export_matches_jax_live_programs(jax_run, exported, b):  # noqa: F811
    """Every bucket (3 pads to 4, 5 runs as 4 + 1) against JAX's service
    of the same run dir."""
    raw = jax_run["raw"][:b]
    js = JService.from_run_dir(jax_run["run_dir"], max_batch=MAX_BATCH)
    z = np.random.default_rng(b).normal(size=(b, 6)).astype(np.float32)
    got = _answers(exported["model"], raw, z)
    want = _answers(js, raw, z)
    for key in ("mu", "decoded", "recon"):
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL,
                                   atol=ATOL, err_msg=key)
    np.testing.assert_allclose(got["error_mm"], want["error_mm"], rtol=0,
                               atol=ERR_ATOL_MM)


@pytest.fixture(scope="module")
def port_service(jax_run):  # noqa: F811
    return DiagnosisService.from_run_dir(jax_run["run_dir"],
                                         max_batch=MAX_BATCH, device="cpu")


def test_export_is_bit_equal_to_the_port_service(jax_run,  # noqa: F811
                                                 exported, port_service):
    """The artifact and the port's live service run the same ops on the
    same inputs: bit-equal at every bucket, chunked batches included."""
    for b in (1, 2, 4, 5):
        z = np.random.default_rng(b).normal(size=(b, 6)).astype(np.float32)
        got = _answers(exported["model"], jax_run["raw"][:b], z)
        want = _answers(port_service, jax_run["raw"][:b], z)
        for key, w in want.items():
            assert np.array_equal(got[key], w), (b, key)


def test_export_bucket_pad_trim_and_chunking(jax_run, exported):  # noqa: F811
    """A batch above the largest bucket streams in chunks; every row
    equals its single-mesh answer (padding rows never leak)."""
    model = exported["model"]
    raw = jax_run["raw"]                    # 5 meshes: chunks 4 + 1
    mu = model.encode(raw)
    assert mu.shape == (5, model.latent_size)
    for i in range(raw.shape[0]):
        np.testing.assert_allclose(mu[i], model.encode(raw[i]), rtol=RTOL,
                                   atol=ATOL)
    rec = model.reconstruct(raw[0])
    assert rec["recon"].shape == raw[0].shape
    assert rec["error_mm"].shape == (model.n_vertices,)
    assert rec["mu"].shape == (model.latent_size,)
    assert model.decode(mu[0]).shape == raw[0].shape


def test_export_is_self_contained(jax_run, exported, tmp_path):  # noqa: F811
    """The artifact runs with the run dir gone: copied away, the run dir
    renamed aside, and loaded afresh (no manager, checkpoint or
    precomputed geometry reachable through the run dir)."""
    moved = str(tmp_path / "deployed")
    shutil.copytree(exported["dir"], moved)
    run_dir = jax_run["run_dir"]
    aside = run_dir + ".aside"
    os.rename(run_dir, aside)
    try:
        model = load_exported(moved, device="cpu")
        raw = jax_run["raw"][:3]
        np.testing.assert_array_equal(model.encode(raw),
                                      exported["model"].encode(raw))
        np.testing.assert_array_equal(
            model.reconstruct(raw)["recon"],
            exported["model"].reconstruct(raw)["recon"])
    finally:
        os.rename(aside, run_dir)
    man = exported["manifest"]
    with open(os.path.join(moved, "manifest.json")) as f:
        assert json.load(f) == json.loads(json.dumps(man))
    assert man["format"] == "craniofacialsd-vae-tpu/torch.export"
    assert man["buckets"] == list(BUCKETS)
    assert set(man["programs"]) == {f"{p}_b{b}" for p in (
        "encode", "decode", "reconstruct") for b in BUCKETS}
    assert man["n_vertices"] == model.n_vertices == jax_run["n"]
    assert man["latent_size"] == 6
    assert man["to_mm_constant"] == jax_run["config"]["data"][
        "to_mm_constant"]
    assert man["policy"] == "float32"
    assert man["ops_module"] == OPS_MODULE
    assert man["platforms"] == ["cpu", "cuda"]
    assert man["programs"]["reconstruct_b4"]["out_shapes"] == [
        [4, jax_run["n"], 3], [4, jax_run["n"]], [4, 6]]


def test_export_input_validation(exported, tmp_path):
    model = exported["model"]
    with pytest.raises(FileNotFoundError, match="export directory"):
        load_exported(str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="vertices"):
        model.encode(np.zeros((2, 5, 3), np.float32))
    with pytest.raises(ValueError, match="latent"):
        model.decode(np.zeros((2, 3), np.float32))
    with pytest.raises(ValueError, match="empty"):
        model.encode(np.zeros((0, model.n_vertices, 3), np.float32))
    with pytest.raises(ValueError, match="buckets"):
        export_run_dir(exported["manifest"]["source"], str(tmp_path / "x"),
                       buckets=(0,), device="cpu")


def test_platforms_and_the_default_device(exported, tmp_path,
                                          monkeypatch):
    """Loading on a device the manifest does not list raises; the entry
    points default to the card and raise without one."""
    moved = str(tmp_path / "cuda_only")
    shutil.copytree(exported["dir"], moved)
    path = os.path.join(moved, "manifest.json")
    with open(path) as f:
        man = json.load(f)
    man["platforms"] = ["cuda"]
    with open(path, "w") as f:
        json.dump(man, f)
    with pytest.raises(ValueError, match="runs on"):
        load_exported(moved, device="cpu")
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_exported(exported["dir"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_run_dir(exported["manifest"]["source"], str(tmp_path / "y"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_model.main(["--run_dir", exported["manifest"]["source"],
                           "--out", str(tmp_path / "z")])


def test_export_model_main_verifies(jax_run, tmp_path, capsys):  # noqa: F811
    out = str(tmp_path / "cli")
    manifest = export_model.main([
        "--run_dir", jax_run["run_dir"], "--out", out, "--buckets", "1", "2",
        "--device", "cpu", "--verify"])
    printed = capsys.readouterr().out
    assert "exported 6 programs (" in printed and out in printed
    assert "bucket 2: encode/decode/reconstruct ok" in printed
    assert "verification passed" in printed
    assert manifest["buckets"] == [1, 2]
    model = load_exported(out, device="cpu")
    np.testing.assert_array_equal(model.encode(jax_run["raw"][:2]),
                                  load_exported(out, device="cpu").encode(
                                      jax_run["raw"][:2]))


def test_mixed_run_exported_equals_the_mixed_service(jax_run,  # noqa: F811
                                                     tmp_path):
    """The same checkpoint under ``compute_dtype: mixed`` (bf16
    activations, the final conv matmul-first through K3b's op): the
    artifact equals the port's live mixed service bit for bit."""
    run_dir = str(tmp_path / "mixed_run")
    shutil.copytree(jax_run["run_dir"], run_dir)
    cfg_path = os.path.join(run_dir, "config.yaml")
    with open(cfg_path) as f:
        cfg = yaml.safe_load(f)
    cfg["model"]["compute_dtype"] = "mixed"
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    out = str(tmp_path / "artifact")
    manifest = export_run_dir(run_dir, out, buckets=(1, 4), device="cpu")
    assert manifest["policy"] == "mixed"
    model = load_exported(out, device="cpu")
    svc = DiagnosisService.from_run_dir(run_dir, max_batch=MAX_BATCH,
                                        device="cpu")
    for b in (1, 3, 5):
        z = np.random.default_rng(b).normal(size=(b, 6)).astype(np.float32)
        got = _answers(model, jax_run["raw"][:b], z)
        want = _answers(svc, jax_run["raw"][:b], z)
        for key, w in want.items():
            assert got[key].dtype == np.float32
            assert np.array_equal(got[key], w), (b, key)

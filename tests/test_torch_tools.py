"""The port's twins of ``tools/convert_torch_checkpoint.py`` and
``tools/make_synthetic_dataset.py``, in process on the CPU, against the
JAX package's functions on the same inputs.

- ``convert_torch_checkpoint.main`` forward, on the reference-named files
  of ``tests/test_torch_reference_import.py`` (its ``ref`` fixture: JAX's
  export of seeded JAX weights and a reference Adam state), with and
  without ``--torch_opt`` and ``--torch_mlp``: JAX's checkpoint reader
  (``training/checkpoint.py::resume_checkpoint``) restores what it wrote
  equal, array for array, to JAX's ``import_reference_checkpoint``,
  ``import_reference_mlp`` and ``import_reference_optimizer`` of the same
  files (renamings and transposes: exact).
- ``--reverse``: the reference files it writes equal JAX's
  ``export_reference_checkpoint`` and ``export_reference_optimizer``.
- ``generate_dataset``, easy and ``--hard``: the same OBJ bytes as the JAX
  tool's with the same seed, over one shared basis (ARPACK's random start
  and the octasphere's degenerate eigenspaces make two solves differ,
  ROADMAP §3), so both packages' solvers are given JAX's eigenvectors."""

import os

import numpy as np
import pytest
import torch
import yaml

import jax
from craniofacialsd_vae_tpu.ops import eigh as jeigh
from craniofacialsd_vae_tpu.training import coupled_adam as jadam
from craniofacialsd_vae_tpu.training import torch_import as ji
from craniofacialsd_vae_tpu.training.checkpoint import resume_checkpoint
from craniofacialsd_vae_tpu.training.trainer import TrainState
from craniofacialsd_vae_tpu_torch import (convert_torch_checkpoint,
                                          make_synthetic_dataset)
from craniofacialsd_vae_tpu_torch.ops import eigh as teigh
from tests.test_torch_reference_import import ref  # noqa: F401

LR = 1e-3


def _arch_config(path, is_vae: bool, weight_decay: float) -> str:
    """The architecture of ``ref``'s weights as a config file."""
    cfg = {"model": {"sampling": {"type": "basic",
                                  "sampling_factors": [2, 2]},
                     "spirals": {"length": [5, 5], "dilation": [1, 1]},
                     "in_channels": 3, "out_channels": [8, 16],
                     "latent_size": 6, "pre_z_sigmoid": False},
           "optimization": {"kl_weight": 1e-4 if is_vae else 0.0,
                            "lr": LR, "weight_decay": weight_decay}}
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


def _reference_mlp(path) -> str:
    torch.manual_seed(3)
    mlp = torch.nn.Module()
    mlp.model = torch.nn.Sequential(torch.nn.Linear(6, 8), torch.nn.ReLU(),
                                    torch.nn.Linear(8, 3), torch.nn.ReLU())
    torch.save({"model": mlp.state_dict()}, path)
    return str(path)


def _same_tree(got, want):
    got_l, got_t = jax.tree_util.tree_flatten(got)
    want_l, want_t = jax.tree_util.tree_flatten(want)
    assert got_t == want_t
    for a, b in zip(got_l, want_l):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("extras", [False, True], ids=["net", "opt_mlp"])
def test_convert_forward_is_read_by_jax(ref, tmp_path,  # noqa: F811
                                        extras):
    wd = 1e-3 if extras else 0.0
    cfg = _arch_config(tmp_path / "arch.yaml", ref["cfg_j"].is_vae, wd)
    out = str(tmp_path / "checkpoints")
    argv = ["--torch_model", ref["model_path"], "--config", cfg,
            "--out", out]
    mlp_path = None
    if extras:
        mlp_path = _reference_mlp(tmp_path / "mlp_classifier.pt")
        argv += ["--torch_opt", ref["opt_path"], "--torch_mlp", mlp_path]
    convert_torch_checkpoint.main(argv)
    # model_00000003.pt: the epoch comes from the file name
    assert sorted(os.listdir(out)) == (
        ["model_00000003.ckpt", "optimizer.ckpt"] if extras
        else ["model_00000003.ckpt"])

    params = ji.import_reference_checkpoint(ref["model_path"], ref["cfg_j"])
    mlp = ji.import_reference_mlp(mlp_path) if extras else None
    optimizer = jadam(LR, wd)
    opt = ji.import_reference_optimizer(ref["opt_path"], params,
                                        ref["cfg_j"], optimizer) \
        if extras else optimizer.init(params)
    template = TrainState(params=jax.tree.map(np.zeros_like, params),
                          opt_state=optimizer.init(params),
                          clf_params=None if mlp is None else jax.tree.map(
                              np.zeros_like, mlp))
    state, epoch = resume_checkpoint(out, template)
    assert epoch == 3
    _same_tree(state.params, params)
    if extras:
        _same_tree(state.clf_params, mlp)
        _same_tree(state.opt_state, opt)
    else:
        assert state.clf_params is None


def test_convert_reverse_equals_jax_export(ref, tmp_path):  # noqa: F811
    wd = 1e-3
    cfg = _arch_config(tmp_path / "arch.yaml", ref["cfg_j"].is_vae, wd)
    out = str(tmp_path / "checkpoints")
    convert_torch_checkpoint.main([
        "--torch_model", ref["model_path"], "--config", cfg, "--out", out,
        "--torch_opt", ref["opt_path"]])
    back = str(tmp_path / "back.pt")
    convert_torch_checkpoint.main(["--torch_model", back, "--config", cfg,
                                   "--out", out, "--reverse"])
    params = ji.import_reference_checkpoint(ref["model_path"], ref["cfg_j"])
    want_model = str(tmp_path / "jax.pt")
    ji.export_reference_checkpoint(params, ref["cfg_j"], want_model)
    got = torch.load(back, weights_only=True)["model"]
    want = torch.load(want_model, weights_only=True)["model"]
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k

    opt = ji.import_reference_optimizer(ref["opt_path"], params,
                                        ref["cfg_j"], jadam(LR, wd))
    want_opt = str(tmp_path / "jax_optimizer.pt")
    ji.export_reference_optimizer(opt, ref["cfg_j"], want_opt, LR, wd)
    got = torch.load(str(tmp_path / "back_optimizer.pt"),
                     weights_only=True)["optimizer"]
    want = torch.load(want_opt, weights_only=True)["optimizer"]
    assert got["param_groups"] == want["param_groups"]
    assert set(got["state"]) == set(want["state"])
    for i, st in want["state"].items():
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(got["state"][i][k], st[k]), (i, k)


@pytest.fixture(scope="module")
def shared_basis():
    """JAX's ARPACK basis of the default template (the octasphere of
    subdivision 4), handed to both packages' tools."""
    from craniofacialsd_vae_tpu.geometry.synthetic import synthetic_template

    tpl = synthetic_template(subdivisions=4, n_regions=15)
    return jeigh.laplacian_eigendecomposition(tpl, k=12, backend="scipy")


@pytest.mark.parametrize("hard", [False, True], ids=["easy", "hard"])
def test_generate_dataset_writes_jax_files(shared_basis, tmp_path,
                                           monkeypatch, hard):
    from tools.make_synthetic_dataset import generate_dataset as jgenerate

    def basis(template, k, backend):
        assert backend == "scipy" and k == 12
        return shared_basis

    monkeypatch.setattr(jeigh, "laplacian_eigendecomposition", basis)
    monkeypatch.setattr(teigh, "laplacian_eigendecomposition", basis)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jgenerate(jdir, 10, seed=5, k_modes=12, hard=hard) == 10
    argv = ["--out", tdir, "--n", "10", "--seed", "5", "--k_modes", "12"]
    assert make_synthetic_dataset.main(
        argv + (["--hard"] if hard else [])) == 10
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir)) and len(names) == 10
    assert names[0] == "a_0.obj"
    for name in names:
        with open(os.path.join(jdir, name), "rb") as f:
            want = f.read()
        with open(os.path.join(tdir, name), "rb") as f:
            assert f.read() == want, name

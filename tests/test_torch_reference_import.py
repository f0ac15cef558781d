"""The port's ``training/torch_import.py`` (the reference's torch
``state_dict`` names and Adam moments, both ways, and its MLP head)
against the JAX package's ``training/torch_import.py`` on the same
reference-named files. Both sides are renamings and transposes: every
comparison is exact."""

import os

import numpy as np
import pytest
import torch

import jax
from craniofacialsd_vae_tpu.models import SDVAEConfig as JConfig
from craniofacialsd_vae_tpu.models import init_sdvae as jinit
from craniofacialsd_vae_tpu.training import coupled_adam as jadam
from craniofacialsd_vae_tpu.training import torch_import as ji
from craniofacialsd_vae_tpu_torch.models import (SDVAE, SDVAEConfig,
                                                 SpiralGeometry,
                                                 params_from_jax)
from craniofacialsd_vae_tpu_torch.geometry import load_bundle
from craniofacialsd_vae_tpu_torch.training import coupled_adam
from craniofacialsd_vae_tpu_torch.training import torch_import as ti
from tests.test_training import _tiny_geometry


@pytest.fixture(scope="module", params=[True, False], ids=["vae", "ae"])
def ref(request, tmp_path_factory):
    """A reference-named checkpoint (JAX's export of seeded JAX weights),
    a reference Adam state for it and the port's model on the same
    geometry."""
    from craniofacialsd_vae_tpu.geometry.precompute import _save_bundle

    is_vae = request.param
    root = tmp_path_factory.mktemp("ref")
    geom_j, bundle_j = _tiny_geometry(np.random.default_rng(4),
                                      return_bundle=True)
    _save_bundle(str(root / "geometry.npz"), bundle_j)
    cfg_j = JConfig(out_channels=(8, 16), latent_size=6, is_vae=is_vae)
    params_j = jax.tree.map(np.asarray,
                            jinit(jax.random.PRNGKey(1), cfg_j, geom_j))
    model_path = str(root / "model_00000003.pt")
    ji.export_reference_checkpoint(params_j, cfg_j, model_path)
    sd = torch.load(model_path, weights_only=True)["model"]
    rng = np.random.default_rng(5)
    state = {i: {"step": torch.tensor(7.0),
                 "exp_avg": torch.from_numpy(
                     rng.normal(size=tuple(v.shape)).astype(np.float32)),
                 "exp_avg_sq": torch.from_numpy(
                     rng.random(size=tuple(v.shape)).astype(np.float32))}
             for i, v in enumerate(sd.values())}
    opt_path = str(root / "optimizer.pt")
    torch.save({"optimizer": {"state": state, "param_groups": [
        {"params": list(state), "lr": 1e-3, "betas": (0.9, 0.999),
         "eps": 1e-8, "weight_decay": 0.0, "amsgrad": False}]}}, opt_path)
    cfg_t = SDVAEConfig(out_channels=(8, 16), latent_size=6, is_vae=is_vae)
    geom_t = SpiralGeometry.from_bundle(load_bundle(str(root /
                                                        "geometry.npz")),
                                        device="cpu")
    return dict(root=root, cfg_j=cfg_j, cfg_t=cfg_t, params_j=params_j,
                model_path=model_path, opt_path=opt_path, sd=sd,
                state=state, geom=geom_t)


def test_import_matches_jax(ref):
    """Reference names → the port's ``state_dict`` equals the JAX import
    renamed, and loads into the port's model."""
    got = ti.import_reference_checkpoint(ref["model_path"], ref["cfg_t"])
    want = params_from_jax(jax.tree.map(
        np.asarray, ji.import_reference_checkpoint(ref["model_path"],
                                                   ref["cfg_j"])))
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    model = SDVAE(ref["cfg_t"], ref["geom"])
    model.load_state_dict(got)


def test_export_is_read_by_jax(ref, tmp_path):
    """The port's export, read back by the JAX package, gives JAX's
    weights; its keys and tensors equal JAX's own export."""
    sd = params_from_jax(ref["params_j"])
    path = str(tmp_path / "back.pt")
    ti.export_reference_checkpoint(sd, ref["cfg_t"], path)
    back = torch.load(path, weights_only=True)["model"]
    assert list(back) == list(ref["sd"])
    for k, v in ref["sd"].items():
        assert torch.equal(back[k], v), k
    tree = ji.import_reference_checkpoint(path, ref["cfg_j"])
    for k, v in params_from_jax(jax.tree.map(np.asarray, tree)).items():
        assert torch.equal(v, sd[k]), k


def test_mismatched_architecture_raises(ref):
    sd = dict(ref["sd"])
    sd["extra.weight"] = torch.zeros(1)
    with pytest.raises(ValueError, match="unconsumed"):
        ti.import_reference_checkpoint(sd, ref["cfg_t"])
    first = next(iter(ref["sd"]))
    with pytest.raises(KeyError, match="missing"):
        ti.import_reference_checkpoint(
            {k: v for k, v in ref["sd"].items() if k != first},
            ref["cfg_t"])


def test_optimizer_import_matches_jax(ref):
    """The reference's Adam moments into the port's ``torch.optim.Adam``
    equal JAX's import into optax's state, leaf by leaf."""
    model = SDVAE(ref["cfg_t"], ref["geom"])
    opt = coupled_adam(model.parameters(), 1e-3, 0.0)
    ti.import_reference_optimizer(ref["opt_path"], model, ref["cfg_t"], opt)
    j_state = ji.import_reference_optimizer(
        ref["opt_path"], ref["params_j"], ref["cfg_j"], jadam(1e-3, 0.0))
    adam = [s for s in jax.tree_util.tree_leaves(
        j_state, is_leaf=lambda n: hasattr(n, "mu")) if hasattr(s, "mu")][0]
    mu = params_from_jax(jax.tree.map(np.asarray, adam.mu))
    nu = params_from_jax(jax.tree.map(np.asarray, adam.nu))
    for name, p in model.named_parameters():
        st = opt.state[p]
        assert float(st["step"]) == float(adam.count) == 7.0
        assert torch.equal(st["exp_avg"], mu[name]), name
        assert torch.equal(st["exp_avg_sq"], nu[name]), name


def test_optimizer_export_round_trips(ref, tmp_path):
    """Import then export gives back the reference file's moments, in
    its order, and torch's Adam loads it."""
    model = SDVAE(ref["cfg_t"], ref["geom"])
    opt = coupled_adam(model.parameters(), 1e-3, 0.0)
    ti.import_reference_optimizer(ref["opt_path"], model, ref["cfg_t"], opt)
    path = str(tmp_path / "opt_back.pt")
    ti.export_reference_optimizer(opt, model, ref["cfg_t"], path, lr=2e-4,
                                  weight_decay=1e-5)
    back = torch.load(path, weights_only=True)["optimizer"]
    assert back["param_groups"][0]["lr"] == 2e-4
    for i, st in ref["state"].items():
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(back["state"][i][k], st[k]), (i, k)
        assert float(back["state"][i]["step"]) == 7.0
    # the reference's own optimizer over reference-named parameters
    ref_params = [torch.nn.Parameter(v.clone()) for v in ref["sd"].values()]
    torch.optim.Adam(ref_params, lr=1e-3).load_state_dict(back)


def test_reference_mlp_matches_jax(tmp_path):
    mlp = torch.nn.Module()
    mlp.model = torch.nn.Sequential(torch.nn.Linear(6, 8), torch.nn.ReLU(),
                                    torch.nn.Linear(8, 3), torch.nn.ReLU())
    path = str(tmp_path / "mlp_classifier.pt")
    torch.save({"model": mlp.state_dict()}, path)
    got, want = ti.import_reference_mlp(path), ji.import_reference_mlp(path)
    assert len(got) == len(want) == 2
    for lt, lj in zip(got, want):
        np.testing.assert_array_equal(lt["w"], np.asarray(lj["w"]))
        np.testing.assert_array_equal(lt["b"], np.asarray(lj["b"]))
    with pytest.raises(KeyError, match="MLPClassifier"):
        ti.import_reference_mlp({"other.weight": torch.zeros(2)})
    assert os.path.exists(path)

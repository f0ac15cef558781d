"""The port's offline augmentation against the JAX package's: the three
modes on the same eigenvectors with the same numpy ``Generator`` (outputs
within 1e-5, tags equal, the generators left in the same state),
``build_datasets`` of both packages on one raw mesh directory with the
same basis seeded in its cache (the same ``data_split.json``, the same
``augmented/`` names, vertices within 1e-5), and the port's training
entry point on a raw directory with the study's data section."""

import glob
import json
import os
import shutil

import numpy as np
import pytest
import torch
import yaml

from craniofacialsd_vae_tpu.data import augmentation as jaug
from craniofacialsd_vae_tpu.data import dataset as jdataset
from craniofacialsd_vae_tpu.geometry import write_obj as jwrite_obj
from craniofacialsd_vae_tpu.geometry.synthetic import \
    synthetic_template as jsynthetic
from craniofacialsd_vae_tpu.ops import eigh as jeigh
from craniofacialsd_vae_tpu_torch import train as ttrain
from craniofacialsd_vae_tpu_torch.data import augmentation as taug
from craniofacialsd_vae_tpu_torch.data import dataset as tdataset
from craniofacialsd_vae_tpu_torch.geometry import (read_mesh,
                                                   synthetic_template)
from craniofacialsd_vae_tpu_torch.ops import eigh
from tests.test_torch_manager import make_workspace

AUG_ATOL = 1e-5       # fp32 projections and rebuilds summed in another
#                       order than XLA's; vertices are O(1)


@pytest.fixture(scope="module")
def mesh_dir(tmp_path_factory):
    """``tests/test_dataset.py``'s raw dataset: 6 noisy copies of the
    octasphere of subdivision 2 in each of classes a/c/m/n/b."""
    tpl = jsynthetic(subdivisions=2, n_regions=3)
    root = tmp_path_factory.mktemp("meshes")
    rng = np.random.default_rng(0)
    for c in ["a", "c", "m", "n", "b"]:
        for i in range(6):
            verts = tpl.pos + rng.normal(scale=0.02, size=tpl.pos.shape)
            jwrite_obj(str(root / f"{c}_{i}.obj"), verts, tpl.face)
    return str(root), tpl


def _pair(tpl, n_pairs, seed):
    rng = np.random.default_rng(seed)
    x1 = (tpl.pos[None] + rng.normal(scale=0.05, size=(n_pairs,)
                                     + tpl.pos.shape)).astype(np.float32)
    x2 = (tpl.pos[None] * 1.2 + rng.normal(scale=0.05, size=(n_pairs,)
                                           + tpl.pos.shape)
          ).astype(np.float32)
    return x1, x2


@pytest.mark.parametrize("mode", ["interpolate", "spectral_comb",
                                  "spectral_interp"])
@pytest.mark.parametrize("k", [40, 60])
def test_modes_match_jax_draw_for_draw(mesh_dir, mode, k):
    _, tpl = mesh_dir
    _, vecs = jeigh.laplacian_eigendecomposition(tpl, k, backend="scipy")
    x1, x2 = _pair(tpl, 3, k)
    rng_t, rng_j = np.random.default_rng(9), np.random.default_rng(9)
    out_t, tags_t = taug.augment_pairs(mode, x1, x2, rng_t, vecs)
    out_j, tags_j = jaug.augment_pairs(mode, x1, x2, rng_j, vecs)
    assert tags_t == tags_j
    assert out_t.shape == x1.shape and out_t.dtype == np.float32
    np.testing.assert_allclose(out_t, np.asarray(out_j), rtol=0,
                               atol=AUG_ATOL)
    assert rng_t.bit_generator.state == rng_j.bit_generator.state


def test_spectral_modes_take_a_device_tensor_and_one_mesh(mesh_dir):
    """A basis tensor runs the products where it lies; an unbatched mesh
    is lifted to [1, N, 3], as JAX lifts it."""
    _, tpl = mesh_dir
    _, vecs = jeigh.laplacian_eigendecomposition(tpl, 40, backend="scipy")
    x1, x2 = _pair(tpl, 1, 3)
    u = torch.as_tensor(vecs, dtype=torch.float32)
    for fn, jfn in ((taug.spectral_combination, jaug.spectral_combination),
                    (taug.spectral_interpolation,
                     jaug.spectral_interpolation)):
        got = fn(u, x1[0], x2[0], np.random.default_rng(4))
        want = jfn(vecs, x1[0], x2[0], np.random.default_rng(4))
        assert got.shape == (1,) + tpl.pos.shape
        np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                   atol=AUG_ATOL)
    assert taug.SWAP_UNTIL == jaug.SWAP_UNTIL
    assert taug.INTERP_UNTIL == jaug.INTERP_UNTIL


def _seed_basis(root, tpl):
    """One basis in ``root``'s cache under the name both packages look
    for (``auto``, k = 1000; the mesh has 66 vertices, so all 66 pairs,
    as a dense solve would store them)."""
    lap = jeigh.unnormalized_laplacian_dense(tpl.num_vertices, tpl.edges)
    vals, vecs = np.linalg.eigh(lap.astype(np.float64))
    stem = eigh._cache_stem(tpl, "auto")
    np.savez(os.path.join(root, f"{stem}_k1000.npz"),
             vals=vals.astype(np.float32), vecs=vecs.astype(np.float32))


@pytest.mark.parametrize("mode,balanced", [("spectral_interp", True),
                                           ("spectral_interp", False),
                                           ("spectral_comb", True),
                                           ("interpolate", False)])
def test_build_datasets_generates_what_jax_generates(mesh_dir, tmp_path,
                                                     mode, balanced):
    """Both packages on copies of one raw directory (the same basis in
    each cache), factor 2: the same split file, the same generated names,
    vertices within 1e-5; the port solves nothing."""
    src, tpl = mesh_dir
    outs, roots = {}, {}
    for pkg in ("t", "j"):
        root = str(tmp_path / f"raw_{pkg}")
        shutil.copytree(src, root)
        _seed_basis(root, tpl)
        roots[pkg] = root
        cfg = {"data": {"dataset_path": root,
                        "precomputed_path": str(tmp_path / f"pre_{pkg}"),
                        "normalize_data": True, "stratified_split": True,
                        "augmentation_factor": 2,
                        "augmentation_mode": mode,
                        "augmentation_balanced": balanced}}
        if pkg == "t":
            eigh.solves.reset()
            outs[pkg] = tdataset.build_datasets(cfg, synthetic_template(2, 3),
                                                device="cpu")
            assert eigh.solves.last is None or \
                eigh.solves.last["solver"] == "cache"
        else:
            outs[pkg] = jdataset.build_datasets(cfg, tpl)
    with open(str(tmp_path / "pre_t" / "data_split.json")) as f, \
            open(str(tmp_path / "pre_j" / "data_split.json")) as g:
        assert json.load(f) == json.load(g)
    names = {pkg: sorted(os.listdir(os.path.join(r, "augmented")))
             for pkg, r in roots.items()}
    assert names["t"] == names["j"] and names["t"]
    n_raw = 30 - len(outs["t"][1].names) - len(outs["t"][2].names)
    assert len(outs["t"][0]) == n_raw + len(names["t"])
    for name in names["t"]:
        a = read_mesh(os.path.join(roots["t"], "augmented", name))
        b = read_mesh(os.path.join(roots["j"], "augmented", name))
        np.testing.assert_allclose(a.vertices, b.vertices, rtol=0,
                                   atol=AUG_ATOL)
        np.testing.assert_array_equal(a.faces, b.faces)
    np.testing.assert_allclose(outs["t"][0].x, outs["j"][0].x, rtol=0,
                               atol=1e-3)
    np.testing.assert_array_equal(outs["t"][0].augmented,
                                  outs["j"][0].augmented)


def test_the_port_solves_and_caches_the_basis_jax_reads(mesh_dir, tmp_path):
    """With no basis cached the port solves it (dense, on the host here)
    into the dataset directory, where the JAX package finds it."""
    src, tpl = mesh_dir
    root = str(tmp_path / "raw")
    shutil.copytree(src, root)
    cfg = {"data": {"dataset_path": root,
                    "precomputed_path": str(tmp_path / "pre"),
                    "stratified_split": True, "augmentation_factor": 2,
                    "augmentation_mode": "spectral_interp"}}
    tdataset.build_datasets(cfg, synthetic_template(2, 3), device="cpu")
    assert eigh.solves.last["solver"] == "dense"
    (cached,) = glob.glob(os.path.join(root, "eigbasis_*_auto_k1000.npz"))
    with np.load(cached) as z:
        vals, vecs = jeigh.laplacian_eigendecomposition(tpl, 1000,
                                                        cache_dir=root)
        np.testing.assert_array_equal(vecs, z["vecs"])


def test_train_entry_point_on_a_raw_dataset(tmp_path):
    """``train.main(device="cpu")`` with the study's data section on a raw
    directory: the basis is solved and cached, ``augmented/`` generated,
    and the extended list trained for a few steps."""
    root = str(tmp_path)
    config = make_workspace(root, per_class=6)
    config["data"].update(augmentation_factor=2,
                          augmentation_mode="spectral_interp",
                          augmentation_balanced=True)
    config["optimization"]["epochs"] = 1
    config["logging_frequency"] = {"tb_renderings": 5, "save_weights": 5}
    path = os.path.join(root, "cfg.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    eigh.solves.reset()
    out = ttrain.main(["--config", path, "--id", "aug", "--output_path",
                       root, "--device", "cpu"])
    assert eigh.solves.last["solver"] == "dense"
    mesh_dir = config["data"]["dataset_path"]
    generated = os.listdir(os.path.join(mesh_dir, "augmented"))
    assert generated and all("_spectral_interp" in n for n in generated)
    assert glob.glob(os.path.join(mesh_dir, "eigbasis_*_auto_k1000.npz"))
    with open(os.path.join(config["data"]["precomputed_path"],
                           "data_split.json")) as f:
        train = json.load(f)["train"]
    assert sum(n.startswith("augmented") for n in train) == len(generated)
    (epoch,) = out["history"]
    assert epoch["steps"] == len(train) // 2
    assert all(np.isfinite(v) for v in epoch["train"].values())

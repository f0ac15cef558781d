"""The port's dataset pipeline against the JAX package's: the split equals
sklearn's draws (through JAX's ``split_files``) over file counts, class
mixes and seeds, including the sizes that send JAX to its non-stratified
fallback and those where both raise; ``build_datasets`` (the split, the
norm stats, the class weights and the npz caches, their fingerprint
invalidation, a reference ``norm.pt``), the summary table, reading an
``augmented/`` directory, and both iterators' batch order."""

import json
import os
import shutil

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from craniofacialsd_vae_tpu.data import dataset as jdataset
from craniofacialsd_vae_tpu_torch.data import dataset as tdataset
from tests.test_torch_manager import make_workspace


# ------------------------------------------------------------- the split
def _names(counts):
    return [f"{c}_{i}.obj" for c, n in zip("abcmn", counts)
            for i in range(n)]


def _split_or_error(fn, names, stratified, seed):
    try:
        return [list(s) for s in fn(names, stratified, seed)]
    except ValueError as e:
        return type(e)


@settings(max_examples=120, deadline=None, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(counts=st.lists(st.integers(0, 14), min_size=1, max_size=5),
       seed=st.integers(0, 2 ** 31 - 1), stratified=st.booleans())
def test_split_files_equals_sklearn_through_jax(counts, seed, stratified):
    names = _names(counts)
    assert _split_or_error(tdataset.split_files, names, stratified, seed) \
        == _split_or_error(jdataset.split_files, names, stratified, seed)


@pytest.mark.parametrize("counts,fallback", [
    ((8, 8, 8), True),          # the second split is too small per class
    ((40, 30, 20, 10), False),  # both splits stratify
    ((1, 30), True),            # a class of one
    ((6,), False),
    ((50, 50, 50, 50, 50), False),
])
def test_split_paths_equal_jax(counts, fallback, capsys):
    names = _names(counts)
    for seed in (0, 7):
        assert tdataset.split_files(names, True, seed) == \
            jdataset.split_files(names, True, seed)
    said = "too small to stratify" in capsys.readouterr().out
    assert said == fallback


@pytest.mark.parametrize("n", [0, 1])
def test_split_of_too_few_files_raises_like_jax(n):
    names = _names((n,))
    with pytest.raises(ValueError):
        jdataset.split_files(names, True, 0)
    with pytest.raises(ValueError):
        tdataset.split_files(names, True, 0)


def test_modulo_split_equals_jax():
    names = _names((90, 40, 20))
    assert tdataset.split_files(names, False) == \
        jdataset.split_files(names, False)


# ------------------------------------------------------- build_datasets
@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data"))
    config = make_workspace(root)
    cfgs = {}
    for pkg in ("t", "j"):
        cfg = json.loads(json.dumps(config))
        cfg["data"]["precomputed_path"] = os.path.join(root, f"pre_{pkg}")
        cfgs[pkg] = cfg
    out_t = tdataset.build_datasets(cfgs["t"])
    out_j = jdataset.build_datasets(cfgs["j"], None)
    return dict(root=root, cfgs=cfgs, out_t=out_t, out_j=out_j)


def _arrays_equal(a, b):
    np.testing.assert_array_equal(a.x, b.x)
    assert a.x.dtype == b.x.dtype
    assert list(a.y) == list(b.y) and list(a.names) == list(b.names)
    np.testing.assert_array_equal(a.age, b.age)
    assert list(a.gender) == list(b.gender)
    np.testing.assert_array_equal(a.augmented, b.augmented)


def _outputs_equal(out_t, out_j):
    for a, b in zip(out_t[:3], out_j[:3]):
        _arrays_equal(a, b)
    for k in ("mean", "std"):
        np.testing.assert_array_equal(out_t[3][k], out_j[3][k])
    assert out_t[4] == out_j[4]


def test_build_datasets_equals_jax(ws):
    _outputs_equal(ws["out_t"], ws["out_j"])
    pre = {k: ws["cfgs"][k]["data"]["precomputed_path"] for k in "tj"}
    for f in ("data_split.json", "norm.npz", "training.npz", "val.npz",
              "test.npz"):
        assert os.path.exists(os.path.join(pre["t"], f)), f
    with open(os.path.join(pre["t"], "data_split.json")) as f, \
            open(os.path.join(pre["j"], "data_split.json")) as g:
        assert json.load(f) == json.load(g)
    with np.load(os.path.join(pre["t"], "norm.npz")) as a, \
            np.load(os.path.join(pre["j"], "norm.npz")) as b:
        for k in ("mean", "std"):
            np.testing.assert_array_equal(a[k], b[k])


def test_each_package_reads_the_others_caches(ws):
    cfg_t = json.loads(json.dumps(ws["cfgs"]["t"]))
    cfg_j = json.loads(json.dumps(ws["cfgs"]["j"]))
    _outputs_equal(tdataset.build_datasets(cfg_j), ws["out_j"])
    _outputs_equal(jdataset.build_datasets(cfg_t, None), ws["out_t"])


def test_regenerated_dataset_invalidates_the_caches(ws, tmp_path):
    root = str(tmp_path)
    shutil.copytree(os.path.join(ws["root"], "meshes"),
                    os.path.join(root, "meshes"))
    cfg = json.loads(json.dumps(ws["cfgs"]["t"]))
    cfg["data"]["dataset_path"] = os.path.join(root, "meshes")
    cfg["data"]["precomputed_path"] = os.path.join(root, "pre")
    first = tdataset.build_datasets(cfg)
    path = os.path.join(root, "meshes", first[0].names[0])
    from craniofacialsd_vae_tpu_torch.geometry import read_mesh, write_obj
    mesh = read_mesh(path)
    write_obj(path, mesh.vertices * 1.5, mesh.faces)
    os.utime(path, ns=(os.stat(path).st_atime_ns,
                       os.stat(path).st_mtime_ns + 10 ** 9))
    second = tdataset.build_datasets(cfg)
    assert not np.array_equal(first[3]["mean"], second[3]["mean"])
    cfg_j = json.loads(json.dumps(cfg))
    cfg_j["data"]["precomputed_path"] = os.path.join(root, "pre_j")
    _outputs_equal(second, jdataset.build_datasets(cfg_j, None))


def test_reference_norm_pt_is_imported(ws, tmp_path):
    cfg = json.loads(json.dumps(ws["cfgs"]["t"]))
    pre = str(tmp_path / "ref")
    os.makedirs(pre)
    mean, std = ws["out_t"][3]["mean"], ws["out_t"][3]["std"]
    torch.save({"mean": torch.from_numpy(mean + 1.0),
                "std": torch.from_numpy(std * 2.0)},
               os.path.join(pre, "norm.pt"))
    cfg["data"]["precomputed_path"] = pre
    cfg_j = json.loads(json.dumps(cfg))
    pre_j = str(tmp_path / "ref_j")
    shutil.copytree(pre, pre_j)
    cfg_j["data"]["precomputed_path"] = pre_j
    out_t = tdataset.build_datasets(cfg)
    _outputs_equal(out_t, jdataset.build_datasets(cfg_j, None))
    np.testing.assert_array_equal(out_t[3]["mean"], mean + 1.0)
    assert not os.path.exists(os.path.join(pre, "training.npz"))


def test_an_augmented_directory_is_read_and_generation_raises(ws, tmp_path):
    """A raw directory no longer raises: generation (the default
    ``interpolate`` mode) writes what JAX writes. A directory that already
    holds ``augmented/`` is read as it is."""
    root = str(tmp_path)
    for pkg in ("gen_t", "gen_j", "meshes"):
        shutil.copytree(os.path.join(ws["root"], "meshes"),
                        os.path.join(root, pkg))
    from craniofacialsd_vae_tpu.geometry.synthetic import \
        synthetic_template as jsynthetic
    from craniofacialsd_vae_tpu_torch.geometry import synthetic_template

    gen = {}
    for pkg, build in (
            ("t", lambda c: tdataset.build_datasets(
                c, synthetic_template(2, 3))),
            ("j", lambda c: jdataset.build_datasets(c, jsynthetic(2, 3)))):
        cfg = json.loads(json.dumps(ws["cfgs"]["t"]))
        cfg["data"].update(dataset_path=os.path.join(root, f"gen_{pkg}"),
                           precomputed_path=os.path.join(root, f"pre_gen_{pkg}"),
                           augmentation_factor=2)
        gen[pkg] = build(cfg)
    _outputs_equal(gen["t"], gen["j"])
    assert gen["t"][0].augmented.sum() > 0
    cfg = json.loads(json.dumps(ws["cfgs"]["t"]))
    cfg["data"].update(dataset_path=os.path.join(root, "meshes"),
                       precomputed_path=os.path.join(root, "pre"),
                       augmentation_factor=2)
    aug = os.path.join(root, "meshes", "augmented")
    os.makedirs(aug)
    for name in ("a_0_1interp3.obj", "c_2_5interp0.obj"):
        shutil.copy(os.path.join(root, "meshes", name[:3] + ".obj"),
                    os.path.join(aug, name))
    out_t = tdataset.build_datasets(cfg)
    cfg_j = json.loads(json.dumps(cfg))
    cfg_j["data"]["precomputed_path"] = os.path.join(root, "pre_j")
    _outputs_equal(out_t, jdataset.build_datasets(cfg_j, None))
    assert out_t[0].augmented.sum() == 2


# ------------------------------------------------------------ the summary
SUMMARY = ("Dataset,ID,PID,AgeMonths,AgeYears,Gender,Head Used,Face Used\n"
           "LSFM,1,11,30,,F,y,n\n"
           "Apert,2,12,,3,M,y,y\n"
           "Crouzon,3,13,,,F,n,y\n"
           "Unknown,,14,5,,,y,y\n"
           "Paeds,5,15,,,M,y,n\n")


@pytest.mark.parametrize("data_type", ["heads", "bodies"])
def test_summary_equals_jax(tmp_path, data_type):
    path = str(tmp_path / "summary.csv")
    with open(path, "w") as f:
        f.write(SUMMARY)
    got = tdataset.DatasetSummary.load(path, data_type)
    want = jdataset.DatasetSummary.load(path, data_type)
    assert got.used == want.used
    assert got.ages == want.ages
    assert set(got.genders) == set(want.genders)
    for k, v in want.genders.items():
        assert got.genders[k] == v or (v != v and got.genders[k] !=
                                       got.genders[k])
    for mesh_id in ("n_1", "a_2", "nan_-1", "x_9"):
        assert got.age_and_gender(mesh_id)[0] == \
            want.age_and_gender(mesh_id)[0]


def test_summary_absent_and_xlsx(tmp_path):
    assert tdataset.DatasetSummary.load("none").used is None
    assert tdataset.DatasetSummary.load(str(tmp_path / "no.csv")).ages == {}
    xlsx = str(tmp_path / "s.xlsx")
    with open(xlsx, "wb") as f:
        f.write(b"PK")
    with pytest.raises(ValueError, match="csv"):
        tdataset.DatasetSummary.load(xlsx)


# ------------------------------------------------------------ iterators
@pytest.mark.parametrize("shuffle,drop_last,bs", [(True, True, 2),
                                                  (True, False, 4),
                                                  (False, False, 3),
                                                  (False, True, 5)])
def test_iterators_give_jax_batches(ws, shuffle, drop_last, bs):
    """Two epochs of each port iterator (host and device-resident, on
    the CPU) against JAX's, then an ``epoch_plan`` and an ordered pass."""
    train = ws["out_t"][0]
    c2i = {"a": 0, "c": 1, "n": 2}
    kw = dict(shuffle=shuffle, drop_last=drop_last, seed=3, class2idx=c2i)
    jit = jdataset.BatchIterator(train, bs, **kw)
    ports = [tdataset.BatchIterator(train, bs, **kw),
             tdataset.DeviceBatchIterator(train, bs, device="cpu", **kw)]
    for it in ports:
        assert len(it) == len(jit)
    for _ in range(2):
        want = list(jit)
        for it in ports:
            got = list(it)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                x = g["x"].numpy() if torch.is_tensor(g["x"]) else g["x"]
                np.testing.assert_array_equal(x, w["x"])
                assert g["y"] == w["y"] and g["gender"] == w["gender"]
                np.testing.assert_array_equal(g["labels"], w["labels"])
                np.testing.assert_array_equal(g["age"], w["age"])
    want = jit.epoch_plan()
    for it in ports:
        got = it.epoch_plan()
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
        x = got[0].numpy() if torch.is_tensor(got[0]) else got[0]
        np.testing.assert_array_equal(x, np.asarray(want[0]))
        assert [b["y"] for b in it.ordered_batches()] == \
            [b["y"] for b in jit.ordered_batches()]


def test_class_weights_equal_jax(ws):
    names = ws["out_t"][0].names + ["b_1.obj", "augmented/b_2_3x1.obj"]
    assert tdataset.compute_class_weights(names) == \
        jdataset.compute_class_weights(names)
    root = os.path.join(ws["root"], "meshes")
    for aug in (True, False):
        assert tdataset.find_filenames(root, None, aug) == \
            jdataset.find_filenames(root, None, aug)
    used = ["a_1", "c_3"]
    assert tdataset.find_filenames(root, used) == \
        jdataset.find_filenames(root, used)

"""The port's config reader against PyYAML and the JAX package's
``get_config``: the YAML subset reader equals ``yaml.safe_load`` on every
shipped config and on written snapshots (block and flow styles), scalars
resolve as YAML 1.1 resolves them, and the merged, validated config dicts
equal the JAX package's."""

import glob
import math
import os

import numpy as np
import pytest
import yaml

from craniofacialsd_vae_tpu import utils as jutils
from craniofacialsd_vae_tpu_torch import utils as tutils
from craniofacialsd_vae_tpu_torch.utils.yaml_subset import safe_load

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configurations", "*.yaml")))


def _ids(paths):
    return [os.path.basename(p) for p in paths]


@pytest.mark.parametrize("path", CONFIGS, ids=_ids(CONFIGS))
def test_reader_equals_safe_load_on_shipped_configs(path):
    with open(path) as f:
        text = f.read()
    assert safe_load(text) == yaml.safe_load(text)


@pytest.mark.parametrize("style", ["block", "flow", "unsorted", "indent4"])
@pytest.mark.parametrize("path", CONFIGS, ids=_ids(CONFIGS))
def test_reader_equals_safe_load_on_written_snapshots(path, style):
    with open(path) as f:
        cfg = yaml.safe_load(f)
    text = {"block": lambda: yaml.safe_dump(cfg),
            "flow": lambda: yaml.dump(cfg, default_flow_style=True),
            "unsorted": lambda: yaml.safe_dump(cfg, sort_keys=False),
            "indent4": lambda: yaml.safe_dump(cfg, indent=4)}[style]()
    assert safe_load(text) == cfg


SCALARS = ["1e-4", "1.0e-4", "1.e+3", "1.5e3", "none", "None", "NONE",
           "True", "true", "yes", "No", "on", "OFF", "0", "010", "08",
           "0x1f", "0b101", "1:30", "1:30.5", "1_000", "-1.5", "+7", "~",
           "null", "", ".inf", "-.inf", ".nan", ".5", "3.", "abc:def",
           "a b", "0o7", "'1e-4'", '"x\\ty"', "'it''s'", "/tmp/a/b.ply",
           "[4, 4, 4, 4]", "[]", "{}", "{a: 1, b: [2, 3]}", "[a, 'b, c']"]


@pytest.mark.parametrize("text", SCALARS)
def test_scalars_resolve_as_yaml_1_1(text):
    got = safe_load(f"k: {text}")["k"]
    want = yaml.safe_load(f"k: {text}")["k"]
    if isinstance(want, float) and math.isnan(want):
        assert isinstance(got, float) and math.isnan(got)
    else:
        assert got == want and type(got) is type(want)


def test_the_traps_of_yaml_1_1():
    """A bare 1e-4 is a string (the code calls float on it), ``none`` is
    a string, ``True`` a bool and ``0`` an int."""
    cfg = safe_load("lr: 1e-4\nsummary: none\nstrat: True\nwd: 0\n")
    assert cfg == {"lr": "1e-4", "summary": "none", "strat": True, "wd": 0}
    assert type(cfg["wd"]) is int and float(cfg["lr"]) == 1e-4


@pytest.mark.parametrize("text", ["k: a: b", "k: |\n  text", "k: &a 1",
                                  "k: !!str 1", "k: [1, 2", "k: 2001-12-14",
                                  "k: one\n  two"])
def test_unsupported_constructs_raise(text):
    with pytest.raises(ValueError):
        safe_load(text)


def test_nested_block_structures():
    text = ("a:\n- 1\n- x: 2\n  y: [3, {p: q, r: 1.0}]\n- - 5\n  - 6\n"
            "b: \"x # not a comment\" # a comment\nc:\nd: {}\n")
    assert safe_load(text) == yaml.safe_load(text)


@pytest.mark.parametrize("path", CONFIGS, ids=_ids(CONFIGS))
def test_get_config_equals_jax(path):
    assert tutils.get_config(path) == jutils.get_config(path)


def test_get_config_of_a_snapshot_equals_jax(tmp_path):
    """A run dir's config.yaml (the snapshot train.py writes) and a config
    written by yaml.safe_dump, as the CLI tests write theirs."""
    src = os.path.join(REPO, "configurations", "smoke.yaml")
    tutils.save_config_snapshot(src, str(tmp_path / "run"))
    snap = str(tmp_path / "run" / "config.yaml")
    with open(snap) as f, open(src) as g:
        assert f.read() == g.read()
    assert tutils.get_config(snap) == jutils.get_config(snap)
    cfg = jutils.get_config(src)
    cfg["optimization"]["lr"] = 3e-4
    dumped = str(tmp_path / "dumped.yaml")
    with open(dumped, "w") as f:
        yaml.safe_dump(cfg, f)
    assert tutils.get_config(dumped) == jutils.get_config(dumped)


@pytest.mark.parametrize("bad", [
    {"model": {"out_channels": [8, 16, 32]}},
    {"model": {"spirals": {"length": [9]}}},
    {"model": {"compute_dtype": "float16"}},
    {"optimization": {"latent_consistency_weight": 0.5},
     "data": {"swap_features": False}},
])
def test_validate_config_refuses_what_jax_refuses(tmp_path, bad):
    path = str(tmp_path / "bad.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(bad, f)
    with pytest.raises(ValueError):
        jutils.get_config(path)
    with pytest.raises(ValueError):
        tutils.get_config(path)


def test_merge_and_defaults_equal_jax():
    user = {"data": {"dataset_path": "x"}, "classifier": {"a": 1},
            "model": {"spirals": {"length": [5, 5, 5, 5]}}}
    assert tutils._merge(tutils.DEFAULT_CONFIG, user) == \
        jutils._merge(jutils.DEFAULT_CONFIG, user)
    assert tutils.DEFAULT_CONFIG == jutils.DEFAULT_CONFIG


@pytest.mark.parametrize("weights", [
    {"a": 0.1, "b": 0.5, "c": 0.2, "n": 0.05},
    {"n": 1.0, "a": 2.0},
    {"b": 1.0, "m": 3.0},
])
def test_class_conversions_and_weights_equal_jax(weights):
    t_map, t_w = tutils.class_conversions_and_weights(weights)
    j_map, j_w = jutils.class_conversions_and_weights(weights)
    assert t_map == j_map and list(t_map)[-1] == list(j_map)[-1]
    np.testing.assert_array_equal(t_w, j_w)


def test_prepare_sub_folder(tmp_path):
    out = tutils.prepare_sub_folder(str(tmp_path / "run"))
    assert out == jutils.prepare_sub_folder(str(tmp_path / "run"))
    assert os.path.isdir(out)

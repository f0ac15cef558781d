"""The port's hyperparameter sweeps (``training/sweep.py``, ``sweep.py``)
against the JAX package's, on the CPU.

The variants' validation and the CLI's grid against JAX's, error for
error. Variant i against JAX's ``make_sweep_scanned_epochs`` on
``_tiny_geometry`` (JAX's init carried across, JAX's key schedule
injected as the shared draws): parameters and metrics within
``TRACK_RTOL`` (1e-4 over Adam steps), the 0.0-weighted term's metric
its unweighted value as JAX reads it. Against the port's own solo run
with the variant's hyperparameters the arithmetic is the same:
parameters, Adam states and metrics bit-equal (the solo run reads 0.0
for the 0-weighted term). The entry point's variant checkpoints resume
in JAX's ``ModelManager`` in the optimizer layout of their own weight
decay."""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp
from flax import serialization
from craniofacialsd_vae_tpu.manager import ModelManager as JManager
from craniofacialsd_vae_tpu.training import sweep as jsweep
from craniofacialsd_vae_tpu.utils import get_config as jget_config
from craniofacialsd_vae_tpu_torch import sweep as tsweep_cli
from craniofacialsd_vae_tpu_torch.models import (SDVAE, SDVAEConfig,
                                                 params_from_jax)
from craniofacialsd_vae_tpu_torch.training import (LOSS_KEYS, LossWeights,
                                                   coupled_adam,
                                                   make_scanned_train_epochs)
from craniofacialsd_vae_tpu_torch.training.ensemble import (EnsembleState,
                                                            MemberState)
from craniofacialsd_vae_tpu_torch.training.sweep import (
    SWEEPABLE_KEYS, build_variants, init_sweep_state,
    make_sweep_scanned_epochs, n_variants, stack_hyperparams, variant_state)
from craniofacialsd_vae_tpu_torch.utils import get_config
from tests.test_torch_ensemble import _plan
from tests.test_torch_manager import make_workspace, max_rel
from tests.test_torch_scan import _draws_from_key, _state
# tiny: the fixture, imported so that pytest finds it here
from tests.test_torch_training import B, Z, tiny  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACK_RTOL = 1e-4
N_EPOCHS = 2

BASE = {
    "data": {"swap_features": True},
    "optimization": {
        "lr": 1e-3, "weight_decay": 0.0, "kl_weight": 1e-4,
        "laplacian_weight": 0.1, "latent_consistency_weight": 0.5,
        "latent_consistency_eta1": 0.5, "latent_consistency_eta2": 0.5,
    },
}
OVERRIDES = [
    {},                                                      # base
    {"lr": 3e-3, "weight_decay": 1e-3, "kl_weight": 1e-3},   # coupled decay
    {"laplacian_weight": 0.0, "latent_consistency_eta1": 0.2},  # 0-weight
]
AE = {"data": {"swap_features": True},
      "optimization": dict(BASE["optimization"], kl_weight=0.0)}
NOSWAP = {"data": {"swap_features": False},
          "optimization": dict(BASE["optimization"],
                               latent_consistency_weight=0.0)}


# ----------------------------------------------- validation and the grid
@pytest.mark.parametrize("base,overrides", [
    (BASE, []),
    (BASE, [{"batch_size": 8}]),
    (BASE, [{}, {"lr": 2e-3, "epochs": 3}]),
    (AE, [{"kl_weight": 1e-4}]),
    (BASE, [{"kl_weight": 0.0}]),
    (NOSWAP, [{"latent_consistency_weight": 0.5}]),
    (BASE, OVERRIDES),
    (AE, [{"lr": 1.0}, {"weight_decay": 2}]),
], ids=["empty", "structural", "mixed", "ae_to_vae", "vae_to_ae",
        "no_swap", "valid", "valid_ae"])
def test_build_variants_matches_jax(base, overrides):
    """The same variants, or the same ValueError, as JAX's."""
    try:
        want = jsweep.build_variants(base, overrides)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            build_variants(base, overrides)
        assert str(got.value) == str(e)
        return
    assert build_variants(base, overrides) == want
    assert SWEEPABLE_KEYS == jsweep.SWEEPABLE_KEYS


def test_stack_hyperparams_matches_jax():
    variants = build_variants(BASE, OVERRIDES)
    got, want = stack_hyperparams(variants), jsweep.stack_hyperparams(
        jsweep.build_variants(BASE, OVERRIDES))
    for key in ("lr", "weight_decay"):
        np.testing.assert_allclose(got[key], np.asarray(want[key]),
                                   rtol=1e-7)
        assert all(isinstance(v, float) for v in got[key])
    for field in ("kl", "laplacian", "latent_consistency", "eta1", "eta2",
                  "classification"):
        np.testing.assert_allclose([getattr(w, field)
                                    for w in got["weights"]],
                                   np.asarray(getattr(want["weights"],
                                                      field)), rtol=1e-7)


def _jax_cli():
    spec = importlib.util.spec_from_file_location(
        "jax_sweep_cli", os.path.join(REPO, "tools", "sweep.py"))
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    return cli


@pytest.mark.parametrize("specs", [
    ["lr=1e-4,3e-4", "optimization.kl_weight=0,1"],
    ["weight_decay=0,1e-3,", " lr =1"],
    ["lr=1e-4", "lr=3e-4"],
    ["lr=fast"],
    ["lr"],
    ["lr="],
    [],
], ids=["grid", "spaces", "twice", "non_numeric", "no_equals", "no_values",
        "no_axis"])
def test_parse_vary_matches_jax(specs):
    """The grid, or the same SystemExit, as tools/sweep.py's."""
    try:
        want = _jax_cli().parse_vary(specs)
    except SystemExit as e:
        with pytest.raises(SystemExit) as got:
            tsweep_cli.parse_vary(specs)
        assert str(got.value) == str(e)
        return
    assert tsweep_cli.parse_vary(specs) == want


# ------------------------------------------------- variant i, tiny model
@pytest.fixture(scope="module")
def sweep_runs(tiny):  # noqa: F811
    """JAX's 3-variant sweep over two epochs; the port's from JAX's init
    with JAX's key schedule as the shared draws; and the port's solo run
    of each variant."""
    plan = _plan(np.random.default_rng(6), tiny["n"])
    key = jax.random.PRNGKey(1)
    variants = jsweep.build_variants(BASE, OVERRIDES)
    j_state = jsweep.init_sweep_state(tiny["cfg_j"], tiny["geom_j"], 3,
                                      seed=0)
    init = jax.tree.map(lambda leaf: np.asarray(leaf[0]), j_state.params)
    fn = jsweep.make_sweep_scanned_epochs(tiny["cfg_j"], batch_size=B)
    j_state, tr_j, va_j = fn(j_state, jsweep.stack_hyperparams(variants),
                             tiny["geom_j"], *[jnp.asarray(a) for a in plan],
                             None, None, None, key)
    host = [torch.from_numpy(a) if a.dtype == np.float32 else a
            for a in plan]
    draws = _draws_from_key(tiny, key)

    def model():
        m = SDVAE(SDVAEConfig(out_channels=(8, 16), latent_size=Z),
                  tiny["geom_t"])
        m.load_state_dict(params_from_jax(init))
        return m

    hp = stack_hyperparams(build_variants(BASE, OVERRIDES))
    members = []
    for lr, wd in zip(hp["lr"], hp["weight_decay"]):
        m = model()
        members.append(MemberState(m, coupled_adam(m.parameters(), lr, wd)))
    state = EnsembleState(members)
    tr_t, va_t = make_sweep_scanned_epochs(state, hp, B, draws=draws)(*host)
    solos = []
    for i, v in enumerate(build_variants(BASE, OVERRIDES)):
        o = v["optimization"]
        m = model()
        opt = coupled_adam(m.parameters(), o["lr"], o["weight_decay"])
        tr, va = make_scanned_train_epochs(
            m, LossWeights.from_config(o), opt, B, draws=draws)(*host)
        solos.append((m, opt, tr, va))
    return dict(j_state=j_state, tr_j=jax.device_get(tr_j),
                va_j=jax.device_get(va_j), state=state, tr_t=tr_t,
                va_t=va_t, solos=solos)


@pytest.mark.parametrize("i", [1, 2])
def test_variant_tracks_jax_sweep(sweep_runs, i):
    """Variant i (1: weight decay > 0; 2: a 0.0 laplacian weight) within
    TRACK_RTOL of JAX's variant i: every metric, the 0-weighted term's
    unweighted value included, and the final parameters."""
    r = sweep_runs
    for e in range(N_EPOCHS):
        for got, want in ((r["tr_t"][i][e], r["tr_j"]),
                          (r["va_t"][i][e], r["va_j"])):
            for k in LOSS_KEYS:
                np.testing.assert_allclose(got[k], float(want[k][i][e]),
                                           rtol=TRACK_RTOL, atol=1e-7,
                                           err_msg=f"variant {i} {e} {k}")
    assert r["va_t"][2][-1]["laplacian"] > 0
    after = params_from_jax(jax.tree.map(
        np.asarray, jsweep.variant_state(r["j_state"], i).params))
    for name, p in variant_state(r["state"], i).model.state_dict().items():
        assert max_rel(p.numpy(), after[name].numpy()) <= TRACK_RTOL, name


@pytest.mark.parametrize("i", [0, 1, 2])
def test_variant_equals_solo_run(sweep_runs, i):
    """Variant i against the port's solo run with its hyperparameters:
    parameters and Adam states bit-equal; the metrics equal but for the
    0-weighted term, which the solo run reads 0.0."""
    r = sweep_runs
    m, opt, tr, va = r["solos"][i]
    v = variant_state(r["state"], i)
    got, want = _state(v.model, v.optimizer), _state(m, opt)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    zero = {"laplacian"} if i == 2 else set()
    for runs_t, runs_s in ((r["tr_t"][i], tr), (r["va_t"][i], va)):
        for got_e, want_e in zip(runs_t, runs_s):
            for k in LOSS_KEYS:
                if k in zero:
                    assert want_e[k] == 0.0 and got_e[k] > 0.0
                else:
                    assert got_e[k] == want_e[k], k
    # the variants differ
    if i:
        assert not torch.equal(next(v.model.parameters()),
                               next(variant_state(r["state"], 0)
                                    .model.parameters()))


def test_state_bounds(sweep_runs, tiny):  # noqa: F811
    state = sweep_runs["state"]
    assert n_variants(state) == 3
    with pytest.raises(IndexError):
        variant_state(state, 3)
    cfg = SDVAEConfig(out_channels=(8, 16), latent_size=Z)
    hp = stack_hyperparams(build_variants(BASE, OVERRIDES))
    with pytest.raises(ValueError):
        init_sweep_state(cfg, tiny["geom_t"], 0, hyperparams=hp)
    with pytest.raises(ValueError):
        init_sweep_state(cfg, tiny["geom_t"], 2, hyperparams=hp)
    # K copies of one init, each Adam with its own variant's values
    st = init_sweep_state(cfg, tiny["geom_t"], 3, seed=4, hyperparams=hp)
    first = st.members[0].model.state_dict()
    for i, m in enumerate(st.members):
        for k, t in m.model.state_dict().items():
            assert torch.equal(t, first[k])
        group = m.optimizer.param_groups[0]
        assert (group["lr"], group["weight_decay"]) == \
            (hp["lr"][i], hp["weight_decay"][i])


# ------------------------------------------------------- the entry point
@pytest.fixture(scope="module")
def sweep_run(tmp_path_factory):
    """sweep.main on the CPU: a 2 × 2 grid of lr and weight decay, two
    epochs in chunks of one."""
    root = str(tmp_path_factory.mktemp("sweep"))
    config = make_workspace(root, mlp_training_type="after")
    path = os.path.join(root, "config.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    res = tsweep_cli.main(["--config", path, "--id", "sw", "--output_path",
                           root, "--vary", "lr=1e-3,3e-3", "--vary",
                           "weight_decay=0,1e-3", "--epochs", "2",
                           "--chunk_epochs", "1", "--device", "cpu"])
    return dict(res, root=root)


def test_sweep_json_ranks_the_variants(sweep_run):
    """sweep.json: JAX's keys, the variants ranked by validation
    reconstruction, the best first; each snapshot carries its variant's
    values, read alike by PyYAML and the port's reader."""
    out = sweep_run["output_dir"]
    with open(os.path.join(out, "sweep.json")) as f:
        manifest = json.load(f)
    assert set(manifest) == {"variants", "select", "seed", "epochs",
                             "config", "axes", "best"}
    assert manifest["select"] == "reconstruction"
    assert len(manifest["variants"]) == 4
    vals = [v["val"]["reconstruction"] for v in manifest["variants"]]
    assert vals == sorted(vals) and manifest["best"] == \
        manifest["variants"][0]
    last = sweep_run["chunks"][-1]["validation"]
    seen = set()
    for v in manifest["variants"]:
        assert set(v) == {"dir", "overrides", "val", "val_accuracy"}
        i = int(v["dir"].split("_")[1])
        assert v["val"] == {k: float(last[i][-1][k]) for k in LOSS_KEYS}
        path = os.path.join(out, v["dir"], "config.yaml")
        cfg = get_config(path)
        with open(path) as f:
            assert yaml.safe_load(f) == cfg
        assert cfg == sweep_run["variants"][i]
        for key, value in v["overrides"].items():
            assert cfg["optimization"][key] == value
        seen.add(tuple(sorted(v["overrides"].items())))
    assert len(seen) == 4


@pytest.mark.parametrize("wd", [0.0, 1e-3])
def test_variant_checkpoint_resumes_in_jax(sweep_run, wd):
    """A variant's checkpoint in the optax layout of its own weight decay
    (``chain(add_decayed_weights, adam)`` for wd > 0, plain ``adam`` at
    0), read by flax's msgpack codec (the JAX package's checkpoints')
    and resumed by JAX's ModelManager (what its train.py --resume calls)
    under the variant's own config snapshot: the weights and Adam's
    moments bit for bit."""
    out = sweep_run["output_dir"]
    i = [j for j, v in enumerate(sweep_run["variants"])
         if v["optimization"]["weight_decay"] == wd
         and v["optimization"]["lr"] == 3e-3][0]
    ckpt = os.path.join(out, f"variant_{i:02d}", "checkpoints")
    with open(os.path.join(ckpt, "optimizer.ckpt"), "rb") as f:
        raw = serialization.msgpack_restore(f.read())
    opt_state = raw["opt_state"]
    assert (set(opt_state) == {"0", "1"} and opt_state["0"] == {}) == \
        (wd > 0)
    config = jget_config(os.path.join(out, f"variant_{i:02d}",
                                      "config.yaml"))
    assert config["optimization"]["weight_decay"] == wd
    jm = JManager(config, config["data"]["precomputed_path"])
    assert jm.resume(ckpt) == 2
    assert jax.tree_util.tree_structure(jm.state.opt_state) == \
        jax.tree_util.tree_structure(jm.optimizer.init(jm.state.params))
    v = variant_state(sweep_run["state"], i)
    params = params_from_jax(jax.tree.map(np.asarray, jm.state.params))
    for name, p in v.model.state_dict().items():
        np.testing.assert_array_equal(p.numpy(), params[name].numpy())
    adam = jm.state.opt_state[1][0] if wd > 0 else jm.state.opt_state[0]
    mu = params_from_jax(jax.tree.map(np.asarray, adam.mu))
    named = dict(v.model.named_parameters())
    for name, p in named.items():
        np.testing.assert_array_equal(
            v.optimizer.state[p]["exp_avg"].numpy(), mu[name].numpy())

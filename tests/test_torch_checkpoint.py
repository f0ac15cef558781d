"""Checkpoints between the packages: the port's msgpack codec against
flax's serialization both ways (byte for byte where flax writes the same
tree, and with lists of 12 entries, so that keys sorted as strings would
put ``'10'`` before ``'2'``); then run dirs crossing both ways. A
checkpoint written by the JAX ``ModelManager`` resumes in the port's with
the same ``encode``/``generate`` and the same next Adam update (rtol
1e-5, draws injected), and the reverse, for weight decay 0 and not 0,
with an end-to-end classifier head and without one."""

import copy
import os

import numpy as np
import optax
import pytest
import torch
from flax import serialization

import jax
import jax.numpy as jnp
from craniofacialsd_vae_tpu.data import dataset as jdataset
from craniofacialsd_vae_tpu.manager import ModelManager as JManager
from craniofacialsd_vae_tpu.training import coupled_adam as jadam
from craniofacialsd_vae_tpu.training import checkpoint as jcheckpoint
from craniofacialsd_vae_tpu_torch.data import dataset as tdataset
from craniofacialsd_vae_tpu_torch.manager import ModelManager
from craniofacialsd_vae_tpu_torch.models import mlp_from_jax, params_from_jax
from craniofacialsd_vae_tpu_torch.training import coupled_adam
from craniofacialsd_vae_tpu_torch.training import checkpoint as tcheckpoint
from craniofacialsd_vae_tpu_torch.training.msgpack import (
    list_from_state_dict, packb, to_state_dict, unpackb)
from tests.test_torch_manager import (jax_draws, make_workspace, max_rel)

RTOL = 1e-5


# ---------------------------------------------------------------- codec
def _trees():
    rng = np.random.default_rng(0)
    layers = [{"w": rng.normal(size=(3, 2)).astype(np.float32),
               "b": np.full(2, i, np.float32)} for i in range(12)]
    return {
        "params": {"convs": layers, "dense": {
            "w": rng.normal(size=(5, 4)).astype(np.float32),
            "b": np.zeros(4, np.float32)}},
        "clf_params": None,
        "misc": {"count": np.asarray(7, np.int32),
                 "ints": np.arange(6, dtype=np.int64).reshape(2, 3),
                 "mask": np.array([True, False]),
                 "bytes": np.arange(300, dtype=np.uint8),
                 "f64": np.linspace(0, 1, 5),
                 "empty": np.zeros((0, 3), np.float32),
                 "scalar": np.float32(1.5), "big": np.int64(-2 ** 40)},
        "epoch": 12, "neg": [-1, -33, -200, -40000, -2 ** 33, 2 ** 40],
        "pos": [0, 127, 128, 255, 256, 65536, 2 ** 33], "flag": True,
        "lr": 1e-3, "name": "x" * 40, "long_name": "y" * 300,
        "nested": [[1, [2, 3]], {}, ()],
    }


def _assert_tree_equal(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want)
        for k in want:
            _assert_tree_equal(got[k], want[k])
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    elif isinstance(want, np.generic):
        assert type(got) is type(want) and got == want
    else:
        assert type(got) is type(want) and got == want


def test_port_bytes_equal_flax_to_bytes():
    tree = _trees()
    assert packb(to_state_dict(tree)) == serialization.to_bytes(tree)


def test_flax_restores_the_ports_bytes():
    tree = _trees()
    restored = serialization.msgpack_restore(packb(to_state_dict(tree)))
    _assert_tree_equal(restored, serialization.to_state_dict(tree))


def test_port_reads_flax_bytes_with_lists_in_integer_order():
    tree = _trees()
    got = unpackb(serialization.to_bytes(tree))
    _assert_tree_equal(got, serialization.to_state_dict(tree))
    convs = list_from_state_dict(got["params"]["convs"])
    assert [float(c["b"][0]) for c in convs] == list(range(12))
    assert sorted(got["params"]["convs"])[2] == "10"      # the string trap
    named = tcheckpoint.named_from_tree(got["params"])
    np.testing.assert_array_equal(named["convs.10.b"],
                                  tree["params"]["convs"][10]["b"])
    back = tcheckpoint.tree_from_named(named)
    assert [c["b"][0] for c in back["convs"]] == list(range(12))


@pytest.mark.parametrize("wd", [0.0, 1e-3])
def test_optax_state_layout_round_trips(wd):
    """optax's coupled Adam state (flax bytes) → the port → torch Adam →
    the port's bytes, which flax restores into optax's tree."""
    params = {"a": [{"w": jnp.ones((2, 3)), "b": jnp.zeros(3)}
                    for _ in range(11)], "c": jnp.arange(4.0)}
    opt = jadam(1e-3, wd)
    state = opt.init(params)
    grads = jax.tree.map(lambda p: 0.1 * jnp.ones_like(p) + p, params)
    for _ in range(3):
        _, state = opt.update(grads, state, params)
    raw = unpackb(serialization.to_bytes(state))
    named_p = {n: torch.nn.Parameter(torch.zeros(v.shape))
               for n, v in tcheckpoint.named_from_tree(
                   serialization.to_state_dict(params)).items()}
    adam = coupled_adam(named_p.values(), 1e-3, wd)
    tcheckpoint.adam_from_optax(adam, named_p, raw, wd)
    back = tcheckpoint.adam_to_optax(adam, named_p, wd)
    restored = serialization.from_bytes(state, packb(to_state_dict(back)))
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(ValueError):
        tcheckpoint.adam_from_optax(adam, named_p, raw, 0.5 if not wd
                                    else 0.0)


@pytest.mark.parametrize("data", [b"\x92\x01", b"\xc1", b"\x01\x02",
                                  b"\xd4\x05\x00"])
def test_codec_rejects_malformed_data(data):
    with pytest.raises(ValueError):
        unpackb(data)


def test_save_checkpoint_is_atomic_and_keeps_the_last(tmp_path):
    d = str(tmp_path / "ck")
    state = {"params": {"w": np.ones(3, np.float32)}, "clf_params": None,
             "opt_state": {"0": {}, "1": {}}, "clf_opt_state": None}
    for e in range(1, 5):
        tcheckpoint.save_checkpoint(d, state, e, keep_last=2)
    assert sorted(os.listdir(d)) == ["model_00000003.ckpt",
                                     "model_00000004.ckpt", "optimizer.ckpt"]
    assert tcheckpoint.latest_checkpoint(d).endswith("model_00000004.ckpt")
    assert jcheckpoint.latest_checkpoint(d) == \
        tcheckpoint.latest_checkpoint(d)
    assert tcheckpoint.latest_checkpoint(str(tmp_path / "none")) is None


# ------------------------------------------------------------- run dirs
SCENARIOS = {"head_wd0": ("end2end", 0.0), "head_wd": ("end2end", 1e-3),
             "no_head": (None, 0.0)}


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ckpt"))
    base = make_workspace(root)
    out = {}
    for name, (head, wd) in SCENARIOS.items():
        cfg = make_workspace(root, weight_decay=wd)
        if head is None:
            del cfg["classifier"]
        out[name] = cfg
    train, val, _, _, weights = tdataset.build_datasets(base)
    return dict(root=root, configs=out, train=train, weights=weights)


def _jax_manager(ws, name):
    cfg = ws["configs"][name]
    jm = JManager(cfg, cfg["data"]["precomputed_path"])
    jm.set_class_conversions_and_weights(ws["weights"])
    return jm


def _port_manager(ws, name):
    cfg = ws["configs"][name]
    tm = ModelManager(cfg, cfg["data"]["precomputed_path"], device="cpu")
    tm.set_class_conversions_and_weights(ws["weights"])
    tm._step_draws = jax_draws(0, len(tm.template.region_names),
                               cfg["model"]["latent_size"])
    return tm


def _epoch(manager, ws, pkg):
    it = pkg.BatchIterator(ws["train"], 2, shuffle=True, seed=1,
                           class2idx=manager._class2idx_dict)
    manager.run_epoch(it, train=True)


def _port_params(tm):
    out = {k: v.detach().clone() for k, v in tm.model.state_dict().items()}
    if tm.head is not None:
        out.update({f"head.{k}": v.detach().clone()
                    for k, v in tm.head.state_dict().items()})
    return out


def _jax_params(state):
    out = params_from_jax(jax.tree.map(np.asarray, state.params))
    if state.clf_params is not None:
        out.update({f"head.{k}": v for k, v in mlp_from_jax(
            jax.tree.map(np.asarray, state.clf_params)).items()})
    return out


def _next_updates(jm, tm, ws, step_id=10_000):
    """One more train step in each manager on the same batch, labels and
    draws; returns the two parameter updates."""
    batch = next(iter(jdataset.BatchIterator(
        ws["train"], 2, shuffle=False, class2idx=jm._class2idx_dict)))
    key = jax.random.fold_in(jax.random.PRNGKey(1), step_id)
    k_region, k_reparam = jax.random.split(key)
    region = int(jax.random.randint(
        k_region, (), 0, int(jm.geometry.region_masks.shape[0])))
    eps = np.array(jax.random.normal(k_reparam, (4, 6), jnp.float32))
    before_j = _jax_params(jm.state)
    labels = jnp.asarray(batch["labels"]) if jm._mlp_end2end else None
    state = jax.tree.map(jnp.copy, jm.state)
    jm.state, _ = jm._train_step(state, jm.geometry, jnp.asarray(batch["x"]),
                                 labels, jm._class_weights, key)
    after_j = _jax_params(jm.state)
    before_t = _port_params(tm)
    tm._train_step(torch.from_numpy(batch["x"]), region_idx=region,
                   eps=torch.from_numpy(eps),
                   labels=torch.from_numpy(batch["labels"]).long()
                   if tm._mlp_end2end else None,
                   class_weights=tm._class_weights)
    after_t = _port_params(tm)
    return ({k: (after_j[k] - before_j[k]).numpy() for k in before_j},
            {k: (after_t[k] - before_t[k]).numpy() for k in before_t})


def _assert_same_model(jm, tm, ws):
    x = ws["train"].x[:2]
    z_j = np.asarray(jm.encode(x))
    assert max_rel(tm.encode(x).numpy(), z_j) <= RTOL
    assert max_rel(tm.generate(z_j).numpy(),
                   np.asarray(jm.generate(z_j))) <= RTOL
    for k, v in _jax_params(jm.state).items():
        assert torch.equal(_port_params(tm)[k], v), k


def _adam_updates(jm, tm):
    """The same gradients (seeded, every parameter) into each manager's
    optimizers; returns (JAX's new parameters, the port's, the update
    sizes): the next Adam update of the restored states."""
    rng = np.random.default_rng(5)
    named_t = dict(tm.model.named_parameters())
    grads = {k: 1e-2 * rng.normal(size=tuple(p.shape)).astype(np.float32)
             for k, p in named_t.items()}
    tree = tcheckpoint.tree_from_named(grads)
    upd, _ = jm.optimizer.update(jax.tree.map(jnp.asarray, tree),
                                 jm.state.opt_state, jm.state.params)
    new_j = params_from_jax(jax.tree.map(
        np.asarray, optax.apply_updates(jm.state.params, upd)))
    sizes = {k: float(np.abs(v).max()) for k, v in
             tcheckpoint.named_from_tree(jax.tree.map(np.asarray,
                                                      upd)).items()}
    pairs = [(tm.optimizer, named_t, grads)]
    if tm.head is not None:
        named_h = dict(tm.head.named_parameters())
        hgrads = {k: 1e-2 * rng.normal(size=tuple(p.shape)).astype(
            np.float32) for k, p in named_h.items()}
        htree = tcheckpoint.tree_from_named(hgrads)["layers"]
        hupd, _ = jm.clf_optimizer.update(
            jax.tree.map(jnp.asarray, htree), jm.state.clf_opt_state,
            jm.state.clf_params)
        for k, v in mlp_from_jax(jax.tree.map(
                np.asarray, optax.apply_updates(jm.state.clf_params,
                                                hupd))).items():
            new_j[f"head.{k}"] = v
        for k, v in tcheckpoint.named_from_tree(
                {"layers": jax.tree.map(np.asarray, hupd)}).items():
            sizes[f"head.{k}"] = float(np.abs(v).max())
        pairs.append((tm.head_optimizer, named_h, hgrads))
    for opt, named, g in pairs:
        opt.zero_grad()
        for k, p in named.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    return new_j, _port_params(tm), sizes


def _snapshot(tm):
    mods = [tm.model, tm.optimizer]
    if tm.head is not None:
        mods += [tm.head, tm.head_optimizer]
    saved = [copy.deepcopy(m.state_dict()) for m in mods]

    def restore():
        for m, sd in zip(mods, saved):
            m.load_state_dict(sd)

    return restore


def _assert_same_update(jm, tm, ws):
    """The restored optimizers give the same next Adam update for the
    same gradients (1e-5 of each leaf's max update, plus two float32
    spacings of the parameters, in which both round ``p + update``); a
    whole next train step on the same batch and draws gives the same
    update within 1e-4 (the gradients of the two packages differ in the
    last bits, and Adam normalises them)."""
    state = jax.tree.map(jnp.copy, jm.state)
    restore = _snapshot(tm)
    new_j, new_t, sizes = _adam_updates(jm, tm)
    for k, want in new_j.items():
        got, want = new_t[k].numpy(), want.numpy()
        atol = RTOL * sizes[k] + 2 * float(np.spacing(np.abs(want).max()))
        np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=k)
    jm.state = state
    restore()
    upd_j, upd_t = _next_updates(jm, tm, ws)
    assert set(upd_j) == set(upd_t)
    for k in upd_j:
        assert np.abs(upd_j[k]).max() > 0, k
        assert max_rel(upd_t[k], upd_j[k]) <= 1e-4, k


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_jax_checkpoint_resumes_in_the_port(ws, name):
    jm = _jax_manager(ws, name)
    _epoch(jm, ws, jdataset)
    d = os.path.join(ws["root"], f"j2t_{name}")
    jm.save_weights(d, 0)
    tm = _port_manager(ws, name)
    assert tm.resume(d) == 1
    _assert_same_model(jm, tm, ws)
    _assert_same_update(jm, tm, ws)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_port_checkpoint_resumes_in_jax(ws, name):
    tm = _port_manager(ws, name)
    _epoch(tm, ws, tdataset)
    d = os.path.join(ws["root"], f"t2j_{name}")
    tm.save_weights(d, 0)
    jm = _jax_manager(ws, name)
    assert jm.resume(d) == 1
    _assert_same_model(jm, tm, ws)
    _assert_same_update(jm, tm, ws)


def test_head_of_another_shape_restores_the_network_only(ws, capsys):
    """A checkpoint without a head resumes in a manager with one: the
    network and its optimizer come back, the head stays fresh."""
    src = _port_manager(ws, "no_head")
    _epoch(src, ws, tdataset)
    d = os.path.join(ws["root"], "mismatch")
    src.save_weights(d, 0)
    tm = _port_manager(ws, "head_wd0")
    head0 = {k: v.clone() for k, v in tm.head.state_dict().items()}
    assert tm.resume(d) == 1
    assert "restored network weights only" in capsys.readouterr().out
    for k, v in src.model.state_dict().items():
        assert torch.equal(tm.model.state_dict()[k], v)
    for k, v in tm.head.state_dict().items():
        assert torch.equal(v, head0[k])


def test_optimizer_of_another_epoch_is_not_loaded(ws, capsys):
    tm = _port_manager(ws, "no_head")
    _epoch(tm, ws, tdataset)
    d = os.path.join(ws["root"], "unpaired")
    tm.save_weights(d, 1)
    tm.save_weights(d, 0)                 # optimizer.ckpt now says epoch 1
    os.remove(os.path.join(d, "model_00000001.ckpt"))
    tm.save_weights(d, 2)
    opt_path = os.path.join(d, "optimizer.ckpt")
    raw = unpackb(open(opt_path, "rb").read())
    raw["epoch"] = 1
    with open(opt_path, "wb") as f:
        f.write(packb(raw))
    fresh = _port_manager(ws, "no_head")
    assert fresh.resume(d) == 3
    assert "optimizer state not restored" in capsys.readouterr().out
    assert not fresh.optimizer.state

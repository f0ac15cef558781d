"""The port's scanned paths against the JAX package's, on the CPU: the
epoch plans and their step ids, ``can_scan_epochs``, the scanned epoch
and the multi-epoch scan (against JAX's, and against the port's own
per-step steps update for update), the manager's ``run_epochs_scanned``
with JAX's draws injected, the entry point's chunked epochs against its
per-epoch loop, ``--profile``, and the fit's cached iteration.

On the CPU the scanned callables run the eager step over their static
tensors (the card replays a CUDA graph of it; ``tests/test_torch_cuda.py``
holds a replay against the eager step there). Tolerances: the JAX
package's own for its scanned paths (``test_training.py``, rtol 1e-5 of
a step's values) grow to 1e-4 over the Adam steps here, as in
``tests/test_torch_training.py``: fp32 sums taken in another order by
XLA and by PyTorch compound. Against the port's own per-step path the
arithmetic is the same, so parameters, Adam states and losses are held
equal."""

import json
import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp
from craniofacialsd_vae_tpu.data import dataset as jdataset
from craniofacialsd_vae_tpu.manager import ModelManager as JManager
from craniofacialsd_vae_tpu.training import LossWeights as JWeights
from craniofacialsd_vae_tpu.training import coupled_adam as jax_adam
from craniofacialsd_vae_tpu.training import trainer as jtrainer
from craniofacialsd_vae_tpu_torch import train as ttrain
from craniofacialsd_vae_tpu_torch.analysis import fitting as tfitting
from craniofacialsd_vae_tpu_torch.data import dataset as tdataset
from craniofacialsd_vae_tpu_torch.manager import ModelManager
from craniofacialsd_vae_tpu_torch.models import params_from_jax
from craniofacialsd_vae_tpu_torch.training import (LOSS_KEYS, LossWeights,
                                                   assemble_epoch_plans,
                                                   coupled_adam,
                                                   make_eval_step,
                                                   make_scanned_train_epochs,
                                                   make_scanned_train_step,
                                                   make_train_step)
from craniofacialsd_vae_tpu_torch.training.checkpoint import read_checkpoint
from tests.test_torch_manager import (copy_jax_state, jax_draws,
                                      make_workspace, max_rel)
# tiny: the fixture, imported so that pytest finds it here
from tests.test_torch_training import (B, WEIGHTS, _injected,  # noqa: F401
                                       _model, tiny)

TRACK_RTOL = 1e-4


def _rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _draws_from_key(tiny_geom, key):
    """``draws(step_id, rows)`` of JAX's scanned key schedule
    (``fold_in`` of the step id, then ``split``)."""
    def draws(step_id, rows):
        assert rows == B * B
        return _injected(tiny_geom, jax.random.fold_in(key, step_id))
    return draws


def _state(model, optimizer) -> list:
    """Parameters and Adam states as numpy, in a fixed order."""
    out = [p.detach().numpy().copy() for p in model.parameters()]
    for p in model.parameters():
        st = optimizer.state[p]
        out += [np.asarray(st[k]).copy() for k in sorted(st)]
    return out


def _eager_sums(metrics: list) -> dict:
    """The per-step metrics summed in fp32 from zero and averaged on the
    host: what a scanned call returns."""
    sums = torch.zeros(len(LOSS_KEYS))
    for m in metrics:
        sums += torch.stack([m[k].float() for k in LOSS_KEYS])
    return {k: float(sums[i]) / len(metrics) for i, k in enumerate(LOSS_KEYS)}


# ------------------------------------------------ the callables, tiny model
def test_scanned_epoch_matches_jax(tiny):
    """make_scanned_train_step against JAX's, with JAX's key schedule as
    the draws: the mean metrics and the final parameters."""
    steps, n_data = 4, 7
    rng = np.random.default_rng(13)
    data = _rand(rng, n_data, tiny["n"], 3)
    idx = rng.integers(0, n_data, size=(steps, B)).astype(np.int32)
    key = jax.random.PRNGKey(21)
    sids = 1 + np.arange(steps)
    opt = jax_adam(1e-3, 0.0)
    j_epoch = jtrainer.make_scanned_train_step(
        tiny["cfg_j"], JWeights(**WEIGHTS), opt, batch_size=B)
    state = jtrainer.create_train_state(
        jax.tree.map(jnp.copy, tiny["params"]), opt)
    state, m_j = j_epoch(state, tiny["geom_j"], jnp.asarray(data),
                         jnp.asarray(idx), jnp.asarray(sids, jnp.int32),
                         None, None, key)
    model = _model(tiny)
    epoch = make_scanned_train_step(
        model, LossWeights(**WEIGHTS),
        coupled_adam(model.parameters(), 1e-3, 0.0), B,
        draws=_draws_from_key(tiny, key))
    m_t = epoch(torch.from_numpy(data), idx, sids)
    for k in LOSS_KEYS:
        np.testing.assert_allclose(m_t[k], float(m_j[k]), rtol=TRACK_RTOL,
                                   atol=1e-7, err_msg=k)
    after = params_from_jax(jax.tree.map(np.asarray, state.params))
    for name, p in model.state_dict().items():
        assert max_rel(p.numpy(), after[name].numpy()) <= TRACK_RTOL, name


@pytest.mark.parametrize("from_numpy", [False, True])
def test_scanned_epoch_equals_the_per_step_path(tiny, from_numpy):
    """The scanned epoch against the port's eager steps on the same
    batches and draws, update for update: parameters, Adam states and
    the averaged metrics equal (the split as a tensor or as numpy)."""
    steps, n_data = 5, 9
    rng = np.random.default_rng(3)
    data = _rand(rng, n_data, tiny["n"], 3)
    idx = rng.integers(0, n_data, size=(steps, B)).astype(np.int32)
    draws = _draws_from_key(tiny, jax.random.PRNGKey(4))
    sids = 11 + np.arange(steps)
    weights = LossWeights(**WEIGHTS)

    model_a = _model(tiny)
    opt_a = coupled_adam(model_a.parameters(), 1e-3, 1e-4)
    step = make_train_step(model_a, weights, opt_a, B)
    ms = []
    for t, s in enumerate(sids):
        region, eps = draws(int(s), B * B)
        ms.append(step(torch.from_numpy(data[idx[t]]), region_idx=region,
                       eps=eps))

    model_b = _model(tiny)
    opt_b = coupled_adam(model_b.parameters(), 1e-3, 1e-4)
    epoch = make_scanned_train_step(model_b, weights, opt_b, B, draws=draws)
    got = epoch(data if from_numpy else torch.from_numpy(data), idx, sids)
    assert got == _eager_sums(ms)
    for a, b in zip(_state(model_a, opt_a), _state(model_b, opt_b)):
        np.testing.assert_array_equal(a, b)


def test_scanned_epochs_match_jax(tiny):
    """make_scanned_train_epochs (E epochs and their validation in one
    call) against JAX's: per-epoch train and validation metrics, final
    parameters."""
    rng = np.random.default_rng(5)
    e_n, st, sv = 2, 3, 2
    tr_x, va_x = _rand(rng, 9, tiny["n"], 3), _rand(rng, 6, tiny["n"], 3)
    tr_idx = rng.integers(0, 9, size=(e_n, st, B)).astype(np.int32)
    va_idx = rng.integers(0, 6, size=(e_n, sv, B)).astype(np.int32)
    per = st + sv
    e_ar = np.arange(e_n)[:, None]
    tr_sid = (1 + e_ar * per + np.arange(st)[None]).astype(np.int32)
    va_sid = (1 + e_ar * per + st + np.arange(sv)[None]).astype(np.int32)
    key = jax.random.PRNGKey(17)
    opt = jax_adam(1e-2, 0.0)
    j_fn = jtrainer.make_scanned_train_epochs(
        tiny["cfg_j"], JWeights(**WEIGHTS), opt, batch_size=B)
    state = jtrainer.create_train_state(
        jax.tree.map(jnp.copy, tiny["params"]), opt)
    state, tr_j, va_j = j_fn(state, tiny["geom_j"], jnp.asarray(tr_x),
                             jnp.asarray(va_x), jnp.asarray(tr_idx),
                             jnp.asarray(tr_sid), jnp.asarray(va_idx),
                             jnp.asarray(va_sid), None, None, None, key)
    model = _model(tiny)
    fn = make_scanned_train_epochs(
        model, LossWeights(**WEIGHTS),
        coupled_adam(model.parameters(), 1e-2, 0.0), B,
        draws=_draws_from_key(tiny, key))
    tr_t, va_t = fn(torch.from_numpy(tr_x), torch.from_numpy(va_x), tr_idx,
                    tr_sid, va_idx, va_sid)
    for e in range(e_n):
        for got, want in ((tr_t[e], tr_j), (va_t[e], va_j)):
            for k in LOSS_KEYS:
                np.testing.assert_allclose(got[k], float(want[k][e]),
                                           rtol=TRACK_RTOL, atol=1e-7,
                                           err_msg=f"epoch {e} {k}")
    after = params_from_jax(jax.tree.map(np.asarray, state.params))
    for name, p in model.state_dict().items():
        assert max_rel(p.numpy(), after[name].numpy()) <= TRACK_RTOL, name


def test_scanned_epochs_equal_sequential_steps(tiny):
    """The multi-epoch call against the port's eager train and eval steps
    in the same order with the same draws: everything equal."""
    rng = np.random.default_rng(8)
    e_n, st, sv = 2, 2, 2
    tr_x, va_x = _rand(rng, 8, tiny["n"], 3), _rand(rng, 5, tiny["n"], 3)
    tr_idx = rng.integers(0, 8, size=(e_n, st, B)).astype(np.int32)
    va_idx = rng.integers(0, 5, size=(e_n, sv, B)).astype(np.int32)
    tr_sid = (1 + np.arange(e_n * st).reshape(e_n, st) * 2).astype(np.int32)
    va_sid = tr_sid + 1
    draws = _draws_from_key(tiny, jax.random.PRNGKey(9))
    weights = LossWeights(**WEIGHTS)

    model_a = _model(tiny)
    opt_a = coupled_adam(model_a.parameters(), 1e-2, 0.0)
    step = make_train_step(model_a, weights, opt_a, B)
    estep = make_eval_step(model_a, weights, B)
    want_tr, want_va = [], []
    for e in range(e_n):
        ms = []
        for t in range(st):
            region, eps = draws(int(tr_sid[e, t]), B * B)
            ms.append(step(torch.from_numpy(tr_x[tr_idx[e, t]]),
                           region_idx=region, eps=eps))
        want_tr.append(_eager_sums(ms))
        ms = [estep(torch.from_numpy(va_x[va_idx[e, t]]),
                    region_idx=draws(int(va_sid[e, t]), B * B)[0])
              for t in range(sv)]
        want_va.append(_eager_sums(ms))

    model_b = _model(tiny)
    opt_b = coupled_adam(model_b.parameters(), 1e-2, 0.0)
    fn = make_scanned_train_epochs(model_b, weights, opt_b, B, draws=draws)
    got_tr, got_va = fn(torch.from_numpy(tr_x), torch.from_numpy(va_x),
                        tr_idx, tr_sid, va_idx, va_sid)
    assert got_tr == want_tr and got_va == want_va
    for a, b in zip(_state(model_a, opt_a), _state(model_b, opt_b)):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ the manager
@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("scan"))
    config = make_workspace(root)
    jm = JManager(config, config["data"]["precomputed_path"])
    tm = ModelManager(config, config["data"]["precomputed_path"],
                      device="cpu")
    train, val, _, _, weights = tdataset.build_datasets(config, tm.template)
    jm.set_class_conversions_and_weights(weights)
    tm.set_class_conversions_and_weights(weights)
    return dict(root=root, config=config, jm=jm, tm=tm, train=train,
                val=val, weights=weights)


def _iters(mod, ws, seeds=(3, 4), **kw):
    c2i = ws["jm"]._class2idx_dict
    extra = {"device": "cpu"} if mod is tdataset else {}
    return tuple(mod.DeviceBatchIterator(ws[split], 2, shuffle=True,
                                         seed=seed, class2idx=c2i,
                                         **extra, **kw)
                 for split, seed in zip(("train", "val"), seeds))


@pytest.mark.parametrize("with_labels", [False, True])
def test_assemble_epoch_plans_matches_jax(ws, with_labels):
    """The same index arrays, step ids, labels and next counter from
    identically seeded iterators."""
    got, n_t = assemble_epoch_plans(*_iters(tdataset, ws), 3,
                                    step_counter=5, with_labels=with_labels)
    want, n_j = jtrainer.assemble_epoch_plans(*_iters(jdataset, ws), 3,
                                              step_counter=5,
                                              with_labels=with_labels)
    assert n_t == n_j
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))
    for g, w in zip(got[2:], want[2:]):
        assert (g is None) == (w is None)
        if w is not None:
            assert g.dtype == np.asarray(w).dtype
            np.testing.assert_array_equal(g, np.asarray(w))
    assert (got[6] is not None) == with_labels


def _no_plan(it):
    """An iterator of the same batches without an ``epoch_plan``."""
    return type("Plain", (), {"__iter__": lambda self: iter(it),
                              "__len__": lambda self: len(it),
                              "batch_size": it.batch_size,
                              "drop_last": it.drop_last})()


def _single(arrays):
    """A split of one mesh: no batch of 2 under drop_last."""
    return tdataset.MeshArrays(arrays.x[:1], arrays.y[:1], arrays.age[:1],
                               arrays.gender[:1], arrays.augmented[:1],
                               arrays.names[:1])


@pytest.mark.parametrize("case,expected", [
    ("device", True), ("host", True), ("train_keeps_last", False),
    ("val_keeps_last", False), ("batch_mismatch", False),
    ("empty_split", False), ("no_plan", False)])
def test_can_scan_epochs_matches_jax(ws, case, expected):
    got = []
    for mod, mgr in ((tdataset, ws["tm"]), (jdataset, ws["jm"])):
        kw = {"device": "cpu"} if mod is tdataset else {}
        tr, va = ws["train"], ws["val"]
        make, bs, dl = mod.DeviceBatchIterator, [2, 2], [True, True]
        if case == "host":
            make, kw = mod.BatchIterator, {}
        elif case == "train_keeps_last":
            dl[0] = False
        elif case == "val_keeps_last":
            dl[1] = False
        elif case == "batch_mismatch":
            bs[1] = 3
        elif case == "empty_split":
            va = _single(va)
        its = [make(a, b, drop_last=d, **kw)
               for a, b, d in zip((tr, va), bs, dl)]
        if case == "no_plan":
            its[0] = _no_plan(its[0])
        got.append(mgr.can_scan_epochs(*its))
    assert got == [expected, expected]


def _fresh_pair(ws):
    """A JAX manager and a port manager from the same weights, the port
    drawing JAX's regions and noise."""
    config = ws["config"]
    jm = JManager(config, config["data"]["precomputed_path"])
    tm = ModelManager(config, config["data"]["precomputed_path"],
                      device="cpu")
    for m in (jm, tm):
        m.set_class_conversions_and_weights(ws["weights"])
    copy_jax_state(tm, jm.state)
    tm._step_draws = jax_draws(0, len(tm.template.region_names),
                               config["model"]["latent_size"])
    return jm, tm


def test_run_epochs_scanned_matches_jax(ws):
    """The manager's multi-epoch call (train and validation steps, the
    head end to end) against JAX's on identically seeded device-resident
    iterators: per-epoch losses, the final parameters and head, the
    validation averages left in ``_losses`` and the step counter."""
    jm, tm = _fresh_pair(ws)
    tr_j, va_j = jm.run_epochs_scanned(*_iters(jdataset, ws), 2)
    tr_t, va_t = tm.run_epochs_scanned(*_iters(tdataset, ws), 2)
    for e in range(2):
        for got, want in ((tr_t[e], tr_j[e]), (va_t[e], va_j[e])):
            for k in LOSS_KEYS:
                np.testing.assert_allclose(got[k], want[k], rtol=TRACK_RTOL,
                                           atol=1e-7, err_msg=f"{e} {k}")
    assert tr_j[-1]["classification"] > 0
    assert tm._step_counter == jm._step_counter
    assert tm._losses == va_t[-1]
    after = params_from_jax(jax.tree.map(np.asarray, jm.state.params))
    for name, p in tm.model.state_dict().items():
        assert max_rel(p.numpy(), after[name].numpy()) <= TRACK_RTOL, name


def test_chunked_run_equals_sequential_run_epoch(ws):
    """The port's multi-epoch call against its own run_epoch(train) /
    run_epoch(val) pairs (a scanned train epoch and the per-step
    validation loop): update for update, the same losses."""
    _, seq = _fresh_pair(ws)
    _, chunked = _fresh_pair(ws)
    tr_c, va_c = chunked.run_epochs_scanned(*_iters(tdataset, ws), 2)
    ti, vi = _iters(tdataset, ws)
    for e in range(2):
        assert seq.run_epoch(ti, train=True) == tr_c[e]
        assert seq.run_epoch(vi, train=False) == va_c[e]
    assert seq._losses == chunked._losses
    assert seq._step_counter == chunked._step_counter
    for mgr_a, mgr_b in ((seq, chunked),):
        for a, b in zip(_state(mgr_a.model, mgr_a.optimizer),
                        _state(mgr_b.model, mgr_b.optimizer)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(_state(mgr_a.head, mgr_a.head_optimizer),
                        _state(mgr_b.head, mgr_b.head_optimizer)):
            np.testing.assert_array_equal(a, b)


def test_fit_iteration_is_cached_without_baking_q(ws):
    """Two scans whose chamfer targets pad to one size but differ in their
    true count share the cached iteration, and each fit equals a fresh
    fit of its scan (the cache emptied first)."""
    mgr = ws["tm"]
    tpl = np.asarray(mgr.template.pos, np.float32)
    lnd_idx = list(range(0, len(tpl), len(tpl) // 6))[:6]
    scans = [tpl[: len(tpl) - 2] + 0.01, tpl[: len(tpl) - 9] - 0.02]
    qs = [len(s[::4]) for s in scans]
    assert qs[0] != qs[1]
    assert len({1 << (q - 1).bit_length() for q in qs}) == 1

    def fit(scan):
        return tfitting.fit_latent(mgr, None, scan, scan[lnd_idx], lnd_idx,
                                   iterations=3, n_restarts=3, seed=1)

    tfitting._FIT_RUNS.pop(mgr, None)
    shared = [fit(s) for s in scans]
    assert len(tfitting._FIT_RUNS[mgr]) == 1
    for scan, got in zip(scans, shared):
        tfitting._FIT_RUNS.pop(mgr, None)
        want = fit(scan)
        np.testing.assert_array_equal(got["z"], want["z"])
        assert got["chamfer_mm2"] == want["chamfer_mm2"]
        assert got["best_restart"] == want["best_restart"]
    assert shared[0]["chamfer_mm2"] != shared[1]["chamfer_mm2"]


def test_fit_iteration_is_keyed_on_shapes_and_bounded(ws):
    """Fits at three learning rates share one cached iteration (the rate
    is an input of the iteration, not part of its key), and each equals a
    fresh fit at its rate; fits at more restart counts than
    FIT_RUNS_PER_MANAGER leave that many cached, the latest kept."""
    mgr = ws["tm"]
    tpl = np.asarray(mgr.template.pos, np.float32)
    lnd_idx = list(range(0, len(tpl), len(tpl) // 6))[:6]
    scan = tpl * 1.05 + 0.01

    def fit(lr=5e-3, restarts=3):
        return tfitting.fit_latent(mgr, None, scan, scan[lnd_idx], lnd_idx,
                                   lr=lr, iterations=2,
                                   n_restarts=restarts, seed=1)

    lrs = (5e-3, 2e-2, 1e-1)
    tfitting._FIT_RUNS.pop(mgr, None)
    shared = [fit(lr) for lr in lrs]
    assert len(tfitting._FIT_RUNS[mgr]) == 1
    for lr, got in zip(lrs, shared):
        tfitting._FIT_RUNS.pop(mgr, None)
        want = fit(lr)
        np.testing.assert_array_equal(got["z"], want["z"])
        assert got["chamfer_mm2"] == want["chamfer_mm2"]
    assert len({r["chamfer_mm2"] for r in shared}) == len(lrs)
    bound = tfitting.FIT_RUNS_PER_MANAGER
    for restarts in range(1, bound + 3):
        fit(restarts=restarts)
        assert len(tfitting._FIT_RUNS[mgr]) <= bound
    kept = [key[0] for key in tfitting._FIT_RUNS[mgr]]
    assert kept == list(range(3, bound + 3))


# ------------------------------------------------------------ entry point
@pytest.fixture(scope="module")
def entry_runs(tmp_path_factory):
    """``train.main`` on the CPU twice from one workspace: chunked (two
    epochs, cadences 2: one chunk) and with ``--profile`` (the per-epoch
    loop, its second epoch traced). The traversals at each checkpoint
    render small: the images are not tested here."""
    from tests.test_torch_tester import small_tester_renders

    root = str(tmp_path_factory.mktemp("entry"))
    cfg_path = os.path.join(root, "run.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(make_workspace(root), f)
    argv = ["--config", cfg_path, "--output_path", root, "--device", "cpu"]
    with small_tester_renders():
        chunked = ttrain.main(argv + ["--id", "chunked"])
        stepped = ttrain.main(argv + ["--id", "stepped", "--profile"])
    return chunked, stepped


def test_train_main_chunks_equal_the_per_epoch_loop(entry_runs):
    """The chunked run's checkpoint and per-epoch losses equal the
    per-epoch loop's."""
    chunked, stepped = entry_runs
    for name in ("model_00000002.ckpt", "optimizer.ckpt"):
        a = read_checkpoint(os.path.join(chunked["checkpoint_dir"], name))
        b = read_checkpoint(os.path.join(stepped["checkpoint_dir"], name))
        flat_a = jax.tree_util.tree_leaves(a)
        flat_b = jax.tree_util.tree_leaves(b)
        assert len(flat_a) == len(flat_b)
        for x, y in zip(flat_a, flat_b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    for h_c, h_s in zip(chunked["history"], stepped["history"]):
        assert h_c["train"] == h_s["train"]
        assert h_c["validation"] == h_s["validation"]
    assert [h["epoch"] for h in chunked["history"]] == [1, 2]


def test_train_main_profile_writes_a_trace(entry_runs):
    _, stepped = entry_runs
    path = os.path.join(stepped["output_dir"], "profile", "trace.json")
    with open(path) as f:
        trace = json.load(f)
    assert trace["traceEvents"]

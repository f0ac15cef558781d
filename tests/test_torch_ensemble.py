"""The port's deep ensembles (``training/ensemble.py``,
``train_ensemble.py``, ``serving.EnsembleService`` and ``serve.py`` on an
ensemble dir) against the JAX package's, on the CPU.

Member i against JAX's ``make_ensemble_scanned_epochs`` on
``_tiny_geometry``: JAX's member weights are carried across, and member
i's region and noise are recomputed from JAX's per-member key schedule
(``fold_in(PRNGKey(base + i + 1), step_id)``) and injected; parameters
and per-member metrics within ``TRACK_RTOL`` (1e-4 over Adam steps, as
in ``test_torch_scan.py``). Against the port's own solo runs
(``ModelManager(seed=base + i)`` over the same plans) the arithmetic is
the same, so parameters, Adam states and metrics are held bit-equal.
The ensemble dirs of both packages' trainers are served by both
packages; posteriors within 1e-4."""

import json
import os
import subprocess
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp
from craniofacialsd_vae_tpu.manager import ModelManager as JManager
from craniofacialsd_vae_tpu.serving import EnsembleService as JEnsemble
from craniofacialsd_vae_tpu.training import LossWeights as JWeights
from craniofacialsd_vae_tpu.training import coupled_adam as jax_adam
from craniofacialsd_vae_tpu.training import ensemble as jens
from craniofacialsd_vae_tpu.utils import get_config as jget_config
from craniofacialsd_vae_tpu_torch import sweep as tsweep
from craniofacialsd_vae_tpu_torch import train_ensemble as tens
from craniofacialsd_vae_tpu_torch.analysis.uncertainty import \
    summarize_ensemble
from craniofacialsd_vae_tpu_torch.data.dataset import (DeviceBatchIterator,
                                                       build_datasets)
from craniofacialsd_vae_tpu_torch.manager import ModelManager
from craniofacialsd_vae_tpu_torch.models import (SDVAE, SDVAEConfig,
                                                 init_mlp, params_from_jax)
from craniofacialsd_vae_tpu_torch.serving import (DiagnosisService,
                                                  EnsembleService)
from craniofacialsd_vae_tpu_torch.training import (LOSS_KEYS, LossWeights,
                                                   assemble_epoch_plans,
                                                   coupled_adam)
from craniofacialsd_vae_tpu_torch.training.ensemble import (
    EnsembleState, MemberState, ensemble_epoch_keys, init_ensemble_state,
    make_ensemble_scanned_epochs, make_ensemble_scanned_step, member_state,
    n_members)
from tests.test_torch_manager import make_workspace, max_rel
from tests.test_torch_scan import _draws_from_key, _state
# tiny: the fixture, imported so that pytest finds it here
from tests.test_torch_training import B, WEIGHTS, Z, tiny  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACK_RTOL = 1e-4
POSTERIOR_ATOL = 1e-4
BASE = 3
N_EPOCHS = 2


def _rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _plan(rng, n, e_n=N_EPOCHS, st=3, sv=2):
    tr_x, va_x = _rand(rng, 9, n, 3), _rand(rng, 6, n, 3)
    tr_idx = rng.integers(0, 9, size=(e_n, st, B)).astype(np.int32)
    va_idx = rng.integers(0, 6, size=(e_n, sv, B)).astype(np.int32)
    per = st + sv
    e_ar = np.arange(e_n)[:, None]
    tr_sid = (1 + e_ar * per + np.arange(st)[None]).astype(np.int32)
    va_sid = (1 + e_ar * per + st + np.arange(sv)[None]).astype(np.int32)
    return tr_x, va_x, tr_idx, tr_sid, va_idx, va_sid


# ------------------------------------------- member i against JAX's, tiny
@pytest.fixture(scope="module")
def jax_vs_port(tiny):  # noqa: F811
    """JAX's 2-member ensemble over two epochs, and the port's from JAX's
    member weights with JAX's per-member draws."""
    plan = _plan(np.random.default_rng(2), tiny["n"])
    opt = jax_adam(1e-3, 1e-4)
    state = jens.init_ensemble_state(tiny["cfg_j"], tiny["geom_j"], opt, 2,
                                     base_seed=BASE)
    init = [jax.tree.map(lambda leaf, i=i: np.asarray(leaf[i]), state.params)
            for i in range(2)]
    fn = jens.make_ensemble_scanned_epochs(tiny["cfg_j"], JWeights(**WEIGHTS),
                                           opt, batch_size=B)
    state, tr_j, va_j = fn(state, tiny["geom_j"],
                           *[jnp.asarray(a) for a in plan], None, None, None,
                           jens.ensemble_epoch_keys(2, base_seed=BASE))
    members = []
    for p in init:
        model = SDVAE(SDVAEConfig(out_channels=(8, 16), latent_size=Z),
                      tiny["geom_t"])
        model.load_state_dict(params_from_jax(p))
        members.append(MemberState(model, coupled_adam(model.parameters(),
                                                       1e-3, 1e-4)))
    ens = EnsembleState(members)
    draws = [_draws_from_key(tiny, jax.random.PRNGKey(BASE + i + 1))
             for i in range(2)]
    tr_t, va_t = make_ensemble_scanned_epochs(
        ens, LossWeights(**WEIGHTS), B, draws=draws)(
        *[torch.from_numpy(a) if a.dtype == np.float32 else a
          for a in plan])
    return dict(state=state, tr_j=jax.device_get(tr_j),
                va_j=jax.device_get(va_j), ens=ens, tr_t=tr_t, va_t=va_t)


@pytest.mark.parametrize("i", [0, 1])
def test_member_tracks_jax_ensemble(jax_vs_port, i):
    """Member i's per-epoch train and validation metrics and its final
    parameters within TRACK_RTOL of JAX's member i."""
    r = jax_vs_port
    for e in range(N_EPOCHS):
        for got, want in ((r["tr_t"][i][e], r["tr_j"]),
                          (r["va_t"][i][e], r["va_j"])):
            for k in LOSS_KEYS:
                np.testing.assert_allclose(got[k], float(want[k][i][e]),
                                           rtol=TRACK_RTOL, atol=1e-7,
                                           err_msg=f"member {i} epoch {e} {k}")
    after = params_from_jax(jax.tree.map(
        np.asarray, jens.member_state(r["state"], i).params))
    for name, p in r["ens"].members[i].model.state_dict().items():
        assert max_rel(p.numpy(), after[name].numpy()) <= TRACK_RTOL, name


def test_ensemble_scanned_step_equals_one_epoch_of_the_epochs(tiny):  # noqa: F811,E501
    """make_ensemble_scanned_step's members: the train halves of a
    one-epoch make_ensemble_scanned_epochs call from the same state,
    bit for bit; the members differ."""
    tr_x, va_x, tr_idx, tr_sid, va_idx, va_sid = _plan(
        np.random.default_rng(4), tiny["n"], e_n=1)
    runs = []
    for epochs in (False, True):
        state = init_ensemble_state(
            SDVAEConfig(out_channels=(8, 16), latent_size=Z),
            tiny["geom_t"], 2, BASE,
            optimizer=lambda p: coupled_adam(p, 1e-3, 0.0))
        draws = [_draws_from_key(tiny, jax.random.PRNGKey(s))
                 for s in (5, 6)]
        if epochs:
            got = [m[0] for m in make_ensemble_scanned_epochs(
                state, LossWeights(**WEIGHTS), B, draws=draws)(
                torch.from_numpy(tr_x), torch.from_numpy(va_x), tr_idx,
                tr_sid, va_idx, va_sid)[0]]
        else:
            got = make_ensemble_scanned_step(
                state, LossWeights(**WEIGHTS), B, draws=draws)(
                torch.from_numpy(tr_x), tr_idx[0], tr_sid[0])
        runs.append((got, [_state(m.model, m.optimizer)
                           for m in state.members]))
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert runs[0][0][0] != runs[0][0][1]


def test_member_state_bounds(tiny):  # noqa: F811
    cfg = SDVAEConfig(out_channels=(8, 16), latent_size=Z)
    state = init_ensemble_state(cfg, tiny["geom_t"], 2,
                                optimizer=lambda p: coupled_adam(p, 1e-3, 0))
    assert n_members(state) == 2
    assert member_state(state, 1) is state.members[1]
    with pytest.raises(IndexError):
        member_state(state, 2)
    with pytest.raises(IndexError):
        member_state(state, -1)
    with pytest.raises(ValueError):
        init_ensemble_state(cfg, tiny["geom_t"], 0,
                            optimizer=lambda p: coupled_adam(p, 1e-3, 0))


# ------------------------------------ member i against the port's solo run
def _solo(config, seed, epochs):
    """``ModelManager(seed=seed)``'s scanned run over fresh iterators (the
    entry point's plans)."""
    mgr = ModelManager(config, config["data"]["precomputed_path"],
                       seed=seed, device="cpu")
    train_set, val_set, _, _, weights = build_datasets(config, mgr.template,
                                                       device="cpu")
    mgr.set_class_conversions_and_weights(weights)
    its = [DeviceBatchIterator(s, mgr.batch_size, shuffle=True,
                               class2idx=mgr._class2idx_dict, device="cpu")
           for s in (train_set, val_set)]
    tr, va = mgr.run_epochs_scanned(*its, epochs)
    return mgr, tr, va


def test_members_with_heads_equal_solo_runs(tmp_path):
    """With an end-to-end head (labels, class weights and the head's own
    Adam), members BASE and BASE + 1 of make_ensemble_scanned_epochs over
    the manager's plans: bit-equal to ModelManager(seed=BASE + i)'s
    scanned runs (parameters, Adam states, heads, metrics)."""
    config = make_workspace(str(tmp_path))
    solos = [_solo(config, BASE + i, N_EPOCHS) for i in range(2)]
    mgr = ModelManager(config, config["data"]["precomputed_path"],
                       seed=BASE, device="cpu")
    train_set, val_set, _, _, weights = build_datasets(config, mgr.template,
                                                       device="cpu")
    mgr.set_class_conversions_and_weights(weights)
    its = [DeviceBatchIterator(s, mgr.batch_size, shuffle=True,
                               class2idx=mgr._class2idx_dict, device="cpu")
           for s in (train_set, val_set)]
    clf = config["classifier"]
    state = init_ensemble_state(
        mgr.net_config, mgr.geometry, 2, BASE,
        optimizer=lambda p: coupled_adam(p, 1e-3, 0.0),
        head_init=lambda g: init_mlp(Z, clf["mlp_hidden_features"], 3, g),
        head_optimizer=lambda p: coupled_adam(p, clf["mlp_lr"], 0.0))
    fn = make_ensemble_scanned_epochs(
        state, mgr.loss_weights, mgr.batch_size,
        draws=ensemble_epoch_keys(2, BASE, mgr.n_regions, Z))
    plan, _ = assemble_epoch_plans(*its, N_EPOCHS, with_labels=True)
    tr, va = fn(*plan, class_weights=mgr._class_weights)
    for i, (solo, s_tr, s_va) in enumerate(solos):
        assert tr[i] == s_tr and va[i] == s_va, f"member {i} metrics"
        assert s_tr[-1]["classification"] > 0
        m = state.members[i]
        for got, want in ((_state(m.model, m.optimizer),
                           _state(solo.model, solo.optimizer)),
                          (_state(m.head, m.head_optimizer),
                           _state(solo.head, solo.head_optimizer))):
            assert len(got) == len(want)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)


# ----------------------------------------------------- the entry points
def _write_config(root, **kw):
    config = make_workspace(root, mlp_training_type="after", **kw)
    path = os.path.join(root, "config.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    return config, path


@pytest.fixture(scope="module")
def port_ens(tmp_path_factory):
    """train_ensemble.main on the CPU: 2 members × 2 epochs, seeds from
    1."""
    root = str(tmp_path_factory.mktemp("port_ens"))
    config, path = _write_config(root)
    res = tens.main(["--config", path, "--id", "ens", "--output_path", root,
                     "--members", "2", "--seed", "1", "--epochs", "2",
                     "--chunk_epochs", "2", "--device", "cpu"])
    return dict(res, root=root, config=config, config_path=path)


@pytest.fixture(scope="module")
def jax_ens(tmp_path_factory):
    """tools/train_ensemble.py (the JAX package's) on the same kind of
    workspace, as a subprocess on the CPU."""
    root = str(tmp_path_factory.mktemp("jax_ens"))
    config, path = _write_config(root)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "tools/train_ensemble.py", "--config", path,
         "--id", "jens", "--output_path", root, "--members", "2",
         "--epochs", "2", "--chunk_epochs", "2", "--platform", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return dict(root=root, run_dir=os.path.join(root, "outputs", "jens"),
                config=config)


def test_entry_point_members_equal_solo_runs(port_ens):
    """Each member of the entry point's run: bit-equal to
    ModelManager(seed=1 + i)'s scanned run over the same plans, and its
    manifest's val_tot that run's last validation tot."""
    manifest = port_ens["manifest"]
    for i in range(2):
        solo, s_tr, s_va = _solo(port_ens["config"], 1 + i, 2)
        chunk = port_ens["chunks"][0]
        assert chunk["train"][i] == s_tr and chunk["validation"][i] == s_va
        assert manifest["members"][i]["val_tot"] == s_va[-1]["tot"]
        m = member_state(port_ens["state"], i)
        for a, b in zip(_state(m.model, m.optimizer),
                        _state(solo.model, solo.optimizer)):
            np.testing.assert_array_equal(a, b)


def test_entry_point_layout_equals_jax_tool(port_ens, jax_ens):
    """The run dir's files and the manifest's keys are the JAX tool's."""
    port = port_ens["output_dir"]
    jax_dir = jax_ens["run_dir"]
    assert sorted(os.listdir(port)) == sorted(os.listdir(jax_dir))
    for d in ("member_00", "member_01"):
        assert sorted(os.listdir(os.path.join(port, d))) == \
            sorted(os.listdir(os.path.join(jax_dir, d)))
        assert sorted(os.listdir(os.path.join(port, d, "checkpoints"))) == \
            sorted(os.listdir(os.path.join(jax_dir, d, "checkpoints")))
    with open(os.path.join(port, "ensemble.json")) as f:
        mp = json.load(f)
    with open(os.path.join(jax_dir, "ensemble.json")) as f:
        mj = json.load(f)
    assert set(mp) == set(mj)
    for a, b in zip(mp["members"], mj["members"]):
        assert set(a) == set(b)
        assert a["dir"] == b["dir"]
        assert set(a["val_accuracy"]) == set(b["val_accuracy"])
    assert mp["seeds"] == [1, 2] and mj["seeds"] == [0, 1]
    assert mp["epochs"] == mj["epochs"] == 2


def test_port_member_resumes_in_jax(port_ens):
    """A port-written member dir resumes in JAX's ModelManager (what its
    train.py --resume calls): the epoch, and the weights bit for bit."""
    mdir = os.path.join(port_ens["output_dir"], "member_01")
    config = jget_config(os.path.join(mdir, "config.yaml"))
    jm = JManager(config, config["data"]["precomputed_path"])
    assert jm.resume(os.path.join(mdir, "checkpoints")) == 2
    want = params_from_jax(jax.tree.map(np.asarray, jm.state.params))
    m = member_state(port_ens["state"], 1)
    for name, p in m.model.state_dict().items():
        np.testing.assert_array_equal(p.numpy(), want[name].numpy())


def _probes(template_pos, n=3, seed=0):
    rng = np.random.default_rng(seed)
    tpl = np.asarray(template_pos, np.float32)
    return np.stack([tpl + rng.normal(scale=0.02, size=tpl.shape)
                     for _ in range(n)]).astype(np.float32)


def _same_consensus(got: list, want: list) -> None:
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for key in ("label", "member_agreement", "member_votes",
                    "n_members"):
            assert a[key] == b[key], key
        for key in ("posterior_mean", "posterior_std"):
            assert set(a[key]) == set(b[key])
            for c, v in b[key].items():
                assert a[key][c] == pytest.approx(v, abs=POSTERIOR_ATOL)
        assert [m["label"] for m in a["members"]] == \
            [m["label"] for m in b["members"]]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_ensemble_service_matches_jax(jax_ens, port_ens, writer):
    """Each package's EnsembleService on each package's ensemble dir:
    labels, agreement and votes equal, posteriors within 1e-4."""
    run_dir = jax_ens["run_dir"] if writer == "jax" \
        else port_ens["output_dir"]
    ts = EnsembleService.from_ensemble_dir(run_dir, max_batch=4,
                                           device="cpu")
    js = JEnsemble.from_ensemble_dir(run_dir, max_batch=4)
    raw = _probes(ts.services[0].manager.template.pos)
    _same_consensus(ts.diagnose(raw), js.diagnose(raw))
    one = ts.diagnose(raw[0])
    assert isinstance(one, dict)
    _same_consensus([one], [js.diagnose(raw[0])])


@pytest.fixture(scope="module")
def port_service(port_ens):
    return EnsembleService.from_ensemble_dir(port_ens["output_dir"],
                                             max_batch=4, device="cpu")


def test_consensus_is_summarize_ensemble(port_service):
    """The consensus equals summarize_ensemble over the member services'
    own reports; the member blocks carry no latent; posterior sampling
    rides each member; stats sum the members."""
    svc = port_service
    assert svc.n_members == 2 and svc.buckets == [1, 2, 4]
    raw = _probes(svc.services[0].manager.template.pos)
    got = svc.diagnose(raw)
    want = summarize_ensemble([s.diagnose(raw) for s in svc.services])
    for row, exp in zip(got, want):
        for key, v in exp.items():
            assert row[key] == v, key
        assert len(row["members"]) == 2
        for block in row["members"]:
            assert "label" in block and "posteriors" in block
            assert "latent" not in block
    unc = svc.diagnose(raw[:1], n_samples=4, seed=1)
    block = unc[0]["members"][0]["uncertainty"]
    assert sum(block["sample_votes"].values()) == 4
    stats = svc.stats()
    assert stats["n_members"] == 2 and stats["requests"] >= 4


def test_ensemble_service_refusals(port_ens, port_service):
    """The JAX tests' rejection cases: not an ensemble dir, no members,
    members that disagree; the single-model requests; and
    DiagnosisService.from_run_dir on an ensemble dir points at
    EnsembleService."""
    run_dir = port_ens["output_dir"]
    with pytest.raises(FileNotFoundError, match="ensemble.json"):
        EnsembleService.from_ensemble_dir(os.path.join(run_dir, "member_00"),
                                          device="cpu")
    with pytest.raises(ValueError, match="at least one"):
        EnsembleService([])
    a, b = port_service.services
    assert EnsembleService([a, a]).n_members == 2
    other = DiagnosisService.from_run_dir(
        os.path.join(run_dir, "member_01"), max_batch=4, device="cpu")
    other.manager.set_class_conversions({"a": 0, "n": 1, "c": 2})
    with pytest.raises(ValueError, match="disagree"):
        EnsembleService([a, other])
    raw = _probes(a.manager.template.pos, n=1)
    for name in ("encode", "decode", "reconstruct", "saliency", "plan",
                 "fit", "diagnose_latent", "diagnose_latents"):
        with pytest.raises(ValueError, match="single-model"):
            getattr(port_service, name)(raw)
    with pytest.raises(AttributeError):
        port_service.not_a_request
    with pytest.raises(ValueError, match="from_ensemble_dir"):
        DiagnosisService.from_run_dir(run_dir, device="cpu")


def test_serve_entry_point_on_an_ensemble_dir(port_ens, port_service):
    """``python -m craniofacialsd_vae_tpu_torch.serve`` on an ensemble
    dir: /healthz with n_members, /diagnose the consensus, 400 on a
    single-model endpoint."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "craniofacialsd_vae_tpu_torch.serve",
         "--run_dir", port_ens["output_dir"], "--port", "0", "--max_batch",
         "4", "--device", "cpu", "--no_warmup"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        url = None
        for _ in range(600):
            line = proc.stdout.readline()
            if "serving" in line and "http://" in line:
                url = line.split()[3]
                break
            assert proc.poll() is None, "the server exited at startup"
        assert url, "no startup line"
        h = json.loads(urllib.request.urlopen(url + "/healthz",
                                              timeout=60).read())
        assert h["ok"] and h["n_members"] == 2
        raw = _probes(port_service.services[0].manager.template.pos, n=1)
        body = json.dumps({"vertices": raw[0].tolist()}).encode()
        req = urllib.request.Request(
            url + "/diagnose", data=body,
            headers={"Content-Type": "application/json"})
        rep = json.loads(urllib.request.urlopen(req, timeout=120).read())[
            "reports"]
        assert rep["n_members"] == 2 and len(rep["members"]) == 2
        assert rep["label"] == port_service.diagnose(raw[0])["label"]
        req = urllib.request.Request(
            url + "/encode", data=body,
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=60)
        assert err.value.code == 400
        assert "single-model" in err.value.read().decode()
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_entry_points_default_to_the_card(tmp_path):
    """Without ``--device`` the ensemble and sweep entry points take the
    card, and raise where there is none, before writing anything."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    argv = ["--config", "configurations/smoke.yaml", "--id", "x",
            "--output_path", str(tmp_path)]
    for main, extra in ((tens.main, []), (tsweep.main, ["--vary", "lr=1"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv + extra)
    assert not os.path.exists(tmp_path / "outputs")

"""The member mesh of the port's ensembles and sweeps
(``parallel.make_member_mesh``, ``shard_member_axis``; the entry points'
``--shard_members``) on the CPU.

Members share nothing, so a sharded state runs each block of members in
its device's own graph (its own replayer on the host) with the same
bodies: sharded equals unsharded bit for bit. The host's CPU named twice
stands for two devices, as in the data-parallel serving tests. K that
does not tile the mesh is refused with JAX's ``ValueError``."""

import os

import numpy as np
import pytest
import torch
import yaml

from craniofacialsd_vae_tpu_torch import parallel
from craniofacialsd_vae_tpu_torch import sweep as tsweep
from craniofacialsd_vae_tpu_torch import train_ensemble as tens
from craniofacialsd_vae_tpu_torch.models import SDVAEConfig
from craniofacialsd_vae_tpu_torch.training import LossWeights, coupled_adam
from craniofacialsd_vae_tpu_torch.training.ensemble import (
    init_ensemble_state, make_ensemble_scanned_epochs, member_state)
from craniofacialsd_vae_tpu_torch.training.sweep import (
    build_variants, init_sweep_state, make_sweep_scanned_epochs,
    stack_hyperparams)
from tests.test_torch_ensemble import _plan
from tests.test_torch_manager import make_workspace
from tests.test_torch_scan import _draws_from_key, _state
from tests.test_torch_sweep import BASE
# tiny: the fixture, imported so that pytest finds it here
from tests.test_torch_training import B, WEIGHTS, Z, tiny  # noqa: F401

import jax

K = 4
CPU2 = ["cpu", "cpu"]


def _run(tiny, kind, mesh):  # noqa: F811
    """A K-member ensemble or a K-variant sweep over the same plan,
    sharded over ``mesh`` where given: (metrics, each member's state)."""
    plan = _plan(np.random.default_rng(9), tiny["n"])
    host = [torch.from_numpy(a) if a.dtype == np.float32 else a
            for a in plan]
    cfg = SDVAEConfig(out_channels=(8, 16), latent_size=Z)
    if kind == "ensemble":
        state = init_ensemble_state(
            cfg, tiny["geom_t"], K, 2,
            optimizer=lambda p: coupled_adam(p, 1e-3, 1e-4))
        draws = [_draws_from_key(tiny, jax.random.PRNGKey(10 + i))
                 for i in range(K)]
    else:
        hp = stack_hyperparams(build_variants(
            BASE, [{"lr": lr, "weight_decay": wd, "laplacian_weight": lw}
                   for lr, wd, lw in ((1e-3, 0, 0.1), (3e-3, 1e-3, 0.1),
                                      (1e-3, 1e-3, 0.0), (5e-4, 0, 0.2))]))
        state = init_sweep_state(cfg, tiny["geom_t"], K, 1, hyperparams=hp)
        draws = _draws_from_key(tiny, jax.random.PRNGKey(7))
    if mesh is not None:
        state = parallel.shard_member_axis(mesh, state)
        assert state.blocks == [(torch.device("cpu"), [0, 1]),
                                (torch.device("cpu"), [2, 3])]
    if kind == "ensemble":
        fn = make_ensemble_scanned_epochs(state, LossWeights(**WEIGHTS), B,
                                          draws=draws)
    else:
        fn = make_sweep_scanned_epochs(state, hp, B, draws=draws)
    assert len(fn.steps) == (1 if mesh is None else 2)
    metrics = fn(*host)
    return metrics, [_state(m.model, m.optimizer) for m in state.members]


@pytest.mark.parametrize("kind", ["ensemble", "sweep"])
def test_sharded_equals_unsharded(tiny, kind):  # noqa: F811
    """Two blocks of two over the CPU named twice against one block of
    four: every member's parameters, Adam states and metrics bit-equal."""
    mesh = parallel.make_member_mesh(devices=CPU2)
    assert mesh.axis == parallel.MEMBER_AXIS == "member"
    (m_a, s_a), (m_b, s_b) = _run(tiny, kind, None), _run(tiny, kind, mesh)
    assert m_a == m_b
    for a, b in zip(s_a, s_b):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_shard_member_axis_divisibility_error(tiny):  # noqa: F811
    """K that is not a multiple of the mesh's size: JAX's ValueError, and
    one for what has no member axis; a trimmed mesh takes it."""
    mesh = parallel.make_member_mesh(devices=CPU2)
    state = init_ensemble_state(
        SDVAEConfig(out_channels=(8, 16), latent_size=Z), tiny["geom_t"], 3,
        optimizer=lambda p: coupled_adam(p, 1e-3, 0.0))
    with pytest.raises(ValueError, match="multiple of the mesh size"):
        parallel.shard_member_axis(mesh, state)
    for tree in ([1, 2], torch.zeros(4)):
        with pytest.raises(ValueError, match="no member axis"):
            parallel.shard_member_axis(mesh, tree)
    small = parallel.make_member_mesh(1, devices=CPU2)
    out = parallel.shard_member_axis(small, state)
    assert out.blocks == [(torch.device("cpu"), [0, 1, 2])]
    assert member_state(out, 2) is state.members[2]
    assert state.blocks is None


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the "
                    "behaviour without a card")
def test_member_mesh_defaults_to_the_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parallel.make_member_mesh()


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("members"))
    config = make_workspace(root, mlp_training_type="after")
    path = os.path.join(root, "config.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    return root, path


@pytest.mark.parametrize("tool", ["train_ensemble", "sweep"])
def test_entry_point_shard_members_equals_unsharded(workspace, tool):
    """``--shard_members --shard_devices cpu,cpu`` against the same run
    without: the members' states and the manifests' metrics equal."""
    root, path = workspace
    main, extra = (tens.main, ["--members", "2"]) if tool == "train_ensemble"\
        else (tsweep.main, ["--vary", "lr=1e-3,3e-3"])
    runs = []
    for shard in ([], ["--shard_members", "--shard_devices", "cpu,cpu"]):
        res = main(["--config", path, "--id", f"{tool}{len(shard)}",
                    "--output_path", root, "--epochs", "2", "--device",
                    "cpu", *extra, *shard])
        assert (res["mesh"] is None) == (not shard)
        runs.append(res)
    a, b = runs
    assert a["chunks"][-1]["validation"] == b["chunks"][-1]["validation"]
    for ma, mb in zip(a["state"].members, b["state"].members):
        for x, y in zip(_state(ma.model, ma.optimizer),
                        _state(mb.model, mb.optimizer)):
            np.testing.assert_array_equal(x, y)


def test_entry_point_refuses_an_uneven_mesh(workspace):
    root, path = workspace
    with pytest.raises(SystemExit, match="multiple of the mesh size"):
        tens.main(["--config", path, "--id", "uneven", "--output_path", root,
                   "--members", "3", "--epochs", "1", "--device", "cpu",
                   "--shard_members", "--shard_devices", "cpu,cpu"])

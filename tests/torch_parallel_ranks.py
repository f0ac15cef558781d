"""Rank groups for the port's parallel tests: ``spawn`` starts ``world``
Gloo ranks on the CPU (``torch.multiprocessing``, a ``file://``
rendezvous in a test's temporary directory, one intra-op thread each),
runs one of the workers below on every rank and returns each rank's
result. The module imports no JAX: the ranks run the port alone, on
inputs the tests made (with JAX) in the parent process.

Every worker takes ``(rank, payload)`` and returns a picklable result;
arrays travel as numpy."""

from __future__ import annotations

import os
import pickle
import time
import traceback

import numpy as np

#: seconds a rank group may take, rendezvous included
GROUP_TIMEOUT_S = 240


def _entry(rank: int, worker: str, world: int, init: str | None,
           payload_path: str, out_dir: str) -> None:
    import torch

    torch.set_num_threads(1)
    from craniofacialsd_vae_tpu_torch.parallel import initialize_multihost

    with open(payload_path, "rb") as f:
        payload = pickle.load(f)
    try:
        if init is not None:
            initialize_multihost(num_processes=world, process_id=rank,
                                 device="cpu", init_method=init,
                                 timeout_s=GROUP_TIMEOUT_S)
        result = globals()[worker](rank, payload)
        err = None
    except Exception:                           # reported by the parent
        result, err = None, traceback.format_exc()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump({"result": result, "error": err}, f)
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def spawn(worker: str, world: int, tmp_dir: str, payload: dict,
          timeout_s: float = GROUP_TIMEOUT_S, group: bool = True) -> list:
    """Run ``worker`` (a function of this module, by name) on ``world``
    Gloo ranks; each rank's result, in rank order. A rank's exception or
    a group that outlasts ``timeout_s`` fails the caller. ``group=False``:
    the ranks start without a process group (the worker makes its own)."""
    import torch.multiprocessing as mp

    os.makedirs(tmp_dir, exist_ok=True)
    payload_path = os.path.join(tmp_dir, "payload.pkl")
    with open(payload_path, "wb") as f:
        pickle.dump(payload, f)
    init = "file://" + os.path.abspath(os.path.join(tmp_dir, "rendezvous")) \
        if group else None
    ctx = mp.start_processes(_entry, args=(worker, world, init, payload_path,
                                           tmp_dir),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{worker}: {world} ranks did not finish "
                                   f"within {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(5)
    out = []
    for r in range(world):
        with open(os.path.join(tmp_dir, f"rank{r}.pkl"), "rb") as f:
            got = pickle.load(f)
        if got["error"]:
            raise RuntimeError(f"{worker} rank {r}:\n{got['error']}")
        out.append(got["result"])
    return out


# ------------------------------------------------------------- helpers
def _geometry(p: dict):
    from craniofacialsd_vae_tpu_torch.geometry import load_bundle
    from craniofacialsd_vae_tpu_torch.models import SpiralGeometry

    bundle = load_bundle(p["bundle"])
    geom = SpiralGeometry.from_bundle(bundle, device="cpu",
                                      laplacian=p["laplacian"],
                                      region_masks=p["masks"])
    return bundle, geom


def _model(p: dict, geom, compute_dtype: str = "float32"):
    from craniofacialsd_vae_tpu_torch.models import (SDVAE, SDVAEConfig,
                                                     params_from_jax)

    cfg = SDVAEConfig(out_channels=tuple(p["out_channels"]),
                      latent_size=p["latent"], compute_dtype=compute_dtype)
    model = SDVAE(cfg, geom)
    model.load_state_dict(params_from_jax(p["params"]))
    return model


def _np_state(model) -> dict:
    return {k: v.detach().numpy().copy()
            for k, v in model.state_dict().items()}


def _floats(m: dict) -> dict:
    return {k: float(v) for k, v in m.items()}


def _lookup(table: dict):
    """``draws(step_id, rows)`` from a ``{step_id: (region, eps)}`` dict."""
    import torch

    def draws(step_id, rows):
        region, eps = table[int(step_id)]
        return int(region), (None if eps is None
                             else torch.from_numpy(np.asarray(eps)))

    return draws


# ------------------------------------------------- data-parallel steps
def dp_worker(rank: int, p: dict) -> dict:
    """The data-parallel step, eval step, scanned epoch and scanned epochs
    on the tiny geometry with JAX's per-rank draws."""
    import torch

    from craniofacialsd_vae_tpu_torch.parallel import (
        make_data_mesh, make_parallel_eval_step, make_parallel_train_step,
        make_scanned_parallel_epochs, make_scanned_parallel_step)
    from craniofacialsd_vae_tpu_torch.training import (LossWeights,
                                                       coupled_adam)

    _, geom = _geometry(p)
    mesh = make_data_mesh()
    weights = LossWeights(**p["weights"])
    b = p["batch"]
    out = {"mesh": (mesh.rank, mesh.world, mesh.size)}

    model = _model(p, geom)
    opt = coupled_adam(model.parameters(), p["lr"], 0.0)
    step = make_parallel_train_step(model, weights, opt, b, mesh)
    metrics = []
    for t, x in enumerate(p["step_x"]):
        region, eps = p["step_draws"][rank][t]
        metrics.append(_floats(step(torch.from_numpy(x), region_idx=region,
                                    eps=torch.from_numpy(eps))))
    out["step_metrics"] = metrics
    out["step_state"] = _np_state(model)
    ev = make_parallel_eval_step(model, weights, b, mesh)
    out["eval"] = _floats(ev(torch.from_numpy(p["eval_x"]),
                             region_idx=p["eval_region"][rank]))

    model = _model(p, geom)
    opt = coupled_adam(model.parameters(), p["lr"], 0.0)
    epoch = make_scanned_parallel_step(
        model, weights, opt, b, mesh, draws=_lookup(p["scan_draws"][rank]))
    out["scan_metrics"] = epoch(torch.from_numpy(p["data"]), p["scan_idx"],
                                p["scan_sids"])
    out["scan_state"] = _np_state(model)

    model = _model(p, geom)
    opt = coupled_adam(model.parameters(), p["lr"], 0.0)
    epochs = make_scanned_parallel_epochs(
        model, weights, opt, b, mesh, draws=_lookup(p["epochs_draws"][rank]))
    data = torch.from_numpy(p["data"])
    tr, va = epochs(data, data, p["tr_idx"], p["tr_sid"], p["va_idx"],
                    p["va_sid"])
    out["epochs_train"], out["epochs_val"] = tr, va
    out["epochs_state"] = _np_state(model)
    return out


def manager_worker(rank: int, p: dict) -> dict:
    """A data-parallel ``ModelManager``: the scanned epoch against the
    per-step path over ``MultihostBatchIterator`` (the same step ids and
    draws), ``run_epochs_scanned``, and ``train.main --data_parallel``."""
    import torch

    from craniofacialsd_vae_tpu_torch import train as ttrain
    from craniofacialsd_vae_tpu_torch.data.dataset import (
        BatchIterator, DeviceBatchIterator, build_datasets)
    from craniofacialsd_vae_tpu_torch.manager import ModelManager
    from craniofacialsd_vae_tpu_torch.parallel import (
        MultihostBatchIterator, local_batch_slice)

    config = p["config"]
    precomp = config["data"]["precomputed_path"]
    out = {}
    states = []
    for kind in ("scanned", "per_step"):
        mgr = ModelManager(config, precomp, device="cpu")
        mesh = mgr.enable_data_parallel()
        train, val, _, _, cw = build_datasets(config, mgr.template,
                                              device="cpu")
        mgr.set_class_conversions_and_weights(cw)
        g = mgr.batch_size * mesh.world
        if kind == "scanned":
            it = DeviceBatchIterator(train, g, shuffle=True, device="cpu",
                                     class2idx=mgr._class2idx_dict)
        else:
            base = BatchIterator(train, g, shuffle=True,
                                 class2idx=mgr._class2idx_dict)
            # without its plan, so that the per-step path takes it
            it = _Batches(MultihostBatchIterator(base, mesh))
            first = next(iter(MultihostBatchIterator(
                BatchIterator(train, g, shuffle=True,
                              class2idx=mgr._class2idx_dict), mesh)))
            host = next(iter(BatchIterator(train, g, shuffle=True,
                                           class2idx=mgr._class2idx_dict)))
            sl = local_batch_slice(g)
            out["slice"] = (sl.start, sl.stop)
            out["local_rows_equal"] = bool(np.array_equal(
                first["x"].numpy(), host["x"][sl]))
            out["local_labels_equal"] = bool(np.array_equal(
                first["labels"].numpy(), host["labels"][sl]))
        losses = [dict(mgr.run_epoch(it, train=True)) for _ in range(2)]
        out[kind] = losses
        states.append(_np_state(mgr.model))
        if kind == "scanned":
            tr, va = mgr.run_epochs_scanned(
                DeviceBatchIterator(train, g, shuffle=True, device="cpu",
                                    class2idx=mgr._class2idx_dict),
                DeviceBatchIterator(val, g, shuffle=True, device="cpu",
                                    class2idx=mgr._class2idx_dict,
                                    drop_last=True), 1)
            out["epochs"] = (tr, va)
    out["states_equal"] = all(np.array_equal(states[0][k], states[1][k])
                              for k in states[0])
    out["state"] = states[0]
    res = ttrain.main(["--config", p["config_path"], "--id", "dp",
                       "--output_path", p["root"], "--device", "cpu",
                       "--data_parallel"])
    out["entry"] = {"world": res.get("world"), "rank": res.get("rank", 0),
                    "history": res["history"]}
    if rank == 0:
        out["entry_state"] = _np_state(res["manager"].model)
    torch.distributed.barrier()
    return out


def multihost_worker(rank: int, p: dict) -> dict:
    """``train.main --multihost`` on each rank, meeting at a TCP
    coordinator on this host."""
    from craniofacialsd_vae_tpu_torch import train as ttrain

    res = ttrain.main(["--config", p["config_path"], "--id", "mh",
                       "--output_path", p["root"], "--device", "cpu",
                       "--multihost", "--coordinator", p["coordinator"],
                       "--num_processes", "2", "--process_id", str(rank)])
    import torch.distributed as dist
    return {"world": res.get("world"), "rank": res.get("rank", 0),
            "history": [e["train"] for e in res["history"]],
            "group_left": dist.is_initialized()}


class _Batches:
    """An iterator's batches alone (no ``epoch_plan``)."""

    def __init__(self, it):
        self.it = it

    def __iter__(self):
        return iter(self.it)


# ---------------------------------------------------- vertex sharding
def _vs_setup(p: dict, n_data: int = 1, compute_dtype: str = "float32"):
    from craniofacialsd_vae_tpu_torch.geometry import load_bundle
    from craniofacialsd_vae_tpu_torch.models import SDVAEConfig
    from craniofacialsd_vae_tpu_torch.parallel.vertex_sharding import (
        VertexShardedModel, make_vertex_mesh)

    bundle = load_bundle(p["bundle"])
    cfg = SDVAEConfig(out_channels=tuple(p["out_channels"]),
                      latent_size=p["latent"], compute_dtype=compute_dtype)
    mesh = make_vertex_mesh(n_data=n_data)
    model = VertexShardedModel(bundle, cfg, mesh, laplacian=p["laplacian"],
                               region_masks=p["masks"])
    return bundle, cfg, mesh, model


def _params_module(p: dict, bundle, cfg):
    """The parameters as an ``SDVAE`` (its geometry unused)."""
    from craniofacialsd_vae_tpu_torch.models import (SDVAE, SpiralGeometry,
                                                     params_from_jax)

    geom = SpiralGeometry.from_bundle(bundle, device="cpu",
                                      laplacian=p["laplacian"],
                                      region_masks=p["masks"])
    model = SDVAE(cfg, geom)
    model.load_state_dict(params_from_jax(p["params"]))
    return model


def vertex_worker(rank: int, p: dict) -> dict:
    """GatherPlan forward and gradients, the sharded forward and its
    parameter gradients, the train step, the scanned epoch against the
    per-step path, and the mixed policy's forward and step, on a 1-D
    vertex mesh."""
    import torch
    import torch.distributed as dist

    from craniofacialsd_vae_tpu_torch.parallel.vertex_sharding import (
        GatherPlan, apply_gather)
    from craniofacialsd_vae_tpu_torch.training import (LossWeights,
                                                       coupled_adam)

    bundle, cfg, mesh, vs = _vs_setup(p)
    d = mesh.n_vertex
    out = {}

    # the plan alone
    plan = GatherPlan.build(p["gather_idx"], p["gather_n"], d)
    tables = plan.rank_gather(mesh.vertex_rank)
    s_in = plan.shard_in
    x = torch.from_numpy(p["gather_x"][rank * s_in:(rank + 1) * s_in]) \
        .requires_grad_(True)
    g = apply_gather(tables, x, mesh.vertex_group)
    w = torch.from_numpy(p["gather_w"][rank * plan.shard_out:
                                       (rank + 1) * plan.shard_out])
    torch.sum(g * w).backward()
    out["gather"] = g.detach().numpy()
    out["gather_grad"] = x.grad.numpy()

    # forward, and the gradients of mean(out²) + mean(mu²)
    params = _params_module(p, bundle, cfg)
    xb = vs.local_block(p["fwd_x"])
    fwd_out, mu, _ = vs.make_forward()(params, xb)
    out["fwd_out"], out["fwd_mu"] = fwd_out.numpy(), mu.numpy()
    n = vs.counts[0]
    s0 = vs.shards[0]
    valid = (torch.arange(s0) + rank * s0 < n).float()[:, None, None]
    o, mu, _ = vs.forward(params, xb)
    loss = torch.sum(o ** 2 * valid) / (n * o.shape[1] * 3) \
        + torch.mean(mu ** 2) / d
    loss.backward()
    grads = {}
    for name, prm in params.named_parameters():
        gr = prm.grad.clone() if prm.grad is not None \
            else torch.zeros_like(prm)
        dist.all_reduce(gr)
        grads[name] = gr.numpy()
    out["grads"] = grads

    # the train step, then the scanned epoch against the per-step path
    weights = LossWeights(**p["weights"])
    b = p["batch"]
    params = _params_module(p, bundle, cfg)
    step = vs.make_train_step(params, weights,
                              coupled_adam(params.parameters(), p["lr"], 0.0),
                              b)
    ms = []
    for t, xs in enumerate(p["train_x"]):
        region, eps = p["train_draws"][t]
        ms.append(_floats(step(vs.local_block(xs), region,
                               torch.from_numpy(eps))))
    out["train_metrics"] = ms
    out["train_state"] = _np_state(params)

    data = p["scan_data"]                       # [N, n, 3] vertex-major
    per = _params_module(p, bundle, cfg)
    opt = coupled_adam(per.parameters(), p["lr"], 0.0)
    step = vs.make_train_step(per, weights, opt, b)
    draws = _lookup(p["scan_draws"])
    per_ms = []
    for t, sid in enumerate(p["scan_sids"]):
        region, eps = draws(sid, b * b)
        xs = data[:, p["scan_idx"][t]]
        per_ms.append(step(vs.local_block(xs), region, eps))
    scanned = _params_module(p, bundle, cfg)
    epoch = vs.make_scanned_epoch(
        scanned, weights, coupled_adam(scanned.parameters(), p["lr"], 0.0),
        b, draws=draws)
    out["scan_metrics"] = epoch(data, p["scan_idx"], p["scan_sids"])
    sums = torch.stack([torch.stack([m[k].float() for k in sorted(m)])
                        for m in per_ms]).sum(0)
    keys = sorted(per_ms[0])
    out["per_step_means"] = {k: float(sums[i]) / len(per_ms)
                             for i, k in enumerate(keys)}
    out["scan_equal"] = all(
        torch.equal(a, c) for a, c in zip(per.parameters(),
                                          scanned.parameters()))
    out["scan_state"] = _np_state(scanned)

    # the mixed policy: forward and one step
    bundle, cfg_m, mesh, vs_m = _vs_setup(p, compute_dtype="mixed")
    params = _params_module(p, bundle, cfg_m)
    o, mu, _ = vs_m.make_forward()(params, vs_m.local_block(p["fwd_x"]))
    out["mixed_out"], out["mixed_mu"] = o.numpy(), mu.numpy()
    out["mixed_out_dtype"] = str(o.dtype)
    step = vs_m.make_train_step(
        params, weights, coupled_adam(params.parameters(), p["lr"], 0.0), b)
    region, eps = p["train_draws"][0]
    out["mixed_metrics"] = _floats(step(vs_m.local_block(p["train_x"][0]),
                                        region, torch.from_numpy(eps)))
    out["mixed_state"] = _np_state(params)
    out["mixed_param_dtypes"] = sorted({str(v.dtype) for v in
                                        params.state_dict().values()})
    return out


def vertex2d_worker(rank: int, p: dict) -> dict:
    """The 2-D (data × vertex) mesh: the composed train step with JAX's
    per-replica draws, and the scanned epochs against the per-step path."""
    import torch

    from craniofacialsd_vae_tpu_torch.training import (LossWeights,
                                                       coupled_adam)

    bundle, cfg, mesh, vs = _vs_setup(p, n_data=2)
    weights = LossWeights(**p["weights"])
    b = p["batch"]
    dr = mesh.data_rank
    out = {"coords": (mesh.data_rank, mesh.vertex_rank)}
    params = _params_module(p, bundle, cfg)
    step = vs.make_train_step(params, weights,
                              coupled_adam(params.parameters(), p["lr"], 0.0),
                              b)
    ms = []
    for t, xs in enumerate(p["train_x"]):       # [N, D_d·B, 3] each
        region, eps = p["train_draws"][dr][t]
        ms.append(_floats(step(vs.local_block(xs[:, dr * b:(dr + 1) * b]),
                               region, torch.from_numpy(eps))))
    out["train_metrics"] = ms
    out["train_state"] = _np_state(params)

    data = p["scan_data"]
    draws = _lookup(p["scan_draws"][dr])
    per = _params_module(p, bundle, cfg)
    step = vs.make_train_step(per, weights,
                              coupled_adam(per.parameters(), p["lr"], 0.0), b)
    evaluate = vs.make_eval_step(per, weights, b)
    tr_ref, va_ref = [], []
    for e in range(p["tr_idx"].shape[0]):
        ms = []
        for t, sid in enumerate(p["tr_sid"][e]):
            region, eps = draws(sid, b * b)
            cols = p["tr_idx"][e, t, dr * b:(dr + 1) * b]
            ms.append(float(step(vs.local_block(data[:, cols]), region,
                                 eps)["tot"]))
        tr_ref.append(float(np.mean(ms)))
        vs_ms = []
        for t, sid in enumerate(p["va_sid"][e]):
            region, eps = draws(sid, b * b)
            cols = p["va_idx"][e, t, dr * b:(dr + 1) * b]
            vs_ms.append(float(evaluate(vs.local_block(data[:, cols]),
                                        region, eps)["tot"]))
        va_ref.append(float(np.mean(vs_ms)))
    scanned = _params_module(p, bundle, cfg)
    epochs = vs.make_scanned_epochs(
        scanned, weights, coupled_adam(scanned.parameters(), p["lr"], 0.0),
        b, draws=draws)
    tr, va = epochs(data, data, p["tr_idx"], p["tr_sid"], p["va_idx"],
                    p["va_sid"])
    out["epochs"] = ([m["tot"] for m in tr], [m["tot"] for m in va])
    out["epochs_ref"] = (tr_ref, va_ref)
    out["epochs_equal"] = all(torch.equal(a, c) for a, c in zip(
        per.parameters(), scanned.parameters()))
    out["epochs_state"] = _np_state(scanned)
    return out

"""Deep-ensemble training entry point (counterpart of
``tools/train_ensemble.py``)::

    python -m craniofacialsd_vae_tpu_torch.train_ensemble \\
        --config=configurations/smoke.yaml --id=RUN --members 4 \\
        [--output_path=.] [--epochs E] [--seed 0] [--chunk_epochs 25] \\
        [--shard_members [--shard_devices N | DEV,DEV,...]] \\
        [--device cuda|cpu]

Trains K members of one config, a step of all K at a time: on the card
one CUDA graph a step kind replays every member's step
(``training/ensemble.py``), on the host (``--device cpu``) the same
steps run eagerly. The epochs run in chunks of ``--chunk_epochs``, one
host read of the metrics a chunk, every member over the same epoch
plans. Member i is ``train.py``'s run with ``seed = base seed + i``:
its init, its draws and so its updates. Writes K standard run dirs and
a manifest::

    outputs/<id>/member_00/{config.yaml, checkpoints/, z_stats.npz}
    ...
    outputs/<id>/ensemble.json    (members [dir, seed, val_tot,
                                   val_accuracy], seeds, epochs, config)

each resumable and servable by either package
(``DiagnosisService.from_run_dir``), and the whole served by
``serving.EnsembleService.from_ensemble_dir`` (``serve.py`` on the
ensemble dir). ``--shard_members`` places contiguous blocks of the
members over a member mesh (``parallel.make_member_mesh``: the first
``--shard_devices`` visible cards, or the devices it names, a device
named twice holding two blocks), each block in its device's own graph;
K must be a multiple of the mesh's size.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def main(argv=None) -> dict:
    """Run the entry point with ``argv`` (None: ``sys.argv``); returns the
    output dir, the manifest, the state and the chunks' metrics, for
    callers in the same process."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config", type=str,
                        default="configurations/smoke.yaml")
    parser.add_argument("--id", type=str, default="ensemble")
    parser.add_argument("--output_path", type=str, default=".")
    parser.add_argument("--members", type=int, default=4)
    parser.add_argument("--seed", type=int, default=0,
                        help="member i trains as seed+i (train.py parity)")
    parser.add_argument("--epochs", type=int, default=None,
                        help="override optimization.epochs")
    parser.add_argument("--chunk_epochs", type=int, default=25,
                        help="epochs a call (one host read a chunk)")
    add_member_flags(parser, "member")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the card)")
    return run(parser.parse_args(argv))


def add_member_flags(parser, what: str) -> None:
    """``--shard_members`` and ``--shard_devices``, shared with
    ``sweep.py``."""
    parser.add_argument("--shard_members", action="store_true",
                        help=f"place contiguous blocks of the {what}s on "
                             "the member mesh's devices, each block in its "
                             "device's own graph (no collectives); the mesh "
                             f"trims to min(devices, K); K must be a "
                             "multiple of its size")
    parser.add_argument("--shard_devices", type=str, default=None,
                        help="the member mesh: a count (the first N "
                             "visible cards) or a comma-separated list of "
                             "devices (one may be named twice); default: "
                             "every visible card")


def member_mesh(args, k: int, device):
    """The member mesh ``--shard_members`` asks for (None without it)."""
    import torch

    from .parallel import make_member_mesh

    if not args.shard_members:
        return None
    spec = args.shard_devices
    if spec and not spec.strip().isdigit():
        devices = [d.strip() for d in spec.split(",") if d.strip()]
    elif device.type == "cuda":
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if spec:
            devices = devices[:int(spec)]
    else:
        devices = [device]
    return make_member_mesh(min(len(devices), k), devices)


def run_chunks(fn, train_iter, val_iter, epochs: int, chunk: int,
               with_labels: bool, class_weights, tag: str, t0: float):
    """The epochs in chunks of ``chunk``, one ``fn`` call each over the
    iterators' shared plans; returns the last chunk's per-member
    validation metrics of its last epoch and every chunk's metrics."""
    from .training import assemble_epoch_plans

    if chunk < 1:
        raise SystemExit("--chunk_epochs must be >= 1")
    step_counter, done, chunks = 0, 0, []
    last_va = None
    while done < epochs:
        n_ep = min(chunk, epochs - done)
        plan_args, step_counter = assemble_epoch_plans(
            train_iter, val_iter, n_ep, step_counter,
            with_labels=with_labels)
        tr_m, va_m = fn(*plan_args, class_weights=class_weights)
        done += n_ep
        chunks.append({"epochs": n_ep, "train": tr_m, "validation": va_m,
                       "s": time.perf_counter() - t0})
        last_va = [m[-1] for m in va_m]
        tots = " ".join(f"{m['tot']:.4f}" for m in last_va)
        print(f"epoch {done}/{epochs} val tot per {tag}: [{tots}] "
              f"({time.perf_counter() - t0:.1f}s)", flush=True)
    return last_va, chunks


def run(args) -> dict:
    from .analysis.tester import compute_latent_stats
    from .data.dataset import DeviceBatchIterator, build_datasets
    from .device import resolve_device
    from .manager import ModelManager
    from .models import init_mlp
    from .parallel import shard_member_axis
    from .training import coupled_adam
    from .training.ensemble import (ensemble_epoch_keys,
                                    init_ensemble_state,
                                    make_ensemble_scanned_epochs,
                                    member_state)
    from .utils import get_config, save_config_snapshot

    device = resolve_device(args.device)
    members = int(args.members)
    config = get_config(args.config)
    if args.epochs is not None:
        config["optimization"]["epochs"] = args.epochs
    epochs = int(config["optimization"]["epochs"])
    output_dir = os.path.join(args.output_path, "outputs", args.id)
    os.makedirs(output_dir, exist_ok=True)
    print(f"device: {device}", flush=True)

    manager = ModelManager(
        config, precomputed_storage_path=config["data"]["precomputed_path"],
        seed=args.seed, device=device)
    train_set, val_set, _, _, class_weights = build_datasets(
        config, manager.template, device=device)
    manager.set_class_conversions_and_weights(class_weights)
    batch_size = manager.batch_size
    c2i = manager._class2idx_dict
    train_iter = DeviceBatchIterator(train_set, batch_size, shuffle=True,
                                     class2idx=c2i, device=device)
    val_iter = DeviceBatchIterator(val_set, batch_size, shuffle=True,
                                   class2idx=c2i, device=device)
    if not manager.can_scan_epochs(train_iter, val_iter):
        raise SystemExit("ensemble training needs epoch plans of at least "
                         "one batch in each split")

    # an end-to-end head trains with each member, sized as the manager's
    head_init = head_opt = None
    if manager._mlp_end2end:
        clf = config["classifier"]
        head_init = lambda g: init_mlp(  # noqa: E731
            manager.model_latent_size, clf["mlp_hidden_features"],
            manager._count_dataset_classes(), g)
        head_opt = lambda p: coupled_adam(  # noqa: E731
            p, float(clf.get("mlp_lr", 1e-4)), manager.weight_decay)
    lr = float(config["optimization"]["lr"])
    state = init_ensemble_state(
        manager.net_config, manager.geometry, members, base_seed=args.seed,
        optimizer=lambda p: coupled_adam(p, lr, manager.weight_decay),
        head_init=head_init, head_optimizer=head_opt)
    draws = ensemble_epoch_keys(members, args.seed, manager.n_regions,
                                manager.model_latent_size)
    mesh = member_mesh(args, members, device)
    if mesh is not None:
        try:
            state = shard_member_axis(mesh, state)
        except ValueError as e:
            raise SystemExit(f"--shard_members: {e}")
        print(f"member axis sharded over {len(mesh.devices)} devices "
              f"({members // len(mesh.devices)} members/device)", flush=True)
    fn = make_ensemble_scanned_epochs(state, manager.loss_weights,
                                      batch_size, manager.swap_features,
                                      draws=draws)
    print(f"ensemble {args.id}: {members} members × {epochs} epochs, "
          f"{len(train_set)} train / {len(val_set)} val meshes, seeds "
          f"{args.seed}..{args.seed + members - 1}", flush=True)
    t0 = time.perf_counter()
    last_va, chunks = run_chunks(fn, train_iter, val_iter, epochs,
                                 int(args.chunk_epochs),
                                 manager._mlp_end2end,
                                 manager._class_weights, "member", t0)
    train_s = time.perf_counter() - t0

    # per-member run dirs: checkpoints, the classifier zoo, the statistics
    clf_train = DeviceBatchIterator(train_set, batch_size, shuffle=False,
                                    class2idx=c2i, device=device)
    clf_val = DeviceBatchIterator(val_set, batch_size, shuffle=False,
                                  class2idx=c2i, device=device)
    manifest = {"members": [], "seeds": list(range(
        args.seed, args.seed + members)), "epochs": epochs,
        "config": os.path.abspath(args.config)}
    for i in range(members):
        mdir = os.path.join(output_dir, f"member_{i:02d}")
        ckpt = os.path.join(mdir, "checkpoints")
        os.makedirs(ckpt, exist_ok=True)
        save_config_snapshot(args.config, mdir)
        manager.use_member(member_state(state, i))
        manager.save_weights(ckpt, epochs - 1)
        accs = manager.train_and_validate_classifiers(clf_train, clf_val,
                                                      checkpoint_dir=ckpt)
        compute_latent_stats(manager, mdir)
        entry = {"dir": f"member_{i:02d}", "seed": args.seed + i,
                 "val_tot": float(last_va[i]["tot"])}
        if accs:
            entry["val_accuracy"] = {k: float(v) for k, v in accs.items()}
        manifest["members"].append(entry)
        print(f"member {i}: saved {mdir}", flush=True)
    with open(os.path.join(output_dir, "ensemble.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    print(f"done in {time.perf_counter() - t0:.1f}s → {output_dir} "
          f"({members} member run dirs + ensemble.json)", flush=True)
    return {"output_dir": output_dir, "manifest": manifest, "state": state,
            "chunks": chunks, "train_s": train_s, "epochs_fn": fn,
            "mesh": mesh, "manager": manager}


if __name__ == "__main__":
    main()

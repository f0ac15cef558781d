"""Training entry point (counterpart of the JAX package's ``train.py``)::

    python -m craniofacialsd_vae_tpu_torch.train --config=CONFIG --id=RUN \\
        [--output_path=.] [--resume] [--epochs=N] [--device=cuda|cpu] \\
        [--profile] [--data_parallel] [--multihost --coordinator=HOST:PORT \\
        --num_processes=P --process_id=I]

Builds ``outputs/<id>/{config.yaml, checkpoints/, logs/}``, trains the
SD-VAE on the card (``--device cpu`` runs the plain PyTorch versions on
the host), logs the per-epoch train and validation losses and
``perf/meshes_per_sec`` to ``logs/metrics.jsonl``, renders the image
grids every ``tb_renderings`` epochs, and checkpoints every
``save_weights`` epochs and at the end, in the JAX package's checkpoint
layout. On a raw dataset whose config asks for augmentation it first
generates ``<dataset>/augmented`` (the spectral modes' Laplacian basis
solved on the card and cached in the dataset directory). The training
split stays on the device (``DeviceBatchIterator``).

The epochs run in chunks of the gcd of the two cadences, each chunk one
``ModelManager.run_epochs_scanned`` call (train and validation steps
replayed from their CUDA graphs on the card; eager on the host), with
chunk boundaries at absolute multiples of the chunk, so the scalars,
renders and checkpoints land on the epochs of the per-epoch loop. A
chunk's ``perf/meshes_per_sec`` counts its train meshes over its wall
time, validation included, and its epochs each take an equal share of
that time (``train_s`` and ``epoch_s`` in the returned history; the
per-epoch loop's ``train_s`` is its train epoch alone). ``--profile``
writes a ``torch.profiler`` Chrome trace of the second epoch (the first
when only one runs) to ``outputs/<id>/profile/trace.json`` and runs the
per-epoch loop, whose train epoch is one scanned epoch (one replayed
graph on the card).
At every checkpoint of the cadence it runs the latent traversals of a
``Tester`` built before training with lazy statistics
(``latent_traversals(use_z_stats=False, save_suffix=<epoch>)``: the
``latent_exploration<epoch>`` frame strips and tiled grid), which draw
nothing from the iterators' generators and leave the weights, the
captured graphs and the checkpoints as they are. After the last save it
fits the classifier zoo on the train latents at the config's batch size
(``checkpoints/classifiers.npz``) and writes the latent statistics
(``z_stats.npz``).

``--data_parallel`` trains one rank per visible card
(``parallel/train_parallel.py``: each rank its own B scans of every
global batch of cards × B, the gradients averaged by an all-reduce inside
each step's graph). It spawns the ranks, which meet at a file rendezvous
in the run's output directory (no port); with one card it runs in this
process at world size 1, through the same code. ``--multihost`` makes
this process one rank of a run over several hosts or processes: a TCP
rendezvous at ``--coordinator`` with ``--num_processes`` and
``--process_id``, or torchrun's variables without a coordinator. Only
rank 0 writes checkpoints, scalars, renders and traversals, and fits the
classifier zoo; ``perf/meshes_per_sec`` counts world × B² meshes per
step.
"""

from __future__ import annotations

import argparse
import math
import os
import time


def main(argv=None) -> dict:
    """Run the entry point with ``argv`` (None: ``sys.argv``); returns the
    run dir and the per-epoch losses, for callers in the same process."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config", type=str,
                        default="configurations/craniofacial.yaml")
    parser.add_argument("--id", type=str, default="none",
                        help="experiment id (default: config basename)")
    parser.add_argument("--output_path", type=str, default=".")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--epochs", type=int, default=None,
                        help="override optimization.epochs")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the card)")
    parser.add_argument("--profile", action="store_true",
                        help="write a torch.profiler trace of epoch 2 "
                             "into outputs/<id>/profile")
    parser.add_argument("--data_parallel", action="store_true",
                        help="one rank per visible card, each with its own "
                             "B scans of every global batch")
    parser.add_argument("--multihost", action="store_true",
                        help="this process is one rank of a multi-process "
                             "run (launch the same command on every host)")
    parser.add_argument("--coordinator", type=str, default=None,
                        help="host:port of rank 0's rendezvous for "
                             "--multihost (omit under torchrun)")
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    args = parser.parse_args(argv)
    return _run(args)


def _rendezvous(output_dir: str) -> str:
    """A fresh file rendezvous in the run's output directory."""
    path = os.path.abspath(os.path.join(output_dir, "rendezvous"))
    if os.path.exists(path):
        os.remove(path)
    return "file://" + path


def _spawned_rank(rank: int, flags: dict, world: int,
                  init_method: str) -> None:
    """One spawned rank of ``--data_parallel``: joins the group on its
    card, then trains."""
    from .parallel import initialize_multihost

    initialize_multihost(num_processes=world, process_id=rank,
                         device=f"cuda:{rank}", init_method=init_method)
    _train(argparse.Namespace(**flags), own_group=True)


def _run(args) -> dict:
    """Start the ranks as the flags ask, or train in this process. A
    process group the caller initialized is used as it is (and left
    open)."""
    import torch
    import torch.distributed as dist

    from .device import resolve_device
    from .parallel import initialize_multihost

    device = resolve_device(args.device)
    if not (args.data_parallel or args.multihost) or dist.is_initialized():
        return _train(args)
    if args.multihost:
        initialize_multihost(args.coordinator, args.num_processes,
                             args.process_id, device=args.device)
        return _train_in_group(args)
    output_dir = _output_dir(args)
    os.makedirs(output_dir, exist_ok=True)
    init = _rendezvous(output_dir)
    world = torch.cuda.device_count() if device.type == "cuda" else 1
    if world > 1:
        import torch.multiprocessing as mp

        mp.spawn(_spawned_rank, args=(vars(args), world, init),
                 nprocs=world, join=True)
        return {"output_dir": output_dir,
                "checkpoint_dir": os.path.join(output_dir, "checkpoints"),
                "world": world}
    initialize_multihost(num_processes=1, process_id=0, device=args.device,
                         init_method=init)
    return _train_in_group(args)


def _train_in_group(args) -> dict:
    """``_train`` in the group this process just joined, which ends with
    the run, or with its fault."""
    import torch.distributed as dist

    try:
        return _train(args, own_group=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _output_dir(args) -> str:
    model_name = args.id if args.id != "none" else \
        os.path.splitext(os.path.basename(args.config))[0]
    return os.path.join(args.output_path, "outputs", model_name)


class _NoWriter:
    """The scalar and image log of a rank other than 0: nothing."""

    def add_scalar(self, *args, **kwargs):
        pass

    def add_image(self, *args, **kwargs):
        pass

    def close(self):
        pass


def _train(args, own_group: bool = False) -> dict:
    """The training run of one process: one rank of the initialized
    process group under ``--data_parallel``/``--multihost`` (destroyed at
    the end where ``own_group``)."""
    import torch.distributed as dist

    from .analysis.tester import Tester, compute_latent_stats
    from .data.dataset import DeviceBatchIterator, build_datasets
    from .device import resolve_device
    from .manager import ModelManager
    from .utils import get_config, prepare_sub_folder, save_config_snapshot
    from .viz.logging import JsonlWriter

    parallel = bool(args.data_parallel or args.multihost)
    if parallel and not dist.is_initialized():
        raise RuntimeError("data parallelism needs the process group")
    rank = dist.get_rank() if parallel else 0
    world = dist.get_world_size() if parallel else 1
    primary = rank == 0
    device = resolve_device(args.device)
    if parallel and device.type == "cuda":
        import torch
        device = torch.device("cuda", torch.cuda.current_device())
    config = get_config(args.config)
    if args.epochs is not None:
        config["optimization"]["epochs"] = args.epochs

    model_name = args.id if args.id != "none" else \
        os.path.splitext(os.path.basename(args.config))[0]
    output_dir = _output_dir(args)
    checkpoint_dir = prepare_sub_folder(output_dir) if primary \
        else os.path.join(output_dir, "checkpoints")
    if primary:
        save_config_snapshot(args.config, output_dir)
    writer = JsonlWriter(os.path.join(output_dir, "logs")) if primary \
        else _NoWriter()
    print(f"device: {device}" + (f" (rank {rank} of {world})"
                                 if parallel else ""))

    manager = ModelManager(
        config, precomputed_storage_path=config["data"]["precomputed_path"],
        device=device)
    if parallel:
        manager.enable_data_parallel()
    t_data = time.perf_counter()
    train_set, val_set, test_set, normalization, class_weights = \
        build_datasets(config, manager.template, device=device)
    manager.set_class_conversions_and_weights(class_weights)
    batch_size = config["optimization"]["batch_size"]
    global_batch = batch_size * world
    # every rank iterates the same global order (same seed) and keeps its
    # own rows of each batch
    train_iter = DeviceBatchIterator(train_set, global_batch, shuffle=True,
                                     class2idx=manager._class2idx_dict,
                                     device=device)
    val_iter = DeviceBatchIterator(val_set, global_batch, shuffle=True,
                                   class2idx=manager._class2idx_dict,
                                   device=device)
    data_s = time.perf_counter() - t_data

    vis_batch = next(iter(train_iter))
    val_vis_batch = next(iter(val_iter), None)
    if val_vis_batch is None:
        print("warning: validation split yields no batch at this batch "
              "size — validation image grids disabled")

    # the traversals at each checkpoint; the stats stay lazy, so nothing
    # encodes the untrained model
    tester = Tester(manager, normalization, train_iter, val_iter,
                    output_dir, config, lazy_stats=True) if primary else None
    start_epoch = manager.resume(checkpoint_dir) if args.resume else 0
    epochs = config["optimization"]["epochs"]
    log_freq = config["logging_frequency"]
    if primary:
        print(f"training {model_name}: {len(train_set)} train / "
              f"{len(val_set)} val meshes, epochs {start_epoch}→{epochs}; "
              f"geometry {manager.geometry_seconds:.2f} s, "
              f"data {data_s:.2f} s")
    # meshes per step: each rank builds the swap grid of its own B scans
    grid = world * (batch_size ** 2 if config["data"].get("swap_features")
                    else batch_size)
    t0 = time.time()
    history, traversal_s = [], []
    print_cad = max(epochs // 10, 1)

    def log_epoch(epoch, train_losses, val_losses, train_s, epoch_s):
        for k, v in train_losses.items():
            writer.add_scalar(f"train/{k}", v, epoch + 1)
        for k, v in val_losses.items():
            writer.add_scalar(f"validation/{k}", v, epoch + 1)
        history.append({"epoch": epoch + 1, "train": dict(train_losses),
                        "validation": dict(val_losses), "train_s": train_s,
                        "epoch_s": epoch_s, "steps": len(train_iter)})

    def cadence(epoch):
        """The renders, checkpoint and traversals due after ``epoch``
        (0-based), on rank 0 alone."""
        if not primary:
            return
        if (epoch + 1) % log_freq["tb_renderings"] == 0:
            manager.log_images(vis_batch, writer, epoch, normalization,
                               "train", error_max_scale=2)
            if val_vis_batch is not None:
                manager.log_images(val_vis_batch, writer, epoch,
                                   normalization, "validation",
                                   error_max_scale=2)
        if (epoch + 1) % log_freq["save_weights"] == 0:
            manager.save_weights(checkpoint_dir, epoch)
            t = time.perf_counter()
            tester.latent_traversals(use_z_stats=False,
                                     save_suffix=str(epoch + 1))
            traversal_s.append(time.perf_counter() - t)

    use_chunks = (not args.profile
                  and manager.can_scan_epochs(train_iter, val_iter))
    if use_chunks:
        # one chunk size, so one pair of graphs; boundaries at absolute
        # multiples, so the cadences fire after a resume from any epoch
        chunk = max(math.gcd(log_freq["tb_renderings"],
                             log_freq["save_weights"]), 1)
        epoch = start_epoch
        while epoch < epochs:
            stop = min(epoch + chunk - epoch % chunk, epochs)
            te = time.perf_counter()
            tr_list, va_list = manager.run_epochs_scanned(
                train_iter, val_iter, stop - epoch)
            chunk_s = time.perf_counter() - te
            mps = len(train_iter) * grid * (stop - epoch) / max(chunk_s,
                                                                1e-9)
            for i, e in enumerate(range(epoch, stop)):
                writer.add_scalar("perf/meshes_per_sec", mps, e + 1)
                log_epoch(e, tr_list[i], va_list[i],
                          chunk_s / (stop - epoch), chunk_s / (stop - epoch))
            prev, epoch = epoch, stop
            cadence(epoch - 1)
            if primary and epoch // print_cad > prev // print_cad:
                dt = time.time() - t0
                print(f"epoch {epoch}/{epochs} "
                      f"tot={manager._losses['tot']:.4f} "
                      f"({dt / (epoch - start_epoch):.2f}s/epoch)")

    # the profiled epoch is the second (the first builds the kernels and
    # captures the graphs), or the only one
    profile_epoch = start_epoch + 1 if epochs > start_epoch + 1 \
        else start_epoch
    for epoch in range(epochs if use_chunks else start_epoch, epochs):
        prof = _start_profile(device) \
            if args.profile and epoch == profile_epoch else None
        te = time.perf_counter()
        train_losses = dict(manager.run_epoch(train_iter, train=True))
        train_s = time.perf_counter() - te
        writer.add_scalar("perf/meshes_per_sec",
                          len(train_iter) * grid / max(train_s, 1e-9),
                          epoch + 1)
        val_losses = dict(manager.run_epoch(val_iter, train=False))
        if prof is not None:
            _stop_profile(prof, device, os.path.join(output_dir, "profile"))
        log_epoch(epoch, train_losses, val_losses, train_s,
                  time.perf_counter() - te)
        cadence(epoch)
        if primary and (epoch + 1) % print_cad == 0:
            dt = time.time() - t0
            print(f"epoch {epoch + 1}/{epochs} "
                  f"tot={manager._losses['tot']:.4f} "
                  f"({dt / (epoch - start_epoch + 1):.2f}s/epoch)")

    if parallel:
        # the ranks part here: the zoo, the statistics and the last save
        # are rank 0's alone
        dist.barrier()
        if own_group:
            dist.destroy_process_group()
        if not primary:
            return {"output_dir": output_dir, "rank": rank, "world": world,
                    "history": history, "start_epoch": start_epoch}
    manager.save_weights(checkpoint_dir, epochs - 1)
    t_clf = time.perf_counter()
    classifier_accs = manager.train_and_validate_classifiers(
        DeviceBatchIterator(train_set, batch_size, shuffle=False,
                            class2idx=manager._class2idx_dict,
                            device=device),
        DeviceBatchIterator(val_set, batch_size, shuffle=False,
                            class2idx=manager._class2idx_dict,
                            device=device),
        writer, checkpoint_dir)
    classifiers_s = time.perf_counter() - t_clf
    compute_latent_stats(manager, output_dir)
    writer.close()
    print(f"done in {time.time() - t0:.1f}s → {output_dir}")
    return {"output_dir": output_dir, "checkpoint_dir": checkpoint_dir,
            "manager": manager, "history": history,
            "geometry_s": manager.geometry_seconds, "data_s": data_s,
            "start_epoch": start_epoch, "classifier_accs": classifier_accs,
            "classifiers_s": classifiers_s, "traversal_s": traversal_s,
            "world": world}


def _start_profile(device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def _stop_profile(prof, device, out_dir: str) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"profile → {path}")


if __name__ == "__main__":
    main()

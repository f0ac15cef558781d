"""Training entry point (counterpart of the JAX package's ``train.py``)::

    python -m craniofacialsd_vae_tpu_torch.train --config=CONFIG --id=RUN \\
        [--output_path=.] [--resume] [--epochs=N] [--device=cuda|cpu] \\
        [--profile]

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

Not ported yet: data parallelism and multihost (ROADMAP queue 1.4).
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
    args = parser.parse_args(argv)

    from .analysis.tester import Tester, compute_latent_stats
    from .data.dataset import DeviceBatchIterator, build_datasets
    from .device import resolve_device
    from .manager import ModelManager
    from .utils import get_config, prepare_sub_folder, save_config_snapshot
    from .viz.logging import JsonlWriter

    device = resolve_device(args.device)
    config = get_config(args.config)
    if args.epochs is not None:
        config["optimization"]["epochs"] = args.epochs

    model_name = args.id if args.id != "none" else \
        os.path.splitext(os.path.basename(args.config))[0]
    output_dir = os.path.join(args.output_path, "outputs", model_name)
    checkpoint_dir = prepare_sub_folder(output_dir)
    save_config_snapshot(args.config, output_dir)
    writer = JsonlWriter(os.path.join(output_dir, "logs"))
    print(f"device: {device}")

    manager = ModelManager(
        config, precomputed_storage_path=config["data"]["precomputed_path"],
        device=device)
    t_data = time.perf_counter()
    train_set, val_set, test_set, normalization, class_weights = \
        build_datasets(config, manager.template, device=device)
    manager.set_class_conversions_and_weights(class_weights)
    batch_size = config["optimization"]["batch_size"]
    train_iter = DeviceBatchIterator(train_set, batch_size, shuffle=True,
                                     class2idx=manager._class2idx_dict,
                                     device=device)
    val_iter = DeviceBatchIterator(val_set, batch_size, shuffle=True,
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
                    output_dir, config, lazy_stats=True)
    start_epoch = manager.resume(checkpoint_dir) if args.resume else 0
    epochs = config["optimization"]["epochs"]
    log_freq = config["logging_frequency"]
    print(f"training {model_name}: {len(train_set)} train / "
          f"{len(val_set)} val meshes, epochs {start_epoch}→{epochs}; "
          f"geometry {manager.geometry_seconds:.2f} s, data {data_s:.2f} s")
    grid = batch_size ** 2 if config["data"].get("swap_features") \
        else batch_size
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
        (0-based)."""
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
            if epoch // print_cad > prev // print_cad:
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
        if (epoch + 1) % print_cad == 0:
            dt = time.time() - t0
            print(f"epoch {epoch + 1}/{epochs} "
                  f"tot={manager._losses['tot']:.4f} "
                  f"({dt / (epoch - start_epoch + 1):.2f}s/epoch)")

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
            "classifiers_s": classifiers_s, "traversal_s": traversal_s}


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

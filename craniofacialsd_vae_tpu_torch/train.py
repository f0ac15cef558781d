"""Training entry point (counterpart of the JAX package's ``train.py``)::

    python -m craniofacialsd_vae_tpu_torch.train --config=CONFIG --id=RUN \\
        [--output_path=.] [--resume] [--epochs=N] [--device=cuda|cpu]

Builds ``outputs/<id>/{config.yaml, checkpoints/, logs/}``, trains the
SD-VAE on the card (``--device cpu`` runs the plain PyTorch versions on
the host), logs the per-epoch train and validation losses and
``perf/meshes_per_sec`` to ``logs/metrics.jsonl``, renders the image
grids every ``tb_renderings`` epochs, and checkpoints every
``save_weights`` epochs and at the end, in the JAX package's checkpoint
layout. The training split stays on the device (``DeviceBatchIterator``).
After the last save it fits the classifier zoo on the train latents at
the config's batch size (``checkpoints/classifiers.npz``) and writes the
latent statistics (``z_stats.npz``).

Not ported yet: data parallelism and multihost (ROADMAP 1.11), the
profiler capture, the scanned epochs (1.5) and the Tester's latent
traversals (1.10).
"""

from __future__ import annotations

import argparse
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
    args = parser.parse_args(argv)

    from .analysis.tester import compute_latent_stats
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
        build_datasets(config, manager.template)
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

    start_epoch = manager.resume(checkpoint_dir) if args.resume else 0
    epochs = config["optimization"]["epochs"]
    log_freq = config["logging_frequency"]
    print(f"training {model_name}: {len(train_set)} train / "
          f"{len(val_set)} val meshes, epochs {start_epoch}→{epochs}; "
          f"geometry {manager.geometry_seconds:.2f} s, data {data_s:.2f} s")
    grid = batch_size ** 2 if config["data"].get("swap_features") \
        else batch_size
    t0 = time.time()
    history = []
    for epoch in range(start_epoch, epochs):
        te = time.perf_counter()
        train_losses = dict(manager.run_epoch(train_iter, train=True))
        train_s = time.perf_counter() - te
        writer.add_scalar("perf/meshes_per_sec",
                          len(train_iter) * grid / max(train_s, 1e-9),
                          epoch + 1)
        manager.log_losses(writer, epoch, "train")
        val_losses = dict(manager.run_epoch(val_iter, train=False))
        manager.log_losses(writer, epoch, "validation")
        history.append({"epoch": epoch + 1, "train": train_losses,
                        "validation": val_losses, "train_s": train_s,
                        "steps": len(train_iter)})

        if (epoch + 1) % log_freq["tb_renderings"] == 0:
            manager.log_images(vis_batch, writer, epoch, normalization,
                               "train", error_max_scale=2)
            if val_vis_batch is not None:
                manager.log_images(val_vis_batch, writer, epoch,
                                   normalization, "validation",
                                   error_max_scale=2)
        if (epoch + 1) % log_freq["save_weights"] == 0:
            manager.save_weights(checkpoint_dir, epoch)
        if (epoch + 1) % max(epochs // 10, 1) == 0:
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
            "classifiers_s": classifiers_s}


if __name__ == "__main__":
    main()

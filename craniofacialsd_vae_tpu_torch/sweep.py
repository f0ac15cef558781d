"""Hyperparameter-sweep entry point (counterpart of ``tools/sweep.py``)::

    python -m craniofacialsd_vae_tpu_torch.sweep \\
        --config=configurations/smoke.yaml --id=RUN \\
        --vary lr=1e-4,3e-4,1e-3 --vary kl_weight=1e-4,1e-3 \\
        [--output_path=.] [--epochs E] [--seed 0] [--chunk_epochs 25] \\
        [--select reconstruction] [--shard_members [--shard_devices ...]] \\
        [--device cuda|cpu]

The grid is the product of the ``--vary`` axes (6 variants above), over
the optimization scalars of ``training.sweep.SWEEPABLE_KEYS``. Every
variant starts from the same init and reads the same batches and draws,
so variant i is the solo ``train.py`` run with its values, bit for bit
(``training/sweep.py``); on the card one CUDA graph a step kind replays
every variant's step. Writes K standard run dirs and a ranking::

    outputs/<id>/variant_00/{config.yaml, checkpoints/, z_stats.npz}
    ...
    outputs/<id>/sweep.json   (variants [dir, overrides, val,
                               val_accuracy] ranked by --select, best,
                               select, seed, epochs, config, axes)

each ``config.yaml`` the base config with that variant's values, so the
run dir evaluates, serves and resumes with them (in either package).
``--shard_members`` and ``--shard_devices`` as ``train_ensemble.py``
takes them.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import time


def parse_vary(specs: list[str]) -> list[dict]:
    """--vary key=v1,v2,... axes → the grid's override dicts."""
    axes = []
    seen_keys = set()
    for spec in specs:
        if "=" not in spec:
            raise SystemExit(f"--vary expects key=v1,v2,...; got {spec!r}")
        key, _, vals = spec.partition("=")
        key = key.strip().removeprefix("optimization.")
        if key in seen_keys:
            # a dict of the product would keep only the last axis's value
            raise SystemExit(
                f"--vary {key} given twice; list all its values in one "
                f"axis: --vary {key}=v1,v2,...")
        seen_keys.add(key)
        try:
            values = [float(v) for v in vals.split(",") if v.strip() != ""]
        except ValueError:
            raise SystemExit(f"--vary {key}: non-numeric value in {vals!r}")
        if not values:
            raise SystemExit(f"--vary {key}: no values")
        axes.append([(key, v) for v in values])
    if not axes:
        raise SystemExit("need at least one --vary axis")
    return [dict(combo) for combo in itertools.product(*axes)]


def main(argv=None) -> dict:
    """Run the entry point with ``argv`` (None: ``sys.argv``); returns the
    output dir, the manifest, the state and the chunks' metrics."""
    from .train_ensemble import add_member_flags

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config", type=str,
                        default="configurations/smoke.yaml")
    parser.add_argument("--id", type=str, default="sweep")
    parser.add_argument("--output_path", type=str, default=".")
    parser.add_argument("--vary", action="append", default=[],
                        metavar="KEY=V1,V2,...",
                        help="sweep axis over an optimization key; the "
                             "grid is the product of all --vary axes")
    parser.add_argument("--seed", type=int, default=0,
                        help="shared by every variant (same init and draws)")
    parser.add_argument("--epochs", type=int, default=None,
                        help="override optimization.epochs")
    parser.add_argument("--chunk_epochs", type=int, default=25,
                        help="epochs a call (one host read a chunk)")
    parser.add_argument("--select", type=str, default="reconstruction",
                        help="validation metric the ranking minimizes "
                             "(reconstruction compares across variants; "
                             "tot does not: each weighs it its own way)")
    add_member_flags(parser, "variant")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the card)")
    return run(parser.parse_args(argv))


def run(args) -> dict:
    from .analysis.tester import compute_latent_stats
    from .data.dataset import DeviceBatchIterator, build_datasets
    from .device import resolve_device
    from .manager import ModelManager
    from .parallel import shard_member_axis
    from .train_ensemble import member_mesh, run_chunks
    from .training import LOSS_KEYS
    from .training.sweep import (build_variants, init_sweep_state,
                                 make_sweep_scanned_epochs,
                                 stack_hyperparams, variant_state)
    from .utils import get_config
    from .utils.yaml_subset import safe_dump

    device = resolve_device(args.device)
    overrides = parse_vary(args.vary)
    if len(overrides) > 64:
        print(f"warning: {len(overrides)}-variant grid — every variant "
              "trains at once on one card; memory grows with K")
    config = get_config(args.config)
    if args.epochs is not None:
        config["optimization"]["epochs"] = args.epochs
    if (config.get("classifier") or {}).get("mlp_training_type") \
            == "end2end":
        raise SystemExit(
            "sweep.py trains the net hyperparameters; end2end classifier "
            "heads are not swept — use mlp_training_type: after (the "
            "post-hoc zoo is fitted per variant) or train.py per setting")
    # the classification losses read 0.0 without an end2end head, and an
    # accuracy ranks the wrong way under a minimizing sort
    selectable = [k for k in LOSS_KEYS
                  if not k.startswith("classification")]
    if args.select not in selectable:
        raise SystemExit(f"--select must be one of {selectable}")
    epochs = int(config["optimization"]["epochs"])
    if epochs < 1:
        raise SystemExit("optimization.epochs (or --epochs) must be >= 1")
    if int(args.chunk_epochs) < 1:
        raise SystemExit("--chunk_epochs must be >= 1")

    variants = build_variants(config, overrides)
    hp = stack_hyperparams(variants)
    k = len(variants)
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
        raise SystemExit("sweep training needs epoch plans of at least one "
                         "batch in each split")

    state = init_sweep_state(manager.net_config, manager.geometry, k,
                             seed=args.seed, hyperparams=hp)
    mesh = member_mesh(args, k, device)
    if mesh is not None:
        try:
            state = shard_member_axis(mesh, state)
        except ValueError as e:
            raise SystemExit(f"--shard_members: {e}")
        print(f"variant axis sharded over {len(mesh.devices)} devices "
              f"({k // len(mesh.devices)} variants/device)", flush=True)
    # one draws stream, the manager's (seed + 1, step id): every variant
    # reads the same swaps and noise
    fn = make_sweep_scanned_epochs(state, hp, batch_size,
                                   manager.swap_features,
                                   draws=manager._draws)
    print(f"sweep {args.id}: {k} variants × {epochs} epochs over "
          f"{len(train_set)} train / {len(val_set)} val meshes; axes: "
          + " ".join(args.vary), flush=True)
    t0 = time.perf_counter()
    last_va, chunks = run_chunks(fn, train_iter, val_iter, epochs,
                                 int(args.chunk_epochs), False,
                                 manager._class_weights, "variant", t0)
    train_s = time.perf_counter() - t0

    clf_train = DeviceBatchIterator(train_set, batch_size, shuffle=False,
                                    class2idx=c2i, device=device)
    clf_val = DeviceBatchIterator(val_set, batch_size, shuffle=False,
                                  class2idx=c2i, device=device)
    manifest = {"variants": [], "select": args.select, "seed": args.seed,
                "epochs": epochs, "config": os.path.abspath(args.config),
                "axes": list(args.vary)}
    keys = sorted(set().union(*overrides))
    for i, vcfg in enumerate(variants):
        vdir = os.path.join(output_dir, f"variant_{i:02d}")
        ckpt = os.path.join(vdir, "checkpoints")
        os.makedirs(ckpt, exist_ok=True)
        # the snapshot carries this variant's values (serving and resume
        # read it)
        with open(os.path.join(vdir, "config.yaml"), "w") as f:
            f.write(safe_dump(vcfg))
        manager.use_member(variant_state(state, i))
        manager.save_weights(ckpt, epochs - 1)
        accs = manager.train_and_validate_classifiers(clf_train, clf_val,
                                                      checkpoint_dir=ckpt)
        compute_latent_stats(manager, vdir)
        entry = {"dir": f"variant_{i:02d}",
                 "overrides": {key: float(vcfg["optimization"][key])
                               for key in keys},
                 "val": {key: float(last_va[i][key]) for key in LOSS_KEYS}}
        if accs:
            entry["val_accuracy"] = {key: float(v)
                                     for key, v in accs.items()}
        manifest["variants"].append(entry)
        print(f"variant {i}: {entry['overrides']} → val {args.select} "
              f"{entry['val'][args.select]:.5f} ({vdir})", flush=True)
    # ranked by --select, best first; the grid order is each dir's index
    manifest["variants"] = sorted(manifest["variants"],
                                  key=lambda v: v["val"][args.select])
    manifest["best"] = manifest["variants"][0]
    with open(os.path.join(output_dir, "sweep.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    best = manifest["best"]
    print(f"best: {best['dir']} {best['overrides']} (val {args.select} "
          f"{best['val'][args.select]:.5f}); done in "
          f"{time.perf_counter() - t0:.1f}s → {output_dir}", flush=True)
    return {"output_dir": output_dir, "manifest": manifest, "state": state,
            "chunks": chunks, "train_s": train_s, "epochs_fn": fn,
            "hyperparams": hp, "variants": variants, "mesh": mesh,
            "manager": manager}


if __name__ == "__main__":
    main()

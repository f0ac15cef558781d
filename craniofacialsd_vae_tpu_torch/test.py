"""Evaluation entry point (counterpart of the JAX package's ``test.py``)::

    python -m craniofacialsd_vae_tpu_torch.test --id=RUN [--output_path=.]
        [--experiment=standard] [--mesh PATH] [--mesh2 PATH]
        [--landmarks JSON] [--procedure monobloc] [--pairs_root DIR]
        [--pairs_excel CSV] [--device cuda|cpu]

Reads the run's ``config.yaml`` (``outputs/<id>/``, written by either
package), builds the manager, the datasets and the iterators as the
JAX entry does, resumes the last checkpoint and the classifier zoo, and
runs one experiment on the card (``--device cpu`` runs the plain
PyTorch versions on the host):

  standard     — traversals, embeddings, generation, classifier metrics,
                 reconstruction and diversity → ``eval_metrics.json``
  traversals | embeddings | generation | classifiers | recon — alone
  refit_classifiers — refit the zoo from the resumed model's latents
  interpolate  — per-feature / per-variable / all-features latent walks
  classify_and_project — diagnose ``--mesh``
  planning     — surgical planning for ``--mesh``
  prepost      — pre/post assessment of ``--mesh`` (pre), ``--mesh2``
  prepost_batch — every pair of the CSV table ``--pairs_excel`` under
                 ``--pairs_root``
  fit          — fit an unregistered scan: ``--mesh`` + ``--landmarks``
  saliency     — gradient attribution of the QDA diagnosis
  uncertainty  — posterior-sampling uncertainty of the QDA diagnosis

The files each writes are listed in ``analysis/tester.py``: images as
PNG, figures as SVG (with an ``.npz`` of the data where JAX pickles the
figure), videos as Motion-JPEG AVI.
"""

from __future__ import annotations

import argparse
import json
import os

EXPERIMENTS = ("standard", "traversals", "embeddings", "generation",
               "classifiers", "refit_classifiers", "recon", "interpolate",
               "classify_and_project", "planning", "prepost",
               "prepost_batch", "fit", "saliency", "uncertainty")


def main(argv=None) -> dict:
    """Run one experiment (``argv`` None: ``sys.argv``); returns
    ``{"tester", "manager", "output_dir", "result"}`` for callers in the
    same process."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--id", type=str, required=True)
    parser.add_argument("--output_path", type=str, default=".")
    parser.add_argument("--experiment", type=str, default="standard",
                        choices=EXPERIMENTS)
    parser.add_argument("--mesh", type=str, default=None)
    parser.add_argument("--mesh2", type=str, default=None)
    parser.add_argument("--landmarks", type=str, default=None)
    parser.add_argument("--procedure", type=str, default="monobloc")
    parser.add_argument("--pairs_root", type=str, default=None,
                        help="prepost_batch: directory of pre/post meshes")
    parser.add_argument("--pairs_excel", type=str, default=None,
                        help="prepost_batch: the CSV pair table")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the card)")
    args = parser.parse_args(argv)

    output_dir = os.path.join(args.output_path, "outputs", args.id)
    config_path = os.path.join(output_dir, "config.yaml")
    if not os.path.exists(config_path):
        raise SystemExit(f"no run found at {output_dir} "
                         "(missing config.yaml — train first)")

    from .analysis.tester import Tester
    from .data.dataset import BatchIterator, build_datasets
    from .device import resolve_device
    from .manager import ModelManager
    from .utils import get_config

    device = resolve_device(args.device)
    config = get_config(config_path)
    manager = ModelManager(
        config, precomputed_storage_path=config["data"]["precomputed_path"],
        device=device)

    train_set, val_set, test_set, normalization, class_weights = \
        build_datasets(config, manager.template, device=device)
    manager.set_class_conversions_and_weights(class_weights)

    checkpoint_dir = os.path.join(output_dir, "checkpoints")
    manager.resume(checkpoint_dir)

    batch_size = config["optimization"]["batch_size"]
    train_iter = BatchIterator(train_set, batch_size, shuffle=False)
    test_iter = BatchIterator(test_set, batch_size, shuffle=False,
                              drop_last=False)

    tester = Tester(manager, normalization, train_iter, test_iter,
                    output_dir, config)
    result = _run(args, tester, manager, config, test_set, val_set,
                  normalization, train_iter, checkpoint_dir, output_dir)
    return {"tester": tester, "manager": manager, "output_dir": output_dir,
            "result": result}


def _run(args, tester, manager, config, test_set, val_set, normalization,
         train_iter, checkpoint_dir, output_dir):
    exp = args.experiment
    if exp == "standard":
        metrics = tester()
        print(json.dumps(metrics, indent=1))
        return metrics
    if exp == "traversals":
        return tester.latent_traversals(use_z_stats=False)
    if exp == "embeddings":
        return tester.plot_embeddings()
    if exp == "generation":
        tester.random_generation_and_rendering()
        tester.random_generation_and_save()
        return None
    if exp in ("classifiers", "refit_classifiers"):
        if exp == "refit_classifiers":
            from .data.dataset import BatchIterator

            val_iter = BatchIterator(val_set, train_iter.batch_size,
                                     shuffle=False, drop_last=False)
            manager.train_and_validate_classifiers(
                train_iter, val_iter, checkpoint_dir=checkpoint_dir)
        accs = tester.test_classifiers()
        print(json.dumps(accs, indent=1))
        return accs
    if exp == "recon":
        errors = tester.reconstruction_errors()
        print(json.dumps(errors, indent=1))
        return errors
    if exp == "interpolate":
        # the first test mesh against the test mesh farthest from it;
        # interpolate takes raw vertices
        import numpy as np

        if config["data"].get("normalize_data", True):
            def raw(x):
                return x * normalization["std"] + normalization["mean"]
        else:
            def raw(x):
                return x
        dists = [float(np.mean((test_set.x[0] - test_set.x[i]) ** 2))
                 for i in range(len(test_set))]
        tester.interpolate(raw(test_set.x[0]),
                           raw(test_set.x[int(np.argmax(dists))]))
        print("interpolations written")
        return None
    if exp == "classify_and_project":
        _require(args.mesh, "--mesh")
        return tester.classify_and_project(args.mesh)
    if exp == "planning":
        _require(args.mesh, "--mesh")
        out = tester.interpolate_syndrome_to_normal(args.mesh)
        print("planned latents:", {k: v.shape for k, v in out.items()
                                   if hasattr(v, "shape")})
        return out
    if exp == "prepost":
        _require(args.mesh and args.mesh2, "--mesh and --mesh2")
        metrics = tester.evaluate_pre_post_pair(
            args.mesh, args.mesh2, "cli", args.procedure)
        print(json.dumps(
            {k: (v if not isinstance(v, dict) else "…")
             for k, v in metrics.items()}, indent=1, default=str))
        tester.compute_and_save_postop_mesh_colourmap(args.mesh, args.mesh2)
        return metrics
    if exp == "prepost_batch":
        _require(args.pairs_root and args.pairs_excel,
                 "--pairs_root and --pairs_excel")
        out = tester.evaluate_all_pre_post_pairs_in_excel(args.pairs_root,
                                                          args.pairs_excel)
        print("pre/post batch evaluation written to "
              f"{os.path.join(output_dir, 'pre_post_eval_plots')}")
        return out
    if exp == "saliency":
        reports = tester.saliency_maps()
        print(json.dumps([{k: v for k, v in r.items() if k != "regions"}
                          | {"top_regions": [x["attribute"]
                                             for x in r["regions"][:3]]}
                          for r in reports], indent=1))
        print(f"saliency PLYs/renders written to "
              f"{os.path.join(output_dir, 'saliency')}")
        return reports
    if exp == "uncertainty":
        reports = tester.diagnosis_uncertainty()
        print(json.dumps([{k: r[k] for k in
                           ("mesh", "label", "label_agreement",
                            "predictive_entropy_nats", "flagged")}
                          for r in reports], indent=1))
        print(f"uncertainty report written to "
              f"{os.path.join(output_dir, 'uncertainty')}")
        return reports
    # fit
    _require(args.mesh and args.landmarks, "--mesh and --landmarks")
    result = tester.fit_mesh(args.mesh, args.landmarks, save_artifacts=True)
    print({k: v for k, v in result.items()
           if not hasattr(v, "shape") or v.size < 10})
    print(f"fitted mesh + aligned scan written to "
          f"{os.path.join(output_dir, 'fit')}")
    return result


def _require(value, what: str) -> None:
    if not value:
        raise SystemExit(f"this experiment needs {what}")


if __name__ == "__main__":
    main()

"""Batch clinical intake: a directory of registered scans → a diagnosis
CSV (counterpart of ``tools/batch_diagnose.py``)::

    python -m craniofacialsd_vae_tpu_torch.batch_diagnose --id RUN \\
        --scans DIR --out DIR [--output_path .] [--run_dir DIR] \\
        [--model qda] [--healthy_class n] [--max_batch 16] \\
        [--save_recons] [--device cuda|cpu]

``DiagnosisService.from_run_dir`` loads the run dir (of either package)
on the card unless ``--device cpu``; every scan of ``--scans`` (``*.ply``
/ ``*.obj``, registered to the run's template) goes through one bucketed
``reconstruct`` per ``max_batch`` chunk, and the per-scan reports land in
``diagnoses.csv``::

    file, label, mean_recon_error_mm, mahalanobis_to_healthy, p_<class>...,
    error

with ``summary.json`` (label counts, error stats, the service's stats).
A scan whose vertex count is not the template's gets a row with an
``error`` note (it needs the fit intake, ``serve.py``'s ``POST /fit``)
instead of stopping the batch. ``--save_recons`` also writes each scan's
reconstruction as ``<scan>_recon.obj``.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import time

MESH_EXTS = (".ply", ".obj")


def main(argv=None) -> dict:
    """Run the intake (``argv`` None: ``sys.argv``); returns the summary."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--id", type=str, default=None)
    parser.add_argument("--output_path", type=str, default=".")
    parser.add_argument("--run_dir", type=str, default=None,
                        help="explicit run dir (overrides --id)")
    parser.add_argument("--scans", type=str, required=True,
                        help="directory of registered scans (*.ply/*.obj)")
    parser.add_argument("--out", type=str, required=True,
                        help="output directory for diagnoses.csv etc.")
    parser.add_argument("--model", type=str, default="qda",
                        choices=["qda", "lda", "svm", "mlp"],
                        help="predicting classifier head")
    parser.add_argument("--healthy_class", type=str, default="n")
    parser.add_argument("--max_batch", type=int, default=16)
    parser.add_argument("--save_recons", action="store_true",
                        help="write each scan's reconstruction as OBJ")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the card)")
    args = parser.parse_args(argv)

    if not args.run_dir and not args.id:
        parser.error("--id or --run_dir required")
    run_dir = args.run_dir or os.path.join(args.output_path, "outputs",
                                           args.id)
    if not os.path.isdir(args.scans):
        parser.error(f"--scans {args.scans!r} is not a directory")

    import numpy as np

    from .geometry import read_mesh, write_obj
    from .serving import DiagnosisService

    service = DiagnosisService.from_run_dir(
        run_dir, healthy_class=args.healthy_class,
        max_batch=args.max_batch, device=args.device)
    n_template = service.manager.template.num_vertices

    names = sorted(f for f in os.listdir(args.scans)
                   if f.lower().endswith(MESH_EXTS))
    if not names:
        raise SystemExit(f"batch_diagnose: no {'/'.join(MESH_EXTS)} "
                         f"files in {args.scans}")

    loaded, skipped = [], []          # [(name, verts)], [(name, reason)]
    for name in names:
        path = os.path.join(args.scans, name)
        try:
            mesh = read_mesh(path)
        except Exception as e:      # a scan file that does not parse
            skipped.append((name, f"unreadable: {e}"))
            continue
        v = np.asarray(mesh.vertices, np.float32)
        if v.shape != (n_template, 3):
            skipped.append((name, f"vertex count {v.shape[0]} != template "
                            f"{n_template} — unregistered scan, use the "
                            "fit intake (serve.py POST /fit)"))
            continue
        loaded.append((name, v))

    os.makedirs(args.out, exist_ok=True)
    rows = []
    t0 = time.time()
    if loaded:
        rec = service.reconstruct(np.stack([v for _, v in loaded]))
        reports = service.diagnose_latents(rec["latent"], model=args.model)
        faces = np.asarray(service.manager.template.face)
        for i, (name, _) in enumerate(loaded):
            rep = reports[i]
            row = {"file": name, "label": rep["label"],
                   "mean_recon_error_mm":
                       round(float(rec["mean_error_mm"][i]), 4),
                   "error": ""}
            if "mahalanobis_to_healthy" in rep:
                row["mahalanobis_to_healthy"] = round(
                    rep["mahalanobis_to_healthy"], 4)
            for cls, p in sorted(rep["posteriors"].items()):
                row[f"p_{cls}"] = round(p, 6)
            rows.append(row)
            if args.save_recons:
                write_obj(os.path.join(
                    args.out, os.path.splitext(name)[0] + "_recon.obj"),
                    rec["vertices"][i], faces)
    for name, reason in skipped:
        rows.append({"file": name, "label": "", "error": reason})
    rows.sort(key=lambda r: r["file"])

    fields = ["file", "label", "mean_recon_error_mm",
              "mahalanobis_to_healthy"]
    fields += sorted({k for r in rows for k in r if k.startswith("p_")})
    fields.append("error")
    csv_path = os.path.join(args.out, "diagnoses.csv")
    with open(csv_path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fields, restval="")
        w.writeheader()
        w.writerows(rows)

    labels = {}
    for r in rows:
        if r["label"]:
            labels[r["label"]] = labels.get(r["label"], 0) + 1
    errs = [r["mean_recon_error_mm"] for r in rows
            if r.get("mean_recon_error_mm", "") != ""]
    summary = {"run_dir": run_dir, "n_scans": len(names),
               "n_diagnosed": len(loaded), "n_skipped": len(skipped),
               "labels": labels,
               "mean_recon_error_mm":
                   round(float(np.mean(errs)), 4) if errs else None,
               "max_recon_error_mm":
                   round(float(np.max(errs)), 4) if errs else None,
               "model": args.model, "wall_s": round(time.time() - t0, 2),
               "service": service.stats()}
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)

    print(f"[batch_diagnose] {len(loaded)} diagnosed, {len(skipped)} "
          f"skipped → {csv_path}")
    print(f"[batch_diagnose] labels: {labels}  mean recon "
          f"{summary['mean_recon_error_mm']} mm")
    return summary


if __name__ == "__main__":
    main()

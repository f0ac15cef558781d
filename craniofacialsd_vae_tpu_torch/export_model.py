"""Ahead-of-time export of a trained run's serving programs (counterpart
of ``tools/export_model.py``).

    python -m craniofacialsd_vae_tpu_torch.export_model --id=run1
        [--output_path=.] [--run_dir DIR] [--out outputs/run1/export]
        [--buckets 1 4 16] [--platforms cpu cuda] [--device cpu]
        [--verify]

Writes the three raw-scan-space serving programs (encode, decode,
reconstruct: ``serving.build_raw_programs``) at each static batch bucket
as self-contained ``torch.export`` artifacts (``export.py``): weights,
spiral and pool tables, the kernels' vertex tiles, the normalization and
the mm scale are inside them. The directory runs through
``craniofacialsd_vae_tpu_torch.export.load_exported`` with no checkpoint,
geometry or template, on the card or the host; the artifact calls the
port's kernels as custom ops, so it needs the port's
``ops/library.py`` importable (the manifest's ``ops_module``).

``--device`` is the device the run is loaded and traced on (default: the
card); ``--platforms`` the devices the artifact may be loaded on.
``--verify`` reloads the artifacts on ``--device`` and runs every program
at every bucket once on random inputs, checking shapes and finiteness
(the numbers against the live service are held by
``tests/test_torch_export.py``).
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def verify_artifacts(out_dir: str, device=None) -> None:
    """Reload the written programs and run every bucket once."""
    from .export import load_exported

    model = load_exported(out_dir, device=device)
    rng = np.random.default_rng(0)
    for b in model.buckets:
        raw = rng.normal(size=(b, model.n_vertices, 3)).astype(np.float32)
        mu = model.encode(raw)
        if mu.shape != (b, model.latent_size):
            raise AssertionError(f"encode gave {mu.shape} at bucket {b}")
        out = model.decode(mu)
        if out.shape != raw.shape:
            raise AssertionError(f"decode gave {out.shape} at bucket {b}")
        rec = model.reconstruct(raw)
        for key in ("recon", "error_mm", "mu"):
            if not np.all(np.isfinite(rec[key])):
                raise AssertionError(f"non-finite {key} at bucket {b}")
        print(f"  bucket {b}: encode/decode/reconstruct ok "
              f"(mean recon err {float(rec['error_mm'].mean()):.3f} mm)")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--id", type=str, default=None)
    parser.add_argument("--output_path", type=str, default=".")
    parser.add_argument("--run_dir", type=str, default=None,
                        help="explicit run dir (overrides --id)")
    parser.add_argument("--out", type=str, default=None,
                        help="artifact dir (default <run_dir>/export)")
    parser.add_argument("--buckets", type=int, nargs="+", default=[1, 4, 16])
    parser.add_argument("--platforms", type=str, nargs="+",
                        default=["cpu", "cuda"],
                        help="devices the artifact may be loaded on "
                             "(written into its manifest)")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device the run is loaded and traced on "
                             "(default: the card)")
    parser.add_argument("--verify", action="store_true")
    args = parser.parse_args(argv)

    if args.run_dir is None:
        if args.id is None:
            parser.error("one of --id or --run_dir is required")
        args.run_dir = os.path.join(args.output_path, "outputs", args.id)

    from .export import export_run_dir

    out_dir = args.out or os.path.join(args.run_dir, "export")
    manifest = export_run_dir(args.run_dir, out_dir,
                              buckets=tuple(args.buckets),
                              platforms=tuple(args.platforms),
                              device=args.device)
    n_files = len(manifest["programs"])
    total = sum(os.path.getsize(os.path.join(out_dir, e["file"]))
                for e in manifest["programs"].values())
    print(f"exported {n_files} programs ({total / 1e6:.1f} MB) to {out_dir} "
          f"[platforms {','.join(manifest['platforms'])}, "
          f"buckets {manifest['buckets']}]")
    if args.verify:
        verify_artifacts(out_dir, device=args.device)
        print("verification passed")
    return manifest


if __name__ == "__main__":
    main()

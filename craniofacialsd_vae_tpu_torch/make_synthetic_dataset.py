"""Generate a synthetic craniofacial-style dataset for smoke training and
demos when the clinical dataset is unavailable (counterpart of
``tools/make_synthetic_dataset.py``).

Takes the template (or a synthetic octasphere), applies per-class smooth
low-frequency deformation signatures and per-sample noise over the
Laplacian's k smallest eigenvectors, and writes class-prefixed OBJ files
(``a_/c_/m_/n_/b_<i>.obj``) in the data pipeline's naming.

Two difficulty modes:

* default (easy): each class gets an independent random signature, about
  3× the per-sample noise: the classes are near-separable;
* ``--hard``: all classes share a base deformation; a class is a small
  offset along a random unit direction whose magnitude is
  ``--separation`` × the per-sample coefficient noise, plus iid
  per-vertex noise (``--vertex_noise``), so classifier heads land inside
  (0, 1).

The draws are numpy's, in the JAX tool's order, and the basis is solved
on the host by ARPACK (``ops.eigh.laplacian_eigendecomposition(backend=
"scipy")``), as the JAX tool solves it: the same seed and basis give the
same files. It needs no card.

    python -m craniofacialsd_vae_tpu_torch.make_synthetic_dataset \\
        --out data_synth --n 60 [--hard]
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def generate_dataset(out: str, n: int, template=None,
                     template_path: str | None = None, seed: int = 0,
                     k_modes: int = 20, hard: bool = False,
                     separation: float = 2.2, vertex_noise: float = 0.002,
                     classes=("a", "c", "m", "n", "b"),
                     coeff_scale: float = 0.03,
                     sample_noise: float = 0.01) -> int:
    """Write ``n`` class-prefixed OBJ meshes under ``out`` (at least 2 a
    class, ``n // len(classes)`` each); returns the number written.
    ``template`` (a loaded ``Template``) wins over ``template_path``;
    without either, the coloured octasphere of subdivision 4."""
    from .geometry import load_template, write_obj
    from .geometry.synthetic import synthetic_template
    from .ops.eigh import laplacian_eigendecomposition

    if template is None:
        if template_path and os.path.exists(template_path):
            template = load_template(template_path)
        else:
            template = synthetic_template(subdivisions=4, n_regions=15)

    rng = np.random.default_rng(seed)
    _, eigvecs = laplacian_eigendecomposition(template, k=k_modes,
                                              backend="scipy")

    if hard:
        # a shared base shape; a class is an offset of separation ×
        # sample_noise along a random unit direction in coefficient space
        base = rng.normal(size=(k_modes, 3)) * coeff_scale
        signatures = {}
        for c in classes:
            d = rng.normal(size=(k_modes, 3))
            d /= np.linalg.norm(d)
            signatures[c] = base + separation * sample_noise * d
    else:
        signatures = {c: rng.normal(size=(k_modes, 3)) * coeff_scale
                      for c in classes}

    os.makedirs(out, exist_ok=True)
    per_class = max(n // len(classes), 2)
    for c in classes:
        for i in range(per_class):
            coeff = signatures[c] + rng.normal(
                size=(k_modes, 3)) * sample_noise
            verts = template.pos + eigvecs @ coeff
            if hard and vertex_noise > 0:
                # noise outside the smooth basis
                verts = verts + rng.normal(size=verts.shape) * vertex_noise
            write_obj(os.path.join(out, f"{c}_{i}.obj"), verts,
                      template.face)
    return per_class * len(classes)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", type=str, required=True)
    parser.add_argument("--n", type=int, default=60,
                        help="total meshes across classes a/c/m/n/b")
    parser.add_argument("--template", type=str, default=None,
                        help="coloured template PLY (default, or where it "
                             "does not exist: the octasphere of "
                             "subdivision 4)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--k_modes", type=int, default=20,
                        help="number of smooth deformation modes")
    parser.add_argument("--hard", action="store_true",
                        help="overlapping class distributions + per-vertex "
                             "noise: classifier heads land inside (0, 1)")
    parser.add_argument("--separation", type=float, default=2.2,
                        help="hard mode: class-mean offset in units of the "
                             "per-sample coefficient noise")
    parser.add_argument("--vertex_noise", type=float, default=0.002,
                        help="hard mode: iid per-vertex noise std in "
                             "template units")
    args = parser.parse_args(argv)

    n = generate_dataset(args.out, args.n, template_path=args.template,
                         seed=args.seed, k_modes=args.k_modes,
                         hard=args.hard, separation=args.separation,
                         vertex_noise=args.vertex_noise)
    mode = f"hard (separation {args.separation})" if args.hard else "easy"
    print(f"wrote {n} meshes to {args.out} ({mode})")
    return n


if __name__ == "__main__":
    main()

"""Time K9 of this checkout against K9 of another checkout, on one card,
in turns (other, this, this, other at each form).

Run from the root of a checkout, on a machine with one CUDA card::

    python -m craniofacialsd_vae_tpu_torch.k9_compare --other PATH
        [--reps 50] [--json PATH]

``--other`` is the root of another checkout of the port (for example the
parent commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists); its kernels are built there. Each side runs K9 as
its own eigensolver does on the card: with the vertex tiles of its
``ops.eigh`` (``build_k9_tiles``) and in the panel layout of its solver
(``eigh.panel``: rows at a padded stride) where the checkout has them,
else on the bare ELL table and contiguous panels.

Shape: the k = 1000 solve's, the octasphere of subdivision 6 (16,386
vertices, ELL K = 7) and a panel of 1,125 columns. Forms: the filter
step (b ≠ 0), a b = 0 step and the residual (a per-column c); then the
same filter step and b = 0 step on a diagonal-only table (``cols =
arange(N)[:, None]``, K = 1, the degrees as values: no gather, the
stream-only floor). The two sides' outputs are held bit-equal. Then each
side's k = 1000 Chebyshev solve of the same octasphere (its
``_chebyshev_smallest``, host clock, in the same turns after one warm-up
solve): its seconds without the host's float64 polish, whose time does
not depend on K9, and its filter seconds; the two sides' passes must
agree and their eigenvalues agree within 1e-6.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import torch

from . import kernels
from .geometry import synthetic_template
from .k1_sweep import cuda_ms
from .ops import eigh

SUBDIVISIONS, BLOCK, SEED, K = 6, 1125, 20, 1000


def load_other(root: str) -> tuple:
    """The other checkout's ``kernels`` and ``ops.eigh``, imported under
    another package name."""
    name = "k9_other_port"
    init = os.path.join(root, "craniofacialsd_vae_tpu_torch", "__init__.py")
    spec = importlib.util.spec_from_file_location(
        name, init, submodule_search_locations=[os.path.dirname(init)])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[name] = pkg
    spec.loader.exec_module(pkg)
    return (importlib.import_module(name + ".kernels"),
            importlib.import_module(name + ".ops.eigh"))


def side(kern, eig, pos: np.ndarray):
    """(step maker, panel layout) of one checkout: ``make(cols, vals)``
    returns ``step(x, c, a, b, p)`` as its solver launches K9, and
    ``layout(t)`` copies a panel into its solver's layout."""
    tiled = hasattr(eig, "build_k9_tiles")

    def make(cols, vals):
        if tiled:
            tiles = eig.build_k9_tiles(cols, pos)
            return lambda x, c, a, b, p: kern.cheby_step(
                cols, vals, x, c, a, b, p, tiles=tiles)
        return lambda x, c, a, b, p: kern.cheby_step(cols, vals, x, c, a, b,
                                                     p)

    def layout(t):
        if not hasattr(eig, "panel"):
            return t.contiguous()
        out = eig.panel(t.shape[0], t.shape[1], t.device)
        out.copy_(t)
        return out

    return make, layout


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--other", required=True,
                        help="root of the checkout to compare with")
    parser.add_argument("--reps", type=int, default=50)
    parser.add_argument("--json", metavar="PATH")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("k9_compare: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=120).stdout.strip()
    dev = torch.device("cuda")
    tpl = synthetic_template(SUBDIVISIONS, 3)
    lap = eigh._EllLaplacian(tpl, dev)
    n = tpl.num_vertices
    diag_cols = torch.arange(n, dtype=torch.int32, device=dev)[:, None]
    diag_vals = lap.vals.sum(1, keepdim=True).abs() + 1.0
    other = load_other(os.path.abspath(args.other))
    sides = {"this": side(kernels, eigh, tpl.pos),
             "other": side(*other, tpl.pos)}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((n, BLOCK), generator=gen, device=dev)
    p = torch.randn((n, BLOCK), generator=gen, device=dev)
    theta = torch.rand((BLOCK,), generator=gen, device=dev) * 1.5
    lb = 1.4
    e, c = (lap.ub - lb) / 2, (lap.ub + lb) / 2
    sigma = e / -c
    sigma_new = 1.0 / (2.0 / sigma - sigma)
    c_vec = torch.full((BLOCK,), c, dtype=torch.float32, device=dev)
    body = (c_vec, 2.0 * sigma_new / e, sigma_new * sigma)
    forms = (("filter step", lap, body),
             ("b = 0", lap, (c_vec, sigma / e, 0.0)),
             ("residual", lap, (theta, 1.0, 0.0)),
             ("diagonal floor, filter step", None, body),
             ("diagonal floor, b = 0", None, (c_vec, sigma / e, 0.0)))
    results = {}
    for name, table, (cv, a, b) in forms:
        cols, vals = ((table.cols, table.vals) if table is not None
                      else (diag_cols, diag_vals))
        runs = {}
        for key, (make, layout) in sides.items():
            xs, ps = layout(x), layout(p)
            step = make(cols, vals)
            runs[key] = (lambda s=step, xs=xs, ps=ps: s(
                xs, cv, a, b, ps if b != 0.0 else None))
        outs = {key: run() for key, run in runs.items()}
        torch.cuda.synchronize()
        if not torch.equal(outs["this"], outs["other"]):
            err = float((outs["this"] - outs["other"]).abs().max())
            raise RuntimeError(f"{name}: the two sides differ ({err:.3e})")
        del outs
        times = {key: [] for key in sides}
        for key in ("other", "this", "this", "other"):
            times[key].append(cuda_ms(runs[key], args.reps))
        results[name] = times
        print(f"[k9 {name}: N={n} D={BLOCK} K={cols.shape[1]}] "
              + ", ".join(f"{k} {v[0]:.4f}/{v[1]:.4f} ms"
                          for k, v in times.items()) + "; bit-equal",
              flush=True)
    eighs = {"this": eigh, "other": other[1]}
    solve = {key: [] for key in eighs}
    evals = {}
    other[1]._chebyshev_smallest(tpl, K, device="cuda")    # warm-up
    for key in ("other", "this", "this", "other"):
        torch.cuda.synchronize()
        vals, _, info = eighs[key]._chebyshev_smallest(tpl, K, device="cuda")
        evals[key] = vals
        solve[key].append({"passes": info["passes"],
                           "without_polish_s": info["seconds"]
                           - info["polish_s"],
                           **{k: info[k] for k in ("seconds", "filter_s",
                                                   "polish_s", "setup_s",
                                                   "tiles_s") if k in info}})
    if len({r["passes"] for runs in solve.values() for r in runs}) != 1:
        raise RuntimeError(f"the solves took different passes: {solve}")
    rel = float((abs(evals["this"] - evals["other"])[1:]
                 / evals["other"][1:]).max())
    if rel > 1e-6:
        raise RuntimeError(f"the solves' eigenvalues differ by {rel:.3e}")
    print(f"[k9 solve k = {K}] " + ", ".join(
        f"{key} " + "/".join(f"{r['without_polish_s']:.3f}" for r in runs)
        + " s without the polish (filter " + "/".join(
            f"{r['filter_s']:.3f}" for r in runs) + ")"
        for key, runs in solve.items()) + f"; eigenvalues within {rel:.1e}",
        flush=True)
    line = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
            "n": n, "d": BLOCK, "results": results, "solve": solve,
            "solve_eigenvalues_rel": rel}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(line, f, indent=1)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())

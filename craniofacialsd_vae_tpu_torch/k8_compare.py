"""Time K8 of this checkout against K8 of another checkout, on one card,
in turns (other, this, this, other at each shape).

Run from the root of a checkout, on a machine with one CUDA card::

    python -m craniofacialsd_vae_tpu_torch.k8_compare --other PATH
        [--reps 50] [--json PATH]

``--other`` is the root of another checkout of the port (for example the
parent commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists); its kernels are built there. Each side runs what
its own ``_NearestSym`` runs on the card: the forward in both directions
(one ``nearest_sq_sym``, or two ``nearest_sq`` where the checkout has no
``nearest_sq_sym``) and the backward in the generated cloud with its CSR
of the argmins (built by ``k8_bwd`` itself, or by ``argmin_csr`` before
it). Shapes: the fit's 16 restarts of 4,097 points against its bucketed
8,192-point target, one restart, and the 16 restarts against a target of
7,500 points padded to 8,192 with copies of its first point. The two
sides' distances are held within 1e-5 of the largest.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys

import torch

from . import kernels
from .k1_sweep import cuda_ms
from .ops import distances

SHAPES = (("fit", 16, 4097, 8192, None), ("one", 1, 4097, 8192, None),
          ("padded", 16, 4097, 8192, 7500))


def load_other(root: str) -> tuple:
    """The other checkout's ``kernels`` and ``ops.distances``, imported
    under another package name."""
    name = "k8_other_port"
    init = os.path.join(root, "craniofacialsd_vae_tpu_torch", "__init__.py")
    spec = importlib.util.spec_from_file_location(
        name, init, submodule_search_locations=[os.path.dirname(init)])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[name] = pkg
    spec.loader.exec_module(pkg)
    return (importlib.import_module(name + ".kernels"),
            importlib.import_module(name + ".ops.distances"))


def side(kern, dist):
    """(forward, backward) of one checkout as its autograd Function runs
    them on the card."""
    if hasattr(kern, "nearest_sq_sym"):
        def fwd(x, y, mu):
            return kern.nearest_sq_sym(x, y, mu)

        def bwd(x, y, mu, gx, d_x, a, gy, d_y, b):
            return kern.nearest_sq_bwd(x, y, mu, gx, d_x, a, gy, d_y, b)
    else:
        def fwd(x, y, mu):
            d_x, a = kern.nearest_sq(x, y, mu)
            d_y, b = kern.nearest_sq(y, x, mu)
            return d_x, d_y, a, b

        def bwd(x, y, mu, gx, d_x, a, gy, d_y, b):
            perm, off = dist.argmin_csr(b, x.shape[1])
            return kern.nearest_sq_bwd(x, y, mu, gx, d_x, a, gy, d_y, perm,
                                       off)
    return fwd, bwd


def case(sides: dict, r: int, p: int, q: int, q_valid, reps: int) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(r * 7 + q)
    x = torch.randn((r, p, 3), generator=gen, device="cuda") * 0.5 + 1.0
    y = torch.randn((q, 3), generator=gen, device="cuda") * 0.5 + 1.0
    if q_valid is not None:
        y[q_valid:] = y[0]
    mu = y.mean(0)
    gx = torch.randn((r, p), generator=gen, device="cuda")
    gy = torch.randn((r, q), generator=gen, device="cuda")
    outs = {k: fb[0](x, y, mu) for k, fb in sides.items()}
    ref = outs["this"]
    scale = float(torch.maximum(ref[0].max(), ref[1].max()))
    for k, o in outs.items():
        err = max(float((o[0] - ref[0]).abs().max()),
                  float((o[1] - ref[1]).abs().max()))
        if err > 1e-5 * scale:
            raise RuntimeError(f"{k}: distances differ by {err:.3e}")
    times = {f"{k}_{part}": [] for k in sides for part in ("fwd", "bwd")}
    for k in ("other", "this", "this", "other"):
        fwd, bwd = sides[k]
        d_x, d_y, a, b = outs[k]
        times[f"{k}_fwd"].append(cuda_ms(lambda: fwd(x, y, mu), reps))
        times[f"{k}_bwd"].append(cuda_ms(
            lambda: bwd(x, y, mu, gx, d_x, a, gy, d_y, b), reps))
    return times


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--other", required=True,
                        help="root of the checkout to compare with")
    parser.add_argument("--reps", type=int, default=50)
    parser.add_argument("--json", metavar="PATH")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("k8_compare: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=120).stdout.strip()
    other = load_other(os.path.abspath(args.other))
    sides = {"this": side(kernels, distances), "other": side(*other)}
    results = {}
    for name, r, p, q, q_valid in SHAPES:
        results[name] = case(sides, r, p, q, q_valid, args.reps)
        print(f"[k8 {name}: R={r} P={p} Q={q} valid {q_valid or q}] "
              + ", ".join(f"{k} {v[0]:.4f}/{v[1]:.4f} ms"
                          for k, v in results[name].items()), flush=True)
    line = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
            "results": results}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(line, f, indent=1)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Time the eager serving pass and the eager training step of this
checkout against another checkout's, on one card, in turns.

Run from the root of a checkout, on a machine with one CUDA card::

    python -m craniofacialsd_vae_tpu_torch.eager_compare --other PATH
        [--reps 30] [--json PATH]

``--other`` is the root of another checkout of the port (for example the
parent commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists); its kernels are built there. Each side runs its
own code on the same inputs: ``configurations/smoke.yaml``'s model
(channels 32/32/32/64, latent 75, fp32) on the fixture's 17,039-vertex
hierarchy with seeded weights, its ``serving.build_raw_programs``
``reconstruct`` at B = 16 (the service's eager program, no CUDA graph)
and one ``make_train_step`` step on 4 scans (a 16-mesh swap grid, the
stand-in Laplacian and 15 stand-in regions). Each is timed on the host
clock from the call to ``torch.cuda.synchronize()``, ``--reps`` times
after a warm-up, in turns (other, this, this, other), and its median
reported; then one call of each under torch.profiler gives its device
time. The host's share is what a change of the Python dispatch (the
kernels as ``torch.library`` custom ops) moves; the device time should
stay. The two sides' reconstructions are held bit-equal.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from . import geometry, kernels, models, serving, training
from .bf16_compare import WEIGHTS, load_other, side_geometry, step_profile

SEED = 22
BATCH = 16
SCANS = 4
MODEL = dict(in_channels=3, out_channels=(32, 32, 32, 64), latent_size=75)
TO_MM = 89.11


def other_modules(root: str) -> dict:
    """The other checkout's modules (``bf16_compare.load_other``), with
    its ``serving``."""
    mods = load_other(root)
    pkg = mods["kernels"].__name__.rpartition(".")[0]
    mods["serving"] = importlib.import_module(f"{pkg}.serving")
    return mods


def side_calls(mods: dict, dev) -> dict:
    """That side's eager ``reconstruct`` at B = 16 and its fp32 training
    step, on seeded weights and inputs."""
    geom = side_geometry(mods, dev)
    m, t = mods["models"], mods["training"]
    cfg = m.SDVAEConfig(**MODEL)
    model = m.init_sdvae(cfg, geom, torch.Generator().manual_seed(SEED))
    model.eval()
    progs = mods["serving"].build_raw_programs(model, None, TO_MM)
    rng = np.random.default_rng(SEED)
    n = geom.num_vertices
    x = torch.as_tensor(rng.normal(size=(BATCH, n, 3)).astype(np.float32),
                        device=dev)

    def reconstruct():
        with torch.inference_mode():
            return progs["reconstruct"](x)

    train_model = m.init_sdvae(cfg, geom,
                               torch.Generator().manual_seed(SEED))
    step = t.make_train_step(
        train_model, t.LossWeights.from_config(WEIGHTS),
        t.coupled_adam(train_model.parameters(), 1e-4, 0), SCANS)
    scans = torch.as_tensor(rng.normal(size=(SCANS, n, 3)).astype(
        np.float32), device=dev)
    eps = torch.as_tensor(rng.normal(size=(SCANS ** 2, cfg.latent_size))
                          .astype(np.float32), device=dev)
    return {"reconstruct": reconstruct,
            "step": lambda: step(scans, region_idx=3, eps=eps)}


def host_p50(fn, reps: int) -> float:
    """Median ms from the call to the card's synchronize, warm."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return sorted(ts)[len(ts) // 2]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--other", required=True,
                        help="root of the checkout to compare with")
    parser.add_argument("--reps", type=int, default=30)
    parser.add_argument("--json", metavar="PATH")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("eager_compare: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=120).stdout.strip()
    print(f"card: {smi}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    this = {"kernels": kernels, "geometry": geometry, "models": models,
            "serving": serving, "training": training}
    sides = {"other": other_modules(os.path.abspath(args.other)),
             "this": this}
    calls = {}
    for key, mods in sides.items():
        mods["kernels"].build()
        calls[key] = side_calls(mods, dev)
    recon = {key: [r.cpu() for r in c["reconstruct"]()]
             for key, c in calls.items()}
    for a, b in zip(recon["other"], recon["this"]):
        if not torch.equal(a, b):
            raise RuntimeError("the two sides' reconstructions differ")
    res = {"card": smi, "batch": BATCH, "scans": SCANS}
    for what in ("reconstruct", "step"):
        t = {"other": [], "this": []}
        for key in ("other", "this", "this", "other"):
            t[key].append(host_p50(calls[key][what], args.reps))
        prof = {key: step_profile(calls[key][what]) for key in t}
        res[what] = {"host_p50_ms": t, "device": prof}
        print(f"eager {what}: host p50 other {t['other'][0]:.3f} / "
              f"{t['other'][1]:.3f} ms, this {t['this'][0]:.3f} / "
              f"{t['this'][1]:.3f}; device other "
              f"{prof['other']['device_ms']:.4f} ms in "
              f"{prof['other']['kernels']} kernels, this "
              f"{prof['this']['device_ms']:.4f} ms in "
              f"{prof['this']['kernels']} ({smi})", flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

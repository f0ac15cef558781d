"""Time K3b's backward of this checkout against another checkout's, on
one card, in turns (other, this, this, other at each shape), and one
mixed training step of each side's own model.

Run from the root of a checkout, on a machine with one CUDA card::

    python -m craniofacialsd_vae_tpu_torch.k3b_compare --other PATH
        [--reps 50] [--sweep] [--json PATH]

``--other`` is the root of another checkout of the port (for example the
parent commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists); its kernels are built there. Each side builds the
final conv's spiral op with its own ``ops.build_spiral_op`` and launches
its own ``kernels.out_gather_sum_bwd(dout, op.out_bwd)``, as its
``_OutGatherSum.backward`` does.

Shapes: the final conv (32 -> 3, L = 9) of the ``mixed`` path on the
fixture's level 0 (17,039 vertices) at B = 16, 4 and 1, and on the
octasphere's level 0 (16,386 vertices, the diagnosis path's template) at
R = 16, the fit's restarts. The two sides' outputs are held bit-equal;
each line gives the bound (du written once, dout and this side's runs
read once, at 3.35 TB/s). Then one mixed training step of each side's
own model, profiled in the same turns (``bf16_compare.step_of``): its
device time and the kernels it ran. ``--sweep`` also times this side's
runs at other sizes (vertices and staged rows a run) and block sizes at
each shape, each held bit-equal to the default's.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import types

import numpy as np
import torch

from . import geometry, kernels, models, ops, training
from .bf16_compare import in_turns, side_geometry, step_of, step_profile
from .k1_sweep import _FIXTURE, cuda_ms

SEED = 15
BATCHES = (16, 4, 1)
FIT_RESTARTS = 16
OCTASPHERE_SUBDIVISIONS = 6
HBM_BYTES_PER_MS = 3.35e9               # H100 SXM: 3.35 TB/s
SWEEP_VERTS = (16, 32, 64)
SWEEP_ROWS = (256, 512)
SWEEP_THREADS = (128, 192, 256)


def load_other(root: str, name: str = "k3b_other_port") -> dict:
    """The other checkout's modules, imported under the package name
    ``name``. Its ``ops.library`` stays an empty module: this side has
    registered the custom-op namespace, a second registration fails, and
    the comparisons call none of the other side's forward ops."""
    sys.modules[f"{name}.ops.library"] = types.ModuleType(
        f"{name}.ops.library")
    init = os.path.join(root, "craniofacialsd_vae_tpu_torch", "__init__.py")
    spec = importlib.util.spec_from_file_location(
        name, init, submodule_search_locations=[os.path.dirname(init)])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[name] = pkg
    spec.loader.exec_module(pkg)
    return {m: importlib.import_module(f"{name}.{m}")
            for m in ("kernels", "ops", "geometry", "models", "training")}


def tables() -> dict:
    """The final conv's spiral tables: the fixture's and the octasphere's
    level 0, ``[N, 9]``."""
    out = {"fixture": np.asarray(geometry.load_bundle(_FIXTURE).spirals[0])}
    pos, face = geometry.octasphere(OCTASPHERE_SUBDIVISIONS)
    out["octasphere"] = geometry.extract_spirals(np.asarray(face),
                                                 np.asarray(pos), 9)
    return out


def bound_ms(runs, n_out: int, seq: int, batch: int, o: int) -> float:
    """du written once, dout and the runs read once, over the card's
    memory rate."""
    lists = sum(t.numel() for t in (runs.starts, runs.rows, runs.row_off,
                                    runs.blob, runs.blob_off, runs.pos))
    return 4 * (seq * o * runs.n_src * batch + n_out * batch * o
                + lists) / HBM_BYTES_PER_MS


def sweep(op, dout, reps: int) -> list:
    """This side's runs and block sizes at one shape: ``(ms, label)``,
    the default first; each bit-equal to the default."""
    host = op.out_bwd.to("cpu")
    ref = kernels.out_gather_sum_bwd(dout, op.out_bwd)
    plan = kernels.out_gather_bwd_plan(op.out_bwd.runs, dout.shape[1],
                                       dout.shape[2])
    rows = [(cuda_ms(lambda: kernels.out_gather_sum_bwd(dout, op.out_bwd),
                     reps), f"default ({plan[2]} threads)")]
    for verts in SWEEP_VERTS:
        for max_rows in SWEEP_ROWS:
            runs = ops.build_out_gather_runs(host, verts, max_rows).to(
                dout.device)
            bwd = dataclasses.replace(op.out_bwd, runs=runs)
            for threads in SWEEP_THREADS:
                fn = (lambda bwd=bwd, t=threads: kernels.out_gather_sum_bwd(
                    dout, bwd, threads=t))
                out = fn()
                torch.cuda.synchronize()
                if not torch.equal(out, ref):
                    raise RuntimeError(f"runs {verts}/{max_rows}, {threads} "
                                       "threads: differs from the default")
                bs, smem, _ = kernels.out_gather_bwd_plan(
                    runs, dout.shape[1], dout.shape[2])
                rows.append((cuda_ms(fn, reps),
                             f"verts {verts} rows {max_rows} threads "
                             f"{threads}: {runs.n_runs} runs, at most "
                             f"{runs.max_rows} rows, slice {bs}, smem "
                             f"{smem}"))
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--other", required=True,
                        help="root of the checkout to compare with")
    parser.add_argument("--reps", type=int, default=50)
    parser.add_argument("--sweep", action="store_true")
    parser.add_argument("--json", metavar="PATH")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("k3b_compare: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=120).stdout.strip()
    print(f"card: {smi}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    this = {"kernels": kernels, "ops": ops, "geometry": geometry,
            "models": models, "training": training}
    sides = {"other": load_other(os.path.abspath(args.other)), "this": this}
    for mods in sides.values():
        mods["kernels"].build()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    res = {"card": smi, "k3b_bwd": {}, "sweep": {}}
    shapes = [("fixture", b) for b in BATCHES] + [("octasphere",
                                                   FIT_RESTARTS)]
    for name, table in tables().items():
        op = {key: mods["ops"].build_spiral_op(table).to(dev)
              for key, mods in sides.items()}
        n, seq = table.shape
        for mesh, batch in shapes:
            if mesh != name:
                continue
            dout = torch.randn((n, batch, 3), generator=gen, device=dev)
            fns = {key: (lambda k=sides[key]["kernels"], o=op[key]:
                         k.out_gather_sum_bwd(dout, o.out_bwd))
                   for key in sides}
            outs = {key: fn() for key, fn in fns.items()}
            torch.cuda.synchronize()
            if not torch.equal(outs["this"], outs["other"]):
                raise RuntimeError(f"{name} B={batch}: the sides differ")
            del outs
            t = in_turns(fns, args.reps)
            runs = op["this"].out_bwd.runs
            b_ms = bound_ms(runs, n, seq, batch, 3)
            print(f"K3b backward {name} B={batch}: other "
                  f"{t['other'][0]:.4f} / {t['other'][1]:.4f} ms, this "
                  f"{t['this'][0]:.4f} / {t['this'][1]:.4f}; bound "
                  f"{b_ms:.5f} ({runs.n_runs} runs, at most "
                  f"{runs.max_rows} rows); bit-equal", flush=True)
            res["k3b_bwd"][f"{name} {batch}"] = {"ms": t, "bound_ms": b_ms}
            if args.sweep:
                rows = sweep(op["this"], dout, args.reps)
                best = sorted(rows)
                print(f"sweep {name} B={batch}: default {rows[0][0]:.4f} ms;"
                      " best " + "; ".join(f"{ms:.4f} [{d}]"
                                           for ms, d in best[:4]),
                      flush=True)
                res["sweep"][f"{name} {batch}"] = rows
        del op
    steps = {}
    for key, mods in sides.items():
        s = {"mods": mods}
        s["geom"] = side_geometry(mods, dev)
        steps[key] = step_of(s, dev)
    prof = {"other": [], "this": []}
    for key in ("other", "this", "this", "other"):
        prof[key].append(step_profile(steps[key]))
    for key in ("other", "this"):
        print(f"mixed step, {key}: device " + " / ".join(
            f"{p['device_ms']:.4f} ms in {p['kernels']} kernels"
            for p in prof[key]), flush=True)
    res["step"] = prof
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Time K2-dW's candidate plans for the training step's spiral convs on
the card, beside the plan that ``kernels.plan_spiral_conv_dw`` picks.

Run from the root of a checkout, on a machine with one CUDA card::

    python -m craniofacialsd_vae_tpu_torch.k2_sweep [--batches 16 1]
        [--json PATH]

For each conv of the smoke model (channels 32/32/32/64 on the fixture's
17,039-vertex hierarchy) and each batch size (16: the step's swap grid)
it builds the plans of every tile size (16, 32 or 64 reduction rows),
ring depth (2 to 4 stages) and blocks per SM (1 to 3) that fit in shared
memory, checks each against the plain twin (rtol 1e-5 of max |dW|, two
launches bit-equal), times it with CUDA events, and prints the planner's
plan and the fastest few. ``--json`` writes every timing. The planner's
rule (``kernels.plan_spiral_conv_dw``) was chosen from this sweep.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

from . import kernels, ops
from .geometry import load_bundle
from .k1_sweep import _FIXTURE, CONVS, cuda_ms
from .models import SpiralGeometry


def candidates(m: int, b: int, seq: int, c_in: int, c_out: int) -> list:
    """The planner's plan, then every plan of the swept sizes that fits."""
    plans = [kernels.plan_spiral_conv_dw(m, b, seq, c_in, c_out)]
    for rows in (16, 32, 64):
        for stages in (2, 3, 4):
            for per_sm in (1, 2, 3):
                plan = kernels._dw_plan(m, b, seq, c_in, c_out, True, True,
                                        rows, stages, per_sm)
                if plan.smem <= min(kernels._SMEM_BLOCK,
                                    kernels._SMEM_SM // per_sm
                                    - kernels._SMEM_RESERVED):
                    plans.append(plan)
    return list(dict.fromkeys(plans))


def describe(plan) -> str:
    return (f"P {plan.positions}, {plan.tmv} vertices a tile, "
            f"{plan.stages} stages, {plan.threads} threads x "
            f"{plan.n_chunks}x{plan.groups}x{plan.zm * plan.zn} blocks, "
            f"{plan.smem} B")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--batches", type=int, nargs="+", default=[16, 1])
    parser.add_argument("--json", metavar="PATH")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("k2_sweep: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    dev = torch.device("cuda")
    geom = SpiralGeometry.from_bundle(load_bundle(_FIXTURE), device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {"card": smi, "convs": {}}
    for b in args.batches:
        chosen_total = best_total = 0.0
        for name, c_in, c_out in CONVS:
            level = 0 if name == "final" else int(name[-1])
            op = (geom.enc_spirals if name.startswith("enc")
                  else geom.spirals)[level]
            m, seq = op.num_vertices, op.seq_length
            x = torch.randn((op.n_src, b, c_in), generator=gen, device=dev)
            dy = torch.randn((m, b, c_out), generator=gen, device=dev)
            ref = ops.spiral_conv_dw_plain(x, op.table, dy)
            scale = float(ref.abs().max())
            rows = []
            for plan in candidates(m, b, seq, c_in, c_out):
                def run(plan=plan):
                    return kernels.spiral_conv_dw(x, op.table, dy, plan=plan)
                out, again = run(), run()
                torch.cuda.synchronize()
                err = float((out - ref).abs().max())
                if err > 1e-5 * scale or not torch.equal(out, again):
                    raise SystemExit(f"{name} B={b}: {describe(plan)} "
                                     f"err {err:.3e}")
                rows.append((cuda_ms(run), plan))
            chosen = rows[0]
            rows.sort(key=lambda r: r[0])
            chosen_total += chosen[0]
            best_total += rows[0][0]
            print(f"B={b} {name}: planner {chosen[0]:.4f} ms "
                  f"[{describe(chosen[1])}]; best of {len(rows)}:", flush=True)
            for t, plan in rows[:3]:
                print(f"    {t:.4f} ms  {describe(plan)}")
            results["convs"][f"{name}@{b}"] = [
                {"ms": t, "chosen": plan == chosen[1],
                 "plan": plan.as_ints(), "describe": describe(plan)}
                for t, plan in rows]
        print(f"B={b}: planner {chosen_total:.4f} ms per step, best plans "
              f"{best_total:.4f} ms", flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

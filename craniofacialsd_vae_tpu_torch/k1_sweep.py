"""Time every candidate K1 plan of the serving model's spiral convs on the
card, beside the plan that ``kernels.plan_spiral_conv`` picks.

Run from the root of a checkout, on a machine with one CUDA card::

    python -m craniofacialsd_vae_tpu_torch.k1_sweep [--batches 16 1]
        [--json PATH]

For each conv of the smoke model (channels 32/32/32/64 on the fixture's
17,039-vertex hierarchy) and each batch size it builds the candidate
tensor-core plans (tile rows, warp width, positions per stage, ring
stages, blocks per SM), checks each against the plain twin (rtol 1e-5 of
max |out|, two launches bit-equal), times it with CUDA events, and prints
the planner's plan and the fastest few. ``--json`` writes every timing.
The planner's size classes (``kernels._plan_tc``) were chosen from this
sweep.
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
from .models import SpiralGeometry

_FIXTURE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests", "fixtures", "geometry.npz")
# the smoke model's convs: (name, C_in, C_out)
CONVS = (("enc0", 3, 32), ("enc1", 32, 32), ("enc2", 32, 32),
         ("enc3", 32, 64), ("dec3", 64, 64), ("dec2", 64, 32),
         ("dec1", 32, 32), ("dec0", 32, 32), ("final", 32, 3))


def cuda_ms(fn, reps: int = 20) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back runs, warm,
    with the card kept busy while the host enqueues them."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(0.01 * 2e9))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def candidates(m: int, b: int, seq: int, c_in: int, c_out: int) -> list:
    """The planner's plan, then every tensor-core plan it could build."""
    plans = [kernels.plan_spiral_conv(m, b, seq, c_in, c_out)]
    if c_out < 8:
        return plans
    path = "tc" if c_in >= 8 else "tc_pad_k"
    vec = (c_in % 4 == 0, c_out % 4 == 0, c_out % 4 == 0)
    positions = [p for p in (1, 3, seq) if seq % p == 0
                 and (c_in < 8 or p < seq)]
    for t in kernels._tc_tiles(m, b, c_out):
        for p in positions:
            for stages in (2, 3, 5):
                for per_sm in (1, 2, 4):
                    plan = kernels._fit_tc(t, seq, c_in, p, stages, per_sm,
                                           path, vec)
                    if plan is not None and (m * b < 132 * 16
                                             or plan.blocks >= 132):
                        plans.append(plan)
    return list(dict.fromkeys(plans))


def describe(plan) -> str:
    if plan.path == "narrow_out":
        return (f"narrow tb {plan.tb}, {plan.threads} threads x "
                f"{plan.blocks} blocks")
    return (f"P {plan.positions}, {plan.warps_m * 16 * plan.mi} rows, "
            f"warp {8 * plan.ni} cols, {plan.threads} threads x "
            f"{plan.grid[0]}x{plan.grid[1]} blocks, {plan.stages} stages, "
            f"{plan.smem} B")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--batches", type=int, nargs="+", default=[16, 1])
    parser.add_argument("--json", metavar="PATH")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("k1_sweep: needs a CUDA card", file=sys.stderr)
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
            w_l = torch.randn((seq, c_in, c_out), generator=gen,
                              device=dev) * 0.2
            bias = torch.randn(c_out, generator=gen, device=dev)
            ref = ops.spiral_conv_plain(w_l, bias, x, op)
            scale = float(ref.abs().max())
            rows = []
            for plan in candidates(m, b, seq, c_in, c_out):
                def run(plan=plan):
                    return kernels.spiral_conv_fwd(x, op.table, w_l, bias,
                                                   plan=plan)
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
        print(f"B={b}: planner {chosen_total:.4f} ms per pass, best plans "
              f"{best_total:.4f} ms", flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

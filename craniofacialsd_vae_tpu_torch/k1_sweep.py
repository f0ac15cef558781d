"""Time every candidate K1 plan of the serving model's spiral convs on the
card, beside the plan that ``kernels.plan_spiral_conv`` picks.

Run from the root of a checkout, on a machine with one CUDA card::

    python -m craniofacialsd_vae_tpu_torch.k1_sweep [--batches 16 1]
        [--template fixture octasphere] [--json PATH]

For each conv of the smoke model (channels 32/32/32/64) on each
template's hierarchy (``fixture``: the 17,039-vertex hierarchy of
``tests/fixtures/geometry.npz``; ``octasphere``: the entry point's
stand-in template, the coloured octasphere of subdivision 6 with 16,386
vertices, simplified 4× per level) and each batch size it builds the
candidate plans (tensor core: tile rows, warp width, positions per
stage, ring stages, blocks per SM; narrow: batch rows and threads per
block of the tiled kernel, and the untiled kernel), checks each against
the plain twin (rtol 1e-5 of max |out|, two launches bit-equal), times
it with CUDA events beside the library form (``index_select`` and one
``linear``), and prints the planner's plan and the fastest few.
``--json`` writes every timing. The planner's rules
(``kernels._plan_tc``, ``_plan_narrow_tile``) were chosen from this
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
from .geometry import load_bundle, precompute_geometry, synthetic_template
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


def candidates(m: int, b: int, seq: int, c_in: int, c_out: int,
               tiles) -> list:
    """The planner's plan, then every plan of the same kernel family it
    could build: for C_out < 8 the tiled kernel at each batch tile and
    block size, and the untiled one; else the tensor-core plans."""
    plans = [kernels.plan_spiral_conv(m, b, seq, c_in, c_out,
                                      n_tiles=tiles.n_tiles,
                                      tile_rows=tiles.max_rows)]
    if c_out < 8:
        for tb in (8, 4, 2, 1) if (seq, c_in) == (9, 32) else ():
            for threads in (128, 256):
                plan = kernels.narrow_tile_plan(
                    b, c_in, tiles.n_tiles, tiles.max_rows, tb, threads, True)
                if plan.smem <= kernels._SMEM_BLOCK:
                    plans.append(plan)
        plans.append(kernels.plan_spiral_conv(m, b, seq, c_in, c_out))
        return list(dict.fromkeys(plans))
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
    if plan.path.startswith("narrow"):
        return (f"{plan.path} tb {plan.tb}, {plan.threads} threads x "
                f"{plan.blocks} blocks, {plan.smem} B")
    return (f"P {plan.positions}, {plan.warps_m * 16 * plan.mi} rows, "
            f"warp {8 * plan.ni} cols, {plan.threads} threads x "
            f"{plan.grid[0]}x{plan.grid[1]} blocks, {plan.stages} stages, "
            f"{plan.smem} B")


def sweep(geom, template: str, b: int, results: dict) -> None:
    """Every conv of the smoke model on ``geom`` at batch ``b``."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    chosen_total = best_total = lib_total = 0.0
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
        for plan in candidates(m, b, seq, c_in, c_out, op.tiles):
            def run(plan=plan):
                return kernels.spiral_conv_fwd(x, op.table, w_l, bias,
                                               plan=plan, tiles=op.tiles)
            out, again = run(), run()
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            if err > 1e-5 * scale or not torch.equal(out, again):
                raise SystemExit(f"{template} {name} B={b}: "
                                 f"{describe(plan)} err {err:.3e}")
            rows.append((cuda_ms(run), plan))
        x_bm = x.transpose(0, 1).contiguous()
        flat = op.table.reshape(-1).long()
        w_t = w_l.reshape(seq * c_in, c_out).t().contiguous()
        lib_ms = cuda_ms(lambda: torch.nn.functional.linear(
            x_bm.index_select(1, flat).view(b, m, seq * c_in), w_t, bias))
        chosen = rows[0]
        rows.sort(key=lambda r: r[0])
        chosen_total += chosen[0]
        best_total += rows[0][0]
        lib_total += lib_ms
        print(f"{template} B={b} {name} (M={m}): planner {chosen[0]:.4f} ms "
              f"[{describe(chosen[1])}], library {lib_ms:.4f} "
              f"(planner/library {chosen[0] / lib_ms:.2f}); best of "
              f"{len(rows)}:", flush=True)
        for t, plan in rows[:3]:
            print(f"    {t:.4f} ms  {describe(plan)}")
        results[f"{template}:{name}@{b}"] = {
            "library_ms": lib_ms,
            "plans": [{"ms": t, "chosen": plan == chosen[1],
                       "plan": plan.as_ints(), "describe": describe(plan)}
                      for t, plan in rows]}
    print(f"{template} B={b}: planner {chosen_total:.4f} ms per pass, best "
          f"plans {best_total:.4f} ms, library {lib_total:.4f} ms",
          flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--batches", type=int, nargs="+", default=[16, 1])
    parser.add_argument("--template", nargs="+", default=["fixture"],
                        choices=["fixture", "octasphere"])
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
    results = {"card": smi, "convs": {}}
    for template in args.template:
        if template == "fixture":
            bundle = load_bundle(_FIXTURE)
        else:
            bundle = precompute_geometry(synthetic_template(6, 15),
                                         [4, 4, 4, 4], [9] * 4, [1] * 4)
        geom = SpiralGeometry.from_bundle(bundle, device=dev)
        for b in args.batches:
            sweep(geom, template, b, results["convs"])
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

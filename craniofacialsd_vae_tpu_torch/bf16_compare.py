"""Time K1-bf16 and K2-dW-bf16 of this checkout against another
checkout's, on one card, in turns (other, this, this, other at each
shape), and one mixed training step of each side's own model.

Run from the root of a checkout, on a machine with one CUDA card::

    python -m craniofacialsd_vae_tpu_torch.bf16_compare --other PATH
        [--reps 50] [--sweep] [--json PATH]

``--other`` is the root of another checkout of the port (for example the
parent commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists); its kernels are built there. Each side launches
its kernels as its own model does: K1-bf16 with the op's vertex tiles,
K2-dW-bf16 with them where its wrapper takes them (``tiles=``).

Shapes: the ``mixed`` path's, ``configurations/craniofacial.yaml``'s
model (channels 32/32/32/64, L = 9) on the fixture's 17,039-vertex
hierarchy: K1-bf16 at its seven bf16 convs (enc1-3, dec3-0) at B = 16, 4
and 1, K2-dW-bf16 at those convs and the gather-first final conv (32 ->
3) over the step's 16-mesh grid. The two sides' outputs are held within
two bf16 ulps of each other (each is within one of its own twin). Then
one mixed training step of each side's own model (seeded weights, 4
scans, the stand-in Laplacian and 15 stand-in regions), profiled in the
same turns: its device time and the kernels it ran. ``--sweep`` also
times this side's candidate plans at each shape (K1-bf16: batch tiles,
column tiles, row tiles a warp and blocks an SM; K2-dW-bf16: batch
tiles, blocks an SM and batch runs a chunk), the planner's first.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import inspect
import json
import os
import subprocess
import sys

import numpy as np
import torch

from . import geometry, kernels, models, training
from .k1_sweep import _FIXTURE, cuda_ms

BF16 = torch.bfloat16
SEED = 14
BATCHES = (16, 4, 1)
GRID = 16                    # the step's swap grid: 4 scans, 16 meshes
REGIONS = 15
# the mixed path's bf16 convs: (name, C_in, C_out), and the final conv's
CONVS = (("enc1", 32, 32), ("enc2", 32, 32), ("enc3", 32, 64),
         ("dec3", 64, 64), ("dec2", 64, 32), ("dec1", 32, 32),
         ("dec0", 32, 32))
FINAL = ("final", 32, 3)
MODEL = dict(in_channels=3, out_channels=(32, 32, 32, 64), latent_size=75,
             compute_dtype="mixed")
WEIGHTS = dict(kl_weight=1e-4, laplacian_weight=0.1,
               latent_consistency_weight=0.5, latent_consistency_eta1=0.5,
               latent_consistency_eta2=0.5)


def load_other(root: str):
    """The other checkout's package, imported under another name."""
    name = "bf16_other_port"
    init = os.path.join(root, "craniofacialsd_vae_tpu_torch", "__init__.py")
    spec = importlib.util.spec_from_file_location(
        name, init, submodule_search_locations=[os.path.dirname(init)])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[name] = pkg
    spec.loader.exec_module(pkg)
    return {m: importlib.import_module(f"{name}.{m}")
            for m in ("kernels", "geometry", "models", "training")}


def side_geometry(mods: dict, dev):
    """The fixture's hierarchy as that side's ``SpiralGeometry``, with
    the stand-in Laplacian and regions, on the card."""
    g = mods["geometry"]
    bundle = g.load_bundle(_FIXTURE)
    return mods["models"].SpiralGeometry.from_bundle(
        bundle, device="cpu",
        laplacian=g.standin_laplacian_coo(bundle.spirals[0]),
        region_masks=g.standin_region_masks(g.level0_positions(bundle),
                                            REGIONS)).to(dev)


def op_of(geom, name: str):
    level = 0 if name == "final" else int(name[-1])
    return (geom.enc_spirals if name.startswith("enc") else
            geom.spirals)[level]


def ulps(got, want) -> float:
    """The largest difference of two bf16 arrays in bf16 ulps of the
    larger magnitude, the ulp taken at no less than 1e-5 of the max."""
    got, want = got.float(), want.float()
    mag = torch.maximum(got.abs(), want.abs()).clamp(min=2.0 ** -120)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7).clamp(
        min=1e-5 * float(want.abs().max()))
    return float(((got - want).abs() / ulp).max())


def conv_case(gen, op, b, c_in, c_out, dev) -> tuple:
    x = torch.randn((op.n_src, b, c_in), generator=gen, device=dev).to(BF16)
    w = (0.1 * torch.randn((op.seq_length, c_in, c_out), generator=gen,
                           device=dev)).to(BF16)
    bias = (0.1 * torch.randn(c_out, generator=gen, device=dev)).to(BF16)
    dy = torch.randn((op.num_vertices, b, c_out), generator=gen,
                     device=dev).to(BF16)
    return x, w, bias, dy


def in_turns(fns: dict, reps: int) -> dict:
    """``{"other": [t1, t2], "this": [t1, t2]}`` timed other, this, this,
    other."""
    t = {"other": [], "this": []}
    for key in ("other", "this", "this", "other"):
        t[key].append(cuda_ms(fns[key], reps))
    return t


def k1_calls(sides: dict, name, b, c_in, c_out, gen, dev) -> dict:
    x, w, bias, _ = conv_case(gen, op_of(sides["this"]["geom"], name), b,
                              c_in, c_out, dev)
    fns = {}
    for key, s in sides.items():
        op = op_of(s["geom"], name)
        fns[key] = (lambda k=s["mods"]["kernels"], op=op:
                    k.spiral_conv_fwd(x, op.table, w, bias, tiles=op.tiles))
    return fns


def k2_calls(sides: dict, name, c_in, c_out, gen, dev) -> dict:
    x, _, _, dy = conv_case(gen, op_of(sides["this"]["geom"], name), GRID,
                            c_in, c_out, dev)
    fns = {}
    for key, s in sides.items():
        op, k = op_of(s["geom"], name), s["mods"]["kernels"]
        tiled = "tiles" in inspect.signature(k.spiral_conv_dw).parameters
        fns[key] = (lambda k=k, op=op, tiled=tiled: k.spiral_conv_dw(
            x, op.table, dy, tiles=op.tiles) if tiled
            else k.spiral_conv_dw(x, op.table, dy))
    return fns


def compare(kind: str, label: str, fns: dict, reps: int) -> dict:
    outs = {key: fn() for key, fn in fns.items()}
    torch.cuda.synchronize()
    u = ulps(outs["this"], outs["other"])
    if not u <= 2.0:
        raise RuntimeError(f"{kind} {label}: the sides differ by {u:.2f} "
                           "bf16 ulps")
    t = in_turns(fns, reps)
    print(f"{kind} {label}: other {t['other'][0]:.4f} / "
          f"{t['other'][1]:.4f} ms, this {t['this'][0]:.4f} / "
          f"{t['this'][1]:.4f}; {u:.2f} ulps apart", flush=True)
    return {"ms": t, "ulps": u}


def step_profile(fn) -> dict:
    """One warm call of ``fn`` under torch.profiler: the device time of
    its kernels and their count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.self_device_time_total > 0]
    return {"device_ms": sum(r[0] for r in rows),
            "kernels": sum(r[1] for r in rows)}


def step_of(s: dict, dev):
    """A mixed training step of that side's model at the flagship
    widths, on fixed scans, region and noise."""
    models_, training_ = s["mods"]["models"], s["mods"]["training"]
    geom = s["geom"]
    cfg = models_.SDVAEConfig(**MODEL)
    model = models_.init_sdvae(cfg, geom, torch.Generator().manual_seed(SEED))
    weights = training_.LossWeights.from_config(WEIGHTS)
    step = training_.make_train_step(
        model, weights, training_.coupled_adam(model.parameters(), 1e-4, 0),
        4)
    rng = np.random.default_rng(SEED)
    n = geom.num_vertices
    x = torch.as_tensor(rng.normal(size=(4, n, 3)).astype(np.float32),
                        device=dev)
    eps = torch.as_tensor(rng.normal(size=(GRID, cfg.latent_size)).astype(
        np.float32), device=dev)
    return lambda: step(x, region_idx=3, eps=eps)


def sweep_k1(name, b, c_in, c_out, op, gen, dev, reps) -> list:
    """This side's K1-bf16 plans at one shape, the planner's first."""
    x, w, bias, _ = conv_case(gen, op, b, c_in, c_out, dev)
    t = op.tiles
    plans = [kernels.plan_spiral_conv(op.num_vertices, b, op.seq_length,
                                      c_in, c_out, True, True, BF16,
                                      t.n_tiles, t.max_rows)]
    for tb in (16, 8, 4, 2, 1):
        for nt in (8, 4, 2, 1):
            for mt in (1, 2):
                for per_sm in (1, 2):
                    p = kernels.bf16_vec_plan(b, op.seq_length, c_in, c_out,
                                              t.n_tiles, t.max_rows, tb, nt,
                                              mt, per_sm)
                    cap = min(kernels._SMEM_BLOCK, kernels._SMEM_SM
                              // per_sm - kernels._SMEM_RESERVED)
                    if 8 * nt < 2 * c_out and nt * mt <= 8 and p.smem <= cap:
                        plans.append(p)
    ref = kernels.spiral_conv_fwd(x, op.table, w, bias, tiles=t)
    rows = []
    for p in dict.fromkeys(plans):
        fn = lambda p=p: kernels.spiral_conv_fwd(x, op.table, w, bias, p,
                                                 tiles=t)
        out = fn()
        torch.cuda.synchronize()
        if ulps(out, ref) > 2.0:
            raise RuntimeError(f"K1-bf16 {name} B={b}: plan {p} differs")
        rows.append((cuda_ms(fn, reps), f"tb {p.tb} nt {p.nt} mt {p.mi} "
                     f"blocks {p.blocks} ({p.n_rtiles} items a slice) smem "
                     f"{p.smem}"))
    return rows


def sweep_k2(name, c_in, c_out, op, gen, dev, reps) -> list:
    """This side's K2-dW-bf16 plans at one shape, the planner's first."""
    x, _, _, dy = conv_case(gen, op, GRID, c_in, c_out, dev)
    t = op.tiles
    m, seq = op.num_vertices, op.seq_length
    plans = [kernels.plan_spiral_conv_dw_bf16(m, GRID, seq, c_in, c_out,
                                              t.n_tiles, t.max_rows,
                                              t.max_verts)]
    for tb in (16, 8, 4, 2, 1):
        for per_sm in (1, 2, 3):
            for bgroups in (None, 1, 2, 4, 8):
                p = kernels.dw_bf16_plan(m, GRID, seq, c_in, c_out,
                                         t.n_tiles, t.max_rows, t.max_verts,
                                         tb, per_sm, bgroups)
                if p.smem <= min(kernels._SMEM_BLOCK, kernels._SMEM_SM
                                 // per_sm - kernels._SMEM_RESERVED):
                    plans.append(p)
    ref = kernels.spiral_conv_dw(x, op.table, dy, tiles=t)
    rows = []
    for p in dict.fromkeys(plans):
        fn = lambda p=p: kernels.spiral_conv_dw(x, op.table, dy, p, tiles=t)
        out = fn()
        torch.cuda.synchronize()
        if ulps(out, ref) > 2.0:
            raise RuntimeError(f"K2-dW-bf16 {name}: plan {p} differs")
        rows.append((cuda_ms(fn, reps), f"tb {p.tb} chunks {p.n_chunks} "
                     f"({p.tpc} tiles x {p.bpc} batch tiles) smem {p.smem}"))
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
        print("bf16_compare: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=120).stdout.strip()
    print(f"card: {smi}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    this = {"kernels": kernels, "geometry": geometry, "models": models,
            "training": training}
    sides = {"other": {"mods": load_other(os.path.abspath(args.other))},
             "this": {"mods": this}}
    for s in sides.values():
        s["mods"]["kernels"].build()
        s["geom"] = side_geometry(s["mods"], dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    res = {"card": smi, "k1": {}, "k2": {}, "sweep": {}}
    for b in BATCHES:
        rows = {name: compare("K1-bf16", f"{name} B={b}", k1_calls(
            sides, name, b, c_in, c_out, gen, dev), args.reps)
            for name, c_in, c_out in CONVS}
        tot = {key: [sum(r["ms"][key][i] for r in rows.values())
                     for i in range(2)] for key in ("other", "this")}
        print(f"K1-bf16 a B={b} pass (7 convs): other {tot['other'][0]:.4f}"
              f" / {tot['other'][1]:.4f} ms, this {tot['this'][0]:.4f} / "
              f"{tot['this'][1]:.4f}", flush=True)
        res["k1"][b] = {"convs": rows, "pass": tot}
    rows = {name: compare("K2-dW-bf16", name, k2_calls(
        sides, name, c_in, c_out, gen, dev), args.reps)
        for name, c_in, c_out in CONVS + (FINAL,)}
    tot = {key: [sum(r["ms"][key][i] for n, r in rows.items()
                     if n != "final") for i in range(2)]
           for key in ("other", "this")}
    print(f"K2-dW-bf16 a step (7 convs): other {tot['other'][0]:.4f} / "
          f"{tot['other'][1]:.4f} ms, this {tot['this'][0]:.4f} / "
          f"{tot['this'][1]:.4f}", flush=True)
    res["k2"] = {"convs": rows, "step": tot}
    steps = {key: step_of(s, dev) for key, s in sides.items()}
    prof = {"other": [], "this": []}
    for key in ("other", "this", "this", "other"):
        prof[key].append(step_profile(steps[key]))
    for key in ("other", "this"):
        print(f"mixed step, {key}: device " + " / ".join(
            f"{p['device_ms']:.4f} ms in {p['kernels']} kernels"
            for p in prof[key]), flush=True)
    res["step"] = prof
    if args.sweep:
        geom = sides["this"]["geom"]
        for b in BATCHES:
            for name, c_in, c_out in CONVS:
                rows = sweep_k1(name, b, c_in, c_out, op_of(geom, name), gen,
                                dev, args.reps)
                best = sorted(rows)
                print(f"sweep K1-bf16 {name} B={b}: planner {rows[0][0]:.4f}"
                      f" ms [{rows[0][1]}]; best " + "; ".join(
                          f"{t:.4f} [{d}]" for t, d in best[:3]), flush=True)
                res["sweep"][f"k1 {name} {b}"] = rows
        for name, c_in, c_out in CONVS + (FINAL,):
            rows = sweep_k2(name, c_in, c_out, op_of(geom, name), gen, dev,
                            args.reps)
            best = sorted(rows)
            print(f"sweep K2-dW-bf16 {name}: planner {rows[0][0]:.4f} ms "
                  f"[{rows[0][1]}]; best " + "; ".join(
                      f"{t:.4f} [{d}]" for t, d in best[:3]), flush=True)
            res["sweep"][f"k2 {name}"] = rows
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Time K2-dx and K2-dx-bf16 (the spiral conv's input gradient,
``csrc/spiral_conv_dx.cu``) of this checkout against another checkout's,
on one card, in turns (other, this, this, other at each shape), or time
cut-down builds of a kernel to see what bounds it.

Run from the root of a checkout, on a machine with one CUDA card::

    python -m craniofacialsd_vae_tpu_torch.k2dx_compare --other PATH
        [--reps 30] [--json PATH]
    python -m craniofacialsd_vae_tpu_torch.k2dx_compare --parts
        [--batches 16 1] [--reps 30] [--json PATH]

``--other`` is the root of another checkout of the port (for example the
parent commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists); its kernels are built there. Each side builds its
spiral ops with its own ``ops.build_spiral_op`` and launches its own
``kernels.spiral_conv_dx`` with its own plan.

Comparison shapes: the training step's eight convs with dx (enc1–enc3,
dec3–dec0 and the gather-first final conv, 32 -> 3) on the fixture
hierarchy at B = 16 and B = 1, in fp32 and (the seven bf16 convs, then
the final conv's gather-first form) in bf16; the fit's decoder convs
(dec3–dec0 and the final conv; bf16: dec3–dec0) on the octasphere of
subdivision 6 at R = 16 restarts. At each shape the sides agree within
``DX_RTOL`` of max |dx| in fp32 and within one bf16 ulp in bf16, and each
side's ``du`` (its kernel built with the products replaced by a store of
``du``) is bit-equal to ``ops.spiral_conv_du_plain``. Each line gives
both sides' times, the replaced path's (``replaced_dx``: cuBLAS ``dg``,
the capped transposes, the adds) and the bound (``dx_bound``: dy, w and
the lists read once and dx written once, or the larger of the products'
time on the tensor cores and the adds' time). ``chip_smoke.py``'s
``k2dx_shape`` uses the same two functions.

``--parts`` builds this side's kernel with parts cut out of its source
text (``CUTS``, anchors that ``csrc/spiral_conv_dx.cu`` holds once), one
``nvcc`` a variant, all at once, into ``build/k2dx_parts/``: ``lists``
(the lists read, no dy gathered, no products), ``gather`` (no products
or dx stores), ``products`` (no dy gathered), and the kernel whole; each
at the step's fp32 and bf16 convs at each batch, at the planner's plan.
A cut kernel computes nothing useful: only its time is read. The
comparison holds the other side's ``du`` through the same cut, so the
other checkout's source must hold the anchors too.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import torch

from . import geometry, kernels, models, ops, training
from .bf16_compare import in_turns, op_of, side_geometry, ulps
from .k1_sweep import cuda_ms
from .k3b_compare import load_other

SEED = 24
BATCHES = (16, 1)
FIT_RESTARTS = 16
OCTASPHERE_SUBDIVISIONS = 6
DX_RTOL = 1e-5                  # chip_smoke.py's: 3xTF32 against fp32
PEAK_BYTES = 3.35e12            # H100 SXM: HBM bytes/s
PEAK_TF32 = 495e12              # dense tensor-core FLOP/s
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12               # outside the tensor cores
# the smoke model's convs with dx: (name, C_in, C_out), in autograd's order
STEP_CONVS = [("final", 32, 3), ("dec0", 32, 32), ("dec1", 32, 32),
              ("dec2", 64, 32), ("dec3", 64, 64), ("enc3", 32, 64),
              ("enc2", 32, 32), ("enc1", 32, 32)]
BF16_CONVS = [c for c in STEP_CONVS if c[0] != "final"] + [STEP_CONVS[0]]
FIT_CONVS = STEP_CONVS[:5]
_OUT = os.path.join(os.path.dirname(kernels._BUILD_ROOT), "k2dx_parts")

# Cuts of the kernel's source: (anchor it holds once, replacement). The
# "du" cut replaces the products by a store of du into the output, [n_src,
# B, L·C_out], by the first column block.
_DUMP = """
      if (blockIdx.z == 0) {
        T* du = static_cast<T*>(p.dx);
        const int w_ = pc * p.Cout;
        for (int e = threadIdx.x; e < p.tv * p.tb * w_; e += kThreads) {
          const int r = e / w_, q = e - r * w_;
          const int vi = r / p.tb, b = r - vi * p.tb;
          if (v0 + vi < p.n_src && b < bw)
            du[((size_t)(v0 + vi) * p.B + b0 + b) * p.L * p.Cout +
               l0 * p.Cout + q] = a[r * p.lda + q];
        }
      }
      continue;"""
_GATHER = "      gather_du<T, VEC>(p, sp, b0, bw, l0, pc, a);\n"
_MMA = "      __syncthreads();\n      if (!mma_warp) continue;\n"
_STORE = "    if (!mma_warp) continue;\n\n    // dx rows"
CUTS = {
    "no_gather": [(_GATHER, "")],
    "no_products": [(_MMA, "      __syncthreads();\n      continue;\n"),
                    (_STORE, "    continue;\n\n    // dx rows")],
    "du": [(_MMA, "      __syncthreads();" + _DUMP + "\n"),
           (_STORE, "    continue;\n\n    // dx rows")],
}
# the parts timed, and each variant's cuts
VARIANTS = {"kernel": (), "lists": ("no_gather", "no_products"),
            "gather": ("no_products",), "products": ("no_gather",),
            "du": ("du",)}
PARTS = ("kernel", "lists", "gather", "products")


def variants(source: str, names) -> dict:
    """The source with each variant's cuts, by variant name."""
    out = {}
    for name in names:
        text = source
        for cut in VARIANTS[name]:
            for anchor, repl in CUTS[cut]:
                if text.count(anchor) != 1:
                    raise SystemExit(
                        f"k2dx_compare: the cut {cut!r} finds its anchor "
                        "in csrc/spiral_conv_dx.cu not once; update CUTS")
                text = text.replace(anchor, repl)
        out[name] = text
    return out


def build_variants(sources: dict, csrc: dict) -> dict:
    """One nvcc per ``(side, variant)``, all at once, each with its side's
    headers; their ``cfs_spiral_conv_dx`` by key."""
    os.makedirs(_OUT, exist_ok=True)
    procs = {}
    for key, text in sources.items():
        stem = os.path.join(_OUT, "_".join(key))
        with open(stem + ".cu", "w") as f:
            f.write(text)
        procs[key] = subprocess.Popen(
            [kernels._nvcc(), *kernels._CFLAGS, "-shared", "-I",
             csrc[key[0]], stem + ".cu", "-o", stem + ".so"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for key, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"k2dx_compare: nvcc failed for {key}\n{log}")
        fn = ctypes.CDLL(os.path.join(_OUT, "_".join(key) + ".so")
                         ).cfs_spiral_conv_dx
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
            ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[key] = fn
    return fns


def raw_call(fn, dy, w_l, tab, n_src, plan, out):
    """One launch of a built variant into ``out``."""
    fields = plan.as_ints()
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())          # noqa: E731
    rc = fn(ptr(dy), ptr(w_l), ptr(tab.ptr),
            ptr(tab.idx if tab.idx.numel() else tab.ptr), ptr(out), n_src,
            dy.shape[0], w_l.shape[0], dy.shape[1], w_l.shape[1],
            dy.shape[2], int(dy.dtype == torch.bfloat16),
            (ctypes.c_int * len(fields))(*fields),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if rc:
        raise SystemExit(f"k2dx_compare: CUDA error {rc}")
    return out


def replaced_dx(op, dy, w_l):
    """The dx path K2-dx replaced (JAX's ``_score_bwd`` form, the port's
    backward before it): per column group one batched product ``dg = dy
    @ W_gᵀ`` (cuBLAS), the group's combined capped transpose applied to
    it (the capped K4, or K4), then the groups' parts and each identity
    column's ``dy @ W_iᵀ`` added."""
    m, bsz, c_out = dy.shape
    d2 = dy.reshape(m * bsz, c_out)
    dx = None
    for table, cols in zip(op.inv_tables, op.group_cols):
        if list(cols) == list(range(cols[0], cols[0] + len(cols))):
            w_g = w_l[cols[0]:cols[0] + len(cols)]
        else:
            w_g = torch.stack([w_l[i] for i in cols])
        dg = torch.bmm(d2.expand(len(cols), -1, -1), w_g.transpose(1, 2))
        part = table.apply(dg.view(len(cols) * m, bsz, -1))
        dx = part if dx is None else dx + part
    for i in op.identity_cols:
        part = dy @ w_l[i].T
        dx = part if dx is None else dx + part
    return dx


def dx_bound(op, batch, c_in, c_out, bf16) -> dict:
    """K2-dx's least time at one conv's shape: the larger of its bytes
    (dy, w and the lists read once, dx written once) over HBM's rate and
    its operations (the products on the tensor cores, 3xTF32 three TF32
    products and bf16 one, or the gathers' adds on the fp32 units, which
    run beside them). ``ms``, ``by`` ("bytes" or "operations"),
    ``bytes``, ``flops`` and ``ops_ms``."""
    es, seq = (2 if bf16 else 4), op.seq_length
    nbytes = (es * (op.num_vertices * batch * c_out + seq * c_in * c_out
                    + op.n_src * batch * c_in)
              + 4 * (op.dx.ptr.numel() + op.dx.idx.numel()))
    products = 2.0 * op.n_src * batch * seq * c_out * c_in
    adds = float(op.dx.idx.numel()) * batch * c_out
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = max(products / PEAK_BF16 if bf16 else 3 * products / PEAK_TF32,
                adds / PEAK_FP32) * 1e3
    return dict(ms=max(t_bytes, t_ops),
                by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, flops=products + adds, ops_ms=t_ops)


def fixture_ops(mods, dev) -> dict:
    geom = side_geometry(mods, dev)
    return {name: op_of(geom, name) for name, _, _ in STEP_CONVS}


def octasphere_ops(mods, tables, dev) -> dict:
    """The fit's decoder ops: levels 3 .. 0 of the octasphere, the final
    conv on level 0."""
    return {name: mods["ops"].build_spiral_op(
        tables[0 if name == "final" else int(name[-1])]).to(dev)
            for name, _, _ in FIT_CONVS}


def octasphere_tables() -> list:
    tpl = geometry.synthetic_template(OCTASPHERE_SUBDIVISIONS, 15)
    bundle = geometry.precompute_geometry(tpl, [4, 4, 4, 4], [9] * 4,
                                          [1] * 4)
    return [np.asarray(s) for s in bundle.spirals]


def case(gen, op, batch, c_in, c_out, dtype, dev) -> tuple:
    dy = torch.randn((op.num_vertices, batch, c_out), generator=gen,
                     device=dev).to(dtype)
    w_l = (0.2 * torch.randn((op.seq_length, c_in, c_out), generator=gen,
                             device=dev)).to(dtype)
    return dy, w_l


def compare(sides, du_fns, ops_by_side, convs, batch, dtype, reps, gen,
            dev, label) -> list:
    """Both sides at each conv of ``convs`` at ``batch``: held, timed."""
    bf16 = dtype == torch.bfloat16
    rows = []
    for name, c_in, c_out in convs:
        op = {key: o[name] for key, o in ops_by_side.items()}
        for t in ("ptr", "idx"):
            if not torch.equal(getattr(op["this"].dx, t),
                               getattr(op["other"].dx, t)):
                raise SystemExit(f"{label} {name}: the sides' lists differ")
        dy, w_l = case(gen, op["this"], batch, c_in, c_out, dtype, dev)
        n_src, seq = op["this"].n_src, op["this"].seq_length
        fns = {key: (lambda k=sides[key]["kernels"], o=op[key]:
                     k.spiral_conv_dx(dy, w_l, o.dx.ptr, o.dx.idx, n_src))
               for key in sides}
        outs = {key: fn() for key, fn in fns.items()}
        du_ref = ops.spiral_conv_du_plain(dy, op["this"].dx, seq)
        for key in sides:
            plan = sides[key]["kernels"].plan_spiral_conv_dx(
                n_src, batch, seq, c_in, c_out, bf16)
            du = torch.full((n_src, batch, seq * c_out), float("nan"),
                            dtype=dtype, device=dev)
            raw_call(du_fns[key], dy, w_l, op[key].dx, n_src, plan, du)
            torch.cuda.synchronize()
            if not torch.equal(du, du_ref):
                raise SystemExit(f"{label} {name} B={batch}: {key}'s du "
                                 "differs from its twin")
        torch.cuda.synchronize()
        scale = float(outs["other"].float().abs().max())
        if bf16:
            err = ulps(outs["this"], outs["other"])
            ok = err <= 1.0
        else:
            err = float((outs["this"] - outs["other"]).abs().max())
            ok = err <= DX_RTOL * scale
        if not ok:
            raise SystemExit(f"{label} {name} B={batch}: the sides differ "
                             f"({err:.3e}, max |dx| {scale:.3e})")
        del outs
        t = in_turns(fns, reps)
        old = cuda_ms(lambda: replaced_dx(op["this"], dy, w_l), reps)
        bd = dx_bound(op["this"], batch, c_in, c_out, bf16)
        b_ms, b_by = bd["ms"], bd["by"]
        plan = sides["this"]["kernels"].plan_spiral_conv_dx(
            n_src, batch, seq, c_in, c_out, bf16)
        print(f"{label} {name} B={batch} ({n_src} rows, {c_in}<-{c_out}; "
              f"{plan.tv} vertices x {plan.tb} batch rows, "
              f"{plan.positions} positions a chunk, {plan.blocks} blocks): "
              f"other "
              f"{t['other'][0]:.4f} / {t['other'][1]:.4f} ms, this "
              f"{t['this'][0]:.4f} / {t['this'][1]:.4f}; replaced "
              f"{old:.4f}; bound {b_ms:.4f} ({b_by}); "
              f"{'ulps' if bf16 else 'err'} {err:.3g}; du bit-equal",
              flush=True)
        rows.append({"conv": name, "batch": batch, "ms": t,
                     "replaced_ms": old, "bound_ms": b_ms, "bound_by": b_by,
                     "err": err, "plan": dataclasses.asdict(plan)})
    sums = {key: [sum(r["ms"][key][i] for r in rows) for i in range(2)]
            for key in ("other", "this")}
    print(f"{label} B={batch} summed over {len(rows)} convs: other "
          f"{sums['other'][0]:.4f} / {sums['other'][1]:.4f} ms, this "
          f"{sums['this'][0]:.4f} / {sums['this'][1]:.4f}; replaced "
          f"{sum(r['replaced_ms'] for r in rows):.4f}; bound "
          f"{sum(r['bound_ms'] for r in rows):.4f}", flush=True)
    return rows


def parts(args, root: str, dev) -> dict:
    """This side's kernel with its parts cut, timed at the step's convs."""
    csrc = os.path.join(root, "craniofacialsd_vae_tpu_torch", "csrc")
    with open(os.path.join(csrc, "spiral_conv_dx.cu")) as f:
        text = f.read()
    fns = build_variants({("this", name): v for name, v in
                          variants(text, PARTS).items()}, {"this": csrc})
    mods = {"kernels": kernels, "ops": ops, "geometry": geometry,
            "models": models, "training": training}
    by_name = fixture_ops(mods, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    res = {}
    for dtype, convs in ((torch.float32, STEP_CONVS),
                         (torch.bfloat16, BF16_CONVS)):
        bf16 = dtype == torch.bfloat16
        kind = "bf16" if bf16 else "fp32"
        for batch in args.batches:
            total = dict.fromkeys(PARTS, 0.0)
            for name, c_in, c_out in convs:
                op = by_name[name]
                dy, w_l = case(gen, op, batch, c_in, c_out, dtype, dev)
                out = torch.empty((op.n_src, batch, c_in), dtype=dtype,
                                  device=dev)
                plan = kernels.plan_spiral_conv_dx(
                    op.n_src, batch, op.seq_length, c_in, c_out, bf16)
                line = []
                for v in PARTS:
                    ms = cuda_ms(lambda f=fns[("this", v)]: raw_call(
                        f, dy, w_l, op.dx, op.n_src, plan, out), args.reps)
                    total[v] += ms
                    line.append(f"{v} {ms:.4f}")
                print(f"parts {kind} {name} B={batch}: " + ", ".join(line),
                      flush=True)
            print(f"parts {kind} B={batch} summed: " + ", ".join(
                f"{k} {v:.4f}" for k, v in total.items()), flush=True)
            res[f"{kind} {batch}"] = total
    return res


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--other", help="root of the checkout to compare "
                        "with")
    parser.add_argument("--parts", action="store_true")
    parser.add_argument("--batches", type=int, nargs="+",
                        default=list(BATCHES))
    parser.add_argument("--reps", type=int, default=30)
    parser.add_argument("--json", metavar="PATH")
    args = parser.parse_args(argv)
    if not args.parts and not args.other:
        parser.error("give --other PATH, --parts, or both")
    if not torch.cuda.is_available():
        print("k2dx_compare: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=120).stdout.strip()
    print(f"card: {smi}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    roots = {"this": here}
    if args.other:
        roots["other"] = os.path.abspath(args.other)
    res = {"card": smi}
    if args.parts:
        res["parts"] = parts(args, here, dev)
    if args.other:
        res["compare"] = compare_all(args, roots, dev)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    return 0


def compare_all(args, roots: dict, dev) -> dict:
    this = {"kernels": kernels, "ops": ops, "geometry": geometry,
            "models": models, "training": training}
    sides = {"other": load_other(roots["other"]), "this": this}
    for mods in sides.values():
        mods["kernels"].build()
    sources = {}
    for side, root in roots.items():
        with open(os.path.join(root, "craniofacialsd_vae_tpu_torch", "csrc",
                               "spiral_conv_dx.cu")) as f:
            sources[(side, "du")] = variants(f.read(), ("du",))["du"]
    fns = build_variants(sources, {
        side: os.path.join(root, "craniofacialsd_vae_tpu_torch", "csrc")
        for side, root in roots.items()})
    du_fns = {side: fns[(side, "du")] for side in roots}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    out = {}
    fixture = {key: fixture_ops(mods, dev) for key, mods in sides.items()}
    for dtype, convs in ((torch.float32, STEP_CONVS),
                         (torch.bfloat16, BF16_CONVS)):
        for batch in BATCHES:
            label = f"{'K2-dx-bf16' if dtype == torch.bfloat16 else 'K2-dx'}"
            out[f"{label} step {batch}"] = compare(
                sides, du_fns, fixture, convs, batch, dtype, args.reps, gen,
                dev, f"{label} step")
    del fixture
    tables = octasphere_tables()
    octa = {key: octasphere_ops(mods, tables, dev)
            for key, mods in sides.items()}
    for dtype, convs in ((torch.float32, FIT_CONVS),
                         (torch.bfloat16, FIT_CONVS[1:])):
        label = f"{'K2-dx-bf16' if dtype == torch.bfloat16 else 'K2-dx'}"
        out[f"{label} fit {FIT_RESTARTS}"] = compare(
            sides, du_fns, octa, convs, FIT_RESTARTS, dtype, args.reps, gen,
            dev, f"{label} fit")
    return out


if __name__ == "__main__":
    sys.exit(main())

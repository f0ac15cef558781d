"""Time K3a's tiled kernel with each of its parts cut out, on the card,
to see what bounds it.

Run from the root of a checkout, on a machine with one CUDA card::

    python -m craniofacialsd_vae_tpu_torch.k3a_parts [--batches 16 4 1]

It compiles ``csrc/spiral_conv_bf16.cu`` once as it is and once per cut
(each its own ``nvcc``, all at once, into ``build/k3a_parts/``): the
products (ldmatrix and mma.sync, replaced by one read of the staged
row), the copies of the source rows, the fill of W, the stores of the
output, and all four at once (``bare``: the launch, the tile's offsets,
its source indices and the copies of its ``local`` and ``verts`` rows
are what remain). Each is launched at the planner's plan on the
fixture's level 0 (the final conv, 32 -> 3) and timed with CUDA events;
the kernel as it is is also held against the plain twin. A cut kernel
computes nothing useful: only its time is read.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

import torch

from . import kernels, ops
from .geometry import load_bundle
from .k1_sweep import _FIXTURE, cuda_ms
from .models import SpiralGeometry

_OUT = os.path.join(os.path.dirname(kernels._BUILD_ROOT), "k3a_parts")
_PRODUCTS = """        ldsm_x4(a, a_row + cs * 16);
        mma_bf16(acc[cs], a, wf[2 * cs], wf[2 * cs + 1]);"""
_COPIES = "      cp_async_piece<VEC>("
_W_FILL = ("    wv[u] = (i & 7) < C_out ? __ldg(wb + (i >> 3) * C_out + "
           "(i & 7)) : 0;")
_STORE = "      if (f32out)\n        static_cast<float*>(out)[e] = sum;"
# each cut: (anchor in the source, its replacement)
CUTS = {
    "products": (_PRODUCTS,
                 "        acc[cs][0] += (float)(a_row[cs * 16]);"),
    "copies": (_COPIES, "      if (k < 0) cp_async_piece<VEC>("),
    "w_fill": (_W_FILL, "    wv[u] = i;"),
    "stores": (_STORE, "      if (sum == 1234.5f)\n"
               "        static_cast<float*>(out)[e] = sum;"),
}


def variants(source: str) -> dict:
    """The source as it is, with each cut, and with all of them."""
    out = {"kernel": source}
    bare = source
    for name, (anchor, repl) in CUTS.items():
        if source.count(anchor) != 1:
            raise SystemExit(f"k3a_parts: the {name} anchor is not in "
                             "csrc/spiral_conv_bf16.cu once; update CUTS")
        out[f"no_{name}"] = source.replace(anchor, repl)
        bare = bare.replace(anchor, repl)
    out["bare"] = bare
    return out


def build(sources: dict) -> dict:
    """One nvcc per variant, all at once; their libraries by name."""
    os.makedirs(_OUT, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        cu = os.path.join(_OUT, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [kernels._nvcc(), *kernels._CFLAGS, "-shared",
             "-I", kernels._CSRC, cu, "-o",
             os.path.join(_OUT, f"{name}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"k3a_parts: nvcc failed for {name}\n{log}")
        lib = ctypes.CDLL(os.path.join(_OUT, f"{name}.so"))
        fn = lib.cfs_spiral_conv_bf16_tile
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 12 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--batches", type=int, nargs="+",
                        default=[16, 4, 1])
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("k3a_parts: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    with open(os.path.join(kernels._CSRC, "spiral_conv_bf16.cu")) as f:
        libs = build(variants(f.read()))
    dev = torch.device("cuda")
    op = SpiralGeometry.from_bundle(load_bundle(_FIXTURE),
                                    device=dev).spirals[0]
    tiles, m = op.tiles, op.num_vertices
    gen = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())          # noqa: E731
    for b in args.batches:
        x = torch.randn((op.n_src, b, 32), generator=gen,
                        device=dev).to(bf16)
        w = (0.2 * torch.randn((9, 32, 3), generator=gen,
                               device=dev)).to(bf16)
        bias = torch.randn(3, generator=gen, device=dev).to(bf16)
        out = torch.empty((m, b, 3), device=dev)
        plan = kernels.plan_spiral_conv(m, b, 9, 32, 3, True, True, bf16,
                                        tiles.n_tiles, tiles.max_rows)
        times = {}
        for name, fn in libs.items():
            def run(fn=fn):
                rc = fn(ptr(x), ptr(tiles.verts), ptr(tiles.starts),
                        ptr(tiles.src), ptr(tiles.src_off), ptr(tiles.local),
                        ptr(w), ptr(bias), ptr(out), m, 9, b, 32, 3,
                        tiles.n_tiles, plan.rows, plan.tb, plan.n_btiles,
                        plan.threads, plan.smem, 1,
                        ctypes.c_void_p(torch.cuda.current_stream()
                                        .cuda_stream))
                if rc:
                    raise SystemExit(f"k3a_parts: {name}: CUDA error {rc}")
            run()
            torch.cuda.synchronize()
            if name == "kernel":
                ref = ops.spiral_conv_plain(w, bias, x, op, torch.float32)
                err = float((out - ref).abs().max())
                if err > 1e-5 * float(ref.abs().max()):
                    raise SystemExit(f"k3a_parts: B={b}: err {err:.3e}")
            times[name] = cuda_ms(run, 50)
        print(f"B={b} (tb {plan.tb}, {plan.blocks} blocks): "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items()),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

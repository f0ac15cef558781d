"""Time K1-bf16's tiled vector kernel and K2-dW-bf16 with each of their
parts cut out, on the card, to see what bounds them.

Run from the root of a checkout, on a machine with one CUDA card::

    python -m craniofacialsd_vae_tpu_torch.bf16_parts [--batches 16 1]

It compiles ``csrc/spiral_conv_bf16.cu`` and ``csrc/spiral_conv_dw_bf16.cu``
once as they are and once per cut of one of them (each variant its own
``nvcc``, all at once, into ``build/bf16_parts/``): K1-bf16's products
(the position loop), its copies of the source rows, its fill of W, its
stores (kept alive by a test on the result), all four (``bare``: the
launch, the item offsets, the index loads and the copies of ``local``
and ``verts`` remain); K2-dW-bf16's products, its copies of x and dy
rows, both. Each is launched at the planner's plan on the fixture's
dec0 (17,039 vertices, 32 -> 32 channels: K1-bf16 at each batch, K2-dW-
bf16 over the step's 16-mesh grid) and timed with CUDA events; the
kernels as they are are also held against the plain twins. A cut kernel
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

_OUT = os.path.join(os.path.dirname(kernels._BUILD_ROOT), "bf16_parts")
K1_SRC, K2_SRC = "spiral_conv_bf16.cu", "spiral_conv_dw_bf16.cu"
# each cut: (source, [(anchor in the source, its replacement)])
CUTS = {
    "k1_no_products": (K1_SRC, [(
        "      for (int l = 0; l < L; ++l) {\n        const uint16_t* ap[MT];",
        "      for (int l = 0; l < (L < 0 ? L : 0); ++l) {\n"
        "        const uint16_t* ap[MT];")]),
    "k1_no_copies": (K1_SRC, [(
        "    stage_rows(xs, TB * xst,",
        "    if (C_in < 0) stage_rows(xs, TB * xst,")]),
    "k1_no_w": (K1_SRC, [(
        "  if (w_vec) {                                    // 16-byte pieces",
        "  if (w_vec && K < 0) {"),
        ("    for (int i = threadIdx.x; i < K * NC; i += blockDim.x) {",
         "    for (int i = threadIdx.x; i < (K < 0 ? K : 0); "
         "i += blockDim.x) {")]),
    "k1_no_stores": (K1_SRC, [(
        "            if (c >= C_out) continue;",
        "            if (c >= C_out || acc[i2][nt][2 * h] != 1234.5f) "
        "continue;")]),
    "k2_no_products": (K2_SRC, [(
        "    for (int k0 = 0; k0 < n_r; k0 += 16 * KU) {",
        "    for (int k0 = 0; k0 < (n_r < 0 ? n_r : 0); k0 += 16 * KU) {")]),
    "k2_no_copies": (K2_SRC, [(
        "      stage_rows(xs, a.TB * st.xst,",
        "      if (a.B < 0) stage_rows(xs, a.TB * st.xst,"),
        ("      stage_rows(ds, tb * st.dst,",
         "      if (a.B < 0) stage_rows(ds, tb * st.dst,")]),
}
BARE = {"k1_bare": ("k1_no_products", "k1_no_copies", "k1_no_w",
                    "k1_no_stores"),
        "k2_bare": ("k2_no_products", "k2_no_copies")}


def variants(sources: dict) -> dict:
    """Each variant's two sources: as they are, with each cut, with the
    bare sets."""
    def cut(names):
        out = dict(sources)
        for name in names:
            src, subs = CUTS[name]
            for anchor, repl in subs:
                if out[src].count(anchor) != 1:
                    raise SystemExit(f"bf16_parts: the {name} anchor is not "
                                     f"in csrc/{src} once; update CUTS")
                out[src] = out[src].replace(anchor, repl)
        return out
    result = {"kernel": dict(sources)}
    result.update({name: cut([name]) for name in CUTS})
    result.update({name: cut(names) for name, names in BARE.items()})
    return result


def build(vs: dict) -> dict:
    """One nvcc per variant, all at once; each variant's library, bound
    as ``kernels.library()`` binds the two functions."""
    os.makedirs(_OUT, exist_ok=True)
    procs = {}
    for name, files in vs.items():
        paths = []
        for src, text in files.items():
            path = os.path.join(_OUT, f"{name}_{src}")
            with open(path, "w") as f:
                f.write(text)
            paths.append(path)
        procs[name] = subprocess.Popen(
            [kernels._nvcc(), *kernels._CFLAGS, "-shared", "-I",
             kernels._CSRC, *paths, "-o", os.path.join(_OUT, f"{name}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"bf16_parts: nvcc failed for {name}\n{log}")
        lib = ctypes.CDLL(os.path.join(_OUT, f"{name}.so"))
        lib.cfs_spiral_conv_bf16_vec.argtypes = [p] * 9 + [i] * 15 + [p]
        lib.cfs_spiral_conv_dw_bf16.argtypes = [p] * 9 + [i] * 6 + [
            ctypes.POINTER(i), p]
        lib.cfs_spiral_conv_bf16_vec.restype = i
        lib.cfs_spiral_conv_dw_bf16.restype = i
        libs[name] = lib
    return libs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--batches", type=int, nargs="+", default=[16, 1])
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("bf16_parts: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    sources = {}
    for src in (K1_SRC, K2_SRC):
        with open(os.path.join(kernels._CSRC, src)) as f:
            sources[src] = f.read()
    libs = build(variants(sources))
    dev = torch.device("cuda")
    op = SpiralGeometry.from_bundle(load_bundle(_FIXTURE),
                                    device=dev).spirals[0]
    gen = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16
    w = (0.2 * torch.randn((9, 32, 32), generator=gen, device=dev)).to(bf16)
    bias = torch.randn(32, generator=gen, device=dev).to(bf16)
    kept = kernels.library()
    try:
        for b in args.batches + [0]:
            kind = "K2-dW-bf16 B=16 grid" if b == 0 else f"K1-bf16 B={b}"
            bb = 16 if b == 0 else b
            x = torch.randn((op.n_src, bb, 32), generator=gen,
                            device=dev).to(bf16)
            dy = torch.randn((op.num_vertices, bb, 32), generator=gen,
                             device=dev).to(bf16)
            if b == 0:
                run = lambda: kernels.spiral_conv_dw(      # noqa: E731
                    x, op.table, dy, tiles=op.tiles)
                names = [n for n in libs if not n.startswith("k1")]
            else:
                run = lambda: kernels.spiral_conv_fwd(     # noqa: E731
                    x, op.table, w, bias, tiles=op.tiles)
                names = [n for n in libs if not n.startswith("k2")]
            times = {}
            for name in names:
                kernels._lib = libs[name]
                out = run()
                torch.cuda.synchronize()
                if name == "kernel":
                    ref = (ops.spiral_conv_dw_plain(x, op.table, dy) if b == 0
                           else ops.spiral_conv_plain(w, bias, x, op))
                    err = float((out.float() - ref.float()).abs().max())
                    if err > 1e-2 * float(ref.float().abs().max()):
                        raise SystemExit(f"bf16_parts: {kind}: err {err:.3e}")
                times[name] = cuda_ms(run, 50)
            print(f"{kind}: " + ", ".join(f"{k} {v:.4f} ms"
                                          for k, v in times.items()),
                  flush=True)
    finally:
        kernels._lib = kept
    return 0


if __name__ == "__main__":
    sys.exit(main())

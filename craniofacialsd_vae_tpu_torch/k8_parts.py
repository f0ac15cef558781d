"""Time K8's forward with each of its parts cut out, on the card, to see
what bounds it.

Run from the root of a checkout, on a machine with one CUDA card::

    python -m craniofacialsd_vae_tpu_torch.k8_parts [--reps 50]

It compiles ``csrc/distances.cu`` once as it is and once per cut (each
its own ``nvcc``, all at once, into ``build/k8_parts/``): the column
direction's per-chunk scan of the transposed minima, the recomputation that finds each column's row and the key's
atomicMin, and the rows' final recomputation; then ``rows`` is the
kernel with its column reduction off (``nearest_sq``). Each runs at the
fit's shapes (16 restarts of 4,097 points against 8,192) and at one
restart, both directions and the rows alone (the column reduction off),
timed with CUDA events; the kernel as it is is also held against the
plain twin. ``row_min_as_add`` swaps the rows' running fminf for an add
(the ALU pipe's work for the FMA pipe's), ``mins_as_adds`` the columns'
too. A cut kernel computes nothing
useful: only its time is read. The launch shapes (``SHAPES``) hold 2 to
16 rows a lane instead of 6, or cap the registers so that three blocks
fit on an SM: how the kernel's six rows a lane were chosen. The kernel as
it is also runs at column ranges around ``kernels.k8_plan``'s.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

import torch

from . import kernels
from .k1_sweep import cuda_ms
from .ops import distances

_OUT = os.path.join(os.path.dirname(kernels._BUILD_ROOT), "k8_parts")
_SCAN_START = "      // lane c reads column c of the transpose"
_SCAN_END = "        atomicMin(colkey + c, pack(w, tile * kTileRows + src * kRows + kw));\n      }\n"
_RESOLVE = """        int kw = kRows - 1;
#pragma unroll
        for (int k = kRows - 1; k >= 0; --k)
          if (pair_d(rw[src * kRowStride + k], v) == w) kw = k;
        atomicMin(colkey + c, pack(w, tile * kTileRows + src * kRows + kw));"""
_ROW_MIN = "        run = c % kGroup < 2 ? d : fminf(run, d);"
_COL_MIN = "        if (kCols) m = k == 0 ? d : fminf(m, d);"
_ROW_RESOLVE = ("          if (pair_d(u[k], cg[cr]) == best[k] && cr < arg) "
                "arg = cr;")


def variants(source: str) -> dict:
    """The source as it is and with each cut."""
    for anchor in (_SCAN_START, _SCAN_END, _RESOLVE, _ROW_RESOLVE,
                   _ROW_MIN, _COL_MIN):
        if source.count(anchor) != 1:
            raise SystemExit("k8_parts: an anchor is not in "
                             "csrc/distances.cu once; update the cuts")
    lo = source.index(_SCAN_START)
    hi = source.index(_SCAN_END) + len(_SCAN_END)
    keep = "      if (xw[lane] == 1234.5f) colkey[lane] = 0ull;\n"
    return {
        "kernel": source,
        "no_column_scan": source[:lo] + keep + source[hi:],
        "no_column_resolve": source.replace(
            _RESOLVE, "        if (w == 1234.5f) colkey[c] = src;"),
        "no_row_resolve": source.replace(
            _ROW_RESOLVE, "          arg = cr ^ (best[k] == 1234.5f);"),
        "row_min_as_add": source.replace(
            _ROW_MIN, "        run = c % kGroup < 2 ? d : __fadd_rn(run, d);"),
        "mins_as_adds": source.replace(
            _ROW_MIN, "        run = c % kGroup < 2 ? d : __fadd_rn(run, d);").replace(
            _COL_MIN, "        if (kCols) m = k == 0 ? d : __fadd_rn(m, d);"),
    }


_ROWS = "constexpr int kRows = 6;"
_BOUNDS = ("template <bool kCols>\n__global__ void __launch_bounds__(kThreads)"
           "\nnearest_pairs_kernel(")
# launch shapes: rows a lane holds, and the blocks an SM must fit (0: any)
SHAPES = {"rows2": (2, 0), "rows3": (3, 0), "rows4": (4, 0), "rows8": (8, 0),
          "rows16": (16, 0), "rows6_min3": (6, 3)}


def shaped(source: str) -> dict:
    """The source with another number of rows a lane, or a register cap
    that fits more blocks on an SM."""
    for anchor in (_ROWS, _BOUNDS):
        if source.count(anchor) != 1:
            raise SystemExit("k8_parts: a shape anchor is not in "
                             "csrc/distances.cu once; update SHAPES")
    out = {}
    for name, (rows, min_blocks) in SHAPES.items():
        text = source.replace(_ROWS, f"constexpr int kRows = {rows};")
        if min_blocks:
            text = text.replace(_BOUNDS, _BOUNDS.replace(
                "(kThreads)", f"(kThreads, {min_blocks})"))
        out[name] = text
    return out


def build(sources: dict) -> dict:
    """One nvcc per variant, all at once; their forward entry points."""
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
            raise SystemExit(f"k8_parts: nvcc failed for {name}\n{log}")
        regs = [ln.split("Used ")[1].split(",")[0] for ln in log.splitlines()
                if "Used " in ln]
        print(f"{name}: registers (pairs without, with columns; reduce; "
              f"backward) {regs}", flush=True)
        lib = ctypes.CDLL(os.path.join(_OUT, f"{name}.so"))
        fn = lib.cfs_nearest_sq
        fn.argtypes = kernels.library().cfs_nearest_sq.argtypes
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--reps", type=int, default=50)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("k8_parts: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    with open(os.path.join(kernels._CSRC, "distances.cu")) as f:
        source = f.read()
    libs = build({**variants(source), **shaped(source)})
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())          # noqa: E731
    for r in (16, 1):
        x = torch.randn((r, 4097, 3), generator=gen, device=dev)
        y = torch.randn((8192, 3), generator=gen, device=dev)
        mu = y.mean(0)
        cols, _ = kernels.k8_plan(r, 4097, 8192)
        splits = -(-8192 // cols)
        part = torch.empty(r * 256 * 4097 + r * 65 * 8192,
                           dtype=torch.int64, device=dev)
        d_x = torch.empty((r, 4097), device=dev)
        d_y = torch.empty((r, 8192), device=dev)
        a = torch.empty((r, 4097), dtype=torch.int32, device=dev)
        b = torch.empty((r, 8192), dtype=torch.int32, device=dev)
        times = {}
        none = ctypes.c_void_p(None)
        for name, fn in libs.items():
            rows = SHAPES[name][0] if name in SHAPES else 6
            tiles = -(-4097 // (32 * rows))
            tpg = -(-tiles // -(-tiles // 8))
            for both in (True, False):
                def run(fn=fn, both=both, tpg=tpg):
                    cols_args = (
                        ctypes.c_void_p(part.data_ptr()
                                        + 8 * r * 256 * 4097),
                        ptr(d_y), ptr(b)) if both else (none, none, none)
                    rc = fn(ptr(x), 4097 * 3, 4097, ptr(y), 0, 8192, ptr(mu),
                            r, cols, tpg, ptr(part), cols_args[0], ptr(d_x),
                            ptr(a), cols_args[1], cols_args[2],
                            ctypes.c_void_p(torch.cuda.current_stream()
                                            .cuda_stream))
                    if rc:
                        raise SystemExit(f"k8_parts: {name}: CUDA error {rc}")
                run()
                torch.cuda.synchronize()
                if name == "kernel":
                    want = distances.nearest_dists_sq_sym_plain(x, y)
                    err = float((d_x - want[0]).abs().max())
                    if err > 1e-5 * float(want[0].max()):
                        raise SystemExit(f"k8_parts: R={r}: err {err:.3e}")
                times[name + ("" if both else " (rows)")] = cuda_ms(
                    run, args.reps)
        # the plan's column range against its neighbours (the kernel as is)
        for other in sorted({max(32, cols // 64 * 32), max(32, cols - 32),
                             cols + 32, min(1024, 2 * cols)} - {cols}):
            def run_cols(other=other):
                fn = libs["kernel"]
                rc = fn(ptr(x), 4097 * 3, 4097, ptr(y), 0, 8192, ptr(mu), r,
                        other, 8, ptr(part),
                        ctypes.c_void_p(part.data_ptr() + 8 * r * 256 * 4097),
                        ptr(d_x), ptr(a), ptr(d_y), ptr(b),
                        ctypes.c_void_p(torch.cuda.current_stream()
                                        .cuda_stream))
                if rc:
                    raise SystemExit(f"k8_parts: {other} columns: CUDA "
                                     f"error {rc}")
            times[f"kernel at {other} columns"] = cuda_ms(run_cols, args.reps)
        print(f"R={r} ({cols} columns a block): "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items()),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Time K3b's backward with each of its parts cut out, on the card, to
see what bounds it.

Run from the root of a checkout, on a machine with one CUDA card::

    python -m craniofacialsd_vae_tpu_torch.k3b_parts [--batches 16 4 1]

It compiles ``csrc/out_gather_sum.cu`` once as it is and once per cut
(each its own ``nvcc``, all at once, into ``build/k3b_parts/``): the
staging copies of the dout rows (the runs' lists are still copied), the
sums (every position then copies one staged value, its first entry's,
and walks no tier), the stores of du, the copies and the sums
(``stores_only``), and all three at once (``bare``: the launch, the
lists' copy and the walk over the items are what remain). Beside them,
``du.zero_()``: torch's write of du alone. Each is launched over the
runs of the fixture's level 0 (the final conv, 32 -> 3) at the
wrapper's plan and timed with CUDA events; the kernel as it is is also
held against the plain twin. A cut kernel computes nothing useful: only
its time is read.
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

_OUT = os.path.join(os.path.dirname(kernels._BUILD_ROOT), "k3b_parts")
_COPIES = ("  stage_rows(srows, dout + (size_t)b0 * O, slist, nr, W, "
           "B * O, vec);")
_STORE = "  for (int o = 0; o < O; ++o) {\n    if constexpr (BV == 4)"
# each cut: its edits, (anchor in the source, its replacement)
CUTS = {
    "copies": ((_COPIES, ""),),
    "sums": (("      entry_sum<O, BV>(e, K, x, W, acc);",
              "      load_rows<O, BV>(x + (e[0] & 0x7fff) * W, acc);"),
             ("      for (int q = 0; q < (h & 3); ++q) {",
              "      for (int q = 0; q < 0 * (h & 3); ++q) {")),
    "stores": ((_STORE, "  for (int o = 0; o < O * (acc[0] == 1234.5f); "
                "++o) {\n    if constexpr (BV == 4)"),),
}


def variants(source: str) -> dict:
    """The source as it is, with each cut, with the copies and the sums
    cut (``stores_only``), and with all of them."""
    out = {"kernel": source}
    bare = source
    for name, edits in CUTS.items():
        cut = source
        for anchor, repl in edits:
            if source.count(anchor) != 1:
                raise SystemExit(f"k3b_parts: the {name} anchor is not in "
                                 "csrc/out_gather_sum.cu once; update CUTS")
            cut = cut.replace(anchor, repl)
            bare = bare.replace(anchor, repl)
        out[f"no_{name}"] = cut
        if name == "sums":
            out["stores_only"] = bare
    out["bare"] = bare
    return out


def build(sources: dict) -> dict:
    """One nvcc per variant, all at once; their launch functions by
    name."""
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
            raise SystemExit(f"k3b_parts: nvcc failed for {name}\n{log}")
        lib = ctypes.CDLL(os.path.join(_OUT, f"{name}.so"))
        fn = lib.cfs_out_gather_sum_bwd
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 \
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
        print("k3b_parts: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=120).stdout.strip()
    print(f"card: {smi}", flush=True)
    with open(os.path.join(kernels._CSRC, "out_gather_sum.cu")) as f:
        libs = build(variants(f.read()))
    dev = torch.device("cuda")
    op = ops.build_spiral_op(load_bundle(_FIXTURE).spirals[0]).to(dev)
    bwd, runs = op.out_bwd, op.out_bwd.runs
    n, seq = op.n_src, op.seq_length
    gen = torch.Generator(device=dev).manual_seed(0)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())          # noqa: E731
    for b in args.batches:
        dout = torch.randn((n, b, 3), generator=gen, device=dev)
        du = torch.empty((seq, 3, n, b), device=dev)
        bs, smem, threads = kernels.out_gather_bwd_plan(runs, b, 3)
        times = {}
        for name, fn in libs.items():
            def run(fn=fn):
                rc = fn(ptr(dout), ptr(runs.starts), ptr(runs.rows),
                        ptr(runs.row_off), ptr(runs.blob),
                        ptr(runs.blob_off), ptr(runs.pos), ptr(du),
                        runs.n_runs, n, n, seq, b, 3, bs,
                        threads, smem, 1,
                        ctypes.c_void_p(torch.cuda.current_stream()
                                        .cuda_stream))
                if rc:
                    raise SystemExit(f"k3b_parts: {name}: CUDA error {rc}")
            run()
            torch.cuda.synchronize()
            if name == "kernel":
                if not torch.equal(du, ops.out_gather_sum_bwd_plain(dout,
                                                                    bwd)):
                    raise SystemExit(f"k3b_parts: B={b}: differs from the "
                                     "twin")
            times[name] = cuda_ms(run, 50)
        times["du.zero_"] = cuda_ms(du.zero_, 50)
        print(f"B={b} ({runs.n_runs} runs, slice {bs}, {smem} B smem, "
              f"{threads} threads): "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items()),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

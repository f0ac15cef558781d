"""Time K9 in its other grid order and at smaller tiles, beside its
stream-only floor and torch's elementwise streams, on the card: what
bounds it.

Run from the root of a checkout, on a machine with one CUDA card::

    python -m craniofacialsd_vae_tpu_torch.k9_parts [--reps 50]
        [--json PATH]

It compiles ``csrc/cheby_step.cu`` as it is (``kernel``: the slices of
a tile side by side in the grid) and with the grid's order swapped
(``tiles_fastest``: the tiles of a slice side by side, cut from the
source text here), each its own ``nvcc``, both at once, into
``build/k9_parts/``. At the k = 1000 solve's shape (the octasphere of
subdivision 6, 16,386 × 1,125, in the solver's padded panels) each
variant runs the filter step and a b = 0 step over the Laplacian (held
bit-equal to the twin) and over a diagonal-only table (K = 1: no
gather, the stream floor), with Morton-ordered tiles of the 64 vertices
the kernel takes and of a half and a quarter of them (smaller blocks,
more of them an SM) and, for the diagonal table, tiles of consecutive
rows. torch's ``mul`` (one read, one write) and ``add`` (two reads, one
write) over the same panels give the card's elementwise stream at these
shapes.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

from . import kernels
from .geometry import synthetic_template
from .k1_sweep import cuda_ms
from .ops import eigh

_OUT = os.path.join(os.path.dirname(kernels._BUILD_ROOT), "k9_parts")
_BLOCK_IDX = ("  const int t = blockIdx.y;                   // the tile\n"
              "  const int j0 = blockIdx.x * kSlice;         // its slice\n")
_GRID = "  const dim3 grid((D + kSlice - 1) / kSlice, n_tiles);\n"
SUBDIVISIONS, BLOCK, SEED = 6, 1125, 20


def variants(source: str) -> dict:
    """The source as it is and with the grid's order swapped."""
    for anchor in (_BLOCK_IDX, _GRID):
        if source.count(anchor) != 1:
            raise SystemExit("k9_parts: an anchor is not in "
                             "csrc/cheby_step.cu once; update the variants")
    swapped = source.replace(_BLOCK_IDX, _BLOCK_IDX.replace(
        "blockIdx.y", "blockIdx.T").replace("blockIdx.x", "blockIdx.y")
        .replace("blockIdx.T", "blockIdx.x")).replace(
        _GRID, "  const dim3 grid(n_tiles, (D + kSlice - 1) / kSlice);\n")
    return {"kernel": source, "tiles_fastest": swapped}


def build(sources: dict) -> dict:
    """One nvcc per variant, all at once; their ``cfs_cheby_step`` by
    name."""
    os.makedirs(_OUT, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        cu = os.path.join(_OUT, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [kernels._nvcc(), *kernels._CFLAGS, "-shared", "-I",
             kernels._CSRC, cu, "-o", os.path.join(_OUT, f"{name}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"k9_parts: nvcc failed for {name}\n{log}")
        lib = ctypes.CDLL(os.path.join(_OUT, f"{name}.so"))
        p, i = ctypes.c_void_p, ctypes.c_int
        fn = lib.cfs_cheby_step
        fn.argtypes = [p] * 6 + [i] * 3 + [p] * 4 + [i] * 4 + [
            ctypes.c_float, ctypes.c_float, p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def step(fn, vals, tiles, x, c, a, b, p):
    """One launch of a variant (``kernels.cheby_step``'s call, unchecked);
    returns the output panel."""
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())          # noqa: E731
    n, d = x.shape
    out = eigh.panel(n, d, x.device)
    rc = fn(ptr(vals), ptr(tiles.verts), ptr(tiles.starts), ptr(tiles.src),
            ptr(tiles.src_off), ptr(tiles.local), tiles.n_tiles,
            tiles.max_rows, tiles.max_verts, ptr(x), ptr(c),
            ptr(p) if b != 0.0 else ctypes.c_void_p(None), ptr(out), n,
            vals.shape[1], d, x.stride(0), ctypes.c_float(a),
            ctypes.c_float(b),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if rc:
        raise SystemExit(f"k9_parts: CUDA error {rc}")
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--reps", type=int, default=50)
    parser.add_argument("--json", metavar="PATH")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("k9_parts: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=120).stdout.strip()
    print(f"card: {smi}", flush=True)
    with open(os.path.join(kernels._CSRC, "cheby_step.cu")) as f:
        fns = build(variants(f.read()))
    dev = torch.device("cuda")
    tpl = synthetic_template(SUBDIVISIONS, 3)
    lap = eigh._EllLaplacian(tpl, dev)
    n = tpl.num_vertices
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((n, BLOCK), generator=gen, device=dev)
    p = torch.randn((n, BLOCK), generator=gen, device=dev)
    xs, ps = eigh._as_panel(x), eigh._as_panel(p)
    lb = 1.4
    e, c = (lap.ub - lb) / 2, (lap.ub + lb) / 2
    sigma = e / -c
    sigma_new = 1.0 / (2.0 / sigma - sigma)
    cv = torch.full((BLOCK,), c, dtype=torch.float32, device=dev)
    forms = {"filter step": (2.0 * sigma_new / e, sigma_new * sigma),
             "b = 0": (sigma / e, 0.0)}
    diag_cols = torch.arange(n, dtype=torch.int32, device=dev)[:, None]
    diag_vals = lap.vals.sum(1, keepdim=True).abs() + 1.0
    results = {}
    for name, fn in fns.items():
        row = {}
        for div in (1, 2, 4):
            verts = eigh.K9_TILE_VERTS // div
            tables = {
                f"laplacian/{verts}": (lap.cols, lap.vals,
                                       eigh.build_k9_tiles(
                                           lap.cols, tpl.pos, verts,
                                           2 * verts)),
                f"diagonal/{verts}": (diag_cols, diag_vals,
                                      eigh.build_k9_tiles(
                                          diag_cols, tpl.pos, verts,
                                          2 * verts))}
            if div == 1:
                tables[f"diagonal in order/{verts}"] = (
                    diag_cols, diag_vals, eigh.build_k9_tiles(
                        diag_cols, None, verts, 2 * verts))
            for tname, (cols, vals, tiles) in tables.items():
                for form, (a, b) in forms.items():
                    out = step(fn, vals, tiles, xs, cv, a, b, ps)
                    ref = eigh.cheby_step_plain(cols, vals, x, cv, a, b, p)
                    torch.cuda.synchronize()
                    if not torch.equal(out, ref):
                        raise SystemExit(f"k9_parts: {name} {tname} {form}:"
                                         " differs from the twin")
                    del out, ref
                    row[f"{tname}, {form}"] = cuda_ms(
                        lambda: step(fn, vals, tiles, xs, cv, a, b, ps),
                        args.reps)
        results[name] = row
        print(f"[k9 {name}] " + ", ".join(f"{k} {v:.4f}"
                                          for k, v in row.items()) + " ms",
              flush=True)
    y = torch.empty_like(x)
    ys = eigh.panel(n, BLOCK, dev)
    streams = {
        "mul contiguous": cuda_ms(lambda: torch.mul(x, 0.5, out=y),
                                  args.reps),
        "mul padded": cuda_ms(lambda: torch.mul(xs, 0.5, out=ys), args.reps),
        "add contiguous": cuda_ms(lambda: torch.add(x, p, alpha=0.5, out=y),
                                  args.reps),
        "add padded": cuda_ms(lambda: torch.add(xs, ps, alpha=0.5, out=ys),
                              args.reps)}
    print("[torch streams] " + ", ".join(f"{k} {v:.4f}"
                                         for k, v in streams.items())
          + " ms", flush=True)
    line = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
            "n": n, "d": BLOCK, "variants": results, "streams": streams}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(line, f, indent=1)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one NVIDIA card.

Run from the root of a checkout::

    python3 chip_smoke.py [--json PATH]

It needs one CUDA card and ``nvcc``, and fails (exit code 1) without
them or outside a checkout. Phases, each of which raises on a fault:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: compiles the kernels of ``craniofacialsd_vae_tpu_torch/csrc``
   with nvcc for sm_90a;
3. kernel parity at the serving path's shapes: every spiral conv of the
   model at B = 16 and B = 1 (K1: its tensor-core and narrow-output
   kernels, with each conv's path, both bounds and ptxas's registers and
   spills per kernel), every up-pool at B = 16 (K4) and a 256² z-buffer
   sweep of the lr0 mesh and of a sphere (K7), each held against its
   plain PyTorch twin on the same inputs and timed with CUDA events
   against its twin and a library call;
4. serving at full width (17,039 vertices, channels 32/32/32/64, latent
   75, seeded weights): a ``DiagnosisService(max_batch=16)`` answers
   ``reconstruct`` requests of 1, 3, 16 and 20 scans, checked against the
   same service on the host, then the lr0 selection of the
   reconstructions is rendered shaded and as a plasma error map;
5. launch counts: each kernel must have run during phase 4.

The last three lines of standard output are the kernels' JSON record,
the nvidia-smi line and ``{"ok": true, "device": {...}}``. ``--json``
also writes every measurement (per shape, per request size, the
profiles) to PATH. Nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
PKG = "craniofacialsd_vae_tpu_torch"
DEVICE = "cuda"
SEED = 0
BATCH = 16
K1_BATCHES = (BATCH, 1)
IMAGE = 256
# configurations/smoke.yaml: the model section, kl_weight and to_mm
MODEL_CONFIG = {
    "sampling": {"type": "basic", "sampling_factors": [4, 4, 4, 4]},
    "spirals": {"length": [9, 9, 9, 9], "dilation": [1, 1, 1, 1]},
    "in_channels": 3,
    "out_channels": [32, 32, 32, 64],
    "latent_size": 75,
    "pre_z_sigmoid": False,
}
KL_WEIGHT = 1e-4
TO_MM = 89.11
REQUEST_SIZES = (1, 3, 16, 20)
ERROR_MAX_MM = 5.0
# H100 SXM peaks (data sheet): HBM bytes/s, fp32 flop/s off the tensor
# cores and dense TF32 flop/s on them (3xTF32 runs three TF32 products)
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
PEAK_TF32 = 495e12
# tolerances
K1_RTOL = 1e-5          # against max |out|: fp32 dot products summed in
#                         another order than the library matmul's
K4_RTOL = 1e-6          # against max |out|: the same rounded order (0 seen)
SERVE_RTOL = 1e-4       # card vs host service, against each array's max
SERVE_ERR_ATOL_MM = 1e-3


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# ----------------------------------------------------------------------
def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back runs, warm.
    The card is first kept busy (``torch.cuda._sleep``) for longer than
    the host takes to enqueue the runs, so the time between the two
    events is the card's own, not the host's launch overhead."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int((2 * host_s + 0.005) * 2e9))   # ~2e9 cycles/s
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, flops: float) -> tuple:
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FP32 * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), t_bytes, t_ops


def max_err(a, b) -> float:
    return float((a - b).abs().max()) if a.numel() else 0.0


def uv_sphere(n_lat: int = 48, n_lon: int = 96):
    """Unit sphere: vertices [V, 3] float32, faces [F, 3] int64."""
    th = np.linspace(0, np.pi, n_lat + 1)[1:-1]
    ph = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    t, p = np.meshgrid(th, ph, indexing="ij")
    ring = np.stack([np.sin(t) * np.cos(p), np.cos(t),
                     np.sin(t) * np.sin(p)], -1).reshape(-1, 3)
    verts = np.concatenate([[[0, 1, 0]], ring, [[0, -1, 0]]])
    faces = []

    def idx(i, j):
        return 1 + i * n_lon + j % n_lon

    for j in range(n_lon):
        faces.append([0, idx(0, j + 1), idx(0, j)])
        faces.append([len(verts) - 1, idx(n_lat - 2, j),
                      idx(n_lat - 2, j + 1)])
    for i in range(n_lat - 2):
        for j in range(n_lon):
            faces.append([idx(i, j), idx(i, j + 1), idx(i + 1, j)])
            faces.append([idx(i + 1, j), idx(i, j + 1), idx(i + 1, j + 1)])
    return verts.astype(np.float32), np.asarray(faces, np.int64)


def scatter_coo(coo, dense: np.ndarray) -> np.ndarray:
    out = np.zeros((coo.shape[0],) + dense.shape[1:], np.float32)
    np.add.at(out, coo.rows, coo.vals[:, None] * dense[coo.cols])
    return out


# ----------------------------------------------------------------------
def phase_device(torch) -> tuple:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=120)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    log(f"[1 device] {name} x{torch.cuda.device_count()}; "
        f"nvidia-smi: {smi_line}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    # a float32 reference is full float32 on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return name, smi_line


def phase_build(kernels) -> tuple:
    """Builds the kernels (printing nvcc's output); returns the seconds it
    took and the build log."""
    t0 = time.perf_counter()
    path = kernels.build(verbose=True)
    kernels.library()
    dt = time.perf_counter() - t0
    log(f"[2 build] {os.path.relpath(path, ROOT)} in {dt:.1f} s")
    with open(os.path.join(os.path.dirname(path), "build.log")) as f:
        return dt, f.read()


def k1_ptxas(build_log: str) -> list:
    """Registers, shared memory and spills of each K1 kernel, from the
    build's ``-Xptxas -v`` output."""
    out, name = [], None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"spiral_conv_(tc|narrow)_kernelILi(\d+)ELi(\d+)E",
                          m.group(1))
            name = f"{k.group(1)}<{k.group(2)},{k.group(3)}>" if k else None
            if name:
                out.append({"kernel": name})
        elif name and "Used" in line:
            out[-1]["registers"] = int(re.search(r"Used (\d+) registers",
                                                 line).group(1))
        elif name and "spill" in line:
            out[-1]["spill_bytes"] = sum(
                int(n) for n in re.findall(r"(\d+) bytes spill", line))
    return out


def k1_parity(torch, mods, model, geom, build_log: str) -> list:
    """Every spiral conv of a forward pass, at B = 16 and B = 1, with the
    model's own (seeded) weights and random inputs: parity with the plain
    twin, two launches bit-equal, times against the twin and the library
    form. One record per K1 kernel from the B = 16 pass."""
    kernels, ops = mods["kernels"], mods["ops"]
    for k in k1_ptxas(build_log):
        log(f"[3 K1 ptxas] {k['kernel']}: {k.get('registers')} registers, "
            f"{k.get('spill_bytes', 0)} bytes spilled")
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    n = len(model.en_convs)
    convs = [(f"enc{i}", model.en_convs[i], geom.enc_spirals[i])
             for i in range(n)]
    convs += [(f"dec{n - 1 - j}", model.de_convs[j],
               geom.spirals[n - 1 - j]) for j in range(n)]
    convs.append(("final", model.final_conv, geom.spirals[0]))
    by_batch = {}
    for batch in K1_BATCHES:
        shapes = []
        for name, conv, op in convs:
            shapes.append(k1_shape(torch, kernels, ops, gen, name, conv, op,
                                   batch))
        tot = {k: sum(s[k] for s in shapes)
               for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                         "bound_fp32_ms")}
        log(f"[3 K1 B={batch}] per pass: kernel {tot['ms']:.4f} ms, plain "
            f"{tot['plain_ms']:.4f} ms, library {tot['library_ms']:.4f} ms, "
            f"bound {tot['bound_ms']:.4f} ms (fp32 bound "
            f"{tot['bound_fp32_ms']:.4f}); kernel/library "
            f"{tot['ms'] / tot['library_ms']:.2f}")
        by_batch[batch] = shapes
    records = []
    for kernel in ("spiral_conv_tc", "spiral_conv_narrow"):
        rec = summarize(kernel, "csrc/spiral_conv.cu",
                        "craniofacialsd_vae_tpu/ops/spiral_conv.py:159",
                        [s for s in by_batch[BATCH] if s["kernel"] == kernel])
        rec["shapes_b1"] = [s for s in by_batch[1] if s["kernel"] == kernel]
        records.append(rec)
    return records


def k1_shape(torch, kernels, ops, gen, name, conv, op, batch) -> dict:
    """One spiral conv at one batch size: parity, bit-equality, times and
    bounds (fp32 on the CUDA cores, and 3xTF32 on the tensor cores for
    the tensor-core kernel)."""
    seq = op.seq_length
    c_in = conv.w.shape[0] // seq
    c_out = conv.w.shape[1]
    m = op.num_vertices
    x = torch.randn((op.n_src, batch, c_in), generator=gen, device=DEVICE)
    w_l = conv.w.detach().reshape(seq, c_in, c_out).contiguous()
    b = (0.1 * torch.randn(c_out, generator=gen, device=DEVICE))
    table = op.table
    plan = kernels.plan_spiral_conv(m, batch, seq, c_in, c_out,
                                    x.data_ptr() % 16 == 0,
                                    w_l.data_ptr() % 16 == 0)
    with torch.inference_mode():
        out = kernels.spiral_conv_fwd(x, table, w_l, b)
        again = kernels.spiral_conv_fwd(x, table, w_l, b)
        ref = ops.spiral_conv_plain(w_l, b, x, op)
        torch.cuda.synchronize()
        err = max_err(out, ref)
        scale = float(ref.abs().max())
        check(err <= K1_RTOL * scale,
              f"K1 {name} B={batch}: max |kernel - plain| {err:.3e} > "
              f"{K1_RTOL} x {scale:.3e}")
        check(torch.equal(out, again),
              f"K1 {name} B={batch}: two launches differ")
        # library yardstick: batch-major index_select + linear, the
        # benchmarks/baseline_torch.py form
        x_bm = x.transpose(0, 1).contiguous()
        flat = table.reshape(-1).long()
        w_t = w_l.reshape(seq * c_in, c_out).t().contiguous()
        lib = lambda: torch.nn.functional.linear(      # noqa: E731
            x_bm.index_select(1, flat).view(batch, m, seq * c_in), w_t, b)
        lib_err = max_err(lib().transpose(0, 1), ref)
        check(lib_err <= 1e-4 * scale,
              f"K1 {name} B={batch}: library form disagrees ({lib_err:.3e})")
        ms = cuda_ms(torch, lambda: kernels.spiral_conv_fwd(
            x, table, w_l, b), 20)
        plain_ms = cuda_ms(
            torch, lambda: ops.spiral_conv_plain(w_l, b, x, op), 5)
        lib_ms = cuda_ms(torch, lib, 5)
    nbytes = 4 * (x.numel() + table.numel() + w_l.numel() + c_out
                  + m * batch * c_out)
    flops = 2.0 * m * batch * seq * c_in * c_out
    fp32_ms, fp32_by, t_bytes, _ = bound(nbytes, flops)
    if plan.kernel == "spiral_conv_tc":
        t_ops = 3 * flops / PEAK_TF32 * 1e3
        b_ms, b_by = max(t_bytes, t_ops), (
            "bytes" if t_bytes >= t_ops else "tf32x3")
    else:
        b_ms, b_by = fp32_ms, ("bytes" if fp32_by == "bytes" else "fp32")
    log(f"[3 K1 {name} B={batch}] {op.n_src}->{m} {c_in}->{c_out} "
        f"{plan.path} (P {plan.positions}, {plan.threads} threads x "
        f"{plan.blocks} blocks, {plan.smem} B smem): err {err:.2e} "
        f"(max|out| {scale:.2e}); kernel {ms:.4f} ms, plain {plain_ms:.4f}, "
        f"library {lib_ms:.4f}, bound {b_ms:.4f} ({b_by}), fp32 bound "
        f"{fp32_ms:.4f}; kernel/library {ms / lib_ms:.2f}")
    return dict(conv=name, batch=batch, kernel=plan.kernel, path=plan.path,
                plan=dataclasses.asdict(plan), n_src=op.n_src, m=m,
                c_in=c_in, c_out=c_out, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                bound_by=b_by, bound_fp32_ms=fp32_ms, bytes=nbytes,
                flops=flops, ops_ms=(3 * flops / PEAK_TF32 * 1e3
                                     if plan.kernel == "spiral_conv_tc"
                                     else flops / PEAK_FP32 * 1e3))


def k4_parity(torch, mods, model, geom, bundle) -> dict:
    """Every up-pool of the decoder at B = 16, at its channel width."""
    kernels, ops = mods["kernels"], mods["ops"]
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    n = len(model.de_convs)
    shapes = []
    for j in range(n):
        level = n - 1 - j
        mat = geom.up[level]
        c = model.de_convs[j].w.shape[0] // geom.spirals[level].seq_length
        n_src = mat.n_cols
        m, k = mat.cols.shape
        x2 = torch.randn((n_src, BATCH * c), generator=gen, device=DEVICE)
        coo = bundle.up[level]
        sp = torch.sparse_coo_tensor(
            torch.as_tensor(np.stack([coo.rows, coo.cols]).astype(np.int64)),
            torch.as_tensor(coo.vals), coo.shape,
            check_invariants=True).coalesce().to(DEVICE)
        with torch.inference_mode():
            out = kernels.ell_matmul_fwd(mat.cols, mat.vals, x2)
            ref = ops.ell_matmul_plain(mat.cols, mat.vals, x2)
            torch.cuda.synchronize()
            err = max_err(out, ref)
            scale = float(ref.abs().max())
            check(err <= K4_RTOL * scale,
                  f"K4 up{level}: max |kernel - plain| {err:.3e} > "
                  f"{K4_RTOL} x {scale:.3e}")
            lib = lambda: torch.sparse.mm(sp, x2)           # noqa: E731
            lib_err = max_err(lib(), ref)
            check(lib_err <= 1e-5 * scale,
                  f"K4 up{level}: library form disagrees ({lib_err:.3e})")
            ms = cuda_ms(torch, lambda: kernels.ell_matmul_fwd(
                mat.cols, mat.vals, x2), 50)
            plain_ms = cuda_ms(torch, lambda: ops.ell_matmul_plain(
                mat.cols, mat.vals, x2), 10)
            lib_ms = cuda_ms(torch, lib, 10)
        d = BATCH * c
        nbytes = 4 * (n_src * d + 2 * m * k + m * d)
        flops = 2.0 * m * k * d
        b_ms, b_by, _, _ = bound(nbytes, flops)
        shapes.append(dict(pool=f"up{level}", n_src=n_src, m=m, k=k, d=d,
                           max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                           bytes=nbytes, flops=flops))
        log(f"[3 K4 up{level}] {n_src}->{m} K={k} D={d}: err {err:.2e}; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
            f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return summarize("ell_matmul_fwd", "csrc/ell_matmul.cu",
                     "craniofacialsd_vae_tpu/ops/sparse.py:191", shapes)


def sweep_inputs(torch, raster, verts: np.ndarray, faces: np.ndarray):
    from craniofacialsd_vae_tpu_torch.viz.renderer import look_at_camera

    eye, rot = look_at_camera()
    v_cam = torch.as_tensor((verts - eye) @ rot.T, device=DEVICE)
    f = torch.as_tensor(faces, device=DEVICE).long()
    pts = raster.project(v_cam, IMAGE)
    n_blocks = -(-len(faces) // raster.TRI_BLOCK)
    coef = raster._triangle_coefficients(pts, f, n_blocks)
    ymin, ymax = raster._block_y_ranges(pts[f, 1], n_blocks)
    return coef, ymin.contiguous(), ymax.contiguous()


def k7_parity(torch, mods, bundle) -> dict:
    """256² sweeps of the lr0 mesh (timed: the render path's input) and
    of a sphere: z and winner bit-identical to the plain twin."""
    kernels, raster = mods["kernels"], mods["raster"]
    n_pix = IMAGE * IMAGE
    cull = raster._cull_tile(n_pix)
    shapes = []
    for name, (verts, faces) in (
            ("lr0", (bundle.lr_pos[0], bundle.lr_face[0])),
            ("sphere", uv_sphere())):
        coef, ymin, ymax = sweep_inputs(torch, raster, verts, faces)
        with torch.inference_mode():
            z, win = kernels.raster_sweep(coef, ymin, ymax, IMAGE, cull)
            z_ref, win_ref = raster._zbuffer_sweep_plain(coef, ymin, ymax,
                                                         IMAGE)
            torch.cuda.synchronize()
            check(torch.equal(z, z_ref) and torch.equal(win, win_ref),
                  f"K7 {name}: z/winner differ from the plain twin at "
                  f"{int((z != z_ref).sum())}/{int((win != win_ref).sum())}"
                  " pixels")
            hits = int((win < len(faces)).sum())
            check(0.05 * n_pix < hits < 0.95 * n_pix,
                  f"K7 {name}: {hits} of {n_pix} pixels hit")
            ms = cuda_ms(torch, lambda: kernels.raster_sweep(
                coef, ymin, ymax, IMAGE, cull), 50)
            plain_ms = cuda_ms(torch, lambda: raster._zbuffer_sweep_plain(
                coef, ymin, ymax, IMAGE), 3)
        # work that this data needs: every pixel of every cull tile
        # against every 256-triangle block the cull keeps; 4 affine forms
        # of 2 products and 2 sums each
        t = torch.arange(-(-n_pix // cull), device=DEVICE)
        lo = ((t * cull) // IMAGE).float()
        hi = (((t + 1) * cull - 1) // IMAGE + 1).float()
        keep = (ymin[None, :] <= hi[:, None]) & (ymax[None, :] >= lo[:, None])
        tile_pix = torch.clamp(n_pix - t * cull, max=cull)
        pairs = float((keep.sum(1) * tile_pix).sum()) * raster.TRI_BLOCK
        flops = 16.0 * pairs
        nbytes = 4 * (coef.numel() + 2 * ymin.numel()) + 8 * n_pix
        b_ms, b_by, _, _ = bound(nbytes, flops)
        entry = dict(mesh=name, faces=len(faces), pixels=n_pix,
                     blocks_kept=int(keep.sum()),
                     blocks_total=int(keep.numel()), max_abs_err=0.0,
                     ms=ms, plain_ms=plain_ms, library_ms=None,
                     bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
                     flops=flops)
        log(f"[3 K7 {name}] {len(faces)} faces at {IMAGE}²: bit-identical, "
            f"{hits} px hit, {int(keep.sum())}/{keep.numel()} tile-blocks "
            f"kept; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by})")
        if name == "lr0":
            shapes.append(entry)
        else:
            sphere = entry
    rec = summarize("raster_sweep", "csrc/raster_sweep.cu",
                    "craniofacialsd_vae_tpu/viz/raster_pallas.py:111",
                    shapes)
    rec["parity_only"] = [sphere]
    return rec


def summarize(name, source, replaces, shapes) -> dict:
    """One record per kernel: times and bounds summed over the shapes of
    one pass of the serving path (each shape runs once per pass). A shape
    may give its operations' bound in ``ops_ms`` (3xTF32 on the tensor
    cores); otherwise it is its flops at the fp32 rate."""
    def total(key):
        vals = [s[key] for s in shapes]
        return None if any(v is None for v in vals) else sum(vals)

    t_bytes = sum(s["bytes"] for s in shapes) / PEAK_BYTES * 1e3
    t_ops = sum(s.get("ops_ms", s["flops"] / PEAK_FP32 * 1e3)
                for s in shapes)
    return {"name": name, "route": "cuda",
            "source": f"{PKG}/{source}", "replaces": replaces,
            "launches": None,
            "max_abs_err": max(s["max_abs_err"] for s in shapes),
            "ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": total("library_ms"), "shapes": shapes}


def serve_latency(svc, scans: dict, reps: int = 7) -> dict:
    """Host-clock latency of warm ``reconstruct`` requests (each ends
    when its numpy answer is on the host), by request size."""
    out = {}
    for b, x in scans.items():
        svc.reconstruct(x)                       # warm this bucket
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            svc.reconstruct(x)
            ts.append((time.perf_counter() - t0) * 1e3)
        ts.sort()
        p50 = ts[len(ts) // 2]
        out[b] = {"p50_ms": p50, "min_ms": ts[0], "max_ms": ts[-1],
                  "n": reps, "meshes_per_s": b / p50 * 1e3}
    return out


def device_profile(torch, fn) -> dict:
    """One warm call of ``fn`` under torch.profiler: wall time, device
    time by kernel name and the device's idle share of the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    return {"wall_ms": wall_ms, "device_ms": busy if rows else None,
            "idle_share": 1 - busy / wall_ms if rows else None,
            "by_kernel": [{"name": n[:80], "ms": t, "count": c}
                          for n, t, c in rows[:15]]}


def phase_serving(torch, mods, bundle, config) -> dict:
    """The port's main path on the card, then the same on the host."""
    from craniofacialsd_vae_tpu_torch.ops import selection_indices
    from craniofacialsd_vae_tpu_torch.serving import DiagnosisService
    from craniofacialsd_vae_tpu_torch.viz import (errors_to_colors,
                                                  render_batch)

    kernels = mods["kernels"]
    rng = np.random.default_rng(SEED)
    n = bundle.vertex_counts[0]
    # a head in the template's own frame, spread by a seeded per-vertex std
    mean = scatter_coo(bundle.up[0], bundle.lr_pos[0])
    std = (0.01 + 0.02 * rng.random((n, 3))).astype(np.float32)
    norm = {"mean": mean, "std": std}
    scans = {b: (mean + std * rng.normal(size=(b, n, 3))).astype(np.float32)
             for b in REQUEST_SIZES}
    sel = selection_indices(bundle.down[0])
    faces = bundle.lr_face[0]

    t0 = time.perf_counter()
    svc = DiagnosisService(bundle, config, norm, TO_MM, seed=SEED,
                           max_batch=BATCH, device=DEVICE)
    setup_s = time.perf_counter() - t0

    # the main path: counts from 0, requests, renders, counts read
    kernels.launches.reset()
    t_main = time.perf_counter()
    answers, req_ms = {}, {}
    for b in REQUEST_SIZES:
        t1 = time.perf_counter()
        answers[b] = svc.reconstruct(scans[b])
        req_ms[b] = (time.perf_counter() - t1) * 1e3
    last = answers[REQUEST_SIZES[-1]]
    recon_lr0 = last["vertices"][:, sel]
    colors = errors_to_colors(last["vertex_errors_mm"][:, sel], 0,
                              ERROR_MAX_MM, "plasma") / 255.0
    t1 = time.perf_counter()
    shaded = render_batch(recon_lr0, faces, image_size=IMAGE, device=DEVICE)
    errmap = render_batch(recon_lr0, faces, colors, image_size=IMAGE,
                          shadeless=True, device=DEVICE)
    render_ms = (time.perf_counter() - t1) * 1e3
    main_s = time.perf_counter() - t_main
    counts = kernels.launches.snapshot()
    log(f"[4 serve] service built in {setup_s:.2f} s; reconstruct ms by "
        f"batch {{{', '.join(f'{b}: {req_ms[b]:.1f}' for b in req_ms)}}}; "
        f"{2 * len(recon_lr0)} renders in {render_ms:.1f} ms; launches "
        f"{counts}")

    for b, ans in answers.items():
        check(ans["vertices"].shape == (b, n, 3)
              and ans["vertex_errors_mm"].shape == (b, n)
              and ans["latent"].shape == (b, config.latent_size),
              f"reconstruct B={b}: shapes")
        for key, v in ans.items():
            check(np.isfinite(v).all(), f"reconstruct B={b}: {key} finite")
    for imgs in (shaded, errmap):
        check(imgs.shape == (len(recon_lr0), IMAGE, IMAGE, 3)
              and np.isfinite(imgs).all()
              and imgs.min() >= 0.0 and imgs.max() <= 1.0, "render range")
        cover = float((imgs.sum(-1) > 0).mean())
        check(0.05 < cover < 0.95, f"render covers {cover:.3f}")

    # the same service on the host (plain versions), same seed and scans
    cpu = DiagnosisService(bundle, config, norm, TO_MM, seed=SEED,
                           max_batch=BATCH, device="cpu")
    for k, v in cpu.model.state_dict().items():
        check(torch.equal(v, svc.model.state_dict()[k].cpu()),
              f"weights differ at {k}")
    worst = {}
    for b in REQUEST_SIZES:
        ref = cpu.reconstruct(scans[b])
        for key in ("vertices", "latent"):
            d = float(np.abs(answers[b][key] - ref[key]).max())
            lim = SERVE_RTOL * float(np.abs(ref[key]).max())
            check(d <= lim, f"B={b} {key}: card vs host {d:.3e} > {lim:.3e}")
            worst[key] = max(worst.get(key, 0.0), d)
        d = float(np.abs(answers[b]["vertex_errors_mm"]
                         - ref["vertex_errors_mm"]).max())
        check(d <= SERVE_ERR_ATOL_MM, f"B={b} error: card vs host {d:.3e} mm")
        worst["vertex_errors_mm"] = max(worst.get("vertex_errors_mm", 0.0), d)
        if b == REQUEST_SIZES[-1]:
            ref_imgs = render_batch(ref["vertices"][:2, sel], faces,
                                    image_size=IMAGE, device="cpu")
    px = np.abs(shaded[:2] - ref_imgs).max(-1)
    frac = float((px > 1e-3).mean())
    check(frac < 0.01, f"card vs host render: {frac:.4f} of pixels differ")
    log(f"[4 serve] card vs host: max |diff| {worst}; renders differ at "
        f"{frac:.5f} of pixels (mean {float(px.mean()):.2e})")

    # after the counted run: warm latency and where the device time goes
    latency = serve_latency(svc, scans)
    log("[4 serve] warm reconstruct p50 ms (meshes/s) by batch: " + ", ".join(
        f"{b}: {v['p50_ms']:.2f} ({v['meshes_per_s']:.0f})"
        for b, v in latency.items()))
    prof_req = device_profile(torch, lambda: svc.reconstruct(scans[BATCH]))
    prof_render = device_profile(torch, lambda: render_batch(
        recon_lr0[:BATCH], faces, image_size=IMAGE, device=DEVICE))
    for what, p in (("reconstruct B=16", prof_req),
                    (f"render_batch {BATCH} x {IMAGE}²", prof_render)):
        top = ", ".join(f"{k['name'][:40]} {k['ms']:.3f}"
                        for k in p["by_kernel"][:6])
        log(f"[4 profile] {what}: wall {p['wall_ms']:.2f} ms, device "
            f"{p['device_ms']} ms, idle share {p['idle_share']}; {top}")
    return dict(counts=counts, request_ms=req_ms, render_ms=render_ms,
                latency=latency, profile_reconstruct=prof_req,
                profile_render=prof_render,
                renders=2 * len(recon_lr0), main_s=main_s, setup_s=setup_s,
                card_vs_host=worst, render_px_differ=frac,
                mean_error_mm={b: float(a["mean_error_mm"].mean())
                               for b, a in answers.items()})


# ----------------------------------------------------------------------
def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--json", metavar="PATH",
                        help="write every measurement to this JSON file")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one NVIDIA card",
              file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, PKG)):
        print(f"chip_smoke: {PKG}/ not found beside this script; run it "
              "from the root of a checkout", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    t_start = time.perf_counter()

    from craniofacialsd_vae_tpu_torch import kernels, ops
    from craniofacialsd_vae_tpu_torch.geometry import load_bundle
    from craniofacialsd_vae_tpu_torch.models import (SDVAEConfig,
                                                     SpiralGeometry,
                                                     init_sdvae)
    from craniofacialsd_vae_tpu_torch.viz import raster

    mods = {"kernels": kernels, "ops": ops, "raster": raster}
    name, smi_line = phase_device(torch)
    build_s, build_log = phase_build(kernels)

    bundle = load_bundle(os.path.join(ROOT, "tests", "fixtures",
                                      "geometry.npz"))
    config = SDVAEConfig.from_dict(MODEL_CONFIG, KL_WEIGHT)
    geom = SpiralGeometry.from_bundle(bundle, device=DEVICE)
    model = init_sdvae(config, geom, torch.Generator().manual_seed(SEED))
    records = [*k1_parity(torch, mods, model, geom, build_log),
               k4_parity(torch, mods, model, geom, bundle),
               k7_parity(torch, mods, bundle)]
    del model, geom
    torch.cuda.empty_cache()

    serve = phase_serving(torch, mods, bundle, config)
    for rec in records:
        rec["launches"] = serve["counts"][rec["name"]]
        check(rec["launches"] > 0,
              f"{rec['name']} was not launched on the serving path")
    log(f"[5 counts] {serve['counts']}; total {time.perf_counter() - t_start:.1f} s")

    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"device": name, "nvidia_smi": smi_line,
                       "torch": torch.__version__, "build_s": build_s,
                       "kernels": records, "serving": serve}, f, indent=1)

    print(json.dumps({"kernels": [
        {k: r[k] for k in ("name", "route", "source", "replaces", "launches",
                           "max_abs_err", "ms", "plain_ms", "bound_ms",
                           "bound_by", "library_ms")} for r in records]}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving, training and diagnosis paths
on one NVIDIA card.

Run from the root of a checkout::

    python3 chip_smoke.py [--json PATH]

It needs one CUDA card and ``nvcc``, and fails (exit code 1) without
them or outside a checkout. Phases, each of which raises on a fault:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: compiles the kernels of ``craniofacialsd_vae_tpu_torch/csrc``
   with nvcc for sm_90a;
3. kernel parity at the serving path's shapes: every spiral conv of the
   model (K1: its tensor-core and narrow-output kernels, with each conv's
   path, both bounds and ptxas's registers and spills per kernel; the
   tiled narrow kernel also timed against the untiled one it replaced) and
   every up-pool (K4, also timed on sequential indices), each at the
   service's batch buckets B = 16, 4 and 1, and 256² z-buffer sweeps of the lr0 mesh, a
   sphere and an adversarial mesh (K7, against the bound from what the
   inputs need and the old strip-cull bound), each held against its
   plain PyTorch twin on the same inputs and timed with CUDA events
   against its twin and a library call;
4. serving at full width (17,039 vertices, channels 32/32/32/64, latent
   75, seeded weights): a ``DiagnosisService(max_batch=16)`` answers
   ``reconstruct`` requests of 1, 3, 16 and 20 scans, checked against the
   same service on the host, then the lr0 selection of the
   reconstructions is rendered shaded and as a plasma error map (one K7
   launch per call); after the counted run, one K7 launch over those 20
   reconstructions, the shape of each counted launch, is held against the twin mesh by mesh, the
   renders against the host's (unquantized) and the uint8 transfer
   against the card's floats, and render and request times are taken;
5. training at full width (``configurations/smoke.yaml``'s model and
   optimisation sections: 4 scans, a 16-mesh swap grid, the stand-in
   Laplacian and 15 stand-in regions of ``geometry/synthetic.py``):
   (a) K2-dW at the nine convs' shapes (with each conv's plan, both
   bounds and ptxas's registers and spills per instance) and, on every
   backward table (the up-pools' and the convs' transposes, the
   Laplacian and its transpose), the fused K4 where the table has
   overflow tiers and K4 where it has none, held against their twins
   and timed (the fused launch also against K4 alone and K4 followed by
   the tiers' twin);
   (b) one counted ``make_train_step`` step on the card against the same
   step on the host (same weights, scans, region and noise): losses and
   every gradient leaf; (c) 10 warm steps (host-clock step time,
   throughput, finite losses) and a profiled step;
6. launch counts, read per path: K1, K4 and K7 must each have run during
   phase 4, and K1, K4, K2-dW and the fused K4 during phase 5's counted
   step (which must match ``expected_step_launches`` exactly); every
   float32 kernel must have run on one of them (the bf16 kernels on phase
   8's paths);
7. the training entry point end to end (``python -m
   craniofacialsd_vae_tpu_torch.train``, called in process), in a
   temporary directory: a coloured octasphere template PLY (16,386
   vertices, 15 regions), 40 OBJ scans of 5 classes and
   ``configurations/smoke.yaml`` pointed at them (4 epochs, renders and
   checkpoints every 2). The entry point builds the geometry, the
   dataset and its caches, trains on the card, renders (K7 at full
   resolution) and checkpoints; a fresh manager resumes the last
   checkpoint bit for bit; ``--resume --epochs 6`` goes on. K1, K2-dW, K4,
   the fused K4 and K7 must each have launched on that path. Then one
   epoch on the card is held against the host, K7 on a full-resolution
   reconstruction against its twin, and each kernel at the path's own
   shapes against its twin; one ``{"phase": "train_entry", ...}`` line;
8. the ``mixed`` policy of ``configurations/craniofacial.yaml`` (its
   model and optimisation sections, through the port's config reader):
   (a) every bf16 kernel at every shape of the mixed paths (K1-bf16, K3b,
   its backward ``out_gather_sum_bwd`` (also against the per-position
   transposes and stack it replaced) and K4-bf16 at B = 16, 4, 1; K3a
   through the vertex tiles at B = 16, 4, 1 on the fixture's and the
   octasphere's level 0, beside the untiled kernel it replaced;
   K2-dW-bf16 at the grid; K4-bf16 or its capped form on every bf16
   backward table at the grid's and the other buckets' widths), held
   against its twin (bit-equal where both round at the same points, else
   within one bf16 ulp; K3a within K3A_RTOL), timed against it and a library
   form, with its bound at 3.35 TB/s and 989 TFLOP/s bf16 and ptxas's
   registers; (b) a mixed ``DiagnosisService(max_batch=16)`` answers
   phase 4's requests and renders the error maps (counted), held
   against the same service on the host and phase 4's fp32 answers;
   (c) one counted mixed step (launches equal to
   ``expected_step_launches``) against the host's, its gradient against
   the card's fp32 step's, 10 warm steps and a profiled step beside
   phase 5's; the path of ``final_out_gather: false`` (K3a), counted;
   (d) ``train.main`` under ``mixed`` for 2 epochs on phase 7's
   workspace, resumed bit for bit; one ``{"phase": "mixed", ...}`` line.
   Phases 7 and 8's ``train.main`` also fit the classifier zoo and write
   ``classifiers.npz`` and ``z_stats.npz`` (fit time and the four
   validation accuracies recorded);
9. diagnosis: K8 (``k8_fwd`` both directions, ``k8_bwd``) at the fit's
   shapes (16 restarts of 4,097 points against 8,192) and at one restart,
   against its twins (distances within K8_D_RTOL of the largest, argmins
   where the best two are apart, gradients within K8_G_RTOL card vs
   host), timed against the twins, the bound and ``torch.cdist`` with
   both minima; then each of phase 7's (fp32) and phase 8's (mixed) run
   dirs served by ``DiagnosisService.from_run_dir`` on the card, counted:
   ``diagnose`` at 1, 3, 16 and 20 scans and with 32 posterior draws,
   ``saliency`` at 4, one ``plan`` and one ``fit`` of a 32,768-point
   unregistered scan (250 iterations, 16 restarts); the diagnose
   latencies, the fit's kernels and device time per iteration; the same
   requests on the host (the fit at FIT_PARITY_ITERATIONS on both):
   fp32 labels equal, posteriors, Mahalanobis and plan latents within
   DIAG_RTOL, saliency within SALIENCY_RTOL of its max, the fit's chamfer
   within FIT_RTOL with the same best restart; mixed labels equal, the
   fit's chamfer and the saliency within MIXED_FIT_RTOL; the counted
   250-iteration fit no worse than the held 10-iteration one; then every
   other kernel of each path at each of its shapes there (the served
   model's convs at every encode and decode bucket, its up-pools, the
   transposes of saliency's backward to the data at B = 4 and of the
   fit's backward to z at R = 16) against its twin and timed, with the
   launches those shapes account for equal to the counted run's, kernel
   for kernel; the HTTP entry point once (``POST /diagnose``, ``GET
   /healthz``); one ``{"phase": "diagnosis", ...}`` line.

The kernels' record holds one entry per kernel and path (``serving``,
``training``, ``train_entry``, ``mixed_serving``, ``mixed_training``,
``mixed_gather_first``, ``diagnosis``, ``mixed_diagnosis``), each timed
over the shapes of that path's launches (on the diagnosis paths each
distinct shape once; every shape carries its launches). The last three
lines of standard output are the kernels' JSON record, the nvidia-smi
line and ``{"ok": true, "device": {...}}``.
``--json`` also writes every measurement (per shape, per request size,
the profiles) to PATH. Nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
PKG = "craniofacialsd_vae_tpu_torch"
DEVICE = "cuda"
SEED = 0
BATCH = 16
# the service's batch buckets on the main path: requests of 1, 3, 16 and
# 20 scans run at B = 1, 4, 16 and 16 + 4
BATCHES = (BATCH, 4, 1)
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
# configurations/smoke.yaml: the optimization section of the training phase
TRAIN_CONFIG = {
    "batch_size": 4,
    "lr": 1e-4,
    "weight_decay": 0,
    "laplacian_weight": 0.1,
    "kl_weight": 1e-4,
    "latent_consistency_weight": 0.5,
    "latent_consistency_eta1": 0.5,
    "latent_consistency_eta2": 0.5,
}
N_REGIONS = 15          # the stand-in regions (the template has 15)
WARM_STEPS = 10
# phase 7: the coloured octasphere stands in for the 17,039-vertex
# template.ply, which is not in the repo (16,386 vertices, 32,768 faces,
# 15 regions: latent 75 / 15), with 8 scans of each of 5 classes
ENTRY_SUBDIVISIONS = 6
ENTRY_REGIONS = 15
ENTRY_CLASSES = "abcmn"
ENTRY_PER_CLASS = 8
ENTRY_EPOCHS = (4, 6)   # the first run, then --resume to the second
ENTRY_CADENCE = 2       # tb_renderings and save_weights
REQUEST_SIZES = (1, 3, 16, 20)
ERROR_MAX_MM = 5.0
# H100 SXM peaks (data sheet): HBM bytes/s, fp32 flop/s off the tensor
# cores and dense TF32 flop/s on them (3xTF32 runs three TF32 products)
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
PEAK_TF32 = 495e12
PEAK_BF16 = 989e12      # dense bf16 on the tensor cores
# tolerances
K1_RTOL = 1e-5          # against max |out|: fp32 dot products summed in
#                         another order than the library matmul's
SERVE_RTOL = 1e-4       # card vs host service, against each array's max
SERVE_ERR_ATOL_MM = 1e-3
K2_RTOL = 1e-5          # K2-dW vs its twin, against max |dW|: fp32 sums of
#                         M·B products in another order than the library
#                         matmul's
TRAIN_RTOL = 1e-4       # card step vs host step: losses, and each gradient
#                         leaf against its max
K3A_RTOL = 1e-5         # K3a vs its twin against max |out|: fp32 sums of bf16
#                         products in another order
BF16_FLOOR_RTOL = 1e-5  # K1-bf16, K2-dW-bf16: one bf16 ulp, or K3A_RTOL of the
#                         max where a sum cancels to nearly 0 (``ulps``)
MIXED_RTOL = 1e-2       # mixed card vs mixed host (answers against each
#                         array's max, step losses): a bf16 rounding may land
#                         on the other neighbour and compound over layers
MIXED_VS_FP32_RTOL = 5e-2   # mixed vs fp32 answers: the JAX package's own
#                             tolerance for the policy
MIXED_COSINE = 0.999    # the whole gradient's cosine, the JAX package's bar
# phase 8: the flagship configuration's model and optimisation sections
FLAGSHIP = "craniofacial.yaml"
# phase 9: the diagnosis path on phases 7's and 8's run dirs
FIT_SCAN_POINTS = 8192 * 4      # the intake's scan: [::4] buckets to 8,192
FIT_GEN_POINTS = 4097           # the octasphere's 16,386 vertices at [::4]
FIT_ITERATIONS = 250
FIT_RESTARTS = 16
FIT_PARITY_ITERATIONS = 10      # the fit held card vs host (the host's
#                                 loop at full width takes seconds a step)
FIT_PROFILE_ITERATIONS = 5
DIAG_SAMPLES = 32
SALIENCY_BATCH = 4
K8_OPS_PER_PAIR = 7             # three FMAs (6 flops) and a compare
K8_BWD_OPS_PER_POINT = 10       # a difference, its scale and the sum
K8_D_RTOL = 1e-5                # K8 vs twin, against max d: another FMA
#                                 order than the twin's expansion
K8_G_RTOL = 1e-4                # K8's gradients, against their max
DIAG_RTOL = 1e-4                # card vs host: posteriors, Mahalanobis,
#                                 uncertainty statistics, plan latents
SALIENCY_RTOL = 1e-3            # card vs host saliency, against its max
FIT_RTOL = 1e-3                 # card vs host fit chamfer (fp32)
MIXED_FIT_RTOL = 5e-2           # card vs host fit chamfer and saliency
#                                 (mixed): the JAX package's tolerance for
#                                 the policy
FP32_KERNELS = ("spiral_conv_tc", "spiral_conv_narrow", "ell_matmul_fwd",
                "raster_sweep", "spiral_conv_dw", "ell_matmul_capped")
MIXED_KERNELS = ("spiral_conv_bf16", "spiral_conv_f32out",
                 "spiral_conv_dw_bf16", "ell_matmul_bf16",
                 "ell_matmul_capped_bf16", "out_gather_sum",
                 "out_gather_sum_bwd")

# each kernel's source in the port and the JAX function it replaces
KERNEL_SOURCES = {
    "spiral_conv_tc": ("csrc/spiral_conv.cu",
                       "craniofacialsd_vae_tpu/ops/spiral_conv.py:159"),
    "spiral_conv_narrow": ("csrc/spiral_conv.cu",
                           "craniofacialsd_vae_tpu/ops/spiral_conv.py:159"),
    "ell_matmul_fwd": ("csrc/ell_matmul.cu",
                       "craniofacialsd_vae_tpu/ops/sparse.py:191"),
    "ell_matmul_capped": ("csrc/ell_matmul.cu",
                          "craniofacialsd_vae_tpu/ops/sparse.py:101"),
    "spiral_conv_bf16": ("csrc/spiral_conv_bf16.cu",
                         "craniofacialsd_vae_tpu/ops/spiral_conv.py:160"),
    "spiral_conv_f32out": ("csrc/spiral_conv_bf16.cu",
                           "craniofacialsd_vae_tpu/ops/spiral_conv.py:267"),
    "ell_matmul_bf16": ("csrc/ell_matmul_bf16.cu",
                        "craniofacialsd_vae_tpu/ops/sparse.py:191"),
    "ell_matmul_capped_bf16": ("csrc/ell_matmul_bf16.cu",
                               "craniofacialsd_vae_tpu/ops/sparse.py:101"),
    "spiral_conv_dw_bf16": ("csrc/spiral_conv_dw_bf16.cu",
                            "craniofacialsd_vae_tpu/ops/spiral_conv.py:208"),
    "out_gather_sum": ("csrc/out_gather_sum.cu",
                       "craniofacialsd_vae_tpu/ops/spiral_conv.py:260"),
    "out_gather_sum_bwd": ("csrc/out_gather_sum.cu",
                           "craniofacialsd_vae_tpu/ops/sparse.py:280"),
    "k8_fwd": ("csrc/distances.cu",
               "craniofacialsd_vae_tpu/ops/distances.py:32"),
    "k8_bwd": ("csrc/distances.cu",
               "craniofacialsd_vae_tpu/ops/distances.py:32"),
}


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
    """Registers and spills of each K1 and K2-dW kernel and of the bf16
    kernels, from the build's ``-Xptxas -v`` output: ``tc<MI,NI>``,
    ``narrow<..>``, ``dw<MI,NI>`` (K2-dW's instance for MI x NI fragments
    per warp), ``dw_sum`` (its chunk sum), ``bf16<NT,ELEM>`` (K1-bf16 and
    K3a), ``bf16_tile<VEC>`` (K3a's tiled kernel), ``dw_bf16<FPW>``,
    ``dw_bf16_sum``, ``ell_bf16_vector<KK,CAPPED>``,
    ``ell_bf16_scalar<CAPPED>``, ``out_gather_sum`` (K3b) and
    ``out_gather_sum_bwd``; the narrow kernels as ``narrow<CO,TBM>`` and
    ``narrow_tile<CO,TBM,VEC,FULL>``."""
    out, name = [], None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"spiral_conv_(tc|narrow)_kernelILi(\d+)ELi(\d+)E",
                          m.group(1))
            nt = re.search(r"spiral_conv_narrow_tile_kernelILi(\d+)ELi(\d+)"
                           r"ELb(\d)ELb(\d)E", m.group(1))
            dw = re.search(r"spiral_conv_dw_kernelILi(\d+)ELi(\d+)E",
                           m.group(1))
            bf = re.search(r"spiral_conv_bf16_kernelILi(\d+)ELb(\d)E",
                           m.group(1))
            dwb = re.search(r"spiral_conv_dw_bf16_kernelILi(\d+)E",
                            m.group(1))
            ell = re.search(r"ell_bf16_vectorILi(\d+)ELb(\d)E", m.group(1))
            ells = re.search(r"ell_bf16_scalarILb(\d)E", m.group(1))
            bt = re.search(r"spiral_conv_bf16_tile_kernelILb(\d)E",
                           m.group(1))
            name = (f"{k.group(1)}<{k.group(2)},{k.group(3)}>" if k
                    else f"narrow_tile<{nt.group(1)},{nt.group(2)},"
                    f"{nt.group(3)},{nt.group(4)}>" if nt
                    else f"dw<{dw.group(1)},{dw.group(2)}>" if dw
                    else "dw_sum" if "spiral_conv_dw_sum" in m.group(1)
                    else f"bf16<{bf.group(1)},{bf.group(2)}>" if bf
                    else f"dw_bf16<{dwb.group(1)}>" if dwb
                    else "dw_bf16_sum" if "spiral_conv_dw_bf16_sum"
                    in m.group(1)
                    else f"ell_bf16_vector<{ell.group(1)},{ell.group(2)}>"
                    if ell
                    else f"ell_bf16_scalar<{ells.group(1)}>" if ells
                    else f"bf16_tile<{bt.group(1)}>" if bt
                    else "out_gather_sum_bwd" if "out_gather_sum_bwd_kernel"
                    in m.group(1)
                    else "out_gather_sum" if "out_gather_sum_kernel"
                    in m.group(1)
                    else None)
            if name:
                out.append({"kernel": name})
        elif name and "Used" in line:
            out[-1]["registers"] = int(re.search(r"Used (\d+) registers",
                                                 line).group(1))
        elif name and "spill" in line:
            out[-1]["spill_bytes"] = sum(
                int(n) for n in re.findall(r"(\d+) bytes spill", line))
    return out


def model_convs(model, geom) -> list:
    """``(name, conv, spiral op)`` of every spiral conv of a forward pass,
    in its order."""
    n = len(model.en_convs)
    convs = [(f"enc{i}", model.en_convs[i], geom.enc_spirals[i])
             for i in range(n)]
    convs += [(f"dec{n - 1 - j}", model.de_convs[j],
               geom.spirals[n - 1 - j]) for j in range(n)]
    convs.append(("final", model.final_conv, geom.spirals[0]))
    return convs


def conv_widths(conv, op) -> tuple:
    return conv.w.shape[0] // op.seq_length, conv.w.shape[1]


def k1_parity(torch, mods, model, geom, build_log: str) -> list:
    """Every spiral conv of a forward pass, at each batch bucket, with the
    model's own (seeded) weights and random inputs: parity with the plain
    twin, two launches bit-equal, times against the twin and the library
    form. One record per K1 kernel from the B = 16 pass."""
    kernels, ops = mods["kernels"], mods["ops"]
    for k in k1_ptxas(build_log):
        if "bf16" in k["kernel"] or k["kernel"].startswith("out_gather"):
            continue                     # phase 8's
        log(f"[3 ptxas] {k['kernel']}: {k.get('registers')} registers, "
            f"{k.get('spill_bytes', 0)} bytes spilled")
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    by_batch = {}
    for batch in BATCHES:
        shapes = []
        for name, conv, op in model_convs(model, geom):
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
        rec["other_batches"] = {
            b: [s for s in by_batch[b] if s["kernel"] == kernel]
            for b in BATCHES[1:]}
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
                                    w_l.data_ptr() % 16 == 0,
                                    n_tiles=op.tiles.n_tiles,
                                    tile_rows=op.tiles.max_rows)
    launch = lambda: kernels.spiral_conv_fwd(            # noqa: E731
        x, table, w_l, b, tiles=op.tiles)
    with torch.inference_mode():
        out = launch()
        again = launch()
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
        ms = cuda_ms(torch, launch, 20)
        plain_ms = cuda_ms(
            torch, lambda: ops.spiral_conv_plain(w_l, b, x, op), 5)
        lib_ms = cuda_ms(torch, lib, 5)
        old_ms = None
        if plan.path == "narrow_tile":
            # the design it replaced: each row gathered from L2
            old = lambda: kernels.spiral_conv_fwd(       # noqa: E731
                x, table, w_l, b)
            check(max_err(old(), ref) <= K1_RTOL * scale,
                  f"K1 {name} B={batch}: narrow_out disagrees")
            old_ms = cuda_ms(torch, old, 20)
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
        f"{fp32_ms:.4f}; kernel/library {ms / lib_ms:.2f}"
        + (f"; untiled narrow_out {old_ms:.4f} ms ({op.tiles.n_tiles} tiles "
           f"of at most {op.tiles.max_rows} rows, "
           f"{op.tiles.src.numel() / m:.2f} rows a vertex)"
           if old_ms is not None else ""))
    return dict(conv=name, batch=batch, kernel=plan.kernel, path=plan.path,
                plan=dataclasses.asdict(plan), n_src=op.n_src, m=m,
                c_in=c_in, c_out=c_out, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                bound_by=b_by, bound_fp32_ms=fp32_ms, bytes=nbytes,
                flops=flops, ops_ms=(3 * flops / PEAK_TF32 * 1e3
                                     if plan.kernel == "spiral_conv_tc"
                                     else flops / PEAK_FP32 * 1e3),
                earlier_ms=old_ms)


def k4_parity(torch, mods, model, geom, bundle) -> dict:
    """Every up-pool of the decoder at each batch bucket, at its channel
    width: bit-equal to the plain twin, timed against the twin, the
    library call and, at B = 16, the same launch on sequential indices
    (``cols[m, k] = m·K + k`` over an ``[M·K, D]`` source: the same
    gathered bytes, each read once). One record from the B = 16 pass."""
    kernels, ops = mods["kernels"], mods["ops"]
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    n = len(model.de_convs)
    by_batch = {}
    for batch in BATCHES:
        shapes = []
        for j in range(n):
            level = n - 1 - j
            c = model.de_convs[j].w.shape[0] // geom.spirals[level].seq_length
            shapes.append(k4_shape(torch, kernels, ops, gen, geom.up[level],
                                   bundle.up[level], level, batch * c,
                                   batch))
        tot = {k: sum(s[k] for s in shapes)
               for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
        log(f"[3 K4 B={batch}] per pass: kernel {tot['ms']:.4f} ms, plain "
            f"{tot['plain_ms']:.4f} ms, library {tot['library_ms']:.4f} ms, "
            f"bound {tot['bound_ms']:.4f} ms")
        by_batch[batch] = shapes
    rec = summarize("ell_matmul_fwd", "csrc/ell_matmul.cu",
                    "craniofacialsd_vae_tpu/ops/sparse.py:191",
                    by_batch[BATCH])
    rec["other_batches"] = {b: by_batch[b] for b in BATCHES[1:]}
    return rec


def k4_shape(torch, kernels, ops, gen, mat, coo, level, d, batch) -> dict:
    n_src = mat.n_cols
    m, k = mat.cols.shape
    x2 = torch.randn((n_src, d), generator=gen, device=DEVICE)
    sp = torch.sparse_coo_tensor(
        torch.as_tensor(np.stack([coo.rows, coo.cols]).astype(np.int64)),
        torch.as_tensor(coo.vals), coo.shape,
        check_invariants=True).coalesce().to(DEVICE)
    with torch.inference_mode():
        out = kernels.ell_matmul_fwd(mat.cols, mat.vals, x2)
        ref = ops.ell_matmul_plain(mat.cols, mat.vals, x2)
        torch.cuda.synchronize()
        check(torch.equal(out, ref),
              f"K4 up{level} B={batch}: kernel and plain twin differ at "
              f"{int((out != ref).sum())} values")
        scale = float(ref.abs().max())
        lib = lambda: torch.sparse.mm(sp, x2)               # noqa: E731
        lib_err = max_err(lib(), ref)
        check(lib_err <= 1e-5 * scale,
              f"K4 up{level}: library form disagrees ({lib_err:.3e})")
        ms = cuda_ms(torch, lambda: kernels.ell_matmul_fwd(
            mat.cols, mat.vals, x2), 50)
        plain_ms = cuda_ms(torch, lambda: ops.ell_matmul_plain(
            mat.cols, mat.vals, x2), 10)
        lib_ms = cuda_ms(torch, lib, 10)
        seq_ms = None
        if batch == BATCH:
            xs = torch.randn((m * k, d), generator=gen, device=DEVICE)
            seq = torch.arange(m * k, dtype=torch.int32,
                               device=DEVICE).view(m, k)
            seq_ms = cuda_ms(torch, lambda: kernels.ell_matmul_fwd(
                seq, mat.vals, xs), 50)
            del xs
    nbytes = 4 * (n_src * d + 2 * m * k + m * d)
    flops = 2.0 * m * k * d
    b_ms, b_by, _, _ = bound(nbytes, flops)
    seq_txt = f", sequential indices {seq_ms:.4f} ms" if seq_ms else ""
    log(f"[3 K4 up{level} B={batch}] {n_src}->{m} K={k} D={d}: "
        f"bit-equal; kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}){seq_txt}")
    return dict(pool=f"up{level}", batch=batch, n_src=n_src, m=m, k=k, d=d,
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, sequential_ms=seq_ms,
                bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=flops)


def camera_frame(verts: np.ndarray) -> np.ndarray:
    from craniofacialsd_vae_tpu_torch.viz.renderer import look_at_camera

    eye, rot = look_at_camera()
    return ((verts - eye) @ rot.T).astype(np.float32)


def k7_work(torch, raster, inp, pts, faces) -> dict:
    """What a sweep of one mesh (inputs without a batch dim) must do and
    what the kernel and the twin do: pixel centres inside the triangles'
    boxes (each an inside test of 16 flops: 4 affine forms of 2 products
    and 2 sums), the pairs the kernel evaluates (``raster.sweep_pairs``),
    the pairs the twin's strip cull keeps, and the bytes (the 12
    coefficients of each real face read once, z and winner written
    once)."""
    n_pix = IMAGE * IMAGE
    coef = inp.coef
    live = ~((coef[:len(faces), 0] == 0) & (coef[:len(faces), 1] == 0)
             & (coef[:len(faces), 2] < 0))
    x, y = pts[faces, 0][live], pts[faces, 1][live]

    def centres(lo, hi):          # pixel centres c + 0.5 in [lo, hi]
        first = torch.ceil(lo.clamp(-1, IMAGE) - 0.5).clamp(min=0)
        last = torch.floor(hi.clamp(-1, IMAGE) - 0.5).clamp(max=IMAGE - 1)
        return (last - first + 1).clamp(min=0)

    needed = float((centres(x.amin(1), x.amax(1))
                    * centres(y.amin(1), y.amax(1))).sum())
    pix, _ = raster.sweep_pairs(inp, IMAGE)
    cull = raster._cull_tile(n_pix)
    t = torch.arange(-(-n_pix // cull), device=coef.device)
    lo, hi = raster._strip_rows(t, cull, IMAGE)
    keep = ((inp.ymin[None, :] <= hi[:, None])
            & (inp.ymax[None, :] >= lo[:, None]))
    tile_pix = torch.clamp(n_pix - t * cull, max=cull)
    strip_pairs = float((keep.sum(1) * tile_pix).sum()) * raster.TRI_BLOCK
    return dict(needed_pairs=needed, kernel_pairs=int(pix.numel()),
                strip_pairs=strip_pairs,
                bytes=48 * len(faces) + 8 * n_pix,
                strip_bytes=4 * (coef.numel() + 2 * inp.ymin.numel())
                + 8 * n_pix)


def k7_bounds(works: list) -> dict:
    """The bound from what the inputs need, and the strip-cull bound
    (every pixel against every 256-triangle block the twin's strip cull
    keeps)."""
    b_ms, b_by, _, _ = bound(sum(w["bytes"] for w in works),
                             16.0 * sum(w["needed_pairs"] for w in works))
    s_ms, s_by, _, _ = bound(sum(w["strip_bytes"] for w in works),
                             16.0 * sum(w["strip_pairs"] for w in works))
    return dict(bound_ms=b_ms, bound_by=b_by, bound_strip_ms=s_ms,
                bound_strip_by=s_by,
                bytes=sum(w["bytes"] for w in works),
                flops=16.0 * sum(w["needed_pairs"] for w in works),
                needed_pairs=sum(w["needed_pairs"] for w in works),
                kernel_pairs=sum(w["kernel_pairs"] for w in works),
                strip_pairs=sum(w["strip_pairs"] for w in works))


def k7_case(torch, mods, name: str, verts_cam: np.ndarray, faces, reps: int,
            plain_reps: int, check_cover: bool = True) -> dict:
    """One K7 launch over ``verts_cam [B, V, 3]`` at IMAGE²: z and winner
    of every mesh bit-identical to the plain twin, timed against the twin
    (mesh by mesh) and both bounds."""
    kernels, raster = mods["kernels"], mods["raster"]
    n_pix = IMAGE * IMAGE
    f = torch.as_tensor(faces, device=DEVICE).long()
    pts = raster.project(torch.as_tensor(verts_cam, device=DEVICE), IMAGE)
    inp = raster.sweep_inputs(pts, f, IMAGE)
    cull = raster._cull_tile(n_pix)

    def launch():
        return kernels.raster_sweep(inp.coef, inp.box, inp.block_box,
                                    inp.ymin, inp.ymax, IMAGE, cull)

    def plain():
        return [raster._zbuffer_sweep_plain(c, lo, hi, IMAGE)
                for c, lo, hi in zip(inp.coef, inp.ymin, inp.ymax)]

    with torch.inference_mode():
        z, win = launch()
        ref = plain()
        torch.cuda.synchronize()
        for b, (z_ref, w_ref) in enumerate(ref):
            check(torch.equal(z[b], z_ref) and torch.equal(win[b], w_ref),
                  f"K7 {name} mesh {b}: z/winner differ from the plain twin "
                  f"at {int((z[b] != z_ref).sum())}/"
                  f"{int((win[b] != w_ref).sum())} pixels")
            hits = int((win[b] < len(faces)).sum())
            check(not check_cover or 0.05 * n_pix < hits < 0.95 * n_pix,
                  f"K7 {name} mesh {b}: {hits} of {n_pix} pixels hit")
        ms = cuda_ms(torch, launch, reps)
        plain_ms = cuda_ms(torch, plain, plain_reps)
        works = [k7_work(torch, raster,
                         raster.SweepInputs(*(t[b] for t in inp)), pts[b], f)
                 for b in range(len(verts_cam))]
    entry = dict(mesh=name, meshes=len(verts_cam), faces=len(faces),
                 pixels=n_pix, max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                 library_ms=None, **k7_bounds(works))
    log(f"[3 K7 {name} x{len(verts_cam)}] {len(faces)} faces at {IMAGE}²: "
        f"bit-identical; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; bound "
        f"{entry['bound_ms']:.5f} ms ({entry['bound_by']}: "
        f"{entry['needed_pairs']:.0f} pixel centres in boxes), strip-cull "
        f"bound {entry['bound_strip_ms']:.4f} ms ({entry['bound_strip_by']}:"
        f" {entry['strip_pairs']:.0f} pairs); the kernel evaluates "
        f"{entry['kernel_pairs']} pairs")
    return entry


def k7_parity(torch, mods, bundle) -> dict:
    """256² sweeps of the lr0 mesh (timed), a sphere and the adversarial
    mesh: z and winner bit-identical to the plain twin. The batched
    launch of the service's reconstructions is added in phase 4."""
    from craniofacialsd_vae_tpu_torch.geometry import (adversarial_mesh,
                                                       uv_sphere)

    sphere_v, sphere_f = uv_sphere()
    adv_v, adv_f = adversarial_mesh(IMAGE, SEED)
    solo = k7_case(torch, mods, "lr0", camera_frame(bundle.lr_pos[0])[None],
                   bundle.lr_face[0], 50, 3)
    others = [k7_case(torch, mods, "sphere", camera_frame(sphere_v)[None],
                      sphere_f, 20, 1),
              k7_case(torch, mods, "adversarial", adv_v[None], adv_f, 20, 1,
                      check_cover=False)]
    return {"name": "raster_sweep", "solo": solo, "parity_only": others}


def summarize(name, source, replaces, shapes) -> dict:
    """One record per kernel: times and bounds summed over the shapes of
    one pass of the serving path (each shape runs once per pass). A shape
    may give its operations' bound in ``ops_ms`` (3xTF32 on the tensor
    cores); otherwise it is its flops at the fp32 rate. ``earlier_ms``:
    the design the kernel replaced, timed in the same run, where every
    shape has it."""
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
            "library_ms": total("library_ms"),
            "earlier_ms": total("earlier_ms") if all(
                "earlier_ms" in s for s in shapes) else None,
            "shapes": shapes}


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
    time by kernel name, the device's idle share of the wall time and the
    number of kernels the call ran."""
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
    # device work only: a user annotation (Optimizer.step's range) spans
    # kernels that are counted on their own
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    host = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU), key=lambda r: -r[1])
    return {"wall_ms": wall_ms, "device_ms": busy if rows else None,
            "idle_share": 1 - busy / wall_ms if rows else None,
            "kernels_run": sum(r[2] for r in rows),
            "by_kernel": [{"name": n[:80], "ms": t, "count": c}
                          for n, t, c in rows[:15]],
            "host_by_op": [{"name": n[:80], "ms": t, "count": c}
                           for n, t, c in host[:10]]}


def phase_serving(torch, mods, bundle, config) -> dict:
    """The port's main path on the card, then the same on the host."""
    from craniofacialsd_vae_tpu_torch.geometry import level0_positions
    from craniofacialsd_vae_tpu_torch.ops import selection_indices
    from craniofacialsd_vae_tpu_torch.serving import DiagnosisService
    from craniofacialsd_vae_tpu_torch.viz import (errors_to_colors,
                                                  render_batch)

    kernels = mods["kernels"]
    rng = np.random.default_rng(SEED)
    n = bundle.vertex_counts[0]
    # a head in the template's own frame, spread by a seeded per-vertex std
    mean = level0_positions(bundle)
    std = (0.01 + 0.02 * rng.random((n, 3))).astype(np.float32)
    norm = {"mean": mean, "std": std}
    scans = {b: (mean + std * rng.normal(size=(b, n, 3))).astype(np.float32)
             for b in REQUEST_SIZES}
    sel = selection_indices(bundle.down[0])
    faces = bundle.lr_face[0]

    t0 = time.perf_counter()
    svc = DiagnosisService.from_bundle(bundle, config, norm, TO_MM, seed=SEED,
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
    first_render_ms = (time.perf_counter() - t1) * 1e3
    errmap = render_batch(recon_lr0, faces, colors, image_size=IMAGE,
                          shadeless=True, device=DEVICE)
    render_ms = (time.perf_counter() - t1) * 1e3
    main_s = time.perf_counter() - t_main
    counts = kernels.launches.snapshot()
    log(f"[4 serve] service built in {setup_s:.2f} s; reconstruct ms by "
        f"batch {{{', '.join(f'{b}: {req_ms[b]:.1f}' for b in req_ms)}}}; "
        f"{2 * len(recon_lr0)} renders in {render_ms:.1f} ms (the first "
        f"call {first_render_ms:.1f} ms); launches "
        f"{counts}")

    for b, ans in answers.items():
        check(ans["vertices"].shape == (b, n, 3)
              and ans["vertex_errors_mm"].shape == (b, n)
              and ans["latent"].shape == (b, config.latent_size),
              f"reconstruct B={b}: shapes")
        for key, v in ans.items():
            check(np.isfinite(v).all(), f"reconstruct B={b}: {key} finite")
    # after the counted run, one launch at the shape of each counted one:
    # all of the service's lr0 reconstructions
    k7_batch = k7_case(torch, mods, "recon lr0", camera_frame(recon_lr0),
                       faces, 20, 1)
    for imgs in (shaded, errmap):
        check(imgs.shape == (len(recon_lr0), IMAGE, IMAGE, 3)
              and np.isfinite(imgs).all()
              and imgs.min() >= 0.0 and imgs.max() <= 1.0, "render range")
        cover = float((imgs.sum(-1) > 0).mean())
        check(0.05 < cover < 0.95, f"render covers {cover:.3f}")

    # the same service on the host (plain versions), same seed and scans
    cpu = DiagnosisService.from_bundle(bundle, config, norm, TO_MM, seed=SEED,
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
    # renders: card (unquantized) vs host; the default uint8 transfer vs
    # the card's floats
    shaded_f = render_batch(recon_lr0, faces, image_size=IMAGE,
                            quantize_transfer=False, device=DEVICE)
    px = np.abs(shaded_f[:2] - ref_imgs).max(-1)
    frac = float((px > 1e-3).mean())
    check(frac < 0.01, f"card vs host render: {frac:.4f} of pixels differ")
    q_err = float(np.abs(shaded - shaded_f).max())
    check(q_err <= 1 / 255 + 1e-6,
          f"uint8 render vs float render: {q_err:.3e} > 1/255")
    log(f"[4 serve] card vs host: max |diff| {worst}; renders differ at "
        f"{frac:.5f} of pixels (mean {float(px.mean()):.2e}); uint8 vs "
        f"float render max |diff| {q_err:.2e}")
    render_wall = {}
    for what, kw in (("shaded", {}),
                     ("error map", {"vertex_colors": colors,
                                    "shadeless": True})):
        render_batch(recon_lr0, faces, image_size=IMAGE, device=DEVICE, **kw)
        ts = []
        for _ in range(5):
            t1 = time.perf_counter()
            render_batch(recon_lr0, faces, image_size=IMAGE, device=DEVICE,
                         **kw)
            ts.append((time.perf_counter() - t1) * 1e3)
        render_wall[what] = sorted(ts)[len(ts) // 2]
    log(f"[4 render] warm render_batch of {len(recon_lr0)} at {IMAGE}², "
        "host-clock p50 of 5: " + ", ".join(
            f"{k} {v:.2f} ms" for k, v in render_wall.items()))

    # after the counted run: warm latency and where the device time goes
    latency = serve_latency(svc, scans)
    log("[4 serve] warm reconstruct p50 ms (meshes/s) by batch: " + ", ".join(
        f"{b}: {v['p50_ms']:.2f} ({v['meshes_per_s']:.0f})"
        for b, v in latency.items()))
    prof_req = device_profile(torch, lambda: svc.reconstruct(scans[BATCH]))
    prof_render = device_profile(torch, lambda: render_batch(
        recon_lr0[:BATCH], faces, image_size=IMAGE, device=DEVICE))
    for what, p in ((f"reconstruct B={BATCH}", prof_req),
                    (f"render_batch {BATCH} x {IMAGE}²", prof_render)):
        top = ", ".join(f"{k['name'][:40]} {k['ms']:.3f}"
                        for k in p["by_kernel"][:6])
        host = ", ".join(f"{k['name'][:30]} {k['ms']:.3f}"
                         for k in p["host_by_op"][:6])
        log(f"[4 profile] {what}: wall {p['wall_ms']:.2f} ms, device "
            f"{p['device_ms']} ms, idle share {p['idle_share']}; {top}; "
            f"host self time by op: {host}")
    return dict(counts=counts, request_ms=req_ms, render_ms=render_ms,
                inputs=dict(norm=norm, scans=scans, answers=answers),
                first_render_ms=first_render_ms,
                render_wall_ms=render_wall, render_uint8_err=q_err,
                k7_batch=k7_batch,
                latency=latency, profile_reconstruct=prof_req,
                profile_render=prof_render,
                renders=2 * len(recon_lr0), main_s=main_s, setup_s=setup_s,
                card_vs_host=worst, render_px_differ=frac,
                mean_error_mm={b: float(a["mean_error_mm"].mean())
                               for b, a in answers.items()})


# ----------------------------------------------------------------------
def training_geometry(bundle):
    """The hierarchy on the host with the stand-in Laplacian and regions
    (``template.ply``, their source, is not in the repo)."""
    from craniofacialsd_vae_tpu_torch.geometry import (level0_positions,
                                                       standin_laplacian_coo,
                                                       standin_region_masks)
    from craniofacialsd_vae_tpu_torch.models import SpiralGeometry

    return SpiralGeometry.from_bundle(
        bundle, device="cpu",
        laplacian=standin_laplacian_coo(bundle.spirals[0]),
        region_masks=standin_region_masks(level0_positions(bundle),
                                          N_REGIONS))


def k2_parity(torch, mods, model, geom, batch: int, ptxas: list) -> dict:
    """K2-dW at each conv's shape over a ``batch``-mesh grid, random x
    and dy: within K2_RTOL of the twin, two launches bit-equal, timed
    against the twin and the library form (``index_select`` of the L
    gathers, one ``einsum``), with its plan, both bounds (fp32 on the
    CUDA cores; 3xTF32 on the tensor cores, K1's form) and ptxas's
    registers and spills for the plan's instance."""
    kernels, ops = mods["kernels"], mods["ops"]
    regs = {k["kernel"]: k for k in ptxas}
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
    shapes = []
    for name, conv, op in model_convs(model, geom):
        seq, m = op.seq_length, op.num_vertices
        c_in, c_out = conv_widths(conv, op)
        x = torch.randn((op.n_src, batch, c_in), generator=gen, device=DEVICE)
        dy = torch.randn((m, batch, c_out), generator=gen, device=DEVICE)
        table = op.table
        plan = kernels.plan_spiral_conv_dw(m, batch, seq, c_in, c_out,
                                           x.data_ptr() % 16 == 0,
                                           dy.data_ptr() % 16 == 0)
        flat = table.t().reshape(-1)
        x2, d2 = x.view(op.n_src, -1), dy.view(-1, c_out)
        lib = lambda: torch.einsum(                      # noqa: E731
            "lnc,no->lco",
            x2.index_select(0, flat).view(seq, m * batch, c_in), d2)
        with torch.inference_mode():
            out = kernels.spiral_conv_dw(x, table, dy)
            again = kernels.spiral_conv_dw(x, table, dy)
            ref = ops.spiral_conv_dw_plain(x, table, dy)
            torch.cuda.synchronize()
            err = max_err(out, ref)
            scale = float(ref.abs().max())
            check(err <= K2_RTOL * scale,
                  f"K2-dW {name}: max |kernel - plain| {err:.3e} > "
                  f"{K2_RTOL} x {scale:.3e}")
            check(torch.equal(out, again), f"K2-dW {name}: launches differ")
            lib_err = max_err(lib(), ref)
            check(lib_err <= 1e-4 * scale,
                  f"K2-dW {name}: library form disagrees ({lib_err:.3e})")
            ms = cuda_ms(torch, lambda: kernels.spiral_conv_dw(x, table, dy),
                         20)
            plain_ms = cuda_ms(
                torch, lambda: ops.spiral_conv_dw_plain(x, table, dy), 5)
            lib_ms = cuda_ms(torch, lib, 5)
        nbytes = 4 * (x.numel() + dy.numel() + table.numel()
                      + seq * c_in * c_out)
        flops = 2.0 * seq * m * batch * c_in * c_out
        fp32_ms, fp32_by, t_bytes, _ = bound(nbytes, flops)
        t_ops = 3 * flops / PEAK_TF32 * 1e3
        b_ms, b_by = max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                           else "tf32x3")
        inst = regs.get(f"dw<{plan.mi},{plan.ni}>", {})
        log(f"[5 K2-dW {name}] {op.n_src}->{m} x{batch} {c_in}->{c_out} "
            f"(P {plan.positions}, {'x' if plan.x_on_m else 'dy'} on M, "
            f"{plan.fgm}x{plan.fgn} warps of {plan.mi}x{plan.ni} fragments "
            f"per position, {plan.tmv} vertices per tile, {plan.stages} "
            f"stages, {plan.n_chunks} chunks of {plan.tiles_per_chunk} "
            f"tiles, {plan.blocks} blocks, {plan.smem} B smem; "
            f"{inst.get('registers')} registers, "
            f"{inst.get('spill_bytes', 0)} B spilled): err {err:.2e} (max|dW| "
            f"{scale:.2e}); kernel {ms:.4f} ms, plain {plain_ms:.4f}, "
            f"library {lib_ms:.4f}, bound {b_ms:.4f} ({b_by}), fp32 bound "
            f"{fp32_ms:.4f} ({fp32_by}); kernel/library {ms / lib_ms:.2f}")
        shapes.append(dict(conv=name, batch=batch, n_src=op.n_src, m=m,
                           c_in=c_in, c_out=c_out,
                           plan=dataclasses.asdict(plan),
                           registers=inst.get("registers"),
                           spill_bytes=inst.get("spill_bytes", 0),
                           max_abs_err=err, rel_err=err / scale, ms=ms,
                           plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=b_ms, bound_by=b_by,
                           bound_fp32_ms=fp32_ms, bytes=nbytes, flops=flops,
                           ops_ms=t_ops))
        del x, dy, out, again, ref
    rec = summarize("spiral_conv_dw", "csrc/spiral_conv_dw.cu",
                    "craniofacialsd_vae_tpu/ops/spiral_conv.py:208", shapes)
    rec["bound_fp32_ms"] = sum(s["bound_fp32_ms"] for s in shapes)
    log(f"[5 K2-dW] per step: kernel {rec['ms']:.4f} ms, plain "
        f"{rec['plain_ms']:.4f}, library {rec['library_ms']:.4f}, bound "
        f"{rec['bound_ms']:.4f} ({rec['bound_by']}), fp32 bound "
        f"{rec['bound_fp32_ms']:.4f}; slower than the library at "
        f"{[s['conv'] for s in shapes if s['ms'] > s['library_ms']]}")
    return rec


def conv_kinds(model, geom) -> list:
    """``(name, conv, op, dtype, form)`` of every spiral conv of a forward
    pass: the dtype of its input under the model's policy, and its form,
    ``"out_gather"`` for a matmul-first final conv (bf16 input and
    ``final_out_gather``), else ``"gather"``."""
    import torch

    cfg = model.config
    out = []
    for name, conv, op in model_convs(model, geom):
        dtype = cfg.activation_dtype if name == "enc0" else cfg.deep_dtype
        form = ("out_gather" if name == "final" and cfg.final_out_gather
                and dtype == torch.bfloat16 else "gather")
        out.append((name, conv, op, dtype, form))
    return out


def transpose_tables(model, geom, batch: int, names) -> list:
    """``(name, matrix, source rows, D, dtype)`` of each K4 product that
    carries a cotangent back through the convs ``names`` (and through the
    up-pool before each decoder conv), in the order autograd reaches
    them, in the dtype of the rows they gather (a matmul-first final conv
    gathers its fp32 dy through every position's transpose in its own
    kernel, ``out_gather_sum_bwd``, and adds no table here)."""
    tables = []
    for name, conv, op, dtype, form in reversed(conv_kinds(model, geom)):
        if name not in names:
            continue
        c_in, c_out = conv_widths(conv, op)
        if form != "out_gather":
            for table, cols in zip(op.inv_tables, op.group_cols):
                tables.append((f"{name} T", table,
                               len(cols) * op.num_vertices, batch * c_in,
                               dtype))
        if name.startswith("dec"):
            level = int(name[3:])
            up = geom.up[level]
            tables.append((f"up{level} T", up.transpose, up.shape[0],
                           batch * c_in, model.config.deep_dtype))
    return tables


def step_tables(model, geom, batch: int) -> list:
    """``(name, matrix, source rows, D, dtype)`` of each K4 product a step
    makes besides the up-pools' forward: the Laplacian (fp32), then the
    backward's transposes (``transpose_tables``; the first encoder conv
    reads the data and computes no dx)."""
    import torch

    f32 = torch.float32
    nv = geom.num_vertices
    names = [k[0] for k in conv_kinds(model, geom) if k[0] != "enc0"]
    return [("lap", geom.laplacian, nv, 3 * batch, f32),
            ("lap T", geom.laplacian.transpose, nv, 3 * batch, f32),
            *transpose_tables(model, geom, batch, names)]


def backward_tables(model, geom, batch: int) -> list:
    """``(name, matrix, source rows, D)`` of ``step_tables``."""
    return [t[:4] for t in step_tables(model, geom, batch)]


def tiers_of(mat) -> tuple:
    """A table's overflow tiers (a forward table has none)."""
    return getattr(mat, "tiers", ())


def coo_of(torch, mat, n_src: int):
    """The whole table, main part and tiers, as one coalesced COO matrix:
    the library call's operand."""
    m, k = mat.cols.shape
    rows = [torch.arange(m, device=DEVICE).repeat_interleave(k)]
    cols, vals = [mat.cols.reshape(-1)], [mat.vals.reshape(-1)]
    for t_rows, t_cols, t_vals in tiers_of(mat):
        rows.append(t_rows.long().repeat_interleave(t_cols.shape[1]))
        cols.append(t_cols.reshape(-1))
        vals.append(t_vals.reshape(-1))
    idx = torch.stack([torch.cat(rows), torch.cat(cols).long()])
    return torch.sparse_coo_tensor(idx, torch.cat(vals), (m, n_src),
                                   check_invariants=True).coalesce()


def k4_table_shape(torch, mods, gen, name, mat, n_src, d) -> dict:
    """One fp32 backward table: with tiers through the fused launch
    (``ell_matmul_capped``), without through K4, bit-equal to the
    sequential twin (K4's twin, then one ``index_add`` per tier) and timed
    against the twin, the library call (``torch.sparse.mm`` of the whole
    table) and, for the fused launch, K4 alone on the main table and K4
    followed by the tiers' twin."""
    kernels, sparse = mods["kernels"], mods["sparse"]
    m, k = mat.cols.shape
    ties = tiers_of(mat)
    x2 = torch.randn((n_src, d), generator=gen, device=DEVICE)
    sp = coo_of(torch, mat, n_src)

    def plain():
        out = sparse.ell_matmul_plain(mat.cols, mat.vals, x2)
        for rows, cols, vals in ties:
            sparse.ell_tier_add_plain(rows, cols, vals, x2, out)
        return out

    def k4_then_twin():
        out = kernels.ell_matmul_fwd(mat.cols, mat.vals, x2)
        for rows, cols, vals in ties:
            sparse.ell_tier_add_plain(rows, cols, vals, x2, out)
        return out

    if ties:
        launch = lambda: kernels.ell_matmul_capped(     # noqa: E731
            mat.cols, mat.vals, ties, mat.links, x2)
    else:
        launch = lambda: kernels.ell_matmul_fwd(        # noqa: E731
            mat.cols, mat.vals, x2)
    with torch.inference_mode():
        out = launch()
        ref = plain()
        torch.cuda.synchronize()
        check(torch.equal(out, ref), f"K4 {name}: kernel and twin "
              f"differ at {int((out != ref).sum())} values")
        if ties:
            check(torch.equal(mat.apply(x2), ref),
                  f"CappedEll.apply {name}: card and twin differ")
        scale = float(ref.abs().max())
        lib = lambda: torch.sparse.mm(sp, x2)            # noqa: E731
        check(max_err(lib(), ref) <= 1e-5 * scale,
              f"K4 {name}: library form disagrees")
        ms = cuda_ms(torch, launch, 20)
        plain_ms = cuda_ms(torch, plain, 5)
        lib_ms = cuda_ms(torch, lib, 5)
        if ties:
            main_ms = cuda_ms(torch, lambda: kernels.ell_matmul_fwd(
                mat.cols, mat.vals, x2), 20)
            seq_ms = cuda_ms(torch, k4_then_twin, 5)
    src = torch.cat([mat.cols.reshape(-1)]
                    + [c.reshape(-1) for _, c, _ in ties])
    t_entries = sum(c.numel() for _, c, _ in ties)
    t_rows = sum(r.numel() for r, _, _ in ties)
    nbytes = 4 * (int(torch.unique(src).numel()) * d + 2 * m * k
                  + 2 * t_entries + (m + t_rows if ties else 0) + m * d)
    flops = 2.0 * (m * k + t_entries) * d + t_rows * d
    b_ms, b_by, _, _ = bound(nbytes, flops)
    entry = dict(table=name, kernel="ell_matmul_capped" if ties
                 else "ell_matmul_fwd", n_src=n_src, m=m, k=k, d=d,
                 tiers=len(ties), tier_rows=[int(r.numel())
                                             for r, _, _ in ties],
                 max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                 library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                 bytes=nbytes, flops=flops)
    if ties:
        entry.update(main_ms=main_ms, k4_then_twin_ms=seq_ms)
        log(f"[K4 capped {name}] {n_src}->{m} K={k} D={d}, tiers "
            f"{entry['tier_rows']} rows K "
            f"{[int(c.shape[1]) for _, c, _ in ties]}: bit-equal; fused "
            f"{ms:.4f} ms (K4 alone {main_ms:.4f}, K4 + tiers' twin "
            f"{seq_ms:.4f}), plain {plain_ms:.4f}, library {lib_ms:.4f}, "
            f"bound {b_ms:.5f} ({b_by})")
    else:
        log(f"[K4 {name}] {n_src}->{m} K={k} D={d}: bit-equal; kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f}, library {lib_ms:.4f}, "
            f"bound {b_ms:.4f} ({b_by})")
    return entry


def k4_backward_parity(torch, mods, model, geom, batch: int) -> tuple:
    """Every table of ``backward_tables`` through ``k4_table_shape``:
    returns the entries of the tables without tiers and the fused
    launch's record over the tables with tiers."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 4)
    mains, fused = [], []
    for name, mat, n_src, d in backward_tables(model, geom, batch):
        entry = k4_table_shape(torch, mods, gen, name, mat, n_src, d)
        (fused if entry["tiers"] else mains).append(entry)
    rec = summarize("ell_matmul_capped", *KERNEL_SOURCES["ell_matmul_capped"],
                    fused)
    rec["main_ms"] = sum(e["main_ms"] for e in fused)
    rec["k4_then_twin_ms"] = sum(e["k4_then_twin_ms"] for e in fused)
    log(f"[5 K4 capped] per step: {len(fused)} tables, "
        f"{sum(e['tiers'] for e in fused)} tiers, fused {rec['ms']:.4f} ms "
        f"(K4 alone on the main tables {rec['main_ms']:.4f}: the tiers add "
        f"{rec['ms'] - rec['main_ms']:.4f}), K4 + tiers' twin "
        f"{rec['k4_then_twin_ms']:.4f}, plain {rec['plain_ms']:.4f}, library "
        f"{rec['library_ms']:.4f}, bound {rec['bound_ms']:.4f}; K4 on "
        f"{[e['table'] for e in mains]}")
    return mains, rec


def conv_kernel(name, conv, op, dtype, form) -> str:
    """The kernel a conv of ``conv_kinds`` launches in its forward: K3b
    for a matmul-first final conv, K1-bf16 (K3a for the final conv) on
    bf16 input, else K1's narrow kernel below 8 outputs or its
    tensor-core kernel."""
    import torch

    if form == "out_gather":
        return "out_gather_sum"
    if dtype == torch.bfloat16:
        return "spiral_conv_f32out" if name == "final" else "spiral_conv_bf16"
    return ("spiral_conv_narrow" if conv_widths(conv, op)[1] < 8
            else "spiral_conv_tc")


def expected_step_launches(model, geom, batch: int) -> dict:
    """Launches of one training step under the model's policy: per conv,
    K1 and K2-dW in its input's dtype (K1-bf16 with K2-dW-bf16, K3a for a
    gather-first bf16 final conv; a matmul-first final conv launches K3b
    and its backward ``out_gather_sum_bwd`` once each and gets its dW
    from a plain product); K4 in the deep dtype per
    up-pool; per table of ``step_tables`` in its dtype, K4 where it has
    no tiers and the fused K4 where it has."""
    import torch

    from craniofacialsd_vae_tpu_torch import kernels

    counts = dict.fromkeys(kernels.KERNEL_NAMES, 0)
    for name, conv, op, dtype, form in conv_kinds(model, geom):
        counts[conv_kernel(name, conv, op, dtype, form)] += 1
        if form == "out_gather":
            counts["out_gather_sum_bwd"] += 1
        else:
            counts["spiral_conv_dw_bf16" if dtype == torch.bfloat16
                   else "spiral_conv_dw"] += 1
    bf = "_bf16" if model.config.deep_dtype == torch.bfloat16 else ""
    counts["ell_matmul" + (bf or "_fwd")] += len(geom.up)
    for _, mat, _, _, dtype in step_tables(model, geom, batch):
        kind = "ell_matmul_capped" if tiers_of(mat) else "ell_matmul"
        counts[kind + ("_bf16" if dtype == torch.bfloat16
                       else "" if tiers_of(mat) else "_fwd")] += 1
    return counts


def training_inputs(torch, bundle, config) -> tuple:
    """``(data [4·B, N, 3], region, eps [B², Z])`` of the training
    phases: scans drawn as the serving phase draws them, normalised by
    the same per-vertex statistics as a dataset would be, and the swapped
    region and the noise from a seeded host generator."""
    from craniofacialsd_vae_tpu_torch.geometry import level0_positions

    b = TRAIN_CONFIG["batch_size"]
    rng = np.random.default_rng(SEED + 5)
    n = bundle.vertex_counts[0]
    mean = level0_positions(bundle)
    std = (0.01 + 0.02 * rng.random((n, 3))).astype(np.float32)
    scans = mean + std * rng.normal(size=(4 * b, n, 3))
    data = ((scans - mean) / std).astype(np.float32)
    gen_h = torch.Generator().manual_seed(SEED + 6)
    region = int(torch.randint(0, N_REGIONS, (), generator=gen_h))
    eps = torch.randn((b * b, config.latent_size), generator=gen_h)
    return data, region, eps


def phase_training(torch, mods, bundle, config, ptxas: list) -> dict:
    """The training step on the card at full width, then on the host."""
    from craniofacialsd_vae_tpu_torch.models import init_sdvae
    from craniofacialsd_vae_tpu_torch.training import (LOSS_KEYS,
                                                       LossWeights,
                                                       coupled_adam,
                                                       make_train_step)

    kernels = mods["kernels"]
    b = TRAIN_CONFIG["batch_size"]
    grid = b * b
    weights = LossWeights.from_config(TRAIN_CONFIG)
    t0 = time.perf_counter()
    geom_h = training_geometry(bundle)
    geom = geom_h.to(DEVICE)
    model = init_sdvae(config, geom, torch.Generator().manual_seed(SEED))
    setup_s = time.perf_counter() - t0
    n_tiers = {name: len(tiers_of(mat))
               for name, mat, _, _ in backward_tables(model, geom, grid)}
    log(f"[5 train] geometry and model in {setup_s:.2f} s; stand-in "
        f"Laplacian {int(geom.laplacian.cols.numel())} entries (K "
        f"{geom.laplacian.cols.shape[1]}), {N_REGIONS} stand-in regions; "
        f"tiers per backward table {n_tiers}")
    k2 = k2_parity(torch, mods, model, geom, grid, ptxas)
    k4_main, capped = k4_backward_parity(torch, mods, model, geom, grid)
    torch.cuda.empty_cache()

    data, region, eps = training_inputs(torch, bundle, config)
    n_scans = len(data)
    lr, wd = TRAIN_CONFIG["lr"], TRAIN_CONFIG["weight_decay"]
    step = make_train_step(model, weights,
                           coupled_adam(model.parameters(), lr, wd), b)

    # the main path: counts from 0, one step, counts read
    x = torch.as_tensor(data[:b], device=DEVICE)
    kernels.launches.reset()
    t1 = time.perf_counter()
    m_card = step(x, region_idx=region, eps=eps.to(DEVICE))
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t1) * 1e3
    counts = kernels.launches.snapshot()
    want = expected_step_launches(model, geom, grid)
    check(counts == want, f"step launches {counts}, expected {want}")
    grads = {k: p.grad for k, p in model.named_parameters()}
    for k, g in grads.items():
        check(g is not None and bool(torch.isfinite(g).all()),
              f"card step: no finite gradient for {k}")

    # the same step on the host: same weights, scans, region and noise
    model_h = init_sdvae(config, geom_h, torch.Generator().manual_seed(SEED))
    step_h = make_train_step(model_h, weights,
                             coupled_adam(model_h.parameters(), lr, wd), b)
    t1 = time.perf_counter()
    m_host = step_h(torch.from_numpy(data[:b]), region_idx=region, eps=eps)
    host_ms = (time.perf_counter() - t1) * 1e3
    loss_err = {}
    for k in LOSS_KEYS:
        got, ref = float(m_card[k]), float(m_host[k])
        check(np.isfinite(got), f"card step: {k} is not finite")
        check(abs(got - ref) <= TRAIN_RTOL * abs(ref),
              f"step {k}: card {got!r} vs host {ref!r}")
        loss_err[k] = abs(got - ref) / abs(ref) if ref else abs(got)
    grad_err = {}
    for k, p in model_h.named_parameters():
        ref = p.grad
        err = float((grads[k].cpu() - ref).abs().max())
        scale = float(ref.abs().max())
        check(err <= TRAIN_RTOL * scale,
              f"gradient {k}: card vs host {err:.3e} > {TRAIN_RTOL} x "
              f"{scale:.3e}")
        grad_err[k] = err / scale
    losses = ", ".join(f"{k}: {float(m_card[k]):.6g}" for k in LOSS_KEYS)
    log(f"[5 train] counted step {first_ms:.1f} ms (cold), launches "
        f"{counts}; losses {{{losses}}}; "
        f"card vs host: worst loss rel {max(loss_err.values()):.2e}, worst "
        f"gradient rel {max(grad_err.values()):.2e} "
        f"({max(grad_err, key=grad_err.get)}); host step {host_ms:.0f} ms")
    del model_h, step_h, geom_h

    # warm steps with the region and noise from a generator on the card
    data_dev = torch.as_tensor(data, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 7)
    idx = torch.randint(0, n_scans, (WARM_STEPS + 2, b), generator=gen,
                        device=DEVICE)
    step(data_dev.index_select(0, idx[0]), generator=gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, tots = [], []
    for t in range(WARM_STEPS):
        t1 = time.perf_counter()
        m = step(data_dev.index_select(0, idx[t + 1]), generator=gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
        tots.append(m)
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    traj = {k: [float(m[k]) for m in tots] for k in LOSS_KEYS}
    for k, v in traj.items():
        check(all(np.isfinite(v)), f"warm steps: {k} not finite: {v}")
    p50 = sorted(times)[len(times) // 2]
    prof = device_profile(torch, lambda: step(
        data_dev.index_select(0, idx[-1]), generator=gen))
    top = ", ".join(f"{k['name'][:40]} {k['ms']:.3f} ({k['count']})"
                    for k in prof["by_kernel"][:8])
    log(f"[5 train] {WARM_STEPS} warm steps: p50 {p50:.2f} ms (min "
        f"{min(times):.2f}, max {max(times):.2f}): {b / p50 * 1e3:.1f} "
        f"scans/s, {grid / p50 * 1e3:.1f} swap-grid meshes/s; peak "
        f"{peak_mb:.0f} MiB; tot {['%.5g' % v for v in traj['tot']]}")
    log(f"[5 profile] train step: wall {prof['wall_ms']:.2f} ms, device "
        f"{prof['device_ms']} ms, idle share {prof['idle_share']}; {top}")
    return dict(counts=counts, k2=k2, k4_backward=k4_main, capped=capped,
                first_step_ms=first_ms, host_step_ms=host_ms,
                loss_rel_err=loss_err, grad_rel_err=grad_err,
                step_ms=times, step_p50_ms=p50, scans_per_s=b / p50 * 1e3,
                meshes_per_s=grid / p50 * 1e3, peak_mib=peak_mb,
                trajectory=traj, profile=prof, setup_s=setup_s,
                tiers=n_tiers)


def training_records(serving: list, train: dict) -> list:
    """One record per kernel of the training step, each timed over the
    shapes of that step's own launches: K1 and the up-pools' forward at
    the serving path's B = 16 pass (the swap grid has 16 meshes, so the
    shapes are the same), K4 at the up-pools and the backward tables
    without tiers, K2-dW, the fused K4 at the tables with tiers."""
    grid = TRAIN_CONFIG["batch_size"] ** 2
    check(grid == BATCH, f"the swap grid ({grid}) is not the B = {BATCH} "
          "pass whose K1 and K4 times the training records reuse")
    by_name = {r["name"]: r for r in serving}
    k1 = [dict(by_name[n]) for n in ("spiral_conv_tc", "spiral_conv_narrow")]
    k4 = summarize("ell_matmul_fwd", "csrc/ell_matmul.cu",
                   "craniofacialsd_vae_tpu/ops/sparse.py:222",
                   by_name["ell_matmul_fwd"]["shapes"]
                   + train["k4_backward"])
    return [*k1, k4, train["k2"], train["capped"]]


# ----------------------------------------------------------------------
def entry_workspace(root: str) -> str:
    """Phase 7's inputs under ``root``: the coloured octasphere template
    PLY, ``ENTRY_PER_CLASS`` OBJ scans of each class (a smooth per-class
    bump along the normal, a per-scan scale and per-vertex noise) and the
    text of ``configurations/smoke.yaml`` pointed at them. Returns the
    config's path."""
    from craniofacialsd_vae_tpu_torch.geometry import (synthetic_template,
                                                       write_obj, write_ply)

    tpl = synthetic_template(ENTRY_SUBDIVISIONS, ENTRY_REGIONS)
    tpl_path = os.path.join(root, "template.ply")
    write_ply(tpl_path, tpl.pos, tpl.face, tpl.colors)
    meshes = os.path.join(root, "meshes")
    os.makedirs(meshes)
    rng = np.random.default_rng(SEED + 8)
    for c in ENTRY_CLASSES:
        freq = 2.0 * rng.normal(size=3)
        bump = 0.05 * np.sin(tpl.pos @ freq + rng.uniform(0, 2 * np.pi))
        for i in range(ENTRY_PER_CLASS):
            scale = 1.0 + 0.02 * rng.normal()
            verts = tpl.pos * (scale + bump[:, None]) \
                + rng.normal(scale=0.002, size=tpl.pos.shape)
            write_obj(os.path.join(meshes, f"{c}_{i}.obj"), verts)
    with open(os.path.join(ROOT, "configurations", "smoke.yaml")) as f:
        text = f.read()
    subs = {"template_path": tpl_path, "dataset_path": meshes,
            "precomputed_path": os.path.join(root, "precomputed"),
            "epochs": ENTRY_EPOCHS[0], "tb_renderings": ENTRY_CADENCE,
            "save_weights": ENTRY_CADENCE}
    for key, value in subs.items():
        text, n = re.subn(rf"^(\s*{key}:)[^\n#]*",
                          lambda m, v=value: f"{m.group(1)} {v} ", text,
                          flags=re.M)
        check(n == 1, f"smoke.yaml has {n} '{key}:' lines, expected 1")
    path = os.path.join(root, "entry.yaml")
    with open(path, "w") as f:
        f.write(text)
    return path


def state_matches_files(manager, model_file: dict, opt_file: dict,
                        what: str) -> None:
    """The manager's parameters and Adam states equal a checkpoint's files
    (read by the port's codec) bit for bit."""
    from craniofacialsd_vae_tpu_torch.training.checkpoint import \
        named_from_tree

    trees = manager.state_trees()
    for key, stored in (("params", model_file), ("clf_params", model_file),
                        ("opt_state", opt_file), ("clf_opt_state", opt_file)):
        got = named_from_tree(trees[key])
        want = named_from_tree(stored[key])
        check(set(got) == set(want), f"{what} {key}: names differ")
        for name, v in want.items():
            check(np.array_equal(np.asarray(got[name]), np.asarray(v)),
                  f"{what} {key} {name}: differs from the checkpoint")


def entry_card_vs_host(torch, config: dict, ckpt: str, train_set) -> dict:
    """One ``run_epoch`` on the card against the same epoch on the host:
    both managers resumed from the same checkpoint (same weights and Adam
    moments), the same batch order, and the same per-step region and
    noise (drawn from the seed and the step id)."""
    from craniofacialsd_vae_tpu_torch.data.dataset import (
        BatchIterator, DeviceBatchIterator)
    from craniofacialsd_vae_tpu_torch.manager import ModelManager
    from craniofacialsd_vae_tpu_torch.training import LOSS_KEYS

    b = config["optimization"]["batch_size"]
    out = {}
    for dev in (DEVICE, "cpu"):
        mgr = ModelManager(config, config["data"]["precomputed_path"],
                           device=dev)
        epoch = mgr.resume(ckpt)
        it = (DeviceBatchIterator(train_set, b, seed=SEED + 9, device=dev)
              if dev != "cpu" else BatchIterator(train_set, b, seed=SEED + 9))
        t0 = time.perf_counter()
        losses = dict(mgr.run_epoch(it, train=True))
        out[dev] = (mgr, losses, time.perf_counter() - t0, epoch)
    card, card_losses, card_s, _ = out[DEVICE]
    host, host_losses, host_s, epoch = out["cpu"]
    loss_err = {}
    for k in LOSS_KEYS:
        got, ref = card_losses[k], host_losses[k]
        check(np.isfinite(got), f"entry card epoch: {k} is not finite")
        loss_err[k] = abs(got - ref) / abs(ref) if ref else abs(got)
    param_err = {}
    ref_sd = host.model.state_dict()
    for name, p in card.model.state_dict().items():
        ref = ref_sd[name]
        param_err[name] = float((p.cpu() - ref).abs().max()) \
            / max(float(ref.abs().max()), 1e-30)
    log(f"[7 entry] card vs host epoch {epoch + 1} ({len(it)} steps; card "
        f"{card_s:.2f} s, host {host_s:.2f} s): worst loss rel "
        f"{max(loss_err.values()):.2e} ({max(loss_err, key=loss_err.get)}), "
        f"worst parameter rel {max(param_err.values()):.2e} "
        f"({max(param_err, key=param_err.get)})")
    for k, e in loss_err.items():
        check(e <= TRAIN_RTOL, f"entry epoch {k}: card "
              f"{card_losses[k]!r} vs host {host_losses[k]!r}")
    for name, e in param_err.items():
        check(e <= TRAIN_RTOL, f"entry epoch parameter {name}: card vs "
              f"host {e:.3e} of its max")
    return dict(card=card, loss_rel_err=loss_err, param_rel_err=param_err,
                card_epoch_s=card_s, host_epoch_s=host_s)


def entry_records(torch, mods, card, k7: dict, grid: int,
                  ptxas: list) -> list:
    """The kernels of the entry path at its own shapes (the octasphere
    hierarchy, the smoke model, the 16-mesh swap grid): K1 at every conv,
    K4 at the up-pools and the backward tables without tiers, K2-dW, the
    fused K4 and K7 at full resolution, each against its twin."""
    kernels, ops = mods["kernels"], mods["ops"]
    model, geom, bundle = card.model, card.geometry, card.bundle
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 10)
    k1 = [k1_shape(torch, kernels, ops, gen, name, conv, op, grid)
          for name, conv, op in model_convs(model, geom)]
    n = len(model.de_convs)
    ups = []
    for j in range(n):
        level = n - 1 - j
        c = model.de_convs[j].w.shape[0] // geom.spirals[level].seq_length
        ups.append(k4_shape(torch, kernels, ops, gen, geom.up[level],
                            bundle.up[level], level, grid * c, grid))
    k2 = k2_parity(torch, mods, model, geom, grid, ptxas)
    k4_main, capped = k4_backward_parity(torch, mods, model, geom, grid)
    recs = [summarize(kernel, "csrc/spiral_conv.cu",
                      "craniofacialsd_vae_tpu/ops/spiral_conv.py:159",
                      [s for s in k1 if s["kernel"] == kernel])
            for kernel in ("spiral_conv_tc", "spiral_conv_narrow")]
    recs.append(summarize("ell_matmul_fwd", "csrc/ell_matmul.cu",
                          "craniofacialsd_vae_tpu/ops/sparse.py:222",
                          ups + k4_main))
    recs += [k2, capped,
             summarize("raster_sweep", "csrc/raster_sweep.cu",
                       "craniofacialsd_vae_tpu/viz/raster_pallas.py:111",
                       [k7])]
    return recs


def phase_train_entry(torch, mods, ptxas: list, lr0_k7: dict,
                      root: str) -> dict:
    """The port's training entry point end to end, on the card, from a
    template written under ``root``: ``train.main`` trains
    ``ENTRY_EPOCHS[0]`` epochs (renders and checkpoints on the cadence),
    a fresh manager resumes the last checkpoint bit for bit, ``main
    --resume`` goes on to ``ENTRY_EPOCHS[1]``; then (not counted) one
    epoch on the card against the host, K7 on a full-resolution
    reconstruction against its twin, and every kernel of the path at its
    shapes. The workspace and its caches stay for phase 8."""
    from craniofacialsd_vae_tpu_torch import train as entry
    from craniofacialsd_vae_tpu_torch.data.dataset import build_datasets
    from craniofacialsd_vae_tpu_torch.manager import ModelManager
    from craniofacialsd_vae_tpu_torch.training.checkpoint import \
        read_checkpoint
    from craniofacialsd_vae_tpu_torch.utils import get_config

    kernels = mods["kernels"]
    t0 = time.perf_counter()
    cfg_path = entry_workspace(root)
    inputs_s = time.perf_counter() - t0
    config = get_config(cfg_path)
    grid = config["optimization"]["batch_size"] ** 2
    argv = ["--config", cfg_path, "--id", "entry", "--output_path", root,
            "--device", DEVICE]

    # the main path: counts from 0, train, resume, train on; counts read
    kernels.launches.reset()
    t1 = time.perf_counter()
    first = entry.main(argv)
    first_s = time.perf_counter() - t1
    run, ckpt = first["output_dir"], first["checkpoint_dir"]
    saved = [f"model_{e:08d}.ckpt"
             for e in range(ENTRY_CADENCE, ENTRY_EPOCHS[0] + 1,
                            ENTRY_CADENCE)]
    check(sorted(os.listdir(ckpt))
          == ["classifiers.npz"] + saved + ["optimizer.ckpt"],
          f"run dir checkpoints {sorted(os.listdir(ckpt))}")
    for rel in ("config.yaml", os.path.join("logs", "metrics.jsonl"),
                "z_stats.npz"):
        check(os.path.isfile(os.path.join(run, rel)), f"no {rel}")
    model_file = read_checkpoint(os.path.join(ckpt, saved[-1]))
    opt_file = read_checkpoint(os.path.join(ckpt, "optimizer.ckpt"))
    check(int(opt_file["epoch"]) == ENTRY_EPOCHS[0],
          f"optimizer.ckpt epoch {opt_file['epoch']}")
    state_matches_files(first["manager"], model_file, opt_file,
                        "trained manager")
    t1 = time.perf_counter()
    resumed = ModelManager(config, config["data"]["precomputed_path"],
                           device=DEVICE)
    check(resumed.resume(ckpt) == ENTRY_EPOCHS[0], "resume epoch")
    resume_s = time.perf_counter() - t1
    state_matches_files(resumed, model_file, opt_file, "resumed manager")
    del resumed, first["manager"]

    t1 = time.perf_counter()
    second = entry.main(argv + ["--resume", "--epochs",
                                str(ENTRY_EPOCHS[1])])
    second_s = time.perf_counter() - t1
    torch.cuda.synchronize()
    counts = kernels.launches.snapshot()
    check(second["start_epoch"] == ENTRY_EPOCHS[0],
          f"--resume started at epoch {second['start_epoch']}")
    check(f"model_{ENTRY_EPOCHS[1]:08d}.ckpt" in os.listdir(ckpt),
          "no checkpoint of the resumed run's last epoch")
    hist = first["history"] + second["history"]
    check([h["epoch"] for h in hist]
          == list(range(1, ENTRY_EPOCHS[1] + 1)), "epochs run")
    for h in hist:
        for phase in ("train", "validation"):
            check(all(np.isfinite(v) for v in h[phase].values()),
                  f"epoch {h['epoch']} {phase} losses {h[phase]}")
    tots = [h["train"]["tot"] for h in hist]
    check(tots[-1] < tots[0], f"train tot did not fall: {tots}")
    for kernel in ("spiral_conv_tc", "spiral_conv_narrow",
                   "ell_matmul_fwd", "ell_matmul_capped",
                   "spiral_conv_dw", "raster_sweep"):
        check(counts[kernel] > 0,
              f"{kernel} was not launched on the train entry path")
    del second["manager"]
    torch.cuda.empty_cache()

    # after the counted run: card vs host, K7 at full resolution, the
    # kernels at this path's shapes
    train_set, val_set, _, norm, _ = build_datasets(config)
    cvh = entry_card_vs_host(torch, config, ckpt, train_set)
    card = cvh.pop("card")
    x = train_set.x[:1]
    recon = card.forward(x)[0].cpu().numpy() * norm["std"] + norm["mean"]
    faces = card.template.face
    k7 = k7_case(torch, mods, "full-res recon", camera_frame(recon),
                 faces, 20, 1)
    records = entry_records(torch, mods, card, k7, grid, ptxas)
    for rec in records:
        rec["path"] = "train_entry"
        rec["launches"] = counts[rec["name"]]
    epoch_s = sorted(h["train_s"] for h in hist)
    p50 = epoch_s[len(epoch_s) // 2]
    steps = hist[0]["steps"]
    line = {
        "phase": "train_entry",
        "template": {"vertices": int(card.template.num_vertices),
                     "faces": int(len(faces)),
                     "regions": len(card.template.region_names)},
        "scans": {"train": len(train_set), "validation": len(val_set)},
        "epochs": ENTRY_EPOCHS[1], "inputs_s": inputs_s,
        "geometry_build_s": first["geometry_s"],
        "dataset_load_s": first["data_s"], "first_run_s": first_s,
        "resume_s": resume_s, "second_run_s": second_s,
        "epoch_p50_s": p50, "epoch_train_s": [h["train_s"] for h in hist],
        "steps_per_epoch": steps, "steps_per_s": steps / p50,
        "meshes_per_s": steps * grid / p50,
        "train_tot": tots,
        "card_vs_host": {"worst_loss_rel": max(
            cvh["loss_rel_err"].values()),
            "worst_param_rel": max(cvh["param_rel_err"].values()),
            "card_epoch_s": cvh["card_epoch_s"],
            "host_epoch_s": cvh["host_epoch_s"]},
        "k7_full_res_ms": k7["ms"], "k7_lr0_ms": lr0_k7["ms"],
        "zoo": {"fit_s": [first["classifiers_s"], second["classifiers_s"]],
                "validation_accuracy": second["classifier_accs"]},
        "launches": counts}
    log(json.dumps(line))
    return dict(line=line, records=records, card_vs_host=cvh, k7=k7,
                history=hist, cfg_path=cfg_path, run_dir=run)


# ----------------------------------------------------------------------
# phase 8: the flagship configurations' `mixed` policy
def ulps(torch, got, want) -> float:
    """The largest difference of two bf16 arrays in bf16 ulps of the
    larger magnitude (8 significant bits), the ulp taken at no less than
    BF16_FLOOR_RTOL of the array's max: where an fp32 sum cancels to
    nearly 0, its bf16 ulp is finer than the sum's own fp32 rounding,
    which differs with the order of the sum."""
    got, want = got.float(), want.float()
    if not got.numel():
        return 0.0
    mag = torch.maximum(got.abs(), want.abs()).clamp(min=2.0 ** -120)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7).clamp(
        min=BF16_FLOOR_RTOL * float(want.abs().max()))
    return float(((got - want).abs() / ulp).max())


def bound_bf16(nbytes: float, flops: float) -> tuple:
    """The bound of a tensor-core kernel in bf16: bytes at the memory rate
    or bf16 operations at the dense bf16 rate."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_BF16 * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), t_ops


def flagship_config():
    """``configurations/craniofacial.yaml`` through the port's config
    reader: its model section (checked equal to ``MODEL_CONFIG`` apart
    from the policy) and its optimisation section (``TRAIN_CONFIG``'s
    keys)."""
    from craniofacialsd_vae_tpu_torch.models import SDVAEConfig
    from craniofacialsd_vae_tpu_torch.utils import get_config

    cfg = get_config(os.path.join(ROOT, "configurations", FLAGSHIP))
    model, opt = cfg["model"], cfg["optimization"]
    check(model["compute_dtype"] == "mixed",
          f"{FLAGSHIP}: compute_dtype {model['compute_dtype']!r}")
    for k, v in MODEL_CONFIG.items():
        check(model[k] == v, f"{FLAGSHIP} model.{k} {model[k]!r} != {v!r}")
    for k, v in TRAIN_CONFIG.items():
        check(float(opt[k]) == float(v),
              f"{FLAGSHIP} optimization.{k} {opt[k]!r} != {v!r}")
    return SDVAEConfig.from_dict(model, opt["kl_weight"])


def mixed_k1_shape(torch, kernels, ops, gen, name, conv, op, batch,
                   f32out=False) -> dict:
    """One bf16 conv at one batch size, on bf16 x and the model's weights
    rounded to bf16: K1-bf16 within one bf16 ulp of its twin (K3a, the
    fp32 output through the op's vertex tiles, within K3A_RTOL of the
    max, and timed beside the untiled kernel it replaced, within
    K3A_RTOL too), two launches bit-equal, timed against the twin and the
    library form (``index_select`` and one bf16 ``linear``)."""
    bf16 = torch.bfloat16
    seq, m = op.seq_length, op.num_vertices
    c_in, c_out = conv_widths(conv, op)
    x = torch.randn((op.n_src, batch, c_in), generator=gen,
                    device=DEVICE).to(bf16)
    w_l = conv.w.detach().reshape(seq, c_in, c_out).to(bf16).contiguous()
    b = (0.1 * torch.randn(c_out, generator=gen, device=DEVICE)).to(bf16)
    table = op.table
    out_dtype = torch.float32 if f32out else None
    kernel = "spiral_conv_f32out" if f32out else "spiral_conv_bf16"
    tiles = op.tiles if f32out else None
    plan = kernels.plan_spiral_conv(m, batch, seq, c_in, c_out,
                                    x.data_ptr() % 4 == 0, True, bf16,
                                    tiles.n_tiles if tiles else 0,
                                    tiles.max_rows if tiles else 0)
    launch = lambda: kernels.spiral_conv_fwd(            # noqa: E731
        x, table, w_l, b, out_dtype=out_dtype, tiles=tiles)
    untiled = lambda: kernels.spiral_conv_fwd(           # noqa: E731
        x, table, w_l, b, out_dtype=out_dtype)
    earlier_ms = None
    with torch.inference_mode():
        out, again = launch(), launch()
        ref = ops.spiral_conv_plain(w_l, b, x, op, out_dtype)
        torch.cuda.synchronize()
        err = max_err(out.float(), ref.float())
        scale = float(ref.float().abs().max())
        if f32out:
            check(plan.path == "bf16_tile", f"K3a {name} B={batch}: plan "
                  f"{plan.path}, not the tiled kernel")
            check(err <= K3A_RTOL * scale, f"K3a {name} B={batch}: max "
                  f"|kernel - plain| {err:.3e} > {K3A_RTOL} x {scale:.3e}")
            old_err = max_err(untiled(), ref)
            check(old_err <= K3A_RTOL * scale, f"K3a {name} B={batch}: the "
                  f"untiled kernel is {old_err:.3e} from the twin")
            earlier_ms = cuda_ms(torch, untiled, 20)
            ulp = None
        else:
            ulp = ulps(torch, out, ref)
            check(ulp <= 1.0, f"K1-bf16 {name} B={batch}: {ulp:.2f} bf16 "
                  "ulps from the plain twin")
        check(torch.equal(out, again),
              f"{kernel} {name} B={batch}: two launches differ")
        x_bm = x.transpose(0, 1).contiguous()
        flat = table.reshape(-1).long()
        w_t = w_l.reshape(seq * c_in, c_out).t().contiguous()
        lib = lambda: torch.nn.functional.linear(      # noqa: E731
            x_bm.index_select(1, flat).view(batch, m, seq * c_in), w_t, b)
        lib_err = max_err(lib().transpose(0, 1).float(), ref.float())
        check(lib_err <= MIXED_RTOL * scale,
              f"{kernel} {name} B={batch}: library form disagrees "
              f"({lib_err:.3e})")
        ms = cuda_ms(torch, launch, 20)
        plain_ms = cuda_ms(torch, lambda: ops.spiral_conv_plain(
            w_l, b, x, op, out_dtype), 5)
        lib_ms = cuda_ms(torch, lib, 5)
    nbytes = (2 * (x.numel() + w_l.numel() + c_out) + 4 * table.numel()
              + (4 if f32out else 2) * m * batch * c_out)
    flops = 2.0 * m * batch * seq * c_in * c_out
    b_ms, b_by, t_ops = bound_bf16(nbytes, flops)
    log(f"[8 {kernel} {name} B={batch}] {op.n_src}->{m} {c_in}->{c_out} "
        f"{plan.path} ({plan.blocks} blocks, {plan.smem} B smem"
        + (f", tb {plan.tb}, {plan.threads} threads" if tiles else "")
        + f"): err {err:.2e} (max|out| {scale:.2e}"
        + (f", {ulp:.2f} ulps" if ulp is not None else "")
        + f"); kernel {ms:.4f} ms"
        + (f", untiled kernel {earlier_ms:.4f}" if tiles else "")
        + f", plain {plain_ms:.4f}, library {lib_ms:.4f}, bound "
        f"{b_ms:.5f} ({b_by}); kernel/library {ms / lib_ms:.2f}")
    rec = dict(conv=name, batch=batch, kernel=kernel, path=plan.path,
               plan=dataclasses.asdict(plan), n_src=op.n_src, m=m,
               c_in=c_in, c_out=c_out, max_abs_err=err, ulps=ulp, ms=ms,
               plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
               bound_by=b_by, bytes=nbytes, flops=flops, ops_ms=t_ops)
    if tiles:
        rec["earlier_ms"] = earlier_ms
    return rec


def mixed_k3b_shape(torch, kernels, ops, gen, conv, op, batch) -> dict:
    """K3b at the final conv: the products of bf16 x and the final conv's
    bf16 weights in fp32, laid out as the matmul-first form lays ``u``,
    ``[L, O, N, B]``, bit-equal to the twin, timed against it and the
    library form (``index_select`` of every position's rows from a
    position-major ``[L·N, B·O]`` copy of ``u``, then one sum)."""
    seq, m = op.seq_length, op.num_vertices
    c_in, c_out = conv_widths(conv, op)
    x = torch.randn((op.n_src, batch, c_in), generator=gen,
                    device=DEVICE).to(torch.bfloat16)
    w = conv.w.detach().to(torch.bfloat16).float()
    w_t = w.reshape(seq, c_in, c_out).transpose(1, 2).reshape(
        seq * c_out, c_in)
    u = (w_t @ x.reshape(-1, c_in).float().t()).view(
        seq, c_out, op.n_src, batch)
    b = 0.1 * torch.randn(c_out, generator=gen, device=DEVICE)
    table = op.table
    u_pos = u.permute(0, 2, 3, 1).reshape(seq * op.n_src, -1).contiguous()
    flat = (table.long().t() + op.n_src * torch.arange(
        seq, device=DEVICE)[:, None]).reshape(-1)
    b_row = b.repeat(batch)
    with torch.inference_mode():
        out = kernels.out_gather_sum(u, table, b)
        ref = ops.out_gather_sum_plain(u, table, b)
        torch.cuda.synchronize()
        check(torch.equal(out, ref), f"K3b B={batch}: kernel and twin "
              f"differ at {int((out != ref).sum())} values")
        lib = lambda: u_pos.index_select(0, flat).view(     # noqa: E731
            seq, m, -1).sum(0) + b_row
        scale = float(ref.abs().max())
        check(max_err(lib().view(m, batch, c_out), ref) <= 1e-5 * scale,
              "K3b: library form disagrees")
        ms = cuda_ms(torch, lambda: kernels.out_gather_sum(u, table, b), 50)
        plain_ms = cuda_ms(torch, lambda: ops.out_gather_sum_plain(
            u, table, b), 10)
        lib_ms = cuda_ms(torch, lib, 10)
    nbytes = 4 * (u.numel() + table.numel() + c_out + m * batch * c_out)
    flops = float(m * batch * c_out * seq)
    b_ms, b_by, _, _ = bound(nbytes, flops)
    log(f"[8 out_gather_sum B={batch}] {op.n_src}->{m} L={seq} "
        f"D={batch * c_out}: bit-equal; kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f}, library {lib_ms:.4f}, bound {b_ms:.5f} ({b_by})")
    return dict(conv="final", batch=batch, kernel="out_gather_sum",
                n_src=op.n_src, m=m, c_in=c_in, c_out=c_out,
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=flops)


def mixed_k3b_bwd_shape(torch, kernels, ops, gen, conv, op, batch) -> dict:
    """K3b's backward at the final conv: ``du`` in ``u``'s layout from a
    random fp32 cotangent in one launch, bit-equal to its twin and to the
    form it replaced (each position's capped transpose, a fused K4 launch
    each, stacked), timed against both, and against the library form (one
    ``index_add_`` of the cotangent, repeated per position, into a zeroed
    ``[L·N, B·O]``; the repeat is made beforehand)."""
    seq, m, n = op.seq_length, op.num_vertices, op.n_src
    c_out = conv_widths(conv, op)[1]
    dout = torch.randn((m, batch, c_out), generator=gen, device=DEVICE)
    bwd = op.out_bwd
    launch = lambda: kernels.out_gather_sum_bwd(dout, bwd)     # noqa: E731
    earlier = lambda: torch.stack(                             # noqa: E731
        [dout if g is None else g.transpose.apply(dout)
         for g in op.gathers], dim=2)
    idx = (op.table.long().t() + n * torch.arange(
        seq, device=DEVICE)[:, None]).reshape(-1)
    src = dout.reshape(m, -1).repeat(seq, 1)
    lib = lambda: torch.zeros(                                  # noqa: E731
        (seq * n, batch * c_out), device=DEVICE).index_add_(0, idx, src)
    with torch.inference_mode():
        du, again = launch(), launch()
        ref = ops.out_gather_sum_bwd_plain(dout, bwd)
        old = earlier().permute(2, 3, 0, 1)
        torch.cuda.synchronize()
        check(torch.equal(du, ref) and torch.equal(du, again),
              f"K3b backward B={batch}: kernel and twin differ at "
              f"{int((du != ref).sum())} values")
        check(torch.equal(du, old), f"K3b backward B={batch}: kernel and "
              "the stack of per-position transposes differ")
        scale = float(ref.abs().max())
        lib_err = max_err(lib().view(seq, n, batch, c_out).permute(
            0, 3, 1, 2), ref)
        check(lib_err <= 1e-5 * scale,
              f"K3b backward: library form disagrees ({lib_err:.3e})")
        ms = cuda_ms(torch, launch, 50)
        earlier_ms = cuda_ms(torch, earlier, 10)
        plain_ms = cuda_ms(torch, lambda: ops.out_gather_sum_bwd_plain(
            dout, bwd), 10)
        lib_ms = cuda_ms(torch, lib, 10)
    entries = int(bwd.cols.numel())
    nbytes = 4 * (dout.numel() + du.numel() + 2 * entries
                  + bwd.links.numel() + bwd.info.numel())
    flops = 2.0 * entries * batch * c_out
    b_ms, b_by, _, _ = bound(nbytes, flops)
    log(f"[8 out_gather_sum_bwd B={batch}] {m}->{n} L={seq} "
        f"D={batch * c_out}, {entries} table entries: bit-equal to the twin "
        f"and the stack; kernel {ms:.4f} ms (one launch), per-position "
        f"transposes + stack {earlier_ms:.4f} ({seq - len(op.identity_cols)}"
        f" launches + stack), plain {plain_ms:.4f}, library {lib_ms:.4f}, "
        f"bound {b_ms:.5f} ({b_by})")
    return dict(conv="final", batch=batch, kernel="out_gather_sum_bwd",
                n_src=n, m=m, c_out=c_out, max_abs_err=0.0, ms=ms,
                earlier_ms=earlier_ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=flops)


def mixed_k4_shape(torch, kernels, ops, gen, name, mat, n_src, d) -> dict:
    """K4-bf16 (or its capped form, where the table has tiers) on bf16
    rows: bit-equal to the twin (the walk's, for the capped form), timed
    against it and the library form, ``index_select`` and one bf16
    ``einsum`` over the main table. That is the whole function only where
    there are no tiers (``torch.sparse.mm`` has no bf16 CUDA kernel), so a
    capped table's library time is null and its main table's is kept
    apart."""
    m, k = mat.cols.shape
    ties = tiers_of(mat)
    x2 = torch.randn((n_src, d), generator=gen,
                     device=DEVICE).to(torch.bfloat16)
    vals = mat.vals.to(torch.bfloat16)
    flat = mat.cols.reshape(-1)
    if ties:
        launch = lambda: kernels.ell_matmul_capped(          # noqa: E731
            mat.cols, mat.vals, ties, mat.links, x2)
        plain = lambda: ops.ell_matmul_capped_plain(         # noqa: E731
            mat.cols, mat.vals, ties, mat.links, x2)
    else:
        launch = lambda: kernels.ell_matmul_fwd(             # noqa: E731
            mat.cols, mat.vals, x2)
        plain = lambda: ops.ell_matmul_plain(mat.cols, mat.vals, x2)  # noqa
    lib = lambda: torch.einsum(                               # noqa: E731
        "mkd,mk->md", x2.index_select(0, flat).view(m, k, d), vals)
    kernel = "ell_matmul_capped_bf16" if ties else "ell_matmul_bf16"
    with torch.inference_mode():
        out, ref = launch(), plain()
        torch.cuda.synchronize()
        check(torch.equal(out, ref), f"{kernel} {name}: kernel and twin "
              f"differ at {int((out != ref).sum())} values")
        if ties:
            check(torch.equal(mat.apply(x2), ref),
                  f"CappedEll.apply {name} in bf16: card and twin differ")
        else:
            scale = float(ref.float().abs().max())
            check(max_err(lib().float(), ref.float()) <= MIXED_RTOL * scale,
                  f"{kernel} {name}: library form disagrees")
        ms = cuda_ms(torch, launch, 20)
        plain_ms = cuda_ms(torch, plain, 5)
        lib_ms = cuda_ms(torch, lib, 5)
    src = torch.cat([flat] + [c.reshape(-1) for _, c, _ in ties])
    t_entries = sum(c.numel() for _, c, _ in ties)
    t_rows = sum(r.numel() for r, _, _ in ties)
    nbytes = (2 * (int(torch.unique(src).numel()) * d + m * d)
              + 8 * (m * k + t_entries) + (4 * (m + t_rows) if ties else 0))
    flops = 2.0 * (m * k + t_entries) * d + t_rows * d
    b_ms, b_by, _, _ = bound(nbytes, flops)
    log(f"[8 {kernel} {name}] {n_src}->{m} K={k} D={d}"
        + (f", tiers {[int(r.numel()) for r, _, _ in ties]} rows" if ties
           else "")
        + f": bit-equal; kernel {ms:.4f} ms, plain {plain_ms:.4f}, library "
        f"{lib_ms:.4f} (main table only{'' if ties else ': all of it'}), "
        f"bound {b_ms:.5f} ({b_by})")
    return dict(table=name, kernel=kernel, n_src=n_src, m=m, k=k, d=d,
                tiers=len(ties), max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                library_ms=None if ties else lib_ms,
                main_library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                bytes=nbytes, flops=flops)


def mixed_k2_shape(torch, kernels, ops, gen, name, conv, op, batch,
                   regs: dict) -> dict:
    """K2-dW-bf16 at one conv over a ``batch``-mesh grid, bf16 x and dy:
    within one bf16 ulp of its chunk-order twin, two launches bit-equal,
    timed against the twin and the library form (``index_select`` of the
    L gathers, one bf16 ``einsum``)."""
    bf16 = torch.bfloat16
    seq, m = op.seq_length, op.num_vertices
    c_in, c_out = conv_widths(conv, op)
    x = torch.randn((op.n_src, batch, c_in), generator=gen,
                    device=DEVICE).to(bf16)
    dy = torch.randn((m, batch, c_out), generator=gen,
                     device=DEVICE).to(bf16)
    table = op.table
    plan = kernels.plan_spiral_conv_dw_bf16(m, batch, seq, c_in, c_out)
    flat = table.t().reshape(-1)
    x2, d2 = x.view(op.n_src, -1), dy.view(-1, c_out)
    lib = lambda: torch.einsum(                          # noqa: E731
        "lnc,no->lco", x2.index_select(0, flat).view(seq, m * batch, c_in),
        d2)
    launch = lambda: kernels.spiral_conv_dw(x, table, dy)    # noqa: E731
    with torch.inference_mode():
        out, again = launch(), launch()
        ref = ops.spiral_conv_dw_chunked_plain(x, table, dy, plan)
        torch.cuda.synchronize()
        ulp = ulps(torch, out, ref)
        check(ulp <= 1.0, f"K2-dW-bf16 {name}: {ulp:.2f} bf16 ulps from "
              "the chunk-order twin")
        check(torch.equal(out, again), f"K2-dW-bf16 {name}: launches differ")
        err = max_err(out.float(), ref.float())
        scale = float(ref.float().abs().max())
        check(max_err(lib().float(), ref.float()) <= MIXED_RTOL * scale,
              f"K2-dW-bf16 {name}: library form disagrees")
        ms = cuda_ms(torch, launch, 20)
        plain_ms = cuda_ms(torch, lambda: ops.spiral_conv_dw_chunked_plain(
            x, table, dy, plan), 3)
        lib_ms = cuda_ms(torch, lib, 5)
    nbytes = 2 * (x.numel() + dy.numel() + seq * c_in * c_out) \
        + 4 * table.numel()
    flops = 2.0 * seq * m * batch * c_in * c_out
    b_ms, b_by, t_ops = bound_bf16(nbytes, flops)
    inst = regs.get(f"dw_bf16<{plan.fpw}>", {})
    log(f"[8 K2-dW-bf16 {name}] {op.n_src}->{m} x{batch} {c_in}->{c_out} "
        f"({plan.n_chunks} chunks of {plan.chunk_v} vertices x {seq} "
        f"positions, {plan.fpw} fragments a warp, "
        f"{inst.get('registers')} registers, {inst.get('spill_bytes', 0)} B "
        f"spilled): {ulp:.2f} ulps (max|dW| {scale:.2e}); kernel {ms:.4f} "
        f"ms, plain {plain_ms:.4f}, library {lib_ms:.4f}, bound {b_ms:.5f} "
        f"({b_by}); kernel/library {ms / lib_ms:.2f}")
    return dict(conv=name, batch=batch, kernel="spiral_conv_dw_bf16",
                n_src=op.n_src, m=m, c_in=c_in, c_out=c_out,
                plan=dataclasses.asdict(plan),
                registers=inst.get("registers"),
                spill_bytes=inst.get("spill_bytes", 0), max_abs_err=err,
                ulps=ulp, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=flops,
                ops_ms=t_ops)


def octasphere_level0(ops):
    """The spiral op of phase 7's template's level 0 (the octasphere of
    ``ENTRY_SUBDIVISIONS``: 16,386 vertices) with its vertex tiles."""
    from craniofacialsd_vae_tpu_torch.geometry import (extract_spirals,
                                                       octasphere)

    pos, face = octasphere(ENTRY_SUBDIVISIONS)
    seq = MODEL_CONFIG["spirals"]["length"][0]
    return ops.build_spiral_op(extract_spirals(
        np.asarray(face), np.asarray(pos), seq)).to(DEVICE)


def mixed_parity(torch, mods, model, geom, ptxas: list) -> dict:
    """Phase 8 (a): every new kernel at every shape it has on the mixed
    paths, with the flagship model's seeded weights: K1-bf16 at the bf16
    convs and K3b and its backward at the final conv at each batch bucket
    (the step's grid is the bucket B = 16), K3a at the
    final conv at each bucket on the fixture's and the octasphere's level
    0 (``ENTRY_SUBDIVISIONS``), K4-bf16 at the up-pools at each bucket, and at
    the step's grid K2-dW-bf16 at every bf16 conv (and the final conv's
    gather-first form) and K4-bf16 or its capped form on every bf16
    backward table. Returns the shapes by kernel."""
    kernels, ops = mods["kernels"], mods["ops"]
    regs = {k["kernel"]: k for k in ptxas}
    for k in ptxas:
        if "bf16" in k["kernel"] or k["kernel"].startswith("out_gather"):
            log(f"[8 ptxas] {k['kernel']}: {k.get('registers')} registers, "
                f"{k.get('spill_bytes', 0)} bytes spilled")
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 11)
    kinds = conv_kinds(model, geom)
    bf_convs = [(n, c, o) for n, c, o, dt, form in kinds
                if dt == torch.bfloat16 and form == "gather"]
    final = next((c, o) for n, c, o, _, _ in kinds if n == "final")
    grid = TRAIN_CONFIG["batch_size"] ** 2
    shapes = {k: {} for k in MIXED_KERNELS}
    n = len(model.de_convs)
    for batch in BATCHES:
        shapes["spiral_conv_bf16"][batch] = [
            mixed_k1_shape(torch, kernels, ops, gen, name, conv, op, batch)
            for name, conv, op in bf_convs]
        shapes["out_gather_sum"][batch] = [
            mixed_k3b_shape(torch, kernels, ops, gen, *final, batch)]
        shapes["out_gather_sum_bwd"][batch] = [
            mixed_k3b_bwd_shape(torch, kernels, ops, gen, *final, batch)]
        ups = []
        for j in range(n):
            level = n - 1 - j
            up = geom.up[level]
            c = conv_widths(model.de_convs[j], geom.spirals[level])[0]
            ups.append(mixed_k4_shape(torch, kernels, ops, gen, f"up{level}",
                                      up, up.n_cols, batch * c))
        shapes["ell_matmul_bf16"][batch] = ups
    octa = octasphere_level0(ops)
    for batch in BATCHES:
        shapes["spiral_conv_f32out"][batch] = [
            mixed_k1_shape(torch, kernels, ops, gen, mesh, final[0], op,
                           batch, f32out=True)
            for mesh, op in (("final", final[1]), ("final_octasphere", octa))]
    del octa
    shapes["spiral_conv_dw_bf16"][grid] = [
        mixed_k2_shape(torch, kernels, ops, gen, name, conv, op, grid, regs)
        for name, conv, op in bf_convs + [("final",) + final]]
    tables = [t for t in step_tables(model, geom, grid)
              if t[4] == torch.bfloat16]
    back = [mixed_k4_shape(torch, kernels, ops, gen, name, mat, n_src, d)
            for name, mat, n_src, d, _ in tables]
    shapes["ell_matmul_capped_bf16"][grid] = [e for e in back if e["tiers"]]
    shapes["ell_matmul_bf16_backward"] = [e for e in back if not e["tiers"]]
    # the same tables at the other buckets' widths: bit-equal, logged
    shapes["k4_bf16_backward_other"] = {
        batch: [mixed_k4_shape(torch, kernels, ops, gen, name, mat, n_src, d)
                for name, mat, n_src, d, dt in step_tables(model, geom, batch)
                if dt == torch.bfloat16]
        for batch in BATCHES if batch != grid}
    torch.cuda.empty_cache()
    return shapes


def mixed_serving(torch, mods, bundle, config, serve: dict) -> dict:
    """Phase 8 (b): a mixed ``DiagnosisService(max_batch=16)`` answers
    ``reconstruct`` for 1, 3, 16 and 20 scans (phase 4's scans) and the
    error maps of the last are rendered (K7), counted; then, not
    counted: the same mixed service on the host (MIXED_RTOL of each
    array's max), phase 4's fp32 answers (MIXED_VS_FP32_RTOL, and the
    change of the per-vertex error in mm), warm p50 beside phase 4's."""
    from craniofacialsd_vae_tpu_torch.ops import selection_indices
    from craniofacialsd_vae_tpu_torch.serving import DiagnosisService
    from craniofacialsd_vae_tpu_torch.viz import (errors_to_colors,
                                                  render_batch)

    kernels = mods["kernels"]
    inp = serve["inputs"]
    norm, scans, fp32 = inp["norm"], inp["scans"], inp["answers"]
    sel = selection_indices(bundle.down[0])
    faces = bundle.lr_face[0]
    svc = DiagnosisService.from_bundle(bundle, config, norm, TO_MM, seed=SEED,
                                       max_batch=BATCH, device=DEVICE)
    kernels.launches.reset()
    answers = {b: svc.reconstruct(scans[b]) for b in REQUEST_SIZES}
    last = answers[REQUEST_SIZES[-1]]
    colors = errors_to_colors(last["vertex_errors_mm"][:, sel], 0,
                              ERROR_MAX_MM, "plasma") / 255.0
    errmap = render_batch(last["vertices"][:, sel], faces, colors,
                          image_size=IMAGE, shadeless=True, device=DEVICE)
    counts = kernels.launches.snapshot()
    n = bundle.vertex_counts[0]
    for b, ans in answers.items():
        check(ans["vertices"].shape == (b, n, 3)
              and ans["vertex_errors_mm"].shape == (b, n)
              and ans["latent"].shape == (b, config.latent_size),
              f"mixed reconstruct B={b}: shapes")
        for key, v in ans.items():
            check(v.dtype == np.float32 and np.isfinite(v).all(),
                  f"mixed reconstruct B={b}: {key} fp32 and finite")
    check(errmap.shape == (len(last["vertices"]), IMAGE, IMAGE, 3)
          and np.isfinite(errmap).all(), "mixed error maps")
    for kernel in ("spiral_conv_tc", "spiral_conv_bf16", "ell_matmul_bf16",
                   "out_gather_sum", "raster_sweep"):
        check(counts[kernel] > 0,
              f"{kernel} was not launched on the mixed serving path")
    cpu = DiagnosisService.from_bundle(bundle, config, norm, TO_MM, seed=SEED,
                                       max_batch=BATCH, device="cpu")
    host_err, fp32_err, err_mm = {}, {}, {}

    def rel(got, want):
        return float(np.abs(got - want).max() / np.abs(want).max())

    for b in REQUEST_SIZES:
        ref = cpu.reconstruct(scans[b])
        for key in ("vertices", "latent"):
            r = rel(answers[b][key], ref[key])
            check(r <= MIXED_RTOL, f"mixed B={b} {key}: card vs host "
                  f"{r:.3e} of the max")
            host_err[key] = max(host_err.get(key, 0.0), r)
            r = rel(answers[b][key], fp32[b][key])
            check(r <= MIXED_VS_FP32_RTOL, f"mixed B={b} {key}: vs fp32 "
                  f"{r:.3e} of the max")
            fp32_err[key] = max(fp32_err.get(key, 0.0), r)
        change = np.abs(answers[b]["vertex_errors_mm"]
                        - fp32[b]["vertex_errors_mm"])
        err_mm[b] = {"mean": float(change.mean()), "max": float(change.max())}
    del cpu
    latency = serve_latency(svc, scans)
    log(f"[8 mixed serve] launches {counts}; card vs host (rel) {host_err}; "
        f"vs phase 4's fp32 (rel) {fp32_err}; per-vertex error change mm "
        f"{err_mm}; warm reconstruct p50 ms by batch (fp32 in phase 4): "
        + ", ".join(f"{b}: {v['p50_ms']:.2f} "
                    f"({serve['latency'][b]['p50_ms']:.2f})"
                    for b, v in latency.items()))
    return dict(counts=counts, card_vs_host_rel=host_err,
                vs_fp32_rel=fp32_err, error_change_mm=err_mm,
                latency=latency)


def grad_cosine(torch, a: dict, b: dict) -> float:
    va = torch.cat([a[k].detach().float().cpu().ravel() for k in sorted(a)])
    vb = torch.cat([b[k].detach().float().cpu().ravel() for k in sorted(b)])
    return float(va @ vb / (va.norm() * vb.norm()))


def mixed_training(torch, mods, bundle, config, fp32_config,
                   train: dict) -> dict:
    """Phase 8 (c): one counted mixed step on the card (launches equal to
    ``expected_step_launches``) against the host's mixed step (same
    weights, scans, region and noise): losses within MIXED_RTOL, the
    whole gradient's cosine at least MIXED_COSINE, every gradient fp32;
    the cosine against the card's fp32 step; 10 warm steps and a
    profiled step beside phase 5's, whose top device ops hold no stack of
    the final conv's cotangent."""
    from craniofacialsd_vae_tpu_torch.models import init_sdvae
    from craniofacialsd_vae_tpu_torch.training import (LOSS_KEYS,
                                                       LossWeights,
                                                       coupled_adam,
                                                       make_train_step)

    kernels = mods["kernels"]
    b = TRAIN_CONFIG["batch_size"]
    grid = b * b
    weights = LossWeights.from_config(TRAIN_CONFIG)
    lr, wd = TRAIN_CONFIG["lr"], TRAIN_CONFIG["weight_decay"]
    geom_h = training_geometry(bundle)
    geom = geom_h.to(DEVICE)
    data, region, eps = training_inputs(torch, bundle, config)

    def stepper(cfg, g):
        model = init_sdvae(cfg, g, torch.Generator().manual_seed(SEED))
        return model, make_train_step(
            model, weights, coupled_adam(model.parameters(), lr, wd), b)

    model, step = stepper(config, geom)
    x = torch.as_tensor(data[:b], device=DEVICE)
    kernels.launches.reset()
    m_card = step(x, region_idx=region, eps=eps.to(DEVICE))
    torch.cuda.synchronize()
    counts = kernels.launches.snapshot()
    want = expected_step_launches(model, geom, grid)
    check(counts == want, f"mixed step launches {counts}, expected {want}")
    grads = {k: p.grad for k, p in model.named_parameters()}
    for k, g in grads.items():
        check(g is not None and g.dtype == torch.float32
              and bool(torch.isfinite(g).all()),
              f"mixed card step: no finite fp32 gradient for {k}")
    model_h, step_h = stepper(config, geom_h)
    t1 = time.perf_counter()
    m_host = step_h(torch.from_numpy(data[:b]), region_idx=region, eps=eps)
    host_ms = (time.perf_counter() - t1) * 1e3
    loss_err = {}
    for k in LOSS_KEYS:
        got, ref = float(m_card[k]), float(m_host[k])
        check(np.isfinite(got), f"mixed card step: {k} is not finite")
        check(abs(got - ref) <= MIXED_RTOL * abs(ref),
              f"mixed step {k}: card {got!r} vs host {ref!r}")
        loss_err[k] = abs(got - ref) / abs(ref) if ref else abs(got)
    cos_host = grad_cosine(torch, grads, {k: p.grad for k, p in
                                          model_h.named_parameters()})
    check(cos_host >= MIXED_COSINE,
          f"mixed step: gradient cosine card vs host {cos_host:.6f}")
    del model_h, step_h, geom_h
    model32, step32 = stepper(fp32_config, geom)
    m32 = step32(x, region_idx=region, eps=eps.to(DEVICE))
    cos_fp32 = grad_cosine(torch, grads, {k: p.grad for k, p in
                                          model32.named_parameters()})
    check(cos_fp32 >= MIXED_COSINE,
          f"mixed step: gradient cosine against fp32 {cos_fp32:.6f}")
    loss_vs_fp32 = {k: abs(float(m_card[k]) - float(m32[k]))
                    / max(abs(float(m32[k])), 1e-30) for k in LOSS_KEYS}
    del model32, step32
    log(f"[8 mixed train] counted step launches {counts} (as expected); "
        f"card vs host: worst loss rel {max(loss_err.values()):.2e}, "
        f"gradient cosine {cos_host:.6f}; against the card's fp32 step: "
        f"gradient cosine {cos_fp32:.6f}, loss rel {loss_vs_fp32}; host "
        f"step {host_ms:.0f} ms")

    data_dev = torch.as_tensor(data, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 7)
    idx = torch.randint(0, len(data), (WARM_STEPS + 2, b), generator=gen,
                        device=DEVICE)
    step(data_dev.index_select(0, idx[0]), generator=gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, tots = [], []
    for t in range(WARM_STEPS):
        t1 = time.perf_counter()
        m = step(data_dev.index_select(0, idx[t + 1]), generator=gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
        tots.append(float(m["tot"]))
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    check(all(np.isfinite(tots)), f"mixed warm steps: tot {tots}")
    p50 = sorted(times)[len(times) // 2]
    prof = device_profile(torch, lambda: step(
        data_dev.index_select(0, idx[-1]), generator=gen))
    top = ", ".join(f"{k['name'][:40]} {k['ms']:.3f} ({k['count']})"
                    for k in prof["by_kernel"][:8])
    # K3b's backward writes du in place: no stack (a cat kernel) of the
    # final conv's cotangents among the step's top device ops
    cats = [k["name"] for k in prof["by_kernel"] if "Cat" in k["name"]]
    check(not cats, f"mixed step: cat kernels among the top device ops "
          f"{cats}")
    fp32_prof = train["profile"]
    log(f"[8 mixed train] {WARM_STEPS} warm steps: p50 {p50:.2f} ms (fp32 "
        f"step in phase 5: {train['step_p50_ms']:.2f}), "
        f"{grid / p50 * 1e3:.1f} swap-grid meshes/s; peak {peak_mb:.0f} MiB "
        f"(fp32 {train['peak_mib']:.0f}); profiled step: wall "
        f"{prof['wall_ms']:.2f} ms, device {prof['device_ms']} ms (fp32 "
        f"{fp32_prof['device_ms']}), idle share {prof['idle_share']}, "
        f"{prof['kernels_run']} kernels run (fp32 "
        f"{fp32_prof['kernels_run']}); {top}")
    return dict(counts=counts, expected=want, loss_rel_err=loss_err,
                grad_cosine_host=cos_host, grad_cosine_fp32=cos_fp32,
                loss_rel_vs_fp32=loss_vs_fp32, host_step_ms=host_ms,
                step_ms=times, step_p50_ms=p50,
                meshes_per_s=grid / p50 * 1e3, peak_mib=peak_mb,
                tot=tots, profile=prof)


def mixed_gather_first(torch, mods, bundle, config) -> dict:
    """The path of ``final_out_gather: False`` (the final conv
    gather-first, K3a): one counted ``reconstruct`` of 16 scans and one
    counted mixed step; K3a must launch in both."""
    from craniofacialsd_vae_tpu_torch.models import init_sdvae
    from craniofacialsd_vae_tpu_torch.serving import DiagnosisService
    from craniofacialsd_vae_tpu_torch.training import (LossWeights,
                                                       coupled_adam,
                                                       make_train_step)

    kernels = mods["kernels"]
    cfg = dataclasses.replace(config, final_out_gather=False)
    rng = np.random.default_rng(SEED + 12)
    n = bundle.vertex_counts[0]
    norm = {"mean": np.zeros((n, 3), np.float32),
            "std": np.ones((n, 3), np.float32)}
    svc = DiagnosisService.from_bundle(bundle, cfg, norm, TO_MM, seed=SEED,
                                       max_batch=BATCH, device=DEVICE)
    geom = training_geometry(bundle).to(DEVICE)
    model = init_sdvae(cfg, geom, torch.Generator().manual_seed(SEED))
    b = TRAIN_CONFIG["batch_size"]
    step = make_train_step(model, LossWeights.from_config(TRAIN_CONFIG),
                           coupled_adam(model.parameters(), 1e-4, 0.0), b)
    data, region, eps = training_inputs(torch, bundle, config)
    kernels.launches.reset()
    ans = svc.reconstruct(rng.normal(size=(BATCH, n, 3)).astype(np.float32))
    m = step(torch.as_tensor(data[:b], device=DEVICE), region_idx=region,
             eps=eps.to(DEVICE))
    torch.cuda.synchronize()
    counts = kernels.launches.snapshot()
    want = expected_step_launches(model, geom, b * b)
    check(counts["spiral_conv_f32out"] == 1 + want["spiral_conv_f32out"],
          f"K3a launches {counts['spiral_conv_f32out']} on the gather-first "
          "path")
    check(np.isfinite(ans["vertices"]).all()
          and all(bool(torch.isfinite(v)) for v in m.values()),
          "gather-first mixed path: finite answers and losses")
    log(f"[8 mixed gather-first] launches {counts}")
    return dict(counts=counts)


def mixed_entry(torch, mods, root: str, cfg_path: str) -> dict:
    """Phase 8 (d): ``train.main`` with ``compute_dtype: mixed`` for 2
    epochs on phase 7's workspace and caches: finite losses, the run
    dir's checkpoint equal to the trained manager, and a fresh manager
    resuming it bit for bit."""
    from craniofacialsd_vae_tpu_torch import train as entry
    from craniofacialsd_vae_tpu_torch.manager import ModelManager
    from craniofacialsd_vae_tpu_torch.training.checkpoint import \
        read_checkpoint
    from craniofacialsd_vae_tpu_torch.utils import get_config

    kernels = mods["kernels"]
    with open(cfg_path) as f:
        text = f.read()
    text, n = re.subn(r"^(\s*)pre_z_sigmoid:[^\n]*",
                      lambda m: f"{m.group(0)}\n{m.group(1)}compute_dtype: "
                      "mixed", text, flags=re.M)
    check(n == 1, f"the entry config has {n} 'pre_z_sigmoid:' lines")
    path = os.path.join(root, "entry_mixed.yaml")
    with open(path, "w") as f:
        f.write(text)
    config = get_config(path)
    check(config["model"]["compute_dtype"] == "mixed", "mixed entry config")
    kernels.launches.reset()
    t0 = time.perf_counter()
    run = entry.main(["--config", path, "--id", "entry_mixed",
                      "--output_path", root, "--device", DEVICE,
                      "--epochs", str(ENTRY_CADENCE)])
    run_s = time.perf_counter() - t0
    counts = kernels.launches.snapshot()
    for h in run["history"]:
        for phase in ("train", "validation"):
            check(all(np.isfinite(v) for v in h[phase].values()),
                  f"mixed entry epoch {h['epoch']} {phase} {h[phase]}")
    for kernel in ("spiral_conv_bf16", "ell_matmul_bf16",
                   "ell_matmul_capped_bf16", "spiral_conv_dw_bf16",
                   "out_gather_sum", "out_gather_sum_bwd", "raster_sweep"):
        check(counts[kernel] > 0,
              f"{kernel} was not launched on the mixed entry path")
    ckpt = run["checkpoint_dir"]
    model_file = read_checkpoint(os.path.join(
        ckpt, f"model_{ENTRY_CADENCE:08d}.ckpt"))
    opt_file = read_checkpoint(os.path.join(ckpt, "optimizer.ckpt"))
    state_matches_files(run["manager"], model_file, opt_file,
                        "mixed trained manager")
    fresh = ModelManager(config, config["data"]["precomputed_path"],
                         device=DEVICE)
    check(fresh.resume(ckpt) == ENTRY_CADENCE, "mixed resume epoch")
    state_matches_files(fresh, model_file, opt_file, "mixed resumed manager")
    check(all(p.dtype == torch.float32 for p in fresh.model.parameters()),
          "mixed checkpoint: fp32 parameters")
    tots = [h["train"]["tot"] for h in run["history"]]
    log(f"[8 mixed entry] {ENTRY_CADENCE} epochs in {run_s:.1f} s (geometry "
        f"{run['geometry_s']:.2f} s, dataset {run['data_s']:.2f} s from "
        f"phase 7's caches), train tot {tots}, resumed bit for bit; "
        f"launches {counts}")
    check(os.path.isfile(os.path.join(ckpt, "classifiers.npz"))
          and os.path.isfile(os.path.join(run["output_dir"], "z_stats.npz")),
          "mixed entry: no classifiers.npz or z_stats.npz")
    log(f"[8 mixed entry] zoo fitted in {run['classifiers_s']:.2f} s, "
        f"validation accuracies {run['classifier_accs']}")
    del run["manager"], fresh
    return dict(run_s=run_s, train_tot=tots, counts=counts,
                epoch_train_s=[h["train_s"] for h in run["history"]],
                zoo={"fit_s": run["classifiers_s"],
                     "validation_accuracy": run["classifier_accs"]},
                run_dir=run["output_dir"])


def mixed_records(shapes: dict, serving: dict, training: dict,
                  gather_first: dict) -> list:
    """One record per new kernel and path: ``mixed_serving`` (K1-bf16,
    K4-bf16 and K3b over the B = 16 pass), ``mixed_training`` (the same
    forward shapes, K4-bf16 also on the backward tables without tiers,
    the capped K4-bf16, K2-dW-bf16 at the step's convs, K3b's backward)
    and ``mixed_gather_first`` (K3a)."""
    grid = TRAIN_CONFIG["batch_size"] ** 2

    def rec(name, path, shape_list, counts):
        r = summarize(name, *KERNEL_SOURCES[name], shape_list)
        r.update(path=path, launches=counts[name])
        check(r["launches"] > 0, f"{name} was not launched on {path}")
        return r

    sc, tc = serving["counts"], training["counts"]
    out = []
    for name in ("spiral_conv_bf16", "ell_matmul_bf16", "out_gather_sum"):
        r = rec(name, "mixed_serving", shapes[name][BATCH], sc)
        r["other_batches"] = {b: shapes[name][b] for b in BATCHES[1:]}
        out.append(r)
    convs = [s for s in shapes["spiral_conv_dw_bf16"][grid]
             if s["conv"] != "final"]
    out += [rec("spiral_conv_bf16", "mixed_training",
                shapes["spiral_conv_bf16"][grid], tc),
            rec("ell_matmul_bf16", "mixed_training",
                shapes["ell_matmul_bf16"][grid]
                + shapes["ell_matmul_bf16_backward"], tc),
            rec("out_gather_sum", "mixed_training",
                shapes["out_gather_sum"][grid], tc),
            rec("out_gather_sum_bwd", "mixed_training",
                shapes["out_gather_sum_bwd"][grid], tc),
            rec("spiral_conv_dw_bf16", "mixed_training", convs, tc),
            rec("ell_matmul_capped_bf16", "mixed_training",
                shapes["ell_matmul_capped_bf16"][grid], tc),
            rec("spiral_conv_f32out", "mixed_gather_first",
                [s for s in shapes["spiral_conv_f32out"][BATCH]
                 if s["conv"] == "final"], gather_first["counts"])]
    out[-1]["other_shapes"] = [s for b in BATCHES
                               for s in shapes["spiral_conv_f32out"][b]
                               if b != BATCH or s["conv"] != "final"]
    return out


def phase_mixed(torch, mods, bundle, serve: dict, train: dict, ptxas: list,
                root: str, entry_cfg: str, fp32_config) -> dict:
    """Phase 8: the flagship configurations' ``mixed`` policy on the card
    (see the module docstring)."""
    from craniofacialsd_vae_tpu_torch.models import init_sdvae

    t0 = time.perf_counter()
    config = flagship_config()
    geom = training_geometry(bundle).to(DEVICE)
    model = init_sdvae(config, geom, torch.Generator().manual_seed(SEED))
    shapes = mixed_parity(torch, mods, model, geom, ptxas)
    del model
    torch.cuda.empty_cache()
    serving = mixed_serving(torch, mods, bundle, config, serve)
    torch.cuda.empty_cache()
    training = mixed_training(torch, mods, bundle, config, fp32_config,
                              train)
    torch.cuda.empty_cache()
    gather_first = mixed_gather_first(torch, mods, bundle, config)
    torch.cuda.empty_cache()
    ent = mixed_entry(torch, mods, root, entry_cfg)
    records = mixed_records(shapes, serving, training, gather_first)
    line = {"phase": "mixed", "config": FLAGSHIP,
            "serving": {"p50_ms": {b: v["p50_ms"] for b, v in
                                   serving["latency"].items()},
                        "fp32_p50_ms": {b: v["p50_ms"] for b, v in
                                        serve["latency"].items()},
                        "card_vs_host_rel": serving["card_vs_host_rel"],
                        "vs_fp32_rel": serving["vs_fp32_rel"],
                        "error_change_mm": serving["error_change_mm"]},
            "training": {"step_p50_ms": training["step_p50_ms"],
                         "fp32_step_p50_ms": train["step_p50_ms"],
                         "device_ms": training["profile"]["device_ms"],
                         "fp32_device_ms": train["profile"]["device_ms"],
                         "kernels_run": training["profile"]["kernels_run"],
                         "fp32_kernels_run": train["profile"]["kernels_run"],
                         "idle_share": training["profile"]["idle_share"],
                         "grad_cosine_host": training["grad_cosine_host"],
                         "grad_cosine_fp32": training["grad_cosine_fp32"],
                         "worst_loss_rel": max(
                             training["loss_rel_err"].values())},
            "entry": {"run_s": ent["run_s"], "train_tot": ent["train_tot"],
                      "zoo": ent["zoo"]},
            "seconds": time.perf_counter() - t0}
    log(json.dumps(line))
    return dict(line=line, records=records, shapes=shapes, serving=serving,
                training=training, gather_first=gather_first, entry=ent)


# ----------------------------------------------------------------------
# phase 9: diagnosis serving from the run dirs of phases 7 and 8
def k8_bound(r: int, nq: int, nr: int) -> tuple:
    """One ``k8_fwd`` launch: each point read once (the query cloud per
    batch, the other shared), d and idx written once; K8_OPS_PER_PAIR
    operations a pair at the fp32 rate."""
    nbytes = (r * nq * 3 + nr * 3 + 3) * 4 + r * nq * 8
    return nbytes, K8_OPS_PER_PAIR * r * nq * nr


def k8_same_argmins(a1, b1, a2, b2) -> tuple:
    """Masks of the points whose chamfer gradient reads the same argmins
    in two evaluations (``a [R, P]``, ``b [R, Q]`` each): x point p keeps
    its own argmin and the same set of y points choosing it; y point q
    (over every batch) likewise. Returns (keep_x [R, P], keep_y [Q])."""
    import torch

    r, p = a1.shape
    q = b1.shape[1]
    keep_x = a1 == a2
    keep_y = torch.ones(q, dtype=torch.bool)
    for i in range(r):
        moved = (b1[i] != b2[i]).nonzero()[:, 0]
        keep_x[i, b1[i][moved].long()] = False
        keep_x[i, b2[i][moved].long()] = False
        keep_y[moved] = False
        swapped = (a1[i] != a2[i]).nonzero()[:, 0]
        keep_y[a1[i][swapped].long()] = False
        keep_y[a2[i][swapped].long()] = False
    return keep_x, keep_y


def k8_case(torch, mods, r: int, p: int, q: int, reps: int) -> dict:
    """K8 at one shape of the fit (``r`` restarts of ``p`` generated points
    against one target of ``q``): both k8_fwd launches and the k8_bwd
    launch against their twins on the same CUDA tensors (both directions
    against the one symmetric twin, in JAX's chunk order; distances within
    K8_D_RTOL of the largest, argmins equal where the best two distances
    are further apart than that, gradients within K8_G_RTOL of the
    largest against the host's twins), timed against the twins and, for
    the forward, against ``torch.cdist`` with both minima."""
    kernels = mods["kernels"]
    dist = mods["distances"]
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + r)
    x = torch.randn((r, p, 3), generator=gen, device=DEVICE) * 0.5 + 1.0
    y = torch.randn((q, 3), generator=gen, device=DEVICE) * 0.5 + 1.0
    mu = y.mean(0)
    out = {"restarts": r, "p": p, "q": q}
    with torch.no_grad():
        d_x, a = kernels.nearest_sq(x, y, mu)
        d_y, b = kernels.nearest_sq(y, x, mu)
        rx, ry, ra, rb = dist.nearest_dists_sq_sym_plain(x, y)
        torch.cuda.synchronize()
        err = max(max_err(d_x, rx), max_err(d_y, ry))
        tol = K8_D_RTOL * float(torch.maximum(rx.max(), ry.max()))
        check(err <= tol, f"K8 fwd R={r}: |d - twin| {err:.3e} > {tol:.3e}")
        agree = []
        for query, ref_pts, got, want in ((x, y, a, ra), (y, x, b, rb)):
            for i in range(r):
                u = (query[i] if query.dim() == 3 else query) - mu
                v = (ref_pts[i] if ref_pts.dim() == 3 else ref_pts) - mu
                e = torch.sum(v * v, -1)[None, :] - 2.0 * (u @ v.T)
                two = torch.topk(e, 2, dim=1, largest=False).values
                sep = two[:, 1] - two[:, 0] > tol
                check(torch.equal(got[i][sep], want[i][sep]),
                      f"K8 fwd R={r}: argmins differ where separated")
                agree.append(float(sep.float().mean()))
        out["separated_share"] = min(agree)
        out["max_abs_err"] = err

        def fwd():
            kernels.nearest_sq(x, y, mu)
            kernels.nearest_sq(y, x, mu)

        def fwd_plain():
            dist.nearest_dists_sq_sym_plain(x, y)

        def fwd_library():
            d2 = torch.cdist(x, y[None].expand(r, q, 3)).square()
            return d2.amin(dim=2), d2.amin(dim=1)

        out["ms"] = cuda_ms(torch, fwd, reps)
        out["plain_ms"] = cuda_ms(torch, fwd_plain, max(reps // 10, 2))
        out["library_ms"] = cuda_ms(torch, fwd_library, max(reps // 10, 2))
        nb1, ops1 = k8_bound(r, p, q)
        nb2, ops2 = k8_bound(r, q, p)
        out.update(bytes=nb1 + nb2, flops=ops1 + ops2)
        out["bound_ms"], out["bound_by"], _, _ = bound(out["bytes"],
                                                       out["flops"])

        # the backward in x, as the fit takes it
        gx = torch.randn((r, p), generator=gen, device=DEVICE)
        gy = torch.randn((r, q), generator=gen, device=DEVICE)
        perm, off = dist.argmin_csr(b, p)

        def bwd():
            return kernels.nearest_sq_bwd(x, y, mu, gx, d_x, a, gy, d_y,
                                          perm, off)

        def bwd_plain():
            return dist.nearest_sq_bwd_plain(x, y, mu, gx, d_x, a, gy, d_y,
                                             perm, off)

        dx, dx_ref = bwd(), bwd_plain()
        torch.cuda.synchronize()
        g_err = max_err(dx, dx_ref)
        check(g_err <= K8_G_RTOL * float(dx_ref.abs().max()),
              f"K8 bwd R={r}: |dx - twin| {g_err:.3e}")
        nb = (r * p * 3 + q * 3 + 3) * 4 + r * p * 12 + r * q * 12 \
            + r * (p + 1) * 4 + r * p * 12
        ops = K8_BWD_OPS_PER_POINT * r * (p + q)
        b_bound, b_by, _, _ = bound(nb, ops)
        out["bwd"] = dict(
            max_abs_err=g_err, ms=cuda_ms(torch, bwd, reps),
            plain_ms=cuda_ms(torch, bwd_plain, max(reps // 10, 2)),
            csr_ms=cuda_ms(torch, lambda: dist.argmin_csr(b, p), reps),
            library_ms=None, bytes=nb, flops=ops, bound_ms=b_bound,
            bound_by=b_by)

    # the gradient in both clouds through the autograd Function, card
    # against host, at every point whose gradient reads the same argmins
    # on both (near a tie the two pick different, equally near points)
    grads = []
    for dev in (DEVICE, "cpu"):
        xs = x.detach().to(dev).clone().requires_grad_(True)
        ys = y.detach().to(dev).clone().requires_grad_(True)
        dxs, dys = dist.nearest_dists_sq_sym(xs, ys)
        ((dxs * gx.to(dev)).sum() + (dys * gy.to(dev)).sum()).backward()
        grads.append((xs.grad.cpu(), ys.grad.cpu()))
    _, _, ha, hb = dist.nearest_dists_sq_sym_plain(x.cpu(), y.cpu())
    keep_x, keep_y = k8_same_argmins(a.cpu(), b.cpu(), ha, hb)
    out["tied_share"] = 1.0 - min(float(keep_x.float().mean()),
                                  float(keep_y.float().mean()))
    check(out["tied_share"] < 0.01,
          f"K8 R={r}: {out['tied_share']:.3%} of the points read other "
          "argmins on the card than on the host")
    for (card_g, host_g), name, keep in zip(zip(*grads), ("x", "y"),
                                            (keep_x, keep_y)):
        e = max_err(card_g[keep], host_g[keep])
        check(e <= K8_G_RTOL * float(host_g.abs().max()),
              f"K8 gradient in {name} R={r}: card vs host {e:.3e}")
        out[f"grad_{name}_card_vs_host"] = e
    log(f"[9 K8 R={r} P={p} Q={q}] fwd both directions {out['ms']:.4f} ms "
        f"(plain {out['plain_ms']:.3f}, cdist {out['library_ms']:.3f}, "
        f"bound {out['bound_ms']:.4f} {out['bound_by']}); bwd "
        f"{out['bwd']['ms']:.4f} ms (plain {out['bwd']['plain_ms']:.3f}, "
        f"CSR {out['bwd']['csr_ms']:.4f}, bound {out['bwd']['bound_ms']:.5f}"
        f" {out['bwd']['bound_by']}); errors d {err:.2e}, dx {g_err:.2e}; "
        f"argmins separated {out['separated_share']:.3f}")
    return out


def request_buckets(svc, n: int) -> list:
    """The batch buckets a request of ``n`` rows runs at: chunks of the
    service's ``max_batch``, each padded to its bucket."""
    return [svc._bucket(min(svc.max_batch, n - lo))
            for lo in range(0, n, svc.max_batch)]


def diagnosis_passes(svc) -> dict:
    """The model passes of ``diagnosis_requests``, each ``{batch: times}``:
    ``enc`` the encodes (every diagnose request, the one with posterior
    draws, saliency, the plan's patient), ``dec`` the decodes (the fit's
    restarts at every iteration and once after, its best restart, the
    plan's four key meshes), ``enc_bwd`` the backward to the data
    (saliency) and ``dec_bwd`` the backward to z (the fit, every
    iteration)."""
    from collections import Counter

    enc = Counter()
    for n in (*REQUEST_SIZES, 3, SALIENCY_BATCH, 1):
        enc.update(request_buckets(svc, n))
    dec = Counter({FIT_RESTARTS: FIT_ITERATIONS + 1})
    dec.update([1, *request_buckets(svc, 4)])
    return {"enc": enc, "dec": dec,
            "enc_bwd": Counter(request_buckets(svc, SALIENCY_BATCH)),
            "dec_bwd": Counter({FIT_RESTARTS: FIT_ITERATIONS})}


def pass_convs(kinds: list, part: str) -> list:
    """The convs of ``conv_kinds`` an encode (``part`` "enc") or a decode
    ("dec", the final conv included) runs."""
    return [k for k in kinds if k[0].startswith(part)
            or (part == "dec" and k[0] == "final")]


def diagnosis_shapes(torch, mods, svc, passes: dict) -> dict:
    """Every kernel of the diagnosis path at every shape it has there, on
    the served model's weights and tables and random inputs, against its
    twin and timed against it and a library call (the checks of phases 3,
    5 and 8): the spiral convs of each pass at each of its buckets, the
    up-pools of each decode, and the transposes of each backward (the
    first encoder conv's included: saliency's gradient reaches the data).
    Returns ``{kernel: [shape, ...]}``, each shape with its ``launches``
    on the path (times the passes run it)."""
    kernels, ops = mods["kernels"], mods["ops"]
    mgr = svc.manager
    model, geom, bundle = mgr.model, mgr.geometry, mgr.bundle
    kinds = conv_kinds(model, geom)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 13)
    shapes: dict = {}

    def add(entry, kernel, launches):
        entry.update(kernel=kernel, launches=launches)
        shapes.setdefault(kernel, []).append(entry)

    for part in ("enc", "dec"):
        for batch, times in sorted(passes[part].items()):
            for name, conv, op, dtype, form in pass_convs(kinds, part):
                kernel = conv_kernel(name, conv, op, dtype, form)
                if form == "out_gather":
                    e = mixed_k3b_shape(torch, kernels, ops, gen, conv, op,
                                        batch)
                elif dtype == torch.bfloat16:
                    e = mixed_k1_shape(torch, kernels, ops, gen, name, conv,
                                       op, batch, f32out=name == "final")
                else:
                    e = k1_shape(torch, kernels, ops, gen, name, conv, op,
                                 batch)
                add(e, kernel, times)
    n = len(model.de_convs)
    bf16 = model.config.deep_dtype == torch.bfloat16
    for batch, times in sorted(passes["dec"].items()):
        for j in range(n):
            level = n - 1 - j
            up = geom.up[level]
            d = batch * conv_widths(model.de_convs[j], geom.spirals[level])[0]
            if bf16:
                e = mixed_k4_shape(torch, kernels, ops, gen, f"up{level}", up,
                                   up.n_cols, d)
            else:
                e = k4_shape(torch, kernels, ops, gen, up, bundle.up[level],
                             level, d, batch)
            add(e, "ell_matmul_bf16" if bf16 else "ell_matmul_fwd", times)
    for part in ("enc", "dec"):
        convs = pass_convs(kinds, part)
        for batch, times in sorted(passes[part + "_bwd"].items()):
            for name, mat, n_src, d, dtype in transpose_tables(
                    model, geom, batch, [k[0] for k in convs]):
                if dtype == torch.bfloat16:
                    e = mixed_k4_shape(torch, kernels, ops, gen, name, mat,
                                       n_src, d)
                else:
                    e = k4_table_shape(torch, mods, gen, name, mat, n_src, d)
                add(e, e["kernel"], times)
            for name, conv, op, dtype, form in convs:
                if form == "out_gather":
                    add(mixed_k3b_bwd_shape(torch, kernels, ops, gen, conv,
                                            op, batch),
                        "out_gather_sum_bwd", times)
    torch.cuda.empty_cache()
    return shapes


def fit_scan(template_pos: np.ndarray, landmark_idx: list) -> tuple:
    """An unregistered scan of FIT_SCAN_POINTS points: a deformed copy of
    the template (scaled, shifted, a smooth bump) sampled with
    replacement, with per-point noise; and its landmarks."""
    rng = np.random.default_rng(SEED + 11)
    bump = 0.03 * np.sin(template_pos @ rng.normal(size=3))
    surface = template_pos * (1.05 + bump[:, None]) + 0.2
    pts = surface[rng.integers(0, len(surface), size=FIT_SCAN_POINTS)]
    pts = pts + rng.normal(scale=0.003, size=pts.shape)
    return pts.astype(np.float32), surface[landmark_idx].astype(np.float32)


def diagnose_latency(svc, scans: dict, reps: int = 7) -> dict:
    """Host-clock latency of warm ``diagnose`` requests by request
    size."""
    out = {}
    for b, x in scans.items():
        svc.diagnose(x)
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            svc.diagnose(x)
            ts.append((time.perf_counter() - t0) * 1e3)
        ts.sort()
        p50 = ts[len(ts) // 2]
        out[b] = {"p50_ms": p50, "min_ms": ts[0], "max_ms": ts[-1],
                  "n": reps, "meshes_per_s": b / p50 * 1e3}
    return out


def diagnosis_requests(svc, scans: dict, scan, lnd, iterations: int) -> dict:
    """The requests of the diagnosis path, once each: diagnose at every
    request size, with DIAG_SAMPLES posterior draws, saliency at
    SALIENCY_BATCH, one plan and one fit."""
    out = {"diagnose": {b: svc.diagnose(x) for b, x in scans.items()}}
    out["uncertainty"] = svc.diagnose(scans[3], n_samples=DIAG_SAMPLES,
                                      seed=SEED)
    out["saliency"] = svc.saliency(scans[REQUEST_SIZES[-1]][:SALIENCY_BATCH])
    out["plan"] = svc.plan(vertices=scans[1][0])
    t0 = time.perf_counter()
    out["fit"] = svc.fit(scan, lnd, iterations=iterations,
                         n_restarts=FIT_RESTARTS, seed=SEED)
    out["fit_s"] = time.perf_counter() - t0
    return out


def compare_diagnoses(card: list, host: list, what: str, rtol
                      ) -> float:
    """Labels equal; posteriors, Mahalanobis and uncertainty statistics
    within ``rtol`` (absolute for probabilities; None: recorded, not
    held); returns the worst."""
    worst = 0.0
    for i, (c, h) in enumerate(zip(card, host)):
        check(c["label"] == h["label"],
              f"{what} scan {i}: card {c['label']} vs host {h['label']}")
        for k, v in h["posteriors"].items():
            worst = max(worst, abs(c["posteriors"][k] - v))
        m = h["mahalanobis_to_healthy"]
        worst = max(worst, abs(c["mahalanobis_to_healthy"] - m)
                    / max(abs(m), 1e-30))
        if "uncertainty" in h:
            cu, hu = c["uncertainty"], h["uncertainty"]
            check(cu["sample_votes"] == hu["sample_votes"],
                  f"{what} scan {i}: sample votes differ")
            for f in ("posterior_mean", "posterior_std"):
                for k, v in hu[f].items():
                    worst = max(worst, abs(cu[f][k] - v))
    check(rtol is None or worst <= rtol,
          f"{what}: card vs host {worst:.3e} > {rtol}")
    return worst


def diagnosis_run(torch, mods, run_dir: str, policy: str) -> dict:
    """One run dir served on the card (the counted path: every request
    once), its latencies, the fit's launches per iteration, every kernel
    of the path at its shapes there (``diagnosis_shapes``, whose launches
    must be the counted run's), and the same requests against the host's
    service."""
    from craniofacialsd_vae_tpu_torch.data.dataset import build_datasets
    from craniofacialsd_vae_tpu_torch.serving import DiagnosisService
    from craniofacialsd_vae_tpu_torch.utils import get_config

    kernels = mods["kernels"]
    config = get_config(os.path.join(run_dir, "config.yaml"))
    train_set, _, _, norm, _ = build_datasets(config)
    raw = (np.asarray(train_set.x[:REQUEST_SIZES[-1]]) * norm["std"]
           + norm["mean"]).astype(np.float32)
    scans = {b: raw[:b] for b in REQUEST_SIZES}

    # the main path: counts from 0, the service built and every request
    # answered once; counts read
    kernels.launches.reset()
    t0 = time.perf_counter()
    svc = DiagnosisService.from_run_dir(run_dir, max_batch=BATCH,
                                        device=DEVICE)
    load_s = time.perf_counter() - t0
    lnd_idx = svc.landmark_idx
    n_gen = len(range(0, svc.manager.template.num_vertices, 4))
    check(n_gen == FIT_GEN_POINTS, f"the fit's generated side has {n_gen} "
          f"points, K8 was held at {FIT_GEN_POINTS}")
    scan, lnd = fit_scan(np.asarray(svc.manager.template.pos, np.float64),
                         lnd_idx)
    card = diagnosis_requests(svc, scans, scan, lnd, FIT_ITERATIONS)
    torch.cuda.synchronize()
    counts = kernels.launches.snapshot()
    fit = card["fit"]
    check(np.isfinite(fit["chamfer_mm2"]) and fit["chamfer_mm2"] >= 0,
          f"{policy} fit chamfer {fit['chamfer_mm2']}")
    check(fit["vertices"].shape == svc.manager.template.pos.shape,
          "fit vertices shape")
    check(all(np.isfinite(r["vertex_saliency_nats_per_mm"]).all()
              for r in card["saliency"]), "saliency not finite")

    # after the counted run: latencies, the fit's per-iteration cost
    latency = diagnose_latency(svc, scans)
    short = {}
    for it in (FIT_PROFILE_ITERATIONS, 2 * FIT_PROFILE_ITERATIONS):
        short[it] = device_profile(torch, lambda it=it: svc.fit(
            scan, lnd, iterations=it, n_restarts=FIT_RESTARTS, seed=SEED))
    lo, hi = short[FIT_PROFILE_ITERATIONS], short[2 * FIT_PROFILE_ITERATIONS]
    per_iter = {k: (hi[k] - lo[k]) / FIT_PROFILE_ITERATIONS
                for k in ("kernels_run", "device_ms", "wall_ms")}

    # every kernel of the path at its shapes there; the launches those
    # shapes account for are the counted run's, kernel for kernel
    passes = diagnosis_passes(svc)
    shapes = diagnosis_shapes(torch, mods, svc, passes)
    k8_per_fit = {"k8_fwd": 2 * (FIT_ITERATIONS + 1),
                  "k8_bwd": FIT_ITERATIONS}
    want = dict.fromkeys(kernels.KERNEL_NAMES, 0)
    want.update(k8_per_fit)
    for kernel, entries in shapes.items():
        want[kernel] += sum(e["launches"] for e in entries)
    check(counts == want, f"{policy}: diagnosis path launches {counts}, "
          f"expected {want} from its passes {passes}")

    # card against host, on the same requests (the fit at
    # FIT_PARITY_ITERATIONS on both)
    parity_fit = svc.fit(scan, lnd, iterations=FIT_PARITY_ITERATIONS,
                         n_restarts=FIT_RESTARTS, seed=SEED)
    t0 = time.perf_counter()
    host = DiagnosisService.from_run_dir(run_dir, max_batch=BATCH,
                                         device="cpu")
    h_diag = {b: host.diagnose(x) for b, x in scans.items()}
    h_unc = host.diagnose(scans[3], n_samples=DIAG_SAMPLES, seed=SEED)
    h_sal = host.saliency(scans[REQUEST_SIZES[-1]][:SALIENCY_BATCH])
    h_plan = host.plan(latent=card["plan"]["z_patient"])
    h_fit = host.fit(scan, lnd, iterations=FIT_PARITY_ITERATIONS,
                     n_restarts=FIT_RESTARTS, seed=SEED)
    host_s = time.perf_counter() - t0
    mixed = policy == "mixed"
    rtol = None if mixed else DIAG_RTOL
    out = {"policy": policy, "load_s": load_s, "host_s": host_s,
           "counts": counts, "latency": latency,
           "fit": {"iterations": FIT_ITERATIONS, "restarts": FIT_RESTARTS,
                   "scan_points": FIT_SCAN_POINTS,
                   "landmarks": len(lnd_idx), "s": card["fit_s"],
                   "ms_per_iteration": card["fit_s"] * 1e3 / FIT_ITERATIONS,
                   "chamfer_mm2": fit["chamfer_mm2"],
                   "landmark_mse_mm2": fit["landmark_mse_mm2"],
                   "best_restart": fit["best_restart"],
                   "per_iteration": per_iter, "k8_launches": k8_per_fit}}
    out["diagnose_rel"] = max(compare_diagnoses(
        card["diagnose"][b], h_diag[b], f"{policy} diagnose B={b}", rtol)
        for b in REQUEST_SIZES)
    out["uncertainty_rel"] = compare_diagnoses(
        card["uncertainty"], h_unc, f"{policy} uncertainty", rtol)
    sal_err = 0.0
    for c, h in zip(card["saliency"], h_sal):
        check(c["label"] == h["label"], f"{policy} saliency label")
        hv = np.asarray(h["vertex_saliency_nats_per_mm"])
        sal_err = max(sal_err, float(np.abs(
            np.asarray(c["vertex_saliency_nats_per_mm"]) - hv).max())
            / float(np.abs(hv).max()))
    check(sal_err <= (MIXED_FIT_RTOL if mixed else SALIENCY_RTOL),
          f"{policy} saliency card vs host {sal_err:.3e} of its max")
    out["saliency_rel"] = sal_err
    card_plan = svc.plan(latent=card["plan"]["z_patient"])
    plan_err = max(float(np.abs(np.asarray(card_plan[k])
                                - np.asarray(h_plan[k])).max())
                   for k in ("z_3std", "z_2std", "z_1std", "z_mean_target"))
    check(plan_err <= DIAG_RTOL, f"{policy} plan key latents {plan_err:.3e}")
    mesh_err = max(float(np.abs(card_plan["target_meshes"][k]
                                - h_plan["target_meshes"][k]).max())
                   / float(np.abs(h_plan["target_meshes"][k]).max())
                   for k in h_plan["target_meshes"])
    check(mesh_err <= (MIXED_RTOL if mixed else SERVE_RTOL),
          f"{policy} plan meshes {mesh_err:.3e}")
    out["plan_rel"] = {"latents": plan_err, "meshes": mesh_err}
    fit_rel = abs(parity_fit["chamfer_mm2"] - h_fit["chamfer_mm2"]) \
        / h_fit["chamfer_mm2"]
    check(fit_rel <= (MIXED_FIT_RTOL if mixed else FIT_RTOL),
          f"{policy} fit chamfer card {parity_fit['chamfer_mm2']} vs host "
          f"{h_fit['chamfer_mm2']}")
    check(mixed or parity_fit["best_restart"] == h_fit["best_restart"],
          f"fit best restart card {parity_fit['best_restart']} vs host "
          f"{h_fit['best_restart']}")
    check(parity_fit["diagnosis"]["label"] == h_fit["diagnosis"]["label"]
          or mixed, "fit diagnosis label card vs host")
    # the counted fit goes on from where the held one stops: its best
    # restart's objective (10 x landmark MSE + chamfer) is no worse

    def objective(f):
        return 10.0 * f["landmark_mse_mm2"] + f["chamfer_mm2"]

    check(objective(fit) <= objective(parity_fit),
          f"{policy} fit: {FIT_ITERATIONS} iterations reach "
          f"{objective(fit)}, {FIT_PARITY_ITERATIONS} reach "
          f"{objective(parity_fit)}")
    out["fit_parity"] = {"iterations": FIT_PARITY_ITERATIONS,
                         "chamfer_rel": fit_rel,
                         "objective_mm2": objective(parity_fit),
                         "counted_objective_mm2": objective(fit),
                         "card_best": parity_fit["best_restart"],
                         "host_best": h_fit["best_restart"]}
    log(f"[9 diagnosis {policy}] load {load_s:.2f} s; diagnose p50 "
        f"{ {b: round(v['p50_ms'], 3) for b, v in latency.items()} } ms; "
        f"fit {FIT_ITERATIONS} it x {FIT_RESTARTS} restarts "
        f"{card['fit_s']:.2f} s ({per_iter['kernels_run']:.1f} kernels, "
        f"{per_iter['device_ms']:.3f} ms device per iteration), chamfer "
        f"{fit['chamfer_mm2']:.4f} mm²; card vs host: diagnose "
        f"{out['diagnose_rel']:.2e}, saliency {sal_err:.2e}, plan "
        f"{plan_err:.2e}, fit chamfer {fit_rel:.2e} (best "
        f"{parity_fit['best_restart']}/{h_fit['best_restart']}); host "
        f"{host_s:.1f} s")
    del host
    out["passes"] = {k: dict(v) for k, v in passes.items()}
    return dict(out=out, svc=svc, scans=scans, shapes=shapes)


def http_once(svc, scans: dict) -> dict:
    """The HTTP entry point once: a server on a free local port, one
    ``POST /diagnose`` and one ``GET /healthz``, then stopped."""
    import threading
    import urllib.request

    from craniofacialsd_vae_tpu_torch.serve import make_server

    server = make_server(svc, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_port}"
    try:
        body = json.dumps({"vertices": scans[3].tolist()}).encode()
        req = urllib.request.Request(url + "/diagnose", data=body,
                                     headers={"Content-Type":
                                              "application/json"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=300) as resp:
            reports = json.loads(resp.read())["reports"]
        post_ms = (time.perf_counter() - t0) * 1e3
        with urllib.request.urlopen(url + "/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    check(not thread.is_alive(), "the HTTP server did not stop")
    direct = svc.diagnose(scans[3])
    check([r["label"] for r in reports] == [r["label"] for r in direct],
          "HTTP /diagnose labels differ from the service's")
    check(health["ok"] and health["device"] == str(svc.device),
          f"/healthz {health}")
    return {"post_diagnose_ms": post_ms, "requests": health["requests"]}


def phase_diagnosis(torch, mods, runs: dict) -> dict:
    """Phase 9: phases 7's and 8's run dirs served on the card through
    ``DiagnosisService.from_run_dir`` (see the module docstring)."""
    t0 = time.perf_counter()
    q = FIT_SCAN_POINTS // 4
    shapes = {"fit": k8_case(torch, mods, FIT_RESTARTS, FIT_GEN_POINTS, q,
                             50),
              "one": k8_case(torch, mods, 1, FIT_GEN_POINTS, q, 50)}
    torch.cuda.empty_cache()
    results, path_shapes = {}, {}
    for policy, run_dir in runs.items():
        res = diagnosis_run(torch, mods, run_dir, policy)
        if policy == "fp32":
            res["out"]["http"] = http_once(res["svc"], res["scans"])
        results[policy] = res["out"]
        path_shapes[policy] = res["shapes"]
        del res
        torch.cuda.empty_cache()
    records = []
    for policy, path in (("fp32", "diagnosis"), ("mixed", "mixed_diagnosis")):
        counts = results[policy]["counts"]
        for kernel, entries in path_shapes[policy].items():
            rec = summarize(kernel, *KERNEL_SOURCES[kernel], entries)
            rec.update(path=path, launches=counts[kernel])
            records.append(rec)
        fwd = summarize("k8_fwd", *KERNEL_SOURCES["k8_fwd"], [shapes["fit"]])
        bwd = summarize("k8_bwd", *KERNEL_SOURCES["k8_bwd"],
                        [shapes["fit"]["bwd"]])
        fwd["parity_only"] = [shapes["one"]]
        for rec in (fwd, bwd):
            rec.update(path=path, launches=counts[rec["name"]])
            records.append(rec)
    line = {"phase": "diagnosis",
            "k8": {k: {"fwd_ms": s["ms"], "fwd_plain_ms": s["plain_ms"],
                       "fwd_cdist_ms": s["library_ms"],
                       "fwd_bound_ms": s["bound_ms"],
                       "bwd_ms": s["bwd"]["ms"],
                       "bwd_bound_ms": s["bwd"]["bound_ms"],
                       "csr_ms": s["bwd"]["csr_ms"]}
                   for k, s in shapes.items()},
            **{policy: {k: v for k, v in r.items() if k != "counts"}
               for policy, r in results.items()},
            "seconds": time.perf_counter() - t0}
    log(json.dumps(line, default=float))
    return dict(line=line, records=records, shapes=shapes, runs=results,
                path_shapes=path_shapes)


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
    from craniofacialsd_vae_tpu_torch.ops import distances, sparse
    from craniofacialsd_vae_tpu_torch.models import (SDVAEConfig,
                                                     SpiralGeometry,
                                                     init_sdvae)
    from craniofacialsd_vae_tpu_torch.viz import raster

    mods = {"kernels": kernels, "ops": ops, "raster": raster,
            "sparse": sparse, "distances": distances}
    name, smi_line = phase_device(torch)
    build_s, build_log = phase_build(kernels)

    bundle = load_bundle(os.path.join(ROOT, "tests", "fixtures",
                                      "geometry.npz"))
    config = SDVAEConfig.from_dict(MODEL_CONFIG, KL_WEIGHT)
    geom = SpiralGeometry.from_bundle(bundle, device=DEVICE)
    model = init_sdvae(config, geom, torch.Generator().manual_seed(SEED))
    records = [*k1_parity(torch, mods, model, geom, build_log),
               k4_parity(torch, mods, model, geom, bundle)]
    k7 = k7_parity(torch, mods, bundle)
    del model, geom
    torch.cuda.empty_cache()

    serve = phase_serving(torch, mods, bundle, config)
    batch = serve["k7_batch"]
    rec = summarize("raster_sweep", "csrc/raster_sweep.cu",
                    "craniofacialsd_vae_tpu/viz/raster_pallas.py:111",
                    [batch])
    rec.update(bound_strip_ms=batch["bound_strip_ms"], solo=k7["solo"],
               parity_only=k7["parity_only"])
    records.append(rec)
    for rec in records:
        rec["path"] = "serving"
        rec["launches"] = serve["counts"][rec["name"]]
        check(rec["launches"] > 0,
              f"{rec['name']} was not launched on the serving path")
    torch.cuda.empty_cache()

    train = phase_training(torch, mods, bundle, config, k1_ptxas(build_log))
    train_records = training_records(records, train)
    for rec in train_records:
        rec["path"] = "training"
        rec["launches"] = train["counts"][rec["name"]]
        check(rec["launches"] > 0,
              f"{rec['name']} was not launched on the training path")
    records += train_records
    for kernel in FP32_KERNELS:
        check(serve["counts"][kernel] + train["counts"][kernel] > 0,
              f"{kernel} was not launched on the serving or training path")
    check({r["name"] for r in records} == set(FP32_KERNELS),
          "the kernels' record does not list every float32 kernel")
    log(f"[6 counts] serving {serve['counts']}; training step "
        f"{train['counts']}; total {time.perf_counter() - t_start:.1f} s")
    torch.cuda.empty_cache()

    root = tempfile.mkdtemp(prefix="cfsdvae_entry_")
    try:
        entry = phase_train_entry(torch, mods, k1_ptxas(build_log),
                                  k7["solo"], root)
        records += entry["records"]
        log(f"[7 entry] done; total {time.perf_counter() - t_start:.1f} s")
        torch.cuda.empty_cache()
        mixed = phase_mixed(torch, mods, bundle, serve, train,
                            k1_ptxas(build_log), root, entry["cfg_path"],
                            config)
        records += mixed["records"]
        log(f"[8 mixed] done; total {time.perf_counter() - t_start:.1f} s")
        torch.cuda.empty_cache()
        diagnosis = phase_diagnosis(torch, mods, {
            "fp32": entry["run_dir"], "mixed": mixed["entry"]["run_dir"]})
        records += diagnosis["records"]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check({r["name"] for r in records} == set(kernels.KERNEL_NAMES),
          "the kernels' record does not list every kernel")
    log(f"[9 diagnosis] done; total {time.perf_counter() - t_start:.1f} s")
    serve.pop("inputs")

    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"device": name, "nvidia_smi": smi_line,
                       "torch": torch.__version__, "build_s": build_s,
                       "kernels": records, "serving": serve,
                       "training": train,
                       "train_entry": {k: entry[k] for k in (
                           "line", "card_vs_host", "k7", "history")},
                       "mixed": {k: mixed[k] for k in (
                           "line", "shapes", "serving", "training",
                           "gather_first", "entry")},
                       "diagnosis": {k: diagnosis[k] for k in (
                           "line", "shapes", "runs", "path_shapes")}},
                      f, indent=1, default=float)

    print(json.dumps({"kernels": [
        {k: r[k] for k in ("name", "path", "route", "source", "replaces",
                           "launches", "max_abs_err", "ms", "plain_ms",
                           "bound_ms", "bound_by", "library_ms")}
        for r in records]}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

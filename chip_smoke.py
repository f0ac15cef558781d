#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving, training, diagnosis,
augmentation, evaluation, parallel, ensemble and export paths and its
Sinkhorn divergence on one NVIDIA card.

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
   ``reconstruct`` requests of 1, 3, 16 and 20 scans (each bucket's CUDA
   graph captured at its first request, so its wrappers count its
   warm-up pass and its capture), checked against the
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
   bounds and ptxas's registers and spills per instance); on every
   backward table (the up-pools' transposes, the Laplacian and its
   transpose), the fused K4 where the table has overflow tiers and K4
   where it has none, held against their twins and timed (the fused
   launch also against K4 alone and K4 followed by the tiers' twin); and
   K2-dx at the eight convs with dx at B = 16 and B = 1 against its twin
   (DX_RTOL), timed beside its twin and the path it replaced (per column
   group a cuBLAS ``dg = dy @ W_gᵀ``, the capped K4 over ``dg``, the
   parts' adds), with its bound;
   (b) one counted ``make_train_step`` step on the card against the same
   step on the host (same weights, scans, region and noise): losses and
   every gradient leaf; (c) 10 warm steps (host-clock step time,
   throughput, finite losses) and a profiled step;
6. launch counts, read per path: K1, K4 and K7 must each have run during
   phase 4, and K1, K4, K2-dW, K2-dx and the fused K4 during phase 5's
   counted step (which must match ``expected_step_launches`` exactly); every
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
   checkpoint bit for bit; ``--resume --epochs 6`` goes on. The epochs run
   in chunks (``run_epochs_scanned``, the train and validation steps
   replayed from their CUDA graphs), and at each checkpoint the latent
   traversals run (their seconds in the line; their model passes and
   renders recorded, and their launches counted apart as the path
   ``train_entry_traversals``). K1, K2-dW, K4, the fused K4 and K7 must
   each have launched on that path outside the traversals. Then the
   per-epoch loop (``--profile``, which skips the chunks) from scratch to
   epoch 4: its checkpoint bit-equal to the chunked run's, both epoch
   times, the trace written; one
   epoch on the card is held against the host, K7 on a full-resolution
   reconstruction against its twin, and each kernel at the path's own
   shapes against its twin; the traversals' kernels (K1 and K4 at their
   decodes' batch, K7 at their renders') at those shapes against their
   twins, with the launches those shapes account for equal to the
   traversals', kernel for kernel; one ``{"phase": "train_entry", ...}``
   line;
8. the ``mixed`` policy of ``configurations/craniofacial.yaml`` (its
   model and optimisation sections, through the port's config reader):
   (a) every bf16 kernel at every shape of the mixed paths (K1-bf16
   through the op's vertex tiles, K3b, its backward
   ``out_gather_sum_bwd`` (also against the per-position transposes and
   stack it replaced) and K4-bf16 at B = 16, 4, 1; K3a through the
   vertex tiles at B = 16, 4, 1 on the fixture's and the octasphere's
   level 0, beside the untiled element path; K2-dW-bf16 through the
   vertex tiles at the grid; K4-bf16 or its capped form on every bf16
   backward table at the grid's and the other buckets' widths; K2-dx-bf16
   at every bf16 conv with dx and the final conv's gather-first form at
   the grid and at B = 1, beside the path it replaced), held
   against its twin (bit-equal where both round at the same points, else
   within one bf16 ulp; K3a within K3A_RTOL), timed against it and a library
   form, with its bound at 3.35 TB/s and 989 TFLOP/s bf16 and ptxas's
   registers and spills; (b) a mixed ``DiagnosisService(max_batch=16)``
   answers phase 4's requests and renders the error maps (counted), held
   against the same service on the host and phase 4's fp32 answers;
   (c) one counted mixed step (launches equal to
   ``expected_step_launches``) against the host's, its gradient against
   the card's fp32 step's, 10 warm steps and a profiled step beside
   phase 5's; the path of ``final_out_gather: false`` (K3a), counted;
   (d) ``train.main`` under ``mixed`` for 2 epochs on phase 7's
   workspace, resumed bit for bit, its traversal's kernels (K1-bf16,
   K4-bf16 and the final conv's K3b or K3a at its decodes' batch, K7 at
   its renders') held at their shapes and their launches accounted for
   as in phase 7 (path ``mixed_entry_traversals``); one ``{"phase":
   "mixed", ...}`` line.
   Phases 7 and 8's ``train.main`` also fit the classifier zoo and write
   ``classifiers.npz`` and ``z_stats.npz`` (fit time and the four
   validation accuracies recorded);
8g. graphs: under ``smoke.yaml``'s float32 model and the flagship's
   ``mixed``, on the fixture hierarchy, 10 replays of the train step's
   CUDA graph (``make_scanned_train_step``) against 10 eager steps from
   the same weights, scans and draws: parameters, Adam states and
   metrics bit-equal; one replay's kernels, counted from torch.profiler's
   CUDA kernel events, equal to ``expected_step_launches`` kernel for
   kernel; the step's p50 eager and replayed, the scanned call's time a
   step, their device time and idle share, meshes/s and the graph's peak
   memory; and a plain PyTorch step of ``benchmarks/baseline_torch.py``'s
   ``BaselineNet`` form (``index_select``, ``nn.Linear``,
   ``torch.sparse.mm``) on the fixture hierarchy, timed; one
   ``{"phase": "graphs", ...}`` line;
9. diagnosis: the reference's sklearn pickles of ``tests/fixtures/
   reference_pickles`` read with sklearn blocked and held against the
   fixture's outputs; K8 (one ``k8_fwd`` for both directions, one
   ``k8_bwd`` with its CSR built in the kernel) at the fit's shapes (16
   restarts of 4,097 points against 8,192), at one restart and against a
   target of 7,500 points padded to 8,192 with copies of its first,
   against its twins (distances within K8_D_RTOL of the largest, argmins
   where the best two are apart and the lowest index at the copies, the
   kernel's CSR equal to ``argmin_csr``'s, gradients within K8_G_RTOL
   card vs twin and card vs host, two launches bit for bit), timed
   against the twins, the bound and ``torch.cdist`` with both minima;
   then each of phase 7's (fp32) and phase 8's (mixed) run
   dirs served by ``DiagnosisService.from_run_dir`` on the card, counted
   (its encode and decode buckets and the fit's iteration as CUDA graphs,
   each counted at its warm-up and capture):
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
   for kernel; every bucket's graph of encode, decode and reconstruct
   against the eager program, bit for bit, and the graph fit against the
   eager fit (best restart, chamfer and z bit-equal), with the diagnose
   and reconstruct p50 at 1, 3, 16 and 20 scans and the fit's seconds
   both ways; the HTTP entry point once (``POST /diagnose``, ``GET
   /healthz``); one ``{"phase": "diagnosis", ...}`` line;
10. the study's data section from a raw dataset: K9 (``cheby_step``,
   the eigensolver's Chebyshev step) in its three call forms (the filter
   step, b = 0, the per-column residual) at the k = 1000 solve's shapes
   (16,386 × 1,125), over its vertex tiles and on the solver's padded
   panels, against its twin (bit-equal; on contiguous panels too) and
   itself (two launches bit-identical), timed against the twin, K4
   followed by torch's elementwise ops and ``torch.sparse.mm`` followed
   by them, with its bound and ptxas's registers; its stream-only floor
   (the filter step and a b = 0 step over a diagonal-only table, K = 1);
   the tiles (count, staged rows a vertex, the largest, a block's shared
   memory, blocks an SM, their build's seconds: the first build and a
   warm one's median within TILES_MAX_S);
   ``laplacian_eigendecomposition`` of the octasphere (subdivision 6) at
   k = 1000 through ``auto`` on the card: the Chebyshev path in
   CHEBY_PASSES passes (f64 residual below 1e-3, K9 launched passes × 82
   times, its tiles built within TILES_MAX_S), eigenvalues within
   CHEBY_RTOL of the float64 dense ones
   (``torch.linalg.eigvalsh`` on the card, timed), one profiled pass; the
   Chebyshev solver at CHEBY_GAP_K against ARPACK (eigenvalues 1e-4,
   subspace overlap 1e-4); ``auto``'s dense solve of subdivision 5
   against the host's; then, counted, ``train.main`` for one epoch from a
   fresh raw dataset (phase 7's 40 scans, no ``augmented/``) with the data
   section of ``configurations/craniofacial.yaml`` (``spectral_interp``,
   factor 2, balanced): the basis solved by K9 and cached in the dataset
   directory (the same passes, its tiles within TILES_MAX_S),
   ``augmented/`` generated and the extended list trained; the
   same generation on the host from a copy of the cached basis (the same
   file names, vertices within 1e-5 of the card's); a second
   ``train.main`` on a fresh precomputed dir and a direct basis request
   read the generated files and the cache with no K9 launch; one
   ``{"phase": "augmentation", ...}`` line;
11. evaluation: counted, ``python -m craniofacialsd_vae_tpu_torch.test
   --experiment standard`` (called in process) on phase 7's run dir on
   the card, timed with its parts (traversals, embeddings, generation,
   classifiers, reconstruction, both diversities), every JSON, PNG, PLY,
   SVG (parsed as XML), ``.npz`` and AVI (its RIFF chunks walked: the
   frames passed, as many ``idx1`` entries, each a JPEG) of the suite
   checked, K1 (both kernels), K4 and K7 launched and
   each model pass and render recorded (``PassShapes``); the suite again
   under torch.profiler (device time, idle share); each kernel at every
   shape the suite's passes and renders gave it (``pass_records``: K7 on
   the first meshes of each batch size it swept) against its twin and
   timed, with the launches those shapes account for equal to the
   suite's, kernel for kernel; every other experiment of the entry point
   on the card at its defaults, timed, on an output directory holding the
   suite's two figure states (``lda_emb_distributions.npz``,
   ``emb_all_train_dist.npz``), its files checked: videos (each walk's
   frames), boxplots and every overlay (the plan's walks on both
   embedding figures with their videos, the scan's projections, the pre
   → post arrows); then, on a
   card Tester and a host Tester of the same run dir, recon, the
   classifiers (their three JSON files equal), a plan and a pre/post pair
   of two test scans, saliency of SALIENCY_BATCH test meshes, the
   uncertainty of EVAL_DRAWS meshes with the same DIAG_SAMPLES draws
   injected, a fit of a FIT_SCAN_POINTS-point scan at
   FIT_PARITY_ITERATIONS (K8 counted) and ``compute_diversity`` at
   EVAL_DIVERSITY: labels equal, answers within SERVE_RTOL of each
   array's max, saliency within SALIENCY_RTOL of its max, the fit's
   chamfer within FIT_RTOL with the same best restart; recon and the
   classifiers on phase 8's ``mixed`` run dir within MIXED_RTOL, files
   equal; ``python -m craniofacialsd_vae_tpu_torch.batch_diagnose`` on the
   card over phase 9's 20 scans (as OBJ files) and one of the wrong size:
   its labels phase 9's ``diagnose``; the zoo refitted; phase 7's
   traversal files (videos and plots) at each save epoch; one
   ``{"phase": "evaluation", ...}`` line;
12. figures, on phase 7's run dir after phase 11 (counted, not a kernel
   path): t-SNE of the train and test latents on the card against the
   host from one start at sklearn's minimum of 250 iterations (P within
   TSNE_P_RTOL, the embedding within TSNE_RTOL of their max), then the
   Tester's t-SNE figures (1,000 iterations on the card); the JPEG of one
   traversal frame encoded from card tensors equal to the host's bytes;
   ``python -m craniofacialsd_vae_tpu_torch.
   visualize_in_batch`` on the run's octasphere template, the card's 16
   PLYs equal to the host's; one ``{"phase": "figures", ...}`` line with
   the seconds by part;
13. parallel (``craniofacialsd_vae_tpu_torch/parallel``), after the
   earlier phases, whose counts it leaves as they are: (b) ``train.main
   --data_parallel`` for one epoch on phase 7's workspace (one card: its
   own world-size-1 NCCL group, a file rendezvous in the run's
   directory), counted (path ``parallel_entry``), against the same
   epoch without it: losses, checkpoint, launches and replays equal;
   then in a
   world-size-1 NCCL group of this process (a) the data-parallel step
   and a PARALLEL_STEPS-step scanned epoch (the all-reduce inside the
   captured graph) against the single-device step and epoch from the
   same weights, scans and draws, metrics, parameters and Adam states
   bit-equal, counted (a step, the epoch's warm-up and capture, its
   replays: path ``parallel_training``); (d) ``VertexShardedModel`` at
   D = 1 on the fixture hierarchy (the training phase's model): a
   forward (B = VS_FWD_BATCH) and a train step against the unsharded
   model within VS_RTOL, a scanned epoch (the all_to_all, all_gather and
   all-reduce inside its graph) bit-equal to as many sharded steps,
   counted (``vertex_launches``: path ``vertex_sharded``), then every
   kernel at the sharded path's shapes against its twin; then (c)
   ``DiagnosisService(data_parallel=True)`` on phase 7's run dir over
   the card named PARALLEL_REPLICAS times (a replica each with its own
   graphs, as over as many cards), counted (path ``parallel_serving``):
   ``encode``, ``reconstruct`` and ``diagnose`` at every request size
   and a 250-iteration fit split between the replicas, the launches
   exactly those of the passes the path ran and of its fits, every
   kernel held at those shapes, every answer within
   PARALLEL_SERVE_RTOL of the single-device service's; step, epoch and
   request times beside the single-device ones; one
   ``{"phase": "parallel", ...}`` line. The records of
   ``parallel_training`` and ``parallel_entry`` are those of
   ``training`` and ``train_entry`` (the same shapes) with this phase's
   launches;
14. ensembles (``training/ensemble.py``, ``training/sweep.py``,
   ``serving.EnsembleService``), after phase 13, whose counts it leaves
   as they are, on phase 7's workspace and config (fp32): (a)
   ``train_ensemble.main`` in process, ENS_MEMBERS members × ENS_EPOCHS
   epochs in one chunk, counted (path ``ensembles``), each member's
   parameters, Adam states and metrics bit-equal to a solo
   ``ModelManager(seed=i)`` run of the same epochs, the training's
   launches and replays (up to the first ``use_member``) ENS_MEMBERS
   times a solo run's, each graph's capture ENS_MEMBERS times the solo
   graph's kernel for kernel, the solo train graph one step at the
   train entry path's grid, and after (d) one replay of each graph
   profiled (``check_replays``); (b) ``sweep.main`` over SWEEP_VARY
   (a weight decay > 0, then a 0.0 Laplacian weight), counted (path
   ``sweep``), each variant bit-equal to a solo run of its config (the
   0-weighted term's metric its unweighted value, 0.0 in the solo run),
   the training's launches and replays the two solo runs' plus the
   Laplacian's K4 launches that variant 1's body adds, and sweep.json
   ranked; (c) ``EnsembleService.from_ensemble_dir`` on (a)'s run dir,
   ``diagnose`` at B = 1 and 16 of phase 9's scans, counted (path
   ``ensemble_serving``): its model passes ENS_MEMBERS times one member
   service's, its launches exactly those of its passes, each kernel
   held at their shapes (``pass_records``), the consensus equal to
   ``summarize_ensemble`` of the member services' reports, the same
   service on the host within SERVE_RTOL (labels equal), one ``POST
   /diagnose`` and one refused single-model request through
   ``serve.py``'s server; (d) ``train_ensemble.main --shard_members``
   over the card named twice (a block and a graph a member), counted
   (path ``ensembles_sharded``): checkpoints, metrics, launches and
   replays equal to (a)'s; one ``{"phase": "ensembles", ...}`` line with
   the seconds a member-epoch beside a solo epoch, the K = 2 run's peak
   allocation, the consensus p50 at B = 16 beside one member's, and the
   phase's and the script's seconds; the phase fails past ENS_PHASE_S.
   The records of (a), (b) and (d) are ``train_entry``'s (the same
   model, grid and workspace) with this phase's launches, those of (c)
   its own;
15. export (``export.py``, the serving kernels as the custom ops of
   ``ops/library.py``), after phase 14, on phase 7's (fp32) and phase
   8's (mixed) run dirs: (a) ``export_run_dir`` on the card at buckets
   EXPORT_BUCKETS, its seconds by program and its artifacts' MB; (b) the
   artifact dir copied away, the run dir renamed aside, the copy loaded
   (``load_exported``) and ``encode``, ``decode`` and ``reconstruct``
   answered at B = 1, 16 and 17 (16 + 1), then the run dir restored;
   (c) those answers against the live ``DiagnosisService.from_run_dir``
   within EXPORT_RTOL and EXPORT_ATOL (error_mm EXPORT_ERR_ATOL_MM), the
   largest difference and whether they are bit-equal printed; (d) the
   launches of one exported ``reconstruct`` at bucket 16 (path
   ``export``, ``mixed_export``) equal, kernel for kernel, to one eager
   call of the live program at that bucket, each of the program's
   kernels (EXPORT_PROGRAM_KERNELS, and the mixed final conv's K3b or
   K3a) launched, and equal to what one encode and one decode at 16
   account for, each kernel held at those shapes against its twin; the
   reconstruct p50 at B = 16 exported, live graph and live eager; (e) on
   the host, ``convert_torch_checkpoint --reverse`` of the fp32 run's
   checkpoint and forward again (parameters and Adam state equal) and
   ``make_synthetic_dataset --n SYNTH_MESHES`` (its OBJs parsed); one
   ``{"phase": "export", ...}`` line with the phase's and the script's
   seconds; the phase fails past EXPORT_PHASE_S;
16. sinkhorn (``ops.sinkhorn_divergence``, K8-sinkhorn), counted (path
   ``sinkhorn``: one ``sinkhorn_fwd`` a forward, one ``sinkhorn_bwd``):
   (a) the forward at SINKHORN_P points (the octasphere of subdivision
   6) against SINKHORN_Q (a deformed scan of it), ε = SINKHORN_EPS,
   within SINKHORN_RTOL of the twin on the card, both timed; (b) the
   gradient at SINKHORN_GRAD against the twin's autograd within
   SINKHORN_GRAD_RTOL of its max, the backward kernel timed against the
   twin's backward; (c) ``tests/test_distances.py``'s two cases; one
   ``{"phase": "sinkhorn", ...}`` line with the phase's and the script's
   seconds; the phase fails past SINKHORN_PHASE_S. The script then
   prints its total seconds.

Every time the new phases print stands beside the card's name and
power limit from nvidia-smi.

The kernels' record holds one entry per kernel and path (``serving``,
``training``, ``train_entry``, ``train_entry_traversals``,
``mixed_serving``, ``mixed_training``, ``mixed_gather_first``,
``mixed_entry_traversals``, ``diagnosis``, ``mixed_diagnosis``,
``augmentation``, ``evaluation``, ``parallel_training``,
``parallel_entry``, ``parallel_serving``, ``vertex_sharded``,
``ensembles``, ``sweep``, ``ensemble_serving``, ``ensembles_sharded``,
``export``, ``mixed_export``, ``sinkhorn``), each
timed over the shapes of that
path's launches (on the traversal, diagnosis and evaluation paths each
distinct shape once; every shape carries its launches). Its
``launches`` are the wrappers' counts on the path's counted run, which
count a CUDA graph's warm-up and capture but not its replays (a replay
launches the captured kernels without the wrappers); ``replayed`` is
what the graphs' replays launched on that run: each replay adds what its
capture recorded, and right after the run one replay of every graph the
path holds (the service's buckets, the fits, the managers' scanned
steps) is profiled, its kernels held equal to that record. A
``*_traversals`` path is the part of phase 7's or 8's counted run made
inside the latent traversals (the counts' growth across each), and
``train_entry`` is the rest of phase 7's run. The last three
lines of standard output are the kernels' JSON record, the nvidia-smi
line and ``{"ok": true, "device": {...}}``.
``--json`` also writes every measurement (per shape, per request size,
the profiles) to PATH. Nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import csv
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
K8_OPS_PER_PAIR = 9             # one pair matrix: three FMAs (6 flops),
#                                 the add of the norms, a compare for
#                                 each direction
FIT_PAD_POINTS = 7500           # a target that pads to the bucket 8,192
K8_BWD_OPS_PER_POINT = 10       # a difference, its scale and the sum
K8_D_RTOL = 1e-5                # K8 vs twin, against max d: another FMA
#                                 order than the twin's expansion
K8_G_RTOL = 1e-4                # K8's gradients, against their max
DIAG_RTOL = 1e-4                # card vs host: posteriors, Mahalanobis,
#                                 uncertainty statistics, plan latents
SALIENCY_RTOL = 1e-3            # card vs host saliency, against its max
FIT_RTOL = 1e-3                 # card vs host fit chamfer (fp32)
PICKLE_RTOL = 1e-10             # the reference pickles' outputs vs the
#                                 fixture's: the same numpy code on the
#                                 same arrays
PICKLE_REGIONS = {"r0": (0, 3), "r1": (3, 6)}   # the fixture's regions
MIXED_FIT_RTOL = 5e-2           # card vs host fit chamfer and saliency
#                                 (mixed): the JAX package's tolerance for
#                                 the policy
# phase 10: the eigensolver (K9) and the study's data section
CHEBY_K = 1000                  # the augmentation basis
CHEBY_GAP_K = 31                # the largest k ≤ 32 in a gap of the
#                                 octasphere's spectrum (multiplets of up
#                                 to 3 cut elsewhere leave the subspace
#                                 undefined; tests/test_torch_eigh.py)
CHEBY_ACCEPT = 1e-3             # f64 residual: JAX's acceptance
CHEBY_RTOL = 1e-6               # k = 1000 eigenvalues vs the f64 dense ones
CHEBY_PASSES = 2                # the k = 1000 solve's passes on the octasphere
TILES_MAX_S = 0.015             # K9's tile build at 16,386 vertices
CHEBY_GAP_RTOL = 1e-4           # k = 31 eigenvalues vs ARPACK
OVERLAP_ATOL = 1e-4             # O Oᵀ against I for two orthonormal bases
DENSE_SUBDIVISIONS = 5          # 4,098 vertices: auto takes the dense solve
DENSE_TOL = 1e-4                # its eigenvalues card vs host, rtol and atol:
#                                 fp32 eigh, JAX's tolerance for its dense
#                                 backend (test_dense_matches_scipy_small)
AUG_RTOL = 1e-5                 # card vs host generated vertices, of max |v|
FP32_KERNELS = ("spiral_conv_tc", "spiral_conv_narrow", "ell_matmul_fwd",
                "raster_sweep", "spiral_conv_dw", "ell_matmul_capped",
                "spiral_conv_dx")
MIXED_KERNELS = ("spiral_conv_bf16", "spiral_conv_f32out",
                 "spiral_conv_dw_bf16", "ell_matmul_bf16",
                 "ell_matmul_capped_bf16", "out_gather_sum",
                 "out_gather_sum_bwd", "spiral_conv_dx_bf16")
DX_RTOL = 1e-5          # K2-dx vs its twin, against max |dx|: 3xTF32
#                         products against the twin's fp32 product of the
#                         same du (K2-dx-bf16: one bf16 ulp, ``ulps``)
REPLACED_DX_RTOL = 1e-4  # the replaced bmm + capped K4 + adds vs K2-dx's
#                          twin, against max |dx| (fp32; bf16: MIXED_RTOL)
SINKHORN_P = 16386      # phase 16 (a): the octasphere of subdivision 6
SINKHORN_Q = 32768      # ... against a scan of FIT_SCAN_POINTS points
SINKHORN_GRAD = (2048, 4096)   # (b): a size whose twin's tape fits
SINKHORN_EPS = 0.05
SINKHORN_ITERS = 50
SINKHORN_RTOL = 1e-4    # (a) K8-sinkhorn vs its twin, relative: the
#                         exponents formed in another order, base 2
SINKHORN_GRAD_RTOL = 1e-3   # (b) gradients vs the twin's autograd, of
#                             their max: 50 fp32 iterations (the twin is
#                             up to 4.6e-4 off a float64 run of itself,
#                             tests/test_torch_sinkhorn.py)
SINKHORN_FWD_OPS = 14   # FP32 operations a pair and pass: the cost (3
#                         products and an add, 7 flops, and the clamp),
#                         the exponent (an FMA), its exponential, the max
#                         and the sum
SINKHORN_BWD_OPS = 30   # ... a backward pass: the cost, two exponents and
#                         exponentials, nine accumulations
SINKHORN_PHASE_S = 60.0

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
    "spiral_conv_dx": ("csrc/spiral_conv_dx.cu",
                       "craniofacialsd_vae_tpu/ops/spiral_conv.py:181"),
    "spiral_conv_dx_bf16": ("csrc/spiral_conv_dx.cu",
                            "craniofacialsd_vae_tpu/ops/spiral_conv.py:181"),
    "sinkhorn_fwd": ("csrc/sinkhorn.cu",
                     "craniofacialsd_vae_tpu/ops/distances.py:103"),
    "sinkhorn_bwd": ("csrc/sinkhorn.cu",
                     "craniofacialsd_vae_tpu/ops/distances.py:103"),
    "k8_fwd": ("csrc/distances.cu",
               "craniofacialsd_vae_tpu/ops/distances.py:32"),
    "k8_bwd": ("csrc/distances.cu",
               "craniofacialsd_vae_tpu/ops/distances.py:32"),
    "cheby_step": ("csrc/cheby_step.cu",
                   "craniofacialsd_vae_tpu/ops/eigh.py:64"),
    "raster_sweep": ("csrc/raster_sweep.cu",
                     "craniofacialsd_vae_tpu/viz/raster_pallas.py:111"),
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
    per warp), ``dw_sum`` (its chunk sum), ``bf16_elem<NT>`` (the element
    path of K1-bf16 and K3a), ``bf16_vec<NT,MT>`` (their tiled vector
    path), ``bf16_tile<VEC>`` (K3a's tiled kernel), ``dw_bf16<FN,UPW>``,
    ``dw_bf16_sum``, ``ell_bf16_vector<KK,CAPPED>``,
    ``ell_bf16_scalar<CAPPED>``, ``out_gather_sum`` (K3b),
    ``out_gather_sum_bwd`` and ``cheby_step<KK,HAS_P,VEC>`` (K9); the narrow
    kernels as ``narrow<CO,TBM>`` and
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
            bf = re.search(r"spiral_conv_bf16_kernelILi(\d+)EE",
                           m.group(1))
            bv = re.search(r"spiral_conv_bf16_vec_kernelILi(\d+)ELi(\d+)E",
                           m.group(1))
            dwb = re.search(r"spiral_conv_dw_bf16_kernelILi(\d+)ELi(\d+)E",
                            m.group(1))
            ell = re.search(r"ell_bf16_vectorILi(\d+)ELb(\d)E", m.group(1))
            ells = re.search(r"ell_bf16_scalarILb(\d)E", m.group(1))
            bt = re.search(r"spiral_conv_bf16_tile_kernelILb(\d)E",
                           m.group(1))
            k9 = re.search(r"cheby_tile_kernelILi(\d+)ELb(\d)ELb(\d)E",
                           m.group(1))
            name = (f"{k.group(1)}<{k.group(2)},{k.group(3)}>" if k
                    else f"narrow_tile<{nt.group(1)},{nt.group(2)},"
                    f"{nt.group(3)},{nt.group(4)}>" if nt
                    else f"dw<{dw.group(1)},{dw.group(2)}>" if dw
                    else "dw_sum" if "spiral_conv_dw_sum" in m.group(1)
                    else f"bf16_elem<{bf.group(1)}>" if bf
                    else f"bf16_vec<{bv.group(1)},{bv.group(2)}>" if bv
                    else f"dw_bf16<{dwb.group(1)},{dwb.group(2)}>" if dwb
                    else "dw_bf16_sum" if "spiral_conv_dw_bf16_sum"
                    in m.group(1)
                    else f"ell_bf16_vector<{ell.group(1)},{ell.group(2)}>"
                    if ell
                    else f"ell_bf16_scalar<{ells.group(1)}>" if ells
                    else f"bf16_tile<{bt.group(1)}>" if bt
                    else f"cheby_step<{k9.group(1)},{k9.group(2)},"
                    f"{k9.group(3)}>" if k9
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
        # the trace drops device events that seem to start before its
        # window opens (the card's clock against the host's): the first
        # kernels of a CUDA graph launched at once can be lost
        time.sleep(PROFILE_LEAD_S)
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
    reset_counts()
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
    counts = read_counts(torch, "serving")
    replays = check_replays(torch, graphs_of(svc), "serving")
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
    return dict(counts=counts, replays=replays, request_ms=req_ms,
                render_ms=render_ms,
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


def k2_parity(torch, mods, model, geom, batch: int, ptxas: list,
              convs=None) -> dict:
    """K2-dW at each conv's shape over a ``batch``-mesh grid, random x
    and dy: within K2_RTOL of the twin, two launches bit-equal, timed
    against the twin and the library form (``index_select`` of the L
    gathers, one ``einsum``), with its plan, both bounds (fp32 on the
    CUDA cores; 3xTF32 on the tensor cores, K1's form) and ptxas's
    registers and spills for the plan's instance. ``convs``: ``(name,
    conv, op)`` to hold instead of the model's (``model_convs``)."""
    kernels, ops = mods["kernels"], mods["ops"]
    regs = {k["kernel"]: k for k in ptxas}
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
    shapes = []
    for name, conv, op in (convs if convs is not None
                           else model_convs(model, geom)):
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
    carries a cotangent back through the up-pool before each decoder conv
    of ``names``, in the order autograd reaches them, in the deep dtype.
    A conv applies none: its dx is one K2-dx (``dx_convs``), and a
    matmul-first final conv gathers its fp32 dy through every position's
    transpose in its own kernel, ``out_gather_sum_bwd``."""
    tables = []
    for name, conv, op, dtype, form in reversed(conv_kinds(model, geom)):
        if name not in names:
            continue
        c_in, c_out = conv_widths(conv, op)
        if name.startswith("dec"):
            level = int(name[3:])
            up = geom.up[level]
            tables.append((f"up{level} T", up.transpose, up.shape[0],
                           batch * c_in, model.config.deep_dtype))
    return tables


def dx_convs(model, geom, names) -> list:
    """``(name, conv, op, dtype)`` of each conv of ``names`` whose dx is a
    K2-dx launch (K2-dx-bf16 for bf16 input), in the order autograd
    reaches them: every gather-first conv (the matmul-first final conv's
    dx is a plain product)."""
    return [(name, conv, op, dtype) for name, conv, op, dtype, form
            in reversed(conv_kinds(model, geom))
            if name in names and form != "out_gather"]


def dx_kernel(dtype) -> str:
    import torch

    return ("spiral_conv_dx_bf16" if dtype == torch.bfloat16
            else "spiral_conv_dx")


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


def k2dx_shape(torch, kernels, ops, gen, name, conv, op, batch,
               dtype) -> dict:
    """K2-dx (K2-dx-bf16 for bf16) at one conv's shape, random dy and the
    conv's weights in ``dtype``: within DX_RTOL of the twin (bf16: one
    bf16 ulp), two launches bit-equal, the replaced path (the package's
    ``k2dx_compare.replaced_dx``: JAX's form, cuBLAS ``dg``, the capped
    transposes and the adds) within REPLACED_DX_RTOL of the twin (bf16:
    MIXED_RTOL), each timed, with its plan and its bound
    (``k2dx_compare.dx_bound``: dy, w and the lists read once and dx
    written once, or the larger of the products' time on the tensor cores
    (3xTF32: three TF32 products; bf16: one) and the gathers' adds' time
    on the fp32 units, which run beside the tensor cores)."""
    from craniofacialsd_vae_tpu_torch.k2dx_compare import (dx_bound,
                                                            replaced_dx)
    seq = op.seq_length
    c_in, c_out = conv_widths(conv, op)
    bf16 = dtype == torch.bfloat16
    kernel = "spiral_conv_dx_bf16" if bf16 else "spiral_conv_dx"
    dy = torch.randn((op.num_vertices, batch, c_out), generator=gen,
                     device=DEVICE).to(dtype)
    w_l = conv.w.detach().to(dtype).reshape(seq, c_in, c_out).contiguous()
    tab = op.dx
    plan = kernels.plan_spiral_conv_dx(op.n_src, batch, seq, c_in, c_out,
                                       bf16)

    def launch():
        return kernels.spiral_conv_dx(dy, w_l, tab.ptr, tab.idx, op.n_src)

    with torch.inference_mode():
        out, again = launch(), launch()
        ref = ops.spiral_conv_dx_plain(dy, w_l, tab)
        old = replaced_dx(op, dy, w_l)
        torch.cuda.synchronize()
        check(torch.equal(out, again), f"{kernel} {name}: launches differ")
        scale = float(ref.float().abs().max())
        err = max_err(out.float(), ref.float())
        old_err = max_err(old.float(), ref.float())
        if bf16:
            u = ulps(torch, out, ref)
            check(u <= 1.0, f"{kernel} {name} B={batch}: {u:.2f} bf16 ulps "
                  "from its twin")
            check(old_err <= MIXED_RTOL * scale, f"{kernel} {name}: the "
                  f"replaced path is {old_err:.3e} from the twin")
        else:
            check(err <= DX_RTOL * scale, f"{kernel} {name} B={batch}: max "
                  f"|kernel - twin| {err:.3e} > {DX_RTOL} x {scale:.3e}")
            check(old_err <= REPLACED_DX_RTOL * scale, f"{kernel} {name}: "
                  f"the replaced path is {old_err:.3e} from the twin")
        ms = cuda_ms(torch, launch, 20)
        plain_ms = cuda_ms(torch, lambda: ops.spiral_conv_dx_plain(
            dy, w_l, tab), 3)
        old_ms = cuda_ms(torch, lambda: replaced_dx(op, dy, w_l), 10)
    bound = dx_bound(op, batch, c_in, c_out, bf16)
    b_ms, b_by = bound["ms"], bound["by"]
    log(f"[{kernel} {name}] {op.n_src}<-{op.num_vertices} x{batch} "
        f"{c_in}<-{c_out} ({plan.positions} positions a chunk, {plan.tv} "
        f"vertices x {plan.tb} batch rows a block, {plan.blocks} blocks, "
        f"{plan.smem} B smem): err {err:.2e} (max|dx| {scale:.2e}); kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f}, replaced bmm + capped K4 + "
        f"adds {old_ms:.4f} (err {old_err:.2e}), bound {b_ms:.4f} ({b_by})")
    return dict(conv=name, kernel=kernel, batch=batch, n_src=op.n_src,
                m=op.num_vertices, c_in=c_in, c_out=c_out,
                plan=dataclasses.asdict(plan), max_abs_err=err,
                rel_err=err / scale if scale else 0.0, ms=ms,
                plain_ms=plain_ms, library_ms=None, earlier_ms=old_ms,
                replaced_err=old_err, bound_ms=b_ms, bound_by=b_by,
                bytes=bound["bytes"], flops=bound["flops"],
                ops_ms=bound["ops_ms"])


def k2dx_parity(torch, mods, convs, batches, phase: str) -> dict:
    """K2-dx at each of ``convs`` (``(name, conv, op, dtype)``) at each
    of ``batches``: the first batch's shapes make the record (its
    ``earlier_ms`` the replaced path's), the others go in
    ``other_batches``."""
    kernels, ops = mods["kernels"], mods["ops"]
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 23)
    by_batch = {b: [k2dx_shape(torch, kernels, ops, gen, name, conv, op, b,
                               dtype) for name, conv, op, dtype in convs]
                for b in batches}
    shapes = by_batch[batches[0]]
    kernel = shapes[0]["kernel"]
    rec = summarize(kernel, *KERNEL_SOURCES[kernel], shapes)
    rec["other_batches"] = {b: by_batch[b] for b in batches[1:]}
    log(f"[{phase} {kernel}] per step at B = {batches[0]}: kernel "
        f"{rec['ms']:.4f} ms over {len(shapes)} convs, plain "
        f"{rec['plain_ms']:.4f}, replaced path (bmm + capped K4 + adds) "
        f"{rec['earlier_ms']:.4f}, bound {rec['bound_ms']:.4f} "
        f"({rec['bound_by']}); B = {batches[1:]} held too")
    torch.cuda.empty_cache()
    return rec


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
    and dx from plain products); per conv but the first (whose input is
    the data) and the matmul-first final conv, one K2-dx in its input's
    dtype; K4 in the deep dtype per up-pool; per table of
    ``step_tables`` in its dtype, K4 where it has no tiers and the fused
    K4 where it has."""
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
    names = [k[0] for k in conv_kinds(model, geom) if k[0] != "enc0"]
    for _, _, _, dtype in dx_convs(model, geom, names):
        counts[dx_kernel(dtype)] += 1
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
    names = [k[0] for k in conv_kinds(model, geom) if k[0] != "enc0"]
    dx = k2dx_parity(torch, mods, dx_convs(model, geom, names), (grid, 1),
                     "5")
    torch.cuda.empty_cache()

    data, region, eps = training_inputs(torch, bundle, config)
    n_scans = len(data)
    lr, wd = TRAIN_CONFIG["lr"], TRAIN_CONFIG["weight_decay"]
    step = make_train_step(model, weights,
                           coupled_adam(model.parameters(), lr, wd), b)

    # the main path: counts from 0, one step, counts read
    x = torch.as_tensor(data[:b], device=DEVICE)
    reset_counts()
    t1 = time.perf_counter()
    m_card = step(x, region_idx=region, eps=eps.to(DEVICE))
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t1) * 1e3
    counts = read_counts(torch, "training")
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
        f"{prof['device_ms']} ms in {prof['kernels_run']} kernels, idle "
        f"share {prof['idle_share']}; {top}")
    return dict(counts=counts, k2=k2, k4_backward=k4_main, capped=capped,
                dx=dx, first_step_ms=first_ms, host_step_ms=host_ms,
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
    without tiers, K2-dW, the fused K4 at the tables with tiers, K2-dx at
    the convs with dx."""
    grid = TRAIN_CONFIG["batch_size"] ** 2
    check(grid == BATCH, f"the swap grid ({grid}) is not the B = {BATCH} "
          "pass whose K1 and K4 times the training records reuse")
    by_name = {r["name"]: r for r in serving}
    k1 = [dict(by_name[n]) for n in ("spiral_conv_tc", "spiral_conv_narrow")]
    k4 = summarize("ell_matmul_fwd", "csrc/ell_matmul.cu",
                   "craniofacialsd_vae_tpu/ops/sparse.py:222",
                   by_name["ell_matmul_fwd"]["shapes"]
                   + train["k4_backward"])
    return [*k1, k4, train["k2"], train["capped"], train["dx"]]


# ----------------------------------------------------------------------
def entry_workspace(root: str, data: dict | None = None) -> str:
    """Phase 7's inputs under ``root``: the coloured octasphere template
    PLY, ``ENTRY_PER_CLASS`` OBJ scans of each class (a smooth per-class
    bump along the normal, a per-scan scale and per-vertex noise) and the
    text of ``configurations/smoke.yaml`` pointed at them, its data
    section's keys set from ``data`` (each key after
    ``augmentation_factor`` where smoke.yaml lacks it). Returns the
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
    for key, value in (data or {}).items():
        text, n = re.subn(rf"^(\s*){key}:[^\n]*", rf"\g<1>{key}: {value}",
                          text, flags=re.M)
        if not n:
            text, n = re.subn(r"^(\s*)(augmentation_factor:[^\n]*)",
                              rf"\g<1>\g<2>\n\g<1>{key}: {value}", text,
                              count=1, flags=re.M)
        check(n == 1, f"smoke.yaml: could not set data.{key}")
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
    fused K4, K2-dx and K7 at full resolution, each against its twin."""
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
    names = [k[0] for k in conv_kinds(model, geom) if k[0] != "enc0"]
    dx = k2dx_parity(torch, mods, dx_convs(model, geom, names), (grid,),
                     "7")
    recs = [summarize(kernel, "csrc/spiral_conv.cu",
                      "craniofacialsd_vae_tpu/ops/spiral_conv.py:159",
                      [s for s in k1 if s["kernel"] == kernel])
            for kernel in ("spiral_conv_tc", "spiral_conv_narrow")]
    recs.append(summarize("ell_matmul_fwd", "csrc/ell_matmul.cu",
                          "craniofacialsd_vae_tpu/ops/sparse.py:222",
                          ups + k4_main))
    recs += [k2, capped, dx,
             summarize("raster_sweep", "csrc/raster_sweep.cu",
                       "craniofacialsd_vae_tpu/viz/raster_pallas.py:111",
                       [k7])]
    return recs


def same_tree(a, b, what: str) -> None:
    """Two checkpoint trees (nested dicts and lists of arrays) equal leaf
    for leaf, bit for bit."""
    if isinstance(a, dict):
        check(isinstance(b, dict) and set(a) == set(b), f"{what}: keys")
        for k in a:
            same_tree(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)):
        check(isinstance(b, (list, tuple)) and len(a) == len(b),
              f"{what}: lengths")
        for i, (x, y) in enumerate(zip(a, b)):
            same_tree(x, y, f"{what}[{i}]")
    else:
        check(np.array_equal(np.asarray(a), np.asarray(b)),
              f"{what}: differs")


def phase_train_entry(torch, mods, ptxas: list, lr0_k7: dict,
                      root: str, smi: str) -> dict:
    """The port's training entry point end to end, on the card, from a
    template written under ``root``: ``train.main`` trains
    ``ENTRY_EPOCHS[0]`` epochs (renders, checkpoints and traversals on
    the cadence), a fresh manager resumes the last checkpoint bit for
    bit, ``main --resume`` goes on to ``ENTRY_EPOCHS[1]``; then (not
    counted) one epoch on the card against the host, K7 on a
    full-resolution reconstruction against its twin, and every kernel of
    the path at its shapes, the traversals' apart (``pass_records``). The
    workspace and its caches stay for phase 8."""
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
    # (the launches inside the traversals apart)
    reset_counts()
    trav = PassShapes(within=("latent_traversals",))
    t1 = time.perf_counter()
    with trav:
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
    # done with the first run's manager: its graphs' replays checked
    replays = [check_replays(torch, graphs_of(managers=[first["manager"]]),
                             "train_entry, first run")]
    del resumed, first["manager"]

    t1 = time.perf_counter()
    with trav:
        second = entry.main(argv + ["--resume", "--epochs",
                                    str(ENTRY_EPOCHS[1])])
    second_s = time.perf_counter() - t1
    counts = read_counts(torch, "train_entry")
    step_counts = {k: counts[k] - trav.launches[k] for k in counts}
    PATH_REPLAYS["train_entry"] = {k: v - trav.replayed[k] for k, v
                                   in PATH_REPLAYS["train_entry"].items()}
    PATH_REPLAYS["train_entry_traversals"] = trav.replayed
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
                   "spiral_conv_dw", "spiral_conv_dx", "raster_sweep"):
        check(step_counts[kernel] > 0,
              f"{kernel} was not launched on the train entry path")
    replays.append(check_replays(torch, graphs_of(
        managers=[second["manager"]]), "train_entry, resumed run"))
    del second["manager"]
    torch.cuda.empty_cache()

    # after the counted run: the per-epoch loop (``--profile`` skips the
    # chunks, as JAX's does) from scratch to the first run's last epoch:
    # its checkpoint bit-equal to the chunked run's, and its trace
    t1 = time.perf_counter()
    stepped = entry.main(["--config", cfg_path, "--id", "entry_steps",
                          "--output_path", root, "--device", DEVICE,
                          "--profile"])
    stepped_s = time.perf_counter() - t1
    s_ckpt = stepped["checkpoint_dir"]
    same_tree(read_checkpoint(os.path.join(s_ckpt, saved[-1])), model_file,
              "per-epoch loop vs chunks: model")
    same_tree(read_checkpoint(os.path.join(s_ckpt, "optimizer.ckpt")),
              opt_file, "per-epoch loop vs chunks: optimizer")
    trace = os.path.join(stepped["output_dir"], "profile", "trace.json")
    check(os.path.isfile(trace) and os.path.getsize(trace) > 0,
          "--profile wrote no trace")
    # epoch times (train and validation): the first chunk and the first
    # epoch capture the graphs; the loop's second epoch is profiled
    chunk_epoch = [h["epoch_s"] for h in first["history"]]
    step_epoch = [h["epoch_s"] for h in stepped["history"]]
    loops = {"chunked_epoch_s": chunk_epoch, "per_epoch_loop_s": step_epoch,
             "chunked_steady_s": chunk_epoch[ENTRY_CADENCE:],
             "per_epoch_loop_steady_s": step_epoch[2:],
             "per_epoch_run_s": stepped_s,
             "trace_mib": os.path.getsize(trace) / 2 ** 20}
    log(f"[7 entry] the per-epoch loop's checkpoint at epoch "
        f"{ENTRY_EPOCHS[0]} equals the chunked run's bit for bit; epoch "
        f"(train + validation) s, chunked {chunk_epoch} (the first chunk "
        f"captures), per-epoch loop {step_epoch} (the first captures, the "
        f"second is profiled); trace {loops['trace_mib']:.1f} MiB; {smi}")
    del stepped["manager"]
    torch.cuda.empty_cache()

    # card vs host, K7 at full resolution, the kernels at this path's
    # shapes
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
        rec["launches"] = step_counts[rec["name"]]
    # the traversals' kernels at their shapes, their launches the
    # traversals' own
    t1 = time.perf_counter()
    trav_records, _ = pass_records(torch, mods, card, trav,
                                   "train_entry_traversals", trav.launches)
    records += trav_records
    trav_held_s = time.perf_counter() - t1
    # the p50 of the epochs whose chunk captured no graph
    steady = sorted(loops["chunked_steady_s"])
    p50 = steady[len(steady) // 2]
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
        "epoch_p50_s": p50, "epoch_s": [h["epoch_s"] for h in hist],
        "loops": loops,
        "steps_per_epoch": steps, "steps_per_s": steps / p50,
        "meshes_per_s": steps * grid / p50,
        "train_tot": tots,
        "card_vs_host": {"worst_loss_rel": max(
            cvh["loss_rel_err"].values()),
            "worst_param_rel": max(cvh["param_rel_err"].values()),
            "card_epoch_s": cvh["card_epoch_s"],
            "host_epoch_s": cvh["host_epoch_s"]},
        "k7_full_res_ms": k7["ms"], "k7_lr0_ms": lr0_k7["ms"],
        "traversal_s": first["traversal_s"] + second["traversal_s"],
        "traversal_passes": {k: dict(v) for k, v in trav.passes.items()
                             if v},
        "traversal_launches": trav.launches,
        "traversal_kernels_held_s": trav_held_s,
        "zoo": {"fit_s": [first["classifiers_s"], second["classifiers_s"]],
                "validation_accuracy": second["classifier_accs"]},
        "launches": counts, "replayed": PATH_REPLAYS["train_entry"],
        "replays_checked": replays}
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
                   f32out=False, regs=None) -> dict:
    """One bf16 conv at one batch size, on bf16 x and the model's weights
    rounded to bf16, through the op's vertex tiles: K1-bf16 (its tiled
    vector path) within one bf16 ulp of its twin (K3a, the fp32 output,
    within K3A_RTOL of the max, and timed beside the untiled element path,
    within K3A_RTOL too), two launches bit-equal, timed against the twin
    and the library form (``index_select`` and one bf16 ``linear``), with
    the registers and spills of the instance it ran (``regs``: the
    kernels of ``k1_ptxas`` by name)."""
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
    tiles = op.tiles
    plan = kernels.plan_spiral_conv(m, batch, seq, c_in, c_out,
                                    x.data_ptr() % 4 == 0, True, bf16,
                                    tiles.n_tiles, tiles.max_rows)
    inst = (regs or {}).get(f"bf16_vec<{plan.nt // 8},{plan.mi}>"
                            if plan.path == "bf16" else "", {})
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
            check(plan.path == "bf16", f"K1-bf16 {name} B={batch}: plan "
                  f"{plan.path}, not the tiled vector kernel")
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
        f"{plan.path} ({plan.blocks} blocks, {plan.smem} B smem, tb "
        f"{plan.tb}, {plan.threads} threads"
        + (f", {plan.nt} columns a block, {plan.mi} row tiles a warp"
           if plan.path == "bf16" else "")
        + (f", {inst['registers']} registers, "
           f"{inst.get('spill_bytes', 0)} B spilled" if inst else "")
        + f"): err {err:.2e} (max|out| {scale:.2e}"
        + (f", {ulp:.2f} ulps" if ulp is not None else "")
        + f"); kernel {ms:.4f} ms"
        + (f", untiled element path {earlier_ms:.4f}" if f32out else "")
        + f", plain {plain_ms:.4f}, library {lib_ms:.4f}, bound "
        f"{b_ms:.5f} ({b_by}); kernel/library {ms / lib_ms:.2f}")
    rec = dict(conv=name, batch=batch, kernel=kernel, path=plan.path,
               plan=dataclasses.asdict(plan), n_src=op.n_src, m=m,
               c_in=c_in, c_out=c_out, max_abs_err=err, ulps=ulp, ms=ms,
               plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
               bound_by=b_by, bytes=nbytes, flops=flops, ops_ms=t_ops,
               registers=inst.get("registers"),
               spill_bytes=inst.get("spill_bytes", 0))
    if f32out:
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
    random fp32 cotangent in one launch over the op's runs, bit-equal to
    its twin, to the tile-order twin (which reads the runs) and to the
    form it replaced (each position's capped transpose, a fused K4 launch
    each, stacked), timed against both, and against the library form (one
    ``index_add_`` of the cotangent, repeated per position, into a zeroed
    ``[L·N, B·O]``; the repeat is made beforehand). The bound reads the
    runs' lists; ``bound_flat_ms`` is the bound with the flat tables the
    kernel read before the runs (``bwd.cols``, ``vals``, ``links``,
    ``info``) in their place."""
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
        tiles_ref = ops.out_gather_sum_bwd_tiles_plain(dout, bwd.runs)
        old = earlier().permute(2, 3, 0, 1)
        torch.cuda.synchronize()
        check(torch.equal(du, ref) and torch.equal(du, again),
              f"K3b backward B={batch}: kernel and twin differ at "
              f"{int((du != ref).sum())} values")
        check(torch.equal(du, tiles_ref), f"K3b backward B={batch}: kernel "
              "and the tile-order twin differ")
        check(torch.equal(du, old), f"K3b backward B={batch}: kernel and "
              "the stack of per-position transposes differ")
        del tiles_ref
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
    runs = bwd.runs
    entries = int(bwd.cols.numel())
    lists = 4 * sum(t.numel() for t in (runs.starts, runs.rows, runs.row_off,
                                        runs.blob, runs.blob_off, runs.pos))
    flat = 4 * (2 * entries + bwd.links.numel() + bwd.info.numel())
    nbytes = 4 * (dout.numel() + du.numel()) + lists
    flops = 2.0 * entries * batch * c_out
    b_ms, b_by, _, _ = bound(nbytes, flops)
    flat_ms = bound(nbytes - lists + flat, flops)[0]
    bs, smem, threads = kernels.out_gather_bwd_plan(runs, batch, c_out)
    log(f"[8 out_gather_sum_bwd B={batch}] {m}->{n} L={seq} "
        f"D={batch * c_out}, {entries} table entries in {runs.n_runs} runs "
        f"(at most {runs.max_verts} vertices, {runs.max_rows} rows; batch "
        f"slice {bs}, {smem} B smem, {threads} threads): bit-equal to the "
        f"twin, the tile-order "
        f"twin and the stack; kernel {ms:.4f} ms (one launch), per-position "
        f"transposes + stack {earlier_ms:.4f} ({seq - len(op.identity_cols)}"
        f" launches + stack), plain {plain_ms:.4f}, library {lib_ms:.4f}, "
        f"bound {b_ms:.5f} ({b_by}; {lists} bytes of runs), with the flat "
        f"tables {flat_ms:.5f} ({flat} bytes)")
    return dict(conv="final", batch=batch, kernel="out_gather_sum_bwd",
                n_src=n, m=m, c_out=c_out, max_abs_err=0.0, ms=ms,
                earlier_ms=earlier_ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=b_ms, bound_by=b_by, bound_flat_ms=flat_ms,
                bytes=nbytes, flops=flops, runs=runs.n_runs,
                max_rows=runs.max_rows, batch_slice=bs, smem=smem,
                threads=threads)


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
    """K2-dW-bf16 at one conv over a ``batch``-mesh grid, bf16 x and dy,
    through the op's vertex tiles: within one bf16 ulp of its chunk-order
    twin, two launches bit-equal, timed against the twin and the library
    form (``index_select`` of the L gathers, one bf16 ``einsum``)."""
    bf16 = torch.bfloat16
    seq, m = op.seq_length, op.num_vertices
    c_in, c_out = conv_widths(conv, op)
    x = torch.randn((op.n_src, batch, c_in), generator=gen,
                    device=DEVICE).to(bf16)
    dy = torch.randn((m, batch, c_out), generator=gen,
                     device=DEVICE).to(bf16)
    table, tiles = op.table, op.tiles
    plan = kernels.plan_spiral_conv_dw_bf16(
        m, batch, seq, c_in, c_out, tiles.n_tiles, tiles.max_rows,
        tiles.max_verts, x.data_ptr() % 16 == 0, dy.data_ptr() % 16 == 0)
    flat = table.t().reshape(-1)
    x2, d2 = x.view(op.n_src, -1), dy.view(-1, c_out)
    lib = lambda: torch.einsum(                          # noqa: E731
        "lnc,no->lco", x2.index_select(0, flat).view(seq, m * batch, c_in),
        d2)
    launch = lambda: kernels.spiral_conv_dw(             # noqa: E731
        x, table, dy, tiles=tiles)
    with torch.inference_mode():
        out, again = launch(), launch()
        ref = ops.spiral_conv_dw_chunked_plain(x, table, dy, plan, tiles)
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
            x, table, dy, plan, tiles), 3)
        lib_ms = cuda_ms(torch, lib, 5)
    nbytes = 2 * (x.numel() + dy.numel() + seq * c_in * c_out) \
        + 4 * table.numel()
    flops = 2.0 * seq * m * batch * c_in * c_out
    b_ms, b_by, t_ops = bound_bf16(nbytes, flops)
    inst = regs.get(f"dw_bf16<{plan.fn},{plan.upw}>", {})
    log(f"[8 K2-dW-bf16 {name}] {op.n_src}->{m} x{batch} {c_in}->{c_out} "
        f"({plan.n_chunks} chunks of {plan.tpc} tiles and {plan.bpc} "
        f"batch tiles x {plan.groups} "
        f"groups of {plan.positions} positions, {plan.warps} warps of "
        f"{plan.upw} units, batch tiles of {plan.tb}, {plan.smem} B smem, "
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
    0 (``ENTRY_SUBDIVISIONS``), K4-bf16 at the up-pools at each bucket, at
    the step's grid K2-dW-bf16 at every bf16 conv (and the final conv's
    gather-first form) and K4-bf16 or its capped form on every bf16
    backward table, and K2-dx-bf16 at every bf16 conv with dx (and the
    final conv's gather-first form) at the grid and at B = 1. Returns the
    shapes by kernel."""
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
            mixed_k1_shape(torch, kernels, ops, gen, name, conv, op, batch,
                           regs=regs)
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
    # K2-dx-bf16 at every bf16 conv with dx, the final conv's gather-first
    # form (C_out = 3) included, at the step's grid and at B = 1
    dx = [(name, conv, op, torch.bfloat16)
          for name, conv, op in [("final",) + final] + bf_convs[::-1]
          if name != "enc0"]
    for batch in (grid, 1):
        shapes["spiral_conv_dx_bf16"][batch] = [
            k2dx_shape(torch, kernels, ops, gen, name, conv, op, batch,
                       dtype) for name, conv, op, dtype in dx]
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
    reset_counts()
    answers = {b: svc.reconstruct(scans[b]) for b in REQUEST_SIZES}
    last = answers[REQUEST_SIZES[-1]]
    colors = errors_to_colors(last["vertex_errors_mm"][:, sel], 0,
                              ERROR_MAX_MM, "plasma") / 255.0
    errmap = render_batch(last["vertices"][:, sel], faces, colors,
                          image_size=IMAGE, shadeless=True, device=DEVICE)
    counts = read_counts(torch, "mixed_serving")
    replays = check_replays(torch, graphs_of(svc), "mixed_serving")
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
    return dict(counts=counts, replays=replays, card_vs_host_rel=host_err,
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
    reset_counts()
    m_card = step(x, region_idx=region, eps=eps.to(DEVICE))
    counts = read_counts(torch, "mixed_training")
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
    gather-first, K3a): one counted ``reconstruct`` of 16 scans (its
    bucket's graph captured: its warm-up passes and the capture) and one
    counted mixed step; K3a must launch in both, and the step's K2-dx-bf16
    at every conv with dx, the final conv's included."""
    from craniofacialsd_vae_tpu_torch.models import init_sdvae
    from craniofacialsd_vae_tpu_torch.serving import (WARMUP_PASSES,
                                                      DiagnosisService)
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
    reset_counts()
    ans = svc.reconstruct(rng.normal(size=(BATCH, n, 3)).astype(np.float32))
    m = step(torch.as_tensor(data[:b], device=DEVICE), region_idx=region,
             eps=eps.to(DEVICE))
    counts = read_counts(torch, "mixed_gather_first")
    replays = check_replays(torch, graphs_of(svc), "mixed_gather_first")
    want = expected_step_launches(model, geom, b * b)
    check(counts["spiral_conv_f32out"]
          == 1 + WARMUP_PASSES + want["spiral_conv_f32out"],
          f"K3a launches {counts['spiral_conv_f32out']} on the gather-first "
          "path")
    check(counts["spiral_conv_dx_bf16"] == want["spiral_conv_dx_bf16"],
          f"K2-dx-bf16 launches {counts['spiral_conv_dx_bf16']} on the "
          f"gather-first path, {want['spiral_conv_dx_bf16']} expected (the "
          "final conv's included)")
    check(np.isfinite(ans["vertices"]).all()
          and all(bool(torch.isfinite(v)) for v in m.values()),
          "gather-first mixed path: finite answers and losses")
    log(f"[8 mixed gather-first] launches {counts}")
    return dict(counts=counts, replays=replays)


def mixed_entry(torch, mods, root: str, cfg_path: str) -> dict:
    """Phase 8 (d): ``train.main`` with ``compute_dtype: mixed`` for 2
    epochs on phase 7's workspace and caches: finite losses, the run
    dir's checkpoint equal to the trained manager, a fresh manager
    resuming it bit for bit, and the traversal's kernels held at their
    shapes (``pass_records``)."""
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
    reset_counts()
    t0 = time.perf_counter()
    with PassShapes(within=("latent_traversals",)) as trav:
        run = entry.main(["--config", path, "--id", "entry_mixed",
                          "--output_path", root, "--device", DEVICE,
                          "--epochs", str(ENTRY_CADENCE)])
    run_s = time.perf_counter() - t0
    counts = read_counts(torch, "mixed_entry")
    PATH_REPLAYS["mixed_entry_traversals"] = trav.replayed
    for h in run["history"]:
        for phase in ("train", "validation"):
            check(all(np.isfinite(v) for v in h[phase].values()),
                  f"mixed entry epoch {h['epoch']} {phase} {h[phase]}")
    for kernel in ("spiral_conv_bf16", "ell_matmul_bf16",
                   "ell_matmul_capped_bf16", "spiral_conv_dw_bf16",
                   "spiral_conv_dx_bf16", "out_gather_sum",
                   "out_gather_sum_bwd", "raster_sweep"):
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
    replays = check_replays(torch, graphs_of(managers=[run["manager"]]),
                            "mixed_entry")
    # the traversal's kernels at their shapes, its launches its own
    records, _ = pass_records(torch, mods, run["manager"], trav,
                              "mixed_entry_traversals", trav.launches)
    del run["manager"], fresh
    return dict(run_s=run_s, train_tot=tots, counts=counts, replays=replays,
                records=records, traversal_s=run["traversal_s"],
                traversal_passes={k: dict(v) for k, v in trav.passes.items()
                                  if v},
                traversal_launches=trav.launches,
                epoch_train_s=[h["train_s"] for h in run["history"]],
                zoo={"fit_s": run["classifiers_s"],
                     "validation_accuracy": run["classifier_accs"]},
                run_dir=run["output_dir"])


def mixed_records(shapes: dict, serving: dict, training: dict,
                  gather_first: dict) -> list:
    """One record per new kernel and path: ``mixed_serving`` (K1-bf16,
    K4-bf16 and K3b over the B = 16 pass), ``mixed_training`` (the same
    forward shapes, K4-bf16 also on the backward tables without tiers,
    the capped K4-bf16, K2-dW-bf16 at the step's convs, K3b's backward,
    K2-dx-bf16 at its convs with dx) and ``mixed_gather_first`` (K3a and
    K2-dx-bf16, the final conv's included)."""
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
    dx = rec("spiral_conv_dx_bf16", "mixed_training",
             [s for s in shapes["spiral_conv_dx_bf16"][grid]
              if s["conv"] != "final"], tc)
    dx["other_batches"] = {1: shapes["spiral_conv_dx_bf16"][1]}
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
            dx,
            rec("spiral_conv_dx_bf16", "mixed_gather_first",
                shapes["spiral_conv_dx_bf16"][grid], gather_first["counts"]),
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
    records = mixed_records(shapes, serving, training, gather_first) \
        + ent["records"]
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
                      "zoo": ent["zoo"], "traversal_s": ent["traversal_s"],
                      "traversal_launches": ent["traversal_launches"]},
            "seconds": time.perf_counter() - t0}
    log(json.dumps(line))
    return dict(line=line, records=records, shapes=shapes, serving=serving,
                training=training, gather_first=gather_first, entry=ent)


# ----------------------------------------------------------------------
# phase 8g: the scanned paths' CUDA graphs against the eager step
# the CUDA kernels of csrc/*.cu by the launch-count name of the wrapper
# that launches them; a wrapper whose call launches two kernels is
# counted by one of them (K2-dW's and K2-dW-bf16's fixed-order sums, K8's
# pair pass, K8-sinkhorn's forward by its final sum), the ELL kernels by
# their CAPPED template argument and K2-dx by its bf16 one. K8-sinkhorn's
# backward has no kernel of its own once a call; no graph holds it.
CUDA_KERNELS = {
    "spiral_conv_tc_kernel": "spiral_conv_tc",
    "spiral_conv_narrow_kernel": "spiral_conv_narrow",
    "spiral_conv_narrow_tile_kernel": "spiral_conv_narrow",
    "spiral_conv_dw_sum": "spiral_conv_dw",
    "spiral_conv_dw_bf16_sum": "spiral_conv_dw_bf16",
    # K1-bf16 and K3a share these (f32out is an argument)
    "spiral_conv_bf16_kernel": "spiral_conv_bf16",
    "spiral_conv_bf16_vec_kernel": "spiral_conv_bf16",
    "spiral_conv_bf16_tile_kernel": "spiral_conv_bf16",
    "out_gather_sum_kernel": "out_gather_sum",
    "out_gather_sum_bwd_kernel": "out_gather_sum_bwd",
    "nearest_pairs_kernel": "k8_fwd",
    "nearest_sq_bwd_kernel": "k8_bwd",
    "raster_sweep_kernel": "raster_sweep",
    "cheby_tile_kernel": "cheby_step",
    "fixed_sum": "sinkhorn_fwd",
}
ELL_KERNELS = {"ell_matmul_direct": ("ell_matmul_fwd", "ell_matmul_capped"),
               "ell_matmul_scalar": ("ell_matmul_fwd", "ell_matmul_capped"),
               "ell_bf16_vector": ("ell_matmul_bf16",
                                   "ell_matmul_capped_bf16"),
               "ell_bf16_scalar": ("ell_matmul_bf16",
                                   "ell_matmul_capped_bf16"),
               "spiral_conv_dx_kernel": ("spiral_conv_dx",
                                         "spiral_conv_dx_bf16")}
GRAPH_STEPS = 10
PROFILE_LEAD_S = 0.01           # host time in the profiler before and
#                                 after fn
REPLAY_PREAMBLE_KERNELS = 32    # padding kernels before and after a
#                                 checked replay
BASELINE_REGION = (10, 15)      # baseline_torch.py's latent slice


def profile_kernels(torch, fn, lead_s: float = PROFILE_LEAD_S) -> dict:
    """One call of ``fn`` under torch.profiler, after a synchronization
    and ``lead_s`` of host time in the window (and as much after it):
    wall and device time, the device's idle share, and every CUDA kernel
    it ran by its full name (memory copies and sets apart)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # the trace drops device events that seem to start before its
        # window opens (the card's clock against the host's): the first
        # kernels of a CUDA graph launched at once can be lost
        time.sleep(lead_s)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        # and the same lead after it, before the window closes
        time.sleep(lead_s)
    kernels, busy, copies = {}, 0.0, 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA \
                or getattr(e, "is_user_annotation", False) \
                or e.self_device_time_total <= 0:
            continue
        busy += e.self_device_time_total / 1e3
        if e.key.startswith(("Memcpy", "Memset")):
            copies += e.count
        else:
            kernels[e.key] = kernels.get(e.key, 0) + e.count
    return {"wall_ms": wall_ms, "device_ms": busy,
            "idle_share": 1 - busy / wall_ms if wall_ms else None,
            "kernels_run": sum(kernels.values()), "copies": copies,
            "kernels": kernels}


def wrapper_counts(kernel_names: dict) -> dict:
    """The profiled kernels of ``csrc/`` by the launch-count names of
    ``kernels.KERNEL_NAMES`` (K3a folded into K1-bf16, which share their
    kernels)."""
    from craniofacialsd_vae_tpu_torch import kernels

    out = dict.fromkeys(kernels.KERNEL_NAMES, 0)
    for name, count in kernel_names.items():
        for base, wrapper in CUDA_KERNELS.items():
            if re.search(rf"(^|[\s:]){base}\s*[<(]", name):
                out[wrapper] += count
        for base, (plain, capped) in ELL_KERNELS.items():
            m = re.search(rf"(^|[\s:]){base}\s*<([^<>]*)>", name)
            if m:
                last = m.group(2).split(",")[-1].strip()
                out[capped if last == "true" else plain] += count
    return out


def fold_f32out(counts: dict) -> dict:
    out = dict(counts)
    out["spiral_conv_bf16"] += out.pop("spiral_conv_f32out")
    return out


#: the graphs' replays on each path's counted run: kernel launches by
#: launch-count name (what each replay's capture recorded, times its
#: replays), by path
PATH_REPLAYS: dict = {}


def reset_counts() -> None:
    """The wrappers' launch counts and the graphs' replay counts to 0."""
    from craniofacialsd_vae_tpu_torch import graphs, kernels

    kernels.launches.reset()
    graphs.replayed.reset()


def read_counts(torch, path: str) -> dict:
    """After a synchronization: the wrappers' launch counts since
    ``reset_counts``; the graphs' replayed launches go to
    ``PATH_REPLAYS[path]``."""
    from craniofacialsd_vae_tpu_torch import graphs, kernels

    torch.cuda.synchronize()
    PATH_REPLAYS[path] = graphs.replayed.snapshot()
    return kernels.launches.snapshot()


def graphs_of(svc=None, managers=()) -> list:
    """The captured graphs (``graphs.Captured``) a service holds (its
    buckets' and its manager's fits') and managers hold (their fits', their
    replicas' fits' and their scanned steps')."""
    from craniofacialsd_vae_tpu_torch.analysis import fitting

    out = []
    if svc is not None:
        out += [b.graph for b in svc._bucket_graphs.values()]
        managers = (*managers, svc.manager)
    for mgr in managers:
        # the fits of the manager's model and of its replicas
        for owner in (mgr, *fitting._REPLICAS.get(mgr, {}).values()):
            if owner in fitting._FIT_RUNS:
                out += [r.graph for r in fitting._FIT_RUNS[owner].values()]
        for fn in (getattr(mgr, "_scanned_step", None),
                   getattr(mgr, "_scanned_epochs", None)):
            if fn is not None:
                out += [r.graph for r in fn.steps.runners.values()]
    return [g for g in out if g is not None]


#: traces of one replay taken at most before ``check_replays`` gives up
#: on a trace that lost the padding on one side of the replay
REPLAY_PROFILE_TRIES = 6


def padding_kept(kernel_names: dict) -> tuple:
    """How many of the padding's kernels a trace kept before the replay
    (``atan_`` on one float) and after it (``asinh_``); no graph of the
    port runs either."""
    def count(op):
        return sum(n for k, n in kernel_names.items() if op in k)
    return count("atan"), count("asinh")


def check_replays(torch, captured: list, path: str) -> dict:
    """One replay of each graph under the profiler (outside the replay
    counts): the kernels of ``csrc/`` it ran, by launch-count name, equal
    to what its capture recorded, which each counted replay adds to
    ``PATH_REPLAYS``. The replay sits between two runs of padding
    kernels. The profiler can drop the first or the last device events of
    a window, hundreds of them late in a long process (PERF.md §7): the
    padding takes those losses, and a trace that kept none of the padding
    on one side may have lost the replay's own kernels there, so another
    replay is traced with four times the padding and four times the host
    time before and after it, at most REPLAY_PROFILE_TRIES in all. A
    replay of a train step's graph updates its model: call this when the
    run is done with it."""
    from craniofacialsd_vae_tpu_torch import kernels

    check(captured, f"{path}: no graph to replay")
    pad = torch.zeros(1, device=DEVICE)
    per_replay, lost = [], 0
    for g in captured:
        def replay(g, n_pad):
            for _ in range(n_pad):
                pad.atan_()
            torch.cuda.synchronize()
            g.cuda_graph.replay()
            torch.cuda.synchronize()
            for _ in range(n_pad):
                pad.asinh_()

        for attempt in range(REPLAY_PROFILE_TRIES):
            n_pad = REPLAY_PREAMBLE_KERNELS * 4 ** attempt
            prof = profile_kernels(torch, lambda g=g, n=n_pad: replay(g, n),
                                   PROFILE_LEAD_S * 4 ** attempt)
            kept = padding_kept(prof["kernels"])
            if min(kept) > 0:
                break
            lost += 1
            log(f"[replays {path}] a trace kept {kept} of the replay's "
                f"{n_pad} padding kernels before and after it: traced "
                "again")
        check(min(kept) > 0, f"{path}: {REPLAY_PROFILE_TRIES} traces of a "
              f"replay each lost the padding on one side; profiled "
              f"{ {k[:48]: v for k, v in prof['kernels'].items()} }")
        got = fold_f32out(wrapper_counts(prof["kernels"]))
        want = fold_f32out({**dict.fromkeys(kernels.KERNEL_NAMES, 0),
                            **g.launches})
        check(got == want, f"{path}: one replay ran the kernels {got}; "
              f"its capture recorded {want}; profiled "
              f"{ {k[:48]: v for k, v in prof['kernels'].items()} }")
        per_replay.append(sum(got.values()))
    log(f"[replays {path}] {len(captured)} graphs, one replay of each "
        f"profiled: its kernels of csrc/ are its capture's ({per_replay} "
        f"of them; {lost} traces retaken)")
    return {"graphs": len(captured), "csrc_kernels_per_replay": per_replay,
            "traces_retaken": lost}


def state_tensors(model, opt) -> list:
    out = [p.detach() for p in model.parameters()]
    for p in model.parameters():
        out += [opt.state[p][k] for k in sorted(opt.state[p])]
    return out


def timed(torch, fn, reps: int) -> list:
    """Host-clock ms of ``reps`` calls, each ended by a synchronization."""
    ts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return ts


def p50(ts: list) -> float:
    return sorted(ts)[len(ts) // 2]


def graph_step(torch, bundle, config, policy: str, smi: str) -> dict:
    """GRAPH_STEPS eager train steps against as many replays of the step's
    CUDA graph (``make_scanned_train_step``) from the same weights, scans
    and draws: parameters, Adam states and metrics bit-equal; one
    replay's kernels (profiled) equal to ``expected_step_launches``; the
    eager and replayed step's p50, device time and idle share, the whole
    scanned call's, and the peak memory of the graph's first call."""
    from craniofacialsd_vae_tpu_torch.models import init_sdvae
    from craniofacialsd_vae_tpu_torch.training import (
        LOSS_KEYS, LossWeights, coupled_adam, make_scanned_train_step,
        make_train_step)

    b = TRAIN_CONFIG["batch_size"]
    grid = b * b
    weights = LossWeights.from_config(TRAIN_CONFIG)
    lr, wd = TRAIN_CONFIG["lr"], TRAIN_CONFIG["weight_decay"]
    geom = training_geometry(bundle).to(DEVICE)
    data, _, _ = training_inputs(torch, bundle, config)
    data_dev = torch.as_tensor(data, device=DEVICE)
    rng = np.random.default_rng(SEED + 20)
    idx = rng.integers(0, len(data), size=(GRAPH_STEPS, b))
    gen_h = torch.Generator().manual_seed(SEED + 21)
    sids = np.arange(1, GRAPH_STEPS + 1)
    draws = {int(s): (int(torch.randint(0, N_REGIONS, (), generator=gen_h)),
                      torch.randn((grid, config.latent_size),
                                  generator=gen_h)) for s in sids}
    idx_dev = torch.as_tensor(idx, device=DEVICE)
    region_dev = torch.tensor([draws[int(s)][0] for s in sids],
                              device=DEVICE)
    eps_dev = torch.stack([draws[int(s)][1] for s in sids]).to(DEVICE)

    def fresh():
        model = init_sdvae(config, geom, torch.Generator().manual_seed(SEED))
        return model, coupled_adam(model.parameters(), lr, wd)

    def eager_step(t):
        return step(data_dev.index_select(0, idx_dev[t]),
                    region_idx=region_dev[t], eps=eps_dev[t])

    # eager: GRAPH_STEPS steps, each timed, their metrics summed
    model_a, opt_a = fresh()
    step = make_train_step(model_a, weights, opt_a, b)
    sums = torch.zeros(len(LOSS_KEYS), device=DEVICE)
    eager_ms = []
    for t in range(GRAPH_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = eager_step(t)
        torch.cuda.synchronize()
        eager_ms.append((time.perf_counter() - t0) * 1e3)
        sums += torch.stack([m[k].float() for k in LOSS_KEYS])
    want = {k: float(v) / GRAPH_STEPS for k, v in zip(LOSS_KEYS, sums.cpu())}

    # replayed: one scanned call of GRAPH_STEPS steps (warm-up, capture,
    # replays) from the same state
    model_b, opt_b = fresh()
    # later calls go on with step ids past GRAPH_STEPS: the same draws
    epoch = make_scanned_train_step(
        model_b, weights, opt_b, b,
        draws=lambda s, rows: draws[(s - 1) % GRAPH_STEPS + 1])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    got = epoch(data_dev, idx, sids)
    first_call_s = time.perf_counter() - t0
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    check(got == want, f"{policy}: replayed metrics {got} vs eager {want}")
    sa, sb = state_tensors(model_a, opt_a), state_tensors(model_b, opt_b)
    check(len(sa) == len(sb), f"{policy}: state sizes differ")
    for i, (x, y) in enumerate(zip(sa, sb)):
        check(torch.equal(x, y), f"{policy}: state tensor {i} differs "
              "between the eager and the replayed steps")
    runner = epoch.steps.runners[("train", False)]
    check(runner.graph is not None, f"{policy}: no graph was captured")

    # one replay's kernels against the eager step's launch counts
    prof_replay = profile_kernels(torch, runner.graph.replay)
    expected = expected_step_launches(model_b, geom, grid)
    replay_counts = wrapper_counts(prof_replay["kernels"])
    check(fold_f32out(replay_counts) == fold_f32out(expected),
          f"{policy}: one replay's kernels {replay_counts}, expected "
          f"{expected}")
    prof_eager = profile_kernels(torch, lambda: eager_step(0))
    same_kernels = prof_eager["kernels"] == prof_replay["kernels"]

    # times: the replay alone, the eager step, the scanned call per step
    replay_ms = timed(torch, runner.graph.replay, GRAPH_STEPS)
    t0 = time.perf_counter()
    epoch(data_dev, idx, sids + GRAPH_STEPS)
    call_ms = (time.perf_counter() - t0) * 1e3 / GRAPH_STEPS
    prof_call = profile_kernels(torch, lambda: epoch(
        data_dev, idx, sids + 2 * GRAPH_STEPS))
    out = {"policy": policy, "steps": GRAPH_STEPS, "bit_equal": True,
           "eager_p50_ms": p50(eager_ms), "eager_ms": eager_ms,
           "replay_p50_ms": p50(replay_ms), "replay_ms": replay_ms,
           "call_ms_per_step": call_ms, "first_call_s": first_call_s,
           "meshes_per_s_eager": grid / p50(eager_ms) * 1e3,
           "meshes_per_s_replay": grid / p50(replay_ms) * 1e3,
           "meshes_per_s_call": grid / call_ms * 1e3,
           "peak_mib": peak_mib, "replay_launches": replay_counts,
           "eager_kernels_equal_replay": same_kernels}
    for name, prof in (("eager", prof_eager), ("replay", prof_replay),
                       ("call", prof_call)):
        out[name + "_profile"] = {k: prof[k] for k in (
            "wall_ms", "device_ms", "idle_share", "kernels_run", "copies")}
    log(f"[8g graphs {policy}] {GRAPH_STEPS} replays bit-equal to "
        f"{GRAPH_STEPS} eager steps (parameters, Adam, metrics); one "
        f"replay's {prof_replay['kernels_run']} kernels match "
        f"expected_step_launches (eager step's kernels the same by name: "
        f"{same_kernels}); step p50 eager {out['eager_p50_ms']:.3f} ms, "
        f"replay {out['replay_p50_ms']:.3f} ms, scanned call "
        f"{call_ms:.3f} ms a step ({out['meshes_per_s_call']:.0f} "
        f"meshes/s); device ms eager {prof_eager['device_ms']:.3f} (idle "
        f"{prof_eager['idle_share']:.3f}), replay "
        f"{prof_replay['device_ms']:.3f} (idle "
        f"{prof_replay['idle_share']:.3f}), call of {GRAPH_STEPS} "
        f"{prof_call['device_ms']:.3f} of {prof_call['wall_ms']:.2f} wall "
        f"(idle {prof_call['idle_share']:.3f}); first call "
        f"{first_call_s:.2f} s, peak {peak_mib:.0f} MiB; {smi}")
    return out


def baseline_step(torch, bundle, smi: str) -> dict:
    """A plain PyTorch train step of ``benchmarks/baseline_torch.py``'s
    ``BaselineNet`` form (``index_select`` and ``nn.Linear`` spiral
    convs, ``torch.sparse.mm`` pools, its losses over a 16-mesh grid,
    Adam), built here from the fixture hierarchy and the stand-in
    Laplacian: the p50 of GRAPH_STEPS warm steps on the card."""
    from craniofacialsd_vae_tpu_torch.geometry import standin_laplacian_coo

    dev = DEVICE
    nn, F = torch.nn, torch.nn.functional

    def sparse(rows, cols, vals, shape):
        idx = torch.as_tensor(np.stack([rows, cols]), dtype=torch.long)
        return torch.sparse_coo_tensor(
            idx, torch.as_tensor(vals, dtype=torch.float32),
            tuple(shape)).coalesce().to(dev)

    def pool(x, trans):
        bsz = x.shape[0]
        stacked = x.transpose(0, 1).reshape(trans.shape[1], -1)
        out = torch.sparse.mm(trans, stacked)
        return out.reshape(trans.shape[0], bsz, -1).transpose(1, 0)

    class Conv(nn.Module):
        def __init__(self, c_in, c_out, spiral):
            super().__init__()
            self.idx = torch.as_tensor(spiral, dtype=torch.long, device=dev)
            self.layer = nn.Linear(c_in * self.idx.shape[1], c_out)

        def forward(self, x):
            g = torch.index_select(x, 1, self.idx.reshape(-1))
            return self.layer(g.view(x.shape[0], self.idx.shape[0], -1))

    spirals = bundle.spirals
    downs = [sparse(d.rows, d.cols, d.vals, d.shape) for d in bundle.down]
    ups = [sparse(u.rows, u.cols, u.vals, u.shape) for u in bundle.up]
    rows, cols, vals = standin_laplacian_coo(spirals[0])
    n = bundle.vertex_counts[0]
    lap = sparse(rows, cols, vals, (n, n))
    chans = (3, *MODEL_CONFIG["out_channels"])
    latent = MODEL_CONFIG["latent_size"]
    torch.manual_seed(SEED)
    en = nn.ModuleList(Conv(chans[i], chans[i + 1], spirals[i])
                       for i in range(4)).to(dev)
    nv = downs[-1].shape[0]
    mu_l = nn.Linear(nv * chans[-1], latent).to(dev)
    lv_l = nn.Linear(nv * chans[-1], latent).to(dev)
    dense = nn.Linear(latent, nv * chans[-1]).to(dev)
    de_ch = [(chans[4], chans[4]), (chans[4], chans[3]),
             (chans[3], chans[2]), (chans[2], chans[1])]
    de = nn.ModuleList(Conv(ci, co, spirals[3 - j])
                       for j, (ci, co) in enumerate(de_ch)).to(dev)
    final = Conv(chans[1], chans[0], spirals[0]).to(dev)
    params = [p for m in (en, mu_l, lv_l, dense, de, final)
              for p in m.parameters()]
    opt = torch.optim.Adam(params, lr=TRAIN_CONFIG["lr"])
    grid = TRAIN_CONFIG["batch_size"] ** 2
    bs = TRAIN_CONFIG["batch_size"]
    x = torch.randn(grid, n, 3, device=dev)
    lo, hi = BASELINE_REGION

    def step():
        opt.zero_grad()
        h = x
        for i, conv in enumerate(en):
            h = pool(F.elu(conv(h)), downs[i])
        h = h.reshape(h.shape[0], -1)
        mu, logvar = mu_l(h), lv_l(h)
        z = mu + torch.randn_like(mu) * torch.exp(0.5 * logvar)
        h = dense(z).view(-1, nv, chans[-1])
        for j, conv in enumerate(de):
            h = F.elu(conv(pool(h, ups[3 - j])))
        out = final(h)
        recon = F.mse_loss(out, x)
        kl = torch.mean(-0.5 * torch.sum(1 + logvar - mu ** 2
                                         - logvar.exp(), dim=1))
        lapl = (pool(out, lap).norm(dim=-1) / n).sum() / grid
        zf = z[:, lo:hi].view(bs, bs, -1)
        ze = torch.cat([z[:, :lo], z[:, hi:]], dim=1).view(bs, bs, -1)
        iu = torch.triu_indices(bs, bs, 1, device=dev)
        lg = ((zf[iu[0]] - zf[iu[1]]) ** 2).sum(-1).reshape(-1)
        dg = ((zf[:, iu[0]] - zf[:, iu[1]]) ** 2).sum(-1).T.reshape(-1)
        dr = ((ze[iu[0]] - ze[iu[1]]) ** 2).sum(-1).reshape(-1)
        lr = ((ze[:, iu[0]] - ze[:, iu[1]]) ** 2).sum(-1).T.reshape(-1)
        cons = (torch.clamp(lg - dg + 0.5, min=0).sum()
                + torch.clamp(lr - dr + 0.5, min=0).sum()) \
            / (bs ** 3 - bs ** 2)
        loss = recon + 1e-4 * kl + 0.1 * lapl + 0.5 * cons
        loss.backward()
        opt.step()
        return float(loss)

    first = step()
    check(np.isfinite(first), f"baseline step loss {first}")
    ms = timed(torch, step, GRAPH_STEPS)
    prof = profile_kernels(torch, step)
    out = {"p50_ms": p50(ms), "ms": ms, "meshes_per_s": grid / p50(ms) * 1e3,
           "device_ms": prof["device_ms"], "idle_share": prof["idle_share"],
           "kernels_run": prof["kernels_run"]}
    log(f"[8g baseline] plain PyTorch step of BaselineNet's form on the "
        f"fixture hierarchy: p50 {out['p50_ms']:.3f} ms "
        f"({out['meshes_per_s']:.0f} meshes/s), device "
        f"{prof['device_ms']:.3f} ms in {prof['kernels_run']} kernels, idle "
        f"{prof['idle_share']:.3f}; {smi}")
    return out


def phase_graphs(torch, bundle, config, smi: str) -> dict:
    """Phase 8g: the step's CUDA graph against the eager step under the
    float32 policy (``smoke.yaml``'s model) and the flagship's ``mixed``,
    and the plain PyTorch baseline step, on the fixture hierarchy."""
    t0 = time.perf_counter()
    runs = {"fp32": graph_step(torch, bundle, config, "fp32", smi)}
    torch.cuda.empty_cache()
    runs["mixed"] = graph_step(torch, bundle, flagship_config(), "mixed",
                               smi)
    torch.cuda.empty_cache()
    baseline = baseline_step(torch, bundle, smi)
    torch.cuda.empty_cache()
    line = {"phase": "graphs", "card": smi, "baseline": {
        k: baseline[k] for k in ("p50_ms", "meshes_per_s", "device_ms",
                                 "idle_share")}}
    for policy, r in runs.items():
        line[policy] = {k: r[k] for k in (
            "eager_p50_ms", "replay_p50_ms", "call_ms_per_step",
            "meshes_per_s_eager", "meshes_per_s_replay",
            "meshes_per_s_call", "peak_mib", "first_call_s")}
        for name in ("eager", "replay", "call"):
            p = r[name + "_profile"]
            line[policy][name + "_device_ms"] = p["device_ms"]
            line[policy][name + "_idle_share"] = p["idle_share"]
    line["seconds"] = time.perf_counter() - t0
    log(json.dumps(line))
    return dict(line=line, runs=runs, baseline=baseline)


# ----------------------------------------------------------------------
# phase 9: diagnosis serving from the run dirs of phases 7 and 8
def k8_bound(r: int, p: int, q: int) -> tuple:
    """One ``k8_fwd`` (both directions, one pair matrix): each point read
    once (the ``r`` generated clouds, the shared target), d and the
    argmin of both sides written once; K8_OPS_PER_PAIR operations a pair
    at the fp32 rate."""
    nbytes = (r * p * 3 + q * 3 + 3) * 4 + r * (p + q) * 8
    return nbytes, K8_OPS_PER_PAIR * r * p * q


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


def k8_case(torch, mods, r: int, p: int, q: int, reps: int,
            q_valid=None) -> dict:
    """K8 at one shape of the fit (``r`` restarts of ``p`` generated points
    against one target of ``q``; with ``q_valid``, the target's points
    from there on are copies of its first and their cotangents 0, as the
    fit pads and masks it): one k8_fwd (both directions) and one k8_bwd
    (the gradient in the generated side, its CSR built in the kernel)
    against their twins on the same CUDA tensors: distances within
    K8_D_RTOL of the largest, argmins equal where the best two distances
    are further apart than that and, at the padded copies, the lowest
    index; the kernel's CSR equal to ``argmin_csr``'s element for element;
    gradients within K8_G_RTOL of the largest against the twin over that
    CSR and against the host's autograd; a second launch of each bit for
    bit the first. Timed against the twins (the backward's twin with
    ``argmin_csr``, whose time is also kept apart) and, for the forward,
    against ``torch.cdist`` with both minima."""
    kernels = mods["kernels"]
    dist = mods["distances"]
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + r)
    x = torch.randn((r, p, 3), generator=gen, device=DEVICE) * 0.5 + 1.0
    y = torch.randn((q, 3), generator=gen, device=DEVICE) * 0.5 + 1.0
    if q_valid is not None:
        y[q_valid:] = y[0]
    mu = y.mean(0)
    out = {"restarts": r, "p": p, "q": q, "q_valid": q_valid or q}
    with torch.no_grad():
        d_x, d_y, a, b = kernels.nearest_sq_sym(x, y, mu)
        rx, ry, ra, rb = dist.nearest_dists_sq_sym_plain(x, y)
        again = kernels.nearest_sq_sym(x, y, mu)
        torch.cuda.synchronize()
        check(all(torch.equal(u, v) for u, v in zip((d_x, d_y, a, b),
                                                    again)),
              f"K8 fwd R={r}: two launches differ")
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
        if q_valid is not None:
            check(int((a >= q_valid).sum()) == 0
                  and torch.equal(b[:, q_valid:],
                                  b[:, :1].expand(-1, q - q_valid)),
                  f"K8 fwd R={r}: a padded copy is not tied to its first")
        out["separated_share"] = min(agree)
        out["max_abs_err"] = err

        def fwd():
            kernels.nearest_sq_sym(x, y, mu)

        def fwd_plain():
            dist.nearest_dists_sq_sym_plain(x, y)

        def fwd_library():
            d2 = torch.cdist(x, y[None].expand(r, q, 3)).square()
            return d2.amin(dim=2), d2.amin(dim=1)

        out["ms"] = cuda_ms(torch, fwd, reps)
        out["plain_ms"] = cuda_ms(torch, fwd_plain, max(reps // 10, 2))
        out["library_ms"] = cuda_ms(torch, fwd_library, max(reps // 10, 2))
        out["bytes"], out["flops"] = k8_bound(r, p, q)
        out["bound_ms"], out["bound_by"], _, _ = bound(out["bytes"],
                                                       out["flops"])

        # the backward in x, as the fit takes it
        gx = torch.randn((r, p), generator=gen, device=DEVICE)
        gy = torch.randn((r, q), generator=gen, device=DEVICE)
        if q_valid is not None:
            gy[:, q_valid:] = 0.0
        args = (x, y, mu, gx, d_x, a, gy, d_y)

        def bwd():
            return kernels.nearest_sq_bwd(*args, b)

        def bwd_plain():
            perm, off = dist.argmin_csr(b, p)
            return dist.nearest_sq_bwd_plain(*args, perm, off)

        dx, perm, off = kernels.nearest_sq_bwd(*args, b, csr=True)
        want_perm, want_off = dist.argmin_csr(b, p)
        dx_ref = bwd_plain()
        dx_again = bwd()
        torch.cuda.synchronize()
        check(torch.equal(perm, want_perm) and torch.equal(off, want_off),
              f"K8 bwd R={r}: the kernel's CSR differs from argmin_csr")
        check(torch.equal(dx, dx_again), f"K8 bwd R={r}: two launches differ")
        g_err = max_err(dx, dx_ref)
        check(g_err <= K8_G_RTOL * float(dx_ref.abs().max()),
              f"K8 bwd R={r}: |dx - twin| {g_err:.3e}")
        nb = (r * p * 3 + q * 3 + 3) * 4 + r * p * 12 + r * q * 12 \
            + r * p * 12
        ops = K8_BWD_OPS_PER_POINT * r * (p + q)
        b_bound, b_by, _, _ = bound(nb, ops)
        out["bwd"] = dict(
            max_abs_err=g_err, ms=cuda_ms(torch, bwd, reps),
            plain_ms=cuda_ms(torch, bwd_plain, max(reps // 10, 2)),
            csr_plain_ms=cuda_ms(torch, lambda: dist.argmin_csr(b, p), reps),
            library_ms=None, bytes=nb, flops=ops, bound_ms=b_bound,
            bound_by=b_by, longest_segment=int((off[:, 1:] - off[:, :-1])
                                               .max()))

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
    log(f"[9 K8 R={r} P={p} Q={q} valid {out['q_valid']}] fwd "
        f"{out['ms']:.4f} ms (plain {out['plain_ms']:.3f}, cdist "
        f"{out['library_ms']:.3f}, bound {out['bound_ms']:.4f} "
        f"{out['bound_by']}); bwd with its CSR {out['bwd']['ms']:.4f} ms "
        f"(plain {out['bwd']['plain_ms']:.3f}, of which argmin_csr "
        f"{out['bwd']['csr_plain_ms']:.4f}; bound "
        f"{out['bwd']['bound_ms']:.5f} {out['bwd']['bound_by']}; longest "
        f"segment {out['bwd']['longest_segment']}); errors d {err:.2e}, dx "
        f"{g_err:.2e}; argmins separated {out['separated_share']:.3f}")
    return out


def request_buckets(svc, n: int) -> list:
    """The batch buckets a request of ``n`` rows runs at: chunks of the
    service's ``max_batch``, each padded to its bucket."""
    return [svc._bucket(min(svc.max_batch, n - lo))
            for lo in range(0, n, svc.max_batch)]


def diagnosis_passes(svc) -> dict:
    """The model passes of ``diagnosis_requests`` that the wrappers see,
    each ``{batch: times}``: ``enc`` the encodes, ``dec`` the decodes,
    ``enc_bwd`` the backward to the data (saliency) and ``dec_bwd`` the
    backward to z (the fit). The service's encode and decode run as one
    CUDA graph per bucket and the fit's iteration as one graph, and a
    replay launches the captured kernels without their wrappers: so a
    bucket's program counts its warm-up passes and its capture at its
    first request and nothing after, the fit its warm-up iterations and
    its capture (then its final losses and its best restart, eagerly);
    the posterior draws and saliency run eagerly, a pass a request."""
    from collections import Counter

    from craniofacialsd_vae_tpu_torch.analysis.fitting import \
        WARMUP_ITERATIONS
    from craniofacialsd_vae_tpu_torch.serving import WARMUP_PASSES

    graphed = 1 + WARMUP_PASSES
    enc = Counter()
    # diagnose at every request size, the plan's patient: graphed
    for size in {b for n in (*REQUEST_SIZES, 1)
                 for b in request_buckets(svc, n)}:
        enc[size] += graphed
    for n in (3, SALIENCY_BATCH):      # posterior draws, saliency: eager
        enc.update(request_buckets(svc, n))
    fit_iters = WARMUP_ITERATIONS + 1
    dec = Counter({FIT_RESTARTS: fit_iters + 1})
    dec.update([1])                    # the fit's best restart
    for size in set(request_buckets(svc, 4)):     # the plan's key meshes
        dec[size] += graphed
    return {"enc": enc, "dec": dec,
            "enc_bwd": Counter(request_buckets(svc, SALIENCY_BATCH)),
            "dec_bwd": Counter({FIT_RESTARTS: fit_iters})}


def pass_convs(kinds: list, part: str) -> list:
    """The convs of ``conv_kinds`` an encode (``part`` "enc") or a decode
    ("dec", the final conv included) runs."""
    return [k for k in kinds if k[0].startswith(part)
            or (part == "dec" and k[0] == "final")]


def diagnosis_shapes(torch, mods, mgr, passes: dict) -> dict:
    """Every kernel of a path's model passes (the diagnosis path's, or
    those a ``PassShapes`` recorded) at every shape it has there, on the
    manager's model's weights and tables and random inputs, against its
    twin and timed against it and a library call (the checks of phases 3,
    5 and 8): the spiral convs of each pass at each of its buckets, the
    up-pools of each decode, and each backward's K2-dx at its convs (the
    first encoder conv's included: saliency's gradient reaches the data)
    and its up-pools' transposes.
    Returns ``{kernel: [shape, ...]}``, each shape with its ``launches``
    on the path (times the passes run it)."""
    kernels, ops = mods["kernels"], mods["ops"]
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
                else:
                    e = k2dx_shape(torch, kernels, ops, gen, name, conv, op,
                                   batch, dtype)
                    add(e, e["kernel"], times)
    torch.cuda.empty_cache()
    return shapes


class PassShapes:
    """While active, a path's model passes in ``diagnosis_passes``' form
    (``enc`` every ``SDVAE.encode`` call and ``dec`` every
    ``SDVAE.decode`` call, each by its batch; no backward) and its K7
    sweeps (each ``rasterize_batch`` call by its batch and image size,
    counted, the camera-frame meshes of its first call kept). With
    ``within`` (names of ``Tester`` methods) only inside those methods,
    whose launches and graph replays (the counters' growth across each
    call) add up in ``launches`` and ``replayed``."""

    def __init__(self, within: tuple = ()):
        from collections import Counter

        from craniofacialsd_vae_tpu_torch import graphs, kernels
        from craniofacialsd_vae_tpu_torch.analysis.tester import Tester
        from craniofacialsd_vae_tpu_torch.models.sdvae import SDVAE
        from craniofacialsd_vae_tpu_torch.viz import renderer

        self.counters = (kernels.launches, graphs.replayed)
        self.targets = (SDVAE, renderer, Tester)
        self.within = within
        self.depth = 0 if within else 1
        self.passes = {p: Counter() for p in ("enc", "dec", "enc_bwd",
                                              "dec_bwd")}
        self.k7: dict = {}
        self.launches = dict.fromkeys(kernels.KERNEL_NAMES, 0)
        self.replayed = dict.fromkeys(kernels.KERNEL_NAMES, 0)

    def __enter__(self):
        sdvae, renderer, tester = self.targets
        self.saved = {"encode": sdvae.encode, "decode": sdvae.decode,
                      "rasterize_batch": renderer.rasterize_batch,
                      **{n: getattr(tester, n) for n in self.within}}
        encode, decode, rast = (self.saved[n] for n in (
            "encode", "decode", "rasterize_batch"))

        def enc(model, x, *a, **kw):        # x vertex-major [N, B, 3]
            if self.depth:
                self.passes["enc"][x.shape[1]] += 1
            return encode(model, x, *a, **kw)

        def dec(model, z, *a, **kw):        # z [B, Z]
            if self.depth:
                self.passes["dec"][z.shape[0]] += 1
            return decode(model, z, *a, **kw)

        def sweep(verts_cam, faces, colors, image_size=256, **kw):
            if self.depth:
                entry = self.k7.setdefault(
                    (verts_cam.shape[0], image_size),
                    [verts_cam.detach().cpu().numpy(),
                     faces.detach().cpu().numpy(), 0])
                entry[2] += 1
            return rast(verts_cam, faces, colors, image_size=image_size,
                        **kw)

        def scoped(fn):
            def run(*a, **kw):
                before = [c.snapshot() for c in self.counters]
                self.depth += 1
                try:
                    return fn(*a, **kw)
                finally:
                    self.depth -= 1
                    for total, c, b in zip((self.launches, self.replayed),
                                           self.counters, before):
                        for k, v in c.snapshot().items():
                            total[k] += v - b[k]
            return run

        sdvae.encode, sdvae.decode = enc, dec
        renderer.rasterize_batch = sweep
        for n in self.within:
            setattr(tester, n, scoped(self.saved[n]))
        return self

    def __exit__(self, *exc):
        sdvae, renderer, tester = self.targets
        sdvae.encode, sdvae.decode = self.saved["encode"], \
            self.saved["decode"]
        renderer.rasterize_batch = self.saved["rasterize_batch"]
        for n in self.within:
            setattr(tester, n, self.saved[n])


def pass_records(torch, mods, mgr, rec: PassShapes, path: str,
                 counts: dict) -> tuple:
    """The kernels of a path whose passes and sweeps ``rec`` recorded, on
    ``mgr``'s model: each at every shape the passes give it
    (``diagnosis_shapes``) and K7 at each batch it swept (``k7_case`` on
    the kept meshes), against its twin and timed; the launches those
    shapes account for must be ``counts``, kernel for kernel. Returns
    (one record per kernel launched, path ``path``; the shapes)."""
    shapes = diagnosis_shapes(torch, mods, mgr, rec.passes)
    for (b, size), (verts, faces, times) in sorted(rec.k7.items()):
        check(size == IMAGE, f"{path}: K7 swept at {size}², held at "
              f"{IMAGE}²")
        e = k7_case(torch, mods, path, verts, faces, 5, 1,
                    check_cover=False)
        e.update(kernel="raster_sweep", launches=times)
        shapes.setdefault("raster_sweep", []).append(e)
    torch.cuda.empty_cache()
    want = dict.fromkeys(mods["kernels"].KERNEL_NAMES, 0)
    for kernel, entries in shapes.items():
        want[kernel] += sum(e["launches"] for e in entries)
    check(counts == want, f"{path}: launches {counts}, expected {want} "
          f"from its passes {rec.passes} and sweeps "
          f"{ {k: v[2] for k, v in rec.k7.items()} }")
    records = []
    for kernel, entries in shapes.items():
        r = summarize(kernel, *KERNEL_SOURCES[kernel], entries)
        r.update(path=path, launches=counts[kernel])
        records.append(r)
    return records, shapes


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


def eager_programs(svc) -> None:
    """Make ``svc`` run its programs eagerly on the card (the reference
    its bucket graphs are held against) until ``graphed_programs``."""
    svc._run_program = lambda name, *arrays: svc._run_bucketed(
        svc._programs[name], *arrays)


def graphed_programs(svc) -> None:
    svc.__dict__.pop("_run_program", None)


def graphs_vs_eager(svc, scans: dict, scan, lnd, smi: str) -> dict:
    """The service's graphs against its eager programs: every bucket of
    encode, decode and reconstruct bit for bit, the fit (its best
    restart, chamfer and z), the diagnose and reconstruct p50 and the
    fit's seconds both ways, and the device memory the bucket graphs and
    one fit's graph hold."""
    from craniofacialsd_vae_tpu_torch.analysis import fitting

    import torch

    mgr = svc.manager
    rng = np.random.default_rng(SEED + 30)
    x_all = scans[REQUEST_SIZES[-1]]
    # the rest of the buckets' graphs are captured here: the memory all of
    # them hold (one pool) and the peak
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for b in svc.buckets:
        x = x_all[np.arange(b) % len(x_all)]
        z = rng.normal(size=(b, mgr.model_latent_size)).astype(np.float32)
        outs = {}
        for graphed in (True, False):
            if not graphed:
                eager_programs(svc)
            outs[graphed] = [svc.encode(x), svc.decode(z),
                             *svc.reconstruct(x).values()]
            graphed_programs(svc)
        for g, e in zip(outs[True], outs[False]):
            check(np.array_equal(g, e), f"bucket {b}: a graph's answer "
                  "differs from the eager program's")
    torch.cuda.synchronize()
    memory = {"graphs": len(svc._bucket_graphs),
              "allocated_mib": torch.cuda.memory_allocated() / 2 ** 20,
              "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20}
    latency, fits, fit_s = {}, {}, {}
    for graphed in (True, False):
        if not graphed:
            eager_programs(svc)
        latency[graphed] = {"diagnose": diagnose_latency(svc, scans),
                            "reconstruct": serve_latency(svc, scans)}
        graphed_programs(svc)
        if graphed:
            # one fit's iteration from nothing: the memory its static
            # tensors, Adam state and graph hold once the fit is done
            fitting._FIT_RUNS.pop(mgr, None)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            held = (torch.cuda.memory_allocated(),
                    torch.cuda.memory_reserved())
        t0 = time.perf_counter()
        fits[graphed] = fitting._fit_latent(
            mgr, svc.normalization, scan, lnd, svc.landmark_idx, 5e-3,
            FIT_ITERATIONS, FIT_RESTARTS, SEED, None, graph=graphed)
        fit_s[graphed] = time.perf_counter() - t0
        if graphed:
            torch.cuda.synchronize()
            memory["fit_graph_allocated_mib"] = (
                torch.cuda.memory_allocated() - held[0]) / 2 ** 20
            memory["fit_graph_reserved_mib"] = (
                torch.cuda.memory_reserved() - held[1]) / 2 ** 20
            memory["fit_runs_per_manager"] = fitting.FIT_RUNS_PER_MANAGER
    g, e = fits[True], fits[False]
    check(g["best_restart"] == e["best_restart"]
          and g["chamfer_mm2"] == e["chamfer_mm2"]
          and np.array_equal(g["z"], e["z"]),
          f"the graph fit (best {g['best_restart']}, chamfer "
          f"{g['chamfer_mm2']!r}) differs from the eager fit (best "
          f"{e['best_restart']}, chamfer {e['chamfer_mm2']!r})")
    out = {"buckets_equal": list(svc.buckets), "memory": memory, "fit_s": {
        "graph": fit_s[True], "eager": fit_s[False]},
        "fit_best_restart": g["best_restart"],
        "fit_chamfer_mm2": g["chamfer_mm2"]}
    for kind in ("diagnose", "reconstruct"):
        for graphed, way in ((True, "graph"), (False, "eager")):
            out[f"{kind}_p50_ms_{way}"] = {
                b: v["p50_ms"] for b, v in latency[graphed][kind].items()}
    log(f"[9 graphs] every bucket's graph equals its eager program; the "
        f"graph fit equals the eager fit (best {g['best_restart']}, "
        f"chamfer {g['chamfer_mm2']:.6f} mm², z bit for bit); fit "
        f"{fit_s[True]:.3f} s graph, {fit_s[False]:.3f} s eager; diagnose "
        f"p50 ms graph {out['diagnose_p50_ms_graph']}, eager "
        f"{out['diagnose_p50_ms_eager']}; reconstruct p50 ms graph "
        f"{out['reconstruct_p50_ms_graph']}, eager "
        f"{out['reconstruct_p50_ms_eager']}; {memory['graphs']} bucket "
        f"graphs, {memory['allocated_mib']:.0f} MiB allocated (peak "
        f"{memory['peak_mib']:.0f}); one fit's graph holds "
        f"{memory['fit_graph_allocated_mib']:.1f} MiB allocated, "
        f"{memory['fit_graph_reserved_mib']:.1f} MiB reserved (at most "
        f"{fitting.FIT_RUNS_PER_MANAGER} cached a manager); {smi}")
    return out


def diagnosis_run(torch, mods, run_dir: str, policy: str, smi: str) -> dict:
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
    reset_counts()
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
    path = "diagnosis" if policy == "fp32" else "mixed_diagnosis"
    counts = read_counts(torch, path)
    replays = check_replays(torch, graphs_of(svc), path)
    fit = card["fit"]
    check(np.isfinite(fit["chamfer_mm2"]) and fit["chamfer_mm2"] >= 0,
          f"{policy} fit chamfer {fit['chamfer_mm2']}")
    check(fit["vertices"].shape == svc.manager.template.pos.shape,
          "fit vertices shape")
    check(all(np.isfinite(r["vertex_saliency_nats_per_mm"]).all()
              for r in card["saliency"]), "saliency not finite")

    # after the counted run: the graphs against the eager programs,
    # latencies, the fit's per-iteration cost
    graphs = graphs_vs_eager(svc, scans, scan, lnd, smi)
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
    shapes = diagnosis_shapes(torch, mods, svc.manager, passes)
    fit_iters = passes["dec_bwd"][FIT_RESTARTS]     # warm-up, capture
    k8_per_fit = {"k8_fwd": fit_iters + 1,            # one a forward
                  "k8_bwd": fit_iters}
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
           "counts": counts, "replayed": PATH_REPLAYS[path],
           "replays_checked": replays, "latency": latency, "graphs": graphs,
           "fit": {"iterations": FIT_ITERATIONS, "restarts": FIT_RESTARTS,
                   "scan_points": FIT_SCAN_POINTS,
                   "landmarks": len(lnd_idx), "s": card["fit_s"],
                   "ms_per_iteration": card["fit_s"] * 1e3 / FIT_ITERATIONS,
                   "chamfer_mm2": fit["chamfer_mm2"],
                   "landmark_mse_mm2": fit["landmark_mse_mm2"],
                   "best_restart": fit["best_restart"],
                   "per_iteration": per_iter, "k8_launches": k8_per_fit}}
    out["labels"] = [r["label"]
                     for r in card["diagnose"][REQUEST_SIZES[-1]]]
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


def reference_pickles_check() -> dict:
    """The reference's sklearn pickles of ``tests/fixtures/
    reference_pickles`` (written with sklearn by ``tests/
    test_torch_pickles.py::write_fixture``) read by the port's
    ``LatentClassifiers.load_reference_pickles`` with ``sklearn`` blocked
    (this machine has none): every head's outputs on the fixture's probe
    latents within PICKLE_RTOL of ``expected.npz``, the labels equal."""
    import importlib.util

    from craniofacialsd_vae_tpu_torch.analysis.classifiers import \
        LatentClassifiers

    root = os.path.join(ROOT, "tests", "fixtures", "reference_pickles")
    installed = importlib.util.find_spec("sklearn") is not None
    held = sys.modules.get("sklearn", "absent")
    sys.modules["sklearn"] = None
    try:
        zoo = LatentClassifiers(latent_size=6,
                                latent_regions=PICKLE_REGIONS) \
            .load_reference_pickles(root)
    finally:
        if held == "absent":
            del sys.modules["sklearn"]
        else:
            sys.modules["sklearn"] = held
    with np.load(os.path.join(root, "expected.npz")) as f:
        want = dict(f)
    z = want.pop("probe")
    got = {"lda_decision": zoo.lda.decision_function(z),
           "lda_transform": zoo.lda_transform(z),
           "lda_label": zoo.predict(z, "lda"),
           "qda_proba": zoo.qda.predict_proba(z),
           "qda_log_proba": zoo.qda.log_posteriors(z),
           "qda_label": zoo.predict(z, "qda"),
           "svm_decision": np.asarray(z, np.float64) @ zoo.svm.w + zoo.svm.b,
           "svm_label": zoo.predict(z, "svm")}
    for k, (lo, hi) in PICKLE_REGIONS.items():
        got[f"{k}_lda_transform"] = \
            zoo.region_ldas[k].transform_sklearn_style(z[:, lo:hi])
        got[f"{k}_qda_proba"] = zoo.region_qdas[k].predict_proba(z[:, lo:hi])
    check(set(got) == set(want), "reference pickles: outputs differ")
    worst = 0.0
    for k, w in want.items():
        g = np.asarray(got[k])
        check(g.shape == w.shape, f"reference pickles: {k} shape {g.shape}")
        if k.endswith("_label"):
            check(np.array_equal(g, w), f"reference pickles: {k} differ")
        else:
            worst = max(worst, float(np.abs(g - w).max())
                        / max(float(np.abs(w).max()), 1e-30))
    check(worst <= PICKLE_RTOL,
          f"reference pickles: outputs {worst:.3e} from expected.npz")
    log(f"[9 reference pickles] read without sklearn (installed here: "
        f"{installed}): {len(want)} outputs within {worst:.2e}")
    return {"sklearn_installed": installed, "max_rel_err": worst}


def phase_diagnosis(torch, mods, runs: dict, smi: str) -> dict:
    """Phase 9: phases 7's and 8's run dirs served on the card through
    ``DiagnosisService.from_run_dir`` (see the module docstring)."""
    t0 = time.perf_counter()
    pickles = reference_pickles_check()
    q = FIT_SCAN_POINTS // 4
    shapes = {"fit": k8_case(torch, mods, FIT_RESTARTS, FIT_GEN_POINTS, q,
                             50),
              "one": k8_case(torch, mods, 1, FIT_GEN_POINTS, q, 50),
              "padded": k8_case(torch, mods, FIT_RESTARTS, FIT_GEN_POINTS,
                                q, 50, q_valid=FIT_PAD_POINTS)}
    torch.cuda.empty_cache()
    results, path_shapes = {}, {}
    for policy, run_dir in runs.items():
        res = diagnosis_run(torch, mods, run_dir, policy, smi)
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
        fwd["parity_only"] = [shapes["one"], shapes["padded"]]
        bwd["parity_only"] = [shapes["one"]["bwd"], shapes["padded"]["bwd"]]
        for rec in (fwd, bwd):
            rec.update(path=path, launches=counts[rec["name"]])
            records.append(rec)
    line = {"phase": "diagnosis",
            "k8": {k: {"fwd_ms": s["ms"], "fwd_plain_ms": s["plain_ms"],
                       "fwd_cdist_ms": s["library_ms"],
                       "fwd_bound_ms": s["bound_ms"],
                       "bwd_ms": s["bwd"]["ms"],
                       "bwd_plain_ms": s["bwd"]["plain_ms"],
                       "bwd_bound_ms": s["bwd"]["bound_ms"],
                       "csr_plain_ms": s["bwd"]["csr_plain_ms"],
                       "longest_segment": s["bwd"]["longest_segment"]}
                   for k, s in shapes.items()},
            "reference_pickles": pickles,
            **{policy: {k: v for k, v in r.items() if k != "counts"}
               for policy, r in results.items()},
            "seconds": time.perf_counter() - t0}
    log(json.dumps(line, default=float))
    return dict(line=line, records=records, shapes=shapes, runs=results,
                path_shapes=path_shapes)


# ----------------------------------------------------------------------
# phase 10: the eigensolver K9 and the study's data section
def k9_form(torch, mods, table, x, p, c, a: float, b: float, form: str,
            reps: int, others: bool = True) -> dict:
    """One K9 call form at the solve's shape, in the solver's panel layout
    (rows at a padded stride, ``eigh.panel``), against its twin
    (bit-equal: the same roundings in the same order), two launches
    bit-identical, and timed. ``table`` is (cols, vals, tiles). With
    ``others``: also on contiguous panels (4-byte copies, bit-equal) and
    timed against the twin, the unfused form (K4, then torch's
    elementwise ops) and the library form (``torch.sparse.mm`` on a CSR
    Laplacian, then the same ops), with its bound."""
    kernels, eigh = mods["kernels"], mods["eigh"]
    cols, vals, tiles = table
    pp = p if b != 0.0 else None
    xs, ps = eigh._as_panel(x), eigh._as_panel(p)
    pps = ps if b != 0.0 else None

    def run(xx, pr):
        return kernels.cheby_step(cols, vals, xx, c, a, b, pr, tiles=tiles)

    out, again = run(xs, pps), run(xs, pps)
    ref = eigh.cheby_step_plain(cols, vals, x, c, a, b, pp)
    torch.cuda.synchronize()
    err = max_err(out, ref)
    check(torch.equal(out, ref), f"K9 {form}: differs from its twin "
          f"(max {err:.3e})")
    check(torch.equal(out, again), f"K9 {form}: two launches differ")
    del out, again
    n, d = x.shape
    k = cols.shape[1]
    nbytes = 4 * n * d * (3 if b != 0.0 else 2) + 8 * n * k + 4 * d
    flops = n * d * (2 * k + 2 + (2 if b != 0.0 else 0))
    bms, by, t_bytes, t_ops = bound(nbytes, flops)
    rec = {"form": form, "n": n, "d": d, "k": k, "a": a, "b": b,
           "ld": xs.stride(0), "max_abs_err": err, "bound_ms": bms,
           "bound_by": by, "bytes": nbytes, "flops": flops,
           "bytes_ms": t_bytes, "ops_ms": t_ops}
    if others:
        flat = run(x, pp)
        torch.cuda.synchronize()
        check(torch.equal(flat, ref), f"K9 {form}: contiguous panels "
              f"differ from the twin (max {max_err(flat, ref):.3e})")
        del flat
    del ref
    rec["ms"] = cuda_ms(torch, lambda: run(xs, pps), reps)
    if not others:
        return rec
    rows = torch.arange(n, device=x.device).repeat_interleave(k)
    csr = torch.sparse_coo_tensor(
        torch.stack([rows, cols.reshape(-1).long()]), vals.reshape(-1),
        (n, n)).coalesce().to_sparse_csr()

    def tail(lx):
        t = (lx - c[None, :] * x) * a
        return t - b * p if b != 0.0 else t

    rec["contiguous_ms"] = cuda_ms(torch, lambda: run(x, pp), reps)
    rec["plain_ms"] = cuda_ms(torch, lambda: eigh.cheby_step_plain(
        cols, vals, x, c, a, b, pp), 3)
    rec["unfused_k4_ms"] = cuda_ms(torch, lambda: tail(
        kernels.ell_matmul_fwd(cols, vals, x)), reps)
    rec["library_ms"] = cuda_ms(torch, lambda: tail(torch.sparse.mm(csr, x)),
                                reps)
    return rec


def k9_tiles_record(torch, mods, lap, tpl) -> dict:
    """K9's tiles of the Laplacian: count, staged rows a vertex, the
    largest tile, a block's shared memory and the blocks an SM holds
    (the runtime's occupancy calculator, filter step and b = 0, vector
    path), and their build's seconds on the card: the Laplacian's own
    (the process's first build) and five warm builds, whose median must
    stay within TILES_MAX_S."""
    kernels, eigh = mods["kernels"], mods["eigh"]
    tiles = lap.tiles
    k = lap.cols.shape[1]
    lib = kernels.library()
    smem = lib.cfs_cheby_step_smem(tiles.max_rows, tiles.max_verts, k)
    warm = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = eigh.build_k9_tiles(lap.cols, tpl.pos)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
        check(torch.equal(again.local, tiles.local)
              and torch.equal(again.src, tiles.src), "K9's tile build is "
              "not deterministic")
    warm_s = float(np.median(warm))
    check(warm_s <= TILES_MAX_S, f"K9's tiles took {warm_s:.4f} s to "
          "build (warm median)")
    return {"n_tiles": tiles.n_tiles,
            "rows_per_vertex": tiles.src.shape[0] / tiles.verts.shape[0],
            "max_rows": tiles.max_rows, "max_verts": tiles.max_verts,
            "smem_bytes": smem,
            "blocks_per_sm": lib.cfs_cheby_step_blocks_per_sm(smem, 1, 1),
            "blocks_per_sm_b0": lib.cfs_cheby_step_blocks_per_sm(smem, 0, 1),
            "tiles_s": lap.tiles_s, "warm_tiles_s": warm,
            "warm_tiles_median_s": warm_s}


def k9_parity(torch, mods, tpl, block: int, ptxas: list) -> dict:
    """K9's three call forms at the k = 1000 solve's shapes (N = 16,386,
    D = block): the filter body (b ≠ 0), a b = 0 step and the per-column
    residual; then the stream-only floor, the filter step and a b = 0
    step over a diagonal-only table (K = 1: each tile stages its own
    rows, no gather); the tiles."""
    eigh = mods["eigh"]
    dev = torch.device(DEVICE)
    lap = eigh._EllLaplacian(tpl, dev)
    table = (lap.cols, lap.vals, lap.tiles)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 20)
    n = tpl.num_vertices
    x = torch.randn((n, block), generator=gen, device=DEVICE)
    p = torch.randn((n, block), generator=gen, device=DEVICE)
    theta = torch.rand((block,), generator=gen, device=DEVICE) * 1.5
    lb = 1.4
    e, c = (lap.ub - lb) / 2, (lap.ub + lb) / 2
    sigma = e / -c
    sigma_new = 1.0 / (2.0 / sigma - sigma)
    c_vec = torch.full((block,), c, dtype=torch.float32, device=DEVICE)
    body = (c_vec, 2.0 * sigma_new / e, sigma_new * sigma)
    first = (c_vec, sigma / e, 0.0)
    forms = [k9_form(torch, mods, table, x, p, *body, "filter step", 50),
             k9_form(torch, mods, table, x, p, *first, "b = 0", 50),
             k9_form(torch, mods, table, x, p, theta, 1.0, 0.0,
                     "residual", 50)]
    diag_cols = torch.arange(n, dtype=torch.int32, device=dev)[:, None]
    diag = (diag_cols, lap.vals.sum(1, keepdim=True).abs() + 1.0,
            eigh.build_k9_tiles(diag_cols, tpl.pos))
    floors = [k9_form(torch, mods, diag, x, p, *body,
                      "diagonal floor, filter step", 50, others=False),
              k9_form(torch, mods, diag, x, p, *first,
                      "diagonal floor, b = 0", 50, others=False)]
    tiles = k9_tiles_record(torch, mods, lap, tpl)
    regs = [r for r in ptxas if r["kernel"].startswith("cheby_step")]
    for f in forms:
        log(f"[10 K9] {f['form']} [{n}, {block}] at stride {f['ld']}: "
            f"{f['ms']:.4f} ms (bound {f['bound_ms']:.4f}, "
            f"{f['bound_by']}), contiguous {f['contiguous_ms']:.4f}, twin "
            f"{f['plain_ms']:.3f}, K4 + ops {f['unfused_k4_ms']:.4f}, "
            f"sparse.mm + ops {f['library_ms']:.4f}; bit-equal to the twin")
    for f in floors:
        log(f"[10 K9] {f['form']} (K = 1): {f['ms']:.4f} ms (bound "
            f"{f['bound_ms']:.4f}); bit-equal to the twin")
    log(f"[10 K9] tiles {tiles}")
    log(f"[10 K9] ptxas {regs}")
    return {"forms": forms, "floors": floors, "tiles": tiles, "ptxas": regs}


def eigh_solves(torch, mods, tpl) -> dict:
    """The k = 1000 solve on the card through ``auto`` (the Chebyshev path,
    accepted by JAX's residual test, K9 launched passes × (degree + 2)
    times), its eigenvalues against the float64 dense ones on the card,
    one profiled pass; the Chebyshev solver at CHEBY_GAP_K against ARPACK;
    ``auto``'s dense solve of subdivision DENSE_SUBDIVISIONS against the
    host's."""
    from craniofacialsd_vae_tpu_torch.geometry import synthetic_template

    kernels, eigh = mods["kernels"], mods["eigh"]
    n = tpl.num_vertices
    kernels.launches.reset()
    eigh.solves.reset()
    t0 = time.perf_counter()
    vals, vecs = eigh.laplacian_eigendecomposition(tpl, CHEBY_K,
                                                   backend="auto",
                                                   device=DEVICE)
    solve_s = time.perf_counter() - t0
    launched = kernels.launches.snapshot()["cheby_step"]
    last = eigh.solves.last
    check(last["solver"] == "cheby", f"the k = {CHEBY_K} basis came from "
          f"{last['solver']}, not K9 ({last.get('rejected')})")
    info = last["info"]
    check(info["max_residual"] < CHEBY_ACCEPT,
          f"k = {CHEBY_K} residual {info['max_residual']:.3e}")
    check(launched == info["passes"] * (info["degree"] + 2),
          f"K9 launched {launched} times in {info['passes']} passes")
    check(info["passes"] == CHEBY_PASSES, f"k = {CHEBY_K} took "
          f"{info['passes']} passes, not {CHEBY_PASSES}")
    check(info["tiles_s"] <= TILES_MAX_S,
          f"K9's tiles took {info['tiles_s']:.4f} s to build")
    lap64 = torch.from_numpy(eigh.unnormalized_laplacian_dense(
        n, tpl.edges)).to(DEVICE, torch.float64)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = torch.linalg.eigvalsh(lap64)
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    ref = ref[:CHEBY_K].cpu().numpy()
    del lap64
    torch.cuda.empty_cache()
    rel = np.abs(vals - ref) / np.maximum(np.abs(ref), 1e-12)
    rel[0] = abs(vals[0] - ref[0])          # λ0 = 0: absolute
    check(float(rel.max()) <= CHEBY_RTOL,
          f"k = {CHEBY_K} eigenvalues vs f64 dense: {rel.max():.3e}")

    lap = eigh._EllLaplacian(tpl, torch.device(DEVICE))
    x0 = eigh._initial_panel(n, info["block"], SEED, DEVICE)

    def one_pass():
        eigh._rayleigh_ritz(lap, eigh._filter_pass(
            lap, x0, info["windows"][-1], info["degree"]))

    profile = device_profile(torch, one_pass)
    del x0, lap
    torch.cuda.empty_cache()

    g_vals, g_vecs, g_info = eigh._chebyshev_smallest(tpl, CHEBY_GAP_K,
                                                      device=DEVICE)
    s_vals, s_vecs = eigh._scipy_eigsh(tpl, CHEBY_GAP_K)
    order = np.argsort(s_vals)
    s_vals, s_vecs = s_vals[order], s_vecs[:, order]
    g_rel = float((np.abs(g_vals - s_vals)[1:] / s_vals[1:]).max())
    ov = g_vecs.T @ s_vecs
    g_ov = float(np.abs(ov @ ov.T - np.eye(CHEBY_GAP_K)).max())
    check(g_rel <= CHEBY_GAP_RTOL and abs(g_vals[0]) < 1e-8,
          f"k = {CHEBY_GAP_K} eigenvalues vs ARPACK: {g_rel:.3e}")
    check(g_ov <= OVERLAP_ATOL, f"k = {CHEBY_GAP_K} overlap {g_ov:.3e}")

    small = synthetic_template(DENSE_SUBDIVISIONS, 3)
    dense = {}
    for where, dev in (("card", DEVICE), ("host", "cpu")):
        t0 = time.perf_counter()
        got = eigh.laplacian_eigendecomposition(small, CHEBY_GAP_K,
                                                backend="auto", device=dev)
        dense[where] = (*got, time.perf_counter() - t0)
        check(eigh.solves.last["solver"] == "dense",
              f"auto at {small.num_vertices} vertices took "
              f"{eigh.solves.last['solver']}")
    (c_vals, c_vecs, card_s), (h_vals, h_vecs, host_s) = \
        dense["card"], dense["host"]
    d_err = float(np.abs(c_vals - h_vals).max())
    ov = c_vecs.T.astype(np.float64) @ h_vecs
    d_ov = float(np.abs(ov @ ov.T - np.eye(CHEBY_GAP_K)).max())
    check(np.all(np.abs(c_vals - h_vals) <= DENSE_TOL * (1 + np.abs(h_vals)))
          and d_ov <= OVERLAP_ATOL,
          f"dense solve card vs host: {d_err:.3e}, overlap {d_ov:.3e}")
    out = {"k": CHEBY_K, "n": n, "solve_s": solve_s, "info": info,
           "launches": launched, "rel_err_vs_f64_dense": float(rel.max()),
           "f64_dense_reference_s": ref_s, "profiled_pass": profile,
           "gap_k": {"k": CHEBY_GAP_K, "passes": g_info["passes"],
                     "seconds": g_info["seconds"], "rel_err_vs_arpack": g_rel,
                     "overlap_err": g_ov},
           "dense": {"n": small.num_vertices, "card_s": card_s,
                     "host_s": host_s, "max_abs_err": d_err,
                     "overlap_err": d_ov}}
    log(f"[10 eigh] k = {CHEBY_K} on {n} vertices: {info['passes']} passes "
        f"(segments {info['segments']}), {solve_s:.2f} s (set-up "
        f"{info['setup_s']:.3f} with K9 tiles {info['tiles_s']:.4f}, filter {info['filter_s']:.3f}, QR "
        f"{info['qr_s']:.3f}, eigh {info['eigh_s']:.3f}, rest {info['rr_other_s']:.3f}, host polish "
        f"{info['polish_s']:.3f}), residual {info['max_residual']:.2e}, "
        f"eigenvalues within {rel.max():.2e} of the f64 dense ones "
        f"({ref_s:.2f} s); one pass: device {profile['device_ms']:.1f} of "
        f"{profile['wall_ms']:.1f} ms; k = {CHEBY_GAP_K}: {g_rel:.2e}, "
        f"overlap {g_ov:.2e}; dense at {small.num_vertices}: card "
        f"{card_s:.2f} s, host {host_s:.2f} s")
    return out


def study_data_section() -> dict:
    """The study's augmentation keys, read from FLAGSHIP by the port's
    config reader."""
    from craniofacialsd_vae_tpu_torch.utils import get_config

    data = get_config(os.path.join(ROOT, "configurations",
                                   FLAGSHIP))["data"]
    keys = ("augmentation_mode", "augmentation_factor",
            "augmentation_balanced")
    return {k: data[k] for k in keys}


def generation_on_host(config: dict, template, card_dir: str,
                       work: str) -> dict:
    """The card run's generation again on the host: the raw scans and the
    cached basis copied to ``work``, the train split's raw names, the same
    seed; every generated file against the card's."""
    from craniofacialsd_vae_tpu_torch.data.dataset import (
        DatasetSummary, _augment_train_list)
    from craniofacialsd_vae_tpu_torch.geometry import read_mesh

    data = config["data"]
    with open(os.path.join(data["precomputed_path"],
                           "data_split.json")) as f:
        train = [n for n in json.load(f)["train"]
                 if not n.startswith("augmented")]
    os.makedirs(work)
    for name in os.listdir(card_dir):
        if name.endswith(".obj") or name.startswith("eigbasis_"):
            shutil.copy2(os.path.join(card_dir, name), work)
    t0 = time.perf_counter()
    names = _augment_train_list(
        work, train, template, DatasetSummary(), data["augmentation_mode"],
        data["augmentation_factor"], data["augmentation_balanced"],
        np.random.default_rng(0), device="cpu")
    host_s = time.perf_counter() - t0
    card_names = sorted(os.listdir(os.path.join(card_dir, "augmented")))
    host_names = sorted(os.listdir(os.path.join(work, "augmented")))
    check(host_names == card_names and len(names) == len(train)
          + len(card_names), "host generation wrote other files")
    worst = 0.0
    for name in card_names:
        a = read_mesh(os.path.join(card_dir, "augmented", name)).vertices
        b = read_mesh(os.path.join(work, "augmented", name)).vertices
        worst = max(worst, float(np.abs(a - b).max() / np.abs(b).max()))
    check(worst <= AUG_RTOL, f"card vs host generation: {worst:.3e}")
    return {"files": len(card_names), "worst_rel": worst, "host_s": host_s}


def phase_augmentation(torch, mods, root: str, ptxas: list) -> dict:
    """Phase 10: K9 at the solve's shapes, the solves (``eigh_solves``),
    then ``train.main`` from a raw dataset with the study's data section:
    counted, it solves the basis with K9 (cached in the dataset
    directory), generates ``augmented/`` and trains one epoch; the same
    generation on the host from a copy of the cached basis; a second
    ``train.main`` (a fresh precomputed dir) and a direct basis request
    read the generated files and the cache with no K9 launch."""
    from craniofacialsd_vae_tpu_torch import train as entry
    from craniofacialsd_vae_tpu_torch.geometry import synthetic_template
    from craniofacialsd_vae_tpu_torch.utils import get_config

    kernels, eigh = mods["kernels"], mods["eigh"]
    t_start = time.perf_counter()
    tpl = synthetic_template(ENTRY_SUBDIVISIONS, ENTRY_REGIONS)
    block = CHEBY_K + max(8, CHEBY_K // 8)
    k9 = k9_parity(torch, mods, tpl, block, ptxas)
    # no empty_cache before the two timed solves (this one and the entry
    # basis below): a build that must take fresh device memory from the
    # driver took past TILES_MAX_S in 26 of 240 builds, none served from
    # the allocator's cache did (k9_tiles_probe, PERF.md section 7)
    solves = eigh_solves(torch, mods, tpl)

    ws = os.path.join(root, "augmentation")
    os.makedirs(ws)
    study = study_data_section()
    cfg_path = entry_workspace(ws, study)
    config = get_config(cfg_path)
    check(all(config["data"][k] == v for k, v in study.items()),
          f"the workspace's data section {config['data']}")
    raw = config["data"]["dataset_path"]
    argv = ["--config", cfg_path, "--id", "augment", "--output_path", ws,
            "--device", DEVICE, "--epochs", "1"]

    # the main path: counts from 0, train.main from the raw dataset
    reset_counts()
    eigh.solves.reset()
    t0 = time.perf_counter()
    first = entry.main(argv)
    first_s = time.perf_counter() - t0
    counts = read_counts(torch, "augmentation")
    last = eigh.solves.last
    check(last is not None and last["solver"] == "cheby",
          f"the entry path's basis came from {last and last['solver']}")
    info = last["info"]
    check(counts["cheby_step"] == info["passes"] * (info["degree"] + 2),
          f"K9 launched {counts['cheby_step']} times on the entry path in "
          f"{info['passes']} passes")
    check(info["max_residual"] < CHEBY_ACCEPT, "entry basis residual")
    check(info["passes"] == CHEBY_PASSES and info["tiles_s"] <= TILES_MAX_S,
          f"the entry basis: {info['passes']} passes, tiles built in "
          f"{info['tiles_s']:.4f} s")
    generated = sorted(os.listdir(os.path.join(raw, "augmented")))
    cached = [n for n in os.listdir(raw) if n.startswith("eigbasis_")]
    check(generated and len(cached) == 1, f"{len(generated)} generated, "
          f"cache {cached}")
    (epoch,) = first["history"]
    grid = config["optimization"]["batch_size"]
    with open(os.path.join(config["data"]["precomputed_path"],
                           "data_split.json")) as f:
        train_names = json.load(f)["train"]
    check(sum(n.startswith("augmented") for n in train_names)
          == len(generated), "the split's train list lacks generated files")
    check(epoch["steps"] == len(train_names) // grid
          and all(np.isfinite(v) for v in epoch["train"].values()),
          f"the epoch on the extended list: {epoch}")
    replays = check_replays(torch, graphs_of(managers=[first["manager"]]),
                            "augmentation")
    del first["manager"]
    torch.cuda.empty_cache()

    host = generation_on_host(config, tpl, raw,
                              os.path.join(ws, "host_generation"))

    # a second run on a fresh precomputed dir, and the basis asked for
    # again: the generated files and the cache, no K9 launch
    config2 = os.path.join(ws, "again.yaml")
    with open(cfg_path) as f:
        text = f.read()
    pre = config["data"]["precomputed_path"]
    with open(config2, "w") as f:
        f.write(text.replace(pre, pre + "_again"))
    kernels.launches.reset()
    eigh.solves.reset()
    t0 = time.perf_counter()
    second = entry.main(["--config", config2, "--id", "augment_again",
                         "--output_path", ws, "--device", DEVICE,
                         "--epochs", "1"])
    eigh.laplacian_eigendecomposition(tpl, CHEBY_K, cache_dir=raw,
                                      device=DEVICE)
    second_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    again = kernels.launches.snapshot()
    check(again["cheby_step"] == 0 and eigh.solves.last["solver"] == "cache",
          f"the cached rerun launched K9 {again['cheby_step']} times "
          f"({eigh.solves.last})")
    check(second["history"][0]["steps"] == epoch["steps"],
          "the rerun trained on another list")
    del second["manager"]
    torch.cuda.empty_cache()

    forms = k9["forms"]
    body = forms[0]
    record = {"name": "cheby_step", "route": "cuda",
              "source": f"{PKG}/csrc/cheby_step.cu",
              "replaces": KERNEL_SOURCES["cheby_step"][1],
              "path": "augmentation", "launches": counts["cheby_step"],
              "max_abs_err": max(f["max_abs_err"] for f in forms),
              **{k: body[k] for k in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms")},
              "unfused_k4_ms": body["unfused_k4_ms"], "forms": forms,
              "floors": k9["floors"], "tiles": k9["tiles"],
              "ptxas": k9["ptxas"]}
    line = {"phase": "augmentation",
            "k9": {f["form"]: {k: f[k] for k in (
                "ms", "contiguous_ms", "plain_ms", "unfused_k4_ms",
                "library_ms", "bound_ms")} for f in forms},
            "k9_floor": {f["form"]: {k: f[k] for k in ("ms", "bound_ms")}
                         for f in k9["floors"]},
            "k9_tiles": k9["tiles"],
            "solve": {k: solves[k] for k in (
                "solve_s", "launches", "rel_err_vs_f64_dense",
                "f64_dense_reference_s", "gap_k", "dense")},
            "solve_info": {k: solves["info"][k] for k in (
                "passes", "block", "degree", "segments", "max_residual",
                "setup_s", "tiles_s", "filter_s", "qr_s", "eigh_s",
                "rr_other_s", "polish_s", "seconds")},
            "profiled_pass": {k: solves["profiled_pass"][k] for k in (
                "wall_ms", "device_ms", "idle_share", "kernels_run")},
            "entry": {"first_run_s": first_s, "second_run_s": second_s,
                      "basis": {k: info[k] for k in (
                          "passes", "seconds", "max_residual", "setup_s",
                          "tiles_s", "filter_s", "polish_s")},
                      "generated": len(generated),
                      "train_scans": len(train_names),
                      "dataset_load_s": first["data_s"],
                      "epoch_train_s": epoch["train_s"],
                      "host_generation": host,
                      "rerun_launches": again["cheby_step"]},
            "launches": counts, "replayed": PATH_REPLAYS["augmentation"],
            "replays_checked": replays,
            "seconds": time.perf_counter() - t_start}
    log(json.dumps(line, default=float))
    return dict(line=line, record=record, k9=k9, solves=solves)


# ----------------------------------------------------------------------
# phase 11: the evaluation harness
EVAL_PARTS = ("latent_traversals", "plot_embeddings",
              "random_generation_and_rendering",
              "random_generation_and_save", "test_classifiers",
              "compute_diversity_train_set", "compute_diversity")
EVAL_DIVERSITY = (200, 25)      # compute_diversity's samples and batch held
#                                 card vs host (the same numpy seeds)
EVAL_DRAWS = 4                  # meshes of the uncertainty held card vs host
TRAVERSAL_FILES = ("latent_exploration{}.avi",
                   "latent_exploration_tiled{}.png",
                   "latent_exploration_tiled{}.avi",
                   "latent_exploration_split{}.svg",
                   "latent_exploration{}.svg")
EMBEDDING_FILES = tuple(f"{{}}_emb_{n}" for n in (
    "train_vs_test.svg", "real_vs_aug.svg", "distributions.svg",
    "distributions.npz"))
STANDARD_FILES = ("eval_metrics.json", "accuracies.json",
                  "classification_report.json",
                  "classification_report_regions.json",
                  "random_generation.png",
                  *(n.format("") for n in TRAVERSAL_FILES),
                  *(n.format("lda") for n in EMBEDDING_FILES),
                  "emb_all_train.svg", "emb_all_train_dist.svg",
                  "emb_all_train_dist.npz",
                  *(f"confmat_{h}.svg" for h in ("mlp", "svm", "lda", "qda")),
                  "region_confmats_lda.svg", "region_confmats_qda.svg",
                  *(os.path.join("random_meshes", f"{i}.ply")
                    for i in range(16)))
TRAVERSAL_STEPS = 10            # latent_traversals' n_steps
PER_VARIABLE_STEPS = 3          # interpolate's per_variable_steps


def walk_avi(path: str) -> int:
    """Walk an AVI's RIFF chunks: the ``avih`` frame count, the ``idx1``
    entries and the ``00dc`` chunks agree, each payload a JPEG (SOI …
    EOI); returns the frame count."""
    with open(path, "rb") as f:
        data = f.read()
    check(data[:4] == b"RIFF" and data[8:12] == b"AVI "
          and int.from_bytes(data[4:8], "little") == len(data) - 8,
          f"{path}: not a RIFF AVI")
    found = {"frames": 0, "index": 0, "total": None}

    def walk(lo, hi):
        pos = lo
        while pos < hi:
            cc = data[pos:pos + 4]
            size = int.from_bytes(data[pos + 4:pos + 8], "little")
            body = data[pos + 8:pos + 8 + size]
            if cc == b"LIST":
                walk(pos + 12, pos + 8 + size)
            elif cc == b"00dc":
                check(body[:2] == b"\xff\xd8" and body[-2:] == b"\xff\xd9",
                      f"{path}: a frame is not a JPEG")
                found["frames"] += 1
            elif cc == b"idx1":
                found["index"] = size // 16
            elif cc == b"avih":
                found["total"] = int.from_bytes(body[16:20], "little")
            pos += 8 + size + size % 2

    walk(12, len(data))
    check(found["total"] == found["index"] == found["frames"] > 0,
          f"{path}: avih {found['total']}, idx1 {found['index']}, "
          f"00dc {found['frames']}")
    return found["frames"]


def check_figures(root: str, rels, frames: dict | None = None) -> dict:
    """Each file under ``root`` exists; each ``.svg`` parses as XML, each
    ``.avi`` walks to its frames (``frames[rel]`` of them where given).
    Returns {rel: frames or bytes}."""
    import xml.etree.ElementTree as ET

    out = {}
    for rel in rels:
        path = os.path.join(root, rel)
        check(os.path.isfile(path), f"no {path}")
        out[rel] = os.path.getsize(path)
        if rel.endswith(".svg"):
            ET.parse(path)
        elif rel.endswith(".avi"):
            out[rel] = walk_avi(path)
            want = (frames or {}).get(rel)
            check(want is None or out[rel] == want,
                  f"{path}: {out[rel]} frames, {want} passed")
    return out


def traversal_frames(latent: int, suffix="") -> dict:
    """The frames of a traversal's two videos: two black frames after each
    dimension's walk, and one grid a step."""
    return {f"latent_exploration{suffix}.avi": latent * (TRAVERSAL_STEPS + 2),
            f"latent_exploration_tiled{suffix}.avi": TRAVERSAL_STEPS}


FIGURE_STATES = ("lda_emb_distributions.npz", "emb_all_train_dist.npz")
PREPOST_IDS = ("cli", "1", "2")    # pre/post pairs of the experiments


def experiment_figures(plan: dict, n_regions: int, latent: int) -> tuple:
    """The files of phase 11's other experiments (``interpolate`` of two
    test scans, ``classify_and_project``, planning, pre/post pairs, the
    post-op colour map, fit, saliency, uncertainty) and the frames of
    each video: every walk of the plan ``plan`` (its ``all_attributes``
    and each procedure) with its renders' video and both overlays' videos
    one frame a point. Returns (rels, {rel: frames})."""
    inter = "interpolations"
    prepost = "pre_post_eval_plots"
    rels = ["interpolate_per_feature.png", "interpolate_all.png",
            "interpolate_per_feature.avi", "interpolate_per_variable.avi",
            os.path.join(inter, "pre_procedure_distances.csv"),
            os.path.join(inter, "pre_emb.svg"),
            os.path.join(inter, "pre_emb_r.svg"),
            "postop_displacement.ply",
            os.path.join(prepost, "pairs_with_results.csv"),
            os.path.join(prepost, "region_metrics_distances.svg"),
            os.path.join(prepost, "region_metrics_with_angles_apert.svg"),
            os.path.join(prepost, "region_metrics_with_angles_crouzon.svg"),
            *(os.path.join(prepost, f"{i}_displacement.svg")
              for i in PREPOST_IDS),
            os.path.join("fit", "unregistered_fit.ply"),
            os.path.join("saliency", "saliency_maps.png"),
            os.path.join("uncertainty", "report.json")]
    frames = {"interpolate_per_feature.avi": n_regions * max(n_regions // 2,
                                                             2),
              "interpolate_per_variable.avi": latent * PER_VARIABLE_STEPS}
    walks = {"all_attributes": plan["all_attributes"], **plan["procedures"]}
    for name, walk in walks.items():
        sid = f"pre_{name}"
        d = os.path.join(inter, sid)
        videos = [os.path.join(d, n) for n in (
            "interpolation.avi", f"{sid}_emb_interpolate.avi",
            f"{sid}_emb_r_interpolate.avi")]
        rels += [os.path.join(d, "interpolation.png"),
                 os.path.join(d, f"{sid}_emb.svg"),
                 os.path.join(d, f"{sid}_emb_r_interpolate.svg"), *videos]
        frames.update(dict.fromkeys(videos, len(walk)))
    return rels, frames


class TimedParts:
    """While active, the wall time (after a synchronization) of each call
    of the named ``Tester`` methods and of ``reconstruction_errors``,
    summed by name."""

    def __init__(self, torch, names):
        from craniofacialsd_vae_tpu_torch.analysis import tester

        self.torch, self.names, self.mod = torch, names, tester
        self.seconds = {}

    def _wrap(self, name, fn):
        def timed(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            self.torch.cuda.synchronize()
            self.seconds[name] = self.seconds.get(name, 0.0) \
                + time.perf_counter() - t0
            return out
        return timed

    def __enter__(self):
        cls = self.mod.Tester
        self.saved = {n: getattr(cls, n) for n in self.names}
        self.saved_recon = self.mod.reconstruction_errors
        for n, fn in self.saved.items():
            setattr(cls, n, self._wrap(n, fn))
        self.mod.reconstruction_errors = self._wrap(
            "reconstruction_errors", self.saved_recon)
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.mod.Tester, n, fn)
        self.mod.reconstruction_errors = self.saved_recon


def evaluation_tester(run_dir: str, device, out_dir: str):
    """The entry point's Tester (``test.main``'s construction) on
    ``run_dir``, evaluating into ``out_dir``, its landmark ids those of
    the template below its vertex count (the service's rule)."""
    from craniofacialsd_vae_tpu_torch.analysis.tester import (
        TEMPLATE_LANDMARKS_IDX, Tester)
    from craniofacialsd_vae_tpu_torch.data.dataset import (BatchIterator,
                                                           build_datasets)
    from craniofacialsd_vae_tpu_torch.manager import ModelManager
    from craniofacialsd_vae_tpu_torch.utils import get_config

    config = get_config(os.path.join(run_dir, "config.yaml"))
    mgr = ModelManager(config, config["data"]["precomputed_path"],
                       device=device)
    train, val, test, norm, weights = build_datasets(config, mgr.template,
                                                     device=device)
    mgr.set_class_conversions_and_weights(weights)
    mgr.resume(os.path.join(run_dir, "checkpoints"))
    b = config["optimization"]["batch_size"]
    tester = Tester(mgr, norm, BatchIterator(train, b, shuffle=False),
                    BatchIterator(test, b, shuffle=False, drop_last=False),
                    out_dir, config)
    n = mgr.template.num_vertices
    tester.template_landmarks_idx = [i for i in TEMPLATE_LANDMARKS_IDX
                                     if i < n]
    return tester, {"train": train, "val": val, "test": test, "norm": norm}


def rel_to_max(got, want) -> float:
    """The largest difference of two arrays of numbers over the largest
    magnitude of ``want`` (SERVE_RTOL's measure)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def read_json(path: str):
    with open(path) as f:
        return json.load(f)


def evaluation_answers(torch, tester, scans: dict, eps, card: bool) -> dict:
    """The experiments held card vs host, on one Tester: recon, the
    classifiers (and their three JSON files), a plan and a pre/post pair
    of two scans, saliency of SALIENCY_BATCH test meshes (artifacts on
    the card), the uncertainty of EVAL_DRAWS meshes with ``eps`` injected
    (DIAG_SAMPLES draws), a fit at FIT_PARITY_ITERATIONS (its K8 launches
    counted on the card, its graph's replays included) and
    ``compute_diversity`` at EVAL_DIVERSITY;
    with each one's wall time."""
    from craniofacialsd_vae_tpu_torch import graphs, kernels

    out, secs = {}, {}

    def run(name, fn):
        t0 = time.perf_counter()
        out[name] = fn()
        if card:
            torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0

    run("recon", tester.reconstruction_errors)
    run("classifiers", tester.test_classifiers)
    out["reports"] = {n: read_json(os.path.join(tester._out_dir, n))
                      for n in ("accuracies.json",
                                "classification_report.json",
                                "classification_report_regions.json")}
    run("planning", lambda: tester.interpolate_syndrome_to_normal(
        scans["pre"], render=False))
    run("prepost", lambda: tester.evaluate_pre_post_pair(
        scans["pre"], scans["post"], "smoke"))
    run("saliency", lambda: tester.saliency_maps(
        n_meshes=SALIENCY_BATCH, save_artifacts=card))
    out["vertex_saliency"] = tester.last_saliency
    run("uncertainty", lambda: tester.diagnosis_uncertainty(
        n_meshes=len(eps), n_samples=DIAG_SAMPLES, eps=eps,
        save_artifacts=False))
    if card:
        reset_counts()
    run("fit", lambda: tester.fit_mesh(
        scans["fit"], scans["fit_landmarks"],
        iterations=FIT_PARITY_ITERATIONS, n_restarts=FIT_RESTARTS,
        seed=SEED))
    if card:
        # the fit's graph may be a cached capture: its replays count too
        launched = kernels.launches.snapshot()
        replayed = graphs.replayed.snapshot()
        out["fit_k8"] = {k: launched[k] + replayed.get(k, 0)
                         for k in ("k8_fwd", "k8_bwd")}
    run("diversity", lambda: tester.compute_diversity(*EVAL_DIVERSITY))
    out["seconds"] = secs
    return out


def compare_evaluations(card: dict, host: dict, what: str, mixed: bool
                        ) -> dict:
    """Card against host: the classifier files and every label equal;
    recon, the plan's patient latent, the pre/post metrics, the
    uncertainty statistics and the diversity within SERVE_RTOL of each
    array's max (MIXED_RTOL under ``mixed``); saliency within
    SALIENCY_RTOL of its max; the fit's chamfer within FIT_RTOL with the
    same best restart."""
    rtol = MIXED_RTOL if mixed else SERVE_RTOL
    rel = {}

    def held(name, value, bar):
        rel[name] = value
        check(value <= bar, f"{what} {name}: card vs host {value:.3e} > "
              f"{bar}")

    check(card["reports"] == host["reports"],
          f"{what}: the classifier files differ card vs host")
    keys = sorted(host["recon"])
    held("recon", rel_to_max([card["recon"][k] for k in keys
                              if np.isfinite(host["recon"][k])],
                             [host["recon"][k] for k in keys
                              if np.isfinite(host["recon"][k])]), rtol)
    if "planning" in host:
        held("plan_patient", rel_to_max(card["planning"]["z_patient"],
                                        host["planning"]["z_patient"]), rtol)
        pc, ph = card["prepost"], host["prepost"]
        check(pc["pre_class"] == ph["pre_class"]
              and pc["post_class"] == ph["post_class"],
              f"{what}: pre/post classes differ")
        names = ["global_metric", "global_metric_l2",
                 "global_metric_directional", "procedure_metric"]
        vals = lambda m: [m[k] for k in names] + [  # noqa: E731
            v for r in sorted(m["region_metrics"])
            for v in m["region_metrics"][r].values()]
        held("prepost", rel_to_max(vals(pc), vals(ph)), rtol)
        for c, h in zip(card["saliency"], host["saliency"]):
            check(c["label"] == h["label"]
                  and c["reference_class"] == h["reference_class"],
                  f"{what}: saliency labels differ")
        held("saliency", rel_to_max(card["vertex_saliency"],
                                    host["vertex_saliency"]),
             MIXED_FIT_RTOL if mixed else SALIENCY_RTOL)
        for c, h in zip(card["uncertainty"], host["uncertainty"]):
            check(c["label"] == h["label"]
                  and c["sample_votes"] == h["sample_votes"],
                  f"{what}: uncertainty votes differ")
        held("uncertainty", rel_to_max(
            [v for r in card["uncertainty"] for f in ("posterior_mean",
                                                      "posterior_std")
             for v in r[f].values()],
            [v for r in host["uncertainty"] for f in ("posterior_mean",
                                                      "posterior_std")
             for v in r[f].values()]), rtol)
        fc, fh = card["fit"], host["fit"]
        held("fit_chamfer", abs(fc["chamfer_mm2"] - fh["chamfer_mm2"])
             / fh["chamfer_mm2"], MIXED_FIT_RTOL if mixed else FIT_RTOL)
        check(mixed or fc["best_restart"] == fh["best_restart"],
              f"{what}: fit best restart card {fc['best_restart']} vs "
              f"host {fh['best_restart']}")
        check(fc["pred_class"] == fh["pred_class"],
              f"{what}: fitted class differs")
        held("diversity", abs(card["diversity"] - host["diversity"])
             / host["diversity"], rtol)
    return rel


def evaluation_scans(root: str, tester, split: dict) -> dict:
    """A pre/post pair (two test scans written as OBJ) and an
    unregistered scan of FIT_SCAN_POINTS points with its landmarks (JSON,
    the reference's layout), for the file-taking experiments."""
    from craniofacialsd_vae_tpu_torch.geometry import write_obj

    mgr = tester._manager
    norm = split["norm"]
    faces = np.asarray(mgr.template.face)
    out = {}
    for key, i in (("pre", 0), ("post", 1)):
        out[key] = os.path.join(root, f"{key}.obj")
        write_obj(out[key], np.asarray(split["test"].x[i]) * norm["std"]
                  + norm["mean"], faces)
    pts, lnd = fit_scan(np.asarray(mgr.template.pos, np.float64),
                        tester.template_landmarks_idx)
    out["fit"] = os.path.join(root, "unregistered.obj")
    write_obj(out["fit"], pts)
    out["fit_landmarks"] = os.path.join(root, "unregistered_landmarks.json")
    with open(out["fit_landmarks"], "w") as f:
        json.dump([dict(zip("xyz", map(float, p))) for p in lnd], f)
    return out


def phase_evaluation(torch, mods, root: str, runs: dict, labels: list,
                     smi: str) -> dict:
    """Phase 11: the evaluation harness on phase 7's (fp32) and phase 8's
    (mixed) run dirs (see the module docstring)."""
    from craniofacialsd_vae_tpu_torch import batch_diagnose
    from craniofacialsd_vae_tpu_torch import test as entry
    from craniofacialsd_vae_tpu_torch.analysis.uncertainty import \
        sample_eps
    from craniofacialsd_vae_tpu_torch.geometry import write_obj

    t_start = time.perf_counter()
    run_dir = runs["fp32"]
    run_id = os.path.basename(run_dir)
    argv = ["--id", run_id, "--output_path", root, "--device", DEVICE,
            "--experiment", "standard"]

    # the main path: counts from 0, the standard suite through the entry
    # point, counts read
    for name in ("eval_metrics.json", "accuracies.json"):
        check(not os.path.exists(os.path.join(run_dir, name)),
              f"{name} before the suite ran")
    reset_counts()
    with PassShapes() as shapes, TimedParts(torch, EVAL_PARTS) as parts:
        t0 = time.perf_counter()
        first = entry.main(argv)
        torch.cuda.synchronize()
        standard_s = time.perf_counter() - t0
    counts = read_counts(torch, "evaluation")
    steps_s = {"standard": standard_s}
    latent = first["manager"].model_latent_size
    figures = check_figures(run_dir, STANDARD_FILES,
                            traversal_frames(latent))
    metrics = read_json(os.path.join(run_dir, "eval_metrics.json"))
    check(metrics == json.loads(json.dumps(first["result"])),
          "eval_metrics.json is not the suite's answer")
    check(all(np.isfinite(metrics["recon_errors"][k])
              for k in ("mean", "median", "max"))
          and metrics["diversity"] > 0
          and metrics["train_set_diversity"] > 0,
          f"eval_metrics {metrics}")
    for kernel in ("spiral_conv_tc", "spiral_conv_narrow",
                   "ell_matmul_fwd", "raster_sweep"):
        check(counts[kernel] > 0,
              f"{kernel} was not launched on the evaluation path")
    svgs = sorted(n for n in first["tester"].figure_data if n.endswith(".svg"))
    check(set(svgs) == {n for n in STANDARD_FILES if n.endswith(".svg")},
          f"the suite's figures {svgs}")
    manager = first["manager"]
    log(f"[11 evaluation] standard suite on the card {standard_s:.2f} s "
        f"(parts {dict((k, round(v, 3)) for k, v in parts.seconds.items())}"
        f"); launches {dict((k, v) for k, v in counts.items() if v)}; "
        f"figures {len(svgs)}, video frames "
        f"{ {k: v for k, v in figures.items() if k.endswith('.avi')} }; "
        f"{smi}")

    # after the counted run: the suite again under the profiler; every
    # kernel at every shape the suite gave it, its launches the run's
    t0 = time.perf_counter()
    prof = profile_kernels(torch, lambda: entry.main(argv))
    steps_s["profiled"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    records, _ = pass_records(torch, mods, manager, shapes, "evaluation",
                              counts)
    steps_s["kernels_held"] = time.perf_counter() - t0
    del first, manager
    torch.cuda.empty_cache()

    # every other experiment on the card, at the entry's defaults, timed,
    # beside the suite's figure states (the overlays read them)
    t_step = time.perf_counter()
    eval_card = os.path.join(root, "eval_card")
    os.makedirs(eval_card)
    for name in FIGURE_STATES:
        shutil.copy2(os.path.join(run_dir, name), eval_card)
    card_t, split = evaluation_tester(run_dir, DEVICE, eval_card)
    scans = evaluation_scans(root, card_t, split)
    pairs = os.path.join(root, "pairs.csv")
    with open(pairs, "w") as f:
        f.write("PID,Pre name,Post name,Surgery regions,Procedure,"
                "Syndrome\n1,pre.obj,post.obj,monobloc,monobloc,Apert\n"
                "2,post.obj,pre.obj,le_fort_III,le_fort_III,Crouzon\n")
    x = np.asarray(split["test"].x, np.float32)
    far = int(np.argmax([float(np.mean((x[0] - xi) ** 2)) for xi in x]))
    raw = lambda v: v * split["norm"]["std"] + split["norm"]["mean"]  # noqa
    experiments = {
        "interpolate": lambda: card_t.interpolate(raw(x[0]), raw(x[far])),
        "classify_and_project": lambda: card_t.classify_and_project(
            scans["pre"]),
        "planning": lambda: card_t.interpolate_syndrome_to_normal(
            scans["pre"]),
        "prepost": lambda: (card_t.evaluate_pre_post_pair(
            scans["pre"], scans["post"], "cli"),
            card_t.compute_and_save_postop_mesh_colourmap(
                scans["pre"], scans["post"])),
        "prepost_batch": lambda: card_t.evaluate_all_pre_post_pairs_in_excel(
            root, pairs),
        "fit": lambda: card_t.fit_mesh(scans["fit"], scans["fit_landmarks"],
                                       save_artifacts=True),
        "saliency": card_t.saliency_maps,
        "uncertainty": card_t.diagnosis_uncertainty,
    }
    experiment_s, answers = {}, {}
    for name, fn in experiments.items():
        t0 = time.perf_counter()
        answers[name] = fn()
        torch.cuda.synchronize()
        experiment_s[name] = time.perf_counter() - t0
    log(f"[11 evaluation] the other experiments on the card, at the entry's "
        f"defaults (s): { {k: round(v, 3) for k, v in experiment_s.items()} }")
    n_regions = len(card_t._manager.latent_regions)
    rels, frames = experiment_figures(answers["planning"], n_regions,
                                      card_t._manager.model_latent_size)
    experiment_files = check_figures(card_t._out_dir, rels, frames)
    overlays = sorted(r for r in rels if "_emb" in r or "displacement.svg"
                      in r)
    check(set(overlays) <= set(card_t.figure_data),
          f"overlays not drawn by the Tester: "
          f"{sorted(set(overlays) - set(card_t.figure_data))}")
    steps_s["experiments"] = time.perf_counter() - t_step

    # card against host, on the same run dir and requests
    t_step = time.perf_counter()
    draws = min(EVAL_DRAWS, len(split["test"]))
    eps = sample_eps(SEED, draws, DIAG_SAMPLES,
                     card_t._manager.model_latent_size)
    card = evaluation_answers(torch, card_t, scans, eps, True)
    check(card["fit_k8"]["k8_fwd"] > 0 and card["fit_k8"]["k8_bwd"] > 0,
          f"the Tester's fit launched K8 {card['fit_k8']}")
    host_t, _ = evaluation_tester(run_dir, "cpu",
                                  os.path.join(root, "eval_host"))
    t0 = time.perf_counter()
    host = evaluation_answers(torch, host_t, scans, eps, False)
    host_s = time.perf_counter() - t0
    rel = compare_evaluations(card, host, "evaluation fp32", False)
    del host_t
    steps_s["card_vs_host"] = time.perf_counter() - t_step
    t_step = time.perf_counter()

    # the mixed run dir: recon and the classifiers, card vs host
    mixed = {}
    for dev in (DEVICE, "cpu"):
        t, _ = evaluation_tester(runs["mixed"], dev, os.path.join(
            root, f"eval_mixed_{torch.device(dev).type}"))
        mixed[dev] = {"recon": t.reconstruction_errors(),
                      "classifiers": t.test_classifiers()}
        mixed[dev]["reports"] = {
            n: read_json(os.path.join(t._out_dir, n))
            for n in ("accuracies.json", "classification_report.json",
                      "classification_report_regions.json")}
        del t
    mixed_rel = compare_evaluations(mixed[DEVICE], mixed["cpu"],
                                    "evaluation mixed", True)
    steps_s["mixed_card_vs_host"] = time.perf_counter() - t_step

    # the batch intake over phase 9's scans (the train split's first
    # REQUEST_SIZES[-1], as OBJ files) and one of the wrong size
    config = card_t._config
    with open(os.path.join(config["data"]["precomputed_path"],
                           "data_split.json")) as f:
        names = json.load(f)["train"][:REQUEST_SIZES[-1]]
    intake = os.path.join(root, "intake")
    os.makedirs(intake)
    for name in names:
        shutil.copy2(os.path.join(config["data"]["dataset_path"], name),
                     intake)
    half = np.asarray(split["test"].x[0])
    write_obj(os.path.join(intake, "zz_unregistered.obj"),
              half[:len(half) // 2])
    t0 = time.perf_counter()
    summary = batch_diagnose.main(["--run_dir", run_dir, "--scans", intake,
                                   "--out", os.path.join(root, "intake_out"),
                                   "--device", DEVICE])
    intake_s = time.perf_counter() - t0
    with open(os.path.join(root, "intake_out", "diagnoses.csv")) as f:
        rows = {r["file"]: r for r in csv.DictReader(f)}
    check(summary["n_diagnosed"] == len(names) and summary["n_skipped"] == 1
          and "unregistered scan" in rows["zz_unregistered.obj"]["error"],
          f"batch intake summary {summary}")
    got = [rows[n]["label"] for n in names]
    check(got == labels, f"batch intake labels {got} vs phase 9's "
          f"diagnose {labels}")

    # refit the zoo last (it rewrites the run's classifiers.npz)
    from craniofacialsd_vae_tpu_torch.data.dataset import BatchIterator

    t0 = time.perf_counter()
    mgr = card_t._manager
    mgr.train_and_validate_classifiers(
        card_t._train_iter, BatchIterator(
            split["val"], card_t._train_iter.batch_size, shuffle=False,
            drop_last=False),
        checkpoint_dir=os.path.join(run_dir, "checkpoints"))
    card_t.test_classifiers()
    torch.cuda.synchronize()
    experiment_s["refit_classifiers"] = time.perf_counter() - t0
    del card_t, mgr
    torch.cuda.empty_cache()

    # phase 7's traversals at each save epoch: their files
    traversal_files = {}
    for run, epochs in (("entry", range(ENTRY_CADENCE, ENTRY_EPOCHS[1] + 1,
                                        ENTRY_CADENCE)),
                        ("entry_steps", range(ENTRY_CADENCE,
                                              ENTRY_EPOCHS[0] + 1,
                                              ENTRY_CADENCE))):
        for e in epochs:
            found = check_figures(
                os.path.join(root, "outputs", run),
                [p.format(e) for p in TRAVERSAL_FILES],
                traversal_frames(latent, e))
            traversal_files.update({os.path.join(run, k): v
                                    for k, v in found.items()})

    line = {"phase": "evaluation", "card": smi,
            "standard": {"s": standard_s, "parts_s": parts.seconds,
                         "metrics": metrics,
                         "profiled": {k: prof[k] for k in (
                             "wall_ms", "device_ms", "idle_share",
                             "kernels_run", "copies")},
                         "figures": figures},
            "experiments_s": experiment_s,
            "experiment_files": experiment_files,
            "overlays": len(overlays),
            "card_vs_host": {"fp32": rel, "mixed": mixed_rel,
                             "card_s": card["seconds"],
                             "host_s": host["seconds"],
                             "host_total_s": host_s,
                             "fit_k8": card["fit_k8"]},
            "batch_intake": {"s": intake_s, "scans": len(names) + 1,
                             "labels": summary["labels"]},
            "traversal_files": traversal_files,
            "steps_s": steps_s,
            "launches": counts, "replayed": PATH_REPLAYS["evaluation"],
            "seconds": time.perf_counter() - t_start}
    log(json.dumps(line, default=float))
    return dict(line=line, records=records)


# ----------------------------------------------------------------------
# phase 12: the figures
TSNE_P_RTOL = 1e-10             # card vs host t-SNE P, of its max (float64)
TSNE_RTOL = 1e-3                # card vs host embedding after 250
#                                 iterations from one start, of max |Y|
#                                 (float32 steps, reductions in another
#                                 order)


def phase_figures(torch, root: str, run_dir: str, smi: str) -> dict:
    """Phase 12: the figures on phase 7's (fp32) run dir after phase 11
    (see the module docstring)."""
    from craniofacialsd_vae_tpu_torch import visualize_in_batch
    from craniofacialsd_vae_tpu_torch.analysis import tsne
    from craniofacialsd_vae_tpu_torch.viz import jpeg

    t_start = time.perf_counter()
    secs = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        return out

    reset_counts()
    tester, _ = evaluation_tester(run_dir, DEVICE, run_dir)
    mgr = tester._manager

    # t-SNE of the train and test latents, card against host from one
    # start at sklearn's minimum of 250 iterations; then the Tester's
    # t-SNE figures (1000 iterations on the card)
    tr_z, _ = tester._train_latents()
    ts_z, _ = mgr.encode_all(tester._test_iter, False)
    x = np.concatenate([tr_z, ts_z]).astype(np.float32)
    y0 = tsne.random_init(len(x), torch.Generator(
        device=DEVICE).manual_seed(SEED))
    card = timed("tsne_card_250", lambda: tsne.tsne(
        x, init=y0, max_iter=250, device=DEVICE))
    host = timed("tsne_host_250", lambda: tsne.tsne(
        x, init=y0.cpu(), max_iter=250, device="cpu"))
    tsne_rel = {"P": rel_to_max(card["P"].cpu().numpy(),
                                host["P"].numpy()),
                "embedding": rel_to_max(card["embedding"],
                                        host["embedding"])}
    check(tsne_rel["P"] <= TSNE_P_RTOL
          and tsne_rel["embedding"] <= TSNE_RTOL,
          f"t-SNE card vs host {tsne_rel} (bars {TSNE_P_RTOL}, {TSNE_RTOL})")
    timed("tsne_figures", lambda: tester.plot_embeddings("tsne"))
    files = check_figures(run_dir, [n.format("tsne")
                                    for n in EMBEDDING_FILES])
    emb = tester.figure_data["tsne_emb_train_vs_test.svg"]
    check(np.isfinite(emb["x1"]).all() and np.isfinite(emb["x2"]).all()
          and len(emb["x1"]) == len(x), "t-SNE embedding")

    # the JPEG of one traversal frame (a mesh and its error map), encoded
    # from card tensors and on the host
    z = np.zeros((2, mgr.model_latent_size), np.float32)
    z[1, 0] = 3.0
    gen = mgr.generate(z)
    gen = tester._unnormalize(gen.cpu().numpy() if torch.is_tensor(gen)
                              else np.asarray(gen))
    diffs = np.asarray(mgr.compute_vertex_errors(
        gen, np.broadcast_to(gen[0], gen.shape)))
    frame = np.concatenate([tester._render(gen),
                            tester._render(gen, diffs, 5)], axis=2)[-1]
    eight = (np.clip(frame, 0, 1) * 255).astype(np.uint8)
    jpg_card = timed("jpeg_card", lambda: jpeg.encode_jpeg(
        torch.as_tensor(eight, device=DEVICE)))
    jpg_host = timed("jpeg_host", lambda: jpeg.encode_jpeg(eight))
    check(jpg_card == jpg_host and jpg_card[:2] == b"\xff\xd8"
          and jpg_card[-2:] == b"\xff\xd9",
          f"JPEG card ({len(jpg_card)} B) vs host ({len(jpg_host)} B)")

    # visualize_in_batch on the run's octasphere template: the card's
    # PLYs equal the host's
    template = tester._config["data"]["template_path"]
    plys_card = timed("visualize_card", lambda: visualize_in_batch.main([
        "--template", template, "--out", os.path.join(root, "swap_card"),
        "--device", DEVICE]))
    plys_host = timed("visualize_host", lambda: visualize_in_batch.main([
        "--template", template, "--out", os.path.join(root, "swap_host"),
        "--device", "cpu"]))
    check(len(plys_card) == 16,
          f"visualize_in_batch wrote {len(plys_card)}")
    for a, b in zip(plys_card, plys_host):
        with open(a, "rb") as f, open(b, "rb") as g:
            check(f.read() == g.read(), f"{a} differs card vs host")
    counts = read_counts(torch, "figures")

    line = {"phase": "figures", "card": smi, "seconds_by_part": secs,
            "tsne": {"n": len(x), "card_vs_host": tsne_rel},
            "jpeg_bytes": len(jpg_host), "files": files,
            "launches": {k: v for k, v in counts.items() if v},
            "replayed": {k: v for k, v in PATH_REPLAYS["figures"].items()
                         if v},
            "seconds": time.perf_counter() - t_start}
    log(json.dumps(line, default=float))
    return line


# ----------------------------------------------------------------------
# ----------------------------------------------------------------------
# phase 13: data parallelism and vertex sharding at world size 1

PARALLEL_STEPS = 4              # the scanned epochs' steps in (a) and (d)
PARALLEL_REPS = 10              # timed eager steps; epochs are timed 5 x
PARALLEL_REPLICAS = 2           # (c): the card named twice, as two cards
PARALLEL_SERVE_RTOL = 1e-5      # (c) against the single-device service, of
#                                 each array's max: a replica runs half a
#                                 bucket, where cuBLAS may pick another
#                                 kernel (the CPU tests' tolerance)
VS_FWD_BATCH = 3                # the sharded forward's scans in (d)
VS_RTOL = 1e-4                  # sharded (D = 1) vs unsharded on the card:
#                                 the forward against max |out|, a step's
#                                 losses and each gradient against its max
#                                 (the sums grouped otherwise, the
#                                 transposes capped over every position)


def parallel_group(root: str) -> None:
    """A world-size-1 NCCL process group on the card, its rendezvous a
    file under ``root``."""
    from craniofacialsd_vae_tpu_torch.parallel import initialize_multihost

    path = os.path.join(root, "rendezvous_parallel")
    if os.path.exists(path):
        os.remove(path)
    initialize_multihost(num_processes=1, process_id=0, device=DEVICE,
                         init_method="file://" + path, timeout_s=600)


def scanned_steps(warmup: int) -> tuple:
    """A PARALLEL_STEPS-step scanned epoch's eager steps (counted by the
    wrappers) and replayed steps: on the card its graph's warm-up and
    capture, then a replay a step; on the host every step eagerly."""
    if DEVICE == "cuda":
        return warmup + 1, PARALLEL_STEPS
    return PARALLEL_STEPS, 0


def parallel_draws(torch, latent: int):
    """``draws(step_id, rows)`` of the phase: a host generator seeded by
    the step id."""
    def draws(sid, rows):
        g = torch.Generator().manual_seed(SEED + 100 + int(sid))
        return (int(torch.randint(0, N_REGIONS, (), generator=g)),
                torch.randn((rows, latent), generator=g))
    return draws


def parallel_steps(torch, bundle, config, smi: str) -> dict:
    """(a) the data-parallel step and scanned epoch (``parallel.
    make_parallel_train_step``, ``make_scanned_parallel_step``: the
    all-reduce inside the captured graph) against the single-device ones
    (``make_train_step``, ``make_scanned_train_step``) from the same
    weights, scans and draws: metrics, parameters and Adam states
    bit-equal. Counted: the step's launches, the epoch's warm-up and
    capture, its replays."""
    import torch.distributed as dist

    from craniofacialsd_vae_tpu_torch import parallel
    from craniofacialsd_vae_tpu_torch.models import init_sdvae
    from craniofacialsd_vae_tpu_torch.training import (
        LOSS_KEYS, LossWeights, coupled_adam, make_scanned_train_step,
        make_train_step)
    from craniofacialsd_vae_tpu_torch.training.trainer import WARMUP_STEPS

    b = TRAIN_CONFIG["batch_size"]
    grid = b * b
    weights = LossWeights.from_config(TRAIN_CONFIG)
    geom = training_geometry(bundle).to(DEVICE)
    data, region, eps = training_inputs(torch, bundle, config)
    data_dev = torch.as_tensor(data, device=DEVICE)
    x = data_dev[:b]
    draws = parallel_draws(torch, config.latent_size)
    rng = np.random.default_rng(SEED + 12)
    idx = rng.integers(0, len(data), size=(PARALLEL_STEPS, b)).astype(
        np.int32)
    sids = 1 + np.arange(PARALLEL_STEPS)
    lr, wd = TRAIN_CONFIG["lr"], TRAIN_CONFIG["weight_decay"]
    mesh = parallel.make_data_mesh()
    check(mesh.ranks and mesh.world == 1
          and dist.get_backend() == parallel.mesh.backend_for(DEVICE),
          f"the data mesh {mesh} is not one rank of {DEVICE}'s backend")

    def fresh():
        model = init_sdvae(config, geom, torch.Generator().manual_seed(SEED))
        return model, coupled_adam(model.parameters(), lr, wd)

    ma, oa = fresh()
    mb, ob = fresh()
    step_a = make_train_step(ma, weights, oa, b)
    step_b = parallel.make_parallel_train_step(mb, weights, ob, b, mesh)
    epoch_a = make_scanned_train_step(ma, weights, oa, b, draws=draws)
    epoch_b = parallel.make_scanned_parallel_step(mb, weights, ob, b, mesh,
                                                  draws=draws)
    m_a = step_a(x, region_idx=region, eps=eps.to(DEVICE))
    r_a = epoch_a(data_dev, idx, sids)
    # the main path: counts from 0, one step and one scanned epoch
    reset_counts()
    m_b = step_b(x, region_idx=region, eps=eps.to(DEVICE))
    r_b = epoch_b(data_dev, idx, sids)
    counts = read_counts(torch, "parallel_training")
    for k in LOSS_KEYS:
        check(torch.equal(m_a[k], m_b[k]), f"data-parallel step {k}: "
              f"{float(m_b[k])!r} vs {float(m_a[k])!r}")
    check(r_a == r_b, f"data-parallel epoch {r_b} vs {r_a}")
    for i, (ta, tb) in enumerate(zip(state_tensors(ma, oa),
                                     state_tensors(mb, ob))):
        check(torch.equal(ta, tb), f"data-parallel state tensor {i} "
              "differs from the single-device one")
    one = expected_step_launches(mb, geom, grid)
    eager, replays_n = scanned_steps(WARMUP_STEPS)
    want = {k: (1 + eager) * v for k, v in one.items()}
    check(counts == want, f"data-parallel launches {counts}, expected "
          f"{want} (a step, then the epoch's warm-up and capture)")
    replayed = PATH_REPLAYS["parallel_training"]
    check(replayed == {k: replays_n * v for k, v in one.items()},
          f"data-parallel replays {replayed}")
    replays = check_replays(torch, [r.graph for r in
                                    epoch_b.steps.runners.values()],
                            "parallel_training")
    # times, in turns, within this run
    t = {}
    for name, fn in (("step_single", lambda: step_a(
            x, region_idx=region, eps=eps.to(DEVICE))),
            ("step_parallel", lambda: step_b(
                x, region_idx=region, eps=eps.to(DEVICE)))):
        t[name] = timed(torch, fn, PARALLEL_REPS)
    for name, fn in (("epoch_single", lambda: epoch_a(data_dev, idx, sids)),
                     ("epoch_parallel",
                      lambda: epoch_b(data_dev, idx, sids))):
        t[name] = [v / PARALLEL_STEPS for v in timed(torch, fn, 5)]
    line = {"world": mesh.world, "backend": dist.get_backend(),
            "launches": counts, "replayed": replayed,
            "replays_checked": replays,
            **{f"{k}_p50_ms": p50(v) for k, v in t.items()}}
    log(f"[13a parallel] world 1 over {dist.get_backend()}: the step and a "
        f"{PARALLEL_STEPS}-step scanned epoch bit-equal to the "
        f"single-device ones; step p50 {line['step_parallel_p50_ms']:.3f} "
        f"ms (single {line['step_single_p50_ms']:.3f}), scanned epoch "
        f"{line['epoch_parallel_p50_ms']:.3f} ms a step (single "
        f"{line['epoch_single_p50_ms']:.3f}); {smi}")
    return dict(line=line, counts=counts)


def parallel_entry(torch, root: str, cfg_path: str, smi: str) -> dict:
    """(b) ``train.main --data_parallel`` for one epoch on phase 7's
    workspace: with one card it makes its own world-size-1 group (a file
    rendezvous in the run's directory) and trains in process; counted.
    Then the same epoch without ``--data_parallel``, counted apart: its
    losses and checkpoint bit-equal, and its launches and replays the
    ``--data_parallel`` run's, kernel for kernel: so the path runs each
    kernel at the ``train_entry`` path's shapes (the same entry point on
    the same workspace)."""
    import torch.distributed as dist

    from craniofacialsd_vae_tpu_torch import train as entry
    from craniofacialsd_vae_tpu_torch.training.checkpoint import \
        read_checkpoint

    runs = {}
    for path, extra in (("parallel_entry", ["--data_parallel"]),
                        ("parallel_entry_single", [])):
        reset_counts()
        t0 = time.perf_counter()
        res = entry.main(["--config", cfg_path, "--id", path,
                          "--output_path", root, "--device", DEVICE,
                          "--epochs", "1", *extra])
        res["run_s"] = time.perf_counter() - t0
        res["counts"] = read_counts(torch, path)
        runs[path] = res
    # the --data_parallel run's graphs replayed under the profiler
    res = runs["parallel_entry"]
    replays = check_replays(torch, graphs_of(managers=[res.pop("manager")]),
                            "parallel_entry")
    del runs["parallel_entry_single"]["manager"]
    single = runs["parallel_entry_single"]
    counts = res["counts"]
    check(res["world"] == 1 and not dist.is_initialized(),
          f"--data_parallel ran at world {res.get('world')} and left its "
          "group")
    hist = res["history"]
    check(len(hist) == 1 and all(np.isfinite(v) for v in
                                 hist[0]["train"].values()),
          f"--data_parallel history {hist}")
    check([h["train"] for h in hist] == [h["train"] for h in
                                         single["history"]],
          f"--data_parallel losses {hist[0]['train']} against the "
          f"single-device run's {single['history'][0]['train']}")
    ckpts = [read_checkpoint(os.path.join(r["checkpoint_dir"],
                                          "model_00000001.ckpt"))
             for r in (res, single)]
    same_tree(*ckpts, "--data_parallel vs single-device checkpoint")
    check(counts == single["counts"]
          and PATH_REPLAYS["parallel_entry"]
          == PATH_REPLAYS.pop("parallel_entry_single"),
          f"--data_parallel launches {counts} (replays "
          f"{PATH_REPLAYS['parallel_entry']}) against the single-device "
          f"run's {single['counts']}")
    for kernel in ("spiral_conv_tc", "spiral_conv_narrow", "ell_matmul_fwd",
                   "ell_matmul_capped", "spiral_conv_dw"):
        check(counts[kernel] > 0,
              f"{kernel} was not launched on the --data_parallel path")
    line = {"run_s": res["run_s"], "epoch_s": hist[0]["epoch_s"],
            "single_run_s": single["run_s"],
            "single_epoch_s": single["history"][0]["epoch_s"],
            "train": hist[0]["train"], "launches": counts,
            "replayed": PATH_REPLAYS["parallel_entry"],
            "replays_checked": replays}
    log(f"[13b parallel entry] --data_parallel, one epoch: "
        f"{res['run_s']:.1f} s (epoch {hist[0]['epoch_s']:.2f} s; single "
        f"device {single['run_s']:.1f} s, {line['single_epoch_s']:.2f} s), "
        f"tot {hist[0]['train']['tot']:.5g}, losses, checkpoint, launches "
        f"and replays equal to the single-device run's; {smi}")
    return dict(line=line, counts=counts)


def parallel_serving(torch, mods, run_dir: str, smi: str) -> dict:
    """(c) ``DiagnosisService(data_parallel=True)`` on phase 7's run dir
    over the card named PARALLEL_REPLICAS times: a replica each, with its
    own bucket graphs and fit graph, as over as many cards. Counted:
    ``encode``, ``reconstruct`` and ``diagnose`` at every request size
    and one fit, its restarts split between the replicas; the launches
    exactly those of the model passes the path ran (``PassShapes``) and
    of the replicas' fits, every kernel held at those shapes (the path's
    own records). Every answer against the single-device service's:
    arrays within PARALLEL_SERVE_RTOL of their max, labels equal; fits
    of FIT_PARITY_ITERATIONS with the same best restart and z within it;
    the counted fits' objectives within FIT_RTOL."""
    from craniofacialsd_vae_tpu_torch.analysis.fitting import \
        WARMUP_ITERATIONS
    from craniofacialsd_vae_tpu_torch.data.dataset import build_datasets
    from craniofacialsd_vae_tpu_torch.serving import DiagnosisService
    from craniofacialsd_vae_tpu_torch.utils import get_config

    kernels = mods["kernels"]
    config = get_config(os.path.join(run_dir, "config.yaml"))
    train_set, _, _, norm, _ = build_datasets(config)
    raw = (np.asarray(train_set.x[:REQUEST_SIZES[-1]]) * norm["std"]
           + norm["mean"]).astype(np.float32)
    scans = {b: raw[:b] for b in REQUEST_SIZES}
    fits = {}

    def requests(svc):
        out = {b: (svc.encode(x), svc.reconstruct(x), svc.diagnose(x))
               for b, x in scans.items()}
        fits["scan"] = fit_scan(np.asarray(svc.manager.template.pos,
                                           np.float64), svc.landmark_idx)
        t0 = time.perf_counter()
        out["fit"] = svc.fit(*fits["scan"], iterations=FIT_ITERATIONS,
                             n_restarts=FIT_RESTARTS, seed=SEED)
        out["fit_s"] = time.perf_counter() - t0
        return out

    # the main path: counts from 0, the service built and every request
    # answered once; counts read
    reset_counts()
    with PassShapes() as rec:
        dp = DiagnosisService.from_run_dir(
            run_dir, max_batch=BATCH, device=DEVICE, data_parallel=True,
            devices=[DEVICE] * PARALLEL_REPLICAS)
        got = requests(dp)
    counts = read_counts(torch, "parallel_serving")
    replays = check_replays(torch, graphs_of(dp), "parallel_serving")
    n_dev = dp.stats()["n_devices"]
    check(n_dev == PARALLEL_REPLICAS
          and all(b % n_dev == 0 for b in dp.buckets)
          and {k[2] for k in dp._bucket_graphs} == set(range(n_dev)),
          f"the data-parallel service spans {n_dev} replicas, buckets "
          f"{dp.buckets}, graphs {sorted(dp._bucket_graphs)}")

    # every kernel of the path at its shapes there; the launches those
    # shapes account for are the counted run's, kernel for kernel: each
    # replica's fit runs FIT_RESTARTS / n_dev restarts, its warm-up and
    # capture launched (backward included), then its final losses
    per = FIT_RESTARTS // n_dev
    fit_iters = WARMUP_ITERATIONS + 1
    rec.passes["dec_bwd"][per] += n_dev * fit_iters
    shapes = diagnosis_shapes(torch, mods, dp.manager, rec.passes)
    k8 = k8_case(torch, mods, per, FIT_GEN_POINTS, FIT_SCAN_POINTS // 4, 50)
    torch.cuda.empty_cache()
    want = dict.fromkeys(kernels.KERNEL_NAMES, 0)
    want.update(k8_fwd=n_dev * (fit_iters + 1), k8_bwd=n_dev * fit_iters)
    for kernel, entries in shapes.items():
        want[kernel] += sum(e["launches"] for e in entries)
    check(counts == want, f"parallel_serving: launches {counts}, expected "
          f"{want} from its passes {rec.passes} and {n_dev} fits of {per} "
          "restarts")
    records = [summarize(k, *KERNEL_SOURCES[k], entries)
               for k, entries in shapes.items()]
    records += [summarize("k8_fwd", *KERNEL_SOURCES["k8_fwd"], [k8]),
                summarize("k8_bwd", *KERNEL_SOURCES["k8_bwd"], [k8["bwd"]])]
    for r in records:
        r.update(path="parallel_serving", launches=counts[r["name"]])

    # the same requests on the single-device service
    one = DiagnosisService.from_run_dir(run_dir, max_batch=BATCH,
                                        device=DEVICE)
    check(dp.buckets == [b * n_dev for b in one.buckets
                         if b * n_dev <= BATCH],
          f"buckets {dp.buckets}: not the single service's {one.buckets} "
          f"times {n_dev}")
    ref = requests(one)
    errs = {}

    def close(g, w, what):
        g, w = np.asarray(g), np.asarray(w)
        check(g.shape == w.shape, f"{what}: shape {g.shape} vs {w.shape}")
        e = float(np.abs(g - w).max()) / max(float(np.abs(w).max()), 1e-30)
        errs[what] = max(errs.get(what, 0.0), e)
        check(e <= PARALLEL_SERVE_RTOL, f"{what}: {e:.3e} of its max from "
              "the single-device service's")

    for b in scans:
        close(got[b][0], ref[b][0], "encode")
        for k, v in ref[b][1].items():
            close(got[b][1][k], v, f"reconstruct {k}")
        check([r["label"] for r in got[b][2]]
              == [r["label"] for r in ref[b][2]], f"diagnose B={b}")
        for r, w in zip(got[b][2], ref[b][2]):
            close(r["latent"], w["latent"], "diagnose latent")
    held = {s: s.fit(*fits["scan"], iterations=FIT_PARITY_ITERATIONS,
                     n_restarts=FIT_RESTARTS, seed=SEED) for s in (dp, one)}
    check(held[dp]["best_restart"] == held[one]["best_restart"],
          f"fit of {FIT_PARITY_ITERATIONS} iterations: best restart "
          f"{held[dp]['best_restart']} vs {held[one]['best_restart']}")
    close(held[dp]["z"], held[one]["z"], "fit z")
    close(held[dp]["chamfer_mm2"], held[one]["chamfer_mm2"], "fit chamfer")

    def objective(f):
        return 10.0 * f["landmark_mse_mm2"] + f["chamfer_mm2"]

    fit_rel = abs(objective(got["fit"]) - objective(ref["fit"])) \
        / objective(ref["fit"])
    check(fit_rel <= FIT_RTOL, f"the counted fits' objectives "
          f"{objective(got['fit'])} vs {objective(ref['fit'])}")
    lat = {"parallel": serve_latency(dp, scans),
           "single": serve_latency(one, scans)}
    line = {"replicas": n_dev, "buckets": dp.buckets,
            "bucket_graphs": len(dp._bucket_graphs),
            "max_rel_err": errs, "bit_equal": not any(errs.values()),
            "fit_objective_rel": fit_rel,
            "fit_best_restart": [got["fit"]["best_restart"],
                                 ref["fit"]["best_restart"]],
            "fit_s": got["fit_s"], "fit_single_s": ref["fit_s"],
            "reconstruct_p50_ms": {k: {b: v["p50_ms"] for b, v in d.items()}
                                   for k, d in lat.items()},
            "passes": {k: dict(v) for k, v in rec.passes.items()},
            "launches": counts, "replayed": PATH_REPLAYS["parallel_serving"],
            "replays_checked": replays}
    log(f"[13c parallel serving] data_parallel over the card named {n_dev} "
        f"times: launches as its passes and fits predict; every answer "
        f"within {PARALLEL_SERVE_RTOL} of the single-device service's "
        f"(worst {max(errs.values()):.2e}, bit-equal {line['bit_equal']}), "
        f"the counted fits' objectives {fit_rel:.2e} apart; reconstruct "
        f"p50 {line['reconstruct_p50_ms']} ms; fit {got['fit_s']:.2f} s "
        f"(single {ref['fit_s']:.2f}); {smi}")
    del dp, one
    return dict(line=line, counts=counts, records=records)


def vertex_convs(vs, params) -> list:
    """``(name, conv, level)`` of every spiral conv of the sharded model's
    forward, in its order."""
    n = len(params.en_convs)
    out = [(f"enc{i}", params.en_convs[i], vs.enc_levels[i])
           for i in range(n)]
    out += [(f"dec{n - 1 - j}", params.de_convs[j], vs.dec_levels[n - 1 - j])
            for j in range(n)]
    out.append(("final", params.final_conv, vs.dec_levels[0]))
    return out


def vertex_tables(vs, params, batch: int, train: bool) -> list:
    """``(name, matrix, source rows, D)`` of every K4 product of the
    sharded forward at ``batch`` (each conv's and up-pool's send table,
    the up-pools), and for a train step the Laplacian's and every
    backward's transposes (none for the first conv, whose input needs no
    gradient): the send tables' and the up-pools'; a conv's dx is one
    K2-dx (``vertex_launches``)."""
    out = []
    n = len(params.de_convs)
    for name, conv, lv in vertex_convs(vs, params):
        c_in = conv.w.shape[0] // lv.op.seq_length
        out.append((f"{name} send", lv.send, lv.send.n_cols, batch * c_in))
        if name.startswith("dec"):
            level = int(name[3:])
            up = vs.up_levels[level]
            out += [(f"up{level} send", up.send, up.send.n_cols, batch * c_in),
                    (f"up{level}", up.op, up.op.n_cols, batch * c_in)]
    if not train:
        return out
    lap = vs._loss_tables()["lap"]
    out += [("lap send", lap.send, lap.send.n_cols, 3 * batch),
            ("lap", lap.op, lap.op.n_cols, 3 * batch),
            ("lap T", lap.op.transpose, lap.op.cols.shape[0], 3 * batch),
            ("lap send T", lap.send.transpose, lap.send.cols.shape[0],
             3 * batch)]
    for name, conv, lv in vertex_convs(vs, params)[1:]:
        c_in = conv.w.shape[0] // lv.op.seq_length
        out.append((f"{name} send T", lv.send.transpose,
                    lv.send.cols.shape[0], batch * c_in))
        if name.startswith("dec"):
            level = int(name[3:])
            up = vs.up_levels[level]
            out += [(f"up{level} T", up.op.transpose, up.op.cols.shape[0],
                     batch * c_in),
                    (f"up{level} send T", up.send.transpose,
                     up.send.cols.shape[0], batch * c_in)]
    return out


def vertex_launches(vs, params, batch: int, train: bool) -> dict:
    """The launches of a sharded forward (``train``: a train step) at
    ``batch``: K1 per conv, K2-dW per conv of a step and K2-dx per conv
    of a step but the first, and per table of ``vertex_tables`` K4, or the
    fused K4 where it has tiers."""
    from craniofacialsd_vae_tpu_torch import kernels

    counts = dict.fromkeys(kernels.KERNEL_NAMES, 0)
    for i, (name, conv, lv) in enumerate(vertex_convs(vs, params)):
        counts[conv_kernel(name, conv, lv.op, None, "gather")] += 1
        counts["spiral_conv_dw"] += int(train)
        counts["spiral_conv_dx"] += int(train and i > 0)
    for _, mat, _, _ in vertex_tables(vs, params, batch, train):
        counts["ell_matmul_capped" if tiers_of(mat)
               else "ell_matmul_fwd"] += 1
    return counts


def parallel_vertex(torch, mods, bundle, config, ptxas: list,
                    smi: str) -> dict:
    """(d) ``VertexShardedModel`` at D = 1 over NCCL on the fixture
    hierarchy (the training phase's model and stand-ins), counted: one
    forward and one train step, each against the unsharded model's, and
    a scanned epoch (its steps replayed from a graph with the
    collectives inside) against as many sharded steps, bit for bit; the
    launches those account for; then every kernel at the sharded path's
    shapes (its local tables over [rows ‖ halo]) against its twin."""
    from craniofacialsd_vae_tpu_torch.geometry import (level0_positions,
                                                       standin_laplacian_coo,
                                                       standin_region_masks)
    from craniofacialsd_vae_tpu_torch.models import init_sdvae
    from craniofacialsd_vae_tpu_torch.parallel.vertex_sharding import (
        VertexShardedModel, make_vertex_mesh)
    from craniofacialsd_vae_tpu_torch.training import (
        LOSS_KEYS, LossWeights, coupled_adam, make_train_step)
    from craniofacialsd_vae_tpu_torch.training.trainer import WARMUP_STEPS

    kernels, ops = mods["kernels"], mods["ops"]
    b = TRAIN_CONFIG["batch_size"]
    grid = b * b
    weights = LossWeights.from_config(TRAIN_CONFIG)
    lr, wd = TRAIN_CONFIG["lr"], TRAIN_CONFIG["weight_decay"]
    geom = training_geometry(bundle).to(DEVICE)
    t0 = time.perf_counter()
    vs = VertexShardedModel(
        bundle, config, make_vertex_mesh(),
        laplacian=standin_laplacian_coo(bundle.spirals[0]),
        region_masks=standin_region_masks(level0_positions(bundle),
                                          N_REGIONS))
    vs._loss_tables()
    build_s = time.perf_counter() - t0
    data, region, eps = training_inputs(torch, bundle, config)
    data_dev = torch.as_tensor(data, device=DEVICE)

    def fresh():
        model = init_sdvae(config, geom, torch.Generator().manual_seed(SEED))
        return model, coupled_adam(model.parameters(), lr, wd)

    ma, oa = fresh()
    mb, ob = fresh()
    mc, oc = fresh()
    fwd = vs.make_forward()
    x_fwd = data_dev[:VS_FWD_BATCH].transpose(0, 1).contiguous()
    x_step = data_dev[:b].transpose(0, 1).contiguous()
    step_b = vs.make_train_step(mb, weights, ob, b)
    draws = parallel_draws(torch, config.latent_size)
    data_vm = data_dev.transpose(0, 1).contiguous()      # [N, n, 3]
    rng = np.random.default_rng(SEED + 14)
    idx = rng.integers(0, len(data), size=(PARALLEL_STEPS, b)).astype(
        np.int32)
    sids = 1 + np.arange(PARALLEL_STEPS)
    epoch_c = vs.make_scanned_epoch(mc, weights, oc, b, draws=draws)
    # the main path: counts from 0, one forward, one step, one epoch
    reset_counts()
    out, mu, _ = fwd(mb, x_fwd)
    m_b = step_b(x_step, region, eps.to(DEVICE))
    m_c = epoch_c(data_vm, idx, sids)
    counts = read_counts(torch, "vertex_sharded")
    one = vertex_launches(vs, mb, grid, True)
    eager, replays_n = scanned_steps(WARMUP_STEPS)
    want = vertex_launches(vs, mb, VS_FWD_BATCH, False)
    for k, v in one.items():
        want[k] += (1 + eager) * v
    check(counts == want, f"vertex-sharded launches {counts}, expected "
          f"{want} (a forward, a step, the epoch's warm-up and capture)")
    replayed = PATH_REPLAYS["vertex_sharded"]
    check(replayed == {k: replays_n * v for k, v in one.items()},
          f"vertex-sharded replays {replayed}")
    # the epoch against as many eager sharded steps
    md, od = fresh()
    step_d = vs.make_train_step(md, weights, od, b)
    sums = None
    for t, sid in enumerate(sids):
        r_t, e_t = draws(int(sid), grid)
        m_t = step_d(data_vm[:, torch.as_tensor(idx[t], device=DEVICE)
                             .long()].contiguous(), r_t, e_t.to(DEVICE))
        vec = torch.stack([m_t[k].float() for k in LOSS_KEYS])
        sums = vec if sums is None else sums + vec
    sums = sums.cpu().numpy()
    check(m_c == {k: float(sums[i]) / PARALLEL_STEPS
                  for i, k in enumerate(LOSS_KEYS)},
          f"vertex-sharded epoch {m_c} vs its steps {sums}")
    for i, (tc, td) in enumerate(zip(state_tensors(mc, oc),
                                     state_tensors(md, od))):
        check(torch.equal(tc, td), f"vertex-sharded epoch: state tensor {i} "
              "differs from its eager steps'")
    replays = check_replays(torch, [r.graph for r in
                                    epoch_c.steps.runners.values()],
                            "vertex_sharded")
    with torch.no_grad():
        mu_r, _ = ma.encode(x_fwd)
        out_r = ma.decode(mu_r)
    fwd_err = max_err(out, out_r) / float(out_r.abs().max())
    mu_err = max_err(mu, mu_r) / float(mu_r.abs().max())
    check(fwd_err <= VS_RTOL and mu_err <= VS_RTOL,
          f"sharded forward vs unsharded: out {fwd_err:.2e}, mu "
          f"{mu_err:.2e} of their max")
    m_a = make_train_step(ma, weights, oa, b)(
        data_dev[:b], region_idx=region, eps=eps.to(DEVICE))
    loss_err = {}
    for k in ("reconstruction", "kl", "laplacian", "latent_consistency",
              "tot"):
        got, ref = float(m_b[k]), float(m_a[k])
        loss_err[k] = abs(got - ref) / abs(ref)
        check(np.isfinite(got) and loss_err[k] <= VS_RTOL,
              f"sharded step {k}: {got!r} vs unsharded {ref!r}")
    grad_err = {}
    for (name, pa), pb in zip(ma.named_parameters(), mb.parameters()):
        grad_err[name] = max_err(pb.grad, pa.grad) / float(
            pa.grad.abs().max())
        check(grad_err[name] <= VS_RTOL, f"sharded gradient {name}: "
              f"{grad_err[name]:.2e} of its max")
    t = {"forward_sharded": timed(torch, lambda: fwd(mb, x_fwd),
                                  PARALLEL_REPS),
         "step_sharded": timed(torch, lambda: step_b(
             x_step, region, eps.to(DEVICE)), PARALLEL_REPS),
         "step_unsharded": timed(torch, lambda: make_train_step(
             ma, weights, oa, b)(data_dev[:b], region_idx=region,
                                 eps=eps.to(DEVICE)), PARALLEL_REPS),
         "epoch_sharded": [v / PARALLEL_STEPS for v in timed(
             torch, lambda: epoch_c(data_vm, idx, sids), 5)]}

    # every kernel at the path's shapes against its twin
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 13)
    convs = vertex_convs(vs, mb)
    k1 = [k1_shape(torch, kernels, ops, gen, name, conv, lv.op, batch)
          for batch in (VS_FWD_BATCH, grid) for name, conv, lv in convs]
    k2 = k2_parity(torch, mods, None, None, grid, ptxas,
                   convs=[(n, c, lv.op) for n, c, lv in convs])
    dx = k2dx_parity(torch, mods, [(n, c, lv.op, torch.float32)
                                   for n, c, lv in reversed(convs[1:])],
                     (grid,), "13d")
    k4 = [k4_table_shape(torch, mods, gen, name, mat, n_src, d)
          for batch, train in ((VS_FWD_BATCH, False), (grid, True))
          for name, mat, n_src, d in vertex_tables(vs, mb, batch, train)]
    records = [summarize(kernel, *KERNEL_SOURCES[kernel],
                         [s for s in k1 if s["kernel"] == kernel])
               for kernel in ("spiral_conv_tc", "spiral_conv_narrow")]
    records.append(summarize("ell_matmul_fwd",
                             *KERNEL_SOURCES["ell_matmul_fwd"],
                             [e for e in k4 if not e["tiers"]]))
    capped = [e for e in k4 if e["tiers"]]
    if capped:
        records.append(summarize("ell_matmul_capped",
                                 *KERNEL_SOURCES["ell_matmul_capped"],
                                 capped))
    records += [k2, dx]
    for rec in records:
        rec["path"] = "vertex_sharded"
        rec["launches"] = counts[rec["name"]]
        check(rec["launches"] > 0, f"{rec['name']} was not launched on the "
              "vertex-sharded path")
    line = {"vertex_ranks": vs.n_devices, "build_s": build_s,
            "forward_rel": fwd_err, "mu_rel": mu_err,
            "loss_rel": loss_err, "worst_grad_rel": max(grad_err.values()),
            "launches": counts, "replayed": replayed,
            "replays_checked": replays,
            **{f"{k}_p50_ms": p50(v) for k, v in t.items()}}
    log(f"[13d vertex sharding] D = 1 over {vs.mesh.device}: tables built in "
        f"{build_s:.2f} s; forward vs unsharded {fwd_err:.2e}, step losses "
        f"{max(loss_err.values()):.2e}, gradients "
        f"{line['worst_grad_rel']:.2e}; forward p50 "
        f"{line['forward_sharded_p50_ms']:.3f} ms (B={VS_FWD_BATCH}), step "
        f"p50 {line['step_sharded_p50_ms']:.3f} ms (unsharded "
        f"{line['step_unsharded_p50_ms']:.3f}), scanned epoch "
        f"{line['epoch_sharded_p50_ms']:.3f} ms a step; launches {counts}; "
        f"{smi}")
    return dict(line=line, records=records)


def phase_parallel(torch, mods, bundle, config, root: str, cfg_path: str,
                   run_dir: str, by_path: dict, ptxas: list,
                   smi: str) -> dict:
    """Phase 13: (b) the entry point with ``--data_parallel``, then in a
    world-size-1 NCCL group (a) the data-parallel step and scanned epoch
    and (d) the vertex-sharded model, then (c) the data-parallel service.
    The records of (a) and (b) are the training and train-entry paths'
    own (the same shapes: the training phase's model and grid, phase 7's
    workspace) with this phase's launches; (c) and (d) hold their kernels
    at their own shapes."""
    import torch.distributed as dist

    entry = parallel_entry(torch, root, cfg_path, smi)
    torch.cuda.empty_cache()
    parallel_group(root)
    try:
        steps = parallel_steps(torch, bundle, config, smi)
        torch.cuda.empty_cache()
        vertex = parallel_vertex(torch, mods, bundle, config, ptxas, smi)
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    serving = parallel_serving(torch, mods, run_dir, smi)
    records = vertex["records"] + serving["records"]
    for path, part, source in (("parallel_training", steps, "training"),
                               ("parallel_entry", entry, "train_entry")):
        counts = part["counts"]
        have = {r["name"]: r for r in by_path[source]}
        for name, n in counts.items():
            if not n:
                continue
            check(name in have, f"{name} ran on {path}; {source} has no "
                  "record of it")
            rec = dict(have[name], path=path, launches=n,
                       shapes_of=source)
            records.append(rec)
    return {"line": {"phase": "parallel", "nvidia_smi": smi,
                     "training": steps["line"], "entry": entry["line"],
                     "serving": serving["line"], "vertex": vertex["line"]},
            "records": records}


# ----------------------------------------------------------------------
# phase 14: deep ensembles, sweeps and ensemble serving
ENS_MEMBERS = 2
ENS_EPOCHS = 2
# two variants: variant 0 with a weight decay > 0, variant 1 with a 0.0
# Laplacian weight (on top of it)
SWEEP_VARY = ("weight_decay=1e-3", "laplacian_weight=0.1,0")
ENS_SIZES = (1, 16)             # the consensus requests' batches (phase 9's
#                                 scans)
ENS_REPS = 7                    # timed consensus requests at B = 16
ENS_PHASE_S = 60.0              # the phase's budget


class MemberMarks:
    """While active, the counters (``kernels.launches``,
    ``graphs.replayed``), the card's peak allocation and the host clock
    at each ``ModelManager.use_member`` call: an entry point's training
    ends at the first, and each member's tail (its checkpoint, zoo fit
    and statistics) runs from one to the next."""

    def __init__(self, torch):
        self.torch = torch
        self.marks: list = []

    def snap(self) -> dict:
        from craniofacialsd_vae_tpu_torch import graphs, kernels

        if DEVICE == "cuda":
            self.torch.cuda.synchronize()
        return {"launches": kernels.launches.snapshot(),
                "replayed": graphs.replayed.snapshot(),
                "peak": peak_mib(self.torch), "t": time.perf_counter()}

    def __enter__(self):
        from craniofacialsd_vae_tpu_torch.manager import ModelManager

        self.saved = ModelManager.use_member
        saved, marks = self.saved, self.marks

        def use_member(mgr, member):
            marks.append(self.snap())
            return saved(mgr, member)

        ModelManager.use_member = use_member
        return self

    def __exit__(self, *exc):
        from craniofacialsd_vae_tpu_torch.manager import ModelManager

        ModelManager.use_member = self.saved
        self.marks.append(self.snap())


def reset_peak(torch) -> None:
    """The card's peak allocation from here on, above what is allocated
    now (``peak_mib``)."""
    global PEAK_BASE
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
        PEAK_BASE = torch.cuda.memory_allocated()


PEAK_BASE = 0


def peak_mib(torch) -> float:
    """MiB allocated at the peak since ``reset_peak``, above what was
    allocated then (0 on the host)."""
    if DEVICE != "cuda":
        return 0.0
    return (torch.cuda.max_memory_allocated() - PEAK_BASE) / 2 ** 20


def diff(after: dict, before: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after}


def scaled(counts: dict, k: int) -> dict:
    return {name: k * n for name, n in counts.items()}


def solo_run(torch, config: dict, seed: int, epochs: int) -> dict:
    """``ModelManager(config, seed=seed)`` on the card: its scanned run of
    ``epochs`` epochs in one call over fresh iterators (the entry points'
    plans), counted from 0 (launches and replays); the peak allocation
    from before the manager is built."""
    from craniofacialsd_vae_tpu_torch.data.dataset import (
        DeviceBatchIterator, build_datasets)
    from craniofacialsd_vae_tpu_torch.manager import ModelManager

    reset_peak(torch)
    mgr = ModelManager(config, config["data"]["precomputed_path"],
                       seed=seed, device=DEVICE)
    train_set, val_set, _, _, weights = build_datasets(config, mgr.template,
                                                       device=DEVICE)
    mgr.set_class_conversions_and_weights(weights)
    its = [DeviceBatchIterator(s, mgr.batch_size, shuffle=True,
                               class2idx=mgr._class2idx_dict, device=DEVICE)
           for s in (train_set, val_set)]
    reset_counts()
    t0 = time.perf_counter()
    tr, va = mgr.run_epochs_scanned(*its, epochs)
    counts = read_counts(torch, "solo")
    return {"manager": mgr, "train": tr, "validation": va,
            "train_s": time.perf_counter() - t0, "launches": counts,
            "replayed": PATH_REPLAYS.pop("solo"), "peak_mib": peak_mib(torch)}


def same_member(member, solo, what: str) -> None:
    """A member's (or a variant's) parameters and Adam states equal a solo
    manager's bit for bit."""
    got = state_tensors(member.model, member.optimizer)
    want = state_tensors(solo.model, solo.optimizer)
    check(len(got) == len(want), f"{what}: {len(got)} state tensors vs "
          f"{len(want)}")
    for i, (a, b) in enumerate(zip(got, want)):
        check(a.shape == b.shape and bool((a == b).all()),
              f"{what}: state tensor {i} differs from the solo run's")


def ensemble_entry(torch, root: str, cfg_path: str, config: dict,
                   entry_grid: int, smi: str) -> dict:
    """(a) ``train_ensemble.main`` in process, ENS_MEMBERS members ×
    ENS_EPOCHS epochs in one chunk, counted (path ``ensembles``); then
    each member's solo ``ModelManager(seed=i)`` run: bit-equal members,
    and the training's launches and replays K times a solo run's, the
    graphs' captures K times a solo graph's kernel for kernel, the solo
    train graph one step at the train entry path's grid. Returns
    the K = 2 graphs, whose replays ``check_replays`` profiles once the
    phase is done with the members."""
    from craniofacialsd_vae_tpu_torch import train_ensemble

    k = ENS_MEMBERS
    reset_counts()
    reset_peak(torch)
    t0 = time.perf_counter()
    with MemberMarks(torch) as marks:
        res = train_ensemble.main([
            "--config", cfg_path, "--id", "ensemble", "--output_path", root,
            "--members", str(k), "--epochs", str(ENS_EPOCHS),
            "--chunk_epochs", str(ENS_EPOCHS), "--device", DEVICE])
    run_s = time.perf_counter() - t0
    counts = read_counts(torch, "ensembles")
    m = marks.marks
    check(len(m) == k + 1, f"{len(m) - 1} use_member calls for {k} members")
    train_counts = diff(m[0]["launches"], {})
    train_replayed = diff(m[0]["replayed"], {})
    tails = [diff(m[i + 1]["launches"], m[i]["launches"]) for i in range(k)]
    check(all(t == tails[0] for t in tails), f"the members' tails launched "
          f"{tails}")
    steps = res["epochs_fn"].steps
    check(len(steps) == 1, f"{len(steps)} blocks for an unsharded state")
    runners = steps[0].runners
    state = res["state"]
    solos = [solo_run(torch, config, i, ENS_EPOCHS) for i in range(k)]
    chunk = res["chunks"][0]
    for i, solo in enumerate(solos):
        same_member(state.members[i], solo["manager"], f"member {i}")
        check(chunk["train"][i] == solo["train"]
              and chunk["validation"][i] == solo["validation"],
              f"member {i} metrics {chunk['validation'][i]} vs the solo "
              f"run's {solo['validation']}")
        check(res["manifest"]["members"][i]["val_tot"]
              == solo["validation"][-1]["tot"], f"member {i} val_tot")
        check(solo["launches"] == solos[0]["launches"]
              and solo["replayed"] == solos[0]["replayed"],
              f"solo runs launched {solo['launches']} vs "
              f"{solos[0]['launches']}")
    check(train_counts == scaled(solos[0]["launches"], k),
          f"the ensemble's training launched {train_counts}, {k} x the solo "
          f"run's {solos[0]['launches']} expected")
    check(train_replayed == scaled(solos[0]["replayed"], k),
          f"the ensemble's replays {train_replayed}, {k} x the solo run's "
          f"{solos[0]['replayed']} expected")
    solo_runners = solos[0]["manager"]._scanned_epochs.steps.runners
    check(set(runners) == set(solo_runners), f"graphs {sorted(runners)} vs "
          f"the solo run's {sorted(solo_runners)}")
    for key, r in runners.items():
        if r.graph is None:             # the host runs the steps eagerly
            continue
        want = scaled(solo_runners[key].graph.launches, k)
        check(r.graph.launches == want, f"the {key} graph captured "
              f"{r.graph.launches}; {k} x the solo graph's {want} expected")
    # the K = 2 graphs repeat a step at the train entry path's shapes
    # (whose records this path takes): the solo train graph captures one
    # step of phase 7's model at its grid
    mgr0 = solos[0]["manager"]
    step = {name: n for name, n in expected_step_launches(
        mgr0.model, mgr0.geometry, entry_grid).items() if n}
    trains = [r for key, r in solo_runners.items()
              if key[0] == "train" and r.graph is not None]
    check(DEVICE != "cuda" or trains, "the solo run captured no train graph")
    for r in trains:
        check(r.graph.launches == step, f"the solo train graph captured "
              f"{r.graph.launches}; one step at the train entry path's grid "
              f"of {entry_grid} launches {step}")
    for kernel in ("spiral_conv_tc", "spiral_conv_narrow", "ell_matmul_fwd",
                   "ell_matmul_capped", "spiral_conv_dw"):
        check(train_counts[kernel] > 0,
              f"{kernel} was not launched by the ensemble's training")
    train_s = res["train_s"]
    solo_epoch = [s["train_s"] / ENS_EPOCHS for s in solos]
    line = {"members": k, "epochs": ENS_EPOCHS, "run_s": run_s,
            "train_s": train_s,
            "member_epoch_s": train_s / (k * ENS_EPOCHS),
            "solo_epoch_s": solo_epoch,
            "peak_mib": m[0]["peak"],
            "solo_peak_mib": [s["peak_mib"] for s in solos],
            "tail_s": [m[i + 1]["t"] - m[i]["t"] for i in range(k)],
            "launches": counts, "training_launches": train_counts,
            "solo_launches": solos[0]["launches"],
            "replayed": PATH_REPLAYS["ensembles"],
            "validation_tot": [c[-1]["tot"] for c in chunk["validation"]]}
    log(f"[14a ensembles] train_ensemble.main, {k} members x {ENS_EPOCHS} "
        f"epochs in one chunk: every member bit-equal to its solo "
        f"ModelManager run, the training's launches and replays {k} x a "
        f"solo run's; {line['member_epoch_s']:.3f} s a member-epoch (solo "
        f"epoch {solo_epoch} s, both with the graphs' capture), peak "
        f"{line['peak_mib']:.0f} MiB (solo {line['solo_peak_mib']}); "
        f"{smi}")
    for s in solos:
        del s["manager"]
    res.pop("manager")
    return dict(line=line, counts=counts, run=res,
                graphs=[r.graph for r in runners.values()])


def sweep_entry(torch, root: str, cfg_path: str, smi: str) -> dict:
    """(b) ``sweep.main`` in process over SWEEP_VARY (variant 0 with a
    weight decay, variant 1 with a 0.0 Laplacian weight), counted (path
    ``sweep``); each variant bit-equal to a solo ``ModelManager`` run of
    its config (the 0-weighted term's metric its unweighted value where
    the solo run reads 0.0), sweep.json ranked, and the training's
    launches and replays the two solo runs' plus the Laplacian's that
    variant 1's body computes and its solo run skips (K4's alone); the
    variants' tails alike."""
    from craniofacialsd_vae_tpu_torch import sweep

    reset_counts()
    t0 = time.perf_counter()
    vary = [a for v in SWEEP_VARY for a in ("--vary", v)]
    with MemberMarks(torch) as marks:
        res = sweep.main(["--config", cfg_path, "--id", "sweep",
                          "--output_path", root, *vary, "--epochs",
                          str(ENS_EPOCHS), "--chunk_epochs",
                          str(ENS_EPOCHS), "--device", DEVICE])
    run_s = time.perf_counter() - t0
    counts = read_counts(torch, "sweep")
    res.pop("manager")
    variants, chunk = res["variants"], res["chunks"][0]
    check(len(variants) == 2
          and variants[0]["optimization"]["weight_decay"] > 0
          and variants[1]["optimization"]["laplacian_weight"] == 0.0,
          f"the sweep's variants {[v['optimization'] for v in variants]}")
    m = marks.marks
    check(len(m) == 3, f"{len(m) - 1} use_member calls for 2 variants")
    train_counts = diff(m[0]["launches"], {})
    train_replayed = diff(m[0]["replayed"], {})
    tails = [diff(m[i + 1]["launches"], m[i]["launches"]) for i in range(2)]
    check(tails[0] == tails[1], f"the variants' tails launched {tails}")
    solos = [solo_run(torch, vcfg, 0, ENS_EPOCHS) for vcfg in variants]
    for i, solo in enumerate(solos):
        same_member(res["state"].members[i], solo["manager"], f"variant {i}")
        zero = {"laplacian"} if i == 1 else set()
        for got, want in ((chunk["train"][i], solo["train"]),
                          (chunk["validation"][i], solo["validation"])):
            for g, w in zip(got, want):
                for key in g:
                    if key in zero:
                        check(w[key] == 0.0 and g[key] > 0.0,
                              f"variant {i} {key}: {g[key]} (solo {w[key]})")
                    else:
                        check(g[key] == w[key], f"variant {i} {key}: "
                              f"{g[key]} vs the solo run's {w[key]}")
        del solo["manager"]
    for what, got, key in (("launches", train_counts, "launches"),
                           ("replays", train_replayed, "replayed")):
        a, b = solos[0][key], solos[1][key]
        lap = diff(a, b)            # variant 1's Laplacian, in its body
        check(any(lap.values()) and all(
            n >= 0 and (not n or name.startswith("ell_matmul"))
            for name, n in lap.items()), f"the Laplacian's {what} {lap}: "
            "K4's alone expected")
        want = {name: a[name] + b[name] + lap[name] for name in a}
        check(got == want, f"the sweep's training {what} {got}; the solo "
              f"runs' {a} + {b} + variant 1's Laplacian {lap} expected")
    with open(os.path.join(res["output_dir"], "sweep.json")) as f:
        manifest = json.load(f)
    vals = [v["val"]["reconstruction"] for v in manifest["variants"]]
    check(vals == sorted(vals) and manifest["best"] == manifest["variants"][0]
          and len(vals) == 2, f"sweep.json ranking {vals}")
    line = {"variants": [v["overrides"] for v in manifest["variants"]],
            "validation_reconstruction": vals, "run_s": run_s,
            "train_s": res["train_s"], "launches": counts,
            "training_launches": train_counts,
            "solo_launches": [s["launches"] for s in solos],
            "replayed": PATH_REPLAYS["sweep"]}
    log(f"[14b sweep] sweep.main over {list(SWEEP_VARY)}: each variant "
        f"bit-equal to its solo run (the 0-weighted Laplacian read "
        f"unweighted), the training's launches and replays the solo runs' "
        f"and the Laplacian's, sweep.json ranked {vals}; {run_s:.1f} s; "
        f"{smi}")
    return dict(line=line, counts=counts)


def http_ensemble(svc, scan) -> dict:
    """``serve.py``'s server over an ``EnsembleService``: one ``POST
    /diagnose`` (the consensus) and one refused single-model request."""
    import threading
    import urllib.error
    import urllib.request

    from craniofacialsd_vae_tpu_torch.serve import make_server

    server = make_server(svc, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_port}"
    body = json.dumps({"vertices": scan.tolist()}).encode()
    try:
        req = urllib.request.Request(url + "/diagnose", data=body, headers={
            "Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as resp:
            report = json.loads(resp.read())["reports"]
        req = urllib.request.Request(url + "/reconstruct", data=body,
                                     headers={"Content-Type":
                                              "application/json"})
        try:
            urllib.request.urlopen(req, timeout=60)
            refused = None
        except urllib.error.HTTPError as e:
            refused = (e.code, e.read().decode())
        with urllib.request.urlopen(url + "/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    check(not thread.is_alive(), "the HTTP server did not stop")
    check(report["label"] == svc.diagnose(scan)["label"]
          and report["n_members"] == svc.n_members,
          f"HTTP /diagnose {report['label']} vs the service's")
    check(refused is not None and refused[0] == 400
          and "single-model" in refused[1],
          f"a single-model request to the ensemble answered {refused}")
    check(health["ok"] and health["n_members"] == svc.n_members,
          f"/healthz {health}")
    return {"diagnose_label": report["label"], "refused": refused[0]}


def ensemble_serving(torch, mods, run_dir: str, config: dict,
                     smi: str) -> dict:
    """(c) ``EnsembleService.from_ensemble_dir`` on (a)'s run dir on the
    card, ``diagnose`` at B = 1 and 16 of phase 9's scans, counted (path
    ``ensemble_serving``): its model passes K times one member service's
    on the same requests (``PassShapes``), its launches exactly those of
    the passes, every kernel held at their shapes (the path's own
    records); the consensus equals ``summarize_ensemble`` over the member
    services' own reports, and the same service on the host agrees
    (labels and votes equal, posteriors and distances within
    SERVE_RTOL); then ``serve.py``'s server over it and the consensus
    p50 at B = 16 beside a single member service's."""
    from craniofacialsd_vae_tpu_torch.analysis.uncertainty import \
        summarize_ensemble
    from collections import Counter

    from craniofacialsd_vae_tpu_torch.data.dataset import build_datasets
    from craniofacialsd_vae_tpu_torch.serving import (WARMUP_PASSES,
                                                      EnsembleService)

    train_set, _, _, norm, _ = build_datasets(config)
    raw = (np.asarray(train_set.x[:max(ENS_SIZES)]) * norm["std"]
           + norm["mean"]).astype(np.float32)
    scans = {b: raw[:b] for b in ENS_SIZES}
    reset_counts()
    with PassShapes() as rec:
        card = EnsembleService.from_ensemble_dir(run_dir, max_batch=BATCH,
                                                 device=DEVICE)
        got = {b: card.diagnose(x) for b, x in scans.items()}
    counts = read_counts(torch, "ensemble_serving")
    # a member service encodes each bucket of the requests in its graph:
    # the warm-up passes and the capture at the bucket's first request
    one = Counter()
    for size in {b for n in ENS_SIZES
                 for b in request_buckets(card.services[0], n)}:
        one[size] += 1 + WARMUP_PASSES
    passes = {p: dict(c) for p, c in rec.passes.items() if c}
    check(passes == {"enc": {b: card.n_members * n
                             for b, n in one.items()}},
          f"the ensemble service's passes {passes}; {card.n_members} x one "
          f"member's {dict(one)} expected")
    records, _ = pass_records(torch, mods, card.services[0].manager, rec,
                              "ensemble_serving", counts)
    check(card.n_members == ENS_MEMBERS and all(
        len(r["members"]) == ENS_MEMBERS for g in got.values() for r in g),
        "the consensus reports lack their member blocks")
    for b, x in scans.items():
        want = summarize_ensemble([s.diagnose(x) for s in card.services])
        for row, w in zip(got[b], want):
            check({k: row[k] for k in w} == w, f"B={b}: the consensus is "
                  "not summarize_ensemble of the members' reports")
    host = EnsembleService.from_ensemble_dir(run_dir, max_batch=BATCH,
                                             device="cpu")
    worst = 0.0
    for b, x in scans.items():
        for g, h in zip(got[b], host.diagnose(x)):
            check(g["label"] == h["label"]
                  and g["member_votes"] == h["member_votes"]
                  and [m["label"] for m in g["members"]]
                  == [m["label"] for m in h["members"]],
                  f"B={b}: card labels differ from the host's")
            pairs = [(g[k][c], h[k][c]) for k in ("posterior_mean",
                                                  "posterior_std")
                     for c in h[k]]
            pairs += [(gm["mahalanobis_to_healthy"],
                       hm["mahalanobis_to_healthy"])
                      for gm, hm in zip(g["members"], h["members"])]
            pairs += [(g["predictive_entropy_nats"],
                       h["predictive_entropy_nats"])]
            for a, w in pairs:
                e = abs(a - w) / max(abs(w), 1.0)
                worst = max(worst, e)
                check(e <= SERVE_RTOL, f"B={b}: card {a} vs host {w}")
    del host
    http = http_ensemble(card, scans[1][0])
    x16 = scans[max(ENS_SIZES)]
    lat = {"consensus": p50(timed(torch, lambda: card.diagnose(x16),
                                  ENS_REPS)),
           "single": p50(timed(torch, lambda: card.services[0].diagnose(
               x16), ENS_REPS))}
    line = {"sizes": list(ENS_SIZES), "card_vs_host_worst": worst,
            "http": http, "diagnose_p50_ms_b16": lat,
            "launches": counts, "replayed": PATH_REPLAYS["ensemble_serving"]}
    log(f"[14c ensemble serving] EnsembleService on the card: the consensus "
        f"is summarize_ensemble of its members' reports, card vs host within "
        f"{worst:.2e} (labels equal), /diagnose answered and a single-model "
        f"request refused over HTTP; consensus p50 at B = 16 "
        f"{lat['consensus']:.2f} ms (one member's {lat['single']:.2f} ms); "
        f"{smi}")
    del card
    return dict(line=line, counts=counts, records=records)


def sharded_entry(torch, root: str, cfg_path: str, ensemble: dict,
                  smi: str) -> dict:
    """(d) ``train_ensemble.main --shard_members`` over the card named
    twice (a block of one member each, in its own graph), counted (path
    ``ensembles_sharded``): the members, their checkpoints and metrics
    bit-equal to (a)'s, and its launches and replays (a)'s."""
    from craniofacialsd_vae_tpu_torch import train_ensemble
    from craniofacialsd_vae_tpu_torch.training.checkpoint import \
        read_checkpoint

    reset_counts()
    t0 = time.perf_counter()
    res = train_ensemble.main([
        "--config", cfg_path, "--id", "ensemble_sharded", "--output_path",
        root, "--members", str(ENS_MEMBERS), "--epochs", str(ENS_EPOCHS),
        "--chunk_epochs", str(ENS_EPOCHS), "--device", DEVICE,
        "--shard_members", "--shard_devices", ",".join([DEVICE] * 2)])
    run_s = time.perf_counter() - t0
    counts = read_counts(torch, "ensembles_sharded")
    res.pop("manager")
    base = ensemble["run"]
    check(res["mesh"] is not None and len(res["epochs_fn"].steps) == 2,
          "--shard_members did not run two blocks")
    check(res["chunks"][0]["train"] == base["chunks"][0]["train"]
          and res["chunks"][0]["validation"]
          == base["chunks"][0]["validation"],
          "sharded metrics differ from the unsharded run's")
    for i in range(ENS_MEMBERS):
        same_member(res["state"].members[i], base["state"].members[i],
                    f"sharded member {i}")
        for name in ("optimizer.ckpt", f"model_{ENS_EPOCHS:08d}.ckpt"):
            same_tree(*[read_checkpoint(os.path.join(
                r["output_dir"], f"member_{i:02d}", "checkpoints", name))
                for r in (res, base)], f"sharded member {i} {name}")
    check(counts == ensemble["counts"]
          and PATH_REPLAYS["ensembles_sharded"] == PATH_REPLAYS["ensembles"],
          f"sharded launches {counts} (replays "
          f"{PATH_REPLAYS['ensembles_sharded']}) vs (a)'s "
          f"{ensemble['counts']}")
    line = {"blocks": len(res["epochs_fn"].steps), "run_s": run_s,
            "train_s": res["train_s"], "launches": counts,
            "replayed": PATH_REPLAYS["ensembles_sharded"]}
    log(f"[14d member sharding] --shard_members over the card named twice: "
        f"members, checkpoints, metrics, launches and replays equal to the "
        f"unsharded run's; {run_s:.1f} s; {smi}")
    return dict(line=line, counts=counts)


def phase_ensembles(torch, mods, root: str, cfg_path: str, by_path: dict,
                    t_start: float, smi: str) -> dict:
    """Phase 14: (a) the ensemble entry point, (b) the sweep, (c) the
    ensemble service on (a)'s run dir, (d) member sharding, on phase 7's
    workspace and config (fp32), in ENS_PHASE_S. The records of (a), (b)
    and (d) are the train-entry path's (the same model, grid and
    workspace; (a) holds its solo step at that grid) with this phase's
    launches; (c) holds its own at its passes' shapes."""
    from craniofacialsd_vae_tpu_torch.utils import get_config

    t0 = time.perf_counter()
    config = get_config(cfg_path)
    ens = ensemble_entry(torch, root, cfg_path, config,
                         config["optimization"]["batch_size"] ** 2, smi)
    torch.cuda.empty_cache()
    swp = sweep_entry(torch, root, cfg_path, smi)
    torch.cuda.empty_cache()
    serving = ensemble_serving(torch, mods, ens["run"]["output_dir"], config,
                               smi)
    torch.cuda.empty_cache()
    sharded = sharded_entry(torch, root, cfg_path, ens, smi)
    torch.cuda.empty_cache()
    # (a)'s K = 2 graphs, one replay of each profiled against its capture
    # (a replay of the train graph updates the members: last)
    ens["line"]["replays_checked"] = check_replays(torch, ens.pop("graphs"),
                                                   "ensembles")
    records = list(serving["records"])
    for path, part in (("ensembles", ens), ("sweep", swp),
                       ("ensembles_sharded", sharded)):
        have = {r["name"]: r for r in by_path["train_entry"]}
        for name, n in part["counts"].items():
            if not n:
                continue
            check(name in have, f"{name} ran on {path}; train_entry has no "
                  "record of it")
            records.append(dict(have[name], path=path, launches=n,
                                shapes_of="train_entry"))
    phase_s = time.perf_counter() - t0
    a, c = ens["line"], serving["line"]
    line = {"phase": "ensembles", "nvidia_smi": smi,
            "member_epoch_s": a["member_epoch_s"],
            "solo_epoch_s": a["solo_epoch_s"],
            "k2_graph_peak_mib": a["peak_mib"],
            "solo_peak_mib": a["solo_peak_mib"],
            "consensus_p50_ms_b16": c["diagnose_p50_ms_b16"]["consensus"],
            "single_p50_ms_b16": c["diagnose_p50_ms_b16"]["single"],
            "card_vs_host_worst": c["card_vs_host_worst"],
            "seconds": {"ensemble": a["run_s"],
                        "sweep": swp["line"]["run_s"],
                        "sharded": sharded["line"]["run_s"]},
            "phase_s": phase_s, "budget_s": ENS_PHASE_S,
            "script_s": time.perf_counter() - t_start}
    log(json.dumps(line, default=float))
    line.update(ensemble=a, sweep=swp["line"], serving=c,
                sharded=sharded["line"])
    check(phase_s <= ENS_PHASE_S, f"phase 14 took {phase_s:.1f} s, over "
          f"its {ENS_PHASE_S:.0f} s budget")
    return {"line": line, "records": records}


# both at 1 and 16: the live service answers B = 1 at bucket 1, and a bf16
# program's sums depend on its batch's plan
EXPORT_BUCKETS = {"fp32": (1, BATCH), "mixed": (1, BATCH)}
EXPORT_SIZES = (1, BATCH, BATCH + 1)   # (b)'s requests: 17 runs as 16 + 1
EXPORT_RTOL = 1e-5              # exported vs live service (JAX's limits,
EXPORT_ATOL = 1e-6              # tests/test_serving.py:1016-1033), and
EXPORT_ERR_ATOL_MM = 1e-5       # error_mm's
EXPORT_PROGRAM_KERNELS = {      # (d): kernels the program must launch
    "fp32": ("spiral_conv_tc", "spiral_conv_narrow", "ell_matmul_fwd"),
    "mixed": ("spiral_conv_bf16", "ell_matmul_bf16")}
SYNTH_MESHES = 10               # (e): make_synthetic_dataset --n
SYNTH_VERTICES = 1026           # its default template: octasphere sub. 4
EXPORT_PHASE_S = 90.0           # the phase's budget


def export_answers(model, x: np.ndarray, z: np.ndarray) -> dict:
    """An exported model's (or the live service's) encode, decode and
    reconstruct of the same rows."""
    rec = model.reconstruct(x)
    if "vertices" in rec:                   # the live service's keys
        rec = {"recon": rec["vertices"], "error_mm":
               rec["vertex_errors_mm"], "mu": rec["latent"]}
    return {"mu": model.encode(x), "decoded": model.decode(z), **rec}


def export_run(torch, mods, root: str, run_dir: str, policy: str,
               smi: str) -> dict:
    """(a)–(d) of phase 15 on one run dir: its export, the artifact loaded
    from a copy with the run dir renamed aside, its answers against the
    live service, its launches at bucket 16 against the live eager
    program's, and the path's records."""
    from collections import Counter

    from craniofacialsd_vae_tpu_torch.export import (OPS_MODULE,
                                                     export_run_dir,
                                                     load_exported)
    from craniofacialsd_vae_tpu_torch.serving import DiagnosisService

    kernels = mods["kernels"]
    buckets = EXPORT_BUCKETS[policy]
    out = os.path.join(root, f"export_{policy}")
    t0 = time.perf_counter()
    manifest = export_run_dir(run_dir, out, buckets=buckets, device=None)
    export_s = time.perf_counter() - t0
    sizes = {k: os.path.getsize(os.path.join(out, e["file"])) / 1e6
             for k, e in manifest["programs"].items()}
    check(manifest["buckets"] == list(buckets)
          and set(manifest["programs"]) == {
              f"{p}_b{b}" for p in ("encode", "decode", "reconstruct")
              for b in buckets}
          and manifest["policy"] == ("float32" if policy == "fp32"
                                     else "mixed")
          and manifest["ops_module"] == OPS_MODULE,
          f"{policy}: export manifest {manifest}")
    program_s = {k: round(e["export_s"], 2)
                 for k, e in manifest["programs"].items()}
    log(f"[15 export {policy}] {len(sizes)} programs in {export_s:.1f} s "
        f"({program_s} s), {sum(sizes.values()):.1f} MB "
        f"({ {k: round(v, 2) for k, v in sizes.items()} }); {smi}")

    # (b) the artifact copied away and loaded with the run dir renamed
    # aside; every program answered at B = 1, 16 and 17
    deployed = os.path.join(root, f"deployed_{policy}")
    shutil.copytree(out, deployed)
    aside = run_dir + ".aside"
    os.rename(run_dir, aside)
    try:
        t0 = time.perf_counter()
        exported = load_exported(deployed)
        load_s = time.perf_counter() - t0
        n, nz = exported.n_vertices, exported.latent_size
        rng = np.random.default_rng(SEED + 150)
        base = rng.normal(scale=0.5, size=(n, 3)).astype(np.float32)
        x_all = base + rng.normal(scale=0.03, size=(
            max(EXPORT_SIZES), n, 3)).astype(np.float32)
        z_all = rng.normal(size=(max(EXPORT_SIZES), nz)).astype(np.float32)
        answers = {b: export_answers(exported, x_all[:b], z_all[:b])
                   for b in EXPORT_SIZES}
    finally:
        os.rename(aside, run_dir)

    # (c) against the live service of the same run dir
    svc = DiagnosisService.from_run_dir(run_dir, max_batch=BATCH,
                                        device=DEVICE)
    worst, bit_equal = {}, True
    for b in EXPORT_SIZES:
        live = export_answers(svc, x_all[:b], z_all[:b])
        for key, want in live.items():
            got = answers[b][key]
            check(got.shape == want.shape and np.isfinite(got).all(),
                  f"{policy} B={b} {key}: {got.shape} vs {want.shape}")
            atol = EXPORT_ERR_ATOL_MM if key == "error_mm" else EXPORT_ATOL
            np.testing.assert_allclose(got, want, rtol=EXPORT_RTOL,
                                       atol=atol, err_msg=f"{policy} B={b} "
                                       f"{key}: exported vs live")
            worst[key] = max(worst.get(key, 0.0),
                             float(np.abs(got - want).max()))
            bit_equal &= bool(np.array_equal(got, want))

    # (d) launches of one exported reconstruct at bucket 16 against one
    # eager call of the live program at the same bucket
    path = "export" if policy == "fp32" else "mixed_export"
    x16 = x_all[:BATCH]
    reset_counts()
    exported.reconstruct(x16)
    counts = read_counts(torch, path)
    eager_programs(svc)
    before = kernels.launches.snapshot()
    svc.reconstruct(x16)
    torch.cuda.synchronize()
    live = {k: v - before[k] for k, v in kernels.launches.snapshot().items()}
    check(counts == live, f"{policy}: the exported reconstruct launched "
          f"{counts}, the live eager program {live}")
    cfg = svc.manager.net_config
    final = ("out_gather_sum" if cfg.final_out_gather
             else "spiral_conv_f32out") if policy == "mixed" else None
    need = EXPORT_PROGRAM_KERNELS[policy] + ((final,) if final else ())
    check(all(counts[k] > 0 for k in need), f"{policy}: the exported "
          f"reconstruct launched {counts}; it must launch each of {need}")

    # request p50 at B = 16: exported, the live graph replay, live eager
    def p50(fn, reps=7):
        fn()
        ts = []
        for _ in range(reps):
            t1 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t1) * 1e3)
        return sorted(ts)[reps // 2]

    ms = {"eager": p50(lambda: svc.reconstruct(x16))}
    graphed_programs(svc)
    ms["graph"] = p50(lambda: svc.reconstruct(x16))
    ms["exported"] = p50(lambda: exported.reconstruct(x16))

    # the path's records: each kernel at the shapes of one encode and one
    # decode at bucket 16, its launches those the shapes account for
    passes = {"enc": Counter({BATCH: 1}), "dec": Counter({BATCH: 1}),
              "enc_bwd": Counter(), "dec_bwd": Counter()}
    shapes = diagnosis_shapes(torch, mods, svc.manager, passes)
    want = dict.fromkeys(kernels.KERNEL_NAMES, 0)
    for kernel, entries in shapes.items():
        want[kernel] += sum(e["launches"] for e in entries)
    check(counts == want, f"{policy}: exported launches {counts}, "
          f"expected {want} from one encode and one decode at {BATCH}")
    records = []
    for kernel, entries in shapes.items():
        r = summarize(kernel, *KERNEL_SOURCES[kernel], entries)
        r.update(path=path, launches=counts[kernel])
        records.append(r)
    line = {"policy": policy, "buckets": list(buckets),
            "export_s": export_s,
            "program_export_s": {k: e["export_s"] for k, e in
                                 manifest["programs"].items()},
            "artifact_mb": sum(sizes.values()), "program_mb": sizes,
            "load_s": load_s, "worst_abs_diff": worst,
            "bit_equal": bit_equal,
            "launches": {k: v for k, v in counts.items() if v},
            "reconstruct_p50_ms_b16": ms}
    log(f"[15 export {policy}] loaded from a copy in {load_s:.2f} s with "
        f"the run dir aside; against the live service at B = "
        f"{list(EXPORT_SIZES)}: largest differences {worst}, bit-equal "
        f"{bit_equal}; launches at bucket {BATCH} equal to the live eager "
        f"program's {line['launches']}; reconstruct p50 at B = {BATCH}: "
        f"exported {ms['exported']:.3f} ms, live graph {ms['graph']:.3f}, "
        f"live eager {ms['eager']:.3f}; {smi}")
    del svc, exported
    torch.cuda.empty_cache()
    return {"line": line, "records": records}


def tool_twins(root: str, run_dir: str) -> dict:
    """(e) on the host: ``convert_torch_checkpoint --reverse`` of the fp32
    run's checkpoint and forward again (parameters and Adam moments come
    back equal), and ``make_synthetic_dataset --n 10`` (its OBJs parse)."""
    from craniofacialsd_vae_tpu_torch import (convert_torch_checkpoint,
                                              make_synthetic_dataset)
    from craniofacialsd_vae_tpu_torch.geometry import read_obj
    from craniofacialsd_vae_tpu_torch.training.checkpoint import (
        latest_checkpoint, named_from_tree, read_checkpoint)

    t0 = time.perf_counter()
    ckpt = os.path.join(run_dir, "checkpoints")
    cfg = os.path.join(run_dir, "config.yaml")
    orig = read_checkpoint(latest_checkpoint(ckpt))
    ref = os.path.join(root, "reference", "model_00000006.pt")
    os.makedirs(os.path.dirname(ref))
    convert_torch_checkpoint.main(["--torch_model", ref, "--config", cfg,
                                   "--out", ckpt, "--reverse"])
    back_dir = os.path.join(root, "converted")
    convert_torch_checkpoint.main([
        "--torch_model", ref, "--config", cfg, "--out", back_dir,
        "--torch_opt", ref[:-3] + "_optimizer.pt"])
    back = read_checkpoint(os.path.join(back_dir, "model_00000006.ckpt"))
    want, got = (named_from_tree(t["params"]) for t in (orig, back))
    check(set(got) == set(want) and all(
        np.array_equal(got[k], want[k]) for k in want),
        "convert_torch_checkpoint: the parameters did not come back equal")
    opt = [named_from_tree(read_checkpoint(os.path.join(d, "optimizer.ckpt"))
                           ["opt_state"]) for d in (ckpt, back_dir)]
    check(set(opt[0]) == set(opt[1]) and all(
        np.array_equal(opt[1][k], opt[0][k]) for k in opt[0]),
        "convert_torch_checkpoint: the Adam state did not come back equal")
    convert_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    synth = os.path.join(root, "synth")
    n = make_synthetic_dataset.main(["--out", synth, "--n",
                                     str(SYNTH_MESHES)])
    files = sorted(os.listdir(synth))
    check(n == SYNTH_MESHES and len(files) == SYNTH_MESHES,
          f"make_synthetic_dataset wrote {files}")
    for name in files:
        mesh = read_obj(os.path.join(synth, name))
        check(mesh.vertices.shape == (SYNTH_VERTICES, 3)
              and np.isfinite(mesh.vertices).all()
              and mesh.faces.shape == (2 * SYNTH_VERTICES - 4, 3),
              f"{name}: {mesh.vertices.shape} vertices, "
              f"{None if mesh.faces is None else mesh.faces.shape} faces")
    synth_s = time.perf_counter() - t0
    log(f"[15 tools] convert_torch_checkpoint --reverse and back: "
        f"{len(want)} parameters and {len(opt[0])} Adam leaves equal in "
        f"{convert_s:.2f} s; make_synthetic_dataset --n {SYNTH_MESHES}: "
        f"{len(files)} OBJs of {SYNTH_VERTICES} vertices parsed in "
        f"{synth_s:.2f} s")
    return {"convert_s": convert_s, "synth_s": synth_s,
            "parameters": len(want), "adam_leaves": len(opt[0])}


def phase_export(torch, mods, root: str, runs: dict, t_start: float,
                 smi: str) -> dict:
    """Phase 15: export of phase 7's (fp32) and phase 8's (mixed) run dirs,
    their artifacts against the live service and the live eager
    program's launches, and the two tool twins, in EXPORT_PHASE_S."""
    t0 = time.perf_counter()
    records, runs_out = [], {}
    for policy in ("fp32", "mixed"):
        res = export_run(torch, mods, root, runs[policy], policy, smi)
        records += res["records"]
        runs_out[policy] = res["line"]
    tools = tool_twins(root, runs["fp32"])
    phase_s = time.perf_counter() - t0
    line = {"phase": "export", "nvidia_smi": smi, **runs_out,
            "tools": tools, "phase_s": phase_s, "budget_s": EXPORT_PHASE_S,
            "script_s": time.perf_counter() - t_start}
    log(json.dumps(line, default=float))
    check(phase_s <= EXPORT_PHASE_S, f"phase 15 took {phase_s:.1f} s, over "
          f"its {EXPORT_PHASE_S:.0f} s budget")
    return {"line": line, "records": records}


# ----------------------------------------------------------------------
# phase 16: sinkhorn_divergence (K8-sinkhorn)
def sinkhorn_shape(what: str, p: int, q: int, passes: int,
                   ops_per_pair: int, **fields) -> dict:
    """One K8-sinkhorn launch's record: its bound from the pairs its
    passes take (``ops_per_pair`` FP32 operations each) and the bytes of
    the clouds and the potentials, the times and errors in ``fields``."""
    flops = float(p) * q * passes * ops_per_pair
    nbytes = 4.0 * (3 * (p + q) + (SINKHORN_ITERS + 1) * (p + q))
    b_ms, b_by, _, _ = bound(nbytes, flops)
    return dict(shape=what, p=p, q=q, passes=passes, bytes=nbytes,
                flops=flops, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, **fields)


def phase_sinkhorn(torch, mods, t_start: float, smi: str) -> dict:
    """Phase 16: ``ops.sinkhorn_divergence`` on the card. Counted (path
    ``sinkhorn``): (a)'s forward and (b)'s forward and backward, one
    ``sinkhorn_fwd`` a forward and one ``sinkhorn_bwd``. (a) the forward
    at P = SINKHORN_P (the octasphere of subdivision 6) against Q =
    SINKHORN_Q (a deformed scan of it, ``fit_scan``), ε = SINKHORN_EPS,
    within SINKHORN_RTOL of the twin on the card, both timed; (b) the
    gradient at SINKHORN_GRAD against the twin's autograd within
    SINKHORN_GRAD_RTOL of each gradient's max, the backward kernel timed
    against the twin's backward (its tape kept); (c) the JAX test's cases
    (``tests/test_distances.py::TestSinkhorn``). No PyTorch call computes
    the divergence: its library time is null. Fails past
    SINKHORN_PHASE_S."""
    from craniofacialsd_vae_tpu_torch.geometry import octasphere

    kernels, dist = mods["kernels"], mods["distances"]
    t0 = time.perf_counter()
    pos = np.asarray(octasphere(6)[0], np.float32)
    check(len(pos) == SINKHORN_P, f"octasphere(6) has {len(pos)} vertices")
    scan, _ = fit_scan(pos, [0])
    x = torch.as_tensor(pos, device=DEVICE)
    y = torch.as_tensor(scan, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 16)
    xg = torch.randn((SINKHORN_GRAD[0], 3), generator=gen, device=DEVICE)
    yg = torch.randn((SINKHORN_GRAD[1], 3), generator=gen,
                     device=DEVICE) + 1.0
    eps, iters = SINKHORN_EPS, SINKHORN_ITERS

    # the path: counts from 0, the forward at (a), (b)'s forward and
    # backward, counts read
    reset_counts()
    with torch.no_grad():
        got = dist.sinkhorn_divergence(x, y, eps, iters)
    xa, ya = xg.clone().requires_grad_(), yg.clone().requires_grad_()
    dist.sinkhorn_divergence(xa, ya, eps, iters).backward()
    counts = read_counts(torch, "sinkhorn")
    want = dict.fromkeys(kernels.KERNEL_NAMES, 0)
    want.update(sinkhorn_fwd=2, sinkhorn_bwd=1)
    check(counts == want, f"sinkhorn launches {counts}, expected {want}")

    # (a) the forward against the twin
    with torch.no_grad():
        ref = dist.sinkhorn_divergence_plain(x, y, eps, iters)
        torch.cuda.synchronize()
        rel = abs(float(got) - float(ref)) / abs(float(ref))
        check(np.isfinite(float(got)) and rel <= SINKHORN_RTOL,
              f"K8-sinkhorn forward {float(got)!r} vs twin {float(ref)!r}")
        again = dist.sinkhorn_divergence(x, y, eps, iters)
        check(torch.equal(got, again), "K8-sinkhorn: two calls differ")
        fwd_ms = cuda_ms(torch, lambda: kernels.sinkhorn_fwd(x, y, eps,
                                                            iters), 3)
        fwd_plain_ms = cuda_ms(torch, lambda: dist.sinkhorn_divergence_plain(
            x, y, eps, iters), 1)
    torch.cuda.empty_cache()
    log(f"[16 sinkhorn a] P {SINKHORN_P} x Q {SINKHORN_Q}, eps {eps}, "
        f"{iters} iterations: kernel {float(got):.6f}, twin "
        f"{float(ref):.6f} (rel {rel:.2e}, rtol {SINKHORN_RTOL}); kernel "
        f"{fwd_ms:.2f} ms, twin {fwd_plain_ms:.2f} ms; {smi}")

    # (b) the gradient against the twin's autograd
    gk = (xa.grad, ya.grad)
    xt, yt = xg.clone().requires_grad_(), yg.clone().requires_grad_()
    out_t = dist.sinkhorn_divergence_plain(xt, yt, eps, iters)
    gt = torch.autograd.grad(out_t, (xt, yt), retain_graph=True)
    grad_rel, grad_abs = [], []
    for name, a, b in (("x", gk[0], gt[0]), ("y", gk[1], gt[1])):
        scale = float(b.abs().max())
        grad_abs.append(max_err(a, b))
        r = grad_abs[-1] / scale
        check(bool(torch.isfinite(a).all()) and r <= SINKHORN_GRAD_RTOL,
              f"K8-sinkhorn gradient of {name}: {r:.2e} of its max from the "
              f"twin's (rtol {SINKHORN_GRAD_RTOL})")
        grad_rel.append(r)
    with torch.no_grad():
        _, f_hist, g_hist = kernels.sinkhorn_fwd(xg, yg, eps, iters)
        one = torch.ones((), device=DEVICE)
        bwd_ms = cuda_ms(torch, lambda: kernels.sinkhorn_bwd(
            xg, yg, eps, iters, f_hist, g_hist, one), 5)
    bwd_plain_ms = cuda_ms(torch, lambda: torch.autograd.grad(
        out_t, (xt, yt), retain_graph=True), 3)
    del out_t, gt
    torch.cuda.empty_cache()
    log(f"[16 sinkhorn b] gradient at P {SINKHORN_GRAD[0]} x Q "
        f"{SINKHORN_GRAD[1]}: x {grad_rel[0]:.2e}, y {grad_rel[1]:.2e} of "
        f"their max from the twin's autograd (rtol {SINKHORN_GRAD_RTOL}); "
        f"backward kernel {bwd_ms:.2f} ms, twin's backward "
        f"{bwd_plain_ms:.2f} ms")

    # (c) the JAX test's cases
    rng = np.random.default_rng(3)
    cx = torch.as_tensor(rng.normal(size=(30, 3)).astype(np.float32),
                         device=DEVICE)
    cy = torch.as_tensor(rng.normal(size=(30, 3)).astype(np.float32) + 2.0,
                         device=DEVICE)
    same = float(dist.sinkhorn_divergence(cx, cx, 0.01))
    apart = float(dist.sinkhorn_divergence(cy, cx, 0.01))
    check(same < 0.05 and apart > 1.0, f"K8-sinkhorn: identical clouds "
          f"{same}, clouds 2 apart {apart}")
    phase_s = time.perf_counter() - t0
    recs = []
    for name, shape in (
            ("sinkhorn_fwd", sinkhorn_shape(
                "a", SINKHORN_P, SINKHORN_Q, 2 * iters + 1, SINKHORN_FWD_OPS,
                ms=fwd_ms, plain_ms=fwd_plain_ms,
                max_abs_err=abs(float(got) - float(ref)), rel_err=rel)),
            ("sinkhorn_bwd", sinkhorn_shape(
                "b", *SINKHORN_GRAD, 2 * iters + 2, SINKHORN_BWD_OPS,
                ms=bwd_ms, plain_ms=bwd_plain_ms,
                max_abs_err=max(grad_abs), rel_err=max(grad_rel)))):
        r = summarize(name, *KERNEL_SOURCES[name], [shape])
        r.update(path="sinkhorn", launches=counts[name])
        recs.append(r)
    line = {"phase": "sinkhorn", "nvidia_smi": smi,
            "forward": {"p": SINKHORN_P, "q": SINKHORN_Q, "eps": eps,
                        "n_iters": iters, "value": float(got),
                        "twin": float(ref), "rel": rel, "ms": fwd_ms,
                        "twin_ms": fwd_plain_ms},
            "gradient": {"p": SINKHORN_GRAD[0], "q": SINKHORN_GRAD[1],
                         "rel_of_max": grad_rel, "ms": bwd_ms,
                         "twin_backward_ms": bwd_plain_ms},
            "jax_cases": {"same": same, "apart": apart},
            "launches": {k: v for k, v in counts.items() if v},
            "phase_s": phase_s, "budget_s": SINKHORN_PHASE_S,
            "script_s": time.perf_counter() - t_start}
    log(json.dumps(line, default=float))
    check(phase_s <= SINKHORN_PHASE_S, f"phase 16 took {phase_s:.1f} s, "
          f"over its {SINKHORN_PHASE_S:.0f} s budget")
    return {"line": line, "records": recs}


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
    from craniofacialsd_vae_tpu_torch.ops import distances, eigh, sparse
    from craniofacialsd_vae_tpu_torch.models import (SDVAEConfig,
                                                     SpiralGeometry,
                                                     init_sdvae)
    from craniofacialsd_vae_tpu_torch.viz import raster

    mods = {"kernels": kernels, "ops": ops, "raster": raster,
            "sparse": sparse, "distances": distances, "eigh": eigh}
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
                                  k7["solo"], root, smi_line)
        records += entry["records"]
        log(f"[7 entry] done; total {time.perf_counter() - t_start:.1f} s")
        torch.cuda.empty_cache()
        mixed = phase_mixed(torch, mods, bundle, serve, train,
                            k1_ptxas(build_log), root, entry["cfg_path"],
                            config)
        records += mixed["records"]
        log(f"[8 mixed] done; total {time.perf_counter() - t_start:.1f} s")
        torch.cuda.empty_cache()
        graphs = phase_graphs(torch, bundle, config, smi_line)
        log(f"[8g graphs] done; total {time.perf_counter() - t_start:.1f} "
            "s")
        diagnosis = phase_diagnosis(torch, mods, {
            "fp32": entry["run_dir"], "mixed": mixed["entry"]["run_dir"]},
            smi_line)
        records += diagnosis["records"]
        log(f"[9 diagnosis] done; total {time.perf_counter() - t_start:.1f} "
            "s")
        torch.cuda.empty_cache()
        augmentation = phase_augmentation(torch, mods, root,
                                          k1_ptxas(build_log))
        records.append(augmentation["record"])
        log(f"[10 augmentation] done; total "
            f"{time.perf_counter() - t_start:.1f} s")
        torch.cuda.empty_cache()
        evaluation = phase_evaluation(
            torch, mods, root, {"fp32": entry["run_dir"],
                                "mixed": mixed["entry"]["run_dir"]},
            diagnosis["runs"]["fp32"]["labels"], smi_line)
        records += evaluation["records"]
        log(f"[11 evaluation] done; total "
            f"{time.perf_counter() - t_start:.1f} s")
        torch.cuda.empty_cache()
        figures = phase_figures(torch, root, entry["run_dir"], smi_line)
        log(f"[12 figures] done; total {time.perf_counter() - t_start:.1f} "
            "s")
        torch.cuda.empty_cache()
        by_path = {p: [r for r in records if r["path"] == p]
                   for p in ("training", "train_entry", "diagnosis")}
        parallel = phase_parallel(torch, mods, bundle, config, root,
                                  entry["cfg_path"], entry["run_dir"],
                                  by_path, k1_ptxas(build_log), smi_line)
        records += parallel["records"]
        log(json.dumps(parallel["line"], default=float))
        log(f"[13 parallel] done; total {time.perf_counter() - t_start:.1f} "
            "s")
        torch.cuda.empty_cache()
        ensembles = phase_ensembles(torch, mods, root, entry["cfg_path"],
                                    by_path, t_start, smi_line)
        records += ensembles["records"]
        log(f"[14 ensembles] done; total "
            f"{time.perf_counter() - t_start:.1f} s")
        torch.cuda.empty_cache()
        export = phase_export(torch, mods, root, {
            "fp32": entry["run_dir"], "mixed": mixed["entry"]["run_dir"]},
            t_start, smi_line)
        records += export["records"]
        log(f"[15 export] done; total {time.perf_counter() - t_start:.1f} "
            "s")
        torch.cuda.empty_cache()
        sinkhorn = phase_sinkhorn(torch, mods, t_start, smi_line)
        records += sinkhorn["records"]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check({r["name"] for r in records} == set(kernels.KERNEL_NAMES),
          "the kernels' record does not list every kernel")
    # launches: the wrappers' (warm-up and capture of a graph included);
    # replayed: what the graphs' replays launched on the path, each
    # graph's replay profiled against its capture (check_replays)
    for rec in records:
        rec["replayed"] = PATH_REPLAYS[rec["path"]][rec["name"]]
    total_s = time.perf_counter() - t_start
    log(f"[16 sinkhorn] done; chip_smoke total {total_s:.1f} s")
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
                       "graphs": {k: graphs[k] for k in (
                           "line", "runs", "baseline")},
                       "diagnosis": {k: diagnosis[k] for k in (
                           "line", "shapes", "runs", "path_shapes")},
                       "augmentation": {k: augmentation[k] for k in (
                           "line", "k9", "solves")},
                       "evaluation": evaluation["line"],
                       "figures": figures,
                       "parallel": parallel["line"],
                       "ensembles": ensembles["line"],
                       "export": export["line"],
                       "sinkhorn": sinkhorn["line"], "total_s": total_s},
                      f, indent=1, default=float)

    print(json.dumps({"kernels": [
        {k: r[k] for k in ("name", "path", "route", "source", "replaces",
                           "launches", "replayed", "max_abs_err", "ms",
                           "plain_ms", "bound_ms", "bound_by",
                           "library_ms")}
        for r in records]}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

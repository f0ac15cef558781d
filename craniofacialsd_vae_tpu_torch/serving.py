"""Serving a trained run (counterpart of ``serving.py``).

``build_raw_programs`` gives the three raw-scan-space programs every
deployment surface shares: normalize → encode, decode → un-normalize, and
reconstruct, which returns the per-vertex error in mm as well.
``DiagnosisService`` serves them, and the clinical requests built on
them, with static batch buckets: a request is padded to the next bucket
size (powers of two up to ``max_batch``) by repeating its first mesh, and
larger batches run in ``max_batch`` chunks.

``DiagnosisService.from_run_dir`` builds a service from a run directory
of either package alone (config snapshot, last checkpoint, classifier
zoo, the precomputed dir's ``norm.npz`` and the classes of its split
cache), with no training dataset, and answers:

- ``diagnose``: the predicting head's label, the QDA posteriors (columns
  labelled through ``qda.classes``) and the Mahalanobis distance to the
  healthy class; with ``n_samples`` the posterior-sampling uncertainty
  (``analysis/uncertainty.py``);
- ``saliency``: the gradient attribution of the QDA margin onto the scan
  (``analysis/saliency.py``);
- ``plan``: the walk toward the healthy Gaussian with its decoded key
  meshes (``analysis/planning.py``);
- ``fit``: an unregistered scan fitted through the decoder with the
  chamfer K8, then diagnosed (``analysis/fitting.py``).

``DiagnosisService.from_bundle`` serves ``encode``/``decode``/
``reconstruct`` from a geometry bundle and weights, with no run dir and no
zoo. The HTTP entry point is ``serve.py``.

On the card each of the three programs runs as one CUDA graph per bucket
(``graphs.py``), as the JAX package compiles one program per bucket:
captured at a bucket's first request or in ``warmup``, a replica's
graphs in one memory pool. A request is copied into the bucket's pinned
host buffer, then to its static device input without blocking, and the
answers come back through pinned buffers. Saliency and posterior sampling run
eagerly.

``data_parallel=True`` serves over several devices in one process, as
the JAX service shards each bucket over the local devices: the model is
replicated on each device (``parallel.replicate_model``), the buckets
are multiples of the device count, and a bucket's rows are split evenly
over the devices, each running its slice with its own replica (and on
the card its own graphs, all launched before any is waited on; a device
given only padding rows sits the request out); the fit
splits its restarts over them (``analysis/fitting.py``). Saliency and
posterior sampling run on the first device.

``EnsembleService`` serves a deep ensemble's run dir (``ensemble.json``
and K member run dirs, written by either package's ensemble trainer):
one ``DiagnosisService`` a member, and ``diagnose`` answers their
consensus (``analysis.uncertainty.summarize_ensemble``); the
single-model requests are refused with a pointer to the member dirs.
"""

from __future__ import annotations

import json
import os
import threading
import time

import numpy as np
import torch

from .device import resolve_device
from .graphs import capture
from .models import SDVAE, SDVAEConfig, SpiralGeometry

__all__ = ["load_normalization", "run_normalization", "classes_from_split",
           "build_raw_programs", "BundleModel", "DiagnosisService",
           "EnsembleService"]


def load_normalization(precomputed_path: str) -> dict:
    """Per-vertex normalization stats from a precomputed dir: ``norm.npz``
    or a migrated reference ``norm.pt``."""
    norm_path = os.path.join(precomputed_path, "norm.npz")
    ref_norm_path = os.path.join(precomputed_path, "norm.pt")
    if os.path.exists(norm_path):
        with np.load(norm_path) as z:
            return {"mean": z["mean"], "std": z["std"]}
    if os.path.exists(ref_norm_path):
        from .data.dataset import _import_reference_norm
        mean, std = _import_reference_norm(ref_norm_path)
        return {"mean": mean, "std": std}
    raise FileNotFoundError(
        f"no normalization stats at {norm_path} (or norm.pt) — the run's "
        "precomputed dir is required for serving")


def run_normalization(config: dict) -> dict | None:
    """The normalization the run's model expects at its input: the
    precomputed stats when it trained with ``normalize_data`` (the
    default), or None (identity) when it consumed raw coordinates."""
    if not config["data"].get("normalize_data", True):
        return None
    return load_normalization(config["data"]["precomputed_path"])


def classes_from_split(precomputed_path: str) -> dict:
    """The class2idx map from the run's cached ``data_split.json``: the
    first-letter labels (with 'b' last) the training run used, so that
    served indices match the fitted heads."""
    split_path = os.path.join(precomputed_path, "data_split.json")
    if not os.path.exists(split_path):
        raise FileNotFoundError(
            f"no {split_path} — pass classes= explicitly")
    with open(split_path) as f:
        names = json.load(f)["train"]
    from .data.dataset import compute_class_weights
    from .utils import class_conversions_and_weights
    class2idx, _ = class_conversions_and_weights(
        compute_class_weights(names))
    return class2idx


def build_raw_programs(model: SDVAE, normalization: dict | None,
                       to_mm: float) -> dict:
    """``encode``: raw [B, N, 3] → mu [B, Z]; ``decode``: z [B, Z] → raw
    [B, N, 3]; ``reconstruct``: raw [B, N, 3] → (recon [B, N, 3],
    per-vertex error in mm [B, N], mu [B, Z]). Each takes and returns
    tensors on the model's device."""
    dev = model.geom.device
    if normalization is None:            # normalize_data: False → identity
        normalization = {"mean": 0.0, "std": 1.0}
    mean = torch.as_tensor(np.asarray(normalization["mean"], np.float32),
                           device=dev)
    std = torch.as_tensor(np.asarray(normalization["std"], np.float32),
                          device=dev)
    to_mm = float(to_mm)

    def _encode_raw(x):
        xn = (x - mean) / std
        mu, _ = model.encode(xn.transpose(0, 1))
        return mu

    def _reconstruct_raw(x):
        xn = (x - mean) / std
        mu, _ = model.encode(xn.transpose(0, 1))
        out = model.decode(mu).transpose(0, 1)
        recon = out * std + mean
        err = torch.sqrt(torch.sum((recon - x) ** 2, dim=-1)) * to_mm
        return recon, err, mu

    def _decode_raw(z):
        out = model.decode(z).transpose(0, 1)
        return out * std + mean

    return {"encode": _encode_raw, "reconstruct": _reconstruct_raw,
            "decode": _decode_raw}


#: calls of a program on a side stream before its bucket's graph is
#: captured
WARMUP_PASSES = 1


class _BucketGraph:
    """One program at one bucket size on the card: pinned host buffers of
    the bucket's inputs and outputs, the static device inputs and the
    CUDA graph whose outputs the replays overwrite."""

    def __init__(self, fn, shapes: list, device, pool):
        self.dev_in = [torch.zeros(s, dtype=torch.float32, device=device)
                       for s in shapes]
        self.host_in = [torch.empty(s, dtype=torch.float32).pin_memory()
                        for s in shapes]

        def call():
            with torch.inference_mode():
                out = fn(*self.dev_in)
            self.dev_out = out if isinstance(out, tuple) else (out,)

        self.graph = capture(call, device, WARMUP_PASSES, pool)
        self.host_out = [torch.empty(t.shape, dtype=t.dtype).pin_memory()
                         for t in self.dev_out]
        self.stream = torch.cuda.current_stream(device)

    def launch(self, chunks: list, pads: list) -> None:
        """``chunks`` (at most the bucket's rows each) copied in, the rest
        of the bucket filled with ``pads`` (one row each); the copies, the
        replay and the answers' copies queued on the device, nothing
        waited on."""
        for host, dev, chunk, pad in zip(self.host_in, self.dev_in, chunks,
                                         pads):
            h = host.numpy()
            h[:len(chunk)] = chunk
            h[len(chunk):] = pad
            dev.copy_(host, non_blocking=True)
        self.graph.replay()
        for host, dev in zip(self.host_out, self.dev_out):
            host.copy_(dev, non_blocking=True)

    def collect(self, n: int) -> tuple:
        """After ``launch``: wait, and the numpy answers of the first
        ``n`` rows."""
        self.stream.synchronize()
        return tuple(h.numpy()[:n].copy() for h in self.host_out)


class BundleModel:
    """What ``DiagnosisService`` reads of a ``ModelManager``, over a
    geometry bundle and weights alone: the model, its device and the mm
    scale, with no template and no classifier zoo (so only ``encode``,
    ``decode`` and ``reconstruct`` can be served). ``params`` is a
    ``state_dict`` (for example from ``models.params_from_jax``); without
    it the weights are drawn from ``seed``."""

    template = None
    classifiers = None
    latent_regions: dict = {}
    _class2idx_dict = None

    def __init__(self, bundle, config: SDVAEConfig, to_mm: float,
                 params: dict | None = None, seed: int = 0, device=None):
        self.device = resolve_device(device)
        geom = SpiralGeometry.from_bundle(bundle, device=self.device)
        model = SDVAE(config, geom, torch.Generator().manual_seed(seed))
        if params is not None:
            model.load_state_dict(params)
        self.model = model.to(self.device).eval()
        self.net_config = config
        self.to_mm_const = float(to_mm)
        self.model_latent_size = config.latent_size


class DiagnosisService:
    """Batched inference over a trained manager (``ModelManager``, or a
    ``BundleModel``) on the manager's device. Thread-safe: device work is
    serialized behind one lock."""

    #: upper bound on diagnose(n_samples=...): the sample count is chosen
    #: by the client, and programs run only at powers of two up to it
    MAX_UNCERTAINTY_SAMPLES = 256

    def __init__(self, manager, normalization: dict | None,
                 healthy_class: str = "n", max_batch: int = 16,
                 data_parallel: bool = False, devices=None):
        from .analysis.tester import TEMPLATE_LANDMARKS_IDX
        from .parallel.mesh import Mesh, replicate_model, same_device

        self.manager = manager
        self.device = manager.device
        self.model = manager.model
        self.normalization = normalization
        self.healthy_class = healthy_class
        self.max_batch = int(max_batch)
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be ≥ 1; got {max_batch}")
        # data-parallel serving: the devices (default: every visible card,
        # or the manager's device on the host), one replica on each
        if data_parallel:
            if devices is None:
                devices = [torch.device("cuda", i) for i in
                           range(torch.cuda.device_count())] \
                    if self.device.type == "cuda" else [self.device]
            devices = [resolve_device(d) for d in devices]
        else:
            devices = [self.device]
        self.n_devices = len(devices)
        if data_parallel and self.max_batch % self.n_devices:
            raise ValueError(
                f"data_parallel serving pads each request to a multiple "
                f"of the {self.n_devices} devices: max_batch "
                f"{self.max_batch} must be a multiple of it")
        self._mesh = Mesh(devices=devices) if data_parallel else None
        self._replicas = [self.model if i == 0 and same_device(d, self.device)
                          else replicate_model(self.model, d).eval()
                          for i, d in enumerate(devices)]
        # the clinical landmark ids valid on this template (the full set
        # belongs to the 17,039-vertex template); settable for others
        tpl = manager.template
        self.landmark_idx = [] if tpl is None else \
            [i for i in TEMPLATE_LANDMARKS_IDX if i < tpl.num_vertices]
        self.buckets = [b * self.n_devices
                        for b in (1, 2, 4, 8, 16, 32, 64, 128)
                        if b * self.n_devices <= self.max_batch]
        if self.buckets[-1] != self.max_batch:
            self.buckets.append(self.max_batch)
        self._lock = threading.Lock()
        self._latency_ms: list = []        # ring buffer, last 512 requests
        self.n_requests = 0
        self.n_meshes = 0
        self._replica_programs = [
            build_raw_programs(m, normalization, manager.to_mm_const)
            for m in self._replicas]
        self._programs = self._replica_programs[0]
        # on the card: the programs' graphs by (program, rows, replica),
        # one memory pool a replica
        self._bucket_graphs: dict = {}
        self._graph_pools: dict = {}
        self._saliency_fn = None            # built at the first request
        self._uncertainty: dict = {}        # programs by sample count

    # ------------------------------------------------------------------
    @classmethod
    def from_bundle(cls, bundle, config: SDVAEConfig,
                    normalization: dict | None, to_mm: float,
                    params: dict | None = None, seed: int = 0,
                    max_batch: int = 16, device=None,
                    data_parallel: bool = False,
                    devices=None) -> "DiagnosisService":
        """A service of ``encode``/``decode``/``reconstruct`` over a
        geometry bundle and weights (``BundleModel``); ``device=None``
        serves on the card."""
        return cls(BundleModel(bundle, config, to_mm, params, seed, device),
                   normalization, max_batch=max_batch,
                   data_parallel=data_parallel, devices=devices)

    @classmethod
    def from_run_dir(cls, run_dir: str, classes: dict | None = None,
                     healthy_class: str = "n", max_batch: int = 16,
                     warm: bool = False, device=None,
                     data_parallel: bool = False,
                     devices=None) -> "DiagnosisService":
        """Build a service from ``outputs/<id>/`` of either package alone:
        config snapshot, last checkpoint, classifier zoo and the
        precomputed dir's normalization stats and split cache. The
        training dataset is not needed. ``device=None`` serves on the
        card; ``data_parallel`` over ``devices`` (default: every visible
        card)."""
        from .manager import ModelManager
        from .utils import get_config

        config_path = os.path.join(run_dir, "config.yaml")
        if os.path.exists(os.path.join(run_dir, "ensemble.json")):
            raise ValueError(
                f"{run_dir} is an ensemble run dir: serve it with "
                "EnsembleService.from_ensemble_dir, or serve a member run "
                "dir")
        if not os.path.exists(config_path):
            raise FileNotFoundError(f"no config snapshot at {config_path}")
        config = get_config(config_path)
        precomp = config["data"]["precomputed_path"]
        if classes is None:
            classes = classes_from_split(precomp)
        # size the MLP head from the split cache: the dataset dir may be
        # gone in deployment
        if config.get("classifier"):
            config["classifier"].setdefault("n_classes", len(classes))

        manager = ModelManager(config, precomputed_storage_path=precomp,
                               device=device)
        manager.resume(os.path.join(run_dir, "checkpoints"))
        if manager.classifiers is None or manager.classifiers.qda is None:
            raise RuntimeError(
                f"run at {run_dir} has no fitted classifier zoo — "
                "diagnosis serving needs the trained heads")
        manager.set_class_conversions(classes)
        manager.model.eval()
        svc = cls(manager, run_normalization(config),
                  healthy_class=healthy_class, max_batch=max_batch,
                  data_parallel=data_parallel, devices=devices)
        if warm:
            svc.warmup()
        return svc

    # ------------------------------------------------------------------
    def _bucket(self, b: int) -> int:
        for size in self.buckets:
            if b <= size:
                return size
        return self.max_batch

    def _chunked(self, run, arrays: tuple):
        """``run(chunks, n)`` on each max_batch chunk of arrays of B rows
        (``n`` rows each); its numpy outputs concatenated back to B."""
        b = arrays[0].shape[0]
        outs = []
        for lo in range(0, b, self.max_batch):
            chunks = [a[lo:lo + self.max_batch] for a in arrays]
            outs.append(run(chunks, chunks[0].shape[0]))
        merged = tuple(np.concatenate(parts, axis=0)
                       for parts in zip(*outs))
        return merged if len(merged) > 1 else merged[0]

    def _run_bucketed(self, fn, *arrays: np.ndarray, grad: bool = False):
        """Run arrays of B rows each ([B, ...]) through ``fn`` (one tensor
        on the device per array in, tensors out) at bucket-padded shapes,
        chunking batches above max_batch; returns numpy outputs trimmed to
        B. ``grad`` keeps autograd available (saliency)."""
        def run(chunks, n):
            size = self._bucket(n)
            padded = []
            for chunk in chunks:
                if size != n:            # pad by repeating the first row
                    pad = np.broadcast_to(
                        chunk[:1], (size - n,) + chunk.shape[1:])
                    chunk = np.concatenate([chunk, pad], axis=0)
                padded.append(torch.as_tensor(chunk, device=self.device))
            res = fn(*padded)
            res = res if isinstance(res, tuple) else (res,)
            return tuple(r[:n].detach().cpu().numpy() for r in res)

        with torch.inference_mode(not grad):
            return self._chunked(run, arrays)

    def _bucket_graph(self, name: str, size: int,
                      replica: int) -> _BucketGraph:
        """The graph of program ``name`` at ``size`` rows on one replica,
        captured at its first use. The caller holds the lock. A replica's
        graphs share one memory pool."""
        key = (name, size, replica)
        if key not in self._bucket_graphs:
            if replica not in self._graph_pools:
                self._graph_pools[replica] = torch.cuda.graph_pool_handle()
            n = self.model.geom.num_vertices
            row = (self.manager.model_latent_size,) if name == "decode" \
                else (n, 3)
            self._bucket_graphs[key] = _BucketGraph(
                self._replica_programs[replica][name], [(size, *row)],
                self._replicas[replica].geom.device,
                self._graph_pools[replica])
        return self._bucket_graphs[key]

    def _run_program(self, name: str, *arrays: np.ndarray):
        """One of ``build_raw_programs``' programs on arrays of B rows,
        each max_batch chunk padded to its bucket by repeating its first
        row and split evenly over the replicas; a replica given only
        padding is skipped. On the card each replica replays its graph
        of the program at its share of the bucket, every replica launched
        before any is waited on; on the host each runs it eagerly."""
        def run(chunks, n):
            per = self._bucket(n) // len(self._replicas)
            pads = [c[:1] for c in chunks]
            parts = [[c[i * per:(i + 1) * per] for c in chunks]
                     for i in range(len(self._replicas))]
            parts = [(i, p) for i, p in enumerate(parts) if len(p[0])]
            if self.device.type == "cuda":
                graphs = [self._bucket_graph(name, per, i) for i, _ in parts]
                for g, (_, part) in zip(graphs, parts):
                    g.launch(part, pads)
                outs = [g.collect(len(part[0]))
                        for g, (_, part) in zip(graphs, parts)]
            else:
                outs = []
                with torch.inference_mode():
                    for i, part in parts:
                        k = len(part[0])
                        dev = self._replicas[i].geom.device
                        full = [np.concatenate([p, np.broadcast_to(
                            pad, (per - k,) + p.shape[1:])])
                            for p, pad in zip(part, pads)]
                        res = self._replica_programs[i][name](
                            *[torch.as_tensor(a, device=dev) for a in full])
                        res = res if isinstance(res, tuple) else (res,)
                        outs.append(tuple(r[:k].cpu().numpy() for r in res))
            return tuple(np.concatenate(o, axis=0) for o in zip(*outs))

        return self._chunked(run, arrays)

    def _observe(self, b: int, t0: float):
        self.n_requests += 1
        self.n_meshes += b
        self._latency_ms.append((time.perf_counter() - t0) * 1e3)
        if len(self._latency_ms) > 512:
            del self._latency_ms[:256]

    def _as_batch(self, vertices) -> tuple:
        """[N, 3] or [B, N, 3] → ([B, N, 3], was_single). A wrong vertex
        count is a client error, not a broadcast against the stats."""
        x = np.asarray(vertices, np.float32)
        single = x.ndim == 2
        x = x[None] if single else x
        n = self.model.geom.num_vertices
        if x.ndim != 3 or x.shape[1] != n or x.shape[2] != 3:
            raise ValueError(
                f"vertices must be [N, 3] or [B, N, 3] with N={n} "
                f"(the template vertex count); got {x.shape}")
        if x.shape[0] == 0:
            raise ValueError("empty batch (B=0)")
        return x, single

    def _zoo(self):
        zoo = self.manager.classifiers
        if zoo is None or zoo.qda is None:
            raise ValueError("this service has no fitted classifier zoo; "
                             "build it with from_run_dir")
        return zoo

    def _healthy_idx(self) -> int:
        mgr = self.manager
        if self.healthy_class not in (mgr._class2idx_dict or {}):
            raise ValueError(
                f"healthy class {self.healthy_class!r} is not among the "
                f"run's classes {sorted(mgr._class2idx_dict or {})}")
        return mgr.class2idx(self.healthy_class)

    # ------------------------------------------------------------------
    def warmup(self):
        """Run every bucket of encode, reconstruct and decode once (on the
        card: capture its graph), so the first request meets built
        kernels and a warm allocator."""
        n = self.model.geom.num_vertices
        nz = self.manager.model_latent_size
        with self._lock:
            for size in self.buckets:
                x = np.zeros((size, n, 3), np.float32)
                z = np.zeros((size, nz), np.float32)
                self._run_program("encode", x)
                self._run_program("reconstruct", x)
                self._run_program("decode", z)

    def warmup_fit(self, scan_points: int = 8192 * 4,
                   iterations: int = 250, n_restarts: int = 16):
        """Run one fit of a template-derived fake scan (result discarded)
        without counting it in the request stats. With no landmark valid
        on this template there is nothing to warm."""
        if not self.landmark_idx:
            print("warmup_fit: no landmark indices valid on this "
                  "template — skipping fit warmup", flush=True)
            return
        tpl = np.asarray(self.manager.template.pos, np.float32)
        rng = np.random.default_rng(0)
        scan = tpl[rng.integers(0, len(tpl), size=int(scan_points))]
        self.fit(scan, tpl[self.landmark_idx],
                 iterations=int(iterations), n_restarts=int(n_restarts))
        with self._lock:                # undo the warmup's observation
            self.n_requests -= 1
            self.n_meshes -= 1
            if self._latency_ms:
                self._latency_ms.pop()

    def encode(self, vertices) -> np.ndarray:
        """Raw scan-space [B, N, 3] (or [N, 3]) → latents [B, Z]."""
        t0 = time.perf_counter()
        x, single = self._as_batch(vertices)
        with self._lock:
            mu = self._run_program("encode", x)
            self._observe(x.shape[0], t0)
        return mu[0] if single else mu

    def decode(self, z) -> np.ndarray:
        """Latents [B, Z] (or [Z]) → raw scan-space vertices."""
        t0 = time.perf_counter()
        z = np.asarray(z, np.float32)
        single = z.ndim == 1
        z = z[None] if single else z
        nz = self.manager.model_latent_size
        if z.ndim != 2 or z.shape[1] != nz:
            raise ValueError(f"latent must be [Z] or [B, Z] with Z={nz}; "
                             f"got {z.shape}")
        if z.shape[0] == 0:
            raise ValueError("empty batch (B=0)")
        with self._lock:
            out = self._run_program("decode", z)
            self._observe(z.shape[0], t0)
        return out[0] if single else out

    def reconstruct(self, vertices) -> dict:
        """Raw scans → reconstructions + per-vertex/mean error in mm —
        the screening metric (reference test.py:280-301 semantics)."""
        t0 = time.perf_counter()
        x, single = self._as_batch(vertices)
        with self._lock:
            recon, err, mu = self._run_program("reconstruct", x)
            self._observe(x.shape[0], t0)
        out = {"vertices": recon, "vertex_errors_mm": err,
               "mean_error_mm": err.mean(axis=1), "latent": mu}
        if single:
            out = {k: v[0] for k, v in out.items()}
        return out

    def diagnose(self, vertices, model: str = "qda", n_samples: int = 0,
                 seed: int = 0, eps=None) -> list:
        """Raw scans → per-mesh reports: the ``model`` head's label, the
        QDA class posteriors and the Mahalanobis distance to the healthy
        class's Gaussian. ``n_samples > 0`` (VAE runs) adds an
        ``uncertainty`` block from that many draws of q(z|x) per scan, in
        the same bucketed pass; the program draws the next power of two
        (row ``i`` of a chunk from ``(seed, i)``) and the summary uses the
        first ``n_samples``. ``eps [B, K', Z]`` (K' that power of two)
        replaces the draws."""
        x, single = self._as_batch(vertices)
        self._zoo()
        if not n_samples:
            mu = self.encode(x)
            reports = self._diagnosis_reports(mu, model,
                                              include_latent=True)
            return reports[0] if single else reports
        n_samples = int(n_samples)
        if not 1 <= n_samples <= self.MAX_UNCERTAINTY_SAMPLES:
            raise ValueError(
                f"n_samples must be in [1, {self.MAX_UNCERTAINTY_SAMPLES}]"
                f"; got {n_samples}")
        from .analysis.uncertainty import summarize_uncertainty

        t0 = time.perf_counter()
        mgr = self.manager
        k = 1 << (n_samples - 1).bit_length()
        if eps is not None:
            eps = np.asarray(eps, np.float32)
            if eps.shape != (x.shape[0], k, mgr.model_latent_size):
                raise ValueError(f"eps must be {(x.shape[0], k)} + (Z,); "
                                 f"got {eps.shape}")
        with self._lock:
            fn = self._uncertainty_fn(k)
            if eps is None:
                mu, lp_mu, sample_lp, sample_pred, _ = self._run_bucketed(
                    lambda c: fn(c, seed=int(seed)), x)
            else:
                mu, lp_mu, sample_lp, sample_pred, _ = self._run_bucketed(
                    lambda c, e: fn(c, eps=e), x, eps)
            self._observe(x.shape[0], t0)
        reports = self._diagnosis_reports(mu, model, include_latent=True)
        unc = summarize_uncertainty(lp_mu, sample_lp[:, :n_samples],
                                    sample_pred[:, :n_samples],
                                    mgr.classifiers.qda.classes,
                                    mgr._idx2class_dict)
        for rep, u in zip(reports, unc):
            rep["uncertainty"] = u
        return reports[0] if single else reports

    def _uncertainty_fn(self, n_samples: int):
        """The posterior-sampling program for one sample count (a power of
        two). The caller holds the lock."""
        fn = self._uncertainty.get(n_samples)
        if fn is None:
            from .analysis.uncertainty import make_uncertainty_fn
            fn = make_uncertainty_fn(self.manager, self.normalization,
                                     self.manager.classifiers.qda,
                                     n_samples)
            self._uncertainty[n_samples] = fn
        return fn

    def _diagnosis_reports(self, mu: np.ndarray, model: str,
                           include_latent: bool) -> list:
        """Per-row diagnosis reports for latents [B, Z]."""
        mgr = self.manager
        zoo = self._zoo()
        with self._lock:        # the MLP head runs on the device
            labels = mgr.idx2class(zoo.predict(mu, model=model))
            log_post = zoo.qda.log_posteriors(mu)
        post = np.exp(log_post - log_post.max(axis=1, keepdims=True))
        post = post / post.sum(axis=1, keepdims=True)
        idx2class = mgr._idx2class_dict
        # QDA fits only the classes that occur in training ('b' merges
        # into 'n' upstream): column j is qda.classes[j], not class j
        qda_classes = [int(c) for c in zoo.qda.classes]
        healthy_idx = mgr.class2idx(self.healthy_class) \
            if self.healthy_class in mgr._class2idx_dict else None
        reports = []
        for i in range(mu.shape[0]):
            rep = {
                "label": labels[i],
                "posteriors": {idx2class[c]: float(post[i, j])
                               for j, c in enumerate(qda_classes)},
            }
            if include_latent:
                rep["latent"] = mu[i].tolist()
            if healthy_idx is not None:
                rep["mahalanobis_to_healthy"] = float(
                    zoo.mahalanobis(mu[i], healthy_idx))
            reports.append(rep)
        return reports

    def saliency(self, vertices, include_vertex_saliency: bool = True,
                 model: str = "qda") -> list:
        """Raw scans → diagnosis reports with gradient attribution: the
        QDA pair the margin explains (``saliency_label``,
        ``saliency_reference_class``), ``margin_nats``, the per-region
        table sorted by share and (unless ``include_vertex_saliency`` is
        False) the per-vertex map in nats/mm."""
        from .analysis.saliency import make_saliency_fn, region_attribution

        t0 = time.perf_counter()
        x, single = self._as_batch(vertices)
        mgr = self.manager
        qda = self._zoo().qda
        with self._lock:
            if self._saliency_fn is None:
                self._saliency_fn = make_saliency_fn(
                    mgr, self.normalization, qda, self._healthy_idx())
            sal, margin, pred, ref, _, mu = self._run_bucketed(
                self._saliency_fn, x, grad=True)
            self._observe(x.shape[0], t0)
        reports = self._diagnosis_reports(mu, model, include_latent=False)
        qda_classes = np.asarray(qda.classes)
        for i, rep in enumerate(reports):
            rep["saliency_label"] = mgr.idx2class(int(qda_classes[pred[i]]))
            rep["saliency_reference_class"] = \
                mgr.idx2class(int(qda_classes[ref[i]]))
            rep["margin_nats"] = float(margin[i])
            rep["regions"] = region_attribution(sal[i], mgr.template)
            if include_vertex_saliency:
                rep["vertex_saliency_nats_per_mm"] = \
                    np.asarray(sal[i], np.float32)
        return reports[0] if single else reports

    def fit(self, vertices, landmarks, lr: float = 5e-3,
            iterations: int = 250, n_restarts: int = 16,
            seed: int = 0, model: str = "qda") -> dict:
        """Fit a latent to an unregistered scan (any vertex count) given
        its ``[K, 3]`` landmarks (K = the template's landmark set), then
        diagnose the fitted latent: the clinical intake (reference
        test.py:336-520) as one request."""
        from .analysis.fitting import fit_latent

        x = np.asarray(vertices, np.float32)
        lnd = np.asarray(landmarks, np.float32)
        if x.ndim != 2 or x.shape[-1] != 3 or x.shape[0] == 0:
            raise ValueError(f"scan must be [M, 3]; got {x.shape}")
        lnd_idx = self.landmark_idx
        if not lnd_idx:
            raise ValueError(
                "no landmark indices valid on this template — set "
                "service.landmark_idx")
        if lnd.shape != (len(lnd_idx), 3):
            raise ValueError(
                f"landmarks must be [{len(lnd_idx)}, 3] matching the "
                f"template landmark set; got {lnd.shape}")
        t0 = time.perf_counter()
        with self._lock:
            # under data_parallel the restarts split over the devices
            result = fit_latent(self.manager, self.normalization, x, lnd,
                                lnd_idx, lr=lr, iterations=int(iterations),
                                n_restarts=int(n_restarts), seed=int(seed),
                                mesh=self._mesh)
            self._observe(1, t0)
        report = self.diagnose_latent(result["z"], model=model)
        return {"z": result["z"], "vertices": result["vertices"],
                "chamfer_mm2": result["chamfer_mm2"],
                "landmark_mse_mm2": result["landmark_mse_mm2"],
                "aligned_scan": result["aligned_scan"],
                "best_restart": result["best_restart"],
                "diagnosis": report}

    def diagnose_latent(self, z, model: str = "qda") -> dict:
        """Diagnosis report for one latent [Z] (the heads only)."""
        return self.diagnose_latents(
            np.asarray(z, np.float32).reshape(1, -1), model=model)[0]

    def diagnose_latents(self, z, model: str = "qda") -> list:
        """Diagnosis reports for latents [B, Z], one batched head call."""
        z = np.asarray(z, np.float32)
        return self._diagnosis_reports(z.reshape(len(z), -1), model,
                                       include_latent=False)

    def plan(self, vertices=None, latent=None, n_p_to_3std: int = 8,
             n_linspace: int = 5000, model: str = "qda",
             decode_key_meshes: bool = True,
             include_paths: bool = False) -> dict:
        """Surgical planning for one patient (reference test.py:652-748):
        walk the latent toward the healthy class's QDA Gaussian, return
        the 3/2/1-std crossing latents, the per-procedure latent-distance
        table and (by default) the decoded key meshes, all four in one
        bucketed decode. Pass raw ``vertices`` ([N, 3], registered) or a
        ``latent`` [Z]; ``include_paths`` adds the full walks."""
        from .analysis.planning import healthy_gaussian, plan_to_healthy

        t0 = time.perf_counter()
        if (vertices is None) == (latent is None):
            raise ValueError("pass exactly one of vertices / latent")
        if vertices is not None:
            x, single = self._as_batch(vertices)
            if not single and x.shape[0] != 1:
                raise ValueError("plan() takes ONE patient mesh")
            # counted once, at the end, as one request
            with self._lock:
                z_p = np.asarray(
                    self._run_program("encode", x)[0],
                    np.float32)
        else:
            z_p = np.asarray(latent, np.float32).reshape(-1)
            nz = self.manager.model_latent_size
            if z_p.shape[0] != nz:
                raise ValueError(f"latent must have Z={nz} dims; "
                                 f"got {z_p.shape[0]}")
        mgr = self.manager
        mean_h, cov_h = healthy_gaussian(self._zoo().qda,
                                         self._healthy_idx())
        result = plan_to_healthy(z_p, mean_h, cov_h, mgr.latent_regions,
                                 n_p_to_3std=int(n_p_to_3std),
                                 n_linspace=int(n_linspace))
        out = {
            "diagnosis": self.diagnose_latent(z_p, model=model),
            "z_patient": z_p,
            "z_3std": result["z_3std"], "z_2std": result["z_2std"],
            "z_1std": result["z_1std"],
            "z_mean_target": np.asarray(result["z_mean_target"],
                                        np.float32),
            "procedure_distances": result["procedure_distances"],
        }
        if include_paths:
            out["all_attributes"] = result["all_attributes"]
            out["procedures"] = result["procedures"]
        if decode_key_meshes:
            keys = ["z_3std", "z_2std", "z_1std", "z_mean_target"]
            zs = np.stack([np.asarray(out[k], np.float32) for k in keys])
            with self._lock:
                meshes = self._run_program("decode", zs)
            out["target_meshes"] = {k[2:]: meshes[i]
                                    for i, k in enumerate(keys)}
        with self._lock:
            self._observe(1, t0)
        return out

    def stats(self) -> dict:
        """Request counters and host-clock latency of recent requests."""
        lat = sorted(self._latency_ms)
        classes = self.manager._class2idx_dict
        return {"requests": self.n_requests, "meshes": self.n_meshes,
                "p50_ms": lat[len(lat) // 2] if lat else None,
                "p95_ms": lat[int(len(lat) * 0.95)] if lat else None,
                "buckets": self.buckets, "device": str(self.device),
                "n_devices": self.n_devices,
                "classes": dict(classes) if classes else None}


class EnsembleService:
    """Consensus diagnosis over a trained deep ensemble: one
    ``DiagnosisService`` a member run dir, and ``diagnose`` answers the
    cross-member consensus (``analysis.uncertainty.summarize_ensemble``:
    majority label, member agreement, per-class posterior mean and std
    over members, predictive entropy) with each member's own block. With
    ``n_samples > 0`` each member also samples its own posterior.

    Only the consensus surface exists: every single-model request
    (encode, decode, reconstruct, saliency, fit, plan) raises with a
    pointer to the member dirs, so ``serve.py`` serves an ensemble dir
    with its own handler and those endpoints answer 400."""

    #: single-model requests this service refuses
    _MEMBER_ONLY = ("encode", "decode", "reconstruct", "saliency", "fit",
                    "plan", "diagnose_latent", "diagnose_latents")

    def __init__(self, services: list):
        if not services:
            raise ValueError("EnsembleService needs at least one member")
        n = {s.model.geom.num_vertices for s in services}
        cls_maps = [dict(s.manager._class2idx_dict or {}) for s in services]
        if len(n) != 1 or any(c != cls_maps[0] for c in cls_maps):
            raise ValueError(
                "ensemble members disagree on template vertex count or "
                f"class map (vertex counts {sorted(n)})")
        self.services = list(services)

    @classmethod
    def from_ensemble_dir(cls, run_dir: str, **from_run_dir_kwargs
                          ) -> "EnsembleService":
        """Build from an ensemble trainer's output dir (its
        ``ensemble.json``); the kwargs go to
        ``DiagnosisService.from_run_dir`` for every member (``device=None``
        serves on the card), and ``warm`` warms every member up once
        they are all built."""
        manifest_path = os.path.join(run_dir, "ensemble.json")
        if not os.path.exists(manifest_path):
            raise FileNotFoundError(
                f"no {manifest_path} — not an ensemble run dir (train one "
                "with train_ensemble)")
        with open(manifest_path) as f:
            manifest = json.load(f)
        warm = from_run_dir_kwargs.pop("warm", False)
        services = [DiagnosisService.from_run_dir(
            os.path.join(run_dir, m["dir"]), **from_run_dir_kwargs)
            for m in manifest["members"]]
        svc = cls(services)
        if warm:
            svc.warmup()
        return svc

    @property
    def n_members(self) -> int:
        return len(self.services)

    @property
    def buckets(self):
        return self.services[0].buckets

    @property
    def device(self):
        return self.services[0].device

    @property
    def n_devices(self) -> int:
        return self.services[0].n_devices

    def warmup(self):
        for s in self.services:
            s.warmup()

    def diagnose(self, vertices, model: str = "qda", n_samples: int = 0,
                 seed: int = 0, include_members: bool = True):
        """Raw scans → per-scan consensus reports (``summarize_ensemble``'s
        fields) with each member's diagnosis block (its latent left out;
        with ``n_samples > 0`` its posterior-sampling ``uncertainty``).
        A single ``[N, 3]`` scan gives a single dict."""
        from .analysis.uncertainty import summarize_ensemble

        x, single = self.services[0]._as_batch(vertices)
        member_reports = [svc.diagnose(x, model=model, n_samples=n_samples,
                                       seed=seed)
                          for svc in self.services]
        consensus = summarize_ensemble(member_reports)
        if include_members:
            for i, row in enumerate(consensus):
                row["members"] = [
                    {k: v for k, v in member_reports[m][i].items()
                     if k != "latent"}
                    for m in range(self.n_members)]
        return consensus[0] if single else consensus

    def stats(self) -> dict:
        """The first member's stats, the requests and meshes summed over
        the members, and ``n_members``."""
        per = [s.stats() for s in self.services]
        out = dict(per[0])
        out["requests"] = sum(p["requests"] for p in per)
        out["meshes"] = sum(p["meshes"] for p in per)
        out["n_members"] = self.n_members
        return out

    def __getattr__(self, name):
        if name in type(self)._MEMBER_ONLY:
            def refuse(*args, **kwargs):
                raise ValueError(
                    f"{name} is a single-model request — serve a member "
                    "run dir (outputs/<id>/member_XX) for it; the "
                    "ensemble endpoint answers /diagnose (consensus) "
                    "and /healthz only")
            return refuse
        raise AttributeError(name)

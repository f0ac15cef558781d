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
zoo. The HTTP entry point is ``serve.py``. Data-parallel serving and
ensembles are not ported yet (ROADMAP 1.11, 1.12).
"""

from __future__ import annotations

import json
import os
import threading
import time

import numpy as np
import torch

from .device import resolve_device
from .models import SDVAE, SDVAEConfig, SpiralGeometry

__all__ = ["load_normalization", "run_normalization", "classes_from_split",
           "build_raw_programs", "BundleModel", "DiagnosisService"]


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
                 healthy_class: str = "n", max_batch: int = 16):
        from .analysis.tester import TEMPLATE_LANDMARKS_IDX

        self.manager = manager
        self.device = manager.device
        self.model = manager.model
        self.normalization = normalization
        self.healthy_class = healthy_class
        self.max_batch = int(max_batch)
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be ≥ 1; got {max_batch}")
        # the clinical landmark ids valid on this template (the full set
        # belongs to the 17,039-vertex template); settable for others
        tpl = manager.template
        self.landmark_idx = [] if tpl is None else \
            [i for i in TEMPLATE_LANDMARKS_IDX if i < tpl.num_vertices]
        self.buckets = [b for b in (1, 2, 4, 8, 16, 32, 64, 128)
                        if b <= self.max_batch]
        if self.buckets[-1] != self.max_batch:
            self.buckets.append(self.max_batch)
        self._lock = threading.Lock()
        self._latency_ms: list = []        # ring buffer, last 512 requests
        self.n_requests = 0
        self.n_meshes = 0
        self._programs = build_raw_programs(self.model, normalization,
                                            manager.to_mm_const)
        self._saliency_fn = None            # built at the first request
        self._uncertainty: dict = {}        # programs by sample count

    # ------------------------------------------------------------------
    @classmethod
    def from_bundle(cls, bundle, config: SDVAEConfig,
                    normalization: dict | None, to_mm: float,
                    params: dict | None = None, seed: int = 0,
                    max_batch: int = 16, device=None) -> "DiagnosisService":
        """A service of ``encode``/``decode``/``reconstruct`` over a
        geometry bundle and weights (``BundleModel``); ``device=None``
        serves on the card."""
        return cls(BundleModel(bundle, config, to_mm, params, seed, device),
                   normalization, max_batch=max_batch)

    @classmethod
    def from_run_dir(cls, run_dir: str, classes: dict | None = None,
                     healthy_class: str = "n", max_batch: int = 16,
                     warm: bool = False, device=None) -> "DiagnosisService":
        """Build a service from ``outputs/<id>/`` of either package alone:
        config snapshot, last checkpoint, classifier zoo and the
        precomputed dir's normalization stats and split cache. The
        training dataset is not needed. ``device=None`` serves on the
        card."""
        from .manager import ModelManager
        from .utils import get_config

        config_path = os.path.join(run_dir, "config.yaml")
        if not os.path.exists(config_path):
            raise FileNotFoundError(f"no config snapshot at {config_path}")
        if os.path.exists(os.path.join(run_dir, "ensemble.json")):
            raise ValueError(
                f"{run_dir} is an ensemble run dir: ensemble serving is not "
                "ported yet (ROADMAP 1.12); serve a member run dir")
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
                  healthy_class=healthy_class, max_batch=max_batch)
        if warm:
            svc.warmup()
        return svc

    # ------------------------------------------------------------------
    def _bucket(self, b: int) -> int:
        for size in self.buckets:
            if b <= size:
                return size
        return self.max_batch

    def _run_bucketed(self, fn, *arrays: np.ndarray, grad: bool = False):
        """Run arrays of B rows each ([B, ...]) through ``fn`` (one tensor
        on the device per array in, tensors out) at bucket-padded shapes,
        chunking batches above max_batch; returns numpy outputs trimmed to
        B. ``grad`` keeps autograd available (saliency)."""
        b = arrays[0].shape[0]
        outs = []
        with torch.inference_mode(not grad):
            for lo in range(0, b, self.max_batch):
                chunks = []
                for a in arrays:
                    chunk = a[lo:lo + self.max_batch]
                    n = chunk.shape[0]
                    size = self._bucket(n)
                    if size != n:        # pad by repeating the first row
                        pad = np.broadcast_to(
                            chunk[:1], (size - n,) + chunk.shape[1:])
                        chunk = np.concatenate([chunk, pad], axis=0)
                    chunks.append(torch.as_tensor(chunk, device=self.device))
                res = fn(*chunks)
                res = res if isinstance(res, tuple) else (res,)
                outs.append(tuple(r[:n].detach().cpu().numpy()
                                  for r in res))
        merged = tuple(np.concatenate(parts, axis=0)
                       for parts in zip(*outs))
        return merged if len(merged) > 1 else merged[0]

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
        """Run every bucket of encode, reconstruct and decode once, so
        the first request meets a warm allocator and built kernels."""
        n = self.model.geom.num_vertices
        nz = self.manager.model_latent_size
        with self._lock:
            for size in self.buckets:
                x = np.zeros((size, n, 3), np.float32)
                z = np.zeros((size, nz), np.float32)
                self._run_bucketed(self._programs["encode"], x)
                self._run_bucketed(self._programs["reconstruct"], x)
                self._run_bucketed(self._programs["decode"], z)

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
            mu = self._run_bucketed(self._programs["encode"], x)
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
            out = self._run_bucketed(self._programs["decode"], z)
            self._observe(z.shape[0], t0)
        return out[0] if single else out

    def reconstruct(self, vertices) -> dict:
        """Raw scans → reconstructions + per-vertex/mean error in mm —
        the screening metric (reference test.py:280-301 semantics)."""
        t0 = time.perf_counter()
        x, single = self._as_batch(vertices)
        with self._lock:
            recon, err, mu = self._run_bucketed(
                self._programs["reconstruct"], x)
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
            result = fit_latent(self.manager, self.normalization, x, lnd,
                                lnd_idx, lr=lr, iterations=int(iterations),
                                n_restarts=int(n_restarts), seed=int(seed))
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
                    self._run_bucketed(self._programs["encode"], x)[0],
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
                meshes = self._run_bucketed(self._programs["decode"], zs)
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
                "classes": dict(classes) if classes else None}

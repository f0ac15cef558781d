"""Ahead-of-time export: ``torch.export`` artifacts of the serving
programs (counterpart of ``export.py``).

``export_run_dir`` traces the three raw-scan-space serving programs
(``serving.build_raw_programs``: encode, decode, reconstruct) at each
static batch bucket with ``torch.export.export`` and writes each with
``torch.export.save``. The artifacts are self-contained: the network's
weights (as parameters), the spiral and pool tables, the kernels' vertex
tiles, the normalization and the mm scale (as lifted constants) are
inside them, so the directory runs with no checkpoint, geometry,
template or model code.

Layout of an export directory::

    manifest.json                 # shapes, buckets, versions, provenance,
                                  #   each program's export seconds
    encode_b<K>.pt2               # one ExportedProgram per program
    decode_b<K>.pt2               #   and bucket size K
    reconstruct_b<K>.pt2

The programs call the port's kernels as the custom ops of
``ops/library.py`` (``cfsdvae::spiral_conv_fwd``, ``ell_matmul_fwd``,
``out_gather_sum``): the kernel on the card, the plain twin on the host.
So, where the JAX artifact needs only jax, loading this one needs the
module that registers those ops imported first; the manifest names it
(``ops_module``) and ``ExportedModel`` imports it. ``platforms`` lists
the devices the ops have implementations for; an artifact traced on one
of them is moved to another when loaded there
(``torch.export.passes.move_to_device_pass``).

``load_exported`` restores the directory as an ``ExportedModel`` with the
live ``DiagnosisService``'s request semantics (numpy in, numpy out; a
batch padded to its bucket with its first row, then trimmed; batches
above the largest bucket in chunks).
"""

from __future__ import annotations

import importlib
import json
import os
import time

import numpy as np
import torch

from .device import resolve_device

__all__ = ["FORMAT", "OPS_MODULE", "export_run_dir", "export_manager",
           "ExportedModel", "load_exported"]

FORMAT = "craniofacialsd-vae-tpu/torch.export"
#: the module whose import registers the custom ops the programs call
OPS_MODULE = "craniofacialsd_vae_tpu_torch.ops.library"
_PROGRAMS = ("encode", "decode", "reconstruct")
_MANIFEST = "manifest.json"
_DEVICE_TYPES = ("cpu", "cuda")


def export_run_dir(run_dir: str, out_dir: str,
                   buckets: tuple = (1, 4, 16),
                   platforms: tuple = _DEVICE_TYPES, device=None) -> dict:
    """Export a trained run directory's serving programs to ``out_dir``.

    Loads the run as serving does (config snapshot, last checkpoint, the
    precomputed dir's normalization; the training dataset and the
    classifier zoo are not needed), on ``device`` (None: the card), and
    writes the artifact directory. The run dir may come from either
    package. Returns the manifest."""
    from .manager import ModelManager
    from .serving import run_normalization
    from .utils import get_config

    config_path = os.path.join(run_dir, "config.yaml")
    if not os.path.exists(config_path):
        raise FileNotFoundError(f"no config snapshot at {config_path}")
    config = get_config(config_path)
    # the checkpoint alone carries the net: without the classifier
    # section no MLP head is sized, which would scan the training dataset
    config.pop("classifier", None)
    precomp = config["data"]["precomputed_path"]
    manager = ModelManager(config, precomputed_storage_path=precomp,
                           device=device)
    manager.resume(os.path.join(run_dir, "checkpoints"))
    manager.model.eval()
    return export_manager(manager, run_normalization(config), out_dir,
                          buckets=buckets, platforms=platforms,
                          source=str(run_dir))


class _Program(torch.nn.Module):
    """One serving program as a module: the model's weights are its
    parameters, and what the program closes over (tables, normalization)
    becomes the export's lifted constants."""

    def __init__(self, model: torch.nn.Module, fn):
        super().__init__()
        self.model = model
        self.fn = fn

    def forward(self, x):
        return self.fn(x)


def _out_shapes(ep) -> list:
    out = next(n for n in ep.graph.nodes if n.op == "output")
    return [list(v.meta["val"].shape) for v in out.args[0]]


def export_manager(manager, normalization: dict | None, out_dir: str,
                   buckets: tuple = (1, 4, 16),
                   platforms: tuple = _DEVICE_TYPES,
                   source: str = "<manager>") -> dict:
    """Export a live manager's serving programs (see the module note), on
    the manager's device."""
    from .serving import build_raw_programs

    buckets = sorted(set(int(b) for b in buckets))
    if not buckets or buckets[0] < 1:
        raise ValueError(f"buckets must be positive ints, got {buckets}")
    platforms = list(platforms)
    unknown = set(platforms) - set(_DEVICE_TYPES)
    if not platforms or unknown:
        raise ValueError(f"platforms must be among {_DEVICE_TYPES}; got "
                         f"{platforms}")
    model = manager.model
    programs = build_raw_programs(model, normalization, manager.to_mm_const)
    n = int(model.geom.num_vertices)
    nz = int(manager.model_latent_size)
    dev = model.geom.device

    os.makedirs(out_dir, exist_ok=True)
    entries = {}
    with torch.no_grad():
        for name in _PROGRAMS:
            module = _Program(model, programs[name]).eval()
            in_shape = (n, 3) if name != "decode" else (nz,)
            for b in buckets:
                x = torch.zeros((b,) + in_shape, dtype=torch.float32,
                                device=dev)
                t0 = time.perf_counter()
                ep = torch.export.export(module, (x,))
                fname = f"{name}_b{b}.pt2"
                torch.export.save(ep, os.path.join(out_dir, fname))
                entries[f"{name}_b{b}"] = {
                    "file": fname, "batch": b, "in_shape": list(x.shape),
                    "out_shapes": _out_shapes(ep),
                    "export_s": time.perf_counter() - t0}

    manifest = {
        "format": FORMAT, "n_vertices": n, "latent_size": nz,
        "to_mm_constant": float(manager.to_mm_const),
        "buckets": buckets, "platforms": platforms, "programs": entries,
        "torch_version": torch.__version__,
        "policy": model.config.compute_dtype, "ops_module": OPS_MODULE,
        "source": source,
    }
    with open(os.path.join(out_dir, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


class ExportedModel:
    """Run an export directory on ``device`` (None: the card): numpy in,
    numpy out, with the serving layer's pad-to-bucket and trim. Needs
    torch and the module that registers the port's custom ops (the
    manifest's ``ops_module``), and no model code, weights or
    geometry."""

    def __init__(self, artifact_dir: str, device=None):
        manifest_path = os.path.join(artifact_dir, _MANIFEST)
        if not os.path.exists(manifest_path):
            raise FileNotFoundError(
                f"{artifact_dir} is not an export directory "
                f"(missing {_MANIFEST})")
        with open(manifest_path) as f:
            self.manifest = json.load(f)
        self.device = resolve_device(device)
        if self.device.type not in self.manifest["platforms"]:
            raise ValueError(
                f"the artifact runs on {self.manifest['platforms']}, not "
                f"{self.device.type}")
        importlib.import_module(self.manifest["ops_module"])
        from torch.export.passes import move_to_device_pass

        self.n_vertices = int(self.manifest["n_vertices"])
        self.latent_size = int(self.manifest["latent_size"])
        self.buckets = [int(b) for b in self.manifest["buckets"]]
        self._calls = {}
        for key, entry in self.manifest["programs"].items():
            ep = torch.export.load(os.path.join(artifact_dir, entry["file"]))
            traced_on = {t.device for t in (*ep.state_dict.values(),
                                            *ep.constants.values())
                         if isinstance(t, torch.Tensor)}
            if traced_on != {self.device}:
                ep = move_to_device_pass(ep, self.device)
            self._calls[key] = ep.module()

    # ------------------------------------------------------------------
    def _run_bucketed(self, name: str, x: np.ndarray):
        b = x.shape[0]
        if b < 1:
            raise ValueError("empty batch (B=0)")
        max_b = self.buckets[-1]
        outs = []
        with torch.inference_mode():
            for lo in range(0, b, max_b):
                chunk = x[lo:lo + max_b]
                n = chunk.shape[0]
                size = next((s for s in self.buckets if n <= s), max_b)
                if size != n:
                    pad = np.broadcast_to(chunk[:1],
                                          (size - n,) + chunk.shape[1:])
                    chunk = np.concatenate([chunk, pad], axis=0)
                res = self._calls[f"{name}_b{size}"](
                    torch.as_tensor(chunk, device=self.device))
                res = res if isinstance(res, (tuple, list)) else (res,)
                outs.append(tuple(r[:n].cpu().numpy() for r in res))
        merged = tuple(np.concatenate(parts, axis=0)
                       for parts in zip(*outs))
        return merged if len(merged) > 1 else merged[0]

    def _check(self, x, shape, what):
        x = np.asarray(x, np.float32)
        single = x.ndim == len(shape)
        x = x[None] if single else x
        if x.shape[1:] != shape:
            raise ValueError(f"{what} must be {list(shape)} or "
                             f"[B, {', '.join(map(str, shape))}]; "
                             f"got {list(x.shape)}")
        return x, single

    def encode(self, vertices) -> np.ndarray:
        """Raw scan-space [B, N, 3] (or [N, 3]) → latents [B, Z]."""
        x, single = self._check(vertices, (self.n_vertices, 3), "vertices")
        mu = self._run_bucketed("encode", x)
        return mu[0] if single else mu

    def decode(self, z) -> np.ndarray:
        """Latents [B, Z] (or [Z]) → raw scan-space vertices."""
        z, single = self._check(z, (self.latent_size,), "latent")
        out = self._run_bucketed("decode", z)
        return out[0] if single else out

    def reconstruct(self, vertices) -> dict:
        """Raw vertices → {recon, error_mm, mu} (one program call a
        bucket)."""
        x, single = self._check(vertices, (self.n_vertices, 3), "vertices")
        recon, err, mu = self._run_bucketed("reconstruct", x)
        if single:
            recon, err, mu = recon[0], err[0], mu[0]
        return {"recon": recon, "error_mm": err, "mu": mu}


def load_exported(artifact_dir: str, device=None) -> ExportedModel:
    return ExportedModel(artifact_dir, device)

"""Config system and small host-side helpers (counterpart of
``utils/__init__.py``).

The card's machine has no ``pyyaml``, so configs are read with the port's
own reader of the YAML subset the configs use (``yaml_subset.py``), which
resolves scalars as ``yaml.safe_load`` does: a bare ``1e-4`` stays a
string, and the code calls ``float(...)`` on such values as the JAX
package does.
"""

from __future__ import annotations

import os
import shutil

import numpy as np

from .yaml_subset import safe_load

__all__ = ["get_config", "save_config_snapshot", "prepare_sub_folder",
           "class_conversions_and_weights", "DEFAULT_CONFIG",
           "validate_config", "safe_load"]

# Keys the pipeline consumes, with defaults; unknown keys pass through.
DEFAULT_CONFIG = {
    "data": {
        "template_path": None,              # required
        "dataset_path": None,               # required for training
        "precomputed_path": "precomputed",
        "dataset_summary_path": None,
        "data_type": "heads",
        "stratified_split": False,
        "augmentation_mode": "interpolate",
        "augmentation_factor": 0,
        "augmentation_balanced": True,
        "normalize_data": True,
        "to_mm_constant": 1.0,
        "number_of_workers": 0,             # accepted for config parity
        "swap_features": True,
    },
    "optimization": {
        "epochs": 40,
        "batch_size": 4,
        "lr": 1e-4,
        "weight_decay": 0.0,
        "laplacian_weight": 0.0,
        "kl_weight": 0.0,
        "latent_consistency_weight": 0.0,
        "latent_consistency_eta1": 0.5,
        "latent_consistency_eta2": 0.5,
    },
    "model": {
        "sampling": {"type": "basic", "sampling_factors": [4, 4, 4, 4]},
        "spirals": {"length": [9, 9, 9, 9], "dilation": [1, 1, 1, 1]},
        "in_channels": 3,
        "out_channels": [32, 32, 32, 64],
        "latent_size": 75,
        "pre_z_sigmoid": False,
        "compute_dtype": "float32",
    },
    "logging_frequency": {
        "tb_renderings": 50,
        "save_weights": 100,
    },
}


def _merge(defaults: dict, user: dict, path: str = "") -> dict:
    out = {}
    for k, v in defaults.items():
        if k in user and isinstance(v, dict) and isinstance(user[k], dict):
            out[k] = _merge(v, user[k], f"{path}{k}.")
        elif k in user:
            out[k] = user[k]
        else:
            out[k] = v
    for k in user:
        if k not in defaults:
            out[k] = user[k]          # pass through (e.g. 'classifier')
    return out


def get_config(path: str) -> dict:
    """Load a YAML experiment config and fill in the defaults."""
    with open(path) as f:
        user = safe_load(f.read())
    cfg = _merge(DEFAULT_CONFIG, user or {})
    validate_config(cfg)
    return cfg


def validate_config(cfg: dict) -> None:
    model = cfg["model"]
    n_levels = len(model["sampling"]["sampling_factors"])
    if len(model["out_channels"]) != n_levels:
        raise ValueError(
            f"model.out_channels ({len(model['out_channels'])}) must match "
            f"sampling levels ({n_levels})")
    if len(model["spirals"]["length"]) != n_levels:
        raise ValueError("model.spirals.length must match sampling levels")
    if model.get("compute_dtype", "float32") not in (
            "float32", "mixed", "bfloat16"):
        raise ValueError("model.compute_dtype must be one of "
                         "'float32', 'mixed', 'bfloat16'")
    opt = cfg["optimization"]
    if float(opt.get("latent_consistency_weight", 0)) > 0 \
            and not cfg["data"].get("swap_features", False):
        raise ValueError("latent_consistency_weight > 0 requires "
                         "data.swap_features: true")


def save_config_snapshot(config_path: str, output_dir: str) -> None:
    """Copy the config into the run dir."""
    os.makedirs(output_dir, exist_ok=True)
    shutil.copy(config_path, os.path.join(output_dir, "config.yaml"))


def prepare_sub_folder(output_dir: str) -> str:
    checkpoint_dir = os.path.join(output_dir, "checkpoints")
    os.makedirs(checkpoint_dir, exist_ok=True)
    return checkpoint_dir


def class_conversions_and_weights(class_weight_dict: dict):
    """(class2idx, normalized weight vector); 'b' is put last."""
    keys = list(class_weight_dict.keys())
    if "b" in keys:
        keys = [k for k in keys if k != "b"] + ["b"]
    class2idx = {k: i for i, k in enumerate(keys)}
    weights = np.asarray([class_weight_dict[k] for k in keys], np.float32)
    weights = weights / weights.sum()
    return class2idx, weights

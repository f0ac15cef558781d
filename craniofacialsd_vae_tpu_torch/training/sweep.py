"""Hyperparameter sweeps: K optimization variants of one config trained a
step at a time in one dispatch (counterpart of ``training/sweep.py``).

Every variant starts from the same init and reads the same batches and
the same draws (one seed, one draws stream), so variants differ by their
hyperparameters alone. JAX maps one program over the variants with the
loss weights, the learning rate and the decay as traced scalars. The
port gives each variant its own body in the step's CUDA graph
(``ensemble.member_steps``), so each keeps the Python floats of a solo
run: its own ``LossWeights`` and its own ``coupled_adam(lr, weight
decay)``, whose decay torch adds as a number, as the solo run does.
Variant i is then bit-equal to a solo scanned run with its
hyperparameters, and ``variant_state`` needs no change of optimizer
layout: each variant's Adam has the form its own config builds.

The bodies compute every term the base structure admits, also a
0.0-weighted one, as JAX's traced weights do: the term adds exactly zero
loss and gradient, so the updates are the solo run's, and its metric
reads its unweighted value where the solo run reads 0.0 (JAX's
readout).

Variant axes are the optimization-section scalars only
(``SWEEPABLE_KEYS``); keys that change the program's structure are
refused, as JAX refuses them. ``sweep.py`` drives this end to end.
"""

from __future__ import annotations

import copy

import torch

from ..models.sdvae import SDVAEConfig, SpiralGeometry, init_sdvae
from .ensemble import (EnsembleState, MemberState,
                       make_ensemble_scanned_epochs, n_members,
                       member_state)
from .trainer import LossWeights, coupled_adam

__all__ = ["SWEEPABLE_KEYS", "build_variants", "stack_hyperparams",
           "init_sweep_state", "make_sweep_scanned_epochs",
           "variant_state", "n_variants"]

#: optimization-section keys a sweep may vary (everything else either
#: changes the program's structure or lives outside the step)
SWEEPABLE_KEYS = ("lr", "weight_decay", "kl_weight", "laplacian_weight",
                  "latent_consistency_weight", "latent_consistency_eta1",
                  "latent_consistency_eta2")


def build_variants(base_config: dict, overrides: list[dict]) -> list[dict]:
    """Full per-variant config dicts: ``base_config`` deep-copied with
    each override applied to the optimization section. Validates that
    only SWEEPABLE_KEYS are touched and that the variants stay
    structurally compatible with the base (is_vae, swap_features)."""
    if not overrides:
        raise ValueError("a sweep needs at least one variant")
    base_kl = float(base_config["optimization"].get("kl_weight", 0.0))
    swap = bool(base_config["data"].get("swap_features", False))
    variants = []
    for i, ov in enumerate(overrides):
        bad = sorted(set(ov) - set(SWEEPABLE_KEYS))
        if bad:
            raise ValueError(
                f"variant {i} sweeps non-sweepable key(s) {bad}; a sweep "
                f"may vary only {list(SWEEPABLE_KEYS)} — other keys change "
                "the compiled program's structure (run them as separate "
                "train.py runs)")
        cfg = copy.deepcopy(base_config)
        cfg["optimization"].update({k: float(v) for k, v in ov.items()})
        kl = float(cfg["optimization"].get("kl_weight", 0.0))
        if base_kl == 0.0 and kl > 0.0:
            raise ValueError(
                f"variant {i} sets kl_weight {kl} > 0 but the base config "
                "is an AE (kl_weight 0): the VAE logvar head does not "
                "exist in the shared program. Sweep kl_weight from a "
                "VAE base config instead")
        if base_kl > 0.0 and kl == 0.0:
            raise ValueError(
                f"variant {i} sets kl_weight 0 under a VAE base config: "
                "the variant would train as a VAE (logvar head + "
                "sampling) but its config snapshot would rebuild an AE, "
                "breaking checkpoint resume — and no solo train.py "
                "equivalent exists. Sweep kl_weight among values > 0, or "
                "run the AE as its own train.py run")
        lc = float(cfg["optimization"].get("latent_consistency_weight", 0.0))
        if lc > 0 and not swap:
            raise ValueError(
                f"variant {i}: latent_consistency_weight > 0 requires "
                "data.swap_features: true in the base config")
        variants.append(cfg)
    return variants


def stack_hyperparams(variant_configs: list[dict]) -> dict:
    """Each variant's hyperparameters as Python floats: ``{"lr": [K],
    "weight_decay": [K], "weights": [K] LossWeights}``."""
    def col(key, default=0.0):
        return [float(c["optimization"].get(key, default))
                for c in variant_configs]

    return {"lr": col("lr", 1e-4), "weight_decay": col("weight_decay"),
            "weights": [LossWeights.from_config(c["optimization"],
                                                c.get("classifier"))
                        for c in variant_configs]}


def init_sweep_state(config: SDVAEConfig, geom: SpiralGeometry,
                     n_variants: int, seed: int = 0, *,
                     hyperparams: dict) -> EnsembleState:
    """K copies of one init (``ModelManager``'s: a generator seeded
    ``seed``), each with its own ``coupled_adam`` at its learning rate and
    weight decay (``stack_hyperparams``' lists)."""
    if int(n_variants) < 1:
        raise ValueError(f"n_variants must be >= 1; got {n_variants}")
    lrs, wds = hyperparams["lr"], hyperparams["weight_decay"]
    if len(lrs) != int(n_variants) or len(wds) != int(n_variants):
        raise ValueError(f"{n_variants} variants, hyperparameters for "
                         f"{len(lrs)}")
    members = []
    for lr, wd in zip(lrs, wds):
        model = init_sdvae(config, geom,
                           torch.Generator().manual_seed(int(seed)))
        members.append(MemberState(model,
                                   coupled_adam(model.parameters(), lr, wd)))
    return EnsembleState(members)


def make_sweep_scanned_epochs(state: EnsembleState, hyperparams: dict,
                              batch_size: int, swap: bool = True, *,
                              draws):
    """K variants × (E epochs of train steps, each followed by its
    validation steps), with the multi-epoch call of
    ``ensemble.make_ensemble_scanned_epochs``: variant i with its own
    loss weights (every admissible term computed), all reading one
    ``draws(step_id, rows)``."""
    return make_ensemble_scanned_epochs(
        state, list(hyperparams["weights"]), batch_size, swap, draws=draws,
        all_terms=True)


def n_variants(state: EnsembleState) -> int:
    return n_members(state)


def variant_state(state: EnsembleState, i: int) -> MemberState:
    """Variant i's state; its Adam already has its own config's form (the
    checkpoint writes ``chain(add_decayed_weights, adam)`` for a weight
    decay > 0, plain ``adam`` otherwise)."""
    k = n_variants(state)
    if not 0 <= int(i) < k:
        raise IndexError(f"variant {i} out of range for a {k}-variant "
                         "state")
    return member_state(state, i)

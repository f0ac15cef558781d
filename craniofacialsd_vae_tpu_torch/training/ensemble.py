"""Deep ensembles: K independent SD-VAEs trained a step at a time in one
dispatch (counterpart of ``training/ensemble.py``).

JAX maps its scanned epoch over a member axis with ``jax.vmap``. The
port's autograd Functions have no ``vmap`` rule, so its one dispatch is
one CUDA graph a step kind (train, validation) whose body runs the K
members' steps one after another, each on its own model, Adam and head
(``trainer._Steps.of_models``, run by the scanned trainer's own
loop): a replay steps every member. Each
member's body is the one its solo run replays, so member i is bit-equal
to ``ModelManager(config, seed=base_seed + i)``'s scanned run over the
same epoch plans: the same init (a generator seeded ``base_seed + i``,
the model first, then the head), the same draws (``step_draws`` with
that seed) and the same updates. On the host the same bodies run
eagerly.

A state sharded over a member mesh (``parallel.shard_member_axis``)
holds blocks of members, each on its own device; each block then runs
in that device's own graph, and nothing passes between blocks.

``train_ensemble.py`` drives this end to end: one config → K standard
run dirs, each resumable and servable by either package.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from ..models.sdvae import SDVAE, SDVAEConfig, SpiralGeometry, init_sdvae
from .trainer import _epoch_over, _epochs_over, _Steps, step_draws

__all__ = ["MemberState", "EnsembleState", "init_ensemble_state",
           "ensemble_epoch_keys", "make_ensemble_scanned_step",
           "make_ensemble_scanned_epochs", "member_state", "n_members"]


@dataclass
class MemberState:
    """One member's (or one variant's) training state: its model, Adam and
    head (None where it trains none), as ``ModelManager.use_member`` takes
    it."""
    model: SDVAE
    optimizer: torch.optim.Optimizer
    head: torch.nn.Module | None = None
    head_optimizer: torch.optim.Optimizer | None = None


@dataclass
class EnsembleState:
    """K members' states. ``blocks``, once sharded over a member mesh, is
    ``[(device, member indices)]``; None: one block, on the members'
    device."""
    members: list
    blocks: list | None = None


def init_ensemble_state(config: SDVAEConfig, geom: SpiralGeometry,
                        n_members: int, base_seed: int = 0, *, optimizer,
                        head_init=None, head_optimizer=None
                        ) -> EnsembleState:
    """K members on ``geom``'s device. Member i's weights come from a
    generator seeded ``base_seed + i``: the model's first, then the head's
    (``head_init(generator) → module``, where given), as
    ``ModelManager(config, seed=base_seed + i)`` draws them.
    ``optimizer(params)`` and ``head_optimizer(params)`` make each
    member's optimizers (``coupled_adam``)."""
    if int(n_members) < 1:
        raise ValueError(f"n_members must be >= 1; got {n_members}")
    members = []
    for i in range(int(n_members)):
        gen = torch.Generator().manual_seed(int(base_seed) + i)
        model = init_sdvae(config, geom, gen)
        head = None if head_init is None else head_init(gen).to(geom.device)
        members.append(MemberState(
            model, optimizer(model.parameters()), head,
            None if head is None or head_optimizer is None
            else head_optimizer(head.parameters())))
    return EnsembleState(members)


def ensemble_epoch_keys(n_members: int, base_seed: int, n_regions: int,
                        latent: int) -> list:
    """Each member's ``draws(step_id, rows) → (region, eps)``: member i
    draws what ``ModelManager(config, seed=base_seed + i)`` draws
    (``step_draws`` with that seed)."""
    return [functools.partial(_draws, int(base_seed) + i, n_regions, latent)
            for i in range(int(n_members))]


def _draws(seed, n_regions, latent, step_id, rows):
    return step_draws(seed, step_id, rows, n_regions, latent)


def n_members(state: EnsembleState) -> int:
    return len(state.members)


def member_state(state: EnsembleState, i: int) -> MemberState:
    """Member i's state, usable wherever a single model's is
    (``ModelManager.use_member``: checkpoints, the zoo, serving)."""
    k = n_members(state)
    if not 0 <= int(i) < k:
        raise IndexError(f"member {i} out of range for a {k}-member state")
    return state.members[int(i)]


def member_steps(state: EnsembleState, weights: list, batch_size: int,
                 swap: bool, draws, all_terms: bool = False) -> list:
    """``[(member indices, _Steps)]``, a replayer pair per block: member
    i's steps with ``weights[i]``; ``draws`` one per member, or one that
    every member reads."""
    blocks = state.blocks or [(state.members[0].model.geom.device,
                               list(range(n_members(state))))]
    out = []
    for _, ids in blocks:
        ms = [state.members[i] for i in ids]
        out.append((ids, _Steps.of_models(
            [m.model for m in ms], [weights[i] for i in ids],
            [m.optimizer for m in ms], batch_size, swap,
            [m.head for m in ms], [m.head_optimizer for m in ms],
            [draws] if callable(draws) else [draws[i] for i in ids],
            all_terms=all_terms)))
    return out


def _per_member(weights, k: int) -> list:
    return list(weights) if isinstance(weights, (list, tuple)) \
        else [weights] * k


def make_ensemble_scanned_step(state: EnsembleState, weights,
                               batch_size: int, swap: bool = True, *,
                               draws):
    """K members × one epoch of train steps: ``epoch(data_x [n, N, 3],
    idx [S, B], step_ids [S], labels [S, B] | None, class_weights) → [K]
    dicts of floats`` (each member's metrics averaged over the S steps),
    the trainer's ``_epoch_over`` on the members' blocks. ``draws`` is
    ``ensemble_epoch_keys``'; ``weights`` one ``LossWeights`` (or one a
    member). ``epoch.steps`` holds each block's replayers."""
    return _epoch_over(member_steps(
        state, _per_member(weights, n_members(state)), batch_size, swap,
        draws))


def make_ensemble_scanned_epochs(state: EnsembleState, weights,
                                 batch_size: int, swap: bool = True, *,
                                 draws, all_terms: bool = False):
    """K members × (E epochs of train steps, each followed by its
    validation steps): ``epochs_fn(train_x, val_x, tr_idx [E, St, B],
    tr_sid [E, St], va_idx [E, Sv, B], va_sid [E, Sv], tr_labels | None,
    va_labels | None, class_weights) → (train metrics, validation
    metrics)``, each ``[K][E]`` dicts of floats: the JAX
    ``make_ensemble_scanned_epochs`` less the state and the keys, which
    ``state`` and ``draws`` hold, run by the trainer's ``_epochs_over``
    on the members' blocks. ``epochs_fn.steps`` holds each block's
    replayers."""
    return _epochs_over(member_steps(
        state, _per_member(weights, n_members(state)), batch_size, swap,
        draws, all_terms))

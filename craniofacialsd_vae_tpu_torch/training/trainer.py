"""The training step (counterpart of ``training/trainer.py``).

One step: the on-device B→B² feature swap, forward, the losses, backward
through the precomputed transposes (K4 and its capped form, K2-dW; see
``ops/spiral_conv.py``) and the Adam update with coupled L2, as the JAX
``_build_raw_step`` and ``_compute_losses`` do. ``make_train_step`` runs
it eagerly, one launch after another, and ``run_steps`` is its per-step
loop.

``make_scanned_train_step`` and ``make_scanned_train_epochs`` are the
JAX package's scanned epoch and nested multi-epoch scan: on the card
each replays one captured CUDA graph of the train step (and one of the
validation step) per step (``graphs.py``), with the step's batch
indices, region, noise and labels copied into static tensors before each
replay and the metrics summed on the device, read once a call. On the
host the same step runs eagerly over the same static tensors. The
step's draws come from a ``draws(step_id, rows) → (region, eps)``
function, called on the host for a whole call's steps ahead and
uploaded once. ``assemble_epoch_plans`` builds their arguments from the
iterators, with the JAX package's step-id schedule. A replayer runs K
models' steps a step (``_Steps.of_models``), one graph for all K on the
card, each model's step exactly the one it replays alone: the scanned
forms are the K = 1 case of one loop (``_epoch_over``, ``_epochs_over``)
that also runs an ensemble's members or a sweep's variants
(``training/ensemble.py``).

With an MLP head (``models/mlp.py``) and a classification weight, the
step adds the class-weighted cross entropy of the head's logits on the
swap grid's diagonal (the unswapped scans, rows ``(B+1)·i``) and updates
the head with its own coupled Adam, as ``_compute_losses`` and
``_build_raw_step`` do.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..data.swap import choose_region, swap_features_dynamic
from ..graphs import StateGuard, capture
from ..models.sdvae import SDVAE
from .losses import (kl_divergence_loss, laplacian_loss,
                     latent_consistency_loss, mse_loss, region_feature_mask,
                     weighted_cross_entropy)

__all__ = ["LOSS_KEYS", "LossWeights", "coupled_adam", "compute_losses",
           "make_train_step", "make_eval_step", "run_steps", "step_draws",
           "assemble_epoch_plans", "make_scanned_train_step",
           "make_scanned_train_epochs"]

LOSS_KEYS = ["reconstruction", "kl", "latent_consistency", "laplacian",
             "classification", "classification_acc", "tot"]

#: steps run on a side stream before a step's graph is captured: the
#: first makes the gradients and the optimizer state, the second runs the
#: step in the form the graph records (gradients zeroed in place)
WARMUP_STEPS = 2


def step_draws(seed: int, step_id: int, rows: int, n_regions: int,
               latent: int, rank: int = 0) -> tuple:
    """Step ``step_id``'s swapped region (an int) and noise ``eps [rows,
    latent]`` (on the host) for a run seeded ``seed``: drawn from a
    generator seeded by (seed + 1, step id), and under data parallelism
    the rank (rank 0 draws what a single-device run draws). The same
    step draws the same on every device and after a resume."""
    entropy = [seed + 1, step_id]
    if rank:
        entropy.append(rank)
    seq = np.random.SeedSequence(entropy)
    g = torch.Generator().manual_seed(int(seq.generate_state(1)[0]))
    region = int(torch.randint(0, n_regions, (), generator=g))
    eps = torch.randn((rows, latent), generator=g)
    return region, eps


def assemble_epoch_plans(train_iter, val_iter, n_epochs: int,
                         step_counter: int = 0, with_labels: bool = False):
    """The multi-epoch call's arguments, assembled on the host as the JAX
    package's ``assemble_epoch_plans`` does: ``(args, next_step_counter)``
    with ``args = (tr_x, va_x, tr_idx [E, St, B], tr_sid [E, St], va_idx
    [E, Sv, B], va_sid [E, Sv], tr_labels | None, va_labels | None)``
    (index and id arrays int32 numpy). Validation step ids follow each
    epoch's train ids, offset by the running counter. Labels come only
    with ``with_labels`` and when both iterators' plans carry them."""
    tr_plans = [train_iter.epoch_plan() for _ in range(n_epochs)]
    va_plans = [val_iter.epoch_plan() for _ in range(n_epochs)]
    tr_x, va_x = tr_plans[0][0], va_plans[0][0]
    tr_idx = np.stack([p[1] for p in tr_plans])
    va_idx = np.stack([p[1] for p in va_plans])
    use_labels = bool(with_labels and tr_plans[0][2] is not None
                      and va_plans[0][2] is not None)
    tr_lab = np.stack([p[2] for p in tr_plans]) if use_labels else None
    va_lab = np.stack([p[2] for p in va_plans]) if use_labels else None
    st, sv = tr_idx.shape[1], va_idx.shape[1]
    per = st + sv
    e_ar = np.arange(n_epochs)[:, None]
    tr_sid = step_counter + 1 + e_ar * per + np.arange(st)[None]
    va_sid = step_counter + 1 + e_ar * per + st + np.arange(sv)[None]
    args = (tr_x, va_x, tr_idx, tr_sid.astype(np.int32), va_idx,
            va_sid.astype(np.int32), tr_lab, va_lab)
    return args, step_counter + n_epochs * per


@dataclass(frozen=True)
class LossWeights:
    """Loss weighting. A term whose weight is 0 is left out of the step
    (its metric reads 0), as the JAX package does for Python floats."""
    kl: float = 1e-4
    laplacian: float = 0.1
    latent_consistency: float = 0.5
    eta1: float = 0.5
    eta2: float = 0.5
    classification: float = 0.0

    @classmethod
    def from_config(cls, opt_cfg: dict, clf_cfg: dict | None = None):
        w_class = 0.0
        if clf_cfg and clf_cfg.get("mlp_training_type") == "end2end":
            w_class = float(clf_cfg.get("mlp_loss_weight", 1.0))
        return cls(
            kl=float(opt_cfg.get("kl_weight", 0.0)),
            laplacian=float(opt_cfg.get("laplacian_weight", 0.0)),
            latent_consistency=float(
                opt_cfg.get("latent_consistency_weight", 0.0)),
            eta1=float(opt_cfg.get("latent_consistency_eta1", 0.5)),
            eta2=float(opt_cfg.get("latent_consistency_eta2", 0.5)),
            classification=w_class,
        )


def coupled_adam(params, lr: float, weight_decay: float
                 ) -> torch.optim.Adam:
    """Adam with *coupled* L2 (the decay is added to the gradient before
    the moments), as the reference's ``torch.optim.Adam(...,
    weight_decay=·)`` and the JAX ``coupled_adam``; ``AdamW`` would decay
    decoupled and change the objective. On the card it is
    ``capturable`` (its step count and bias correction on the device),
    so that the eager step and a graph's replay do the same arithmetic;
    PyTorch supports that only for CUDA tensors."""
    params = list(params)
    return torch.optim.Adam(params, lr=float(lr),
                            weight_decay=float(weight_decay),
                            capturable=bool(params) and params[0].is_cuda)


def compute_losses(model: SDVAE, weights: LossWeights, x_grid: torch.Tensor,
                   region_idx, batch_size: int, eps=None, generator=None,
                   training: bool = True, swap: bool = True, head=None,
                   labels=None, class_weights=None, all_terms: bool = False):
    """The losses of one vertex-major grid ``[N, B², 3]`` (or ``[N, B, 3]``
    without the swap): ``(total, metrics)`` keyed by ``LOSS_KEYS``. The
    classification term needs ``head``, a positive weight and ``labels
    [B]``. ``all_terms`` computes every term the geometry, the swap and
    the head admit, also where its weight is 0.0, as the JAX package does
    for a sweep's traced weights: the term then adds exactly zero loss
    and gradient, and its metric reads its unweighted value."""
    geom, config = model.geom, model.config
    out, z, mu, logvar = model(x_grid, generator=generator,
                               training=training, eps=eps)
    zero = out.new_zeros(())
    loss_recon = mse_loss(out, x_grid)
    loss_lap = laplacian_loss(geom.laplacian, out) \
        if weights.laplacian > 0 \
        or (all_terms and geom.laplacian is not None) else zero
    loss_kl = kl_divergence_loss(mu, logvar) if config.is_vae else zero
    if swap and (weights.latent_consistency > 0 or all_terms):
        fmask = region_feature_mask(config.latent_size,
                                    geom.region_masks.shape[0], region_idx,
                                    device=z.device)
        loss_cons = latent_consistency_loss(z, fmask, batch_size,
                                            weights.eta1, weights.eta2)
    else:
        loss_cons = zero
    loss_class, acc_class = zero, zero
    if head is not None and (weights.classification > 0 or all_terms) \
            and labels is not None:
        if swap:
            diag = (batch_size + 1) * torch.arange(batch_size,
                                                   device=z.device)
            z_diag = z.index_select(0, diag)
        else:
            z_diag = z
        logits, _ = head(z_diag)
        loss_class, acc_class = weighted_cross_entropy(
            logits, torch.as_tensor(labels, device=z.device),
            torch.as_tensor(class_weights, dtype=z.dtype, device=z.device))
    loss_tot = (loss_recon
                + weights.kl * loss_kl
                + weights.latent_consistency * loss_cons
                + weights.laplacian * loss_lap
                + weights.classification * loss_class)
    metrics = {"reconstruction": loss_recon, "kl": loss_kl,
               "latent_consistency": loss_cons, "laplacian": loss_lap,
               "classification": loss_class,
               "classification_acc": acc_class, "tot": loss_tot}
    return loss_tot, metrics


def _check(model: SDVAE, weights: LossWeights, swap: bool, head) -> None:
    if weights.classification > 0 and head is None:
        raise ValueError("a classification weight > 0 needs the MLP head "
                         "(models/mlp.py) passed as head=")
    geom = model.geom
    if weights.laplacian > 0 and geom.laplacian is None:
        raise ValueError("laplacian weight > 0 needs a geometry built with "
                         "a Laplacian (SpiralGeometry.from_bundle)")
    if swap and geom.region_masks is None:
        raise ValueError("the swap needs a geometry built with region masks")


def _grid(model: SDVAE, x, batch_size: int, swap: bool, region_idx,
          generator):
    """``[B, N, 3]`` scans → the vertex-major grid and the region."""
    geom = model.geom
    x = torch.as_tensor(x, dtype=torch.float32, device=geom.device)
    x_vm = x.transpose(0, 1)                       # [B, N, 3] → [N, B, 3]
    if not swap:
        return x_vm.contiguous(), 0
    if x.shape[0] != batch_size:
        raise ValueError(f"x holds {x.shape[0]} scans; the swap grid was "
                         f"built for batch_size {batch_size}")
    if region_idx is None:
        region_idx = choose_region(generator, geom.region_masks.shape[0],
                                   device=geom.device)
    return swap_features_dynamic(x_vm, geom.region_masks, region_idx), \
        region_idx


def make_train_step(model: SDVAE, weights: LossWeights,
                    optimizer: torch.optim.Optimizer, batch_size: int,
                    swap: bool = True, head=None, head_optimizer=None,
                    reduce=None, all_terms: bool = False):
    """The train step ``step(x [B, N, 3], region_idx=None, eps=None,
    generator=None, labels=None, class_weights=None) → metrics`` (0-d
    tensors on the device, keyed by ``LOSS_KEYS``). The swapped region and
    the reparameterisation noise ``eps [B², Z]`` come from ``generator``
    unless given. With ``head``, a classification weight and
    ``head_optimizer``, the head is updated too, every step (from a zero
    gradient where a batch has no labels, as the JAX step does). The
    gradients are zeroed in place (a CUDA graph of the step keeps them at
    fixed addresses) and stay on the parameters after the step.
    ``reduce(tensors)``, where given, averages the gradients and the
    metrics in place across data-parallel replicas between the backward
    and the updates (the JAX step's ``pmean`` under ``axis_name``;
    ``parallel/train_parallel.py``). ``all_terms`` as ``compute_losses``
    takes it."""
    _check(model, weights, swap, head)
    train_head = (head is not None and head_optimizer is not None
                  and weights.classification > 0)

    def step(x, region_idx=None, eps=None, generator=None, labels=None,
             class_weights=None):
        x_grid, region = _grid(model, x, batch_size, swap, region_idx,
                               generator)
        optimizer.zero_grad(set_to_none=False)
        if train_head:
            head_optimizer.zero_grad(set_to_none=False)
        loss, metrics = compute_losses(model, weights, x_grid, region,
                                       batch_size, eps=eps,
                                       generator=generator, training=True,
                                       swap=swap, head=head, labels=labels,
                                       class_weights=class_weights,
                                       all_terms=all_terms)
        loss.backward()
        if train_head:
            for p in head.parameters():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        metrics = {k: v.detach() for k, v in metrics.items()}
        if reduce is not None:
            grads = [p.grad for p in model.parameters()]
            if train_head:
                grads += [p.grad for p in head.parameters()]
            metrics = _reduced(reduce, grads, metrics)
        optimizer.step()
        if train_head:
            head_optimizer.step()
        return metrics

    return step


def _reduced(reduce, tensors: list, metrics: dict) -> dict:
    """``reduce`` over ``tensors`` and the metrics in one call; the metrics
    come back as the reduced values."""
    vec = torch.stack([metrics[k].float() for k in LOSS_KEYS])
    reduce(tensors + [vec])
    return {k: vec[i].to(metrics[k].dtype) for i, k in enumerate(LOSS_KEYS)}


def make_eval_step(model: SDVAE, weights: LossWeights, batch_size: int,
                   swap: bool = True, head=None, reduce=None,
                   all_terms: bool = False):
    """Validation: the same losses, no update, ``z = mu``:
    ``step(x [B, N, 3], region_idx=None, generator=None, labels=None,
    class_weights=None) → metrics``, averaged across replicas by
    ``reduce`` where given."""
    _check(model, weights, swap, head)

    def step(x, region_idx=None, generator=None, labels=None,
             class_weights=None):
        x_grid, region = _grid(model, x, batch_size, swap, region_idx,
                               generator)
        with torch.no_grad():
            _, metrics = compute_losses(model, weights, x_grid, region,
                                        batch_size, training=False,
                                        swap=swap, head=head, labels=labels,
                                        class_weights=class_weights,
                                        all_terms=all_terms)
        if reduce is not None:
            metrics = _reduced(reduce, [], metrics)
        return metrics

    return step


def run_steps(step, data: torch.Tensor, idx, region_idx=None, eps=None,
              generator=None) -> dict:
    """``S`` steps over the batches ``data[idx[t]]`` (``data [n, N, 3]``,
    ``idx [S, B]``), the metrics averaged over the steps. ``region_idx
    [S]`` and ``eps [S, B², Z]`` are injected per step where given."""
    idx = torch.as_tensor(idx, device=data.device).long()
    sums = None
    for t in range(idx.shape[0]):
        kw = {}
        if region_idx is not None:
            kw["region_idx"] = region_idx[t]
        if eps is not None:
            kw["eps"] = eps[t]
        m = step(data.index_select(0, idx[t]), generator=generator, **kw)
        sums = m if sums is None else {k: sums[k] + m[k] for k in sums}
    return {k: v / idx.shape[0] for k, v in sums.items()}


class _Replayed:
    """K steps replayed as one over a call's steps: static inputs (the
    split, the batch's row indices and labels, which every body reads,
    and for each draws stream its region as a 0-d int64 tensor and its
    ``eps``), a device tensor summing each body's metrics ``[K,
    len(LOSS_KEYS)]``, and on the card one CUDA graph of the K steps,
    captured at the first call. ``bodies[i](x, region, eps, labels,
    class_weights) → metrics`` is body i's eager step, and it reads the
    draws of stream ``streams[i]``. Body i runs exactly the ops it runs
    alone, so each body's updates are those of its own replayer."""

    def __init__(self, bodies, streams, device, batch_size: int, eps_shape,
                 with_labels: bool, guard: StateGuard | None, pool):
        self.bodies = list(bodies)
        self.streams = list(streams)
        self.device = device
        self.guard = guard
        self.pool = pool
        n_streams = max(self.streams) + 1
        self.idx = torch.zeros(batch_size, dtype=torch.long, device=device)
        self.regions = [torch.zeros((), dtype=torch.long, device=device)
                        for _ in range(n_streams)]
        self.eps = None if eps_shape is None else \
            [torch.zeros(eps_shape, dtype=torch.float32, device=device)
             for _ in range(n_streams)]
        self.labels = torch.zeros(batch_size, dtype=torch.long,
                                  device=device) if with_labels else None
        self.class_weights = None
        self.sums = torch.zeros((len(self.bodies), len(LOSS_KEYS)),
                                dtype=torch.float32, device=device)
        self._rows = list(self.sums.unbind(0))
        self.data = None
        self._owned = False
        self.graph = None

    def _bind(self, data, class_weights) -> None:
        """The split and the class weights into the step's inputs. A
        float32 split on the device is read where it lies: the graph reads
        it at its address, so after the capture no other may come. A host
        split is uploaded, at every call, into a tensor of the runner's
        own."""
        on_device = isinstance(data, torch.Tensor) \
            and data.device == self.sums.device \
            and data.dtype == torch.float32
        if self.graph is None:
            self.data = data if on_device else torch.as_tensor(
                data, dtype=torch.float32).to(self.device)
            self._owned = not on_device
        elif data is self.data:
            pass
        elif self._owned and not on_device \
                and tuple(np.shape(data)) == tuple(self.data.shape):
            self.data.copy_(torch.as_tensor(data, dtype=torch.float32))
        else:
            raise ValueError(f"the step's graph reads the split it was "
                             f"captured with ({tuple(self.data.shape)} on "
                             f"{self.device}); got another")
        if self.labels is not None and class_weights is not None:
            cw = torch.as_tensor(class_weights, dtype=torch.float32,
                                 device=self.device)
            if self.class_weights is None:
                self.class_weights = torch.empty_like(cw)
            self.class_weights.copy_(cw)

    def _step(self) -> None:
        x = self.data.index_select(0, self.idx)
        for body, s, row in zip(self.bodies, self.streams, self._rows):
            m = body(x, self.regions[s],
                     None if self.eps is None else self.eps[s], self.labels,
                     self.class_weights)
            row += torch.stack([m[k].float() for k in LOSS_KEYS])

    def _load(self, t: int, idx, region, eps, labels) -> None:
        self.idx.copy_(idx[t])
        for s, r in enumerate(self.regions):
            r.copy_(region[t, s])
        if self.eps is not None:
            for s, e in enumerate(self.eps):
                e.copy_(eps[t, s])
        if self.labels is not None:
            self.labels.copy_(labels[t])

    def run(self, data, idx, region, eps, labels, class_weights
            ) -> torch.Tensor:
        """Steps ``t`` over ``idx [S, B]``, ``region [S, D]``, ``eps [S, D,
        ...]`` (D draws streams) and ``labels [S, B]`` (on the device);
        returns each body's metrics summed over them ``[K,
        len(LOSS_KEYS)]`` (the static tensor: copy it before the next
        call)."""
        self._bind(data, class_weights)
        steps = idx.shape[0]
        if steps and self.device.type == "cuda" and self.graph is None:
            self._load(0, idx, region, eps, labels)
            self.graph = capture(self._step, self.device, WARMUP_STEPS,
                                 self.pool, self.guard)
        self.sums.zero_()
        for t in range(steps):
            self._load(t, idx, region, eps, labels)
            if self.graph is not None:
                self.graph.replay()
            else:
                self._step()
        return self.sums


def _upload(draws: list, rows: int, step_ids, idx, labels, device,
            with_eps: bool) -> tuple:
    """A call's per-step inputs on the device: the batch indices, the
    labels and, for each draws stream, the draws of every step id (made
    on the host ahead; ``region [..., D]``, ``eps [..., D, rows, Z]``),
    each through pinned memory on the card."""
    shape = np.shape(step_ids)
    sids = np.asarray(step_ids).reshape(-1)
    made = [[d(int(s), rows) for d in draws] for s in sids]
    region = torch.tensor([[int(r) for r, _ in m] for m in made],
                          dtype=torch.long).reshape(*shape, len(draws))
    eps = torch.stack([torch.stack([torch.as_tensor(
        e, dtype=torch.float32).cpu() for _, e in m]) for m in made]) \
        if with_eps and made else None
    host = [torch.as_tensor(np.asarray(idx), dtype=torch.long), region,
            None if eps is None else eps.reshape(*shape, *eps.shape[1:]),
            None if labels is None
            else torch.as_tensor(np.asarray(labels), dtype=torch.long)]
    if device.type != "cuda":
        return tuple(host)
    return tuple(None if t is None else
                 t.pin_memory().to(device, non_blocking=True) for t in host)


class _Steps:
    """What the scanned callables share: the train and validation steps'
    replayers by (kind, labels or not), their graph pool on the card, and
    the models' state that a capture's warm-up must leave as it found.

    A replayer runs K bodies a step (K models: an ensemble's members or a
    sweep's variants; one for a single model), in one graph on the card.
    ``bodies`` maps each kind to its K bodies; ``draws`` lists one
    ``draws(step_id, rows) → (region, eps)`` that every body reads, or
    one per body."""

    def __init__(self, device, batch_size: int, rows: int, latent: int,
                 draws: list, bodies: dict, guard: StateGuard,
                 eps_kinds: tuple = ("train",)):
        self.device = device
        self.batch_size = batch_size
        self.rows = rows
        self.latent = latent
        self.bodies = {k: list(b) for k, b in bodies.items()}
        n_bodies = {len(b) for b in self.bodies.values()}
        self.draws = list(draws)
        if len(n_bodies) != 1 or len(self.draws) not in (1, *n_bodies):
            raise ValueError(f"{sorted(n_bodies)} bodies a kind and "
                             f"{len(self.draws)} draws streams do not pair")
        self.streams = [i if len(self.draws) > 1 else 0
                        for i in range(n_bodies.pop())]
        # the kinds in ``eps_kinds`` get their steps' noise
        self.eps_kinds = tuple(eps_kinds)
        self.guard = guard
        self.pool = None
        self.runners: dict = {}

    @classmethod
    def of_models(cls, models, weights, optimizers, batch_size, swap,
                  heads, head_optimizers, draws, reduce=None,
                  all_terms: bool = False) -> "_Steps":
        """The train and eval steps (``make_train_step``'s,
        ``make_eval_step``'s) of K models, each with its own loss weights,
        optimizer and head (lists of K), in one replayer a kind."""
        train, evaluate = [], []
        for m, w, opt, h, h_opt in zip(models, weights, optimizers, heads,
                                       head_optimizers):
            t = make_train_step(m, w, opt, batch_size, swap=swap, head=h,
                                head_optimizer=h_opt, reduce=reduce,
                                all_terms=all_terms)
            e = make_eval_step(m, w, batch_size, swap=swap, head=h,
                               reduce=reduce, all_terms=all_terms)
            train.append(lambda x, r, eps, lab, cw, t=t: t(
                x, region_idx=r, eps=eps, labels=lab, class_weights=cw))
            evaluate.append(lambda x, r, eps, lab, cw, e=e: e(
                x, region_idx=r, labels=lab, class_weights=cw))
        modules = list(models) + [h for h in heads if h is not None]
        opts = list(optimizers) + [o for o in head_optimizers
                                   if o is not None]
        model = models[0]
        return cls(model.geom.device, batch_size,
                   batch_size ** 2 if swap else batch_size,
                   model.config.latent_size, draws,
                   {"train": train, "eval": evaluate},
                   StateGuard(modules, opts))

    def runner(self, kind: str, with_labels: bool) -> _Replayed:
        key = (kind, with_labels)
        if key not in self.runners:
            if self.device.type == "cuda" and self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            train = kind == "train"
            self.runners[key] = _Replayed(
                self.bodies[kind], self.streams, self.device,
                self.batch_size,
                (self.rows, self.latent) if kind in self.eps_kinds
                else None, with_labels, self.guard if train else None,
                self.pool)
        return self.runners[key]

    def upload(self, kind: str, step_ids, idx, labels) -> tuple:
        """The per-step inputs of a call's ``kind`` steps (any leading
        shape), uploaded once."""
        return _upload(self.draws, self.rows, step_ids, idx, labels,
                       self.device, kind in self.eps_kinds)

    def run(self, kind: str, data, inputs: tuple, class_weights
            ) -> torch.Tensor:
        """One run of ``kind`` steps over uploaded ``inputs`` (``upload``'s,
        leading dim S); each body's metrics summed over them (the
        runner's static tensor, ``[K, len(LOSS_KEYS)]``)."""
        idx, region, eps, labels = inputs
        return self.runner(kind, labels is not None).run(
            data, idx, region, eps, labels, class_weights)


def _at(inputs: tuple, e: int) -> tuple:
    return tuple(None if t is None else t[e] for t in inputs)


def _averages(sums: np.ndarray, steps: int) -> dict:
    return {k: float(sums[i]) / steps if steps else 0.0
            for i, k in enumerate(LOSS_KEYS)}


def _epoch_over(blocks: list):
    """An epoch of train steps over ``blocks``, ``[(body indices,
    _Steps)]`` holding K bodies in all (one block for a single model or
    an unsharded ensemble; one a device over a member mesh):
    ``epoch(data_x [n, N, 3], idx [S, B], step_ids [S], labels [S, B] |
    None, class_weights) → [K]`` dicts of floats, each body's metrics
    averaged over the S steps. ``epoch.steps`` lists the blocks'
    ``_Steps``."""
    k = sum(len(ids) for ids, _ in blocks)

    def epoch(data_x, idx, step_ids, labels=None, class_weights=None):
        runs = []
        for ids, steps in blocks:
            inputs = steps.upload("train", step_ids, idx, labels)
            runs.append((ids, steps.run("train", data_x, inputs,
                                        class_weights)))
        out = [None] * k
        for ids, sums in runs:
            sums = sums.cpu().numpy()
            for j, i in enumerate(ids):
                out[i] = _averages(sums[j], int(np.shape(idx)[0]))
        return out

    epoch.steps = [steps for _, steps in blocks]
    return epoch


def _epochs_over(blocks: list):
    """E epochs of train steps, each followed by its validation steps,
    over ``blocks`` as ``_epoch_over`` takes them: ``epochs_fn(train_x,
    val_x, tr_idx [E, St, B], tr_sid [E, St], va_idx [E, Sv, B], va_sid
    [E, Sv], tr_labels [E, St, B] | None, va_labels [E, Sv, B] | None,
    class_weights) → (train metrics, validation metrics)``, each ``[K][E]``
    dicts of floats (the averages of each epoch's steps). Every block's
    steps are queued an epoch at a time, the per-epoch sums gathered on
    the device and read once a call."""
    k = sum(len(ids) for ids, _ in blocks)

    def epochs_fn(train_x, val_x, tr_idx, tr_sid, va_idx, va_sid,
                  tr_labels=None, va_labels=None, class_weights=None):
        n_epochs, st = np.shape(tr_idx)[:2]
        sv = np.shape(va_idx)[1]
        runs = []
        for ids, steps in blocks:
            tr = steps.upload("train", tr_sid, tr_idx, tr_labels)
            va = steps.upload("eval", va_sid, va_idx, va_labels)
            out = torch.zeros((n_epochs, 2, len(ids), len(LOSS_KEYS)),
                              dtype=torch.float32, device=steps.device)
            runs.append((ids, steps, tr, va, out))
        for e in range(n_epochs):
            for _, steps, tr, va, out in runs:
                out[e, 0] = steps.run("train", train_x, _at(tr, e),
                                      class_weights)
                out[e, 1] = steps.run("eval", val_x, _at(va, e),
                                      class_weights)
        train_m, val_m = [None] * k, [None] * k
        for ids, _, _, _, out in runs:
            sums = out.cpu().numpy()
            for j, i in enumerate(ids):
                train_m[i] = [_averages(sums[e, 0, j], st)
                              for e in range(n_epochs)]
                val_m[i] = [_averages(sums[e, 1, j], sv)
                            for e in range(n_epochs)]
        return train_m, val_m

    epochs_fn.steps = [steps for _, steps in blocks]
    return epochs_fn


def _model_steps(model, weights, optimizer, batch_size, swap, head,
                 head_optimizer, draws, reduce) -> _Steps:
    return _Steps.of_models([model], [weights], [optimizer], batch_size,
                            swap, [head], [head_optimizer], [draws], reduce)


def make_scanned_train_step(model: SDVAE, weights: LossWeights,
                            optimizer: torch.optim.Optimizer,
                            batch_size: int, swap: bool = True, head=None,
                            head_optimizer=None, *, draws, reduce=None):
    """A whole epoch of train steps: ``epoch(data_x [n, N, 3], idx [S, B],
    step_ids [S], labels [S, B] | None, class_weights) → metrics averaged
    over the S steps`` (floats keyed by ``LOSS_KEYS``), the JAX
    ``make_scanned_train_step`` less the state, the geometry and the key,
    which the model and ``draws(step_id, rows) → (region, eps [rows, Z])``
    hold. Update for update the eager step's: on the card each step is a
    replay of the step's CUDA graph; the metrics are read once. It is
    ``_epoch_over`` at K = 1. ``epoch.steps.runners`` holds the replayers
    (and their graphs). ``reduce`` as ``make_train_step`` takes it
    (inside the graph)."""
    steps = _model_steps(model, weights, optimizer, batch_size, swap, head,
                         head_optimizer, draws, reduce)
    call = _epoch_over([([0], steps)])

    def epoch(data_x, idx, step_ids, labels=None, class_weights=None):
        return call(data_x, idx, step_ids, labels, class_weights)[0]

    epoch.steps = steps
    return epoch


def make_scanned_train_epochs(model: SDVAE, weights: LossWeights,
                              optimizer: torch.optim.Optimizer,
                              batch_size: int, swap: bool = True, head=None,
                              head_optimizer=None, *, draws, reduce=None):
    """E epochs of train steps, each followed by its validation steps:
    ``epochs_fn(train_x, val_x, tr_idx [E, St, B], tr_sid [E, St], va_idx
    [E, Sv, B], va_sid [E, Sv], tr_labels [E, St, B] | None, va_labels
    [E, Sv, B] | None, class_weights) → (train metrics, validation
    metrics)``, each a list of E dicts of floats (the averages of each
    epoch's steps), the JAX ``make_scanned_train_epochs`` less the state,
    the geometry and the key. The train and validation steps each replay
    their own graph on the card; the per-epoch sums are gathered on the
    device and read once a call. It is ``_epochs_over`` at K = 1.
    ``reduce`` as ``make_train_step`` takes it."""
    steps = _model_steps(model, weights, optimizer, batch_size, swap, head,
                         head_optimizer, draws, reduce)
    call = _epochs_over([([0], steps)])

    def epochs_fn(train_x, val_x, tr_idx, tr_sid, va_idx, va_sid,
                  tr_labels=None, va_labels=None, class_weights=None):
        tr, va = call(train_x, val_x, tr_idx, tr_sid, va_idx, va_sid,
                      tr_labels, va_labels, class_weights)
        return tr[0], va[0]

    epochs_fn.steps = steps
    return epochs_fn

"""ModelManager: config → geometry → model and head → optimizers →
epochs → checkpoints (counterpart of ``manager.py``).

The surface is the JAX manager's (``run_epoch``, ``encode``,
``generate``, ``forward``, ``encode_all``, ``save_weights``, ``resume``,
``log_images``, the class maps, ``latent_regions``), so that
``train.py`` drives it the same way. The geometry is built on the host
and moved to the device once; the model, the head, the data and the
metrics then stay on the device, and an epoch syncs once, when its summed
metrics are read.

Each step draws its swapped region and its reparameterisation noise on
the host from a generator seeded by the manager's seed and the step's
number (``_step_draws``), so the same step draws the same on every
device and after a resume.

After training, the classifier zoo (``analysis/classifiers.py``) is
fitted on the encoded train latents (``train_and_validate_classifiers``),
saved beside the checkpoints as ``classifiers.npz`` and restored by
``resume`` (or read from a reference run's sklearn pickles).

Not ported here: the scanned epochs (``can_scan_epochs`` is False,
ROADMAP 1.5) and data parallelism (1.11).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from .device import resolve_device
from .geometry import load_or_compute_geometry, load_template
from .models import (SDVAEConfig, SpiralGeometry, init_mlp, init_sdvae,
                     latent_regions, mlp_to_jax, params_to_jax)
from .training import (LOSS_KEYS, LossWeights, coupled_adam, make_eval_step,
                       make_train_step)
from .training.checkpoint import (MODEL_RE, adam_from_optax, adam_to_optax,
                                  latest_checkpoint, named_from_tree,
                                  read_checkpoint, save_checkpoint)
from .utils import class_conversions_and_weights

__all__ = ["ModelManager"]


def _load_named(module: torch.nn.Module, named: dict) -> None:
    """Load ``{name: array}`` into ``module``; ``ValueError`` (and nothing
    loaded) unless the names and shapes are the module's own."""
    own = module.state_dict()
    if set(named) != set(own):
        raise ValueError(f"stored names {sorted(named)} are not the "
                         f"module's {sorted(own)}")
    for k, v in named.items():
        if tuple(np.shape(v)) != tuple(own[k].shape):
            raise ValueError(f"{k}: stored shape {np.shape(v)} vs "
                             f"{tuple(own[k].shape)}")
    module.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                            for k, v in named.items()})


class ModelManager:
    def __init__(self, configurations: dict,
                 precomputed_storage_path: str = "precomputed",
                 seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.config = configurations
        self._model_params = configurations["model"]
        self._optimization_params = configurations["optimization"]
        self._data_params = configurations["data"]
        self._classifier_params = configurations.get("classifier")
        self.to_mm_const = float(
            self._data_params.get("to_mm_constant", 1.0))

        # geometry: built (or read from the cache) on the host, moved once
        t0 = time.perf_counter()
        self.template = load_template(self._data_params["template_path"])
        sampling = self._model_params["sampling"]
        spirals = self._model_params["spirals"]
        self.bundle = load_or_compute_geometry(
            precomputed_storage_path, self.template,
            sampling["sampling_factors"], spirals["length"],
            spirals["dilation"],
            region_weighted=sampling.get("type", "basic") != "basic")
        self.geometry_host = SpiralGeometry.from_bundle(self.bundle,
                                                        device="cpu")
        self.geometry = self.geometry_host if self.device.type == "cpu" \
            else self.geometry_host.to(self.device)
        self.geometry_seconds = time.perf_counter() - t0

        # model, head, losses and optimizers
        self.loss_weights = LossWeights.from_config(
            self._optimization_params, self._classifier_params)
        self.net_config = SDVAEConfig.from_dict(
            self._model_params, self.loss_weights.kl)
        self.swap_features = bool(
            self._data_params.get("swap_features", False))
        if self.loss_weights.latent_consistency > 0 \
                and not self.swap_features:
            raise ValueError("latent consistency requires swap_features")
        self.batch_size = int(self._optimization_params["batch_size"])
        self.weight_decay = float(
            self._optimization_params.get("weight_decay", 0.0))
        self._seed = seed
        gen = torch.Generator().manual_seed(seed)
        self.model = init_sdvae(self.net_config, self.geometry, gen)
        self.optimizer = coupled_adam(
            self.model.parameters(),
            float(self._optimization_params["lr"]), self.weight_decay)

        self.head = None
        self.head_optimizer = None
        self._mlp_end2end = False
        if self._classifier_params:
            self._mlp_end2end = \
                self._classifier_params.get("mlp_training_type") == "end2end"
            self.head = init_mlp(
                self._model_params["latent_size"],
                self._classifier_params["mlp_hidden_features"],
                self._count_dataset_classes(), gen).to(self.device)
            self.head_optimizer = coupled_adam(
                self.head.parameters(),
                float(self._classifier_params.get("mlp_lr", 1e-4)),
                self.weight_decay)

        self._train_step = make_train_step(
            self.model, self.loss_weights, self.optimizer, self.batch_size,
            swap=self.swap_features, head=self.head,
            head_optimizer=self.head_optimizer)
        self._eval_step = make_eval_step(
            self.model, self.loss_weights, self.batch_size,
            swap=self.swap_features, head=self.head)

        names = self.template.region_names
        self._latent_regions = latent_regions(
            self._model_params["latent_size"], names) if names else {}
        self._class2idx_dict = None
        self._idx2class_dict = None
        self._class_weights = None
        self._losses = None
        self._step_counter = 0
        self._train_latents = None
        self._train_labels = None
        self.classifiers = None         # the zoo, built when fitted or read

    # ------------------------------------------------------------------
    @property
    def loss_keys(self):
        return list(LOSS_KEYS)

    @property
    def latent_regions(self):
        return self._latent_regions

    @property
    def is_vae(self):
        return self.net_config.is_vae

    @property
    def model_latent_size(self):
        return self._model_params["latent_size"]

    @property
    def batch_diagonal_idx(self):
        bs = self.batch_size
        return [(bs + 1) * i for i in range(bs)]

    @property
    def train_latents_and_labels(self):
        return self._train_latents, self._train_labels

    def _count_dataset_classes(self) -> int:
        """Classes = distinct first letters of the dataset's mesh file
        names (at least 2); ``classifier.n_classes`` overrides the scan."""
        explicit = (self._classifier_params or {}).get("n_classes")
        if explicit:
            return int(explicit)
        path = self._data_params.get("dataset_path")
        try:
            names = [n for n in os.listdir(path)
                     if n.endswith((".obj", ".ply"))]
        except (TypeError, FileNotFoundError, NotADirectoryError) as e:
            raise ValueError(
                f"cannot count dataset classes: dataset_path {path!r} is "
                f"not readable ({e}); fix the path or set "
                f"classifier.n_classes explicitly") from None
        if not names:
            raise ValueError(
                f"cannot count dataset classes: no .obj/.ply meshes in "
                f"{path!r}; fix the path or set classifier.n_classes")
        return max(len({n[0] for n in names}), 2)

    # ------------------------------------------------------------------
    # class maps
    def set_class_conversions_and_weights(self, class_weight_dict: dict):
        self._class2idx_dict, weights = class_conversions_and_weights(
            class_weight_dict)
        self._idx2class_dict = {v: k for k, v in
                                self._class2idx_dict.items()}
        self._class_weights = torch.as_tensor(weights, device=self.device)

    def set_class_conversions(self, class2idx: dict):
        self._class2idx_dict = dict(class2idx)
        self._idx2class_dict = {v: k for k, v in
                                self._class2idx_dict.items()}

    def class2idx(self, data_class):
        if isinstance(data_class, (list, np.ndarray)):
            return [self._class2idx_dict[d] for d in data_class]
        return self._class2idx_dict[data_class]

    def idx2class(self, idx):
        inv = self._idx2class_dict
        if isinstance(idx, (list, np.ndarray)):
            return [inv[int(i)] for i in idx]
        return inv[int(idx)]

    # ------------------------------------------------------------------
    # model calls: batch-major in and out, tensors on the manager's device
    def _batch(self, x) -> torch.Tensor:
        if not torch.is_tensor(x):
            x = np.asarray(x, np.float32)
            if not x.flags.writeable:
                x = x.copy()
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def encode(self, x) -> torch.Tensor:
        """[B, N, 3] or [N, 3] → latents [B, Z] (deterministic: mu)."""
        x = self._batch(x)
        single = x.dim() == 2
        if single:
            x = x[None]
        with torch.no_grad():
            mu, _ = self.model.encode(x.transpose(0, 1))
        return mu[0] if single else mu

    def generate(self, z) -> torch.Tensor:
        """[B, Z] or [Z] → vertices [B, N, 3]."""
        z = self._batch(z)
        single = z.dim() == 1
        if single:
            z = z[None]
        with torch.no_grad():
            out = self.model.decode(z).transpose(0, 1)
        return out[0] if single else out

    def forward(self, x, eps=None, training: bool = False):
        """[B, N, 3] → (reconstruction [B, N, 3], z, mu, logvar); a VAE
        samples z with ``eps [B, Z]`` when ``training``."""
        x = self._batch(x)
        with torch.no_grad():
            out, z, mu, logvar = self.model(x.transpose(0, 1), eps=eps,
                                            training=training)
        return out.transpose(0, 1), z, mu, logvar

    def compute_vertex_errors(self, out_verts, gt_verts):
        """Per-vertex Euclidean error in mm."""
        if torch.is_tensor(out_verts) or torch.is_tensor(gt_verts):
            diff = self._batch(out_verts) - self._batch(gt_verts)
            return torch.linalg.vector_norm(diff, dim=-1) * self.to_mm_const
        err = np.sqrt(np.sum((np.asarray(out_verts)
                              - np.asarray(gt_verts)) ** 2, axis=-1))
        return err * self.to_mm_const

    # ------------------------------------------------------------------
    # epochs
    def _step_draws(self, step_id: int, rows: int):
        """Step ``step_id``'s swapped region (an int) and noise ``eps
        [rows, Z]`` (on the manager's device), drawn on the host from a
        generator seeded by (seed, step id)."""
        seq = np.random.SeedSequence([self._seed + 1, step_id])
        g = torch.Generator().manual_seed(int(seq.generate_state(1)[0]))
        n_regions = self.geometry.region_masks.shape[0] \
            if self.geometry.region_masks is not None else 1
        region = int(torch.randint(0, n_regions, (), generator=g))
        eps = torch.randn((rows, self.net_config.latent_size), generator=g)
        return region, eps.to(self.device)

    def run_epoch(self, batch_iter, train: bool = True) -> dict:
        """One pass over the iterator, the losses averaged over its steps.
        The metrics are summed on the device and read once, at the end."""
        totals, count = None, 0
        for batch in batch_iter:
            x = batch["x"]
            if self.swap_features and x.shape[0] != self.batch_size:
                continue        # the swap grid is built for one batch size
            self._step_counter += 1
            rows = x.shape[0] ** 2 if self.swap_features else x.shape[0]
            region, eps = self._step_draws(self._step_counter, rows)
            labels = None
            if self._mlp_end2end and "labels" in batch:
                labels = torch.as_tensor(np.asarray(batch["labels"]),
                                         dtype=torch.long,
                                         device=self.device)
            x = self._batch(x)
            if train:
                metrics = self._train_step(
                    x, region_idx=region, eps=eps, labels=labels,
                    class_weights=self._class_weights)
            else:
                metrics = self._eval_step(
                    x, region_idx=region, labels=labels,
                    class_weights=self._class_weights)
            totals = metrics if totals is None else \
                {k: totals[k] + metrics[k] for k in totals}
            count += 1
        if totals is None:
            self._losses = {k: 0.0 for k in LOSS_KEYS}
        else:
            sums = torch.stack([totals[k] for k in LOSS_KEYS]).cpu()
            self._losses = {k: float(sums[i]) / count
                            for i, k in enumerate(LOSS_KEYS)}
        return self._losses

    def can_scan_epochs(self, train_iter=None, val_iter=None) -> bool:
        """The scanned-epoch path (one graph per chunk of epochs) is not
        ported yet (ROADMAP 1.5)."""
        return False

    def log_losses(self, writer, epoch: int, phase: str = "train"):
        for k, v in (self._losses or {}).items():
            writer.add_scalar(f"{phase}/{k}", v, epoch + 1)

    # ------------------------------------------------------------------
    # rendering
    def render(self, batched_verts, vertex_errors=None,
               error_max_scale=None, image_size: int = 256,
               background: float = 0.0) -> np.ndarray:
        """[B, N, 3] → [B, H, W, 3] images on the template's faces; with
        ``vertex_errors``, the shadeless plasma error map."""
        from .viz.colors import errors_to_colors
        from .viz.renderer import render_batch

        verts = _numpy(batched_verts)
        if vertex_errors is not None:
            cols = errors_to_colors(_numpy(vertex_errors), 0,
                                    error_max_scale, "plasma") / 255.0
            return render_batch(verts, self.template.face, cols,
                                image_size=image_size, shadeless=True,
                                background=background, device=self.device)
        return render_batch(verts, self.template.face, image_size=image_size,
                            background=background, device=self.device)

    def log_images(self, batch, writer, epoch: int, normalization=None,
                   phase: str = "train", error_max_scale: float = 5.0,
                   max_meshes: int = 4) -> np.ndarray:
        """Ground truth, reconstruction and error map of up to
        ``max_meshes`` scans of ``batch`` as one grid, handed to
        ``writer.add_image`` and returned. A fault in the renders
        propagates."""
        from .viz.renderer import make_image_grid

        x = _numpy(batch["x"])[:max_meshes]
        out = _numpy(self.forward(x, training=False)[0])
        if normalization is not None:
            mean = np.asarray(normalization["mean"])
            std = np.asarray(normalization["std"])
            x = x * std + mean
            out = out * std + mean
        errors = self.compute_vertex_errors(out, x)
        renders = np.concatenate([
            self.render(x), self.render(out),
            self.render(out, errors, error_max_scale)], axis=0)
        grid = make_image_grid(renders, nrow=len(x))
        writer.add_image(phase, grid.transpose(2, 0, 1),
                         global_step=epoch + 1)
        return grid

    # ------------------------------------------------------------------
    def encode_all(self, batch_iter, is_train_loader: bool = True):
        """Encode every mesh of an iterator → (latents [M, Z] numpy,
        labels dict)."""
        zs, labels = [], {"y": [], "age": [], "gender": [], "augmented": []}
        for batch in batch_iter:
            zs.append(_numpy(self.encode(batch["x"])))
            labels["y"].extend(batch["y"])
            labels["age"].extend(np.asarray(batch["age"]).tolist())
            labels["gender"].extend(batch["gender"])
            labels["augmented"].extend(
                np.asarray(batch["augmented"]).tolist())
        latents = np.concatenate(zs, axis=0) if zs else np.zeros((0, 1))
        if is_train_loader:
            self._train_latents = latents
            self._train_labels = labels
        return latents, labels

    # ------------------------------------------------------------------
    # the classifier zoo (analysis/classifiers.py)
    def build_classifiers(self):
        from .analysis.classifiers import LatentClassifiers

        clf = self._classifier_params or {}
        per_region = self.loss_weights.latent_consistency > 0
        self.classifiers = LatentClassifiers(
            latent_size=self.model_latent_size,
            latent_regions=self._latent_regions if per_region else None,
            mlp_hidden=clf.get("mlp_hidden_features", [512, 128, 64]),
            mlp_lr=float(clf.get("mlp_lr", 1e-4)),
            mlp_epochs=int(clf.get("mlp_epochs", 50)),
            # the reference's optimizer: coupled Adam with the main
            # config's weight decay, one step per latent loader batch
            # (reference mm.py:118-121, 428-446)
            mlp_weight_decay=self.weight_decay,
            mlp_batch=self.batch_size,
            mlp_restarts=int(clf.get("mlp_restarts", 4)),
            device=self.device)
        return self.classifiers

    def train_and_validate_classifiers(self, train_iter, val_iter,
                                       writer=None, checkpoint_dir=None):
        """Fit MLP/SVM/LDA/QDA (and the per-region LDA/QDA) on the train
        latents, score them on the validation latents (reference
        mm.py:448-504); returns the accuracies. With an end-to-end head
        the head's own weights are the MLP."""
        if self._train_latents is None:
            self.encode_all(train_iter, is_train_loader=True)
        val_z, val_labels = self.encode_all(val_iter, is_train_loader=False)
        if len(self._train_latents) == 0 or len(val_z) == 0:
            raise ValueError(
                "classifier fitting got an empty latent set — the loader "
                "yielded no batches (batch_size larger than the split with "
                "drop_last?)")
        if self.classifiers is None:
            self.build_classifiers()
        y = np.asarray(self.class2idx(self._train_labels["y"]))
        y_val = np.asarray(self.class2idx(val_labels["y"]))
        accs = self.classifiers.fit_all(
            self._train_latents, y, val_z, y_val,
            class_weights=None if self._class_weights is None
            else _numpy(self._class_weights),
            mlp_init=mlp_to_jax(self.head.state_dict())
            if self._mlp_end2end else None,
            writer=writer)
        if checkpoint_dir:
            self.classifiers.save(checkpoint_dir)
        return accs

    def classify_latent(self, z, model: str = "main"):
        if model == "main":
            model = (self._classifier_params or {}).get(
                "main_model_type", "qda")
        pred = self.classifiers.predict(_numpy(z), model)
        return self.idx2class(pred)

    def mahalanobis_dist_to_qda_distribution(self, z, distribution_class="n",
                                             region="all"):
        idx = self.class2idx(distribution_class)
        return self.classifiers.mahalanobis(_numpy(z), idx, region)

    def qda_sample(self, sample_class="a", n_samples=1, seed=0):
        if isinstance(sample_class, str):
            sample_class = self.class2idx(sample_class)
        return self.classifiers.qda_sample(sample_class, n_samples, seed)

    def lda_project_latents_in_2d(self, latents):
        return self.classifiers.lda_transform(_numpy(latents))

    # ------------------------------------------------------------------
    # checkpointing, in the JAX package's layout
    def state_trees(self) -> dict:
        """The parameters and optimizer states as the JAX package's trees
        (numpy leaves)."""
        head = self.head
        return {
            "params": params_to_jax(self.model.state_dict()),
            "clf_params": None if head is None
            else mlp_to_jax(head.state_dict()),
            "opt_state": adam_to_optax(
                self.optimizer, dict(self.model.named_parameters()),
                self.weight_decay),
            "clf_opt_state": None if head is None else adam_to_optax(
                self.head_optimizer, dict(head.named_parameters()),
                self.weight_decay, root="layers"),
        }

    def save_weights(self, checkpoint_dir: str, epoch: int):
        save_checkpoint(checkpoint_dir, self.state_trees(), epoch + 1)
        if self.classifiers is not None:
            self.classifiers.save(checkpoint_dir)

    def resume(self, checkpoint_dir: str) -> int:
        """Restore the latest checkpoint of ``checkpoint_dir``; returns
        its epoch (0 when there is none). The network must match; a head
        of another shape is kept fresh (network weights only), and an
        ``optimizer.ckpt`` of another epoch than the model file is not
        loaded. The zoo comes from ``classifiers.npz``, or from a
        reference run's ``lda/qda_classifier.pkl``; with neither,
        ``classifiers`` is an empty zoo."""
        model_path = latest_checkpoint(checkpoint_dir)
        if model_path is None:
            self._resume_classifiers(checkpoint_dir)
            return 0
        raw = read_checkpoint(model_path)
        _load_named(self.model, named_from_tree(raw["params"]))
        if self.head is not None:
            try:
                stored = raw.get("clf_params")
                if stored is None:
                    raise ValueError("no head stored")
                _load_named(self.head, named_from_tree({"layers": stored}))
            except ValueError:
                print("Classifier head shape mismatch; restored network "
                      "weights only")
        epoch = int(MODEL_RE.search(model_path).group(1))
        opt_path = os.path.join(checkpoint_dir, "optimizer.ckpt")
        if os.path.exists(opt_path):
            opt = read_checkpoint(opt_path)
            stored_epoch = int(opt["epoch"])
            if stored_epoch != epoch:
                print(f"WARNING: optimizer.ckpt is from epoch {stored_epoch} "
                      f"but the latest model checkpoint is epoch {epoch} "
                      "(crash between paired writes?); optimizer state not "
                      "restored")
            else:
                adam_from_optax(self.optimizer,
                                dict(self.model.named_parameters()),
                                opt["opt_state"], self.weight_decay)
                if self.head is not None:
                    try:
                        if opt.get("clf_opt_state") is None:
                            raise ValueError("no head optimizer stored")
                        adam_from_optax(self.head_optimizer,
                                        dict(self.head.named_parameters()),
                                        opt["clf_opt_state"],
                                        self.weight_decay, root="layers")
                    except ValueError:
                        print("Classifier optimizer mismatch; restored net "
                              "optimizer state only")
        self._resume_classifiers(checkpoint_dir)
        return epoch

    def _resume_classifiers(self, checkpoint_dir: str) -> None:
        if self.classifiers is None:
            self.build_classifiers()
        try:
            self.classifiers.load(checkpoint_dir)
        except FileNotFoundError:
            # a migrated reference run carries sklearn pickles instead
            if any(os.path.exists(os.path.join(checkpoint_dir, n))
                   for n in ("lda_classifier.pkl", "qda_classifier.pkl")):
                self.classifiers.load_reference_pickles(checkpoint_dir)
                print("Classifiers loaded from reference sklearn pickles")
            else:
                print("Classifiers not trained yet; "
                      "skipping classifier resume")


def _numpy(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)

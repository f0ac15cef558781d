"""The evaluation harness (counterpart of ``analysis/tester.py``): the
``Tester``, its experiments, the template's clinical landmark indices
and the latent statistics.

It writes the JAX package's artifact families into ``outputs/<id>/``:

- ``eval_metrics.json``: reconstruction errors in mm and the diversities;
- ``accuracies.json``, ``classification_report.json`` and
  ``classification_report_regions.json`` (``analysis/metrics.py``, the
  card's machine has no sklearn);
- the latent traversals (``latent_exploration{s}.avi``, the tiled PNG
  and AVI, ``latent_exploration_split{s}.svg`` and
  ``latent_exploration{s}.svg``), the random generations
  (``random_generation.png`` and ``random_meshes/*.ply``), the
  interpolations, the surgical plans (``interpolations/``, with
  ``<patient>_procedure_distances.csv``), the pre/post assessment
  (``pre_post_eval_plots/<table>_with_results.csv``, the boxplots,
  ``postop_displacement.ply``), saliency, uncertainty and the fit of an
  unregistered scan (``fit/``);
- the embeddings, LDA or t-SNE (``analysis/tsne.py``):
  ``<mode>_emb_train_vs_test.svg``, ``<mode>_emb_real_vs_aug.svg``,
  ``<mode>_emb_distributions.svg``, ``emb_all_train.svg`` and
  ``emb_all_train_dist.svg``; the confusion matrices
  (``confmat_<head>.svg``, ``region_confmats_<m>.svg``); and the
  overlays of latent walks and patients on the embedding figures, each an
  SVG and, for a walk, a video of one frame a point.

Images are PNG through ``viz/images.py``; figures are SVG through
``viz/svg.py`` and ``viz/plots.py``; every video JAX writes as
``<name>.mp4`` (an ``.avi`` where it has no ffmpeg) is ``<name>.avi``,
Motion-JPEG encoded on the manager's device (``viz/video.py``). The
numbers behind each figure are kept in ``figure_data``, keyed by the
file's path relative to the run dir.

JAX pickles its two embedding figures (``lda_emb_distributions.pkl``,
``emb_all_train_dist.pkl``) and draws later overlays on the unpickled
figure. The port writes the figure's data to ``<name>.npz`` beside the
SVG instead and redraws from it; where a JAX run dir holds only the
``.pkl``, it recomputes the data from the run's train latents.

Decodes, encodes, renders (K7), the fit (K8) and saliency's gradient run
on the manager's device; the metrics are numpy on the host, as JAX's
are.
"""

from __future__ import annotations

import csv
import json
import os
import pickle

import numpy as np
import torch

from ..geometry.mesh_io import read_mesh, write_ply
from ..geometry.template import COLOUR2ATTRIBUTE, PROCEDURES2ATTRIBUTES
from ..viz import plots
from ..viz.images import write_png
from ..viz.renderer import make_image_grid
from ..viz.svg import overlay_frames
from ..viz.video import write_video
from .classifiers import QDAClassifier
from .metrics import classification_report, confusion_matrix, unique_labels
from .planning import vector_linspace

__all__ = ["Tester", "TEMPLATE_LANDMARKS_IDX", "compute_latent_stats",
           "reconstruction_errors", "compute_diversity", "random_latent",
           "random_generation"]

# 20 hand-picked facial landmark vertex ids on the 17,039-vertex
# craniofacial template (reference test.py:52-55): a property of that
# template asset. On another template keep the ids below its vertex count.
TEMPLATE_LANDMARKS_IDX = [14336, 14250, 13087, 13145, 4134,
                          871, 4166, 303, 15614, 7166,
                          3904, 16465, 9246, 4643, 10122,
                          4548, 2893, 2985, 830, 2004]

_STATS = ("means", "stds", "mins", "maxs")


def _numpy(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def compute_latent_stats(manager, output_dir: str, train_iter=None,
                         cache: bool = True, transient: bool = False
                         ) -> dict:
    """Per-dimension mean, std (ddof 1), min and max of the train latents,
    cached as ``z_stats.npz`` (reference test.py:95-117).

    A reference run dir's ``z_stats.pkl`` (a pickled dict of torch
    tensors) is read in place, as it was written: it reflects the model
    that wrote it. ``transient=True`` computes the stats of the current
    weights with no file read or written, no latents kept on the manager
    and the iterator's dataset order (its shuffle draws untouched)."""
    path = os.path.join(output_dir, "z_stats.npz")
    if transient:
        if train_iter is None:
            raise ValueError("transient stats need train_iter")
        batches = (train_iter.ordered_batches()
                   if hasattr(train_iter, "ordered_batches")
                   else train_iter)
        latents, _ = manager.encode_all(batches, is_train_loader=False)
    else:
        if cache and os.path.exists(path):
            with np.load(path) as z:
                return {k: z[k] for k in _STATS}
        ref_pkl = os.path.join(output_dir, "z_stats.pkl")
        if cache and os.path.exists(ref_pkl):
            with open(ref_pkl, "rb") as f:
                ref = pickle.load(f)
            print(f"[tester] using migrated latent stats from {ref_pkl} — "
                  "these reflect the model that wrote them; delete the "
                  "file to recompute for the current weights")
            return {k: np.asarray(ref[k], dtype=np.float32) for k in _STATS}
        latents, _ = manager.train_latents_and_labels
        if latents is None:
            if train_iter is None:
                raise ValueError("no cached train latents; pass train_iter")
            latents, _ = manager.encode_all(train_iter,
                                            is_train_loader=True)
    stats = {"means": latents.mean(axis=0),
             "stds": latents.std(axis=0, ddof=1),
             "mins": latents.min(axis=0),
             "maxs": latents.max(axis=0)}
    if not transient and cache:
        os.makedirs(output_dir, exist_ok=True)
        np.savez(path, **stats)
    return stats


def reconstruction_errors(manager, data_iter, normalization: dict) -> dict:
    """Per-mesh mean vertex error in mm; stats over meshes (reference
    test.py:280-301). ``std`` has ddof 1: NaN for one mesh, as in JAX."""
    mean = np.asarray(normalization["mean"])
    std = np.asarray(normalization["std"])
    per_mesh = []
    for batch in data_iter:
        x = _numpy(batch["x"])
        out = _numpy(manager.forward(x, training=False)[0])
        gt = x * std + mean
        pred = out * std + mean
        err = np.asarray(manager.compute_vertex_errors(pred, gt))
        per_mesh.append(err.mean(axis=1))
    e = np.concatenate(per_mesh)
    return {"mean": float(e.mean()), "median": float(np.median(e)),
            "max": float(e.max()), "std": float(e.std(ddof=1))}


def compute_diversity(meshes_a: np.ndarray, meshes_b: np.ndarray,
                      to_mm: float = 1.0) -> float:
    """Mean per-vertex distance between two matched mesh sets."""
    d = np.linalg.norm(meshes_a - meshes_b, axis=-1) * to_mm
    return float(d.mean())


def random_latent(manager, z_stats, n_samples=16, seed=0,
                  z_range_multiplier=1.0) -> np.ndarray:
    """``n_samples`` latents drawn from ``default_rng(seed)``: standard
    normal for a VAE (``z_stats`` unused), uniform in the stats' range
    for an AE."""
    rng = np.random.default_rng(seed)
    if manager.is_vae:
        z = rng.standard_normal((n_samples, manager.model_latent_size))
    else:
        lo = np.asarray(z_stats["mins"]) * z_range_multiplier
        hi = np.asarray(z_stats["maxs"]) * z_range_multiplier
        z = rng.uniform(size=(n_samples, len(lo))) * (hi - lo) + lo
    return z.astype(np.float32)


def random_generation(manager, z_stats, n_samples=16, seed=0,
                      z_range_multiplier=1.0):
    """Decode ``n_samples`` latents of ``random_latent``."""
    return _numpy(manager.generate(random_latent(
        manager, z_stats, n_samples, seed, z_range_multiplier)))


class Tester:
    """Standard evaluation suite runner (reference test.py:57-79)."""

    def __init__(self, manager, norm_dict, train_iter, test_iter,
                 out_dir: str, config: dict, lazy_stats: bool = False):
        """With ``lazy_stats=True`` the train-latent statistics are
        computed on first use instead of here: a Tester built before
        training (``train.py``'s traversals at each checkpoint) must not
        cache the untrained model's stats."""
        self._manager = manager
        self._norm = {k: np.asarray(v) for k, v in norm_dict.items()}
        self._normalized = config["data"].get("normalize_data", True)
        self._out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self._config = config
        self._train_iter = train_iter
        self._test_iter = test_iter
        self._is_vae = manager.is_vae
        self._latent_stats = None if lazy_stats else \
            compute_latent_stats(manager, out_dir, train_iter)
        self.template_landmarks_idx = list(TEMPLATE_LANDMARKS_IDX)
        self._image_size = 256
        self._background = 0.0
        # {file written, relative to the run dir: the numbers behind it}
        self.figure_data = {}

    @property
    def latent_stats(self) -> dict:
        if self._latent_stats is None:
            self._latent_stats = compute_latent_stats(
                self._manager, self._out_dir, self._train_iter)
        return self._latent_stats

    # ------------------------------------------------------------------
    def __call__(self):
        self.set_renderings_size(256)
        self.set_rendering_background_color(1.0)
        self.latent_traversals(use_z_stats=False)
        self.plot_embeddings()
        self.random_generation_and_rendering(n_samples=16)
        self.random_generation_and_save(n_samples=16)
        self.test_classifiers()
        metrics = {
            "recon_errors": reconstruction_errors(
                self._manager, self._test_iter, self._norm),
            "train_set_diversity": self.compute_diversity_train_set(),
            "diversity": self.compute_diversity(),
        }
        with open(os.path.join(self._out_dir, "eval_metrics.json"),
                  "w") as f:
            json.dump(metrics, f)
        return metrics

    def _save_figure(self, rel: str, fig, data) -> str:
        """``fig`` as ``<run dir>/<rel>`` (SVG), its numbers kept in
        ``figure_data[rel]``."""
        self.figure_data[rel] = data
        return fig.save_svg(os.path.join(self._out_dir, rel))

    def _write_video(self, path: str, frames, fps=4) -> str:
        """Float frames ``[T, H, W, 3]`` as ``<name>.avi`` beside the
        ``<name>.mp4`` JAX asks for, encoded on the manager's device."""
        return write_video(path, frames, fps=fps,
                           device=self._manager.device)

    string_to_color = staticmethod(plots.string_to_color)

    # ------------------------------------------------------------------
    def _unnormalize(self, verts: np.ndarray) -> np.ndarray:
        if not self._normalized:
            return verts
        return verts * self._norm["std"] + self._norm["mean"]

    def _normalize(self, verts: np.ndarray) -> np.ndarray:
        if not self._normalized:
            return verts
        return (verts - self._norm["mean"]) / self._norm["std"]

    def set_renderings_size(self, size: int):
        self._image_size = size

    def set_rendering_background_color(self, color=1.0):
        """Grayscale background level (white for the standard suite,
        reference test.py:59-60, 89-93)."""
        self._background = float(color if not isinstance(color, (list,
                                 tuple)) else color[0])

    def _render(self, verts, errors=None, error_max_scale=None):
        return self._manager.render(verts, errors, error_max_scale,
                                    image_size=self._image_size,
                                    background=self._background)

    def save_batch(self, batch_verts, out_dir, v_colours=None):
        os.makedirs(out_dir, exist_ok=True)
        for i, v in enumerate(np.asarray(batch_verts)):
            vc = None if v_colours is None else np.asarray(v_colours[i])
            write_ply(os.path.join(out_dir, f"{i}.ply"), v,
                      self._manager.template.face, vc)

    # ------------------------------------------------------------------
    # latent traversals (reference test.py:128-229)
    def latent_traversals(self, z_range_multiplier=1.0, use_z_stats=True,
                          save_suffix=None, n_steps=10,
                          render_videos=True):
        """Walk each latent dimension from its low to its high end
        (±3 for a VAE without stats), the others at their means; returns
        each dimension's per-vertex displacement at the walk's end."""
        latent_size = self._manager.model_latent_size
        if self._is_vae and not use_z_stats:
            z_means = np.zeros(latent_size, np.float32)
            z_mins = -3 * z_range_multiplier * np.ones(latent_size)
            z_maxs = 3 * z_range_multiplier * np.ones(latent_size)
        else:
            # an AE's mid-training traversal takes transient stats: the
            # cached ones would serve this model's stats to the final
            # evaluation, and a shuffle draw would shift later epoch plans
            if not use_z_stats and self._latent_stats is None:
                stats = compute_latent_stats(
                    self._manager, self._out_dir, self._train_iter,
                    transient=True)
            else:
                stats = self.latent_stats
            z_means = np.asarray(stats["means"])
            z_mins = np.asarray(stats["mins"]) * z_range_multiplier
            z_maxs = np.asarray(stats["maxs"]) * z_range_multiplier

        s = save_suffix if save_suffix is not None else ""
        # the dims decoded in chunks of at most 80 meshes, every chunk of
        # one size where the latent size allows (JAX's plan)
        z_all = np.tile(z_means,
                        (latent_size, n_steps, 1)).astype(np.float32)
        for i in range(latent_size):
            z_all[i, :, i] = np.linspace(z_mins[i], z_maxs[i], n_steps)
        flat = z_all.reshape(-1, latent_size)
        cap = max(80 // n_steps, 1)
        dims_per_chunk = max(
            [d for d in range(1, cap + 1) if latent_size % d == 0])
        rows = dims_per_chunk * n_steps if n_steps <= 80 else 80
        chunks = [_numpy(self._manager.generate(flat[s0:s0 + rows]))
                  for s0 in range(0, len(flat), rows)]
        gen_all = np.concatenate(chunks).reshape(
            latent_size, n_steps, -1, 3)

        all_frames, all_diff_renders, max_distances = [], [], []
        for i in range(latent_size):
            gen = self._unnormalize(gen_all[i])
            diffs = np.asarray(self._manager.compute_vertex_errors(
                gen, np.broadcast_to(gen[0], gen.shape)))
            max_distances.append(diffs[-1])
            if render_videos:
                renders = self._render(gen)
                diff_renders = self._render(gen, diffs, 5)
                all_diff_renders.append(diff_renders)
                frames = np.concatenate([renders, diff_renders], axis=2)
                black = np.zeros_like(frames[:2])
                all_frames.append(np.concatenate([frames, black]))

        if render_videos:
            self._write_video(
                os.path.join(self._out_dir, f"latent_exploration{s}.mp4"),
                np.concatenate(all_frames), fps=4)
            del all_frames
            n_regions = max(len(self._manager.latent_regions), 1)
            nrow = latent_size // n_regions \
                if self._config["data"].get("swap_features") else 8
            stacked = np.stack(all_diff_renders)       # [Z, steps, H, W, 3]
            grid_frames = [make_image_grid(stacked[:, t], nrow=nrow)
                           for t in range(stacked.shape[1])]
            write_png(
                os.path.join(self._out_dir,
                             f"latent_exploration_tiled{s}.png"),
                grid_frames[-1])
            self._write_video(
                os.path.join(self._out_dir,
                             f"latent_exploration_tiled{s}.mp4"),
                np.stack(grid_frames), fps=1)

        # the per-region displacement plots
        table = self.region_displacement(max_distances)
        split, line = plots.traversal_figures(table, {
            k: self.string_to_color(k)
            for k in self._manager.template.feat_and_cont})
        self._save_figure(f"latent_exploration_split{s}.svg", split, table)
        self._save_figure(f"latent_exploration{s}.svg", line, table)
        return max_distances

    def region_displacement(self, max_distances) -> list:
        """The traversal plots' rows: per latent dimension and region,
        the mean end-of-walk displacement over the region's vertices."""
        regions = self._manager.template.feat_and_cont
        return [{"mean_dist": float(
                    dist[np.asarray(idxs["feature"])].mean()),
                 "z_var": zi, "region": region}
                for zi, dist in enumerate(max_distances)
                for region, idxs in regions.items()]

    # ------------------------------------------------------------------
    # generation (reference test.py:231-266)
    def _generation_stats(self):
        # a VAE draws from N(0, 1): its stats are not computed for it
        return None if self._is_vae else self.latent_stats

    def random_latent(self, n_samples, z_range_multiplier=1.0, seed=0):
        return random_latent(self._manager, self._generation_stats(),
                             n_samples, seed, z_range_multiplier)

    def random_generation(self, n_samples=16, z_range_multiplier=1.0,
                          denormalize=True, seed=0):
        gen = random_generation(self._manager, self._generation_stats(),
                                n_samples, seed, z_range_multiplier)
        return self._unnormalize(gen) if denormalize else gen

    def random_generation_and_rendering(self, n_samples=16,
                                        z_range_multiplier=1.0):
        gen = self.random_generation(n_samples, z_range_multiplier)
        grid = make_image_grid(self._render(gen), nrow=4)
        write_png(os.path.join(self._out_dir, "random_generation.png"),
                  grid)
        return grid

    def random_generation_and_save(self, n_samples=16,
                                   z_range_multiplier=1.0):
        gen = self.random_generation(n_samples, z_range_multiplier)
        self.save_batch(gen, os.path.join(self._out_dir, "random_meshes"))

    # ------------------------------------------------------------------
    # quantitative (reference test.py:280-334)
    def reconstruction_errors(self, data_iter=None):
        return reconstruction_errors(
            self._manager, data_iter or self._test_iter, self._norm)

    def compute_diversity_train_set(self) -> float:
        prev = None
        dists = []
        for batch in self._train_iter:
            cur = self._unnormalize(_numpy(batch["x"]))
            if prev is not None:
                n = min(len(prev), len(cur))
                d = np.asarray(self._manager.compute_vertex_errors(
                    prev[:n], cur[:n]))
                dists.append(d.mean(axis=1))
            prev = cur
        return float(np.concatenate(dists).mean()) if dists else 0.0

    def compute_diversity(self, n_samples=10000, batch=100) -> float:
        """Mean vertex distance between pairs of independently generated
        meshes (reference test.py:325-334), in batches of ``batch``, the
        pair's seeds ``2i`` and ``2i + 1``."""
        dists = [compute_diversity(
            self.random_generation(batch, seed=2 * i),
            self.random_generation(batch, seed=2 * i + 1),
            self._manager.to_mm_const)
            for i in range(n_samples // (2 * batch))]
        return float(np.mean(dists)) if dists else 0.0

    # ------------------------------------------------------------------
    # embeddings (reference test.py:1160-1321)
    def _train_latents(self) -> tuple:
        mgr = self._manager
        tr_z, tr_l = mgr.train_latents_and_labels
        if tr_z is None:
            tr_z, tr_l = mgr.encode_all(self._train_iter, True)
        return tr_z, tr_l

    def plot_embeddings(self, embedding_mode="lda") -> dict:
        """The 2-D embedding of the train and test latents, LDA or t-SNE
        (``analysis/tsne.py`` on the manager's device from
        ``torch.Generator().manual_seed(0)``), and its figures (JAX
        ``:462-541``): ``<mode>_emb_train_vs_test.svg``,
        ``<mode>_emb_real_vs_aug.svg`` and the KDE figure
        ``<mode>_emb_distributions.svg`` with its ``.npz``; then the
        per-region figures. Returns ``{train [M, 2], test [K, 2],
        train_class, test_class, train_augmented, regions}``, ``regions``
        the per-region 2-D projections of the train latents where the zoo
        has region LDAs."""
        mgr = self._manager
        tr_z, tr_l = self._train_latents()
        ts_z, ts_l = mgr.encode_all(self._test_iter, False)
        tr_y = np.asarray(mgr.class2idx(tr_l["y"]))
        ts_y = np.asarray(mgr.class2idx(ts_l["y"]))
        if embedding_mode == "lda":
            tr_e = np.asarray(mgr.lda_project_latents_in_2d(tr_z))
            ts_e = np.asarray(mgr.lda_project_latents_in_2d(ts_z))
        elif embedding_mode == "tsne":
            from .tsne import tsne

            gen = torch.Generator(device=mgr.device).manual_seed(0)
            emb = tsne(np.concatenate([tr_z, ts_z]), generator=gen,
                       device=mgr.device)["embedding"]
            tr_e, ts_e = emb[:len(tr_z)], emb[len(tr_z):]
        else:
            raise NotImplementedError(embedding_mode)

        m = embedding_mode
        emb = np.concatenate([tr_e, ts_e])
        x1, x2 = emb[:, 0], emb[:, 1]
        cls = np.asarray(mgr.idx2class(np.concatenate([tr_y, ts_y]))
                         ).astype(str)
        kind = np.array(["train"] * len(tr_y) + ["test"] * len(ts_y))
        aug = np.concatenate([np.asarray(tr_l["augmented"]),
                              np.asarray(ts_l["augmented"])]).astype(bool)
        hue_order, palette = plots.class_palette(cls)
        self._save_figure(
            f"{m}_emb_train_vs_test.svg", plots.scatter_figure(
                x1, x2, cls, kind, hue_order, palette, ["train", "test"]),
            {"x1": x1, "x2": x2, "class": cls, "type": kind})
        tr = kind == "train"
        self._save_figure(
            f"{m}_emb_real_vs_aug.svg", plots.scatter_figure(
                x1[tr], x2[tr], cls[tr], aug[tr], hue_order, palette,
                sorted(set(aug[tr].tolist())), style_title="aug"),
            {"x1": x1[tr], "x2": x2[tr], "class": cls[tr], "aug": aug[tr]})
        real = tr & ~aug
        state = plots.distribution_state(x1[real], x2[real], cls[real],
                                         hue_order, palette)
        np.savez(os.path.join(self._out_dir, f"{m}_emb_distributions.npz"),
                 **state)
        self._save_figure(f"{m}_emb_distributions.svg",
                          plots.distribution_figure(state)[0], state)
        out = {"train": tr_e, "test": ts_e,
               "train_class": list(tr_l["y"]), "test_class": list(ts_l["y"]),
               "train_augmented": np.asarray(tr_l["augmented"])}
        regions = self.plot_embeddings_per_region(tr_z, tr_y, tr_l)
        if regions is not None:
            out["regions"] = regions
        return out

    def _region_state(self, tr_z, tr_y, tr_l) -> tuple:
        """The per-region grid's data over the real train latents, and the
        per-region projections of every train latent."""
        mgr = self._manager
        proj = self._region_projections(tr_z)
        real = ~np.asarray(tr_l["augmented"]).astype(bool)
        cls = np.asarray(mgr.idx2class(np.asarray(tr_y))).astype(str)[real]
        names = [COLOUR2ATTRIBUTE.get(k, k) for k in proj]
        hue_order = [c for c in plots.CLASS_ORDER if c in set(cls)]
        state = plots.region_grid_state(
            np.concatenate([e[real, 0] for e in proj.values()]),
            np.concatenate([e[real, 1] for e in proj.values()]),
            np.tile(cls, len(proj)), np.repeat(names, real.sum()),
            hue_order)
        return state, proj

    def plot_embeddings_per_region(self, tr_z, tr_y, tr_l):
        """The per-region FacetGrid of the real train latents (JAX
        ``:543-592``): ``emb_all_train.svg``, and the same figure as
        ``emb_all_train_dist.svg`` with its ``.npz``. Returns the
        per-region projections, or None without region LDAs."""
        zoo = self._manager.classifiers
        if zoo is None or not zoo.region_ldas:
            print("[tester] region LDAs unavailable; skipping region plots")
            return None
        state, proj = self._region_state(tr_z, tr_y, tr_l)
        np.savez(os.path.join(self._out_dir, "emb_all_train_dist.npz"),
                 **state)
        fig, _ = plots.region_grid_figure(state)
        self._save_figure("emb_all_train.svg", fig, state)
        self._save_figure("emb_all_train_dist.svg", fig, state)
        return proj

    def _figure_state(self, name: str):
        """The data of the embedding figure ``name``
        (``lda_emb_distributions`` or ``emb_all_train_dist``) from its
        ``.npz``; where only JAX's ``.pkl`` is in the run dir, recomputed
        from the train latents; else None (the overlay is skipped, as
        JAX skips it)."""
        path = os.path.join(self._out_dir, name + ".npz")
        if os.path.exists(path):
            with np.load(path) as z:
                return {k: z[k] for k in z.files}
        if not os.path.exists(os.path.join(self._out_dir, name + ".pkl")):
            print(f"[tester] {path} missing; overlay skipped")
            return None
        mgr = self._manager
        tr_z, tr_l = self._train_latents()
        tr_y = np.asarray(mgr.class2idx(tr_l["y"]))
        if name == "emb_all_train_dist":
            return self._region_state(tr_z, tr_y, tr_l)[0]
        emb = np.asarray(mgr.lda_project_latents_in_2d(tr_z))
        cls = np.asarray(mgr.idx2class(tr_y)).astype(str)
        real = ~np.asarray(tr_l["augmented"]).astype(bool)
        hue_order, palette = plots.class_palette(cls)
        return plots.distribution_state(emb[real, 0], emb[real, 1],
                                        cls[real], hue_order, palette)

    def _region_projections(self, z: np.ndarray) -> dict:
        """{region_key: [P, 2]} per-region 2-D projections: the region's
        LDA where its slice has more than two dimensions, else the
        slice's first and last coordinates."""
        mgr = self._manager
        zoo = mgr.classifiers
        out = {}
        for key, (lo, hi) in mgr.latent_regions.items():
            if hi - lo > 2 and zoo is not None and zoo.region_ldas:
                lda = zoo.region_ldas[key]
                emb = lda.transform_sklearn_style(z[:, lo:hi]) \
                    if hasattr(lda, "_sklearn_transform") \
                    else lda.transform(z[:, lo:hi])
            else:
                emb = z[:, [lo, hi - 1]]
            emb = np.asarray(emb)
            if emb.shape[1] < 2:    # 2-class LDA has a single component
                emb = np.concatenate(
                    [emb, np.zeros((len(emb), 2 - emb.shape[1]))], axis=1)
            out[key] = emb
        return out

    # ------------------------------------------------------------------
    # classifier evaluation (reference test.py:1323-1440)
    def test_classifiers(self):
        """Every head's test accuracy and sklearn-form report
        (``accuracies.json``, ``classification_report.json``), the region
        QDAs' reports (``classification_report_regions.json``), and the
        normalised confusion matrices (``confmat_<head>.svg``,
        ``region_confmats_<m>.svg``), whose labels span the predictions
        too. A head the zoo lacks is left out."""
        mgr = self._manager
        zoo = mgr.classifiers
        ts_z, ts_l = mgr.encode_all(self._test_iter, False)
        ts_ly = np.asarray(ts_l["y"])
        ts_y = np.asarray(mgr.class2idx(ts_l["y"]))

        accs, reports, preds = {}, {}, {}
        for name in ("mlp", "svm", "lda", "qda"):
            if zoo is None or getattr(zoo, name) is None:
                print(f"[tester] {name} unavailable: not fitted")
                continue
            pred = zoo.predict(ts_z, name)
            pred_chars = np.asarray(mgr.idx2class(pred))
            accs[f"accuracy_{name}"] = float(np.mean(pred == ts_y))
            reports[name] = classification_report(
                ts_ly, pred_chars, output_dict=True, zero_division=0)
            preds[name] = pred_chars

        with open(os.path.join(self._out_dir, "accuracies.json"), "w") as f:
            json.dump(accs, f)
        with open(os.path.join(self._out_dir,
                               "classification_report.json"), "w") as f:
            json.dump(reports, f)

        # labels span the predictions too: a head predicting a class absent
        # from a small test split gives the matrix one more row
        labels = unique_labels(ts_ly, *preds.values()) if preds \
            else unique_labels(ts_ly)
        self.confusion_matrices = {
            name: confusion_matrix(ts_ly, pred_chars, labels=labels,
                                   normalize="true")
            for name, pred_chars in preds.items()}
        self.confusion_labels = labels
        for name, cm in self.confusion_matrices.items():
            self._save_figure(f"confmat_{name}.svg",
                              plots.confusion_figure(cm, labels),
                              {"labels": labels, "matrix": cm})

        if zoo is not None and zoo.region_qdas:
            region_reports = {}
            for key, (lo, hi) in mgr.latent_regions.items():
                pred = zoo.region_qdas[key].predict(ts_z[:, lo:hi])
                pred_chars = np.asarray(mgr.idx2class(pred))
                region_reports[key] = classification_report(
                    ts_ly, pred_chars, output_dict=True, zero_division=0)
                region_reports[key]["accuracy"] = float(
                    np.mean(pred == ts_y))
            with open(os.path.join(
                    self._out_dir,
                    "classification_report_regions.json"), "w") as f:
                json.dump(region_reports, f)
            self.confusion_matrices_per_region(ts_z, ts_ly)
        return accs

    def confusion_matrices_per_region(self, ts_z, ts_ly) -> dict:
        """``{"lda"|"qda": {region: (labels, normalised matrix)}}``, each
        region's labels spanning its predictions, drawn as
        ``region_confmats_<m>.svg`` (five panels a row)."""
        mgr = self._manager
        zoo = mgr.classifiers
        out = {}
        for m, clf_dict in (("lda", zoo.region_ldas),
                            ("qda", zoo.region_qdas)):
            if not clf_dict:
                continue
            out[m] = {}
            for key, clf in clf_dict.items():
                lo, hi = mgr.latent_regions[key]
                pred = np.asarray(mgr.idx2class(clf.predict(ts_z[:, lo:hi])))
                labels = unique_labels(ts_ly, pred)
                out[m][key] = (labels, confusion_matrix(
                    ts_ly, pred, labels=labels, normalize="true"))
            self._save_figure(f"region_confmats_{m}.svg",
                              plots.region_confusion_figure([
                                  (COLOUR2ATTRIBUTE.get(k, k), cm, labels)
                                  for k, (labels, cm) in out[m].items()]),
                              out[m])
        return out

    # ------------------------------------------------------------------
    # interpolations (reference test.py:544-637)
    def interpolate(self, v_1: np.ndarray, v_2: np.ndarray,
                    per_variable_steps: int = 3):
        """Per-feature, per-variable and all-features latent
        interpolation between two meshes (raw vertex arrays):
        ``interpolate_per_feature.png``, ``interpolate_all.png`` and the
        videos ``interpolate_per_feature.avi`` and
        ``interpolate_per_variable.avi``."""
        mgr = self._manager
        z_1 = _numpy(mgr.encode(self._normalize(v_1)))
        z_2 = _numpy(mgr.encode(self._normalize(v_2)))
        features = list(mgr.template.feat_and_cont.keys())
        n = max(len(features) // 2, 2)

        # per feature: walk each region's slice from z1 to z2 in turn
        rows, all_frames = [], []
        z = np.tile(z_1, (n, 1))
        for feature in features:
            lo, hi = mgr.latent_regions[feature]
            z[:, lo:hi] = vector_linspace(z_1[lo:hi], z_2[lo:hi], n)
            gen = self._unnormalize(_numpy(mgr.generate(z)))
            renders = self._render(gen)
            all_frames.append(renders)
            rows.append(make_image_grid(renders, nrow=n))
            z = np.tile(z[-1], (n, 1))
        write_png(
            os.path.join(self._out_dir, "interpolate_per_feature.png"),
            np.concatenate(rows, axis=0))
        self._write_video(
            os.path.join(self._out_dir, "interpolate_per_feature.mp4"),
            np.concatenate(all_frames, axis=0), fps=4)

        # per variable: walk every latent dimension z1 → z2 in turn
        all_frames = []
        z = np.tile(z_1, (per_variable_steps, 1))
        for z_i in range(z_1.shape[-1]):
            z[:, z_i] = np.linspace(float(z_1[z_i]), float(z_2[z_i]),
                                    per_variable_steps)
            gen = self._unnormalize(_numpy(mgr.generate(z)))
            all_frames.append(self._render(gen))
            z = np.tile(z[-1], (per_variable_steps, 1))
        self._write_video(
            os.path.join(self._out_dir, "interpolate_per_variable.mp4"),
            np.concatenate(all_frames, axis=0), fps=4)

        # all features at once
        zs = vector_linspace(z_1, z_2, len(features))
        gen = self._unnormalize(_numpy(mgr.generate(zs)))
        write_png(
            os.path.join(self._out_dir, "interpolate_all.png"),
            make_image_grid(self._render(gen), nrow=len(features)))

    # ------------------------------------------------------------------
    # surgical planning (reference test.py:652-905)
    def _load_and_encode(self, mesh_path: str) -> np.ndarray:
        verts = read_mesh(mesh_path).vertices.astype(np.float32)
        return _numpy(self._manager.encode(self._normalize(verts)))

    def interpolate_syndrome_to_normal(self, patient_path: str,
                                       n_p_to_3std: int = 8,
                                       n_linspace: int = 5000,
                                       render: bool = True) -> dict:
        """Plan surgery: walk the patient latent toward the healthy-class
        QDA Gaussian, locating the 3/2/1-std crossings by log-pdf
        thresholds (reference test.py:652-748). Returns the key latents
        and per-procedure walks; with ``render`` writes each walk's
        renders, PLYs, video and overlays under ``interpolations/`` and
        the ``<patient>_procedure_distances.csv`` table."""
        from .planning import healthy_gaussian, plan_to_healthy

        mgr = self._manager
        z_p = self._load_and_encode(patient_path).reshape(-1)
        patient_fname = os.path.basename(patient_path)

        if mgr.classifiers is None or mgr.classifiers.qda is None:
            raise RuntimeError(
                "surgical planning needs the trained QDA (run "
                "train_and_validate_classifiers or resume a checkpoint "
                "with a fitted zoo first)")
        mean_h, cov_h = healthy_gaussian(mgr.classifiers.qda,
                                         mgr.class2idx("n"))
        out = plan_to_healthy(z_p, mean_h, cov_h, mgr.latent_regions,
                              n_p_to_3std=n_p_to_3std,
                              n_linspace=n_linspace)
        if render:
            self._render_embed_save_z_interpolations(
                out["all_attributes"],
                patient_fname[:-4] + "_all_attributes")
            for proc, zp_grid in out["procedures"].items():
                self._render_embed_save_z_interpolations(
                    zp_grid, patient_fname[:-4] + "_" + proc)
            interp_dir = os.path.join(self._out_dir, "interpolations")
            os.makedirs(interp_dir, exist_ok=True)
            write_table_csv(
                os.path.join(interp_dir, patient_fname[:-4]
                             + "_procedure_distances.csv"),
                out["procedure_distances"])
        return out

    def _render_embed_save_z_interpolations(self, z_interp, save_id):
        """Renders and error maps of a latent walk (PNG grids and
        ``interpolation.avi``), its meshes as PLYs under
        ``interpolations/<save_id>``, and the walk overlaid on both
        embedding figures, each as an SVG and a video of one frame a point
        (reference test.py:750-905)."""
        mgr = self._manager
        out_dir = os.path.join(self._out_dir, "interpolations", save_id)
        os.makedirs(out_dir, exist_ok=True)

        gen = self._unnormalize(
            _numpy(mgr.generate(z_interp.astype(np.float32))))
        errors = np.asarray(mgr.compute_vertex_errors(
            gen, np.broadcast_to(gen[0], gen.shape)))
        renders = self._render(gen)
        err_renders = self._render(gen, errors, 5)
        write_png(os.path.join(out_dir, "interpolation.png"),
                  make_image_grid(renders, nrow=len(gen)))
        write_png(os.path.join(out_dir, "interpolation_errors.png"),
                  make_image_grid(err_renders, nrow=len(gen)))
        self._write_video(os.path.join(out_dir, "interpolation.mp4"),
                          np.concatenate([renders, err_renders], axis=2),
                          fps=2)
        self.save_batch(gen, out_dir)
        self._overlay_on_global_figure(
            z_interp, out_dir, save_id + "_emb",
            video_name=save_id + "_emb_interpolate")
        self._overlay_on_region_grid(
            z_interp, out_dir, save_id + "_emb_r_interpolate", video=True)

    def _overlay_on_global_figure(self, z, out_dir, svg_name,
                                  video_name=None) -> None:
        """The latents' LDA projections on the KDE embedding figure: a
        line with markers (``<svg_name>.svg``) and, with ``video_name``
        and several latents, a video whose frame p shows points 0..p
        (JAX ``:867-890``)."""
        state = self._figure_state("lda_emb_distributions")
        if state is None:
            return
        z = np.atleast_2d(np.asarray(z))
        proj = np.asarray(self._manager.lda_project_latents_in_2d(z))
        fig, ax = plots.distribution_figure(state)
        ax.plot(proj[:, 0], proj[:, 1], plots.OVERLAY_COLOUR, marker="o",
                markersize=3)
        rel = os.path.relpath(os.path.join(out_dir, svg_name + ".svg"),
                              self._out_dir)
        self._save_figure(rel, fig, {"points": proj})
        if video_name is not None and len(proj) > 1:
            fig, ax = plots.distribution_figure(state)
            frames = overlay_frames(fig, [(ax, proj, 6,
                                           plots.OVERLAY_COLOUR, True)])
            path = self._write_video(
                os.path.join(out_dir, video_name + ".mp4"), frames, fps=4)
            self.figure_data[os.path.relpath(path, self._out_dir)] = {
                "points": proj, "frames": len(frames)}

    def _overlay_on_region_grid(self, z, out_dir, name,
                                video=False) -> None:
        """The latents' per-region projections on the per-region grid:
        ``<name>.svg`` and, with ``video`` and several latents, a video
        whose frame p shows point p in every panel (JAX ``:891-904``)."""
        state = self._figure_state("emb_all_train_dist")
        if state is None:
            return
        z = np.atleast_2d(np.asarray(z))
        pts = {COLOUR2ATTRIBUTE.get(k, k): e
               for k, e in self._region_projections(z).items()}
        extra = np.concatenate(list(pts.values()))
        fig, axes = plots.region_grid_figure(state, extra)
        for region, e in pts.items():
            if region in axes:
                axes[region].scatter(e[:, 0], e[:, 1], plots.OVERLAY_COLOUR,
                                     2)
        rel = os.path.relpath(os.path.join(out_dir, name + ".svg"),
                              self._out_dir)
        self._save_figure(rel, fig, pts)
        if video and len(z) > 1:
            fig, axes = plots.region_grid_figure(state, extra)
            frames = overlay_frames(fig, [
                (axes[r], e, 2, plots.OVERLAY_COLOUR, False)
                for r, e in pts.items() if r in axes])
            path = self._write_video(os.path.join(out_dir, name + ".mp4"),
                                     frames, fps=4)
            self.figure_data[os.path.relpath(path, self._out_dir)] = {
                "points": pts, "frames": len(frames)}

    def classify_and_project(self, mesh_path: str):
        """Diagnose one patient mesh with the QDA head and overlay its
        latent on both embedding figures (``interpolations/<scan>_emb.svg``
        and ``<scan>_emb_r.svg``; reference test.py:872-904)."""
        z_p = self._load_and_encode(mesh_path).reshape(1, -1)
        label = self._manager.classify_latent(z_p, "qda")
        print(f"[tester] {os.path.basename(mesh_path)} classified as "
              f"{label}")
        out_dir = os.path.join(self._out_dir, "interpolations")
        os.makedirs(out_dir, exist_ok=True)
        name = os.path.splitext(os.path.basename(mesh_path))[0]
        self._overlay_on_global_figure(z_p, out_dir, name + "_emb")
        self._overlay_on_region_grid(z_p, out_dir, name + "_emb_r")
        return label

    # ------------------------------------------------------------------
    # pre/post surgery assessment (reference test.py:972-1157)
    def evaluate_pre_post_pair(self, pre_path, post_path, patient_id,
                               procedure="monobloc") -> dict:
        mgr = self._manager
        zoo = mgr.classifiers
        z_pre = self._load_and_encode(pre_path).reshape(1, -1)
        z_post = self._load_and_encode(post_path).reshape(1, -1)

        self._project_pre_post_pair(z_pre, z_post, patient_id)
        pre_class = mgr.classify_latent(z_pre, "qda")
        post_class = mgr.classify_latent(z_post, "qda")

        n_label = mgr.class2idx("n")
        d_pre = zoo.mahalanobis(z_pre, n_label)
        d_post = zoo.mahalanobis(z_post, n_label)
        metric_global = (d_pre - d_post) / max(d_post, 1e-9)

        if zoo.qda is None:
            raise RuntimeError(
                "pre/post assessment needs the trained QDA distribution")
        qda = zoo.qda
        # class_covariance rebuilds the covariance of a head imported
        # from a store_covariance=False sklearn pickle
        mean_h, cov_h = qda.class_covariance(n_label)
        d_pre_l2 = float(np.linalg.norm(z_pre[0] - mean_h))
        d_post_l2 = float(np.linalg.norm(z_post[0] - mean_h))
        metric_global_l2 = (d_pre_l2 - d_post_l2) / max(d_post_l2, 1e-9)

        displacement = z_post[0] - z_pre[0]
        ideal = mean_h - z_pre[0]
        cos_angle = float(
            displacement @ ideal /
            (np.linalg.norm(displacement) * np.linalg.norm(ideal) + 1e-12))
        diff = z_post[0] - z_pre[0]
        length_maha = float(np.sqrt(max(
            diff @ qda._solve_cov(cov_h, diff), 0.0)))
        metric_global_dir = length_maha * cos_angle / max(d_post, 1e-9)

        # the procedure metric, weighted by each region QDA's accuracy
        # where the classifier suite has run
        report_path = os.path.join(self._out_dir,
                                   "classification_report_regions.json")
        region_reports = None
        if os.path.exists(report_path):
            with open(report_path) as f:
                region_reports = json.load(f)

        affected = [a for a in PROCEDURES2ATTRIBUTES[procedure]
                    if a in mgr.latent_regions]
        metric_regions = 0.0
        region_metrics = {}
        for key in affected:
            lo, hi = mgr.latent_regions[key]
            d_pre_r = zoo.mahalanobis(z_pre[0, lo:hi], n_label, region=key)
            d_post_r = zoo.mahalanobis(z_post[0, lo:hi], n_label,
                                       region=key)
            w = region_reports[key]["accuracy"] if region_reports else 1.0
            metric_regions += w * ((d_pre_r - d_post_r) /
                                   max(d_post_r, 1e-9))

            rq = zoo.region_qdas[key]
            m_r, cov_r = rq.class_covariance(n_label)
            disp = z_post[0, lo:hi] - z_pre[0, lo:hi]
            ideal_r = m_r - z_pre[0, lo:hi]
            cos_r = float(disp @ ideal_r /
                          (np.linalg.norm(disp) * np.linalg.norm(ideal_r)
                           + 1e-12))
            len_r = float(np.sqrt(max(
                disp @ QDAClassifier._solve_cov(cov_r, disp), 0.0)))
            region_metrics[key] = {
                "metric_distances": (d_pre_r - d_post_r) /
                max(d_post_r, 1e-9),
                "metric_with_angle": len_r * cos_r / max(d_post_r, 1e-9),
            }
        metric_regions /= max(len(affected), 1)

        return {"pre_class": pre_class, "post_class": post_class,
                "global_metric": metric_global,
                "global_metric_l2": metric_global_l2,
                "global_metric_directional": metric_global_dir,
                "procedure_metric": metric_regions,
                "region_metrics": region_metrics}

    def _project_pre_post_pair(self, z_pre, z_post, patient_id) -> None:
        """The pre → post displacement as an arrow on the KDE embedding
        figure, ``pre_post_eval_plots/<patient>_displacement.svg`` (JAX
        ``:1042-1069``)."""
        state = self._figure_state("lda_emb_distributions")
        if state is None:
            return
        mgr = self._manager
        pre = np.asarray(mgr.lda_project_latents_in_2d(z_pre))
        post = np.asarray(mgr.lda_project_latents_in_2d(z_post))
        fig, ax = plots.distribution_figure(state)
        ax.scatter(pre[:, 0], pre[:, 1], plots.OVERLAY_COLOUR, 12)
        ax.scatter(post[:, 0], post[:, 1], "#81a7e8", 12)
        plots.plot_2d_arrow(pre[0], post[0], ax)
        os.makedirs(os.path.join(self._out_dir, "pre_post_eval_plots"),
                    exist_ok=True)
        self._save_figure(os.path.join("pre_post_eval_plots",
                                       f"{patient_id}_displacement.svg"),
                          fig, {"pre": pre, "post": post})

    def evaluate_all_pre_post_pairs_in_excel(self, pairs_root,
                                             pairs_excel_path) -> dict:
        """Every pair of a CSV table (columns ``PID``, ``Pre name``,
        ``Post name``, ``Surgery regions``, optional ``Procedure`` and
        ``Syndrome``) evaluated, written to ``pre_post_eval_plots/
        <table>_with_results.csv`` with the boxplots of the region metrics
        (``region_metrics_distances.svg``, and
        ``region_metrics_with_angles_<syndrome>.svg`` for Apert and
        Crouzon; reference test.py:906-970). Returns the rows and the
        region metrics. An ``.xlsx`` table raises: export it as CSV."""
        if not pairs_excel_path.lower().endswith(".csv"):
            raise ValueError(
                f"{pairs_excel_path}: the pair table is read as CSV only "
                "(no spreadsheet reader here); export the sheet as CSV")
        with open(pairs_excel_path, newline="") as f:
            reader = csv.DictReader(f)
            columns = list(reader.fieldnames or [])
            table = [dict(r) for r in reader]
        out_dir = os.path.join(self._out_dir, "pre_post_eval_plots")
        os.makedirs(out_dir, exist_ok=True)

        region_rows, region_rows_a = [], []
        for row in table:
            metrics = self.evaluate_pre_post_pair(
                os.path.join(pairs_root, row["Pre name"]),
                os.path.join(pairs_root, row["Post name"]),
                str(row["PID"]), row["Surgery regions"])
            region_metrics = metrics.pop("region_metrics")
            rr = {"Procedure": row.get("Procedure")}
            rra = {"Procedure": row.get("Procedure"),
                   "Syndrome": row.get("Syndrome")}
            for k, m in region_metrics.items():
                name = COLOUR2ATTRIBUTE.get(k, k)
                rr[name] = m["metric_distances"]
                rra[name] = m["metric_with_angle"]
            region_rows.append(rr)
            region_rows_a.append(rra)
            for k, v in metrics.items():
                if k not in columns:
                    columns.append(k)
                row[k] = str(v) if isinstance(v, list) else v

        write_table_csv(os.path.join(
            out_dir, os.path.basename(pairs_excel_path).rsplit(".", 1)[0]
            + "_with_results.csv"), table, columns)
        self._save_figure(os.path.join("pre_post_eval_plots",
                                       "region_metrics_distances.svg"),
                          plots.boxplot_figure(region_rows)[0], region_rows)
        for syndrome in ("Apert", "Crouzon"):
            sub = [r for r in region_rows_a
                   if str(r.get("Syndrome")).lower() == syndrome.lower()]
            if sub:
                self._save_figure(os.path.join(
                    "pre_post_eval_plots",
                    f"region_metrics_with_angles_{syndrome.lower()}.svg"),
                    plots.boxplot_figure(sub)[0], sub)
        return {"rows": table, "region_metrics": region_rows,
                "region_metrics_with_angles": region_rows_a}

    def compute_and_save_postop_mesh_colourmap(self, pre_path, post_path,
                                               out_name="postop_displacement"):
        """The post-op mesh coloured by its displacement from the pre-op
        one, as a PLY (reference test.py:1138-1151)."""
        from ..viz.colors import errors_to_colors

        pre = read_mesh(pre_path).vertices.astype(np.float32)
        post = read_mesh(post_path).vertices.astype(np.float32)
        disp = np.asarray(self._manager.compute_vertex_errors(
            post[None], pre[None]))[0]
        cols = errors_to_colors(disp, 0, disp.max() or 1.0, "plasma")
        rgba = np.concatenate(
            [cols, np.full((len(cols), 1), 255, np.uint8)], axis=1)
        write_ply(os.path.join(self._out_dir, out_name + ".ply"), post,
                  self._manager.template.face, rgba)

    # ------------------------------------------------------------------
    # diagnostic saliency
    def _first_test_meshes(self, n_meshes: int) -> np.ndarray:
        raws = []
        for batch in self._test_iter:
            raws.append(self._unnormalize(_numpy(batch["x"]).astype(
                np.float32)))
            if sum(len(r) for r in raws) >= n_meshes:
                break
        return np.concatenate(raws, axis=0)[:n_meshes].astype(np.float32)

    def saliency_maps(self, n_meshes=4, healthy_class="n",
                      save_artifacts=True) -> list:
        """Gradient attribution of the QDA diagnosis onto the scan surface
        for the first test meshes (``analysis/saliency.py``): writes
        ``saliency/<i>_saliency.ply`` (plasma per-vertex colours),
        ``saliency/saliency_maps.png`` (shadeless renders on a shared
        scale) and ``saliency/report.json``; returns the reports."""
        from ..viz.colors import errors_to_colors
        from .saliency import make_saliency_fn, region_attribution

        mgr = self._manager
        if mgr.classifiers is None or mgr.classifiers.qda is None:
            raise RuntimeError("saliency_maps needs the fitted QDA head")
        qda = mgr.classifiers.qda
        raw = self._first_test_meshes(n_meshes)
        fn = make_saliency_fn(mgr, self._norm if self._normalized else None,
                              qda, mgr.class2idx(healthy_class))
        sal, margin, pred, ref, _, _ = [
            _numpy(r) for r in fn(torch.as_tensor(raw, device=mgr.device))]
        qda_classes = np.asarray(qda.classes)
        out_dir = os.path.join(self._out_dir, "saliency")
        if save_artifacts:
            os.makedirs(out_dir, exist_ok=True)
        reports = []
        for i in range(len(raw)):
            reports.append({
                "mesh": i,
                "label": mgr.idx2class(int(qda_classes[pred[i]])),
                "reference_class": mgr.idx2class(int(qda_classes[ref[i]])),
                "margin_nats": float(margin[i]),
                "regions": region_attribution(sal[i], mgr.template),
            })
            if save_artifacts:
                cols = errors_to_colors(sal[i], 0, sal[i].max() or 1.0,
                                        "plasma")
                rgba = np.concatenate(
                    [cols, np.full((len(cols), 1), 255, np.uint8)], axis=1)
                write_ply(os.path.join(out_dir, f"{i}_saliency.ply"),
                          raw[i], mgr.template.face, rgba)
        self.last_saliency = sal
        if save_artifacts:
            grid = make_image_grid(
                self._render(raw, sal, float(sal.max()) or 1.0), nrow=4)
            write_png(os.path.join(out_dir, "saliency_maps.png"), grid)
            with open(os.path.join(out_dir, "report.json"), "w") as f:
                json.dump(reports, f, indent=1)
        return reports

    # ------------------------------------------------------------------
    # diagnosis uncertainty
    def diagnosis_uncertainty(self, n_meshes=8, n_samples=64, seed=0,
                              agreement_threshold=0.9,
                              save_artifacts=True, eps=None) -> list:
        """Posterior-sampling uncertainty of the QDA diagnosis for the
        first test meshes (``analysis/uncertainty.py``; VAE runs only):
        each report carries the point label, the share of samples that
        agree with it, the votes, the posterior mean and std, the
        predictive entropy, and ``flagged`` below
        ``agreement_threshold``. The draws come from ``seed`` (row i from
        its own generator); ``eps [n_meshes, n_samples, Z]`` replaces
        them. Writes ``uncertainty/report.json``."""
        from .uncertainty import make_uncertainty_fn, summarize_uncertainty

        mgr = self._manager
        if mgr.classifiers is None or mgr.classifiers.qda is None:
            raise RuntimeError(
                "diagnosis_uncertainty needs the fitted QDA head")
        qda = mgr.classifiers.qda
        raw = self._first_test_meshes(n_meshes)
        fn = make_uncertainty_fn(
            mgr, self._norm if self._normalized else None, qda,
            int(n_samples))
        with torch.no_grad():
            _, lp_mu, sample_lp, sample_pred, _ = [
                _numpy(r) for r in fn(torch.as_tensor(raw, device=mgr.device),
                                      seed=int(seed), eps=eps)]
        reports = summarize_uncertainty(lp_mu, sample_lp, sample_pred,
                                        qda.classes, mgr._idx2class_dict)
        for i, rep in enumerate(reports):
            rep["mesh"] = i
            rep["flagged"] = rep["label_agreement"] < agreement_threshold
        if save_artifacts:
            out_dir = os.path.join(self._out_dir, "uncertainty")
            os.makedirs(out_dir, exist_ok=True)
            with open(os.path.join(out_dir, "report.json"), "w") as f:
                json.dump(reports, f, indent=1)
        return reports

    # ------------------------------------------------------------------
    # mesh fitting (reference test.py:336-520)
    def fit_mesh(self, mesh_path, landmarks, lr=5e-3, iterations=250,
                 n_restarts=16, seed=0, save_artifacts=False):
        """Fit a latent to an unregistered scan: Procrustes landmark
        alignment, then Adam over ``n_restarts`` latents minimizing
        10·landmark MSE + chamfer (K8), the best one classified.

        ``landmarks``: ``[K, 3]`` or a path to the reference's landmark
        JSON (``[{'x':..,'y':..,'z':..}, ...]``), matching
        ``template_landmarks_idx``. ``save_artifacts`` writes
        ``fit/<scan>_fit.ply``, ``fit/<scan>_aligned.ply`` and
        ``fit/<scan>_fit.json``."""
        from .fitting import fit_latent

        scan_mesh = read_mesh(mesh_path)
        mgr = self._manager
        if isinstance(landmarks, str):
            with open(landmarks) as f:
                pts = json.load(f)
            landmarks = np.asarray([[p["x"], p["y"], p["z"]] for p in pts])

        result = fit_latent(
            mgr, self._norm if self._normalized else None,
            scan_mesh.vertices, landmarks, self.template_landmarks_idx,
            lr=lr, iterations=iterations, n_restarts=n_restarts, seed=seed,
            z_anchor=np.asarray(self.latent_stats["means"], np.float32))
        gen, aligned = result["vertices"], result["aligned_scan"]
        z_best = result["z"]
        if mgr.classifiers is not None and mgr.classifiers.qda is not None:
            result["pred_class"] = mgr.classify_latent(
                z_best[None], "qda")
            region_preds = {}
            for key, (lo, hi) in mgr.latent_regions.items():
                if mgr.classifiers.region_qdas:
                    p = mgr.classifiers.region_qdas[key].predict(
                        z_best[None, lo:hi])
                    region_preds[COLOUR2ATTRIBUTE.get(key, key)] = \
                        mgr.idx2class(p)
            result["region_pred_classes"] = region_preds
        if save_artifacts:
            fit_dir = os.path.join(self._out_dir, "fit")
            os.makedirs(fit_dir, exist_ok=True)
            base = os.path.splitext(os.path.basename(mesh_path))[0]
            fit_path = os.path.join(fit_dir, f"{base}_fit.ply")
            aligned_path = os.path.join(fit_dir, f"{base}_aligned.ply")
            write_ply(fit_path, gen, mgr.template.face)
            write_ply(aligned_path, aligned, scan_mesh.faces)
            scalars = {k: v for k, v in result.items()
                       if isinstance(v, (int, float, str, list, dict))}
            with open(os.path.join(fit_dir, f"{base}_fit.json"),
                      "w") as f:
                json.dump(scalars, f, indent=1, default=str)
            result["artifacts"] = [fit_path, aligned_path]
        return result


def write_table_csv(path: str, rows: list, columns: list | None = None
                    ) -> str:
    """Rows of dicts as CSV in ``pandas.DataFrame(rows).to_csv(path)``'s
    layout: an unnamed index column first, then ``columns`` (default: the
    keys in first-seen order); a missing cell is empty, a float its
    ``repr``."""
    if columns is None:
        columns = []
        for r in rows:
            columns += [k for k in r if k not in columns]
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow([""] + list(columns))
        for i, r in enumerate(rows):
            w.writerow([i] + ["" if r.get(c) is None else r[c]
                              for c in columns])
    return path

"""The parts of the evaluation harness that serving and training need
(counterpart of ``analysis/tester.py:39-42, 51-110``): the template's
clinical landmark indices and the latent statistics. The ``Tester`` and
its experiments are not ported yet (ROADMAP 1.10).
"""

from __future__ import annotations

import os
import pickle

import numpy as np

__all__ = ["TEMPLATE_LANDMARKS_IDX", "compute_latent_stats"]

# 20 hand-picked facial landmark vertex ids on the 17,039-vertex
# craniofacial template (reference test.py:52-55): a property of that
# template asset. On another template keep the ids below its vertex count.
TEMPLATE_LANDMARKS_IDX = [14336, 14250, 13087, 13145, 4134,
                          871, 4166, 303, 15614, 7166,
                          3904, 16465, 9246, 4643, 10122,
                          4548, 2893, 2985, 830, 2004]

_STATS = ("means", "stds", "mins", "maxs")


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

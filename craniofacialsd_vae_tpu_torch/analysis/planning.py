"""Surgical-planning latent math (counterpart of ``analysis/planning.py``;
the reference's test.py:652-748), shared by the serving path's ``plan``.

Walk a patient latent toward the healthy-class QDA Gaussian, locate the
3/2/1-std crossings by negative-log-pdf thresholds, and build
per-procedure walks where only the latent slices of the procedure's
affected regions move. Host numpy: the path's log-pdf is one factorized
solve over the whole ``[n_linspace, D]`` difference matrix.
"""

from __future__ import annotations

import numpy as np

from ..geometry.template import PROCEDURES2ATTRIBUTES
from .classifiers import QDAClassifier


def vector_linspace(start, finish, steps: int) -> np.ndarray:
    """Row-wise linspace between two vectors → [steps, D]
    (reference test.py vector_linspace analog)."""
    start = np.asarray(start).reshape(-1)
    finish = np.asarray(finish).reshape(-1)
    t = np.linspace(0.0, 1.0, steps)[:, None]
    return (start[None] + t * (finish - start)[None]).astype(np.float32)


def healthy_gaussian(qda, healthy_class_idx: int):
    """(mean, covariance) of the QDA class Gaussian for a fitted class
    index — ``QDAClassifier.class_covariance``, which also handles heads
    imported from ``store_covariance=False`` sklearn pickles (reference
    model_manager.py:492-495 always stores it; migrated run dirs may
    not)."""
    return qda.class_covariance(healthy_class_idx)


def plan_to_healthy(z_p: np.ndarray, mean_h: np.ndarray,
                    cov_h: np.ndarray, latent_regions: dict,
                    n_p_to_3std: int = 8, n_linspace: int = 5000) -> dict:
    """Plan surgery in latent space (reference test.py:652-748).

    Walks ``n_linspace`` points from the patient latent ``z_p`` to the
    healthy mean and finds the first points whose negative log-pdf under
    the healthy Gaussian falls below the 3/2/1-std thresholds (thresholds
    evaluated on the centered, diagonalized reference distribution, like
    the reference's eigendecomposed-covariance form).

    Returns a dict with:
      - ``z_patient`` / ``z_mean_target`` / ``z_3std`` / ``z_2std`` /
        ``z_1std``: the key latents [D]
      - ``all_attributes``: [n_p_to_3std + 3, D] interpolation path
        (patient → 3-std crossing, then the 2/1-std crossings and mean)
      - ``procedures``: {procedure: [n_p_to_3std + 3, D]} walks where only
        the affected regions' latent slices move
      - ``procedure_distances``: per-procedure mean-squared latent
        distance to the healthy mean at the 3/2/1-std and mean stops
        (the reference's ``procedure_distances.csv`` rows)
    """
    n_p_to_3std = int(n_p_to_3std)
    n_linspace = int(n_linspace)
    if n_p_to_3std < 2:
        raise ValueError(
            f"n_p_to_3std must be >= 2, got {n_p_to_3std}: the patient→"
            "3-std walk must contain both endpoints (its last row is the "
            "3-std stop the distance table reads)")
    if n_linspace < 2:
        raise ValueError(f"n_linspace must be >= 2, got {n_linspace}")
    z_p = np.asarray(z_p, np.float32).reshape(-1)
    mean_h = np.asarray(mean_h)
    cov_h = np.asarray(cov_h)
    d = len(mean_h)

    # negative log-pdf of the healthy Gaussian along the walk — one
    # factorized solve for all points (values match the per-point form)
    logdet = float(np.linalg.slogdet(cov_h)[1])
    const = 0.5 * (d * np.log(2 * np.pi) + logdet)
    z_interp_full = vector_linspace(z_p, mean_h, n_linspace)
    diff = z_interp_full - mean_h                       # [n, D]
    sol = QDAClassifier._solve_cov(cov_h, diff.T)       # [D, n]
    pdf_path = const + 0.5 * np.einsum("nd,dn->n", diff, sol)

    # thresholds at k std of the centered diagonalized distribution;
    # eigenvalues clipped for rank-deficient covariances (tiny datasets)
    eigval = np.linalg.eigvalsh(cov_h)
    ref_logdet = float(np.sum(np.log(np.maximum(eigval, 1e-12))))
    ref_const = 0.5 * (d * np.log(2 * np.pi) + ref_logdet)
    targets = {}
    for k in (3, 2, 1):
        hits = np.where(pdf_path <= ref_const + 0.5 * k ** 2)[0]
        targets[k] = z_interp_full[hits[0]] if len(hits) \
            else mean_h.astype(np.float32)

    out = {"z_patient": z_p, "z_mean_target": mean_h,
           "z_3std": targets[3], "z_2std": targets[2],
           "z_1std": targets[1]}

    # all-attributes path: dense walk to the 3-std crossing, then the
    # 2/1-std crossings and the healthy mean as single stops
    out["all_attributes"] = np.concatenate([
        vector_linspace(z_p, targets[3], n_p_to_3std),
        targets[2][None], targets[1][None],
        mean_h[None].astype(np.float32)], axis=0)

    # per-procedure walks: only the affected regions' slices move
    out["procedures"], out["procedure_distances"] = {}, []
    for proc, attributes in PROCEDURES2ATTRIBUTES.items():
        zp_grid = np.tile(z_p, (n_p_to_3std + 3, 1)).astype(np.float32)
        for attr in attributes:
            if attr not in latent_regions:
                continue
            lo, hi = latent_regions[attr]
            zp_grid[:n_p_to_3std, lo:hi] = vector_linspace(
                z_p[lo:hi], targets[3][lo:hi], n_p_to_3std)
            zp_grid[n_p_to_3std, lo:hi] = targets[2][lo:hi]
            zp_grid[n_p_to_3std + 1, lo:hi] = targets[1][lo:hi]
            zp_grid[n_p_to_3std + 2, lo:hi] = mean_h[lo:hi]
        out["procedures"][proc] = zp_grid
        out["procedure_distances"].append({
            "procedure": proc,
            "d3": float(np.mean((zp_grid[n_p_to_3std - 1] - mean_h) ** 2)),
            "d2": float(np.mean((zp_grid[n_p_to_3std] - mean_h) ** 2)),
            "d1": float(np.mean(
                (zp_grid[n_p_to_3std + 1] - mean_h) ** 2)),
            "dm": float(np.mean(
                (zp_grid[n_p_to_3std + 2] - mean_h) ** 2)),
        })
    return out

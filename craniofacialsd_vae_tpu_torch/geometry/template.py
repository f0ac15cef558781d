"""Template graph structures the training step needs (counterpart of the
``unique_edges`` and ``rw_laplacian_coo`` of ``geometry/template.py``),
numpy only."""

from __future__ import annotations

import numpy as np

__all__ = ["unique_edges", "rw_laplacian_coo"]


def unique_edges(faces: np.ndarray) -> np.ndarray:
    """[E, 2] unique undirected edges (i < j) from triangle faces."""
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                        faces[:, [2, 0]]], axis=0)
    e = np.sort(e, axis=1)
    return np.unique(e, axis=0)


def rw_laplacian_coo(num_vertices: int, edges: np.ndarray):
    """Random-walk-normalized Laplacian L = I - D^-1 A as COO arrays
    (rows, cols, vals) int32/int32/float32: off-diagonal entries
    -1/deg(row), diagonal 1."""
    src = np.concatenate([edges[:, 0], edges[:, 1]])
    dst = np.concatenate([edges[:, 1], edges[:, 0]])
    deg = np.bincount(src, minlength=num_vertices).astype(np.float64)
    inv_deg = np.where(deg > 0, 1.0 / np.maximum(deg, 1), 0.0)

    rows = np.concatenate([src, np.arange(num_vertices)])
    cols = np.concatenate([dst, np.arange(num_vertices)])
    vals = np.concatenate([-inv_deg[src], np.ones(num_vertices)])
    order = np.lexsort((cols, rows))
    return (rows[order].astype(np.int32), cols[order].astype(np.int32),
            vals[order].astype(np.float32))

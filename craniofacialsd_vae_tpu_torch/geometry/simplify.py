"""Quadric-error-metric mesh simplification + barycentric up-sampling.

One-time CPU preprocessing producing, per pooling level:
  * the simplified template mesh,
  * the down-sampling selection matrix (rows = kept vertices), and
  * the up-sampling barycentric matrix (3 nnz per fine vertex).

Counterpart of ``geometry/simplify.py`` (its numpy path), held equal to it
element by element by the tests.

Functionally equivalent to the reference (its
``mesh_simplification.py``) — classic lazy-heap QEM with collapse-into-endpoint,
optional region-size and edge-length cost weighting — but re-engineered:

  * vertex collapses tracked with a union-find instead of O(E) `np.place`
    scans per collapse (identical outcomes, orders of magnitude faster);
  * per-face plane quadrics from one batched SVD instead of a Python loop;
  * closest-point queries for the up-transform done with chunked vectorized
    point-triangle distances instead of trimesh/rtree.

Sparse matrices are returned as (rows, cols, vals, shape) COO tuples — the
static-index representation consumed by the pooling ops.
"""

from __future__ import annotations

import heapq
import math
from dataclasses import dataclass

import numpy as np

__all__ = ["SparseCOO", "simplify_mesh", "upsampling_transform",
           "simplification_hierarchy"]


@dataclass
class SparseCOO:
    rows: np.ndarray
    cols: np.ndarray
    vals: np.ndarray
    shape: tuple

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=np.float64)
        np.add.at(out, (self.rows, self.cols), self.vals)
        return out

    def matmul(self, dense: np.ndarray) -> np.ndarray:
        out = np.zeros((self.shape[0],) + dense.shape[1:],
                       dtype=np.result_type(self.vals, dense))
        np.add.at(out, self.rows, self.vals.reshape(
            (-1,) + (1,) * (dense.ndim - 1)) * dense[self.cols])
        return out


def vertex_quadrics(pos: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """[N, 4, 4] accumulated plane quadrics.

    Plane equations from the null space of the homogeneous corner matrix
    (batched SVD), normalized by the normal's length — numerically identical
    to the reference's per-face SVD loop (mesh_simplification.py:122-141) but
    in one LAPACK call. Accumulation runs in face-major order so float
    summation order matches too.
    """
    pos = np.asarray(pos, dtype=np.float64)
    corners = pos[faces]                                   # [F, 3, 3]
    homo = np.concatenate(
        [corners, np.ones((*corners.shape[:2], 1))], axis=2)  # [F, 3, 4]
    _, _, vt = np.linalg.svd(homo)
    eq = vt[:, -1, :]                                      # [F, 4]
    eq = eq / np.linalg.norm(eq[:, :3], axis=1, keepdims=True)
    face_quadrics = eq[:, :, None] * eq[:, None, :]        # [F, 4, 4]

    quadrics = np.zeros((pos.shape[0], 4, 4))
    flat_idx = faces.reshape(-1)                           # f0k0, f0k1, f0k2…
    np.add.at(quadrics, flat_idx, np.repeat(face_quadrics, 3, axis=0))
    return quadrics


def _collapse_cost(pos, quadrics, a, b, region_weights, edge_length_weighted):
    qsum = quadrics[a] + quadrics[b]
    p0 = np.append(pos[a], 1.0)
    p1 = np.append(pos[b], 1.0)
    d0 = float(p0 @ qsum @ p0)
    d1 = float(p1 @ qsum @ p1)
    cost = min(d0, d1)
    if edge_length_weighted:
        cost += float(np.linalg.norm(pos[a] - pos[b]))
    if region_weights is not None:
        cost *= (region_weights[a] + region_weights[b]) / 2
    return d0, d1, cost, qsum


def simplify_mesh(pos: np.ndarray, faces: np.ndarray, edges: np.ndarray,
                  sampling_factor: float,
                  region_weights: np.ndarray | None = None,
                  edge_length_weighted: bool = False):
    """Lazy-heap QEM edge collapse down to ceil(N / sampling_factor) vertices.

    Returns (new_faces [F',3] reindexed, down SparseCOO [N', N]).
    """
    pos = np.asarray(pos, dtype=np.float64)
    n = pos.shape[0]
    target = math.ceil(n / sampling_factor)
    quadrics = vertex_quadrics(pos, faces)

    parent = np.arange(n, dtype=np.int64)

    def find(v):
        root = v
        while parent[root] != root:
            root = parent[root]
        while parent[v] != root:
            parent[v], v = root, parent[v]
        return root

    heap = []
    e0 = edges[:, 0].copy()
    e1 = edges[:, 1].copy()
    for idx in range(len(edges)):
        _, _, cost, _ = _collapse_cost(pos, quadrics, e0[idx], e1[idx],
                                       region_weights, edge_length_weighted)
        heap.append((cost, idx))
    heapq.heapify(heap)

    verts_left = n
    while verts_left > target and heap:
        top_cost, idx = heapq.heappop(heap)
        a, b = find(e0[idx]), find(e1[idx])
        if a == b:
            continue
        d0, d1, cur_cost, qsum = _collapse_cost(
            pos, quadrics, a, b, region_weights, edge_length_weighted)
        if cur_cost > top_cost:
            # stale entry — reinsert with the up-to-date cost
            heapq.heappush(heap, (cur_cost, idx))
            continue
        keep, destroy = (a, b) if d0 < d1 else (b, a)
        parent[destroy] = keep
        quadrics[keep] = qsum
        verts_left -= 1

    roots = np.array([find(v) for v in range(n)], dtype=np.int64)
    collapsed = roots[faces]
    degenerate = (
        (collapsed[:, 0] == collapsed[:, 1]) |
        (collapsed[:, 1] == collapsed[:, 2]) |
        (collapsed[:, 2] == collapsed[:, 0]))
    collapsed = collapsed[~degenerate]

    verts_kept = np.unique(collapsed)
    remap = np.zeros(n, dtype=np.int64)
    remap[verts_kept] = np.arange(len(verts_kept))
    new_faces = remap[collapsed]

    down = SparseCOO(
        rows=np.arange(len(verts_kept), dtype=np.int32),
        cols=verts_kept.astype(np.int32),
        vals=np.ones(len(verts_kept), dtype=np.float32),
        shape=(len(verts_kept), n))
    return new_faces, down


def _point_triangle_closest(points: np.ndarray, tri: np.ndarray):
    """Vectorized closest point on triangles (Ericson, Real-Time Collision
    Detection §5.1.5). points [P,3], tri [T,3,3] → (dist2 [P,T])."""
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
    ab = b - a
    ac = c - a
    p = points[:, None, :]                       # [P,1,3]
    ap = p - a[None]                             # [P,T,3]

    d1 = np.einsum("tk,ptk->pt", ab, ap)
    d2 = np.einsum("tk,ptk->pt", ac, ap)
    bp = p - b[None]
    d3 = np.einsum("tk,ptk->pt", ab, bp)
    d4 = np.einsum("tk,ptk->pt", ac, bp)
    cp = p - c[None]
    d5 = np.einsum("tk,ptk->pt", ab, cp)
    d6 = np.einsum("tk,ptk->pt", ac, cp)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    # Barycentric candidates for the interior region
    denom = va + vb + vc
    v_in = np.where(denom != 0, vb / np.where(denom == 0, 1, denom), 0.0)
    w_in = np.where(denom != 0, vc / np.where(denom == 0, 1, denom), 0.0)

    # Region tests, resolved by priority exactly as in Ericson
    v_ab = np.where(d1 - d3 != 0, d1 / np.where(d1 - d3 == 0, 1, d1 - d3), 0)
    w_ac = np.where(d2 - d6 != 0, d2 / np.where(d2 - d6 == 0, 1, d2 - d6), 0)
    t_bc = np.where((d4 - d3) + (d5 - d6) != 0,
                    (d4 - d3) / np.where((d4 - d3) + (d5 - d6) == 0, 1,
                                         (d4 - d3) + (d5 - d6)), 0)

    # Start from interior solution, override by regions
    v = v_in
    w = w_in
    # edge BC region
    cond_bc = (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)
    v = np.where(cond_bc, 1 - t_bc, v)
    w = np.where(cond_bc, t_bc, w)
    # edge AC region
    cond_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    v = np.where(cond_ac, 0.0, v)
    w = np.where(cond_ac, np.clip(w_ac, 0, 1), w)
    # edge AB region
    cond_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    v = np.where(cond_ab, np.clip(v_ab, 0, 1), v)
    w = np.where(cond_ab, 0.0, w)
    # vertex regions (highest priority — applied last so they win overlaps)
    cond_a = (d1 <= 0) & (d2 <= 0)
    cond_b = (d3 >= 0) & (d4 <= d3)
    cond_c = (d6 >= 0) & (d5 <= d6)
    v = np.where(cond_a, 0.0, np.where(cond_b, 1.0, np.where(cond_c, 0.0, v)))
    w = np.where(cond_a, 0.0, np.where(cond_b, 0.0, np.where(cond_c, 1.0, w)))

    closest = a[None] + v[..., None] * ab[None] + w[..., None] * ac[None]
    diff = p - closest
    return np.einsum("ptk,ptk->pt", diff, diff)


def closest_faces(points: np.ndarray, tri_verts: np.ndarray,
                  chunk: int = 2048, k_candidates: int = 64) -> np.ndarray:
    """Index of the closest triangle for each point.

    Candidate pruning via a KDTree over triangle centroids, with an exact correctness
    bound: the true closest triangle t satisfies
    dist(p, centroid_t) <= dist(p, t) + r_t where r_t is t's circumradius
    bound, so any point whose best candidate distance exceeds
    (k-th centroid distance - max_r) falls back to brute force.
    """
    from scipy.spatial import cKDTree

    n_tri = len(tri_verts)
    if n_tri <= k_candidates * 2:
        out = np.empty(len(points), dtype=np.int64)
        for s in range(0, len(points), chunk):
            d2 = _point_triangle_closest(points[s:s + chunk], tri_verts)
            out[s:s + chunk] = np.argmin(d2, axis=1)
        return out

    centroids = tri_verts.mean(axis=1)
    max_r = np.linalg.norm(
        tri_verts - centroids[:, None, :], axis=2).max()
    kdt = cKDTree(centroids)
    out = np.empty(len(points), dtype=np.int64)
    needs_exact = []
    for s in range(0, len(points), chunk):
        pts = points[s:s + chunk]
        cd, cand = kdt.query(pts, k=k_candidates)      # [P,k]
        # exact distances on the candidate set only
        best_d2 = np.full(len(pts), np.inf)
        best_i = np.zeros(len(pts), dtype=np.int64)
        for j in range(k_candidates):
            tv = tri_verts[cand[:, j]]
            d2 = _point_triangle_pairwise(pts, tv)
            upd = d2 < best_d2
            best_d2 = np.where(upd, d2, best_d2)
            best_i = np.where(upd, cand[:, j], best_i)
        out[s:s + chunk] = best_i
        # bound check: anything outside the candidate ball can still win only
        # if kth centroid distance - max_r < best distance
        unsafe = np.sqrt(best_d2) > (cd[:, -1] - max_r)
        needs_exact.extend((s + np.where(unsafe)[0]).tolist())
    if needs_exact:
        idx = np.asarray(needs_exact)
        for s in range(0, len(idx), 512):
            sel = idx[s:s + 512]
            d2 = _point_triangle_closest(points[sel], tri_verts)
            out[sel] = np.argmin(d2, axis=1)
    return out


def _point_triangle_pairwise(points: np.ndarray, tri: np.ndarray):
    """Pairwise (not all-pairs) point-triangle squared distance:
    points [P,3] vs tri [P,3,3] → [P]. Same Ericson logic as
    _point_triangle_closest, one triangle per point."""
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
    ab = b - a
    ac = c - a
    ap = points - a
    d1 = np.einsum("pk,pk->p", ab, ap)
    d2_ = np.einsum("pk,pk->p", ac, ap)
    bp = points - b
    d3 = np.einsum("pk,pk->p", ab, bp)
    d4 = np.einsum("pk,pk->p", ac, bp)
    cp = points - c
    d5 = np.einsum("pk,pk->p", ab, cp)
    d6 = np.einsum("pk,pk->p", ac, cp)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2_ - d1 * d6
    vc = d1 * d4 - d3 * d2_

    denom = va + vb + vc
    v = np.where(denom != 0, vb / np.where(denom == 0, 1, denom), 0.0)
    w = np.where(denom != 0, vc / np.where(denom == 0, 1, denom), 0.0)

    t_bc = np.where((d4 - d3) + (d5 - d6) != 0,
                    (d4 - d3) / np.where((d4 - d3) + (d5 - d6) == 0, 1,
                                         (d4 - d3) + (d5 - d6)), 0)
    cond_bc = (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)
    v = np.where(cond_bc, 1 - t_bc, v)
    w = np.where(cond_bc, t_bc, w)
    w_ac = np.where(d2_ - d6 != 0, d2_ / np.where(d2_ - d6 == 0, 1, d2_ - d6), 0)
    cond_ac = (vb <= 0) & (d2_ >= 0) & (d6 <= 0)
    v = np.where(cond_ac, 0.0, v)
    w = np.where(cond_ac, np.clip(w_ac, 0, 1), w)
    v_ab = np.where(d1 - d3 != 0, d1 / np.where(d1 - d3 == 0, 1, d1 - d3), 0)
    cond_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    v = np.where(cond_ab, np.clip(v_ab, 0, 1), v)
    w = np.where(cond_ab, 0.0, w)
    cond_a = (d1 <= 0) & (d2_ <= 0)
    cond_b = (d3 >= 0) & (d4 <= d3)
    cond_c = (d6 >= 0) & (d5 <= d6)
    v = np.where(cond_a, 0.0, np.where(cond_b, 1.0, np.where(cond_c, 0.0, v)))
    w = np.where(cond_a, 0.0, np.where(cond_b, 0.0, np.where(cond_c, 1.0, w)))

    closest = a + v[:, None] * ab + w[:, None] * ac
    diff = points - closest
    return np.einsum("pk,pk->p", diff, diff)


def upsampling_transform(fine_pos: np.ndarray, coarse_pos: np.ndarray,
                         coarse_faces: np.ndarray) -> SparseCOO:
    """[N_fine, N_coarse] barycentric interpolation matrix, 3 nnz per row
    (W. Heidrich 2005 barycentric formula, as in reference
    mesh_simplification.py:214-247)."""
    fine_pos = np.asarray(fine_pos, dtype=np.float64)
    coarse_pos = np.asarray(coarse_pos, dtype=np.float64)
    tri_verts = coarse_pos[coarse_faces]                  # [T,3,3]
    face_ids = closest_faces(fine_pos, tri_verts)

    tris = coarse_faces[face_ids]                         # [P,3]
    tv = coarse_pos[tris]                                 # [P,3,3]
    u = tv[:, 1] - tv[:, 0]
    v = tv[:, 2] - tv[:, 0]
    nrm = np.cross(u, v)
    w = fine_pos - tv[:, 0]
    n_dot = np.einsum("pk,pk->p", nrm, nrm)
    gamma = np.einsum("pk,pk->p", np.cross(u, w), nrm) / n_dot
    beta = np.einsum("pk,pk->p", np.cross(w, v), nrm) / n_dot
    alpha = 1.0 - gamma - beta

    n_fine = len(fine_pos)
    rows = np.repeat(np.arange(n_fine, dtype=np.int32), 3)
    cols = tris.reshape(-1).astype(np.int32)
    vals = np.stack([alpha, beta, gamma], axis=1).reshape(-1)
    return SparseCOO(rows=rows, cols=cols, vals=vals.astype(np.float32),
                     shape=(n_fine, coarse_pos.shape[0]))


def simplification_hierarchy(template, sampling_factors,
                             region_weighted: bool = False):
    """Build the multi-level pooling hierarchy for a segmented template.

    For each factor: QEM-simplify the current level, derive the selection
    (down) and barycentric (up) transforms, carry vertex colors down, and
    re-extract the region segmentation on the coarse mesh (needed when
    region-weighted costs are requested at deeper levels). Analog of the
    reference's per-level MeshSimplifier loop (model_manager.py:176-209).

    Returns (low_res_templates, down_transforms, up_transforms).
    """
    from .template import template_from_mesh
    from .mesh_io import MeshData

    low_res, downs, ups = [], [], []
    cur = template
    for factor in sampling_factors:
        region_weights = None
        if region_weighted:
            region_weights = np.ones(cur.num_vertices)
            for key, fc in cur.feat_and_cont.items():
                idxs = np.asarray(fc["feature"] + fc["contour"],
                                  dtype=np.int64)
                region_weights[idxs] = 1.0 / max(len(idxs), 1)

        new_faces, down = simplify_mesh(
            cur.pos, cur.face, cur.edges, factor,
            region_weights=region_weights)
        new_pos = down.matmul(cur.pos.astype(np.float64))
        new_colors = None
        if cur.colors is not None:
            new_colors = cur.colors[down.cols.astype(np.int64)]
        up = upsampling_transform(cur.pos, new_pos, new_faces)

        cur = template_from_mesh(
            MeshData(vertices=new_pos, faces=new_faces,
                     vertex_colors=new_colors),
            with_regions=new_colors is not None)
        low_res.append(cur)
        downs.append(down)
        ups.append(up)
    return low_res, downs, ups

"""Synthetic meshes: the coloured octasphere template (counterpart of
``geometry/synthetic.py``), on which a whole run can be built where no
clinical template is at hand; meshes for the rasterizer's tests and the
card smoke run (a UV sphere and a mesh made to trip the z-buffer sweep's
culls); and the stand-ins for the full-resolution template's Laplacian
and region masks that a training run on a bundle without its template
takes."""

from __future__ import annotations

import numpy as np

from .mesh_io import MeshData
from .template import (COLOUR2ATTRIBUTE, Template, rw_laplacian_coo,
                       template_from_mesh)

__all__ = ["octasphere", "synthetic_template", "uv_sphere",
           "adversarial_mesh", "level0_positions", "standin_laplacian_coo",
           "standin_region_masks"]


def octasphere(subdivisions: int = 2):
    """(vertices [N,3], faces [F,3]) unit sphere from octahedron midpoint
    subdivision."""
    verts = [np.array(v, dtype=np.float64) for v in
             [[1, 0, 0], [-1, 0, 0], [0, 1, 0],
              [0, -1, 0], [0, 0, 1], [0, 0, -1]]]
    faces = [[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
             [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]]

    for _ in range(subdivisions):
        edge_mid = {}

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                m = (verts[a] + verts[b]) / 2
                m /= np.linalg.norm(m)
                edge_mid[key] = len(verts)
                verts.append(m)
            return edge_mid[key]

        new_faces = []
        for a, b, c in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            new_faces += [[a, ab, ca], [ab, b, bc], [ca, bc, c],
                          [ab, bc, ca]]
        faces = new_faces
    return np.asarray(verts), np.asarray(faces, dtype=np.int64)


def synthetic_template(subdivisions: int = 2,
                       n_regions: int = 5) -> Template:
    """A coloured octasphere Template with n_regions region colours drawn
    from the anatomical palette, partitioned by z-slabs cut at the
    quantiles of z (so regions are balanced bands). Subdivision 6 gives
    16,386 vertices and 32,768 faces."""
    verts, faces = octasphere(subdivisions)
    palette = [np.array([int(t) for t in key.strip("[]").split()],
                        dtype=np.uint8)
               for key in list(COLOUR2ATTRIBUTE.keys())[:n_regions]]
    z = verts[:, 2]
    qs = np.quantile(z, np.linspace(0, 1, n_regions + 1)[1:-1])
    region = np.searchsorted(qs, z)
    colors = np.stack([palette[r] for r in region])
    return template_from_mesh(
        MeshData(vertices=verts, faces=faces, vertex_colors=colors))


def uv_sphere(n_lat: int = 48, n_lon: int = 96):
    """Unit sphere: vertices [V, 3] float32, faces [F, 3] int64."""
    th = np.linspace(0, np.pi, n_lat + 1)[1:-1]
    ph = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    t, p = np.meshgrid(th, ph, indexing="ij")
    ring = np.stack([np.sin(t) * np.cos(p), np.cos(t),
                     np.sin(t) * np.sin(p)], -1).reshape(-1, 3)
    verts = np.concatenate([[[0, 1, 0]], ring, [[0, -1, 0]]])
    faces = []

    def idx(i, j):
        return 1 + i * n_lon + j % n_lon

    for j in range(n_lon):
        faces.append([0, idx(0, j + 1), idx(0, j)])
        faces.append([len(verts) - 1, idx(n_lat - 2, j),
                      idx(n_lat - 2, j + 1)])
    for i in range(n_lat - 2):
        for j in range(n_lon):
            faces.append([idx(i, j), idx(i, j + 1), idx(i + 1, j)])
            faces.append([idx(i + 1, j), idx(i, j + 1), idx(i + 1, j + 1)])
    return verts.astype(np.float32), np.asarray(faces, np.int64)


def adversarial_mesh(image_size: int = 256, seed: int = 0):
    """Camera-frame vertices [V, 3] float32 and faces [F, 3] int64 made to
    trip the sweep's culls: small triangles in view, slivers (1e-6 to
    1e-2 px thick) along pixel rows, columns and at random angles, corners
    near the camera plane and behind it, faces off screen, degenerate
    faces (repeated and collinear corners), a few large faces, and exact
    duplicates of in-view faces two blocks later (coplanar ties). Screen
    positions assume the renderer's 60° field of view."""
    rng = np.random.default_rng(seed)
    w = float(image_size)
    focal = 1.0 / np.tan(np.deg2rad(30.0))
    chunks = []

    def screen(px, py, depth):       # screen (px, py, depth) → camera
        zc = np.maximum(depth, 1e-6)
        return np.stack([(px / w - 0.5) * 2 * zc / focal,
                         -(py / w - 0.5) * 2 * zc / focal, -depth], -1)

    def corners(n, spread, lo=0.0, hi=w):
        c = rng.uniform(lo, hi, (n, 1, 2))
        return c + rng.normal(0, spread, (n, 3, 2))

    def depths(n):
        return rng.uniform(1.5, 4.0, (n, 1)) + rng.normal(0, 0.05, (n, 3))

    p = corners(400, 3.0)
    chunks.append(screen(p[..., 0], p[..., 1], depths(400)))      # in view
    n = 60                                    # slivers on rows and columns
    x0 = rng.uniform(-10, w, n)
    length = rng.uniform(2, 60, n)
    r = rng.integers(0, image_size, n) + 0.5
    thick = 10.0 ** rng.integers(-6, -1, n)
    along = np.stack([x0, x0 + length, x0 + length / 2], 1)
    across = np.stack([r, r, r + thick], 1)
    chunks.append(screen(along, across, depths(n)))
    chunks.append(screen(across, along, depths(n)))
    ang = rng.uniform(0, np.pi, n)                # slivers at any angle
    a = rng.uniform(0, w, (n, 2))
    u = np.stack([np.cos(ang), np.sin(ang)], 1)
    v = np.stack([-u[:, 1], u[:, 0]], 1)
    pts = np.stack([a, a + length[:, None] * u,
                    a + 0.5 * length[:, None] * u + thick[:, None] * v], 1)
    chunks.append(screen(pts[..., 0], pts[..., 1], depths(n)))
    cam = rng.uniform(-1, 1, (80, 3, 3))          # near and behind the camera
    cam[:40, :, 2] = -rng.uniform(1e-8, 1e-5, (40, 3))
    cam[40:, 0, 2] = rng.uniform(0.1, 2.0, 40)
    cam[40:, 1:, 2] = -rng.uniform(1.0, 3.0, (40, 2))
    chunks.append(cam)
    p = corners(40, 5.0, w + 20, w + 200)         # off screen
    chunks.append(screen(p[..., 0], -p[..., 1], depths(40)))
    p = corners(30, 4.0)                          # collinear corners
    p[:, 2] = 0.5 * (p[:, 0] + p[:, 1])
    chunks.append(screen(p[..., 0], p[..., 1], depths(30)))
    big = np.array([[[0, 0], [w, 0], [0, w]], [[w, w], [0, w], [w, 0]],
                    [[-w, 0.3 * w], [2 * w, 0.5 * w], [0.5 * w, 2 * w]]])
    chunks.append(screen(big[..., 0], big[..., 1],
                         np.array([[5.0, 5.0, 5.0], [5.0, 5.0, 5.0],
                                   [3.0, 6.0, 4.5]])))
    verts = np.concatenate(chunks).reshape(-1, 3).astype(np.float32)
    faces = np.arange(len(verts)).reshape(-1, 3)
    faces = np.concatenate([faces, [[0, 0, 1], [5, 5, 5], [3, 4, 3]]])
    filler = np.zeros((2 * 256, 3), np.int64)     # degenerate: [0, 0, 0]
    return verts, np.concatenate([faces, filler, faces[:400]]).astype(
        np.int64)


def level0_positions(bundle) -> np.ndarray:
    """[N_0, 3] float32 full-resolution positions interpolated from the
    first decimated level, ``up0 · lr0_pos`` (the bundle holds no level-0
    mesh)."""
    up = bundle.up[0]
    pos = bundle.lr_pos[0]
    out = np.zeros((up.shape[0], pos.shape[1]), np.float64)
    np.add.at(out, up.rows, up.vals[:, None] * pos[up.cols])
    return out.astype(np.float32)


def standin_laplacian_coo(spiral0: np.ndarray, ring: int = 6):
    """STAND-IN for the template's rw-Laplacian, which needs the level-0
    faces of ``template.ply``: ``rw_laplacian_coo`` over the unique
    undirected edges ``(v, spiral0[v, j])``, j = 1…``ring``. Positions
    1–6 of a level-0 spiral are its centre's first ring (on the 17,039-
    vertex fixture the relation is 97.6 % symmetric), so the graph is
    close to the mesh's one-ring graph. Returns (rows, cols, vals)."""
    spiral0 = np.asarray(spiral0)
    n = spiral0.shape[0]
    src = np.repeat(np.arange(n), ring)
    dst = spiral0[:, 1:ring + 1].reshape(-1)
    keep = src != dst
    edges = np.unique(np.sort(np.stack([src[keep], dst[keep]], 1), axis=1),
                      axis=0)
    return rw_laplacian_coo(n, edges)


def standin_region_masks(positions: np.ndarray,
                         n_regions: int = 15) -> np.ndarray:
    """STAND-IN for the template's region masks, which need the vertex
    colours of ``template.ply``: ``n_regions`` slabs of equal vertex count
    along z, cut at the quantiles of the positions' z as the JAX
    ``geometry/synthetic.py::synthetic_template`` cuts the octasphere.
    Returns [R, N] bool."""
    z = np.asarray(positions)[:, 2]
    qs = np.quantile(z, np.linspace(0, 1, n_regions + 1)[1:-1])
    region = np.searchsorted(qs, z)
    return region[None, :] == np.arange(n_regions)[:, None]

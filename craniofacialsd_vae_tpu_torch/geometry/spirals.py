"""SpiralNet++-style spiral index extraction, pure NumPy/Python.

Counterpart of ``geometry/spirals.py`` (its numpy path, which the JAX
package documents as bit-identical to its native one), held equal to it by
the tests.

The reference delegates one-ring circulation to the OpenMesh C++ halfedge
structure (its ``compute_spirals.py``). This is one-time CPU
preprocessing, so no native code is needed: we derive ordered one-rings
directly from triangle winding with a successor-map walk, then grow spirals
ring by ring exactly like SpiralNet++ (concentric rings concatenated, KDTree
fallback of nearest vertices when the walk stalls at boundaries, dilation by
subsampling).

Ring ordering matters: the spiral sequence determines which learned weight
multiplies which neighbor. By default rings come from geometry.halfedge's
OpenMesh-faithful construction (clockwise circulation from the
construction-determined outgoing halfedge), which reproduces the reference's
spiral tables bit-exactly (verified against demo_files/spirals.pkl). A
lighter-weight winding-based walker is kept for meshes where OpenMesh parity
is irrelevant.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree

from .halfedge import HalfedgeMesh

__all__ = ["ordered_one_rings", "extract_spirals"]


def ordered_one_rings(faces: np.ndarray, num_vertices: int,
                      reverse: bool = False) -> list:
    """Ordered one-ring neighbor list per vertex, derived from face winding.

    For each face (v, a, b) the wedge contributes the successor a->b around v.
    Walking the successor map yields the ring in winding order. Boundary
    vertices (open fans) start at the fan's boundary neighbor; interior
    vertices start at the first wedge seen in face order.
    """
    faces = np.asarray(faces, dtype=np.int64)
    succ = [dict() for _ in range(num_vertices)]   # a -> b around v
    first_nb = [-1] * num_vertices                 # first wedge start, face order
    for f in faces:
        for k in range(3):
            v, a, b = f[k], f[(k + 1) % 3], f[(k + 2) % 3]
            if reverse:
                a, b = b, a
            succ[v][a] = b
            if first_nb[v] < 0:
                first_nb[v] = a

    rings = []
    for v in range(num_vertices):
        s = succ[v]
        if not s:
            rings.append([])
            continue
        # Boundary start: a neighbor that is never a successor target.
        targets = set(s.values())
        starts = [a for a in s if a not in targets]
        start = starts[0] if starts else first_nb[v]
        ring = [start]
        seen = {start}
        cur = start
        while cur in s:
            cur = s[cur]
            if cur in seen:
                break
            ring.append(cur)
            seen.add(cur)
        # Non-manifold fans may leave unvisited wedges; append their walks.
        missing = [a for a in s if a not in seen]
        while missing:
            cur = missing[0]
            ring.append(cur)
            seen.add(cur)
            while cur in s:
                cur = s[cur]
                if cur in seen:
                    break
                ring.append(cur)
                seen.add(cur)
            missing = [a for a in s if a not in seen]
        rings.append(ring)
    return rings


def _next_ring(rings: list, last_ring: list, other: set) -> list:
    """Advance one concentric ring outward (reference compute_spirals.py:11-31
    semantics): for each vertex of the current ring, append its unvisited
    neighbors, split at the position where the current ring crosses."""
    res = []
    res_set = set()
    last = set(last_ring)

    def is_new(idx):
        return idx not in last and idx not in other and idx not in res_set

    for v1 in last_ring:
        ring = rings[v1]
        after_last_ring = False
        for v2 in ring:
            if after_last_ring and is_new(v2):
                res.append(v2)
                res_set.add(v2)
            if v2 in last:
                after_last_ring = True
        for v2 in ring:
            if v2 in last:
                break
            if is_new(v2):
                res.append(v2)
                res_set.add(v2)
    return res


def extract_spirals(faces: np.ndarray, vertices: np.ndarray,
                    seq_length: int, dilation: int = 1,
                    openmesh_order: bool = True) -> np.ndarray:
    """[N, seq_length] int spiral indices (reference compute_spirals.py:34-61).

    With openmesh_order=True (default) the one-ring circulation reproduces
    OpenMesh exactly, giving bit parity with the reference's spirals.pkl.
    """
    num_vertices = vertices.shape[0]
    if openmesh_order:
        hm = HalfedgeMesh.from_faces(faces, num_vertices)
        rings = [hm.vertex_ring(v) for v in range(num_vertices)]
    else:
        rings = ordered_one_rings(faces, num_vertices, reverse=True)
    kdt = None

    spirals = []
    for v in range(num_vertices):
        spiral = [v]
        spiral_set = {v}
        last_ring = list(rings[v])
        next_ring = _next_ring(rings, last_ring, spiral_set)
        spiral.extend(last_ring)
        spiral_set.update(last_ring)
        while len(spiral) + len(next_ring) < seq_length * dilation:
            if len(next_ring) == 0:
                break
            last_ring = next_ring
            next_ring = _next_ring(rings, last_ring, spiral_set)
            spiral.extend(last_ring)
            spiral_set.update(last_ring)
        if len(next_ring) > 0:
            spiral.extend(next_ring)
        else:
            # Boundary stall: fall back to Euclidean nearest neighbors.
            if kdt is None:
                kdt = cKDTree(vertices)
            _, nn = kdt.query(vertices[spiral[0]], k=seq_length * dilation)
            spiral = list(np.atleast_1d(nn))
        spirals.append(spiral[:seq_length * dilation][::dilation])
    return np.asarray(spirals, dtype=np.int64)

"""Minimal halfedge mesh with OpenMesh-compatible construction semantics.

Counterpart of ``geometry/halfedge.py``, held equal to it by the tests.

The reference's spiral preprocessing (its ``compute_spirals.py``)
circulates one-rings with OpenMesh (C++). The circulation *order* — which
neighbor a spiral starts from — is a function of OpenMesh's halfedge
construction: each vertex's outgoing-halfedge handle is assigned and adjusted
while faces are added, with the invariant that boundary vertices always point
at a boundary halfedge. To reproduce the reference's spiral tables exactly
(bit parity with demo_files/spirals.pkl), this module re-implements that
construction discipline: `add_face` follows the same edge-creation, boundary
re-linking, and outgoing-halfedge adjustment rules, and `vertex_ring` rotates
clockwise like OpenMesh's default vertex-vertex circulator.

One-time CPU preprocessing — plain Python is fine at 17k vertices (~1s).
"""

from __future__ import annotations

import numpy as np

__all__ = ["HalfedgeMesh"]

_INVALID = -1


class HalfedgeMesh:
    def __init__(self, num_vertices: int):
        self.nv = num_vertices
        # Halfedge arrays; pair i^1 is the opposite halfedge.
        self.to_v: list = []       # target vertex
        self.face: list = []       # incident face or -1 (boundary)
        self.next: list = []
        self.prev: list = []
        self.v_he: list = [_INVALID] * num_vertices   # outgoing halfedge
        self._he_map: dict = {}    # (from, to) -> halfedge id
        self.n_faces = 0

    # -- basic accessors ----------------------------------------------------
    def opposite(self, h: int) -> int:
        return h ^ 1

    def from_v(self, h: int) -> int:
        return self.to_v[h ^ 1]

    def is_boundary_he(self, h: int) -> bool:
        return self.face[h] == _INVALID

    def find_halfedge(self, a: int, b: int) -> int:
        return self._he_map.get((a, b), _INVALID)

    def is_boundary_vertex(self, v: int) -> bool:
        h = self.v_he[v]
        return h == _INVALID or self.is_boundary_he(h)

    def _new_edge(self, a: int, b: int) -> int:
        h = len(self.to_v)
        self.to_v.extend((b, a))
        self.face.extend((_INVALID, _INVALID))
        self.next.extend((_INVALID, _INVALID))
        self.prev.extend((_INVALID, _INVALID))
        self._he_map[(a, b)] = h
        self._he_map[(b, a)] = h + 1
        return h

    def _set_next(self, a: int, b: int) -> None:
        self.next[a] = b
        self.prev[b] = a

    def _adjust_outgoing_halfedge(self, v: int) -> None:
        """Rotate clockwise from the current handle; park on the first
        boundary outgoing halfedge found (OpenMesh invariant)."""
        start = self.v_he[v]
        if start == _INVALID:
            return
        h = start
        while True:
            if self.is_boundary_he(h):
                self.v_he[v] = h
                return
            h = self.next[h ^ 1]          # cw_rotated = next(opposite(h))
            if h == start:
                return

    # -- face insertion (OpenMesh PolyConnectivity::add_face semantics) -----
    def add_face(self, vs) -> bool:
        n = len(vs)
        he = [0] * n
        is_new = [False] * n
        needs_adjust = [False] * n

        for i in range(n):
            ii = (i + 1) % n
            if not self.is_boundary_vertex(vs[i]):
                return False  # non-manifold vertex; skip face like OpenMesh
            he[i] = self.find_halfedge(vs[i], vs[ii])
            is_new[i] = he[i] == _INVALID
            if not is_new[i] and not self.is_boundary_he(he[i]):
                return False  # complex edge

        # Re-link boundary patches when two consecutive old edges are not
        # yet chained.
        for i in range(n):
            ii = (i + 1) % n
            if not is_new[i] and not is_new[ii]:
                inner_prev, inner_next = he[i], he[ii]
                if self.next[inner_prev] != inner_next:
                    outer_prev = inner_next ^ 1
                    boundary_prev = outer_prev
                    while True:
                        boundary_prev = self.next[boundary_prev] ^ 1
                        if self.is_boundary_he(boundary_prev):
                            break
                    boundary_next = self.next[boundary_prev]
                    if boundary_prev == inner_prev:
                        return False  # patch re-linking failed
                    patch_start = self.next[inner_prev]
                    patch_end = self.prev[inner_next]
                    self._set_next(boundary_prev, patch_start)
                    self._set_next(patch_end, boundary_next)
                    self._set_next(inner_prev, inner_next)

        for i in range(n):
            if is_new[i]:
                he[i] = self._new_edge(vs[i], vs[(i + 1) % n])

        fh = self.n_faces
        self.n_faces += 1

        for i in range(n):
            ii = (i + 1) % n
            vh = vs[ii]
            inner_prev, inner_next = he[i], he[ii]
            case = (1 if is_new[i] else 0) | (2 if is_new[ii] else 0)
            if case:
                outer_prev = inner_next ^ 1
                outer_next = inner_prev ^ 1
                if case == 1:    # prev new, next old
                    boundary_prev = self.prev[inner_next]
                    self._set_next(boundary_prev, outer_next)
                    self.v_he[vh] = outer_next
                elif case == 2:  # next new, prev old
                    boundary_next = self.next[inner_prev]
                    self._set_next(outer_prev, boundary_next)
                    self.v_he[vh] = boundary_next
                else:            # both new
                    if self.v_he[vh] == _INVALID:
                        self.v_he[vh] = outer_next
                        self._set_next(outer_prev, outer_next)
                    else:
                        boundary_next = self.v_he[vh]
                        boundary_prev = self.prev[boundary_next]
                        self._set_next(boundary_prev, outer_next)
                        self._set_next(outer_prev, boundary_next)
                self._set_next(inner_prev, inner_next)
            else:
                needs_adjust[ii] = self.v_he[vh] == inner_next
            self.face[he[i]] = fh

        for i in range(n):
            if needs_adjust[i]:
                self._adjust_outgoing_halfedge(vs[i])
        return True

    # -- circulation ---------------------------------------------------------
    def vertex_ring(self, v: int) -> list:
        """One-ring neighbors in OpenMesh vertex-vertex circulator order
        (clockwise, starting at the outgoing-halfedge target)."""
        start = self.v_he[v]
        if start == _INVALID:
            return []
        ring = []
        h = start
        while True:
            ring.append(self.to_v[h])
            h = self.next[h ^ 1]          # clockwise rotation
            if h == start:
                break
        return ring

    @classmethod
    def from_faces(cls, faces: np.ndarray, num_vertices: int
                   ) -> "HalfedgeMesh":
        mesh = cls(num_vertices)
        for f in np.asarray(faces, dtype=np.int64):
            mesh.add_face([int(f[0]), int(f[1]), int(f[2])])
        return mesh

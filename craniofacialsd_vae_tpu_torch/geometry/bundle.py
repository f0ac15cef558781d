"""Template hierarchy bundle: the arrays of a cached ``geometry.npz``.

Counterpart of ``GeometryBundle`` and ``_load_bundle`` of
``geometry/precompute.py`` in the JAX package. The bundle holds per-level
positions, faces and colours of the decimated templates, the down/up
transforms as COO and the spiral tables, and, when it was built or read
with one, the full-resolution ``Template`` (``template``) and the
decimated levels as ``Template``s (``low_res_templates``). A bundle read
from a ``geometry.npz`` alone has ``template=None``: the training step's
Laplacian and region masks are then handed to
``SpiralGeometry.from_bundle`` (``geometry/synthetic.py`` has stand-ins).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from .mesh_io import MeshData
from .simplify import SparseCOO
from .template import Template, template_from_mesh

__all__ = ["SparseCOO", "GeometryBundle", "load_bundle"]


@dataclass
class GeometryBundle:
    """Level l of ``down``/``up``/``spirals`` maps between level l
    (``N_l`` vertices) and level l+1; ``lr_*[l]`` describe level l+1, the
    l-th decimated template (level 0 is the full-resolution template,
    whose mesh only ``template`` holds)."""
    lr_pos: list                  # [N_{l+1}, 3] float32
    lr_face: list                 # [F_{l+1}, 3] int64
    lr_colors: list               # [N_{l+1}, 4] uint8 or None
    down: list                    # SparseCOO [N_{l+1}, N_l]
    up: list                      # SparseCOO [N_l, N_{l+1}]
    spirals: list                 # [N_l, L] int, as stored
    template: Template | None = None
    low_res_templates: list | None = None     # Template per level

    @classmethod
    def from_templates(cls, template, low_res_templates, down, up,
                       spirals) -> "GeometryBundle":
        return cls(lr_pos=[t.pos for t in low_res_templates],
                   lr_face=[t.face for t in low_res_templates],
                   lr_colors=[t.colors for t in low_res_templates],
                   down=list(down), up=list(up), spirals=list(spirals),
                   template=template,
                   low_res_templates=list(low_res_templates))

    @property
    def n_levels(self) -> int:
        return len(self.down)

    @property
    def vertex_counts(self) -> list:
        return [int(self.spirals[0].shape[0])] + \
            [int(p.shape[0]) for p in self.lr_pos]


def load_bundle(path: str, template: Template | None = None
                ) -> GeometryBundle:
    """Read a bundle ``.npz`` (the JAX package's cache format) into numpy.
    With ``template``, the bundle carries it and each decimated level as a
    ``Template`` (regions re-extracted where the level has colours), as
    the JAX ``_load_bundle`` builds them."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"no geometry bundle at {path}")
    with np.load(path) as z:
        n_levels = int(z["n_levels"])
        pos, face, colors, downs, ups, spirals = [], [], [], [], [], []
        for l in range(n_levels):
            pos.append(z[f"lr{l}_pos"])
            face.append(z[f"lr{l}_face"])
            colors.append(z[f"lr{l}_colors"] if f"lr{l}_colors" in z.files
                          else None)
            for name, out in (("down", downs), ("up", ups)):
                out.append(SparseCOO(z[f"{name}{l}_rows"],
                                     z[f"{name}{l}_cols"],
                                     z[f"{name}{l}_vals"],
                                     tuple(int(s) for s in
                                           z[f"{name}{l}_shape"])))
            spirals.append(z[f"spiral{l}"])
    if template is None:
        return GeometryBundle(lr_pos=pos, lr_face=face, lr_colors=colors,
                              down=downs, up=ups, spirals=spirals)
    low_res = [template_from_mesh(MeshData(vertices=p, faces=f,
                                           vertex_colors=c),
                                  with_regions=c is not None)
               for p, f, c in zip(pos, face, colors)]
    return GeometryBundle.from_templates(template, low_res, downs, ups,
                                         spirals)

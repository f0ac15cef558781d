"""Cached geometry precomputation: the pooling hierarchy and the spiral
tables of a template (counterpart of ``geometry/precompute.py``).

The hierarchy and the spirals are computed once per template and cached
as a single ``geometry.npz`` of flat numpy arrays, the JAX package's
format, so a cache written by either package serves the other. The
reference's own ``transforms.pkl`` / ``spirals.pkl`` are imported where a
storage dir holds them (torch only; a shim stands in for
``torch_geometric``).
"""

from __future__ import annotations

import os

import numpy as np

from .bundle import GeometryBundle, load_bundle
from .mesh_io import MeshData
from .simplify import SparseCOO, simplification_hierarchy
from .spirals import extract_spirals
from .template import Template, template_from_mesh

__all__ = ["precompute_geometry", "load_or_compute_geometry",
           "save_bundle", "import_reference_transforms",
           "import_reference_spirals"]


def precompute_geometry(template: Template, sampling_factors,
                        spiral_lengths, spiral_dilations,
                        region_weighted: bool = False) -> GeometryBundle:
    low_res, downs, ups = simplification_hierarchy(
        template, sampling_factors, region_weighted=region_weighted)
    meshes = [template] + low_res
    spirals = [
        extract_spirals(meshes[i].face, meshes[i].pos,
                        spiral_lengths[i], spiral_dilations[i])
        for i in range(len(meshes) - 1)
    ]
    return GeometryBundle.from_templates(template, low_res, downs, ups,
                                         spirals)


def save_bundle(path: str, bundle: GeometryBundle) -> None:
    """Write the bundle's arrays as the JAX ``_save_bundle`` does."""
    arrays = {"n_levels": np.asarray(len(bundle.down))}
    for l, (pos, face, colors) in enumerate(zip(bundle.lr_pos, bundle.lr_face,
                                                bundle.lr_colors)):
        arrays[f"lr{l}_pos"] = pos
        arrays[f"lr{l}_face"] = face
        if colors is not None:
            arrays[f"lr{l}_colors"] = colors
    for l, (d, u, s) in enumerate(zip(bundle.down, bundle.up,
                                      bundle.spirals)):
        for name, m in (("down", d), ("up", u)):
            arrays[f"{name}{l}_rows"] = m.rows
            arrays[f"{name}{l}_cols"] = m.cols
            arrays[f"{name}{l}_vals"] = m.vals
            arrays[f"{name}{l}_shape"] = np.asarray(m.shape)
        arrays[f"spiral{l}"] = s
    np.savez_compressed(path, **arrays)


def load_or_compute_geometry(storage_dir: str, template: Template,
                             sampling_factors, spiral_lengths,
                             spiral_dilations,
                             region_weighted: bool = False,
                             cache_name: str = "geometry.npz"
                             ) -> GeometryBundle:
    """The cached bundle of ``storage_dir`` (read with ``template``), or
    the reference's pickles there, or a fresh precompute that is then
    cached."""
    os.makedirs(storage_dir, exist_ok=True)
    cache_path = os.path.join(storage_dir, cache_name)
    if os.path.exists(cache_path):
        return load_bundle(cache_path, template)

    ref_transforms = os.path.join(storage_dir, "transforms.pkl")
    ref_spirals = os.path.join(storage_dir, "spirals.pkl")
    if os.path.exists(ref_transforms) and os.path.exists(ref_spirals):
        low_res, downs, ups = import_reference_transforms(ref_transforms)
        spirals = import_reference_spirals(ref_spirals)
        # the pickles are the cache: nothing is written next to them
        return GeometryBundle.from_templates(template, low_res, downs, ups,
                                             spirals)
    bundle = precompute_geometry(template, sampling_factors,
                                 spiral_lengths, spiral_dilations,
                                 region_weighted=region_weighted)
    save_bundle(cache_path, bundle)
    return bundle


def _install_torch_geometric_shim():
    """Allow unpickling the reference's torch_geometric Data objects without
    torch_geometric installed."""
    import sys
    import types

    if "torch_geometric" in sys.modules:
        return

    class Data:
        def __init__(self, **kwargs):
            self.__dict__.update(kwargs)

    tg = types.ModuleType("torch_geometric")
    tgd = types.ModuleType("torch_geometric.data")
    tgdd = types.ModuleType("torch_geometric.data.data")
    tgd.Data = Data
    tgdd.Data = Data
    tg.data = tgd
    tgd.data = tgdd
    sys.modules["torch_geometric"] = tg
    sys.modules["torch_geometric.data"] = tgd
    sys.modules["torch_geometric.data.data"] = tgdd


def _torch_sparse_to_coo(t) -> SparseCOO:
    t = t.coalesce()
    idx = t.indices().numpy()
    return SparseCOO(rows=idx[0].astype(np.int32),
                     cols=idx[1].astype(np.int32),
                     vals=t.values().numpy().astype(np.float32),
                     shape=tuple(t.shape))


def import_reference_transforms(path: str):
    """Read the reference's transforms.pkl → (templates, downs, ups)."""
    import pickle

    _install_torch_geometric_shim()
    with open(path, "rb") as f:
        low_res, downs, ups = pickle.load(f)
    templates = []
    for t in low_res:
        colors = getattr(t, "colors", None)
        colors_np = colors.numpy().astype(np.uint8) \
            if colors is not None else None
        templates.append(template_from_mesh(
            MeshData(vertices=t.pos.numpy().astype(np.float64),
                     faces=t.face.numpy().T.astype(np.int64),
                     vertex_colors=colors_np),
            with_regions=colors_np is not None))
    return (templates,
            [_torch_sparse_to_coo(d) for d in downs],
            [_torch_sparse_to_coo(u) for u in ups])


def import_reference_spirals(path: str) -> list:
    """Read the reference's spirals.pkl → list of [N_l, L] int arrays."""
    import pickle

    _install_torch_geometric_shim()
    with open(path, "rb") as f:
        spirals = pickle.load(f)
    return [s.numpy().astype(np.int64) for s in spirals]

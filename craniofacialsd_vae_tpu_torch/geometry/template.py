"""Template mesh: region segmentation from vertex colors + graph operators
(counterpart of ``geometry/template.py``, held equal to it by the tests).

Mirrors the behavior of the reference loader (its ``utils.py:77-144``):
a colored PLY template is decomposed into 15 anatomical regions keyed by the
RGBA string of their vertex color; a vertex is "contour" when any one-ring
neighbor has a different color; tiny color islands (<3 feature vertices) are
merged into the dominant neighboring region. The random-walk-normalized graph
Laplacian L = I - D^-1 A is built as static COO index/value arrays — the
static representation the ELL builders consume (``ops/sparse.py``).

Region key *order* is significant: the latent space is partitioned into
contiguous per-region slices in dict-insertion order (reference
model_manager.py:232-238), so we reproduce the reference's first-seen-vertex
insertion order exactly.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field

import numpy as np

from .mesh_io import MeshData, read_mesh

__all__ = ["Template", "load_template", "template_from_mesh", "color_key",
           "extract_regions_from_colors", "unique_edges", "vertex_adjacency",
           "rw_laplacian_coo", "COLOUR2ATTRIBUTE", "PROCEDURES2ATTRIBUTES"]

# RGBA-string → anatomical region name (reference utils.py:45-61).
COLOUR2ATTRIBUTE = {
    "[232 129 166 255]": "upper lip",
    "[194 109  97 255]": "chin",
    "[133 169 172 255]": "nasolabial",
    "[237 109  93 255]": "nose",
    "[ 89  51 139 255]": "cheeks",
    "[245 158  40 255]": "zygomatic",
    "[ 26  81  82 255]": "eyes",
    "[164  78 123 255]": "jaw",
    "[238 206  74 255]": "supraorbital",
    "[ 18  78 129 255]": "neck",
    "[245 160 106 255]": "ears",
    "[116 192 194 255]": "frontal",
    "[ 90  97 115 255]": "occipital",
    "[164 184 207 255]": "temporal",
    "[219 203 190 255]": "parietal",
}

# Surgical procedure → list of affected region color keys
# (reference utils.py:24-43).
PROCEDURES2ATTRIBUTES = {
    "foar": ["[238 206  74 255]", "[116 192 194 255]", "[ 26  81  82 255]"],
    "genioplasty": ["[194 109  97 255]"],
    "le_fort_I": ["[232 129 166 255]", "[ 89  51 139 255]"],
    "le_fort_II": ["[232 129 166 255]", "[133 169 172 255]",
                   "[237 109  93 255]"],
    "le_fort_III": ["[232 129 166 255]", "[133 169 172 255]",
                    "[237 109  93 255]", "[ 89  51 139 255]",
                    "[245 158  40 255]", "[ 26  81  82 255]"],
    "mandibular_ost": ["[194 109  97 255]", "[164  78 123 255]"],
    "monobloc": ["[232 129 166 255]", "[133 169 172 255]",
                 "[237 109  93 255]", "[ 89  51 139 255]",
                 "[245 158  40 255]", "[ 26  81  82 255]",
                 "[238 206  74 255]", "[116 192 194 255]"],
    "box_ost": ["[133 169 172 255]", "[245 158  40 255]",
                "[ 26  81  82 255]", "[238 206  74 255]"],
    "rhinoplasty": ["[237 109  93 255]"],
    "zygomatic_ost": ["[ 89  51 139 255]", "[245 158  40 255]"],
    "calvarial": ["[ 90  97 115 255]", "[164 184 207 255]",
                  "[219 203 190 255]"],
}


def color_key(rgba: np.ndarray) -> str:
    """Format an RGBA row the way numpy prints an int array — the reference
    uses `str(vertex_color)` as the dict key, so keys look like
    '[232 129 166 255]' with numpy's space padding."""
    return str(np.array(rgba, dtype=np.int64))


def unique_edges(faces: np.ndarray) -> np.ndarray:
    """[E, 2] unique undirected edges (i < j) from triangle faces."""
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                        faces[:, [2, 0]]], axis=0)
    e = np.sort(e, axis=1)
    return np.unique(e, axis=0)


def vertex_adjacency(num_vertices: int, edges: np.ndarray) -> list:
    """One-ring neighbor lists (sorted index order) for each vertex."""
    neighbors = [[] for _ in range(num_vertices)]
    for a, b in edges:
        neighbors[a].append(b)
        neighbors[b].append(a)
    return [sorted(n) for n in neighbors]


def extract_regions_from_colors(colors: np.ndarray,
                                neighbors: list) -> dict:
    """Vertex-color → {region_key: {'feature': [...], 'contour': [...]}}.

    Semantics match reference utils.py:93-135: contour = any neighbor with a
    different color; regions with <3 feature vertices are dissolved, each of
    their vertices re-assigned (as both feature and contour) to the most
    common neighboring color.
    """
    colors = np.asarray(colors, dtype=np.int64)
    # one key a distinct colour (formatting each vertex's is slow)
    uniq, inverse = np.unique(colors, axis=0, return_inverse=True)
    ukeys = [color_key(c) for c in uniq]
    keys = [ukeys[i] for i in inverse.reshape(-1)]

    # Vectorized contour detection: vertex is contour iff any neighbor color
    # differs. Pack RGBA into a single int for fast comparison.
    packed = (colors[:, 0] << 24) + (colors[:, 1] << 16) + \
             (colors[:, 2] << 8) + colors[:, 3]

    features: dict = {}
    for index, key in enumerate(keys):
        if key not in features:
            features[key] = {"feature": [], "contour": []}
        ring = neighbors[index]
        is_contour = any(packed[r] != packed[index] for r in ring)
        if is_contour:
            features[key]["contour"].append(index)
        else:
            features[key]["feature"].append(index)

    # Dissolve tiny color islands into the dominant neighboring region.
    elem_to_remove = []
    for key, feat in features.items():
        if len(feat["feature"]) < 3:
            elem_to_remove.append(key)
            for idx in feat["feature"]:
                counts = Counter(keys[ri] for ri in neighbors[idx])
                most_common = counts.most_common(1)[0][0]
                if most_common == key:
                    break
                features[most_common]["feature"].append(idx)
                features[most_common]["contour"].append(idx)
    for e in elem_to_remove:
        features.pop(e, None)
    return features


def rw_laplacian_coo(num_vertices: int, edges: np.ndarray):
    """Random-walk-normalized Laplacian L = I - D^-1 A as COO arrays.

    Returns (rows, cols, vals) int32/int32/float32. Matches the layout of
    torch_geometric.utils.get_laplacian(normalization='rw') used by the
    reference (utils.py:88-89): off-diagonal entries -1/deg(row), diagonal 1.
    """
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


@dataclass
class Template:
    """The segmented template mesh plus derived graph structures."""
    pos: np.ndarray                     # [N, 3] float32
    face: np.ndarray                    # [F, 3] int64
    colors: np.ndarray | None           # [N, 4] uint8
    feat_and_cont: dict                 # region_key -> {feature, contour}
    edges: np.ndarray                   # [E, 2] unique undirected (i<j)
    laplacian: tuple                    # (rows, cols, vals) COO of rw-Laplacian
    neighbors: list = field(repr=False, default=None)

    @property
    def num_vertices(self) -> int:
        return self.pos.shape[0]

    @property
    def region_names(self) -> list:
        return list(self.feat_and_cont.keys())

    def region_vertex_mask(self, key: str) -> np.ndarray:
        """Boolean [N] mask over 'feature' vertices of a region — the index
        set swapped by the disentanglement batch transform."""
        mask = np.zeros(self.num_vertices, dtype=bool)
        mask[np.asarray(self.feat_and_cont[key]["feature"], dtype=np.int64)] \
            = True
        return mask

    def region_masks(self) -> np.ndarray:
        """[R, N] boolean masks for all regions, in region_names order."""
        return np.stack([self.region_vertex_mask(k)
                         for k in self.region_names])


def template_from_mesh(mesh: MeshData, with_regions: bool = True) -> Template:
    edges = unique_edges(mesh.faces)
    n = mesh.vertices.shape[0]
    neighbors = vertex_adjacency(n, edges)
    feat_and_cont = {}
    if with_regions and mesh.vertex_colors is not None:
        feat_and_cont = extract_regions_from_colors(
            mesh.vertex_colors, neighbors)
    return Template(
        pos=mesh.vertices.astype(np.float32),
        face=mesh.faces.astype(np.int64),
        colors=mesh.vertex_colors,
        feat_and_cont=feat_and_cont,
        edges=edges,
        laplacian=rw_laplacian_coo(n, edges),
        neighbors=neighbors,
    )


def load_template(mesh_path: str) -> Template:
    """Load the colored template PLY and derive regions + Laplacian
    (reference utils.py:77-90)."""
    return template_from_mesh(read_mesh(mesh_path))

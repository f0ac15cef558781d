"""The port's geometry pipeline against the JAX package's, element by
element, on the coloured octasphere ``synthetic_template(subdivisions=3,
n_regions=5)``: mesh I/O (PLY, binary and ASCII, and OBJ), the template
(region order, masks, Laplacian), the QEM hierarchy, the spirals, the
written ``geometry.npz`` and the bundle read back with its template, plus
one ``region_weighted=True`` hierarchy. The JAX package is held to its
numpy path (its native helpers are switched off), which it documents as
bit-identical to the native one."""

import os

import numpy as np
import pytest
import torch

from craniofacialsd_vae_tpu.geometry import mesh_io as jmesh_io
from craniofacialsd_vae_tpu.geometry import native as jnative
from craniofacialsd_vae_tpu.geometry import precompute as jprecompute
from craniofacialsd_vae_tpu.geometry import simplify as jsimplify
from craniofacialsd_vae_tpu.geometry import spirals as jspirals
from craniofacialsd_vae_tpu.geometry import synthetic as jsynthetic
from craniofacialsd_vae_tpu.geometry import template as jtemplate
from craniofacialsd_vae_tpu.geometry.halfedge import \
    HalfedgeMesh as JHalfedge
from craniofacialsd_vae_tpu_torch.geometry import (
    HalfedgeMesh, extract_spirals, load_bundle, load_or_compute_geometry,
    load_template, octasphere, read_mesh, simplification_hierarchy,
    synthetic_template, template_from_mesh, write_obj, write_ply)
from craniofacialsd_vae_tpu_torch.geometry import mesh_io, simplify, spirals
from craniofacialsd_vae_tpu_torch.geometry.mesh_io import MeshData
from craniofacialsd_vae_tpu_torch.models import SpiralGeometry

FACTORS = [4, 4]
LENGTHS = [9, 9]
DILATIONS = [1, 1]


@pytest.fixture(autouse=True)
def _jax_numpy_path(monkeypatch):
    monkeypatch.setattr(jnative, "is_available", lambda: False)


def _templates_equal(t, j):
    np.testing.assert_array_equal(t.pos, j.pos)
    np.testing.assert_array_equal(t.face, j.face)
    if j.colors is None:
        assert t.colors is None
    else:
        np.testing.assert_array_equal(t.colors, j.colors)
    assert list(t.feat_and_cont) == list(j.feat_and_cont)
    assert t.feat_and_cont == j.feat_and_cont
    np.testing.assert_array_equal(t.edges, j.edges)
    for a, b in zip(t.laplacian, j.laplacian):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert t.neighbors == j.neighbors
    if j.feat_and_cont:
        np.testing.assert_array_equal(t.region_masks(), j.region_masks())


def _coo_equal(t, j):
    for name in ("rows", "cols", "vals"):
        a, b = getattr(t, name), getattr(j, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b)
    assert tuple(int(s) for s in t.shape) == tuple(int(s) for s in j.shape)


@pytest.fixture(scope="module")
def hierarchies(tmp_path_factory):
    """Both packages' geometry caches of the octasphere, basic and
    region-weighted, each written through ``load_or_compute_geometry``."""
    jnative_avail = jnative.is_available
    jnative.is_available = lambda: False
    try:
        root = tmp_path_factory.mktemp("geom")
        out = {}
        for weighted in (False, True):
            tpl_t = synthetic_template(subdivisions=3, n_regions=5)
            tpl_j = jsynthetic.synthetic_template(subdivisions=3, n_regions=5)
            dirs = {k: str(root / f"{k}{int(weighted)}") for k in "tj"}
            b_t = load_or_compute_geometry(dirs["t"], tpl_t, FACTORS, LENGTHS,
                                           DILATIONS, region_weighted=weighted)
            b_j = jprecompute.load_or_compute_geometry(
                dirs["j"], tpl_j, FACTORS, LENGTHS, DILATIONS,
                region_weighted=weighted)
            out[weighted] = dict(tpl_t=tpl_t, tpl_j=tpl_j, b_t=b_t, b_j=b_j,
                                 dirs=dirs)
        return out
    finally:
        jnative.is_available = jnative_avail


# ------------------------------------------------------------------ I/O
def test_octasphere_equals_jax():
    for s in (0, 2, 3):
        v, f = octasphere(s)
        jv, jf = jsynthetic.octasphere(s)
        np.testing.assert_array_equal(v, jv)
        np.testing.assert_array_equal(f, jf)
    v, f = octasphere(6)
    assert v.shape == (16386, 3) and f.shape == (32768, 3)


@pytest.mark.parametrize("colors", [True, False])
@pytest.mark.parametrize("faces", [True, False])
def test_write_ply_bytes_and_read_equal_jax(tmp_path, colors, faces):
    tpl = synthetic_template(subdivisions=2, n_regions=3)
    args = (tpl.pos, tpl.face if faces else None,
            tpl.colors if colors else None)
    write_ply(str(tmp_path / "t.ply"), *args)
    jmesh_io.write_ply(str(tmp_path / "j.ply"), *args)
    with open(tmp_path / "t.ply", "rb") as f, \
            open(tmp_path / "j.ply", "rb") as g:
        assert f.read() == g.read()
    got, want = read_mesh(str(tmp_path / "t.ply")), \
        jmesh_io.read_mesh(str(tmp_path / "t.ply"))
    for name in ("vertices", "faces", "vertex_colors"):
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None)
        if b is not None:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_read_ascii_and_big_endian_ply_equal_jax(tmp_path):
    tpl = synthetic_template(subdivisions=1, n_regions=2)
    n, m = len(tpl.pos), len(tpl.face)
    lines = ["ply", "format ascii 1.0", "comment made by a test",
             f"element vertex {n}", "property float x", "property float y",
             "property float z", "property uchar red", "property uchar green",
             "property uchar blue", f"element face {m}",
             "property list uchar int vertex_indices", "end_header"]
    lines += [f"{p[0]} {p[1]} {p[2]} {c[0]} {c[1]} {c[2]}"
              for p, c in zip(tpl.pos, tpl.colors)]
    lines += [f"3 {a} {b} {c}" for a, b, c in tpl.face]
    path = str(tmp_path / "ascii.ply")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    head = ("ply\nformat binary_big_endian 1.0\n"
            f"element vertex {n}\nproperty double x\nproperty double y\n"
            "property double z\n"
            f"element face {m}\nproperty list uchar int vertex_indices\n"
            "end_header\n").encode()
    rec = np.dtype([("n", "u1"), ("idx", ">i4", (3,))])
    fbuf = np.empty(m, rec)
    fbuf["n"] = 3
    fbuf["idx"] = tpl.face
    big = str(tmp_path / "big.ply")
    with open(big, "wb") as f:
        f.write(head + tpl.pos.astype(">f8").tobytes() + fbuf.tobytes())
    for p in (path, big):
        got, want = read_mesh(p), jmesh_io.read_mesh(p)
        np.testing.assert_array_equal(got.vertices, want.vertices)
        np.testing.assert_array_equal(got.faces, want.faces)
        if want.vertex_colors is not None:
            np.testing.assert_array_equal(got.vertex_colors,
                                          want.vertex_colors)


def test_obj_round_trip_equals_jax(tmp_path):
    rng = np.random.default_rng(0)
    tpl = synthetic_template(subdivisions=2, n_regions=3)
    verts = tpl.pos + rng.normal(scale=0.01, size=tpl.pos.shape)
    write_obj(str(tmp_path / "t.obj"), verts, tpl.face)
    jmesh_io.write_obj(str(tmp_path / "j.obj"), verts, tpl.face)
    with open(tmp_path / "t.obj") as f, open(tmp_path / "j.obj") as g:
        assert f.read() == g.read()
    got = read_mesh(str(tmp_path / "t.obj"))
    want = jmesh_io.read_mesh(str(tmp_path / "t.obj"))
    np.testing.assert_array_equal(got.vertices, want.vertices)
    np.testing.assert_array_equal(got.faces, want.faces)
    with pytest.raises(ValueError):
        read_mesh(str(tmp_path / "t.stl"))


# -------------------------------------------------------------- template
@pytest.mark.parametrize("sub,regions", [(2, 3), (3, 5), (3, 15)])
def test_synthetic_template_equals_jax(sub, regions):
    _templates_equal(synthetic_template(sub, regions),
                     jsynthetic.synthetic_template(sub, regions))


def test_region_order_is_first_seen_colour_and_islands_dissolve():
    """A shuffled vertex order changes the region order exactly as it
    changes JAX's; a 2-vertex colour island is dissolved into its
    neighbours in both."""
    v, f = octasphere(2)
    rng = np.random.default_rng(3)
    perm = rng.permutation(len(v))
    inv = np.argsort(perm)
    base = synthetic_template(2, 4)
    colors = base.colors[perm].copy()
    colors[:2] = [9, 9, 9, 255]                    # a tiny island
    mesh = MeshData(vertices=v[perm], faces=inv[f], vertex_colors=colors)
    got = template_from_mesh(mesh)
    want = jtemplate.template_from_mesh(
        jmesh_io.MeshData(vertices=v[perm], faces=inv[f],
                          vertex_colors=colors))
    _templates_equal(got, want)
    assert "[  9   9   9 255]" not in got.feat_and_cont


def test_load_template_equals_jax(tmp_path):
    tpl = synthetic_template(3, 5)
    path = str(tmp_path / "template.ply")
    write_ply(path, tpl.pos, tpl.face, tpl.colors)
    _templates_equal(load_template(path), jtemplate.load_template(path))


# ------------------------------------------------------------- hierarchy
def test_halfedge_rings_equal_jax_on_an_open_mesh():
    """Vertex rings on a hemisphere (boundary vertices, re-linked boundary
    patches) and in face orders that add faces out of order."""
    v, f = octasphere(3)
    keep = f[np.all(v[f][..., 2] >= -0.2, axis=1)]
    rng = np.random.default_rng(1)
    for faces in (keep, keep[rng.permutation(len(keep))]):
        hm = HalfedgeMesh.from_faces(faces, len(v))
        jm = JHalfedge.from_faces(faces, len(v))
        assert [hm.vertex_ring(i) for i in range(len(v))] == \
            [jm.vertex_ring(i) for i in range(len(v))]
        assert hm.v_he == jm.v_he and hm.next == jm.next


@pytest.mark.parametrize("openmesh_order", [True, False])
def test_extract_spirals_equal_jax_on_an_open_mesh(openmesh_order):
    v, f = octasphere(3)
    keep = f[np.all(v[f][..., 2] >= 0.0, axis=1)]
    got = extract_spirals(keep, v, 12, 2, openmesh_order=openmesh_order)
    want = jspirals.extract_spirals(keep, v, 12, 2,
                                    openmesh_order=openmesh_order,
                                    use_native="never")
    np.testing.assert_array_equal(got, want)


def test_closest_faces_equal_jax():
    rng = np.random.default_rng(2)
    v, f = octasphere(3)
    pts = rng.normal(size=(700, 3)) * rng.uniform(0.5, 1.5, (700, 1))
    got = simplify.closest_faces(pts, v[f])
    want = jsimplify.closest_faces(pts, v[f], use_native="never")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("weighted", [False, True])
def test_hierarchy_tables_equal_jax(hierarchies, weighted):
    h = hierarchies[weighted]
    b_t, b_j = h["b_t"], h["b_j"]
    _templates_equal(b_t.template, b_j.template)
    assert len(b_t.low_res_templates) == len(FACTORS)
    for t, j in zip(b_t.low_res_templates, b_j.low_res_templates):
        _templates_equal(t, j)
    for d, jd in zip(b_t.down, b_j.down_transforms):
        _coo_equal(d, jd)
    for u, ju in zip(b_t.up, b_j.up_transforms):
        _coo_equal(u, ju)
    for s, js in zip(b_t.spirals, b_j.spirals):
        assert s.dtype == js.dtype
        np.testing.assert_array_equal(s, js)
    assert b_t.vertex_counts == b_j.vertex_counts


def test_weighting_changes_the_hierarchy(hierarchies):
    """The region-weighted case is a different collapse order, so the
    element-by-element test above covers a second path."""
    a, b = hierarchies[False]["b_t"], hierarchies[True]["b_t"]
    assert any(not np.array_equal(x.cols, y.cols)
               for x, y in zip(a.down, b.down))


def test_simplification_hierarchy_direct_equals_jax():
    tpl = synthetic_template(2, 3)
    jtpl = jsynthetic.synthetic_template(2, 3)
    low, downs, ups = simplification_hierarchy(tpl, [2, 3])
    jlow, jdowns, jups = jsimplify.simplification_hierarchy(jtpl, [2, 3])
    for t, j in zip(low, jlow):
        _templates_equal(t, j)
    for a, b in zip(downs + ups, jdowns + jups):
        _coo_equal(a, b)


@pytest.mark.parametrize("weighted", [False, True])
def test_written_geometry_npz_equals_jax(hierarchies, weighted):
    dirs = hierarchies[weighted]["dirs"]
    with np.load(os.path.join(dirs["t"], "geometry.npz")) as t, \
            np.load(os.path.join(dirs["j"], "geometry.npz")) as j:
        assert sorted(t.files) == sorted(j.files)
        for k in j.files:
            assert t[k].dtype == j[k].dtype, k
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)


def test_cache_read_back_equals_jax_and_crosses_packages(hierarchies):
    """Each package reads the other's cache, and the port's bundle read
    with its template carries the decimated levels as JAX builds them."""
    h = hierarchies[False]
    for d in h["dirs"].values():
        b_t = load_or_compute_geometry(d, h["tpl_t"], FACTORS, LENGTHS,
                                       DILATIONS)
        b_j = jprecompute.load_or_compute_geometry(d, h["tpl_j"], FACTORS,
                                                   LENGTHS, DILATIONS)
        for t, j in zip(b_t.low_res_templates, b_j.low_res_templates):
            _templates_equal(t, j)
        for a, b in zip(b_t.down + b_t.up,
                        b_j.down_transforms + b_j.up_transforms):
            _coo_equal(a, b)
    bare = load_bundle(os.path.join(h["dirs"]["t"], "geometry.npz"))
    assert bare.template is None and bare.low_res_templates is None


def test_spiral_geometry_takes_the_templates_laplacian_and_regions(
        hierarchies):
    """``from_bundle`` on a bundle with its template equals the same
    bundle without it given the template's Laplacian and masks, whose
    masks equal the JAX geometry's."""
    from craniofacialsd_vae_tpu.models import SpiralGeometry as JGeometry

    h = hierarchies[False]
    geom = SpiralGeometry.from_bundle(h["b_t"], device="cpu")
    bare = load_bundle(os.path.join(h["dirs"]["t"], "geometry.npz"))
    tpl = h["tpl_t"]
    given = SpiralGeometry.from_bundle(bare, device="cpu",
                                       laplacian=tpl.laplacian,
                                       region_masks=tpl.region_masks())
    for name in ("cols", "vals"):
        assert torch.equal(getattr(geom.laplacian, name),
                           getattr(given.laplacian, name))
    assert torch.equal(geom.region_masks, given.region_masks)
    jgeom = JGeometry.from_bundle(h["b_j"])
    np.testing.assert_array_equal(geom.region_masks.numpy(),
                                  np.asarray(jgeom.region_masks))
    assert SpiralGeometry.from_bundle(bare, device="cpu").laplacian is None


def test_port_geometry_modules_read_no_native_helpers():
    for mod in (mesh_io, simplify, spirals):
        with open(mod.__file__) as f:
            src = f.read()
        assert "import native" not in src and "use_native" not in src

"""Card tests of the port's CUDA kernels: each kernel against its plain
PyTorch twin on the same CUDA tensors, the wrappers' input checks and
launch counts, the service and the training step on the card against the
same on the host. Every test skips itself without a card.

This file imports no JAX, so it also runs where JAX is not installed::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from craniofacialsd_vae_tpu_torch import kernels, ops
from craniofacialsd_vae_tpu_torch.geometry import (adversarial_mesh,
                                                   level0_positions,
                                                   load_bundle,
                                                   standin_laplacian_coo,
                                                   standin_region_masks,
                                                   uv_sphere)
from craniofacialsd_vae_tpu_torch.models import (SDVAEConfig, SpiralGeometry,
                                                 init_sdvae)
from craniofacialsd_vae_tpu_torch.ops import sparse
from craniofacialsd_vae_tpu_torch.serving import DiagnosisService
from craniofacialsd_vae_tpu_torch.training import (LOSS_KEYS, LossWeights,
                                                   coupled_adam,
                                                   make_train_step)
from craniofacialsd_vae_tpu_torch.viz import raster
from craniofacialsd_vae_tpu_torch.viz.renderer import look_at_camera

pytestmark = pytest.mark.cuda

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "geometry.npz")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _gen(dev, seed):
    return torch.Generator(device=dev).manual_seed(seed)


@pytest.mark.parametrize("m,n,k,d,offset", [
    (500, 300, 3, 64, 0),       # float4 path
    (333, 90, 5, 48, 0),
    (200, 70, 4, 7, 0),         # D % 4 != 0: scalar path
    (100, 40, 3, 16, 1),        # unaligned x view: scalar path
])
def test_ell_matmul_kernel_equals_plain(m, n, k, d, offset):
    """Same products, rounded one by one in the same order: bit-equal."""
    dev = _card()
    g = _gen(dev, 0)
    cols = torch.randint(0, n, (m, k), generator=g, device=dev,
                         dtype=torch.int32)
    vals = torch.randn((m, k), generator=g, device=dev)
    vals[::7, -1] = 0.0                      # padding-like entries
    cols[::7, -1] = 0
    base = torch.randn(n * d + offset, generator=g, device=dev)
    x2 = base[offset:].view(n, d)
    out = kernels.ell_matmul_fwd(cols, vals, x2)
    ref = ops.ell_matmul_plain(cols, vals, x2)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


def _conv_matches_plain(dev, op, b, c_in, c_out, scale=1.0, seed=1,
                        tiles=True):
    """K1 against its plain twin on one table, through the op's vertex
    tiles as the model calls it (``tiles=False``: without them, the
    ``narrow_out`` kernel for C_out < 8): rtol 1e-5 against max |out|
    (3xTF32 products and another summation order than the library
    matmul's), and two launches bit-equal. Returns the plan."""
    g = _gen(dev, seed)
    x = torch.randn((op.n_src, b, c_in), generator=g, device=dev) * scale
    seq = op.seq_length
    w_l = torch.randn((seq, c_in, c_out), generator=g, device=dev) * 0.2
    bias = torch.randn(c_out, generator=g, device=dev) * scale
    t = op.tiles if tiles else None
    out = kernels.spiral_conv_fwd(x, op.table, w_l, bias, tiles=t)
    again = kernels.spiral_conv_fwd(x, op.table, w_l, bias, tiles=t)
    ref = ops.spiral_conv_plain(w_l, bias, x, op)
    torch.cuda.synchronize()
    assert out.shape == ref.shape
    err = float((out - ref).abs().max())
    assert err <= 1e-5 * float(ref.abs().max())
    assert torch.equal(out, again)
    return kernels.plan_spiral_conv(
        op.num_vertices, b, seq, c_in, c_out,
        n_tiles=op.tiles.n_tiles if tiles else 0,
        tile_rows=op.tiles.max_rows if tiles else 0)


@pytest.mark.parametrize("m,n_src,seq,b,c_in,c_out", [
    (4260, 17039, 9, 16, 3, 32),      # composed first encoder conv
    (1065, 1065, 9, 16, 64, 32),      # above 48 KB of shared memory
    (3000, 3000, 9, 16, 32, 3),       # final conv
    (700, 700, 5, 20, 16, 256),       # batch split across blocks
    (50, 80, 3, 1, 1, 1),
    (267, 267, 9, 16, 64, 64),        # C_out = 64 split across blocks
    (1001, 1500, 9, 16, 32, 32),      # M not a multiple of the tile
    (333, 333, 7, 3, 10, 18),         # 4-byte copies and stores
])
def test_spiral_conv_kernel_matches_plain(m, n_src, seq, b, c_in, c_out):
    dev = _card()
    rng = np.random.default_rng(m)
    table = rng.integers(0, n_src, size=(m, seq))
    if m == n_src:
        table[:, 0] = np.arange(m)
    op = ops.build_spiral_op(table, n_src=n_src).to(dev)
    plan = _conv_matches_plain(dev, op, b, c_in, c_out)
    if (m, c_in, c_out) == (1065, 64, 32):
        assert plan.smem > 48 * 1024     # launched after the opt-in
    if (m, c_out) == (267, 64):
        assert plan.grid[1] == 2
    if m == 1001:
        assert m % plan.tm != 0
    if c_out < 8:     # the tiled kernel at the final conv's shape
        assert plan.path == ("narrow_tile" if (seq, c_in) == (9, 32)
                             else "narrow_out")


@pytest.mark.parametrize("path", ["narrow_tile", "narrow_out"])
@pytest.mark.parametrize("c_out,b,n_src", [
    (1, 1, 3000), (2, 4, 3000), (3, 16, 3000), (4, 20, 3000), (5, 3, 4000),
    (6, 8, 3000), (7, 2, 4500), (3, 16, 17039)])
def test_spiral_conv_narrow_kernels_match_plain(path, c_out, b, n_src):
    """Both narrow kernels at every C_out below 8, batches of 1 to 20 rows
    (odd batch tiles) and tables composed with a selection (n_src ≠ M):
    the tiled kernel through the op's tiles, the other without them."""
    dev = _card()
    rng = np.random.default_rng(c_out)
    m = 3000
    table = rng.integers(0, n_src, size=(m, 9))
    if m == n_src:
        table[:, 0] = np.arange(m)
    op = ops.build_spiral_op(table, n_src=n_src).to(dev)
    plan = _conv_matches_plain(dev, op, b, 32, c_out,
                               tiles=path == "narrow_tile")
    assert plan.path == path


@pytest.fixture(scope="module")
def octasphere_level0():
    """The spiral op of the octasphere's level 0 (subdivision 6: 16,386
    vertices), the entry point's template."""
    from craniofacialsd_vae_tpu_torch.geometry import (extract_spirals,
                                                       octasphere)

    pos, face = octasphere(6)
    return ops.build_spiral_op(extract_spirals(np.asarray(face),
                                               np.asarray(pos), 9))


@pytest.mark.parametrize("b", [1, 4, 16])
def test_spiral_conv_narrow_tile_on_the_octasphere(octasphere_level0, b):
    dev = _card()
    op = octasphere_level0.to(dev)
    assert op.num_vertices == 16386
    plan = _conv_matches_plain(dev, op, b, 32, 3)
    assert plan.path == "narrow_tile" and plan.rows == op.tiles.max_rows


# the smoke model's convs on the fixture's tables: (name, C_in, C_out)
_SMOKE = [("enc0", 3, 32), ("enc1", 32, 32), ("enc2", 32, 32),
          ("enc3", 32, 64), ("dec3", 64, 64), ("dec2", 64, 32),
          ("dec1", 32, 32), ("dec0", 32, 32), ("final", 32, 3)]


@pytest.fixture(scope="module")
def card_geometry():
    dev = _card()
    return SpiralGeometry.from_bundle(load_bundle(FIXTURE), device=dev)


def _smoke_op(geom, name):
    level = int(name[-1]) if name != "final" else 0
    return geom.enc_spirals[level] if name.startswith("enc") else \
        geom.spirals[level]


@pytest.mark.parametrize("b", [1, 4, 16])
@pytest.mark.parametrize("name,c_in,c_out", _SMOKE)
def test_spiral_conv_kernel_on_the_model_tables(card_geometry, name, c_in,
                                                c_out, b):
    dev = _card()
    _conv_matches_plain(dev, _smoke_op(card_geometry, name), b, c_in, c_out)


@pytest.mark.parametrize("scale", [1e3, 1e-3])
@pytest.mark.parametrize("name,c_in,c_out", [("dec1", 32, 32),
                                             ("final", 32, 3)])
def test_spiral_conv_kernel_at_other_scales(card_geometry, name, c_in, c_out,
                                            scale):
    dev = _card()
    _conv_matches_plain(dev, _smoke_op(card_geometry, name), 16, c_in, c_out,
                        scale=scale)


def _sphere():
    return uv_sphere(24, 48)


def _camera(verts):
    eye, rot = look_at_camera()
    return ((verts - eye) @ rot.T).astype(np.float32)


def _sweep_both(dev, verts_cam, faces, size):
    """One K7 launch over ``verts_cam [B, V, 3]``, and the plain twin mesh
    by mesh."""
    f = torch.as_tensor(faces, device=dev).long()
    pts = raster.project(torch.as_tensor(verts_cam, device=dev), size)
    inp = raster.sweep_inputs(pts, f, size)
    got = kernels.raster_sweep(inp.coef, inp.box, inp.block_box, inp.ymin,
                               inp.ymax, size, raster._cull_tile(size * size))
    want = [raster._zbuffer_sweep_plain(c, lo, hi, size)
            for c, lo, hi in zip(inp.coef, inp.ymin, inp.ymax)]
    torch.cuda.synchronize()
    return got, want


def _assert_identical(got, want):
    z, w = got
    assert z.shape == w.shape == (len(want), want[0][0].numel())
    for b, (z_ref, w_ref) in enumerate(want):
        assert torch.equal(z[b], z_ref) and torch.equal(w[b], w_ref), b


@pytest.mark.parametrize("size", [16, 20, 48, 64, 256])
def test_raster_sweep_kernel_equals_plain(size):
    """z and winner bit-identical (no FMA contraction on either side);
    20² and 48² have ragged strips and tiles."""
    dev = _card()
    verts, faces = _sphere()
    got, want = _sweep_both(dev, _camera(verts)[None], faces, size)
    _assert_identical(got, want)
    assert int((got[1] < len(faces)).sum()) > 0


@pytest.mark.parametrize("batch", [1, 3, 16])
@pytest.mark.parametrize("size", [16, 48, 256])
def test_raster_sweep_batch_equals_plain_per_mesh(size, batch):
    """A batch of distinct lr0 meshes (seeded per-vertex offsets) in one
    launch: every mesh bit-identical to its own plain sweep."""
    dev = _card()
    bundle = load_bundle(FIXTURE)
    rng = np.random.default_rng(batch)
    verts = bundle.lr_pos[0][None] + 0.01 * rng.normal(
        size=(batch,) + bundle.lr_pos[0].shape)
    got, want = _sweep_both(dev, _camera(verts), bundle.lr_face[0], size)
    _assert_identical(got, want)


@pytest.mark.parametrize("size", [16, 48, 256])
def test_raster_sweep_adversarial_mesh(size):
    """Slivers, corners at and behind the camera plane, off-screen and
    degenerate faces and coplanar duplicates two blocks apart."""
    dev = _card()
    verts, faces = adversarial_mesh(size)
    got, want = _sweep_both(dev, np.stack([verts, 0.97 * verts]), faces,
                            size)
    _assert_identical(got, want)


def test_raster_sweep_tie_goes_to_lower_index():
    """Coplanar copies two blocks apart, in both orders, in one batch: the
    lower index wins in each mesh."""
    dev = _card()
    tri = np.array([[-.4, -.4, 0.5], [.4, -.4, 0.5], [0., .4, 0.5]],
                   np.float32)
    verts = np.concatenate([tri, tri])
    filler = np.zeros((300, 3), np.int64)
    faces = np.concatenate([[[3, 4, 5]], filler, [[0, 1, 2]]])
    batch = np.stack([_camera(verts), _camera(verts[::-1].copy())])
    got, want = _sweep_both(dev, batch, faces, 64)
    _assert_identical(got, want)
    w = got[1]
    hit = w < len(faces)
    assert int(hit[0].sum()) > 50 and bool((w[hit] == 0).all())


def test_render_on_card_matches_host():
    """Unquantized: under 1 % of pixels off by more than 1e-3 (edge
    pixels where the card's and the host's shading round apart); the
    default uint8 transfer within 1/255 of the card's floats."""
    dev = _card()
    verts, faces = _sphere()
    from craniofacialsd_vae_tpu_torch.viz import render_batch

    batch = np.stack([verts, 0.8 * verts, 0.9 * verts])
    card = render_batch(batch, faces, image_size=64, quantize_transfer=False,
                        device=dev)
    host = render_batch(batch, faces, image_size=64, device="cpu")
    assert float((np.abs(card - host).max(-1) > 1e-3).mean()) < 0.01
    quantized = render_batch(batch, faces, image_size=64, device=dev)
    assert np.abs(quantized - card).max() <= 1 / 255 + 1e-6
    assert np.array_equal(np.round(quantized * 255), quantized * 255)


def test_render_batch_launches_k7_once_per_call():
    dev = _card()
    verts, faces = _sphere()
    from craniofacialsd_vae_tpu_torch.viz import render_batch

    kernels.launches.reset()
    render_batch(np.stack([verts] * 5), faces, image_size=32, max_vmap=2,
                 device=dev)
    assert kernels.launches.snapshot()["raster_sweep"] == 1


@pytest.mark.parametrize("b", [1, 4, 16])
@pytest.mark.parametrize("level", [3, 2, 1, 0])
def test_ell_matmul_kernel_on_the_up_pools(card_geometry, level, b):
    """Every up-pool of the smoke model at its channel width, at the
    service's batch buckets: bit-equal."""
    dev = _card()
    mat = card_geometry.up[level]
    d = b * {3: 64, 2: 64, 1: 32, 0: 32}[level]
    x2 = torch.randn((mat.n_cols, d), generator=_gen(dev, level), device=dev)
    out = kernels.ell_matmul_fwd(mat.cols, mat.vals, x2)
    ref = ops.ell_matmul_plain(mat.cols, mat.vals, x2)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


@pytest.mark.parametrize("m,n,k,d", [
    (500, 300, 3, 64), (333, 90, 5, 48), (1001, 900, 9, 96), (77, 20, 1, 4),
    (40000, 5000, 3, 128),      # two rows per thread
    (40000, 5000, 5, 128),      # two rows per thread, runtime K
    (33800, 900, 3, 1028),      # ragged column segments
])
def test_ell_matmul_direct_plans_equal_plain(m, n, k, d):
    """The direct kernel with one and two rows per thread, on other K (its
    runtime-K build), ragged row groups and column segments, and repeated
    indices."""
    dev = _card()
    g = _gen(dev, m)
    cols = torch.randint(0, n, (m, k), generator=g, device=dev,
                         dtype=torch.int32)
    vals = torch.randn((m, k), generator=g, device=dev)
    x2 = torch.randn((n, d), generator=g, device=dev)
    out = kernels.ell_matmul_fwd(cols, vals, x2)
    torch.cuda.synchronize()
    assert torch.equal(out, ops.ell_matmul_plain(cols, vals, x2))


def test_wrappers_reject_what_the_kernels_do_not_take():
    dev = _card()
    x = torch.randn(10, 8, device=dev)
    cols = torch.zeros(4, 3, dtype=torch.int32, device=dev)
    vals = torch.ones(4, 3, device=dev)
    with pytest.raises(ValueError):
        kernels.ell_matmul_fwd(cols.cpu(), vals, x)
    with pytest.raises(ValueError):
        kernels.ell_matmul_fwd(cols.long(), vals, x)
    with pytest.raises(ValueError):
        kernels.ell_matmul_fwd(cols, vals, x.t())
    x3 = torch.randn(10, 2, 4, device=dev)
    w = torch.randn(3, 4, 5, device=dev)
    with pytest.raises(ValueError):
        kernels.spiral_conv_fwd(x3, cols, w[:2], torch.zeros(5, device=dev))
    with pytest.raises(ValueError):
        kernels.spiral_conv_fwd(x3.transpose(0, 1), cols, w,
                                torch.zeros(5, device=dev))
    coef = torch.zeros(2, 256, 16, device=dev)
    box = torch.zeros(2, 256, 4, device=dev)
    bbox = torch.zeros(2, 1, 4, device=dev)
    ys = torch.zeros(2, 1, device=dev)
    z, w = kernels.raster_sweep(coef, box, bbox, ys, ys, 8, 64)
    assert z.shape == w.shape == (2, 64)
    for bad in ((coef[:, :100], box, bbox, ys, ys, 8, 64),    # not 256·nb
                (coef[0], box, bbox, ys, ys, 8, 64),          # no batch dim
                (coef, box[:1], bbox, ys, ys, 8, 64),         # batch differs
                (coef, box, bbox[..., :3], ys, ys, 8, 64),    # box width
                (coef, box, bbox, ys.long(), ys, 8, 64),      # dtype
                (coef.cpu(), box, bbox, ys, ys, 8, 64),       # device
                (coef, box, bbox, ys, ys, 8, 65),             # cull > P
                (coef, box, bbox, ys, ys, 0, 1)):             # no pixels
        with pytest.raises(ValueError):
            kernels.raster_sweep(*bad)
    with pytest.raises(ValueError):          # no entries per row
        kernels.ell_matmul_fwd(cols[:, :0].contiguous(),
                               vals[:, :0].contiguous(), x)


def test_launch_counts_move_only_on_launch():
    dev = _card()
    kernels.launches.reset()
    x = torch.randn(10, 8, device=dev)
    cols = torch.zeros(4, 3, dtype=torch.int32, device=dev)
    kernels.ell_matmul_fwd(cols, torch.ones(4, 3, device=dev), x)
    ops.ell_matmul_plain(cols, torch.ones(4, 3, device=dev), x)
    assert kernels.launches.snapshot() == {
        **dict.fromkeys(kernels.KERNEL_NAMES, 0), "ell_matmul_fwd": 1}


def test_service_on_card_matches_host():
    """A narrow model on the real hierarchy: card vs host, rtol 1e-4
    against each array's max and 1e-3 mm on the error."""
    dev = _card()
    bundle = load_bundle(FIXTURE)
    cfg = SDVAEConfig(out_channels=(8, 8, 8, 16), latent_size=6)
    n = bundle.vertex_counts[0]
    rng = np.random.default_rng(0)
    mean = rng.normal(size=(n, 3)).astype(np.float32)
    norm = {"mean": mean, "std": np.full((n, 3), 0.1, np.float32)}
    x = (mean + 0.1 * rng.normal(size=(3, n, 3))).astype(np.float32)
    kernels.launches.reset()
    card = DiagnosisService.from_bundle(bundle, cfg, norm, 10.0, max_batch=2,
                                        device=dev).reconstruct(x)
    counts = kernels.launches.snapshot()
    host = DiagnosisService.from_bundle(bundle, cfg, norm, 10.0, max_batch=2,
                                        device="cpu").reconstruct(x)
    assert counts["spiral_conv_tc"] == 2 * 8
    assert counts["spiral_conv_narrow"] == 2 and counts["ell_matmul_fwd"] == 8
    for key in ("vertices", "latent"):
        lim = 1e-4 * float(np.abs(host[key]).max())
        assert float(np.abs(card[key] - host[key]).max()) <= lim
    assert float(np.abs(card["vertex_errors_mm"]
                        - host["vertex_errors_mm"]).max()) <= 1e-3


# ------------------------------------------------------------ training
def _dw_matches_plain(dev, x, table, dy):
    """K2-dW against its twin: rtol 1e-5 against max |dW| (fp32 sums of
    M·B products in another order than the library matmul's), and two
    launches bit-equal (fixed chunks, no atomics)."""
    out = kernels.spiral_conv_dw(x, table, dy)
    again = kernels.spiral_conv_dw(x, table, dy)
    ref = ops.spiral_conv_dw_plain(x, table, dy)
    torch.cuda.synchronize()
    assert out.shape == ref.shape
    assert float((out - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    assert torch.equal(out, again)


@pytest.mark.parametrize("m,n_src,seq,b,c_in,c_out", [
    (50, 80, 3, 1, 1, 1),
    (333, 333, 7, 3, 10, 18),         # channels not a multiple of 4
    (100, 100, 9, 2, 128, 96),        # more than 256 tiles: grid.z
    (700, 900, 5, 20, 3, 64),
    (20, 20, 9, 1, 64, 3),            # fewer rows than one stage
])
def test_spiral_conv_dw_kernel_matches_plain(m, n_src, seq, b, c_in, c_out):
    dev = _card()
    g = _gen(dev, m)
    table = torch.randint(0, n_src, (m, seq), generator=g, device=dev,
                          dtype=torch.int32)
    x = torch.randn((n_src, b, c_in), generator=g, device=dev)
    dy = torch.randn((m, b, c_out), generator=g, device=dev)
    _dw_matches_plain(dev, x, table, dy)


@pytest.mark.parametrize("b", [1, 4, 16])
@pytest.mark.parametrize("name,c_in,c_out", _SMOKE)
def test_spiral_conv_dw_kernel_on_the_model_tables(card_geometry, name, c_in,
                                                   c_out, b):
    dev = _card()
    op = _smoke_op(card_geometry, name)
    g = _gen(dev, b)
    x = torch.randn((op.n_src, b, c_in), generator=g, device=dev)
    dy = torch.randn((op.num_vertices, b, c_out), generator=g, device=dev)
    _dw_matches_plain(dev, x, op.table, dy)


@pytest.mark.parametrize("scale", [1e3, 1e-3])
@pytest.mark.parametrize("name,c_in,c_out", [("dec0", 32, 32),
                                             ("final", 32, 3),
                                             ("enc0", 3, 32)])
def test_spiral_conv_dw_kernel_at_other_scales(card_geometry, name, c_in,
                                               c_out, scale):
    """3xTF32 splits each operand into a high and a low TF32 part: the
    error stays relative at large and small magnitudes."""
    dev = _card()
    op = _smoke_op(card_geometry, name)
    g = _gen(dev, 7)
    x = torch.randn((op.n_src, 16, c_in), generator=g, device=dev) * scale
    dy = torch.randn((op.num_vertices, 16, c_out), generator=g, device=dev)
    _dw_matches_plain(dev, x, op.table, dy)


def _sequential_twin(mat, x2):
    """K4's twin on the main table, then one index_add per tier."""
    want = ops.ell_matmul_plain(mat.cols, mat.vals, x2)
    for rows, cols, vals in mat.tiers:
        sparse.ell_tier_add_plain(rows, cols, vals, x2, want)
    return want


@pytest.mark.parametrize("m,n,d,offset,hubs", [
    (1000, 500, 64, 0, (300, 90, 40)),       # float4 path, three tiers
    (1000, 500, 48, 0, (200,)),              # one tier
    (50000, 5000, 128, 0, (900, 300, 60)),   # two rows per thread
    (400, 90, 7, 0, (120, 40)),              # D % 4 != 0: scalar path
    (300, 40, 16, 1, (100, 30, 9)),          # unaligned x: scalar path
    (10, 10, 4, 0, (30,)),
])
def test_ell_capped_kernel_equals_plain(m, n, d, offset, hubs):
    """The main table and every tier in one launch: the same sums in the
    same order, each tier added with one rounding, so bit-equal to K4's
    twin followed by one index_add per tier, and to the walk's twin."""
    dev = _card()
    rng = np.random.default_rng(m + d)
    rows = np.concatenate([np.repeat(np.arange(len(hubs)) * 3 + 1, hubs),
                           rng.integers(0, m, 3 * m)])
    cols = rng.integers(0, n, len(rows))
    mat = sparse.capped_ell(rows, cols, rng.normal(size=len(rows)), m).to(dev)
    assert mat.tiers
    g = _gen(dev, m)
    base = torch.randn(n * d + offset, generator=g, device=dev)
    x2 = base[offset:].view(n, d)
    got = kernels.ell_matmul_capped(mat.cols, mat.vals, mat.tiers, mat.links,
                                    x2)
    walk = sparse.ell_matmul_capped_plain(mat.cols, mat.vals, mat.tiers,
                                          mat.links, x2)
    want = _sequential_twin(mat, x2)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(walk, want)


@pytest.fixture(scope="module")
def card_training_geometry():
    dev = _card()
    bundle = load_bundle(FIXTURE)
    return SpiralGeometry.from_bundle(
        bundle, device=dev, laplacian=standin_laplacian_coo(bundle.spirals[0]))


@pytest.mark.parametrize("b", [1, 16, "odd"])
def test_capped_ell_apply_on_the_backward_tables(card_training_geometry, b):
    """Every transpose a training step applies (the Laplacian's, the
    up-pools', the convs' combined ones; 13 tables, 34 tiers): one fused
    launch each, bit-equal to the sequential twin, at the step's widths
    for a grid of b meshes and at an odd width (the scalar path)."""
    dev = _card()
    geom = card_training_geometry
    width = (lambda c: 7) if b == "odd" else (lambda c: b * c)
    tables = [(geom.laplacian.transpose, geom.num_vertices, width(3))]
    tables += [(u.transpose, u.shape[0], width(c)) for u, c in
               zip(geom.up, (32, 32, 64, 64))]
    for name, c_in, _ in _SMOKE[1:]:
        op = _smoke_op(geom, name)
        tables += [(t, len(cols) * op.num_vertices, width(c_in))
                   for t, cols in zip(op.inv_tables, op.group_cols)]
    assert len(tables) == 13
    assert sum(len(t.tiers) for t, _, _ in tables) == 34
    for mat, n_src, d in tables:
        x2 = torch.randn((n_src, d), generator=_gen(dev, d), device=dev)
        kernels.launches.reset()
        got = mat.apply(x2)
        assert kernels.launches.snapshot()["ell_matmul_capped"] == 1
        want = _sequential_twin(mat, x2)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def test_differentiable_ops_launch_the_kernels():
    """On CUDA tensors the forward and the backward go through the
    kernels: K1, the fused K4 of a tiered transpose and K2-dW each
    counted."""
    dev = _card()
    rng = np.random.default_rng(0)
    m = 300
    table = rng.integers(0, m, size=(m, 9))
    table[:, 0] = np.arange(m)
    table[:150, 1] = 0                     # a skewed in-degree: tiers
    op = ops.build_spiral_op(table).to(dev)
    assert op.inv_tables[0].tiers
    w = torch.randn(9 * 8, 16, device=dev, requires_grad=True)
    b = torch.zeros(16, device=dev, requires_grad=True)
    x = torch.randn(m, 2, 8, device=dev, requires_grad=True)
    kernels.launches.reset()
    ops.spiral_conv({"w": w, "b": b}, x, op).square().sum().backward()
    counts = kernels.launches.snapshot()
    assert counts["spiral_conv_tc"] == 1 and counts["spiral_conv_dw"] == 1
    assert counts["ell_matmul_fwd"] == 0 and counts["ell_matmul_capped"] == 1
    gop = sparse.gather_op_from_idx(np.zeros(50, int), 10).to(dev)
    assert gop.transpose.tiers
    y = torch.randn(10, 4, device=dev, requires_grad=True)
    kernels.launches.reset()
    sparse.gather_rows(gop, y).sum().backward()
    assert kernels.launches.snapshot()["ell_matmul_capped"] == 1
    assert torch.equal(y.grad[0], torch.full((4,), 50.0, device=dev))


def test_wrappers_reject_what_the_training_kernels_do_not_take():
    dev = _card()
    x = torch.randn(10, 2, 4, device=dev)
    table = torch.zeros(6, 3, dtype=torch.int32, device=dev)
    dy = torch.randn(6, 2, 5, device=dev)
    assert kernels.spiral_conv_dw(x, table, dy).shape == (3, 4, 5)
    for bad in ((x, table, dy[:5]), (x.transpose(0, 1), table, dy),
                (x, table.long(), dy), (x.cpu(), table, dy)):
        with pytest.raises(ValueError):
            kernels.spiral_conv_dw(*bad)
    plan = kernels.plan_spiral_conv_dw(6, 2, 3, 4, 5)
    with pytest.raises(RuntimeError):        # the kernel's own plan check
        kernels.spiral_conv_dw(x, table, dy, dataclasses.replace(
            plan, threads=plan.threads + 32))
    mat = sparse.capped_ell(np.r_[np.zeros(40, int), np.arange(5)],
                            np.arange(45) % 10, np.ones(45), 5).to(dev)
    assert len(mat.tiers) >= 1
    x2 = torch.randn(10, 8, device=dev)
    args = (mat.cols, mat.vals, mat.tiers, mat.links, x2)
    assert kernels.ell_matmul_capped(*args).shape == (5, 8)
    t_rows, t_cols, t_vals = mat.tiers[0]
    for bad in ((mat.cols, mat.vals, (), (mat.links[0],), x2),   # no tier
                (mat.cols, mat.vals, mat.tiers, mat.links[:-1], x2),
                (mat.cols[:4], mat.vals[:4], mat.tiers, mat.links, x2),
                (mat.cols, mat.vals, ((t_rows, t_cols.long(), t_vals),),
                 mat.links[:2], x2),
                (mat.cols, mat.vals, mat.tiers, mat.links, x2.t()),
                (mat.cols, mat.vals, mat.tiers,
                 (mat.links[0].cpu(),) + mat.links[1:], x2)):
        with pytest.raises(ValueError):
            kernels.ell_matmul_capped(*bad)


def _train_setup(bundle, dev, cfg, batch):
    geom = SpiralGeometry.from_bundle(
        bundle, device=dev, laplacian=standin_laplacian_coo(bundle.spirals[0]),
        region_masks=standin_region_masks(level0_positions(bundle)))
    model = init_sdvae(cfg, geom, torch.Generator().manual_seed(0))
    step = make_train_step(model, LossWeights(), coupled_adam(
        model.parameters(), 1e-4, 0.0), batch)
    return model, step


def test_train_step_on_card_matches_host():
    """A narrow model on the real hierarchy with the stand-in Laplacian
    and regions: one step on the card against the host with the same
    weights, scans, region and noise. Losses within rtol 1e-4, every
    gradient leaf within 1e-4 of its max; every kernel of the step
    launched."""
    dev = _card()
    bundle = load_bundle(FIXTURE)
    cfg = SDVAEConfig(out_channels=(8, 8, 8, 16), latent_size=15)
    batch = 3
    rng = np.random.default_rng(1)
    x = rng.normal(size=(batch, bundle.vertex_counts[0], 3)).astype(
        np.float32)
    eps = torch.from_numpy(rng.normal(size=(batch * batch, 15)).astype(
        np.float32))
    card, step = _train_setup(bundle, dev, cfg, batch)
    kernels.launches.reset()
    m_card = step(torch.as_tensor(x, device=dev), region_idx=4,
                  eps=eps.to(dev))
    counts = kernels.launches.snapshot()
    host, step_h = _train_setup(bundle, "cpu", cfg, batch)
    m_host = step_h(torch.from_numpy(x), region_idx=4, eps=eps)
    for k in LOSS_KEYS:
        assert abs(float(m_card[k]) - float(m_host[k])) <= \
            1e-4 * abs(float(m_host[k])), k
    for (name, p), q in zip(card.named_parameters(), host.parameters()):
        assert p.grad is not None, name
        err = float((p.grad.cpu() - q.grad).abs().max())
        assert err <= 1e-4 * float(q.grad.abs().max()), name
    for kernel in ("spiral_conv_tc", "spiral_conv_narrow", "ell_matmul_fwd",
                   "ell_matmul_capped", "spiral_conv_dw"):
        assert counts[kernel] > 0, kernel


def test_train_steps_on_card_stay_finite():
    """Five steps with the region and noise from a generator on the card."""
    dev = _card()
    bundle = load_bundle(FIXTURE)
    cfg = SDVAEConfig(out_channels=(8, 8, 8, 16), latent_size=15)
    _, step = _train_setup(bundle, dev, cfg, 2)
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((2, bundle.vertex_counts[0], 3), generator=gen,
                    device=dev)
    tots = [step(x, generator=gen)["tot"] for _ in range(5)]
    assert bool(torch.isfinite(torch.stack(tots)).all())


# ------------------------------------------------------- the entry point
@pytest.mark.parametrize("size", [64, 256])
def test_raster_sweep_full_resolution_octasphere(size):
    """K7 on the 32,768 faces of the subdivision-6 octasphere (the
    template phase 7 of chip_smoke.py trains on), two meshes in one
    launch: z and winner bit-identical to the twin."""
    from craniofacialsd_vae_tpu_torch.geometry import octasphere

    dev = _card()
    verts, faces = octasphere(6)
    rng = np.random.default_rng(6)
    batch = np.stack([verts, verts * (1 + 0.02 * rng.normal(
        size=(len(verts), 1)))])
    got, want = _sweep_both(dev, _camera(batch), faces, size)
    _assert_identical(got, want)
    assert int((got[1] < len(faces)).sum()) > 0


def _entry_workspace(root):
    """A small entry-point workspace: the subdivision-3 octasphere with
    3 regions, 6 OBJ scans of each of 3 classes, a narrow model."""
    from craniofacialsd_vae_tpu_torch.geometry import (synthetic_template,
                                                       write_obj, write_ply)

    tpl = synthetic_template(subdivisions=3, n_regions=3)
    tpl_path = os.path.join(root, "template.ply")
    write_ply(tpl_path, tpl.pos, tpl.face, tpl.colors)
    meshes = os.path.join(root, "meshes")
    os.makedirs(meshes)
    rng = np.random.default_rng(0)
    for k, c in enumerate("acn"):
        for i in range(6):
            write_obj(os.path.join(meshes, f"{c}_{i}.obj"),
                      tpl.pos * (1 + 0.05 * k)
                      + rng.normal(scale=0.02, size=tpl.pos.shape))
    return {
        "data": {"template_path": tpl_path, "dataset_path": meshes,
                 "precomputed_path": os.path.join(root, "precomp"),
                 "normalize_data": True, "to_mm_constant": 10.0,
                 "swap_features": True, "stratified_split": True,
                 "augmentation_factor": 0},
        "optimization": {"epochs": 1, "batch_size": 3, "lr": 1e-4,
                         "weight_decay": 0, "laplacian_weight": 0.1,
                         "kl_weight": 1e-4, "latent_consistency_weight": 0.5,
                         "latent_consistency_eta1": 0.5,
                         "latent_consistency_eta2": 0.5},
        "model": {"sampling": {"type": "basic",
                               "sampling_factors": [2, 2, 2]},
                  "spirals": {"length": [9, 9, 9], "dilation": [1, 1, 1]},
                  "in_channels": 3, "out_channels": [8, 8, 16],
                  "latent_size": 6, "pre_z_sigmoid": False},
        "classifier": {"main_model_type": "qda",
                       "mlp_training_type": "end2end",
                       "mlp_hidden_features": [8], "mlp_lr": 1e-3,
                       "mlp_loss_weight": 1},
        "logging_frequency": {"tb_renderings": 1, "save_weights": 1},
    }


def test_manager_epoch_on_card_matches_host(tmp_path):
    """The check of chip_smoke.py's phase 7 at a small size: a host
    manager trains three epochs and checkpoints (so Adam's moments are
    warm: a first Adam step is lr·sign(g), which flips where a gradient
    is near 0), then a card manager and a host manager resume that
    checkpoint and run one epoch over the same batches with the same
    per-step draws. Every loss within rtol 1e-4 and every parameter
    within 1e-4 of its leaf's max; the epoch launched K1, K4, the fused
    K4 and K2-dW, and ``log_images`` K7."""
    from craniofacialsd_vae_tpu_torch.data.dataset import (
        BatchIterator, DeviceBatchIterator, build_datasets)
    from craniofacialsd_vae_tpu_torch.manager import ModelManager
    from craniofacialsd_vae_tpu_torch.viz.logging import JsonlWriter

    dev = _card()
    config = _entry_workspace(str(tmp_path))
    train, _, _, norm, weights = build_datasets(config)
    ckpt = str(tmp_path / "ckpt")

    def manager(d):
        mgr = ModelManager(config, config["data"]["precomputed_path"],
                           device=d)
        mgr.set_class_conversions_and_weights(weights)
        return mgr

    warm = manager("cpu")
    it = BatchIterator(train, 3, seed=1, class2idx=warm._class2idx_dict)
    for _ in range(3):
        warm.run_epoch(it, train=True)
    warm.save_weights(ckpt, 2)
    out = {}
    for d in (dev, "cpu"):
        mgr = manager(d)
        assert mgr.resume(ckpt) == 3
        kw = dict(seed=2, class2idx=mgr._class2idx_dict)
        it = DeviceBatchIterator(train, 3, device=d, **kw) \
            if d == dev else BatchIterator(train, 3, **kw)
        kernels.launches.reset()
        losses = mgr.run_epoch(it, train=True)
        out[d] = (mgr, dict(losses), kernels.launches.snapshot())
    (card, lc, counts), (host, lh, _) = out[dev], out["cpu"]
    assert lh["classification"] > 0
    for k in LOSS_KEYS:
        assert abs(lc[k] - lh[k]) <= 1e-4 * abs(lh[k]), k
    ref = host.model.state_dict()
    for name, p in card.model.state_dict().items():
        err = float((p.cpu() - ref[name]).abs().max())
        assert err <= 1e-4 * float(ref[name].abs().max()), name
    for kernel in ("spiral_conv_tc", "spiral_conv_narrow", "ell_matmul_fwd",
                   "ell_matmul_capped", "spiral_conv_dw"):
        assert counts[kernel] > 0, kernel
    kernels.launches.reset()
    writer = JsonlWriter(str(tmp_path / "logs"))
    grid = card.log_images(next(iter(BatchIterator(train, 3))), writer, 0,
                           norm)
    writer.close()
    assert np.isfinite(grid).all()
    assert kernels.launches.snapshot()["raster_sweep"] == 3


# ------------------------------------------- the mixed and bfloat16 policies
BF16 = torch.bfloat16


def _within_ulp(got, want):
    """Two bf16 arrays within one bf16 ulp of the larger magnitude: the
    same fp32 sums in another order can round to the neighbouring bf16
    value. The ulp is taken at no less than 1e-5 of the array's max:
    where a sum cancels to nearly 0, its bf16 ulp is finer than the fp32
    sum's own rounding, which differs with the order of the sum."""
    got, want = got.float(), want.float()
    assert got.shape == want.shape
    mag = torch.maximum(got.abs(), want.abs()).clamp(min=2.0 ** -120)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7).clamp(
        min=1e-5 * float(want.abs().max()))
    assert bool(((got - want).abs() <= ulp).all())


def _bf16_rows(dev, g, n, d, offset=0):
    base = torch.randn(n * d + offset, generator=g, device=dev).to(BF16)
    return base[offset:].view(n, d)


@pytest.mark.parametrize("m,n,k,d,offset", [
    (500, 300, 3, 64, 0),       # 16-byte path
    (300, 267, 3, 1024, 0),     # dec0's up-pool width at B = 16
    (333, 90, 5, 48, 0),
    (200, 70, 4, 7, 0),         # D % 8 != 0: scalar path
    (100, 40, 3, 16, 1),        # unaligned x view: scalar path
])
def test_ell_matmul_bf16_kernel_equals_plain(m, n, k, d, offset):
    """K4-bf16: the same fp32 products and sums in the same order, one
    rounding: bit-equal to the twin."""
    dev = _card()
    g = _gen(dev, m)
    cols = torch.randint(0, n, (m, k), generator=g, device=dev,
                         dtype=torch.int32)
    vals = torch.randn((m, k), generator=g, device=dev)
    x2 = _bf16_rows(dev, g, n, d, offset)
    kernels.launches.reset()
    out = kernels.ell_matmul_fwd(cols, vals, x2)
    assert kernels.launches.snapshot()["ell_matmul_bf16"] == 1
    torch.cuda.synchronize()
    assert out.dtype == BF16
    assert torch.equal(out, ops.ell_matmul_plain(cols, vals, x2))


@pytest.mark.parametrize("m,n,d,offset,hubs", [
    (1000, 500, 64, 0, (300, 90, 40)),       # 16-byte path, three tiers
    (1000, 500, 512, 0, (200,)),             # a conv's dg width at B = 16
    (400, 90, 7, 0, (120, 40)),              # scalar path
    (300, 40, 16, 1, (100, 30, 9)),          # unaligned x: scalar path
])
def test_ell_capped_bf16_kernel_equals_plain(m, n, d, offset, hubs):
    """The capped K4-bf16: main sum, each tier's sum and each landing
    rounded as JAX rounds them; bit-equal to the walk twin and to K4's
    twin followed by one bf16 index_add per tier."""
    dev = _card()
    rng = np.random.default_rng(m + d)
    rows = np.concatenate([np.repeat(np.arange(len(hubs)) * 3 + 1, hubs),
                           rng.integers(0, m, 3 * m)])
    cols = rng.integers(0, n, len(rows))
    mat = sparse.capped_ell(rows, cols, rng.normal(size=len(rows)), m).to(dev)
    x2 = _bf16_rows(dev, _gen(dev, m), n, d, offset)
    got = kernels.ell_matmul_capped(mat.cols, mat.vals, mat.tiers, mat.links,
                                    x2)
    walk = sparse.ell_matmul_capped_plain(mat.cols, mat.vals, mat.tiers,
                                          mat.links, x2)
    want = _sequential_twin(mat, x2)
    torch.cuda.synchronize()
    assert got.dtype == BF16
    assert torch.equal(got, want) and torch.equal(walk, want)


@pytest.mark.parametrize("b", [1, 4, 16])
@pytest.mark.parametrize("level", [3, 2, 1, 0])
def test_ell_matmul_bf16_on_the_up_pools(card_geometry, level, b):
    dev = _card()
    up = card_geometry.up[level]
    c = 64 if level >= 2 else 32
    x2 = _bf16_rows(dev, _gen(dev, level), up.n_cols, b * c)
    out = kernels.ell_matmul_fwd(up.cols, up.vals, x2)
    torch.cuda.synchronize()
    assert torch.equal(out, ops.ell_matmul_plain(up.cols, up.vals, x2))


@pytest.mark.parametrize("b", [1, 16])
def test_capped_ell_apply_bf16_on_the_backward_tables(card_training_geometry,
                                                      b):
    """The bf16 transposes of a mixed step (the up-pools' and the bf16
    convs'): one launch each, bit-equal to the twin."""
    dev = _card()
    geom = card_training_geometry
    tables = [(u.transpose, u.shape[0], b * c) for u, c in
              zip(geom.up, (32, 32, 64, 64))]
    for name, c_in, _ in _SMOKE[1:]:
        op = _smoke_op(geom, name)
        tables += [(t, len(cols) * op.num_vertices, b * c_in)
                   for t, cols in zip(op.inv_tables, op.group_cols)]
    for mat, n_src, d in tables:
        x2 = _bf16_rows(dev, _gen(dev, d), n_src, d)
        kernels.launches.reset()
        got = mat.apply(x2)
        counts = kernels.launches.snapshot()
        assert counts["ell_matmul_capped_bf16" if mat.tiers
                      else "ell_matmul_bf16"] == 1
        torch.cuda.synchronize()
        assert torch.equal(got, _sequential_twin(mat, x2))


@pytest.mark.parametrize("m,n,k,d,offset", [
    (17039, 4260, 3, 512, 0),   # up0 at B = 16
    (1001, 300, 3, 64, 0),      # M not a multiple of a block's rows
    (999, 300, 2, 1024, 0),     # run-time K, two column segments
    (777, 300, 5, 96, 0),       # run-time K, D/8 not a power of two
    (333, 90, 3, 8, 0),         # one thread a row
    (333, 90, 3, 16, 0),        # two threads a row
    (333, 90, 3, 24, 0),        # three of four threads a row
    (200, 70, 4, 7, 0),         # D % 8 != 0: scalar path
    (100, 40, 3, 16, 1),        # unaligned x view: scalar path
])
def test_ell_matmul_bf16_shapes_equal_plain(m, n, k, d, offset):
    """K4-bf16 at the up-pools' compiled K = 3 and at run-time K, at
    widths of fewer than 32 threads a row and off 16 bytes: bit-equal to
    the twin, one launch each."""
    dev = _card()
    g = _gen(dev, m + d)
    cols = torch.randint(0, n, (m, k), generator=g, device=dev,
                         dtype=torch.int32)
    vals = torch.randn((m, k), generator=g, device=dev)
    x2 = _bf16_rows(dev, g, n, d, offset)
    want = ops.ell_matmul_plain(cols, vals, x2)
    kernels.launches.reset()
    got = kernels.ell_matmul_fwd(cols, vals, x2)
    assert kernels.launches.snapshot()["ell_matmul_bf16"] == 1
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("m,n,d,hubs", [
    (20000, 5000, 512, (900, 300, 60)),      # a conv's dg width at B = 16
    (1001, 500, 24, (300, 90, 40)),          # three threads a row
    (1000, 500, 96, (200,)),                 # D/8 not a power of two
])
def test_ell_capped_bf16_widths_equal_plain(m, n, d, hubs):
    """The capped K4-bf16 at a conv's dg width, at fewer than 32 threads
    a row and at a width of 12 vectors: bit-equal to K4's twin followed
    by one bf16 index_add per tier."""
    dev = _card()
    rng = np.random.default_rng(m + d)
    rows = np.concatenate([np.repeat(np.arange(len(hubs)) * 3 + 1, hubs),
                           rng.integers(0, m, 3 * m)])
    cols = rng.integers(0, n, len(rows))
    mat = sparse.capped_ell(rows, cols, rng.normal(size=len(rows)), m).to(dev)
    assert mat.tiers
    x2 = _bf16_rows(dev, _gen(dev, m), n, d)
    want = _sequential_twin(mat, x2)
    got = kernels.ell_matmul_capped(mat.cols, mat.vals, mat.tiers, mat.links,
                                    x2)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _k3a_matches_plain(dev, op, b, tiles=True, offset=0, c_in=32, seed=3):
    """K3a (fp32 out) within 1e-5 of the max of its twin, two launches
    bit-equal, and the bf16 output of the same kernel within one bf16
    ulp; C_in -> 3 channels, with the op's tiles or without. Returns the
    plan."""
    g = _gen(dev, seed + b)
    seq = op.seq_length
    base = torch.randn(op.n_src * b * c_in + offset, generator=g,
                       device=dev).to(BF16)
    x = base[offset:].view(op.n_src, b, c_in)
    w_l = (0.2 * torch.randn((seq, c_in, 3), generator=g,
                             device=dev)).to(BF16)
    bias = torch.randn(3, generator=g, device=dev).to(BF16)
    t = op.tiles if tiles else None
    kernels.launches.reset()
    out = kernels.spiral_conv_fwd(x, op.table, w_l, bias,
                                  out_dtype=torch.float32, tiles=t)
    again = kernels.spiral_conv_fwd(x, op.table, w_l, bias,
                                    out_dtype=torch.float32, tiles=t)
    rounded = kernels.spiral_conv_fwd(x, op.table, w_l, bias, tiles=t)
    counts = kernels.launches.snapshot()
    assert counts["spiral_conv_f32out"] == 2
    assert counts["spiral_conv_bf16"] == 1
    ref = ops.spiral_conv_plain(w_l, bias, x, op, torch.float32)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and rounded.dtype == BF16
    assert float((out - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    assert torch.equal(out, again)
    _within_ulp(rounded, ops.spiral_conv_plain(w_l, bias, x, op))
    return kernels.plan_spiral_conv(
        op.num_vertices, b, seq, c_in, 3, x.data_ptr() % 4 == 0, True, BF16,
        t.n_tiles if t else 0, t.max_rows if t else 0)


@pytest.mark.parametrize("b", [1, 3, 4, 16])
@pytest.mark.parametrize("mesh", ["fixture", "octasphere"])
def test_k3a_tiled_on_the_level0_meshes(card_geometry, octasphere_level0,
                                        mesh, b):
    """K3a's tiled kernel on the fixture's and the octasphere's level 0
    (B = 3: a partial batch tile where the tile takes fewer rows)."""
    dev = _card()
    op = (card_geometry.spirals[0] if mesh == "fixture"
          else octasphere_level0.to(dev))
    plan = _k3a_matches_plain(dev, op, b)
    assert plan.path == "bf16_tile" and plan.rows >= op.tiles.max_rows


def test_k3a_tiled_with_4_byte_copies(card_geometry):
    """x on 4 bytes but not on 16: the tiled kernel copies 4 bytes at a
    time; x on 2 bytes takes the element path."""
    dev = _card()
    op = card_geometry.spirals[0]
    assert _k3a_matches_plain(dev, op, 4, offset=2).path == "bf16_tile"
    assert _k3a_matches_plain(dev, op, 4, offset=1).path == "bf16_elem"


def test_k3a_gather_first_conv_launches_the_tiled_kernel(card_geometry):
    """``ops.spiral_conv(..., out_dtype=float32)`` on bf16 x (the
    gather-first final conv) goes through the tiled kernel, once."""
    dev = _card()
    op = card_geometry.spirals[0]
    g = _gen(dev, 5)
    params = {"w": 0.1 * torch.randn((9 * 32, 3), generator=g, device=dev),
              "b": torch.randn(3, generator=g, device=dev)}
    x = torch.randn((op.n_src, 16, 32), generator=g, device=dev).to(BF16)
    kernels.launches.reset()
    out = ops.spiral_conv(params, x, op, out_dtype=torch.float32)
    assert kernels.launches.snapshot()["spiral_conv_f32out"] == 1
    ref = ops.spiral_conv_plain(params["w"].to(BF16).view(9, 32, 3),
                                params["b"].to(BF16), x, op, torch.float32)
    torch.cuda.synchronize()
    assert float((out - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.parametrize("seq,c_in", [(9, 16), (7, 32), (9, 64)])
def test_k3a_other_shapes_keep_the_mma_path(seq, c_in):
    """With tiles, at another shape than the tiled kernel's (9 positions
    of 32 channels), K3a keeps the bf16 kernel's path."""
    dev = _card()
    rng = np.random.default_rng(seq * c_in)
    op = ops.build_spiral_op(rng.integers(0, 3000, (3000, seq))).to(dev)
    assert _k3a_matches_plain(dev, op, 4, c_in=c_in).path == "bf16"


def test_k3a_untiled_mma_path_still_matches(card_geometry):
    """The untiled bf16 kernel, K3a's path before the tiles and still the
    path without them, at the final conv."""
    dev = _card()
    plan = _k3a_matches_plain(dev, card_geometry.spirals[0], 16, tiles=False)
    assert plan.path == "bf16"


def _bf16_conv_matches_plain(dev, op, b, c_in, c_out, seed=1):
    """K1-bf16 within one bf16 ulp of its twin, K3a (fp32 out) within
    1e-5 of the max (fp32 sums in another order), two launches
    bit-equal. Returns the plan."""
    g = _gen(dev, seed)
    seq = op.seq_length
    x = torch.randn((op.n_src, b, c_in), generator=g, device=dev).to(BF16)
    w_l = (0.2 * torch.randn((seq, c_in, c_out), generator=g,
                             device=dev)).to(BF16)
    bias = torch.randn(c_out, generator=g, device=dev).to(BF16)
    kernels.launches.reset()
    out = kernels.spiral_conv_fwd(x, op.table, w_l, bias)
    again = kernels.spiral_conv_fwd(x, op.table, w_l, bias)
    f32 = kernels.spiral_conv_fwd(x, op.table, w_l, bias,
                                  out_dtype=torch.float32)
    counts = kernels.launches.snapshot()
    assert counts["spiral_conv_bf16"] == 2
    assert counts["spiral_conv_f32out"] == 1
    ref = ops.spiral_conv_plain(w_l, bias, x, op)
    ref32 = ops.spiral_conv_plain(w_l, bias, x, op, torch.float32)
    torch.cuda.synchronize()
    assert out.dtype == BF16 and f32.dtype == torch.float32
    _within_ulp(out, ref)
    assert torch.equal(out, again)
    assert float((f32 - ref32).abs().max()) <= 1e-5 * float(
        ref32.abs().max())
    return kernels.plan_spiral_conv(op.num_vertices, b, seq, c_in, c_out,
                                    True, True, BF16)


@pytest.mark.parametrize("m,n_src,seq,b,c_in,c_out", [
    (4260, 17039, 9, 16, 3, 32),      # the bfloat16 policy's first conv
    (1065, 4260, 9, 16, 32, 32),
    (267, 267, 9, 16, 64, 64),        # above 48 KB of shared memory
    (3000, 3000, 9, 16, 32, 3),       # K3a's shape class
    (50, 80, 3, 1, 1, 1),
    (333, 333, 7, 3, 10, 18),         # element path, odd C_out
    (700, 700, 5, 20, 24, 128),       # 16 column tiles
])
def test_spiral_conv_bf16_kernel_matches_plain(m, n_src, seq, b, c_in,
                                               c_out):
    dev = _card()
    rng = np.random.default_rng(m)
    table = rng.integers(0, n_src, size=(m, seq))
    if m == n_src:
        table[:, 0] = np.arange(m)
    op = ops.build_spiral_op(table, n_src=n_src).to(dev)
    plan = _bf16_conv_matches_plain(dev, op, b, c_in, c_out)
    assert plan.path == ("bf16" if c_in % 16 == 0 else "bf16_elem")
    if (m, c_in) == (267, 64):
        assert plan.smem > 48 * 1024


@pytest.mark.parametrize("b", [1, 4, 16])
@pytest.mark.parametrize("name,c_in,c_out", _SMOKE)
def test_spiral_conv_bf16_on_the_model_tables(card_geometry, name, c_in,
                                              c_out, b):
    dev = _card()
    _bf16_conv_matches_plain(dev, _smoke_op(card_geometry, name), b, c_in,
                             c_out)


def _dw_bf16_matches_plain(dev, x, table, dy):
    """K2-dW-bf16 within one bf16 ulp of its chunk-order twin (inside a
    chunk the tensor cores sum in another order), two launches
    bit-equal."""
    m, bsz, c_out = dy.shape
    plan = kernels.plan_spiral_conv_dw_bf16(m, bsz, table.shape[1],
                                            x.shape[2], c_out)
    kernels.launches.reset()
    out = kernels.spiral_conv_dw(x, table, dy)
    again = kernels.spiral_conv_dw(x, table, dy)
    assert kernels.launches.snapshot()["spiral_conv_dw_bf16"] == 2
    ref = ops.spiral_conv_dw_chunked_plain(x, table, dy, plan)
    torch.cuda.synchronize()
    assert out.dtype == BF16
    _within_ulp(out, ref)
    assert torch.equal(out, again)


@pytest.mark.parametrize("m,n_src,seq,b,c_in,c_out", [
    (50, 80, 3, 1, 1, 1),
    (333, 333, 7, 3, 10, 18),
    (100, 100, 9, 2, 128, 96),        # 32 fragments a warp
    (700, 900, 5, 20, 3, 64),
    (20, 20, 9, 1, 64, 3),            # fewer rows than one tile
])
def test_spiral_conv_dw_bf16_kernel_matches_plain(m, n_src, seq, b, c_in,
                                                  c_out):
    dev = _card()
    g = _gen(dev, m)
    table = torch.randint(0, n_src, (m, seq), generator=g, device=dev,
                          dtype=torch.int32)
    x = torch.randn((n_src, b, c_in), generator=g, device=dev).to(BF16)
    dy = torch.randn((m, b, c_out), generator=g, device=dev).to(BF16)
    _dw_bf16_matches_plain(dev, x, table, dy)


@pytest.mark.parametrize("b", [1, 16])
@pytest.mark.parametrize("name,c_in,c_out", _SMOKE)
def test_spiral_conv_dw_bf16_on_the_model_tables(card_geometry, name, c_in,
                                                 c_out, b):
    dev = _card()
    op = _smoke_op(card_geometry, name)
    g = _gen(dev, b)
    x = torch.randn((op.n_src, b, c_in), generator=g, device=dev).to(BF16)
    dy = torch.randn((op.num_vertices, b, c_out), generator=g,
                     device=dev).to(BF16)
    _dw_bf16_matches_plain(dev, x, op.table, dy)


@pytest.mark.parametrize("n,b,seq,o", [(17039, 16, 9, 3), (30, 4, 5, 3),
                                       (100, 1, 7, 5)])
def test_out_gather_sum_kernel_equals_plain(n, b, seq, o):
    """K3b on the position-major ``u [L, O, N, B]``: the bias, then each
    position's gathered value in position order, one rounding each:
    bit-equal to the twin."""
    dev = _card()
    g = _gen(dev, n)
    table = torch.randint(0, n, (n, seq), generator=g, device=dev,
                          dtype=torch.int32)
    table[:, 0] = torch.arange(n, device=dev, dtype=torch.int32)
    u = torch.randn((seq, o, n, b), generator=g, device=dev)
    bias = torch.randn(o, generator=g, device=dev)
    kernels.launches.reset()
    out = kernels.out_gather_sum(u, table, bias)
    assert kernels.launches.snapshot()["out_gather_sum"] == 1
    torch.cuda.synchronize()
    assert torch.equal(out, ops.out_gather_sum_plain(u, table, bias))


@pytest.mark.parametrize("n,b,seq,o,hubs", [
    (17039, 16, 9, 3, False), (30, 4, 5, 3, False), (100, 1, 7, 5, False),
    (3000, 16, 9, 3, True), (500, 3, 9, 7, True)])
def test_out_gather_sum_bwd_kernel_equals_plain(n, b, seq, o, hubs):
    """K3b's backward in one launch: bit-equal to its twin and to the
    stack of the positions' ``CappedEll.apply`` (the fused K4 per
    position), in ``u``'s layout; ``hubs``: a skewed in-degree that gives
    every position overflow tiers, some of them two or three deep."""
    dev = _card()
    rng = np.random.default_rng(n + o)
    table = rng.integers(0, n, size=(n, seq))
    table[:, 0] = np.arange(n)
    if hubs:
        for l in range(1, seq):
            table[rng.random(n) < 0.3, l] = rng.integers(0, 4)
    op = ops.build_spiral_op(table).to(dev)
    if hubs:
        tiers = [len(g.transpose.tiers) for g in op.gathers[1:]]
        assert min(tiers) >= 1 and max(tiers) >= 2, tiers
    dout = torch.randn((n, b, o), generator=_gen(dev, n), device=dev)
    kernels.launches.reset()
    du = kernels.out_gather_sum_bwd(dout, op.out_bwd)
    assert kernels.launches.snapshot()["out_gather_sum_bwd"] == 1
    want = torch.stack([dout if g is None else g.transpose.apply(dout)
                        for g in op.gathers]).permute(0, 3, 1, 2)
    torch.cuda.synchronize()
    assert du.shape == (seq, o, n, b)
    assert torch.equal(du, ops.out_gather_sum_bwd_plain(dout, op.out_bwd))
    assert torch.equal(du, want)


def test_wrappers_reject_what_the_bf16_kernels_do_not_take():
    """Each wrapper takes float32 or bfloat16 rows as they are: another
    dtype, or weights of another dtype than x, raise; none converts."""
    dev = _card()
    cols = torch.zeros(4, 3, dtype=torch.int32, device=dev)
    vals = torch.ones(4, 3, device=dev)
    x = torch.randn(10, 8, device=dev)
    for bad in (x.half(), x.double()):
        with pytest.raises(ValueError):
            kernels.ell_matmul_fwd(cols, vals, bad)
    with pytest.raises(ValueError):                      # vals stay fp32
        kernels.ell_matmul_fwd(cols, vals.to(BF16), x.to(BF16))
    x3 = torch.randn(10, 2, 4, device=dev)
    table = torch.zeros(6, 3, dtype=torch.int32, device=dev)
    w = torch.randn(3, 4, 5, device=dev)
    b = torch.zeros(5, device=dev)
    for args in ((x3.to(BF16), table, w, b),             # W not bf16
                 (x3.to(BF16), table, w.to(BF16), b),    # b not bf16
                 (x3.half(), table, w.half(), b.half())):
        with pytest.raises(ValueError):
            kernels.spiral_conv_fwd(*args)
    with pytest.raises(ValueError):                      # fp32 plan, bf16 x
        kernels.spiral_conv_fwd(x3.to(BF16), table, w.to(BF16), b.to(BF16),
                                kernels.plan_spiral_conv(6, 2, 3, 4, 5))
    with pytest.raises(ValueError):                      # fp32 x, bf16 out
        kernels.spiral_conv_fwd(x3, table, w, b, out_dtype=BF16)
    with pytest.raises(ValueError):                      # a tiled plan, no tiles
        kernels.spiral_conv_fwd(
            torch.randn(6, 2, 32, device=dev).to(BF16),
            torch.zeros(6, 9, dtype=torch.int32, device=dev),
            torch.zeros(9, 32, 3, device=dev).to(BF16),
            torch.zeros(3, device=dev).to(BF16),
            kernels.bf16_tile_plan(2, 1, 6, 2, 128), torch.float32)
    dy = torch.randn(6, 2, 5, device=dev)
    with pytest.raises(ValueError):
        kernels.spiral_conv_dw(x3.to(BF16), table, dy)   # dy not bf16
    with pytest.raises(ValueError):
        kernels.spiral_conv_dw(x3.to(BF16), table, dy.to(BF16),
                               kernels.plan_spiral_conv_dw(6, 2, 3, 4, 5))
    u = torch.randn(3, 5, 10, 2, device=dev)              # [L, O, N, B]
    assert kernels.out_gather_sum(u, table[:, :3].contiguous() % 10,
                                  b).shape == (6, 2, 5)
    for args in ((u.to(BF16), table, b), (u, table[:, :2].contiguous(), b),
                 (u, table, b[:4]), (u.cpu(), table, b),
                 (torch.randn(3, 9, 10, 2, device=dev), table,
                  torch.zeros(9, device=dev))):           # O > 8
        with pytest.raises(ValueError):
            kernels.out_gather_sum(*args)
    bwd = ops.build_spiral_op(np.arange(12).reshape(6, 2) % 6).to(dev).out_bwd
    dout = torch.randn(6, 2, 5, device=dev)
    assert kernels.out_gather_sum_bwd(dout, bwd).shape == (2, 5, 6, 2)
    for bad in (dout.to(BF16), dout[:5], dout.cpu(),
                torch.randn(6, 2, 9, device=dev)):        # O > 8
        with pytest.raises(ValueError):
            kernels.out_gather_sum_bwd(bad, bwd)


_MIXED = SDVAEConfig(out_channels=(8, 8, 8, 16), latent_size=15,
                     compute_dtype="mixed")


def test_mixed_service_on_card_matches_host():
    """A narrow mixed model on the real hierarchy: card vs host within
    1e-2 of each array's max (bf16 roundings may land on the other
    neighbour); the bf16 kernels and K3b launched."""
    dev = _card()
    bundle = load_bundle(FIXTURE)
    n = bundle.vertex_counts[0]
    rng = np.random.default_rng(0)
    mean = rng.normal(size=(n, 3)).astype(np.float32)
    norm = {"mean": mean, "std": np.full((n, 3), 0.1, np.float32)}
    x = (mean + 0.1 * rng.normal(size=(3, n, 3))).astype(np.float32)
    kernels.launches.reset()
    card = DiagnosisService.from_bundle(bundle, _MIXED, norm, 10.0,
                                        max_batch=2,
                                        device=dev).reconstruct(x)
    counts = kernels.launches.snapshot()
    host = DiagnosisService.from_bundle(bundle, _MIXED, norm, 10.0,
                                        max_batch=2,
                                        device="cpu").reconstruct(x)
    assert counts["spiral_conv_tc"] == 2                 # enc0 in fp32
    assert counts["spiral_conv_bf16"] == 2 * 7
    assert counts["ell_matmul_bf16"] == 2 * 4
    assert counts["out_gather_sum"] == 2
    for key in ("vertices", "latent"):
        lim = 1e-2 * float(np.abs(host[key]).max())
        assert float(np.abs(card[key] - host[key]).max()) <= lim


@pytest.mark.parametrize("final_out_gather", [True, False])
def test_mixed_train_step_on_card_matches_host(final_out_gather):
    """One mixed step on the card against the host (same weights, scans,
    region and noise): losses within 1e-2, the whole gradient's cosine
    above 0.999, every gradient fp32; the step launched the bf16
    kernels (K3b or K3a for the final conv)."""
    dev = _card()
    bundle = load_bundle(FIXTURE)
    cfg = dataclasses.replace(_MIXED, final_out_gather=final_out_gather)
    batch = 3
    rng = np.random.default_rng(1)
    x = rng.normal(size=(batch, bundle.vertex_counts[0], 3)).astype(
        np.float32)
    eps = torch.from_numpy(rng.normal(size=(batch * batch, 15)).astype(
        np.float32))
    card, step = _train_setup(bundle, dev, cfg, batch)
    kernels.launches.reset()
    m_card = step(torch.as_tensor(x, device=dev), region_idx=4,
                  eps=eps.to(dev))
    counts = kernels.launches.snapshot()
    host, step_h = _train_setup(bundle, "cpu", cfg, batch)
    m_host = step_h(torch.from_numpy(x), region_idx=4, eps=eps)
    for k in LOSS_KEYS:
        assert abs(float(m_card[k]) - float(m_host[k])) <= \
            1e-2 * abs(float(m_host[k])), k
    ga = torch.cat([p.grad.cpu().ravel() for p in card.parameters()])
    gb = torch.cat([p.grad.ravel() for p in host.parameters()])
    assert ga.dtype == torch.float32
    assert float(ga @ gb / (ga.norm() * gb.norm())) > 0.999
    final = "out_gather_sum" if final_out_gather else "spiral_conv_f32out"
    for kernel in ("spiral_conv_tc", "spiral_conv_bf16", "ell_matmul_bf16",
                   "ell_matmul_capped_bf16", "spiral_conv_dw_bf16",
                   "spiral_conv_dw", final):
        assert counts[kernel] > 0, kernel
    # the matmul-first final conv's backward is one launch
    assert counts["out_gather_sum_bwd"] == int(final_out_gather)


def test_bfloat16_policy_on_card_matches_host():
    """The bfloat16 policy: the first conv's 3-channel rows in bf16 (the
    element path of K1-bf16) on the card against the host."""
    dev = _card()
    bundle = load_bundle(FIXTURE)
    cfg = dataclasses.replace(_MIXED, compute_dtype="bfloat16")
    geom = SpiralGeometry.from_bundle(bundle, device=dev)
    model = init_sdvae(cfg, geom, torch.Generator().manual_seed(0))
    geom_h = SpiralGeometry.from_bundle(bundle, device="cpu")
    host = init_sdvae(cfg, geom_h, torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(bundle.vertex_counts[0], 2, 3)).astype(np.float32))
    kernels.launches.reset()
    with torch.no_grad():
        out, _, mu, _ = model(x.to(dev))
        counts = kernels.launches.snapshot()
        out_h, _, mu_h, _ = host(x)
    assert counts["spiral_conv_tc"] == 0 and counts["spiral_conv_bf16"] == 8
    assert out.dtype == torch.float32
    for got, want in ((out, out_h), (mu, mu_h)):
        assert float((got.cpu() - want).abs().max()) <= \
            1e-2 * float(want.abs().max())


# ------------------------------------------------------------------ K8
def _clouds(dev, r, p, q, offset, seed=0):
    g = _gen(dev, seed)
    x = torch.randn((r, p, 3), generator=g, device=dev) + offset
    y = torch.randn((q, 3), generator=g, device=dev) + offset
    return x, y


def _k8_separated(x, y, mu, tol):
    """Rows of x whose best and second-best distances to y differ by more
    than ``tol``: there the first argmin is unambiguous."""
    keep = []
    for xr in x:
        u, v = xr - mu, y - mu
        e = torch.sum(v * v, -1)[None, :] - 2.0 * (u @ v.T)
        two = torch.topk(e, 2, dim=1, largest=False).values
        keep.append(two[:, 1] - two[:, 0] > tol)
    return torch.stack(keep)


@pytest.mark.parametrize("r,p,q,offset", [
    (16, 4097, 8192, 0.0),      # the fit's restarts and bucketed target
    (1, 4097, 8192, 100.0),     # one cloud, a large frame offset
    (3, 100, 5000, 0.0),        # a ragged tile
])
def test_k8_fwd_kernel_matches_plain(r, p, q, offset):
    """k8_fwd against its twin, both directions: d within 1e-5 of max d
    (another FMA order than the twin's), argmins equal wherever the best
    two distances differ by more than that."""
    dev = _card()
    x, y = _clouds(dev, r, p, q, offset)
    mu = y.mean(0)
    d_x, d_y, a, b = ops.distances.nearest_dists_sq_sym_plain(x, y)
    for query, ref, d_ref, idx_ref in ((x, y, d_x, a), (y, x, d_y, b)):
        d, idx = kernels.nearest_sq(query, ref, mu)
        torch.cuda.synchronize()
        tol = 1e-5 * float(d_ref.max())
        assert float((d - d_ref).abs().max()) <= tol
        qb = query if query.dim() == 3 else query.expand(r, -1, -1)
        rb = ref if ref.dim() == 3 else ref.expand(r, -1, -1)
        sep = torch.stack([_k8_separated(qb[i:i + 1], rb[i], mu, tol)[0]
                           for i in range(r)])
        assert sep.float().mean() > 0.9
        assert torch.equal(idx[sep], idx_ref[sep])


def _same_argmins(a1, b1, a2, b2):
    """The points whose chamfer gradient reads the same argmins in both
    evaluations: x keeps its argmin and the y points choosing it, y
    likewise over every batch."""
    r, q = b1.shape
    keep_x = a1 == a2
    keep_y = torch.ones(q, dtype=torch.bool)
    for i in range(r):
        moved = (b1[i] != b2[i]).nonzero()[:, 0]
        keep_x[i, b1[i][moved].long()] = False
        keep_x[i, b2[i][moved].long()] = False
        keep_y[moved] = False
        swapped = (a1[i] != a2[i]).nonzero()[:, 0]
        keep_y[a1[i][swapped].long()] = False
        keep_y[a2[i][swapped].long()] = False
    return keep_x, keep_y


@pytest.mark.parametrize("r,p,q", [(16, 4097, 8192), (1, 300, 1000)])
def test_k8_gradients_on_card_match_host(r, p, q):
    """The chamfer's gradient in both clouds through k8_fwd/k8_bwd
    against the host's twins: within 1e-4 of each gradient's max at every
    point whose gradient reads the same argmins on both (at a near tie
    the card and the host may pick two equally near points, whose
    differences differ by their distance, not by rounding); fewer than
    1 % of the points are such."""
    dev = _card()
    x, y = _clouds(dev, r, p, q, 0.0, seed=3)
    g = _gen(dev, 4)
    gx = torch.randn((r, p), generator=g, device=dev)
    gy = torch.randn((r, q), generator=g, device=dev)
    grads = []
    for d in (dev, torch.device("cpu")):
        xs = x.detach().to(d).clone().requires_grad_(True)
        ys = y.detach().to(d).clone().requires_grad_(True)
        dx, dy = ops.distances.nearest_dists_sq_sym(xs, ys)
        ((dx * gx.to(d)).sum() + (dy * gy.to(d)).sum()).backward()
        grads.append((xs.grad.cpu(), ys.grad.cpu()))
    mu = y.mean(0)
    _, a = kernels.nearest_sq(x, y, mu)
    _, b = kernels.nearest_sq(y, x, mu)
    _, _, ha, hb = ops.distances.nearest_dists_sq_sym_plain(x.cpu(), y.cpu())
    keeps = _same_argmins(a.cpu(), b.cpu(), ha, hb)
    for (card_g, host_g), keep in zip(zip(*grads), keeps):
        assert float(keep.float().mean()) > 0.99
        scale = float(host_g.abs().max())
        assert float((card_g[keep] - host_g[keep]).abs().max()) \
            <= 1e-4 * scale


def test_k8_launch_counts_and_checks():
    """One differentiable call launches k8_fwd twice (both directions)
    and its backward in x once k8_bwd; the wrappers refuse what the
    kernels do not take."""
    dev = _card()
    x, y = _clouds(dev, 2, 50, 70, 0.0)
    x.requires_grad_(True)
    kernels.launches.reset()
    dx, dy = ops.distances.nearest_dists_sq_sym(x, y)
    (dx.sum() + dy.sum()).backward()
    counts = kernels.launches.snapshot()
    assert counts["k8_fwd"] == 2 and counts["k8_bwd"] == 1
    mu = y.mean(0)
    with pytest.raises(ValueError):
        kernels.nearest_sq(x.detach().cpu(), y, mu)
    with pytest.raises(ValueError):
        kernels.nearest_sq(x.detach().double(), y, mu)
    with pytest.raises(ValueError):
        kernels.nearest_sq(x.detach(), y[:0], mu)
    with pytest.raises(ValueError):
        kernels.nearest_sq(x.detach(), torch.zeros((3, 70, 3), device=dev),
                           mu)

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

from craniofacialsd_vae_tpu_torch import graphs, kernels, ops
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


def _bucket_passes():
    """The passes the wrappers see when a request of 3 scans at
    max_batch 2 meets a fresh service on the card: its two buckets' CUDA
    graphs, each captured after its warm-up passes (a replay launches
    the captured kernels without the wrappers)."""
    from craniofacialsd_vae_tpu_torch.serving import WARMUP_PASSES

    return 2 * (1 + WARMUP_PASSES)


def test_service_on_card_matches_host():
    """A narrow model on the real hierarchy: card vs host, rtol 1e-4
    against each array's max and 1e-3 mm on the error; the first request
    captures its buckets' graphs, and a second one only replays them."""
    dev = _card()
    bundle = load_bundle(FIXTURE)
    cfg = SDVAEConfig(out_channels=(8, 8, 8, 16), latent_size=6)
    n = bundle.vertex_counts[0]
    rng = np.random.default_rng(0)
    mean = rng.normal(size=(n, 3)).astype(np.float32)
    norm = {"mean": mean, "std": np.full((n, 3), 0.1, np.float32)}
    x = (mean + 0.1 * rng.normal(size=(3, n, 3))).astype(np.float32)
    kernels.launches.reset()
    svc = DiagnosisService.from_bundle(bundle, cfg, norm, 10.0, max_batch=2,
                                       device=dev)
    card = svc.reconstruct(x)
    counts = kernels.launches.snapshot()
    graphs.replayed.reset()
    again = svc.reconstruct(x)
    assert kernels.launches.snapshot() == counts
    # the second request: one replay of each of its two buckets' graphs
    assert graphs.replayed.snapshot()["spiral_conv_tc"] == 2 * 8
    host = DiagnosisService.from_bundle(bundle, cfg, norm, 10.0, max_batch=2,
                                        device="cpu").reconstruct(x)
    passes = _bucket_passes()
    assert counts["spiral_conv_tc"] == passes * 8
    assert counts["spiral_conv_narrow"] == passes
    assert counts["ell_matmul_fwd"] == passes * 4
    for key in card:
        np.testing.assert_array_equal(again[key], card[key])
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
    """Every tiered transpose of a training step's geometry (the
    Laplacian's and the up-pools', which the step applies, and the convs'
    combined ones, which K2-dx reads its padding from; 13 tables, 34
    tiers): one fused launch each, bit-equal to the sequential twin, at
    the step's widths for a grid of b meshes and at an odd width (the
    scalar path)."""
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
    kernels: K1, K2-dx (a tiered combined transpose no longer applied)
    and K2-dW each counted, and the fused K4 of a tiered gather's
    transpose."""
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
    assert counts["spiral_conv_dx"] == 1
    assert counts["ell_matmul_fwd"] == 0 and counts["ell_matmul_capped"] == 0
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
    """The bf16 transposes of a mixed step's geometry (the up-pools',
    which the step applies, and the bf16 convs' combined ones): one launch
    each, bit-equal to the twin."""
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
    of 32 channels), K3a takes the bf16 kernel's tiled vector path."""
    dev = _card()
    rng = np.random.default_rng(seq * c_in)
    op = ops.build_spiral_op(rng.integers(0, 3000, (3000, seq))).to(dev)
    assert _k3a_matches_plain(dev, op, 4, c_in=c_in).path == "bf16"


def test_k3a_untiled_mma_path_still_matches(card_geometry):
    """The untiled bf16 kernel (its element path), the path without
    tiles, at the final conv."""
    dev = _card()
    plan = _k3a_matches_plain(dev, card_geometry.spirals[0], 16, tiles=False)
    assert plan.path == "bf16_elem"


def _bf16_conv_matches_plain(dev, op, b, c_in, c_out, seed=1, offset=0,
                             plan=None):
    """K1-bf16 through the op's tiles within one bf16 ulp of its twin,
    K3a (fp32 out) within 1e-5 of the max (fp32 sums in another order),
    two launches bit-equal; x starts ``offset`` values into its buffer;
    ``plan``: the launch to run (default: the planner's). Returns the
    plan."""
    g = _gen(dev, seed)
    seq = op.seq_length
    base = torch.randn(op.n_src * b * c_in + offset, generator=g,
                       device=dev).to(BF16)
    x = base[offset:].view(op.n_src, b, c_in)
    w_l = (0.2 * torch.randn((seq, c_in, c_out), generator=g,
                             device=dev)).to(BF16)
    bias = torch.randn(c_out, generator=g, device=dev).to(BF16)
    t = op.tiles
    if plan is None:
        plan = kernels.plan_spiral_conv(op.num_vertices, b, seq, c_in, c_out,
                                        x.data_ptr() % 4 == 0, True, BF16,
                                        t.n_tiles, t.max_rows)
    kernels.launches.reset()
    out = kernels.spiral_conv_fwd(x, op.table, w_l, bias, plan, tiles=t)
    again = kernels.spiral_conv_fwd(x, op.table, w_l, bias, plan, tiles=t)
    f32 = kernels.spiral_conv_fwd(x, op.table, w_l, bias, plan,
                                  out_dtype=torch.float32, tiles=t)
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
    return plan


@pytest.mark.parametrize("m,n_src,seq,b,c_in,c_out", [
    (4260, 17039, 9, 16, 3, 32),      # the bfloat16 policy's first conv
    (1065, 4260, 9, 16, 32, 32),
    (267, 267, 9, 16, 64, 64),        # also a plan above 48 KB
    (3000, 3000, 9, 16, 32, 3),       # K3a's shape class: its tiled kernel
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
    assert plan.path == ("bf16_tile" if c_out < 8 and (seq, c_in) == (9, 32)
                         else "bf16" if c_in % 16 == 0 else "bf16_elem")
    if (m, c_in) == (267, 64):
        wide = kernels.bf16_vec_plan(b, seq, c_in, c_out, op.tiles.n_tiles,
                                     op.tiles.max_rows, 4, 8, per_sm=1)
        assert wide.smem > 48 * 1024
        _bf16_conv_matches_plain(dev, op, b, c_in, c_out, plan=wide)


@pytest.mark.parametrize("c_out", [3, 32, 64])
@pytest.mark.parametrize("m,b", [(333, 16), (1001, 3), (77, 1)])
def test_spiral_conv_bf16_vec_at_odd_m(m, b, c_out):
    """The tiled vector path (C_in = 32, with tiles; the final conv's
    C_out = 3 at L = 7, where K3a's kernel is not compiled) at odd M,
    against its twin."""
    dev = _card()
    seq = 7 if c_out < 8 else 9
    rng = np.random.default_rng(m + c_out)
    table = rng.integers(0, m, size=(m, seq))
    table[:, 0] = np.arange(m)
    op = ops.build_spiral_op(table).to(dev)
    assert _bf16_conv_matches_plain(dev, op, b, 32, c_out).path == "bf16"


@pytest.mark.parametrize("b", [16, 3])
def test_spiral_conv_bf16_vec_with_misaligned_x(card_geometry, b):
    """x on 4 bytes but not on 16: the tiled vector path copies 4 bytes
    at a time; x on 2 bytes takes the element path, as the planner
    names."""
    dev = _card()
    op = card_geometry.spirals[1]
    assert _bf16_conv_matches_plain(dev, op, b, 32, 32,
                                    offset=2).path == "bf16"
    assert _bf16_conv_matches_plain(dev, op, b, 32, 32,
                                    offset=1).path == "bf16_elem"


@pytest.mark.parametrize("b", [1, 3, 4, 16])
@pytest.mark.parametrize("name,c_in,c_out", _SMOKE)
def test_spiral_conv_bf16_on_the_model_tables(card_geometry, name, c_in,
                                              c_out, b):
    dev = _card()
    _bf16_conv_matches_plain(dev, _smoke_op(card_geometry, name), b, c_in,
                             c_out)


def _dw_bf16_matches_plain(dev, op, b, c_in, c_out, seed=0, offset=0):
    """K2-dW-bf16 through the op's tiles within one bf16 ulp of its
    chunk-order twin (inside a chunk the tensor cores sum in another
    order), two launches bit-equal; x and dy start ``offset`` values into
    their buffers. Returns the plan."""
    g = _gen(dev, seed)
    m, seq, t = op.num_vertices, op.seq_length, op.tiles
    xb = torch.randn(op.n_src * b * c_in + offset, generator=g,
                     device=dev).to(BF16)
    db = torch.randn(m * b * c_out + offset, generator=g,
                     device=dev).to(BF16)
    x = xb[offset:].view(op.n_src, b, c_in)
    dy = db[offset:].view(m, b, c_out)
    plan = kernels.plan_spiral_conv_dw_bf16(
        m, b, seq, c_in, c_out, t.n_tiles, t.max_rows, t.max_verts,
        x.data_ptr() % 16 == 0, dy.data_ptr() % 16 == 0)
    kernels.launches.reset()
    out = kernels.spiral_conv_dw(x, op.table, dy, tiles=t)
    again = kernels.spiral_conv_dw(x, op.table, dy, plan, tiles=t)
    assert kernels.launches.snapshot()["spiral_conv_dw_bf16"] == 2
    ref = ops.spiral_conv_dw_chunked_plain(x, op.table, dy, plan, t)
    torch.cuda.synchronize()
    assert out.dtype == BF16
    _within_ulp(out, ref)
    assert torch.equal(out, again)
    return plan


def _random_op(dev, m, n_src, seq, seed):
    rng = np.random.default_rng(seed)
    table = rng.integers(0, n_src, size=(m, seq))
    if m == n_src:
        table[:, 0] = np.arange(m)
    return ops.build_spiral_op(table, n_src=n_src).to(dev)


@pytest.mark.parametrize("m,n_src,seq,b,c_in,c_out", [
    (50, 80, 3, 1, 1, 1),
    (333, 333, 7, 3, 10, 18),
    (100, 100, 9, 2, 128, 96),        # 16 column fragments, 1 position
    (700, 900, 5, 20, 3, 64),
    (20, 20, 9, 1, 64, 3),            # fewer rows than one k16 step
])
def test_spiral_conv_dw_bf16_kernel_matches_plain(m, n_src, seq, b, c_in,
                                                  c_out):
    dev = _card()
    _dw_bf16_matches_plain(dev, _random_op(dev, m, n_src, seq, m), b, c_in,
                           c_out, seed=m)


@pytest.mark.parametrize("b", [1, 3, 4, 16])
@pytest.mark.parametrize("name,c_in,c_out", _SMOKE)
def test_spiral_conv_dw_bf16_on_the_model_tables(card_geometry, name, c_in,
                                                 c_out, b):
    dev = _card()
    _dw_bf16_matches_plain(dev, _smoke_op(card_geometry, name), b, c_in,
                           c_out, seed=b)


@pytest.mark.parametrize("c_out", [3, 32, 64])
@pytest.mark.parametrize("m,b", [(333, 16), (1001, 3), (77, 1)])
def test_spiral_conv_dw_bf16_at_odd_m(m, b, c_out):
    """K2-dW-bf16 at odd M (tiles of odd vertex counts, k16 steps past
    the tile's rows) and C_out 3 (dy staged value by value), 32, 64."""
    dev = _card()
    plan = _dw_bf16_matches_plain(dev, _random_op(dev, m, m, 9, m + c_out),
                                  b, 32, c_out, seed=c_out)
    assert plan.vec_x and plan.vec_d == (c_out % 8 == 0)


@pytest.mark.parametrize("offset", [2, 1])
def test_spiral_conv_dw_bf16_with_misaligned_rows(card_geometry, offset):
    """x and dy off 16 bytes: the plan stages both value by value."""
    dev = _card()
    plan = _dw_bf16_matches_plain(dev, card_geometry.spirals[1], 4, 32, 32,
                                  offset=offset)
    assert not plan.vec_x and not plan.vec_d


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


def _hub_table(n, seq, seed):
    """In-degrees that follow a power law (entries ``n · u³``): most
    positions' transposes get three overflow tiers, and the hub's own
    run stages more rows than a block holds at every batch row."""
    rng = np.random.default_rng(seed)
    table = (n * rng.random((n, seq)) ** 3).astype(np.int64)
    table[:, 0] = np.arange(n)
    return table


def _same_nan(a, b):
    """Bit-equal but for NaN payloads (the card's 0 · NaN is its canonical
    NaN, the host's keeps the operand's)."""
    torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("n,b,seq,o,hubs,verts,bad_row0", [
    (17039, 16, 9, 3, False, None, False), (30, 4, 5, 3, False, None, False),
    (100, 1, 7, 5, False, None, False), (3000, 16, 9, 3, True, None, False),
    (500, 3, 9, 7, True, None, False), (17039, 4, 9, 3, False, None, False),
    (17039, 1, 9, 3, False, None, False), (17039, 20, 9, 3, False, None,
                                           False),
    (3000, 3, 9, 1, "three", None, False), (3000, 16, 9, 8, "three", None,
                                            False),
    (3000, 20, 9, 3, "three", None, True), (3000, 4, 9, 3, "three", 1, False),
    (2000, 16, 9, 3, False, 1, True), (500, 40, 9, 8, "three", None, False)])
def test_out_gather_sum_bwd_kernel_equals_plain(n, b, seq, o, hubs, verts,
                                                bad_row0):
    """K3b's backward in one launch over the op's runs: bit-equal to its
    twin, to the tile-order twin, to the stack of the positions'
    ``CappedEll.apply`` (the fused K4 per position) and across two
    launches, in ``u``'s layout. ``hubs``: a skewed in-degree that gives
    every position overflow tiers, some of them two or three deep
    ("three": a power law, three tiers, and runs too large for one block
    at the whole batch, so the batch is sliced); ``verts`` 1: runs of
    single vertices; ``bad_row0``: NaN and infinity in dout's row 0, which
    every padding entry reads with weight 0."""
    dev = _card()
    rng = np.random.default_rng(n + o)
    if hubs == "three":
        table = _hub_table(n, seq, n)
    else:
        table = rng.integers(0, n, size=(n, seq))
        table[:, 0] = np.arange(n)
        if hubs:
            for l in range(1, seq):
                table[rng.random(n) < 0.3, l] = rng.integers(0, 4)
    host = ops.build_spiral_op(table)
    if verts:
        host.out_bwd.runs = ops.build_out_gather_runs(host.out_bwd, verts)
    op = host.to(dev)
    runs = op.out_bwd.runs
    if hubs:
        tiers = [len(g.transpose.tiers) for g in op.gathers[1:]]
        assert min(tiers) >= 1 and max(tiers) >= (3 if hubs == "three"
                                                  else 2), tiers
    if verts:
        assert runs.n_runs == n
    dout = torch.randn((n, b, o), generator=_gen(dev, n), device=dev)
    if bad_row0:
        dout[0, 0] = float("nan")
        dout[0, -1] = float("inf")
        dout[1] = -0.0
    kernels.launches.reset()
    du = kernels.out_gather_sum_bwd(dout, op.out_bwd)
    assert kernels.launches.snapshot()["out_gather_sum_bwd"] == 1
    again = kernels.out_gather_sum_bwd(dout, op.out_bwd)
    want = torch.stack([dout if g is None else g.transpose.apply(dout)
                        for g in op.gathers]).permute(0, 3, 1, 2)
    torch.cuda.synchronize()
    assert du.shape == (seq, o, n, b)
    _same_nan(du, again)
    assert torch.equal(du.isnan(), again.isnan())
    _same_nan(du, ops.out_gather_sum_bwd_plain(dout, op.out_bwd))
    _same_nan(du, ops.out_gather_sum_bwd_tiles_plain(dout, runs))
    _same_nan(du, want)
    if bad_row0:
        assert bool(du.isnan().any())
    if hubs == "three" and b >= 16:
        assert kernels.out_gather_bwd_plan(runs, b, o)[0] < b


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
    x32 = torch.randn(6, 2, 32, device=dev).to(BF16)
    t9 = torch.zeros(6, 9, dtype=torch.int32, device=dev)
    w32 = torch.zeros(9, 32, 3, device=dev).to(BF16)
    b3 = torch.zeros(3, device=dev).to(BF16)
    for plan in (kernels.bf16_tile_plan(2, 1, 6, 2, 128),   # tiled plans,
                 kernels.bf16_vec_plan(2, 9, 32, 3, 1, 6, 2, 1)):  # no tiles
        with pytest.raises(ValueError):
            kernels.spiral_conv_fwd(x32, t9, w32, b3, plan, torch.float32)
    op6 = ops.build_spiral_op(np.arange(54).reshape(6, 9) % 6).to(dev)
    with pytest.raises(ValueError):             # tiles of another table
        kernels.spiral_conv_fwd(x32, t9[:5].contiguous(), w32, b3,
                                kernels.bf16_vec_plan(2, 9, 32, 3, 1, 6, 2, 1),
                                tiles=op6.tiles)
    dy = torch.randn(6, 2, 5, device=dev)
    with pytest.raises(ValueError):
        kernels.spiral_conv_dw(x3.to(BF16), table, dy)   # dy not bf16
    with pytest.raises(ValueError):
        kernels.spiral_conv_dw(x3.to(BF16), table, dy.to(BF16),
                               kernels.plan_spiral_conv_dw(6, 2, 3, 4, 5))
    op3 = ops.build_spiral_op(np.arange(18).reshape(6, 3) % 6).to(dev)
    assert kernels.spiral_conv_dw(x3.to(BF16), op3.table, dy.to(BF16),
                                  tiles=op3.tiles).shape == (3, 4, 5)
    with pytest.raises(ValueError):                      # K2-dW-bf16, no tiles
        kernels.spiral_conv_dw(x3.to(BF16), op3.table, dy.to(BF16))
    t = op3.tiles
    short = dataclasses.replace(kernels.plan_spiral_conv_dw_bf16(
        6, 2, 3, 4, 5, t.n_tiles, t.max_rows, t.max_verts),
        rows=t.max_rows - 1)
    with pytest.raises(ValueError):                      # rows that do not fit
        kernels.spiral_conv_dw(x3.to(BF16), op3.table, dy.to(BF16), short,
                               tiles=t)
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
    passes = _bucket_passes()
    assert counts["spiral_conv_tc"] == passes            # enc0 in fp32
    assert counts["spiral_conv_bf16"] == passes * 7
    assert counts["ell_matmul_bf16"] == passes * 4
    assert counts["out_gather_sum"] == passes
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
def _clouds(dev, r, p, q, offset, seed=0, q_valid=None):
    """``r`` clouds of ``p`` points and one of ``q``; with ``q_valid``, the
    last ``q - q_valid`` points of the second are copies of its first, as
    the fit pads its target."""
    g = _gen(dev, seed)
    x = torch.randn((r, p, 3), generator=g, device=dev) + offset
    y = torch.randn((q, 3), generator=g, device=dev) + offset
    if q_valid is not None:
        y[q_valid:] = y[0]
    return x, y


def _k8_separated(x, y, mu, tol):
    """Rows of x whose best and second-best distances to y differ by more
    than ``tol``: there the lowest argmin is unambiguous."""
    keep = []
    for xr in x:
        u, v = xr - mu, y - mu
        e = torch.sum(v * v, -1)[None, :] - 2.0 * (u @ v.T)
        two = torch.topk(e, 2, dim=1, largest=False).values
        keep.append(two[:, 1] - two[:, 0] > tol)
    return torch.stack(keep)


K8_SHAPES = [
    (16, 4097, 8192, 0.0, None),    # the fit's restarts and bucketed target
    (16, 4097, 8192, 0.0, 7500),    # a padded target: 692 copies of y[0]
    (1, 4097, 8192, 100.0, None),   # one cloud, a large frame offset
    (3, 100, 5000, 0.0, None),      # ragged tiles and column ranges
]


@pytest.mark.parametrize("r,p,q,offset,q_valid", K8_SHAPES)
def test_k8_fwd_kernel_matches_plain(r, p, q, offset, q_valid):
    """One k8_fwd against its twin, both directions: d within 1e-5 of max d
    (another FMA order than the twin's), argmins equal wherever the best
    two distances differ by more than that, and where they tie exactly
    (the padded copies) the lowest index."""
    dev = _card()
    x, y = _clouds(dev, r, p, q, offset, q_valid=q_valid)
    mu = y.mean(0)
    d_x, d_y, a, b = ops.distances.nearest_dists_sq_sym_plain(x, y)
    kernels.launches.reset()
    got = kernels.nearest_sq_sym(x, y, mu)
    torch.cuda.synchronize()
    assert kernels.launches.snapshot()["k8_fwd"] == 1
    tol = 1e-5 * float(torch.maximum(d_x.max(), d_y.max()))
    for d, d_ref in ((got[0], d_x), (got[1], d_y)):
        assert float((d - d_ref).abs().max()) <= tol
    for query, ref, idx, idx_ref in ((x, y, got[2], a), (y, x, got[3], b)):
        qb = query if query.dim() == 3 else query.expand(r, -1, -1)
        rb = ref if ref.dim() == 3 else ref.expand(r, -1, -1)
        sep = torch.stack([_k8_separated(qb[i:i + 1], rb[i], mu, tol)[0]
                           for i in range(r)])
        assert sep.float().mean() > 0.9
        assert torch.equal(idx[sep], idx_ref[sep])
    if q_valid is not None:
        # a copy of y[0] never wins a row of x, and every copy takes the
        # argmin y[0] takes
        assert int((got[2] >= q_valid).sum()) == 0
        assert torch.equal(got[3][:, q_valid:],
                           got[3][:, :1].expand(-1, q - q_valid))


def test_k8_fwd_one_direction_matches_both():
    """``nearest_sq`` (the column reduction off) gives the row direction of
    ``nearest_sq_sym`` bit for bit, in one k8_fwd."""
    dev = _card()
    x, y = _clouds(dev, 16, 4097, 8192, 0.0, seed=5)
    mu = y.mean(0)
    d_x, _, a, _ = kernels.nearest_sq_sym(x, y, mu)
    kernels.launches.reset()
    d, idx = kernels.nearest_sq(x, y, mu)
    torch.cuda.synchronize()
    assert kernels.launches.snapshot()["k8_fwd"] == 1
    assert torch.equal(d, d_x) and torch.equal(idx, a)
    one = ops.distances.nearest_dists_sq(x[0], y)
    assert torch.equal(one, kernels.nearest_sq(x[0], y, mu)[0][0])


def test_k8_ties_go_to_the_lowest_index():
    """Exact ties in both directions: duplicated points of either cloud
    give equal distances, and the lowest index wins, as in the twin."""
    dev = _card()
    x, y = _clouds(dev, 2, 700, 1500, 0.0, seed=7)
    x[:, 600:650] = x[:, 10:60]          # rows tied for their columns
    y[1200:1300] = y[100:200]            # columns tied for their rows
    mu = y.mean(0)
    d_x, d_y, a, b = kernels.nearest_sq_sym(x, y, mu)
    _, _, ha, hb = ops.distances.nearest_dists_sq_sym_plain(x, y)
    torch.cuda.synchronize()
    assert int(((a >= 1200) & (a < 1300)).sum()) == 0
    assert int(((b >= 600) & (b < 650)).sum()) == 0
    won = (a >= 100) & (a < 200)
    assert int(won.sum()) > 0 and torch.equal(a[won], ha[won])
    won = (b >= 10) & (b < 60)
    assert int(won.sum()) > 0 and torch.equal(b[won], hb[won])


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


@pytest.mark.parametrize("r,p,q,q_valid", [(16, 4097, 8192, None),
                                           (16, 4097, 8192, 7500),
                                           (1, 300, 1000, None)])
def test_k8_gradients_on_card_match_host(r, p, q, q_valid):
    """The chamfer's gradient in both clouds through k8_fwd/k8_bwd
    against the host's twins: within 1e-4 of each gradient's max at every
    point whose gradient reads the same argmins on both (at a near tie
    the card and the host may pick two equally near points, whose
    differences differ by their distance, not by rounding); fewer than
    1 % of the points are such."""
    dev = _card()
    x, y = _clouds(dev, r, p, q, 0.0, seed=3, q_valid=q_valid)
    g = _gen(dev, 4)
    gx = torch.randn((r, p), generator=g, device=dev)
    gy = torch.randn((r, q), generator=g, device=dev)
    if q_valid is not None:
        gy[:, q_valid:] = 0.0            # the fit masks its padding
    grads = []
    for d in (dev, torch.device("cpu")):
        xs = x.detach().to(d).clone().requires_grad_(True)
        ys = y.detach().to(d).clone().requires_grad_(True)
        dx, dy = ops.distances.nearest_dists_sq_sym(xs, ys)
        ((dx * gx.to(d)).sum() + (dy * gy.to(d)).sum()).backward()
        grads.append((xs.grad.cpu(), ys.grad.cpu()))
    mu = y.mean(0)
    _, _, a, b = kernels.nearest_sq_sym(x, y, mu)
    _, _, ha, hb = ops.distances.nearest_dists_sq_sym_plain(x.cpu(), y.cpu())
    keeps = _same_argmins(a.cpu(), b.cpu(), ha, hb)
    for (card_g, host_g), keep in zip(zip(*grads), keeps):
        assert float(keep.float().mean()) > 0.99
        scale = float(host_g.abs().max())
        assert float((card_g[keep] - host_g[keep]).abs().max()) \
            <= 1e-4 * scale


@pytest.mark.parametrize("r,p,q,q_valid", [(16, 4097, 8192, None),
                                           (16, 4097, 8192, 7500),
                                           (2, 1300, 700, None)])
def test_k8_bwd_csr_equals_argmin_csr(r, p, q, q_valid):
    """The CSR k8_bwd builds (written out where asked) equals
    ``argmin_csr`` element for element, in both directions, and the
    gradient equals the twin's over that CSR within 1e-5 of its max (the
    same products and sums, rounded one by one in the same order)."""
    dev = _card()
    x, y = _clouds(dev, r, p, q, 0.0, seed=11, q_valid=q_valid)
    mu = y.mean(0)
    d_x, d_y, a, b = kernels.nearest_sq_sym(x, y, mu)
    g = _gen(dev, 12)
    gx = torch.randn((r, p), generator=g, device=dev)
    gy = torch.randn((r, q), generator=g, device=dev)
    for args, n_bins in (((x, y, mu, gx, d_x, a, gy, d_y, b), p),
                         ((y, x, mu, gy, d_y, b, gx, d_x, a), q)):
        kernels.launches.reset()
        out, perm, off = kernels.nearest_sq_bwd(*args, csr=True)
        torch.cuda.synchronize()
        assert kernels.launches.snapshot()["k8_bwd"] == 1
        want_perm, want_off = ops.distances.argmin_csr(args[-1], n_bins)
        assert torch.equal(perm, want_perm) and torch.equal(off, want_off)
        plain = ops.distances.nearest_sq_bwd_plain(*args[:-1], want_perm,
                                                   want_off)
        assert float((out - plain).abs().max()) <= \
            1e-5 * float(plain.abs().max())
        assert torch.equal(out, kernels.nearest_sq_bwd(*args))


def test_k8_runs_are_bit_identical():
    """Two launches on the same inputs give the same distances, argmins
    and gradients, bit for bit (no float atomics; the argmins' keys and the
    CSR's counts are exact)."""
    dev = _card()
    x, y = _clouds(dev, 16, 4097, 8192, 0.0, seed=13, q_valid=7000)
    runs = []
    for _ in range(2):
        xs = x.clone().requires_grad_(True)
        ys = y.clone().requires_grad_(True)
        dx, dy = ops.distances.nearest_dists_sq_sym(xs, ys)
        (dx.sum() + (dy * torch.arange(8192, device=dev)).sum()).backward()
        mu = y.mean(0)
        runs.append((dx, dy, *kernels.nearest_sq_sym(x, y, mu)[2:],
                     xs.grad, ys.grad))
    torch.cuda.synchronize()
    for first, second in zip(*runs):
        assert torch.equal(first, second)


def test_k8_launch_counts_and_checks():
    """One differentiable call launches k8_fwd once (both directions in one
    pass) and its backward one k8_bwd per cloud that needs a gradient; the
    wrappers refuse what the kernels do not take."""
    dev = _card()
    x, y = _clouds(dev, 2, 50, 70, 0.0)
    x.requires_grad_(True)
    kernels.launches.reset()
    dx, dy = ops.distances.nearest_dists_sq_sym(x, y)
    (dx.sum() + dy.sum()).backward()
    counts = kernels.launches.snapshot()
    assert counts["k8_fwd"] == 1 and counts["k8_bwd"] == 1
    y.requires_grad_(True)
    kernels.launches.reset()
    dx, dy = ops.distances.nearest_dists_sq_sym(x, y)
    (dx.sum() + dy.sum()).backward()
    counts = kernels.launches.snapshot()
    assert counts["k8_fwd"] == 1 and counts["k8_bwd"] == 2
    mu = y.detach().mean(0)
    xd, yd = x.detach(), y.detach()
    with pytest.raises(ValueError):
        kernels.nearest_sq_sym(xd.cpu(), yd, mu)
    with pytest.raises(ValueError):
        kernels.nearest_sq_sym(xd.double(), yd, mu)
    with pytest.raises(ValueError):
        kernels.nearest_sq(xd, yd[:0], mu)
    with pytest.raises(ValueError):
        kernels.nearest_sq_sym(xd, torch.zeros((3, 70, 3), device=dev), mu)
    d_x, d_y, a, b = kernels.nearest_sq_sym(xd, yd, mu)
    with pytest.raises(ValueError):
        kernels.nearest_sq_bwd(xd, yd, mu, d_x, d_x, a, d_y, d_y, a)


# ---------------------------------------------------------------- K9
def _cheby_case(dev, subdivisions, d, seed=0):
    """The octasphere's ELL Laplacian on ``dev`` (with K9's tiles) and
    seeded panels x, p and per-column c ``[d]``."""
    from craniofacialsd_vae_tpu_torch.geometry import synthetic_template
    from craniofacialsd_vae_tpu_torch.ops import eigh

    lap = eigh._EllLaplacian(synthetic_template(subdivisions, 3), dev)
    g = _gen(dev, seed)
    n = lap.cols.shape[0]
    x = torch.randn((n, d), generator=g, device=dev)
    p = torch.randn((n, d), generator=g, device=dev)
    c = torch.rand((d,), generator=g, device=dev) * lap.ub
    return lap, x, p, c


def _cheby_args(form, c, d):
    if form == "body":
        return (c.new_full((d,), float(c[0])), 0.37, -1.25)
    if form == "b0":
        return (c.new_full((d,), float(c[0])), -0.11, 0.0)
    return (c, 1.0, 0.0)


@pytest.mark.parametrize("subdivisions,d", [(6, 1125), (3, 37), (2, 5),
                                            (4, 128)])
@pytest.mark.parametrize("form", ["body", "b0", "columns"])
def test_cheby_step_kernel_equals_plain(subdivisions, d, form):
    """K9 (tiled) against its twin: the same products and sums in the
    same order, each rounded, so bit-equal; two launches bit-identical."""
    from craniofacialsd_vae_tpu_torch.ops import eigh

    dev = _card()
    lap, x, p, c = _cheby_case(dev, subdivisions, d)
    cv, a, b = _cheby_args(form, c, d)
    pp = p if b != 0.0 else None
    out = kernels.cheby_step(lap.cols, lap.vals, x, cv, a, b, pp,
                             tiles=lap.tiles)
    ref = eigh.cheby_step_plain(lap.cols, lap.vals, x, cv, a, b, pp)
    again = kernels.cheby_step(lap.cols, lap.vals, x, cv, a, b, pp,
                               tiles=lap.tiles)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    assert torch.equal(out, again)


@pytest.mark.parametrize("subdivisions,d", [(6, 1125), (3, 37), (2, 5),
                                            (4, 128)])
@pytest.mark.parametrize("form", ["body", "b0", "columns"])
def test_cheby_step_padded_panels_equal_plain(subdivisions, d, form):
    """The solver's layout (``eigh.panel``: rows at a stride padded to 8
    floats, 16-byte copies): bit-equal to the twin, the output at x's
    strides."""
    from craniofacialsd_vae_tpu_torch.ops import eigh

    dev = _card()
    lap, x, p, c = _cheby_case(dev, subdivisions, d, seed=1)
    cv, a, b = _cheby_args(form, c, d)
    xs, ps = eigh._as_panel(x), eigh._as_panel(p)
    out = eigh.cheby_step(lap.cols, lap.vals, xs, cv, a, b,
                          ps if b != 0.0 else None, tiles=lap.tiles)
    torch.cuda.synchronize()
    assert out.stride() == xs.stride() and xs.stride(0) % 8 == 0
    assert torch.equal(out, eigh.cheby_step_plain(
        lap.cols, lap.vals, x, cv, a, b, p if b != 0.0 else None))


@pytest.mark.parametrize("max_rows", [256, 40])
def test_cheby_step_runtime_k_path_equals_plain(max_rows):
    """A table whose rows are not 7 wide takes the run-time K loop, in
    tiles of at most ``max_rows`` staged rows."""
    from craniofacialsd_vae_tpu_torch.ops import eigh

    dev = _card()
    g = _gen(dev, 3)
    n, k, d = 300, 11, 70
    cols = torch.randint(0, n, (n, k), generator=g, device=dev,
                         dtype=torch.int32)
    vals = torch.randn((n, k), generator=g, device=dev)
    x = torch.randn((n, d), generator=g, device=dev)
    p = torch.randn((n, d), generator=g, device=dev)
    c = torch.randn((d,), generator=g, device=dev)
    tiles = eigh.build_k9_tiles(cols, max_rows=max_rows)
    want = eigh.cheby_step_plain(cols, vals, x, c, 0.5, 2.0, p)
    out = kernels.cheby_step(cols, vals, x, c, 0.5, 2.0, p, tiles=tiles)
    padded = kernels.cheby_step(cols, vals, eigh._as_panel(x), c, 0.5, 2.0,
                                eigh._as_panel(p), tiles=tiles)
    torch.cuda.synchronize()
    assert torch.equal(out, want) and torch.equal(padded, want)


def test_cheby_step_launch_counts_and_checks():
    """One launch a call; the wrapper refuses what the kernel does not
    take: missing or mismatched tiles, a panel whose rows are not
    contiguous or overlap, p at other strides."""
    from craniofacialsd_vae_tpu_torch.ops import eigh

    dev = _card()
    lap, x, p, c = _cheby_case(dev, 2, 8)
    other, _, _, _ = _cheby_case(dev, 3, 8)
    kernels.launches.reset()
    kernels.cheby_step(lap.cols, lap.vals, x, c, 1.0, tiles=lap.tiles)
    assert kernels.launches.snapshot()["cheby_step"] == 1
    bad = (
        ((x, c, 1.0, 2.0), {}),                                 # no p
        ((x.cpu(), c, 1.0), {}),
        ((x.double(), c, 1.0), {}),
        ((x, c[:-1], 1.0), {}),
        ((x[:-1], c, 1.0), {}),
        ((x, c, 1.0, 1.0, p[:, :-1]), {}),
        ((x, c, 1.0), {"tiles": None}),                         # no tiles
        ((x, c, 1.0), {"tiles": other.tiles}),                  # another mesh
        ((x.t().contiguous().t(), c, 1.0), {}),                 # column-major
        ((x.as_strided(x.shape, (4, 1)), c, 1.0), {}),          # overlapping
        ((x, c, 1.0, 1.0, eigh._as_panel(p[:, :5])[:, :5]), {}),
    )
    for args, kw in bad:
        kw = {"tiles": lap.tiles, **kw}
        with pytest.raises(ValueError):
            kernels.cheby_step(lap.cols, lap.vals, *args, **kw)
    with pytest.raises(ValueError):                             # p's strides
        kernels.cheby_step(lap.cols, lap.vals, eigh._as_panel(x[:, :5]),
                           c[:5], 1.0, 1.0, p[:, :5].contiguous(),
                           tiles=lap.tiles)
    assert kernels.launches.snapshot()["cheby_step"] == 1


def test_cheby_step_tiles_fit_the_card():
    """The octasphere's tiles at subdivision 6: a block's shared memory
    within the card's, at least two blocks an SM (the runtime's occupancy
    calculator). The kernel takes ``build_k9_tiles``' default tiles,
    128-column slices of 128 rows and 64 vertices, and no tile of more
    vertices."""
    from craniofacialsd_vae_tpu_torch.ops import eigh

    dev = _card()
    lap, _, _, _ = _cheby_case(dev, 6, 8)
    lib = kernels.library()
    smem = lib.cfs_cheby_step_smem(lap.tiles.max_rows, lap.tiles.max_verts,
                                   lap.cols.shape[1])
    assert 48 * 1024 < smem <= 227 * 1024
    most = kernels._CHEBY_MAX_VERTS
    assert lib.cfs_cheby_step_smem(eigh.K9_TILE_ROWS, most, 7) \
        == 4 * (eigh.K9_TILE_ROWS * 129 + most * 16)
    assert lib.cfs_cheby_step_smem(eigh.K9_TILE_ROWS, most + 1, 7) == 0
    for has_p in (0, 1):
        for vec in (0, 1):
            assert lib.cfs_cheby_step_blocks_per_sm(smem, has_p, vec) >= 2


def test_cheby_pass_launches_degree_plus_two():
    """One pass of the solver (the filter in its segments, then the
    Rayleigh–Ritz step) launches K9 degree + 2 times."""
    from craniofacialsd_vae_tpu_torch.geometry import synthetic_template
    from craniofacialsd_vae_tpu_torch.ops import eigh

    dev = _card()
    tpl = synthetic_template(4, 3)
    lap = eigh._EllLaplacian(tpl, dev)
    x = eigh._initial_panel(tpl.num_vertices, 39, 0, dev)
    kernels.launches.reset()
    eigh._rayleigh_ritz(lap, eigh._filter_pass(lap, x, 1.4, 80))
    torch.cuda.synchronize()
    assert kernels.launches.snapshot()["cheby_step"] == 82


def test_chebyshev_solver_on_card_matches_scipy():
    """The solver on the card (K9 in the filter and the Rayleigh–Ritz
    matvecs) against ARPACK on the octasphere of subdivision 4 at k = 31,
    the largest k ≤ 32 in a gap of its spectrum: eigenvalues rtol 1e-4,
    subspace overlap within 1e-4; K9 launched passes × (degree + 2)
    times."""
    from craniofacialsd_vae_tpu_torch.geometry import synthetic_template
    from craniofacialsd_vae_tpu_torch.ops import eigh

    _card()
    tpl = synthetic_template(4, 3)
    kernels.launches.reset()
    vals, vecs, info = eigh._chebyshev_smallest(tpl, 31, device="cuda")
    launched = kernels.launches.snapshot()["cheby_step"]
    assert launched == info["passes"] * (info["degree"] + 2)
    ref_vals, ref_vecs = eigh._scipy_eigsh(tpl, 31)
    order = np.argsort(ref_vals)
    ref_vals, ref_vecs = ref_vals[order], ref_vecs[:, order]
    np.testing.assert_allclose(vals, ref_vals, rtol=1e-4, atol=1e-8)
    ov = vecs.T @ ref_vecs
    np.testing.assert_allclose(ov @ ov.T, np.eye(31), atol=1e-4)


# --------------------------------------------------------- CUDA graphs
def _graph_setup(dev, policy, head, seed=0):
    """A narrow model (and an MLP head) on the fixture hierarchy with the
    stand-in Laplacian and regions, and their capturable Adams."""
    from craniofacialsd_vae_tpu_torch.models import init_mlp

    bundle = load_bundle(FIXTURE)
    geom = SpiralGeometry.from_bundle(
        bundle, device=dev,
        laplacian=standin_laplacian_coo(bundle.spirals[0]),
        region_masks=standin_region_masks(level0_positions(bundle)))
    cfg = SDVAEConfig(out_channels=(8, 8, 8, 16), latent_size=15,
                      compute_dtype=policy)
    gen = torch.Generator().manual_seed(seed)
    model = init_sdvae(cfg, geom, gen)
    opt = coupled_adam(model.parameters(), 1e-3, 1e-4)
    h = h_opt = None
    if head:
        h = init_mlp(15, [8], 3, gen).to(dev)
        h_opt = coupled_adam(h.parameters(), 1e-3, 1e-4)
    weights = LossWeights(classification=1.0 if head else 0.0)
    return model, opt, h, h_opt, weights, bundle.vertex_counts[0]


def _graph_inputs(n_verts, steps, batch, labelled):
    rng = np.random.default_rng(7)
    data = rng.normal(size=(3 * batch, n_verts, 3)).astype(np.float32)
    idx = rng.integers(0, 3 * batch, size=(steps, batch))
    draws = {s: (int(rng.integers(0, 15)),
                 torch.from_numpy(rng.normal(size=(batch * batch, 15))
                                  .astype(np.float32)))
             for s in range(1, steps + 1)}
    labels = rng.integers(0, 3, size=(steps, batch)) if labelled else None
    return data, idx, draws, labels


def _all_state(model, opt) -> list:
    out = [p.detach() for p in model.parameters()]
    for p in model.parameters():
        out += [opt.state[p][k] for k in sorted(opt.state[p])]
    return out


@pytest.mark.parametrize("head", [False, True])
@pytest.mark.parametrize("policy", ["float32", "mixed"])
def test_step_graph_replay_equals_eager_step(policy, head):
    """Four replays of the train step's CUDA graph (make_scanned_train_step)
    against four eager steps from the same state, batches and draws:
    parameters, Adam states and metrics bit-equal; with the head, labels
    and class weights, its parameters and states too."""
    from craniofacialsd_vae_tpu_torch.training import make_scanned_train_step

    dev = _card()
    steps, batch = 4, 2
    runs = []
    for graphed in (False, True):
        model, opt, h, h_opt, weights, n = _graph_setup(dev, policy, head)
        data, idx, draws, labels = _graph_inputs(n, steps, batch, head)
        cw = torch.tensor([0.2, 0.3, 0.5], device=dev) if head else None
        if graphed:
            epoch = make_scanned_train_step(
                model, weights, opt, batch, head=h, head_optimizer=h_opt,
                draws=lambda s, rows: draws[s])
            got = epoch(torch.as_tensor(data, device=dev), idx,
                        np.arange(1, steps + 1), labels, cw)
            runner = next(iter(epoch.steps.runners.values()))
            assert runner.graph is not None
        else:
            step = make_train_step(model, weights, opt, batch, head=h,
                                   head_optimizer=h_opt)
            data_d = torch.as_tensor(data, device=dev)
            sums = torch.zeros(len(LOSS_KEYS), device=dev)
            for t in range(steps):
                region, eps = draws[t + 1]
                lab = None if labels is None else torch.as_tensor(
                    labels[t], device=dev)
                m = step(data_d.index_select(
                    0, torch.as_tensor(idx[t], device=dev)),
                    region_idx=torch.tensor(region, device=dev),
                    eps=eps.to(dev), labels=lab, class_weights=cw)
                sums += torch.stack([m[k].float() for k in LOSS_KEYS])
            got = {k: float(v) / steps
                   for k, v in zip(LOSS_KEYS, sums.cpu())}
        torch.cuda.synchronize()
        state = _all_state(model, opt) + (_all_state(h, h_opt) if head
                                          else [])
        runs.append((got, state))
    (m_a, s_a), (m_b, s_b) = runs
    assert m_a == m_b
    assert len(s_a) == len(s_b)
    for a, b in zip(s_a, s_b):
        assert torch.equal(a, b)


def test_ensemble_step_graph_equals_eager_and_solo_replays():
    """A K = 2 ensemble's scanned epoch (one CUDA graph of both members'
    train steps, each member with its own draws) against the members'
    eager steps and against two solo scanned epochs (a graph each), from
    the same states, batches and draws: parameters, Adam states and
    metrics bit-equal; the ensemble's capture recorded the two solo
    captures' launches, kernel for kernel."""
    from craniofacialsd_vae_tpu_torch.training import make_scanned_train_step
    from craniofacialsd_vae_tpu_torch.training.ensemble import (
        EnsembleState, MemberState, make_ensemble_scanned_step)

    dev = _card()
    steps, batch = 4, 2
    results = {}
    for how in ("ensemble", "eager", "solo"):
        members = [_graph_setup(dev, "float32", False, seed=s)
                   for s in (0, 1)]
        data, idx, draws, _ = _graph_inputs(members[0][5], steps, batch,
                                            False)
        own = [draws, {s: (r, -e) for s, (r, e) in draws.items()}]
        fns = [lambda s, rows, d=d: d[s] for d in own]
        data_d = torch.as_tensor(data, device=dev)
        sids = np.arange(1, steps + 1)
        weights = members[0][4]
        if how == "ensemble":
            state = EnsembleState([MemberState(m[0], m[1]) for m in members])
            epoch = make_ensemble_scanned_step(state, weights, batch,
                                               draws=fns)
            got = epoch(data_d, idx, sids)
            runner = epoch.steps[0].runners[("train", False)]
            launches = runner.graph.launches
        elif how == "solo":
            got, launches = [], {}
            for (model, opt, *_), fn in zip(members, fns):
                solo = make_scanned_train_step(model, weights, opt, batch,
                                               draws=fn)
                got.append(solo(data_d, idx, sids))
                g = solo.steps.runners[("train", False)].graph
                for k, v in g.launches.items():
                    launches[k] = launches.get(k, 0) + v
        else:
            got, launches = [], None
            for (model, opt, *_), d in zip(members, own):
                step = make_train_step(model, weights, opt, batch)
                sums = torch.zeros(len(LOSS_KEYS), device=dev)
                for t in range(steps):
                    region, eps = d[t + 1]
                    m = step(data_d.index_select(
                        0, torch.as_tensor(idx[t], device=dev)),
                        region_idx=torch.tensor(region, device=dev),
                        eps=eps.to(dev))
                    sums += torch.stack([m[k].float() for k in LOSS_KEYS])
                got.append({k: float(v) / steps
                            for k, v in zip(LOSS_KEYS, sums.cpu())})
        torch.cuda.synchronize()
        results[how] = (got, [_all_state(m[0], m[1]) for m in members],
                        launches)
    base_m, base_s, base_l = results["ensemble"]
    assert base_l == results["solo"][2]
    assert base_m[0] != base_m[1]
    for how in ("eager", "solo"):
        got_m, got_s, _ = results[how]
        assert got_m == base_m, how
        for a, b in zip(got_s, base_s):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                assert torch.equal(x, y), how


def test_member_mesh_moves_members_to_the_card():
    """An ensemble made on the host and sharded over the card named twice
    (``parallel.shard_member_axis``): each member moved to the card (its
    model, geometry and a capturable Adam), a graph a block; its epoch
    bit-equal to the same ensemble made on the card and sharded alike."""
    from craniofacialsd_vae_tpu_torch import parallel
    from craniofacialsd_vae_tpu_torch.training.ensemble import (
        EnsembleState, MemberState, make_ensemble_scanned_step)

    dev = _card()
    mesh = parallel.make_member_mesh(devices=["cuda", "cuda"])
    runs = []
    for where in (torch.device("cpu"), dev):
        members = [_graph_setup(where, "float32", False, seed=s)
                   for s in (0, 1)]
        state = parallel.shard_member_axis(mesh, EnsembleState(
            [MemberState(m[0], m[1]) for m in members]))
        for m in state.members:
            assert m.model.geom.device.type == "cuda"
            assert m.optimizer.param_groups[0]["capturable"]
        data, idx, draws, _ = _graph_inputs(members[0][5], 4, 2, False)
        epoch = make_ensemble_scanned_step(
            state, members[0][4], 2, draws=[lambda s, rows: draws[s]] * 2)
        got = epoch(torch.as_tensor(data, device=dev), idx,
                    np.arange(1, 5))
        assert len(epoch.steps) == 2 and all(
            st.runners[("train", False)].graph is not None
            for st in epoch.steps)
        torch.cuda.synchronize()
        runs.append((got, [_all_state(m.model, m.optimizer)
                           for m in state.members]))
    (m_a, s_a), (m_b, s_b) = runs
    assert m_a == m_b
    for a, b in zip(s_a, s_b):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_step_graph_binds_the_split():
    """After the capture, a device split is read where it lies (another
    tensor raises: the graph reads the first at its address), and a host
    split is uploaded into the runner's own tensor at every call: two
    calls over a host split equal two calls over the same split on the
    card."""
    from craniofacialsd_vae_tpu_torch.training import make_scanned_train_step

    dev = _card()
    runs = []
    for host in (False, True):
        model, opt, _, _, weights, n = _graph_setup(dev, "float32", False)
        data, idx, draws, _ = _graph_inputs(n, 4, 2, False)
        epoch = make_scanned_train_step(model, weights, opt, 2,
                                        draws=lambda s, rows: draws[s])
        split = data if host else torch.as_tensor(data, device=dev)
        got = [epoch(split, idx[:2], np.array([1, 2])),
               epoch(split if not host else data.copy(), idx[2:],
                     np.array([3, 4]))]
        runner = epoch.steps.runners[("train", False)]
        assert (runner.data is split) == (not host)
        if not host:
            with pytest.raises(ValueError, match="captured with"):
                epoch(split.clone(), idx[:2], np.array([1, 2]))
        torch.cuda.synchronize()
        runs.append((got, _all_state(model, opt)))
    (m_a, s_a), (m_b, s_b) = runs
    assert m_a == m_b
    for a, b in zip(s_a, s_b):
        assert torch.equal(a, b)


def test_resumed_capturable_adam_replays(tmp_path):
    """An Adam state read back from the checkpoint layout (its count on
    the card, as capturable Adam keeps it) drives replays that equal the
    eager steps from the same state."""
    from craniofacialsd_vae_tpu_torch.training import make_scanned_train_step
    from craniofacialsd_vae_tpu_torch.training.checkpoint import (
        adam_from_optax, adam_to_optax)

    dev = _card()
    model, opt, _, _, weights, n = _graph_setup(dev, "float32", False)
    data, idx, draws, _ = _graph_inputs(n, 3, 2, False)
    data_d = torch.as_tensor(data, device=dev)
    step = make_train_step(model, weights, opt, 2)
    region, eps = draws[1]
    step(data_d[:2], region_idx=region, eps=eps.to(dev))
    stored = adam_to_optax(opt, dict(model.named_parameters()), 1e-4)
    params = {k: v.clone() for k, v in model.state_dict().items()}
    out = []
    for graphed in (False, True):
        m2, o2, _, _, _, _ = _graph_setup(dev, "float32", False)
        m2.load_state_dict(params)
        adam_from_optax(o2, dict(m2.named_parameters()), stored, 1e-4)
        assert all(st["step"].is_cuda for st in o2.state.values())
        if graphed:
            make_scanned_train_step(m2, weights, o2, 2,
                                    draws=lambda s, rows: draws[s])(
                data_d, idx[1:], np.array([2, 3]))
        else:
            s2 = make_train_step(m2, weights, o2, 2)
            for t in (1, 2):
                r, e = draws[t + 1]
                s2(data_d.index_select(0, torch.as_tensor(idx[t],
                                                          device=dev)),
                   region_idx=torch.tensor(r, device=dev), eps=e.to(dev))
        torch.cuda.synchronize()
        out.append(_all_state(m2, o2))
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_fit_graph_equals_eager_fit(tmp_path):
    """A fit whose iterations replay the cached graph against the same fit
    launched eagerly: z, chamfer, landmark loss and best restart equal;
    a second scan of the same padded size and a fit at another learning
    rate reuse the graph, the latter equal to its eager fit too."""
    from craniofacialsd_vae_tpu_torch.analysis import fitting
    from craniofacialsd_vae_tpu_torch.manager import ModelManager

    dev = _card()
    config = _entry_workspace(str(tmp_path))
    mgr = ModelManager(config, config["data"]["precomputed_path"],
                       device=dev)
    tpl = np.asarray(mgr.template.pos, np.float32)
    lnd = list(range(0, len(tpl), len(tpl) // 6))[:6]
    scan = tpl * 1.05 + 0.01

    def fit(lr, graph):
        return fitting._fit_latent(mgr, None, scan, scan[lnd], lnd, lr, 6,
                                   4, 0, None, graph=graph)

    for lr in (5e-3, 2e-2):
        res = {g: fit(lr, g) for g in (True, False)}
        np.testing.assert_array_equal(res[True]["z"], res[False]["z"])
        for k in ("chamfer_mm2", "landmark_mse_mm2", "best_restart"):
            assert res[True][k] == res[False][k], k
    (run,) = fitting._FIT_RUNS[mgr].values()
    assert run.graph is not None
    more = np.concatenate([scan, scan[:9] + 0.003])      # pads alike
    other = fitting.fit_latent(mgr, None, more, scan[lnd], lnd,
                               iterations=6, n_restarts=4)
    assert list(fitting._FIT_RUNS[mgr].values()) == [run]
    assert np.isfinite(other["chamfer_mm2"])


def test_serving_bucket_graphs_equal_eager_programs():
    """encode, reconstruct and decode at every bucket (and a request above
    max_batch): the graphs' answers equal the eager programs' bit for
    bit; warmup captures every bucket."""
    dev = _card()
    bundle = load_bundle(FIXTURE)
    cfg = SDVAEConfig(out_channels=(8, 8, 8, 16), latent_size=15)
    n = bundle.vertex_counts[0]
    rng = np.random.default_rng(4)
    norm = {"mean": level0_positions(bundle),
            "std": np.full((n, 3), 0.02, np.float32)}
    svc = DiagnosisService.from_bundle(bundle, cfg, norm, 10.0, seed=1,
                                       max_batch=4, device=dev)
    svc.warmup()
    assert set(svc._bucket_graphs) == {(p, b, 0) for p in
                                       ("encode", "reconstruct", "decode")
                                       for b in svc.buckets}
    for b in (1, 2, 3, 4, 7):
        x = (norm["mean"] + 0.02 * rng.normal(size=(b, n, 3))).astype(
            np.float32)
        z = rng.normal(size=(b, 15)).astype(np.float32)
        for name, arg in (("encode", x), ("decode", z),
                          ("reconstruct", x)):
            got = svc._run_program(name, arg)
            want = svc._run_bucketed(svc._programs[name], arg)
            got, want = (got, want) if isinstance(got, tuple) \
                else ((got,), (want,))
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)


# ------------------------------------------------ the evaluation harness
def test_tester_recon_and_classifiers_on_card_match_host(tmp_path):
    """The Tester's ``recon`` and ``classifiers`` on the card against the
    same on the host, both managers resumed from one host-trained
    checkpoint with its zoo: errors rtol 1e-4 (phase 9's SERVE_RTOL),
    accuracies and reports equal; the card launched K1, K4 and no K7."""
    from craniofacialsd_vae_tpu_torch.analysis.tester import Tester
    from craniofacialsd_vae_tpu_torch.data.dataset import (BatchIterator,
                                                           build_datasets)
    from craniofacialsd_vae_tpu_torch.manager import ModelManager

    dev = _card()
    config = _entry_workspace(str(tmp_path))
    train, val, test, norm, weights = build_datasets(config)
    ckpt = str(tmp_path / "ckpt")
    warm = ModelManager(config, config["data"]["precomputed_path"],
                        device="cpu")
    warm.set_class_conversions_and_weights(weights)
    warm.run_epoch(BatchIterator(train, 3, seed=1,
                                 class2idx=warm._class2idx_dict))
    warm.save_weights(ckpt, 0)
    warm.train_and_validate_classifiers(
        BatchIterator(train, 3, shuffle=False),
        BatchIterator(val, 3, shuffle=False, drop_last=False),
        checkpoint_dir=ckpt)
    out = {}
    for d in (dev, "cpu"):
        mgr = ModelManager(config, config["data"]["precomputed_path"],
                           device=d)
        mgr.set_class_conversions_and_weights(weights)
        mgr.resume(ckpt)
        tester = Tester(mgr, norm, BatchIterator(train, 3, shuffle=False),
                        BatchIterator(test, 3, shuffle=False,
                                      drop_last=False),
                        str(tmp_path / f"eval_{torch.device(d).type}"),
                        config)
        kernels.launches.reset()
        out[d] = (tester.reconstruction_errors(), tester.test_classifiers(),
                  kernels.launches.snapshot(), tester)
    (rc, ac, counts, tc), (rh, ah, _, th) = out[dev], out["cpu"]
    for k, v in rh.items():
        if np.isfinite(v):
            assert abs(rc[k] - v) <= 1e-4 * abs(v), k
    assert ac == ah
    for name in ("classification_report.json",
                 "classification_report_regions.json"):
        paths = [os.path.join(t._out_dir, name) for t in (tc, th)]
        if os.path.exists(paths[1]):
            with open(paths[0]) as f, open(paths[1]) as g:
                assert f.read() == g.read(), name
    for kernel in ("spiral_conv_tc", "spiral_conv_narrow", "ell_matmul_fwd"):
        assert counts[kernel] > 0, kernel
    assert counts["raster_sweep"] == 0


def test_tsne_on_card_matches_host():
    """The exact t-SNE from one start: P within 1e-12 of its max, the
    embedding after 250 iterations within 1e-3 of its max (float32
    steps whose reductions run in another order on the card)."""
    from craniofacialsd_vae_tpu_torch.analysis import tsne

    dev = _card()
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(c, 1.0, (20, 6))
                        for c in (0.0, 3.0, 6.0)]).astype(np.float32)
    y0 = tsne.random_init(len(x), _gen(dev, 1))
    assert y0.device.type == "cuda"
    card = tsne.tsne(x, init=y0, max_iter=250, device=dev)
    host = tsne.tsne(x, init=y0.cpu(), max_iter=250, device="cpu")
    p_card, p_host = card["P"].cpu().numpy(), host["P"].numpy()
    assert np.abs(p_card - p_host).max() <= 1e-12 * p_host.max()
    scale = np.abs(host["embedding"]).max()
    assert np.abs(card["embedding"] - host["embedding"]).max() \
        <= 1e-3 * scale


@pytest.mark.parametrize("shape", [(256, 512), (37, 53), (8, 8)])
def test_jpeg_from_card_frames_equals_host(shape):
    """The encoder's integer colour transform and exact float64 DCT give
    the same file from card tensors as from host arrays."""
    from craniofacialsd_vae_tpu_torch.viz import jpeg

    dev = _card()
    rng = np.random.default_rng(sum(shape))
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    smooth = np.stack([yy * 255 // max(shape[0] - 1, 1),
                       xx * 255 // max(shape[1] - 1, 1),
                       (yy + xx) % 256], -1).astype(np.uint8)
    noise = rng.integers(0, 256, (2, *shape, 3), dtype=np.uint8)
    frames = np.concatenate([smooth[None], noise])
    assert jpeg.encode_jpegs(torch.as_tensor(frames, device=dev)) == \
        jpeg.encode_jpegs(frames)


# ------------------------------------------------- data parallelism, NCCL
@pytest.fixture
def nccl_world_one(tmp_path):
    """A world-size-1 NCCL process group on the card (file rendezvous)."""
    import torch.distributed as dist

    from craniofacialsd_vae_tpu_torch import parallel

    _card()
    parallel.initialize_multihost(
        num_processes=1, process_id=0, device="cuda",
        init_method="file://" + str(tmp_path / "rendezvous"), timeout_s=300)
    try:
        assert dist.get_backend() == "nccl"
        yield parallel.make_data_mesh()
    finally:
        dist.destroy_process_group()


def test_nccl_world_one_step_equals_single_device(nccl_world_one):
    """The data-parallel step at world size 1 over NCCL (an all-reduce
    sum, then a division by 1) equals the single-device step bit for
    bit: metrics, parameters and Adam states, three steps."""
    from craniofacialsd_vae_tpu_torch import parallel

    dev = _card()
    batch = 2
    runs = []
    for dp in (False, True):
        model, opt, _, _, weights, n = _graph_setup(dev, "float32", False)
        data, idx, draws, _ = _graph_inputs(n, 3, batch, False)
        step = parallel.make_parallel_train_step(
            model, weights, opt, batch, nccl_world_one) if dp else \
            make_train_step(model, weights, opt, batch)
        data_d = torch.as_tensor(data, device=dev)
        ms = []
        for t in range(3):
            region, eps = draws[t + 1]
            ms.append(step(data_d.index_select(
                0, torch.as_tensor(idx[t], device=dev)), region_idx=region,
                eps=eps.to(dev)))
        torch.cuda.synchronize()
        runs.append((ms, _all_state(model, opt)))
    (m_a, s_a), (m_b, s_b) = runs
    for a, b in zip(m_a, m_b):
        for k in LOSS_KEYS:
            assert torch.equal(a[k], b[k]), k
    for a, b in zip(s_a, s_b):
        assert torch.equal(a, b)


def test_nccl_all_reduce_replays_inside_the_step_graph(nccl_world_one):
    """The data-parallel scanned epoch captures the step with its NCCL
    all-reduce inside the graph: four replays equal four single-device
    eager steps bit for bit, and a replay adds its capture's launches."""
    from craniofacialsd_vae_tpu_torch import parallel

    dev = _card()
    steps, batch = 4, 2
    model, opt, _, _, weights, n = _graph_setup(dev, "float32", False)
    data, idx, draws, _ = _graph_inputs(n, steps, batch, False)
    epoch = parallel.make_scanned_parallel_step(
        model, weights, opt, batch, nccl_world_one,
        draws=lambda s, rows: draws[s])
    graphs.replayed.reset()
    got = epoch(torch.as_tensor(data, device=dev), idx,
                np.arange(1, steps + 1))
    runner = next(iter(epoch.steps.runners.values()))
    assert runner.graph is not None
    assert graphs.replayed.snapshot()["spiral_conv_dw"] == \
        steps * runner.graph.launches["spiral_conv_dw"]

    ref_model, ref_opt, _, _, _, _ = _graph_setup(dev, "float32", False)
    step = make_train_step(ref_model, weights, ref_opt, batch)
    data_d = torch.as_tensor(data, device=dev)
    sums = torch.zeros(len(LOSS_KEYS), device=dev)
    for t in range(steps):
        region, eps = draws[t + 1]
        m = step(data_d.index_select(0, torch.as_tensor(idx[t], device=dev)),
                 region_idx=torch.tensor(region, device=dev),
                 eps=eps.to(dev))
        sums += torch.stack([m[k].float() for k in LOSS_KEYS])
    torch.cuda.synchronize()
    assert got == {k: float(v) / steps for k, v in zip(LOSS_KEYS, sums.cpu())}
    for a, b in zip(_all_state(model, opt), _all_state(ref_model, ref_opt)):
        assert torch.equal(a, b)


def test_serving_two_replicas_on_one_card_equal_single_service():
    """``DiagnosisService(data_parallel=True)`` over the card named twice:
    each bucket's rows split between two replicas, each replaying its own
    graphs (keyed by program, rows and replica). encode, reconstruct and
    decode at every request size within 1e-5 of the single service's max
    (a replica runs half the bucket, where cuBLAS may pick another
    kernel); a replay launches no wrapper and adds its capture's
    launches; a request whose second half is padding runs one replica."""
    dev = _card()
    bundle = load_bundle(FIXTURE)
    cfg = SDVAEConfig(out_channels=(8, 8, 8, 16), latent_size=15)
    n = bundle.vertex_counts[0]
    rng = np.random.default_rng(5)
    norm = {"mean": level0_positions(bundle),
            "std": np.full((n, 3), 0.02, np.float32)}
    one = DiagnosisService.from_bundle(bundle, cfg, norm, 10.0, seed=1,
                                       max_batch=4, device=dev)
    dp = DiagnosisService.from_bundle(bundle, cfg, norm, 10.0, seed=1,
                                      max_batch=4, device=dev,
                                      data_parallel=True,
                                      devices=[dev, dev])
    assert dp.n_devices == 2 and dp.buckets == [2, 4]
    dp.warmup()
    assert set(dp._bucket_graphs) == {
        (p, b // 2, i) for p in ("encode", "reconstruct", "decode")
        for b in dp.buckets for i in (0, 1)}

    def rel(a, b):
        return float(np.abs(a - b).max()) / float(np.abs(b).max())

    for b in (1, 3, 4, 7):
        x = (norm["mean"] + 0.02 * rng.normal(size=(b, n, 3))).astype(
            np.float32)
        z = rng.normal(size=(b, 15)).astype(np.float32)
        for name, arg in (("encode", x), ("decode", z),
                          ("reconstruct", x)):
            kernels.launches.reset()
            graphs.replayed.reset()
            got = dp._run_program(name, arg)
            torch.cuda.synchronize()
            assert not any(kernels.launches.snapshot().values())
            want_replays = {}
            for lo in range(0, b, 4):           # the max_batch chunks
                rows = min(4, b - lo)
                per = dp._bucket(rows) // 2
                for i in range(-(-rows // per)):    # replicas given rows
                    for k, v in dp._bucket_graphs[(name, per, i)] \
                            .graph.launches.items():
                        want_replays[k] = want_replays.get(k, 0) + v
            assert {k: v for k, v in graphs.replayed.snapshot().items()
                    if v} == {k: v for k, v in want_replays.items() if v}
            want = one._run_program(name, arg)
            got, want = (got, want) if isinstance(got, tuple) \
                else ((got,), (want,))
            for g, w in zip(got, want):
                assert g.shape == w.shape
                assert rel(g, w) <= 1e-5, (name, b)


def test_fit_over_two_replicas_on_one_card(tmp_path):
    """``fit_latent(mesh=)`` over the card named twice: five restarts run
    as six, three a replica, each replica replaying its own graph; the
    answer is the unsharded six-restart fit's (best restart equal, z and
    chamfer within 1e-5)."""
    from craniofacialsd_vae_tpu_torch.analysis import fitting
    from craniofacialsd_vae_tpu_torch.manager import ModelManager
    from craniofacialsd_vae_tpu_torch.parallel import make_data_mesh

    dev = _card()
    config = _entry_workspace(str(tmp_path))
    mgr = ModelManager(config, config["data"]["precomputed_path"],
                       device=dev)
    tpl = np.asarray(mgr.template.pos, np.float32)
    lnd = list(range(0, len(tpl), len(tpl) // 6))[:6]
    scan = tpl * 1.05 + 0.01
    mesh = make_data_mesh(devices=[dev, dev])
    got = fitting.fit_latent(mgr, None, scan, scan[lnd], lnd, iterations=6,
                             n_restarts=5, mesh=mesh)
    six = fitting.fit_latent(mgr, None, scan, scan[lnd], lnd, iterations=6,
                             n_restarts=6)
    (rep,) = fitting._REPLICAS[mgr].values()
    assert [r.graph is not None for r in fitting._FIT_RUNS[rep].values()] \
        == [True]
    assert got["best_restart"] == six["best_restart"]
    assert np.abs(got["z"] - six["z"]).max() <= 1e-5 * np.abs(six["z"]).max()
    assert got["chamfer_mm2"] == pytest.approx(six["chamfer_mm2"], rel=1e-5)


def test_library_ops_launch_their_kernels():
    """On CUDA tensors each custom op of ``ops/library.py`` runs its
    kernel, one counted launch, with the wrapper's answer bit for bit."""
    dev = _card()
    g = _gen(dev, 22)
    op = ops.build_spiral_op(np.asarray(load_bundle(FIXTURE).spirals[0])
                             ).to(dev)
    n = op.n_src
    lib = torch.ops.cfsdvae
    cases = []
    for dtype, c_out, f32_out in ((torch.float32, 32, False),
                                  (torch.float32, 3, False),
                                  (torch.bfloat16, 32, False),
                                  (torch.bfloat16, 3, True)):
        x = torch.randn((n, 4, 32), generator=g, device=dev).to(dtype)
        w_l = (0.2 * torch.randn((9, 32, c_out), generator=g,
                                 device=dev)).to(dtype)
        b = torch.randn(c_out, generator=g, device=dev).to(dtype)
        cases.append((
            lambda x=x, w_l=w_l, b=b, f=f32_out: lib.spiral_conv_fwd(
                x, op.table, w_l, b, f, *ops.tile_args(op.tiles)),
            lambda x=x, w_l=w_l, b=b, f=f32_out: kernels.spiral_conv_fwd(
                x, op.table, w_l, b, out_dtype=torch.float32 if f else None,
                tiles=op.tiles)))
    cols = torch.randint(0, n, (500, 3), generator=g, device=dev,
                         dtype=torch.int32)
    vals = torch.randn((500, 3), generator=g, device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((n, 4, 8), generator=g, device=dev).to(dtype)
        cases.append((lambda x=x: lib.ell_matmul_fwd(cols, vals, x),
                      lambda x=x: kernels.ell_matmul_fwd(
                          cols, vals, x.view(n, -1)).view(500, 4, 8)))
    u = torch.randn((9, 3, n, 4), generator=g, device=dev)
    b3 = torch.randn(3, generator=g, device=dev)
    cases.append((lambda: lib.out_gather_sum(u, op.table, b3),
                  lambda: kernels.out_gather_sum(u, op.table, b3)))
    for call, wrapper in cases:
        before = kernels.launches.snapshot()
        out = call()
        torch.cuda.synchronize()
        after = kernels.launches.snapshot()
        assert sum(after.values()) - sum(before.values()) == 1
        assert torch.equal(out, wrapper())
    # no fallback: the kernel's input checks raise through the op
    x_t = torch.randn((4, n, 32), device=dev).transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        lib.spiral_conv_fwd(x_t, op.table, torch.randn((9, 32, 8),
                                                       device=dev),
                            torch.zeros(8, device=dev), False,
                            *ops.tile_args(op.tiles))


# ----------------------------------------------------------------------
# K2-dx and K2-dx-bf16 (csrc/spiral_conv_dx.cu)

def _bf16_ulps(got, want, floor_rtol=1e-5):
    """Largest |got − want| in bf16 ulps of the larger magnitude (at least
    ``floor_rtol`` of max |want|), NaNs where both are NaN skipped."""
    got, want = got.float(), want.float()
    both = torch.isnan(got) & torch.isnan(want)
    got, want = got[~both], want[~both]
    mag = torch.maximum(got.abs(), want.abs()).clamp(min=2.0 ** -120)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7).clamp(
        min=floor_rtol * float(want.abs().max()) if want.numel() else 0.0)
    return float(((got - want).abs() / ulp).max()) if got.numel() else 0.0


def _dx_matches_plain(dev, op, b, c_in, c_out, dtype, seed=0, nan_row=None):
    """K2-dx (K2-dx-bf16 for bf16) against its twin on one op: fp32
    within 1e-5 of max |dx| (3xTF32 against the twin's fp32 product of
    the same du), bf16 within one bf16 ulp (both round the fp32 product
    once); NaN where the twin has NaN; two launches bit-equal; one
    launch counted."""
    g = _gen(dev, seed)
    dy = torch.randn((op.num_vertices, b, c_out), generator=g, device=dev)
    w_l = torch.randn((op.seq_length, c_in, c_out), generator=g,
                      device=dev) * 0.2
    if nan_row is not None:
        dy[nan_row, 0, 0] = float("nan")
    dy, w_l = dy.to(dtype), w_l.to(dtype)
    kernels.launches.reset()
    got = ops.spiral_conv_dx(dy, w_l, op.dx)
    name = "spiral_conv_dx_bf16" if dtype == torch.bfloat16 \
        else "spiral_conv_dx"
    assert kernels.launches.snapshot()[name] == 1
    again = ops.spiral_conv_dx(dy, w_l, op.dx)
    want = ops.spiral_conv_dx_plain(dy, w_l, op.dx)
    torch.cuda.synchronize()
    assert got.shape == (op.n_src, b, c_in) and got.dtype == dtype
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got, again) or torch.equal(
        got.isnan(), again.isnan())
    if dtype == torch.bfloat16:
        assert _bf16_ulps(got, want) <= 1.0
    else:
        fin = ~want.isnan()
        scale = float(want[fin].abs().max())
        assert float((got[fin] - want[fin]).abs().max()) <= 1e-5 * scale
    return got, want


def _dx_tables(rng, kind):
    if kind == "identity":
        table = rng.integers(0, 300, size=(300, 9))
        table[:, 0] = np.arange(300)
        return table, None
    if kind == "composed":
        return rng.integers(0, 700, size=(200, 9)), 700
    table = rng.integers(0, 300, size=(300, 9))         # a hub: tiers
    table[:, 0] = np.arange(300)
    table[:180, 3] = 7
    return table, None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["identity", "composed", "hub"])
@pytest.mark.parametrize("b,c_in,c_out", [(16, 32, 32), (1, 32, 3),
                                          (4, 3, 32), (20, 64, 64),
                                          (100, 16, 8)])
def test_spiral_conv_dx_kernel_matches_plain(kind, b, c_in, c_out, dtype):
    dev = _card()
    table, n_src = _dx_tables(np.random.default_rng(1), kind)
    op = ops.build_spiral_op(table, n_src=n_src).to(dev)
    if kind == "hub":
        assert op.inv_tables[0].tiers
    got, _ = _dx_matches_plain(dev, op, b, c_in, c_out, dtype)
    if kind == "composed":
        reached = torch.zeros(op.n_src, dtype=torch.bool, device=dev)
        reached[op.table.long().reshape(-1)] = True
        assert not bool(reached.all())
        assert bool((got[~reached] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 16])
@pytest.mark.parametrize("name,c_in,c_out", _SMOKE)
def test_spiral_conv_dx_kernel_on_the_model_tables(card_geometry, name,
                                                   c_in, c_out, b, dtype):
    dev = _card()
    _dx_matches_plain(dev, _smoke_op(card_geometry, name), b, c_in, c_out,
                      dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("row", [0, 5])
def test_spiral_conv_dx_kernel_carries_a_nan_row(card_geometry, row, dtype):
    """A NaN in dy's row 0 reaches every padded list (0 · dy[0]), one in
    another row only the rows that read it: the same rows as the twin."""
    dev = _card()
    got, want = _dx_matches_plain(dev, _smoke_op(card_geometry, "dec0"), 4,
                                  32, 32, dtype, nan_row=row)
    assert bool(got.isnan().any())


def test_spiral_conv_backward_launches_k2_dx(card_geometry):
    """The conv's backward on the card: one K2-dx for dx, no ELL kernel,
    and the same dx as the host's."""
    dev = _card()
    op = _smoke_op(card_geometry, "dec1")
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.normal(size=(9 * 32, 32)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(op.n_src, 2, 32)).astype(
        np.float32))
    grads = []
    for device, o in ((dev, op), ("cpu", op.to("cpu"))):
        xd = x.to(device).requires_grad_()
        kernels.launches.reset()
        ops.spiral_conv({"w": w.to(device), "b": torch.zeros(
            32, device=device)}, xd, o).square().sum().backward()
        grads.append(xd.grad.cpu())
        if device == dev:
            counts = kernels.launches.snapshot()
            assert counts["spiral_conv_dx"] == 1
            assert counts["ell_matmul_fwd"] == counts[
                "ell_matmul_capped"] == 0
    assert float((grads[0] - grads[1]).abs().max()) <= \
        1e-5 * float(grads[1].abs().max())


# ----------------------------------------------------------------------
# K8-sinkhorn (csrc/sinkhorn.cu)

def _clouds(dev, p, q, shift, seed=0):
    g = _gen(dev, seed)
    x = torch.randn((p, 3), generator=g, device=dev)
    y = torch.randn((q, 3), generator=g, device=dev) + shift
    return x, y


@pytest.mark.parametrize("eps", [0.05, 0.01])
@pytest.mark.parametrize("p,q,shift", [(300, 500, 2.0), (1000, 257, 0.5),
                                       (1, 70, 0.0)])
def test_sinkhorn_kernel_matches_plain(p, q, shift, eps):
    """The forward kernel against the twin: rtol 1e-4 (the potentials'
    exponents formed in another order, base 2 against natural)."""
    dev = _card()
    x, y = _clouds(dev, p, q, shift)
    kernels.launches.reset()
    got = ops.sinkhorn_divergence(x, y, eps)
    assert kernels.launches.snapshot()["sinkhorn_fwd"] == 1
    want = ops.distances.sinkhorn_divergence_plain(x, y, eps)
    again = ops.sinkhorn_divergence(x, y, eps)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert abs(float(got) - float(want)) <= 1e-4 * abs(float(want))


@pytest.mark.parametrize("same", [False, True])
def test_sinkhorn_gradient_matches_plain(same):
    """The backward kernel against the twin's autograd: each gradient
    within 1e-3 of its max (sinkhorn(x, x) ties at the clamp on its
    diagonal)."""
    dev = _card()
    x, y = _clouds(dev, 400, 300, 1.0)
    if same:
        y = x.clone()
    grads = []
    for fn in (ops.sinkhorn_divergence,
               ops.distances.sinkhorn_divergence_plain):
        xa, ya = x.clone().requires_grad_(), y.clone().requires_grad_()
        kernels.launches.reset()
        fn(xa, ya, 0.05).backward()
        grads.append((xa.grad, ya.grad))
        if fn is ops.sinkhorn_divergence:
            assert kernels.launches.snapshot()["sinkhorn_bwd"] == 1
    torch.cuda.synchronize()
    for got, want in zip(grads[0], grads[1]):
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-3 * scale


def test_sinkhorn_jax_cases_on_the_card():
    """tests/test_distances.py's cases: identical clouds near 0, clouds
    2 apart above 1."""
    dev = _card()
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(30, 3)).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.normal(size=(30, 3)).astype(np.float32)
                         + 2.0).to(dev)
    assert float(ops.sinkhorn_divergence(x, x, 0.01)) < 0.05
    assert float(ops.sinkhorn_divergence(x, y, 0.01)) > 1.0

"""Card tests of the port's CUDA kernels: each kernel against its plain
PyTorch twin on the same CUDA tensors, the wrappers' input checks and
launch counts, and the service on the card against the service on the
host. Every test skips itself without a card.

This file imports no JAX, so it also runs where JAX is not installed::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import os

import numpy as np
import pytest
import torch

from craniofacialsd_vae_tpu_torch import kernels, ops
from craniofacialsd_vae_tpu_torch.geometry import load_bundle
from craniofacialsd_vae_tpu_torch.models import SDVAEConfig, SpiralGeometry
from craniofacialsd_vae_tpu_torch.serving import DiagnosisService
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


def _conv_matches_plain(dev, op, b, c_in, c_out, scale=1.0, seed=1):
    """K1 against its plain twin on one table: rtol 1e-5 against max |out|
    (3xTF32 products and another summation order than the library
    matmul's), and two launches bit-equal. Returns the plan."""
    g = _gen(dev, seed)
    x = torch.randn((op.n_src, b, c_in), generator=g, device=dev) * scale
    seq = op.seq_length
    w_l = torch.randn((seq, c_in, c_out), generator=g, device=dev) * 0.2
    bias = torch.randn(c_out, generator=g, device=dev) * scale
    out = kernels.spiral_conv_fwd(x, op.table, w_l, bias)
    again = kernels.spiral_conv_fwd(x, op.table, w_l, bias)
    ref = ops.spiral_conv_plain(w_l, bias, x, op)
    torch.cuda.synchronize()
    assert out.shape == ref.shape
    err = float((out - ref).abs().max())
    assert err <= 1e-5 * float(ref.abs().max())
    assert torch.equal(out, again)
    return kernels.plan_spiral_conv(op.num_vertices, b, seq, c_in, c_out)


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
    from chip_smoke import uv_sphere
    return uv_sphere(24, 48)


def _sweep_both(dev, verts, faces, size):
    eye, rot = look_at_camera()
    v_cam = torch.as_tensor((verts - eye) @ rot.T, device=dev)
    f = torch.as_tensor(faces, device=dev).long()
    pts = raster.project(v_cam, size)
    nb = -(-len(faces) // raster.TRI_BLOCK)
    coef = raster._triangle_coefficients(pts, f, nb)
    lo, hi = raster._block_y_ranges(pts[f, 1], nb)
    lo, hi = lo.contiguous(), hi.contiguous()
    got = kernels.raster_sweep(coef, lo, hi, size,
                               raster._cull_tile(size * size))
    want = raster._zbuffer_sweep_plain(coef, lo, hi, size)
    torch.cuda.synchronize()
    return got, want


@pytest.mark.parametrize("size", [16, 20, 48, 64, 256])
def test_raster_sweep_kernel_equals_plain(size):
    """z and winner bit-identical (no FMA contraction on either side);
    20² and 48² have ragged tiles."""
    dev = _card()
    verts, faces = _sphere()
    (z, w), (z_ref, w_ref) = _sweep_both(dev, verts, faces, size)
    assert torch.equal(z, z_ref) and torch.equal(w, w_ref)
    assert int((w < len(faces)).sum()) > 0


def test_raster_sweep_tie_goes_to_lower_index():
    dev = _card()
    tri = np.array([[-.4, -.4, 0.5], [.4, -.4, 0.5], [0., .4, 0.5]],
                   np.float32)
    verts = np.concatenate([tri, tri])
    filler = np.zeros((300, 3), np.int64)
    faces = np.concatenate([[[3, 4, 5]], filler, [[0, 1, 2]]])
    (z, w), (z_ref, w_ref) = _sweep_both(dev, verts, faces, 64)
    assert torch.equal(z, z_ref) and torch.equal(w, w_ref)
    hit = w < len(faces)
    assert int(hit.sum()) > 50 and bool((w[hit] == 0).all())


def test_render_on_card_matches_host():
    dev = _card()
    verts, faces = _sphere()
    from craniofacialsd_vae_tpu_torch.viz import render_batch

    batch = np.stack([verts, 0.8 * verts])
    card = render_batch(batch, faces, image_size=64, device=dev)
    host = render_batch(batch, faces, image_size=64, device="cpu")
    assert float((np.abs(card - host).max(-1) > 1e-3).mean()) < 0.01


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
    with pytest.raises(ValueError):
        kernels.raster_sweep(torch.zeros(100, 16, device=dev),
                             torch.zeros(1, device=dev),
                             torch.zeros(1, device=dev), 8, 64)


def test_launch_counts_move_only_on_launch():
    dev = _card()
    kernels.launches.reset()
    x = torch.randn(10, 8, device=dev)
    cols = torch.zeros(4, 3, dtype=torch.int32, device=dev)
    kernels.ell_matmul_fwd(cols, torch.ones(4, 3, device=dev), x)
    ops.ell_matmul_plain(cols, torch.ones(4, 3, device=dev), x)
    assert kernels.launches.snapshot() == {
        "spiral_conv_tc": 0, "spiral_conv_narrow": 0, "ell_matmul_fwd": 1,
        "raster_sweep": 0}


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
    card = DiagnosisService(bundle, cfg, norm, 10.0, max_batch=2,
                            device=dev).reconstruct(x)
    counts = kernels.launches.snapshot()
    host = DiagnosisService(bundle, cfg, norm, 10.0, max_batch=2,
                            device="cpu").reconstruct(x)
    assert counts["spiral_conv_tc"] == 2 * 8
    assert counts["spiral_conv_narrow"] == 2 and counts["ell_matmul_fwd"] == 8
    for key in ("vertices", "latent"):
        lim = 1e-4 * float(np.abs(host[key]).max())
        assert float(np.abs(card[key] - host[key]).max()) <= lim
    assert float(np.abs(card["vertex_errors_mm"]
                        - host["vertex_errors_mm"]).max()) <= 1e-3

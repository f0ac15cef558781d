"""The port's rasterizer and colours (plain versions, CPU) against the
JAX rasterizer run as its own tests run it (``interpret=True``), plus the
tie-break, background and device rules, the batched render against the
JAX package's, and the invariant of the kernel's cull."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from craniofacialsd_vae_tpu.geometry.synthetic import octasphere
from craniofacialsd_vae_tpu.viz import raster_pallas as jr
from craniofacialsd_vae_tpu.viz.colors import \
    errors_to_colors as jax_errors_to_colors
from craniofacialsd_vae_tpu.viz.renderer import look_at_camera
from craniofacialsd_vae_tpu_torch.viz import raster as tr
from craniofacialsd_vae_tpu_torch.viz.colors import errors_to_colors
from craniofacialsd_vae_tpu_torch.viz.renderer import (make_image_grid,
                                                       render_batch,
                                                       render_mesh)


def _sphere_cam(subdiv=2, seed=0):
    verts, faces = octasphere(subdiv)
    cols = np.random.default_rng(seed).random(verts.shape).astype(np.float32)
    eye, rot = look_at_camera()
    vc = ((verts - eye) @ rot.T).astype(np.float32)
    return vc, faces.astype(np.int32), cols


def _raster_both(vc, faces, cols, size, background=0.0):
    ref = np.asarray(jr.rasterize_pallas(
        jnp.asarray(vc), jnp.asarray(faces), jnp.asarray(cols),
        image_size=size, background=background, interpret=True))
    out = tr.rasterize(torch.from_numpy(vc), torch.from_numpy(faces),
                       torch.from_numpy(cols), image_size=size,
                       background=background).numpy()
    return out, ref


@pytest.mark.parametrize("subdiv", [2, 3])
def test_rasterize_matches_pallas_interpret(subdiv):
    """64² image, atol 1e-4 (the bound the JAX test of the Pallas kernel
    uses); subdivision 3 has 512 faces, two triangle blocks."""
    out, ref = _raster_both(*_sphere_cam(subdiv), 64)
    assert out.shape == (64, 64, 3)
    np.testing.assert_allclose(out, ref, atol=1e-4)


def test_coefficients_and_block_ranges_match_jax():
    """The same expressions as the JAX builder, on the same projected
    points. XLA contracts products and sums into FMAs on the CPU, which
    shifts the cancellation-prone terms, so: exact equality for padding
    rows and the block ranges, rtol 1e-5 / atol 1e-4 (pixels) for faces
    of at least one pixel² (the error of c grows with 1/area)."""
    vc, faces, _ = _sphere_cam(3)
    size = 64
    pts_t = tr.project(torch.from_numpy(vc), size)
    f = 1.0 / jnp.tan(jnp.deg2rad(60.0) / 2)
    z = -jnp.asarray(vc)[:, 2]
    pts_j = jnp.stack([
        (f * vc[:, 0] / jnp.maximum(z, 1e-6) * 0.5 + 0.5) * size,
        (0.5 - f * vc[:, 1] / jnp.maximum(z, 1e-6) * 0.5) * size, z], 1)
    np.testing.assert_allclose(pts_t.numpy(), np.asarray(pts_j),
                               rtol=1e-6, atol=1e-5)
    pts = np.array(pts_j)
    n_blocks = -(-len(faces) // 256) + 1          # one all-padding block
    coef_t = tr._triangle_coefficients(
        torch.from_numpy(pts), torch.from_numpy(faces).long(),
        n_blocks).numpy()
    coef_j = np.asarray(jr._triangle_coefficients(
        jnp.asarray(pts), jnp.asarray(faces), n_blocks))
    assert coef_t.shape == (n_blocks * 256, 16)
    np.testing.assert_array_equal(coef_t[len(faces):], coef_j[len(faces):])
    x, y = pts[faces, 0], pts[faces, 1]
    area = (x[:, 1] - x[:, 0]) * (y[:, 2] - y[:, 0]) \
        - (y[:, 1] - y[:, 0]) * (x[:, 2] - x[:, 0])
    big = np.abs(area) >= 1.0
    assert big.sum() > len(faces) // 4
    np.testing.assert_allclose(coef_t[:len(faces)][big],
                               coef_j[:len(faces)][big],
                               rtol=1e-5, atol=1e-4)
    tri_y = pts[faces, 1]
    lo_t, hi_t = tr._block_y_ranges(torch.from_numpy(tri_y), n_blocks)
    lo_j, hi_j = jr._block_y_ranges(jnp.asarray(tri_y), n_blocks)
    np.testing.assert_array_equal(lo_t.numpy(), np.asarray(lo_j))
    np.testing.assert_array_equal(hi_t.numpy(), np.asarray(hi_j))
    assert lo_t[-1] > hi_t[-1]                    # padding: empty range


@pytest.mark.parametrize("size", [16, 48])
def test_sweep_matches_pallas_interpret_on_same_coefficients(size):
    """Fed the same coefficients, the plain sweep gives the Pallas
    kernel's winners exactly and its depths within 1e-6 relative (XLA
    contracts the affine forms into FMAs on the CPU; the port rounds each
    product, as its CUDA kernel does). A 48² image has a ragged last
    tile."""
    vc, faces, _ = _sphere_cam(3)
    pts = tr.project(torch.from_numpy(vc), size)
    inp = tr.sweep_inputs(pts[None], torch.from_numpy(faces), size)
    tri_y = pts[torch.from_numpy(faces).long(), 1]
    z_t, w_t = (a[0] for a in tr._zbuffer_sweep(inp, size))
    z_j, w_j = jr._zbuffer_sweep(jnp.asarray(inp.coef[0].numpy()),
                                 jnp.asarray(tri_y.numpy()), size,
                                 interpret=True)
    np.testing.assert_array_equal(w_t.numpy(), np.asarray(w_j))
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), rtol=1e-6,
                               atol=0)
    assert (w_t.numpy() < len(faces)).any() and (z_t.numpy() >= 3e38).any()


def test_background_and_misses():
    v = np.array([[-.1, -.1, 0.], [.1, -.1, 0.], [0., .1, 0.]], np.float32)
    vc = v + np.array([0., 0., -2.0], np.float32)
    faces = np.array([[0, 1, 2]], np.int32)
    out, ref = _raster_both(vc, faces, np.ones((3, 3), np.float32), 32,
                            background=0.25)
    assert np.isclose(out.min(), 0.25) and out.max() > 0.9
    np.testing.assert_allclose(out, ref, atol=1e-4)


@pytest.mark.parametrize("gap", [0, 300])
def test_tie_goes_to_lower_index(gap):
    """Two coplanar triangles over the same pixels, red first, green
    second (``gap`` degenerate faces between them puts the green one in
    another triangle block): red must win everywhere, and swapping the
    order makes green win."""
    tri = np.array([[-.4, -.4, -2.], [.4, -.4, -2.], [0., .4, -2.]],
                   np.float32)
    vc = np.concatenate([tri, tri])
    cols = np.array([[1, 0, 0]] * 3 + [[0, 1, 0]] * 3, np.float32)
    filler = np.zeros((gap, 3), np.int32)
    for first, second, want in (([0, 1, 2], [3, 4, 5], 0),
                                ([3, 4, 5], [0, 1, 2], 1)):
        faces = np.concatenate([[first], filler, [second]]).astype(np.int32)
        out, ref = _raster_both(vc, faces, cols, 32)
        hit = out.sum(-1) > 0
        assert hit.sum() > 50
        # the barycentrics sum to 1 within fp32 rounding
        np.testing.assert_allclose(out[hit][:, want], 1.0, atol=1e-5)
        np.testing.assert_allclose(out[hit][:, 1 - want], 0.0, atol=1e-5)
        np.testing.assert_allclose(out, ref, atol=1e-4)


def test_render_batch_shaded_and_shadeless():
    verts, faces = octasphere(2)
    batch = np.stack([verts, verts * 0.9]).astype(np.float32)
    imgs = render_batch(batch, faces, image_size=32, device="cpu")
    assert imgs.shape == (2, 32, 32, 3)
    assert 0.0 <= imgs.min() and imgs.max() <= 1.0
    single = render_mesh(verts, faces, image_size=32, device="cpu")
    np.testing.assert_allclose(imgs[0], single, atol=1e-4)
    red = np.tile([1.0, 0.0, 0.0], (len(verts), 1))
    flat = render_batch(batch, faces, red, image_size=32, shadeless=True,
                        background=0.5, device="cpu")
    hit = np.any(flat != 0.5, axis=-1)
    assert hit.mean() > 0.1
    np.testing.assert_allclose(flat[hit][:, 0], 1.0, atol=1e-4)
    grid = make_image_grid(np.concatenate([imgs, flat]), nrow=2, padding=2)
    assert grid.shape == (2 * 34 + 2, 2 * 34 + 2, 3)


def test_render_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    verts, faces = octasphere(1)
    with pytest.raises(RuntimeError, match="CUDA"):
        render_batch(verts[None], faces, image_size=16)


def test_errors_to_colors_equals_matplotlib():
    rng = np.random.default_rng(0)
    cases = [(rng.random(500) * 7 - 1, 0, 5),
             (np.array([0., 1., 2.5, 5., -3., 10., np.nan]), 0, 5.0),
             (np.linspace(0, 5, 10), 0, 5),
             (rng.normal(size=(3, 40)), None, None),
             (np.full(4, 2.0), None, None)]
    for vals, lo, hi in cases:
        out = errors_to_colors(vals, lo, hi, "plasma")
        ref = jax_errors_to_colors(vals, lo, hi, "plasma")
        assert out.dtype == np.uint8 and out.shape == ref.shape
        np.testing.assert_array_equal(out, ref)
    with pytest.raises(ValueError):
        errors_to_colors(np.zeros(3), cmap="viridis")


def _octasphere_batch(n, seed=0):
    """``n`` distinct meshes on the octasphere's faces (seeded scales and
    offsets) and seeded per-vertex colours."""
    verts, faces = octasphere(2)
    rng = np.random.default_rng(seed)
    batch = np.stack([verts * rng.uniform(0.7, 1.1)
                      + rng.normal(0, 0.05, verts.shape) for _ in range(n)])
    cols = rng.random((n,) + verts.shape)
    return batch.astype(np.float32), faces, cols.astype(np.float32)


@pytest.mark.parametrize("shadeless", [False, True])
def test_render_batch_matches_jax_render_batch(monkeypatch, shadeless):
    """Three distinct meshes, against the JAX package's portable vmapped
    path (native rasterizer off, max_vmap 2, floats): atol 1e-4, the bound
    the JAX tests hold its rasterizers to."""
    from craniofacialsd_vae_tpu.viz.renderer import \
        render_batch as jax_render_batch

    monkeypatch.setenv("CFSDVAE_NATIVE_RASTER", "0")
    batch, faces, cols = _octasphere_batch(3)
    kw = dict(image_size=32, shadeless=shadeless, background=0.25,
              max_vmap=2)
    ref = jax_render_batch(batch, faces, cols, quantize_transfer=False, **kw)
    out = render_batch(batch, faces, cols, quantize_transfer=False,
                       device="cpu", **kw)
    assert out.shape == ref.shape == (3, 32, 32, 3)
    assert (out == 0.25).any() and (out != 0.25).mean() > 0.1
    np.testing.assert_allclose(out, ref, atol=1e-4)


def test_rasterize_batch_equals_rasterize_per_mesh():
    """The batched coefficient build, sweep and resolve give each mesh the
    bits of its own ``rasterize``."""
    batch, faces, cols = _octasphere_batch(3, seed=1)
    eye, rot = look_at_camera()
    vc = torch.from_numpy(((batch - eye) @ rot.T).astype(np.float32))
    f = torch.from_numpy(faces)
    c = torch.from_numpy(cols)
    out = tr.rasterize_batch(vc, f, c, image_size=24, background=0.5)
    for b in range(3):
        one = tr.rasterize(vc[b], f, c[b], image_size=24, background=0.5)
        assert torch.equal(out[b], one)


def test_render_batch_sub_batches_give_the_same_images():
    """A max_vmap that does not divide the batch (and one that exceeds
    it) gives the images of one mesh at a time, bit for bit."""
    batch, faces, cols = _octasphere_batch(5, seed=2)
    imgs = [render_batch(batch, faces, cols, image_size=24, max_vmap=mv,
                         device="cpu") for mv in (1, 2, 8)]
    assert np.array_equal(imgs[0], imgs[1])
    assert np.array_equal(imgs[0], imgs[2])


def test_meshes_per_launch_keeps_the_resolve_near_1_gb():
    assert tr.meshes_per_launch(256) == 64
    assert tr.meshes_per_launch(512) == 16
    assert tr.meshes_per_launch(4096) == 1


def _inside_pairs(inp, size):
    """The (pixel, triangle) pairs the plain twin finds inside (strip cull
    included), as codes pixel·Fp + triangle."""
    coef, fp = inp.coef, inp.coef.shape[0]
    n_pix = size * size
    tile = tr._cull_tile(n_pix)
    gid = torch.arange(n_pix)
    px = (gid % size).to(torch.float32) + 0.5
    py = (gid // size).to(torch.float32) + 0.5
    lo, hi = tr._strip_rows(gid // tile, tile, size)
    codes = []
    for j in range(inp.ymin.shape[0]):
        c = coef[j * 256:(j + 1) * 256]

        def affine(k):
            return c[:, k:k + 1] * px + c[:, k + 1:k + 2] * py \
                + c[:, k + 2:k + 3]

        hit = (inp.ymin[j] <= hi) & (inp.ymax[j] >= lo)
        inside = (affine(0) >= 0) & (affine(3) >= 0) & (affine(6) >= 0) \
            & (affine(9) > 1e-6) & hit
        t, p = torch.nonzero(inside, as_tuple=True)
        codes.append(p * fp + t + j * 256)
    return torch.cat(codes)


def _invariant_cases():
    from craniofacialsd_vae_tpu_torch.geometry import (adversarial_mesh,
                                                       load_bundle)

    bundle = load_bundle(os.path.join(os.path.dirname(__file__), "fixtures",
                                      "geometry.npz"))
    eye, rot = look_at_camera()
    verts, faces = octasphere(3)
    return {"octasphere": ((verts - eye) @ rot.T, faces, 64),
            "lr0": ((bundle.lr_pos[0] - eye) @ rot.T, bundle.lr_face[0],
                    256),
            "adversarial": (*adversarial_mesh(64), 64)}


@pytest.mark.parametrize("mesh", ["octasphere", "lr0", "adversarial"])
def test_kernel_cull_keeps_every_inside_pair_and_no_skipped_one(mesh):
    """K7's invariant, through ``sweep_pairs`` (the plain mirror of the
    kernel's tile and triangle cull): the pairs it evaluates (i) hold every
    pair the twin finds inside and (ii) lie within the twin's strip-cull
    pairs."""
    vc, faces, size = _invariant_cases()[mesh]
    pts = tr.project(torch.as_tensor(np.asarray(vc, np.float32)), size)
    inp = tr.sweep_inputs(pts, torch.as_tensor(faces), size)
    pix, tri = tr.sweep_pairs(inp, size)
    fp = inp.coef.shape[0]
    kept = pix * fp + tri
    assert kept.unique().numel() == kept.numel()
    inside = _inside_pairs(inp, size)
    assert inside.numel() > 0
    assert bool(torch.isin(inside, kept).all())                      # (i)
    cull = tr._cull_tile(size * size)
    lo, hi = tr._strip_rows(pix // cull, cull, size)
    blk = tri // 256
    assert bool(((inp.ymin[blk] <= hi) & (inp.ymax[blk] >= lo)).all())  # (ii)
    # the boxes do cull: far fewer pairs than the strip cull keeps
    assert kept.numel() < 0.5 * size * size * fp

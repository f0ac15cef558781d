"""The chamfer K8's plain twins (``ops/distances.py`` of the port) against
the JAX package's ``nearest_dists_sq_sym``, ``chamfer_distance`` and
``jax.grad`` of the chamfer, on seeded clouds, plus the CSR walk of the
backward and the fit's padded target.

Tolerances: distances within 1e-5 of the largest (fp32 products summed
in another order by XLA and PyTorch; the kernel form adds the query's
norm after the minimum), gradients within 1e-5 of the largest."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from craniofacialsd_vae_tpu.ops import distances as jd
from craniofacialsd_vae_tpu_torch.ops import distances as td

D_RTOL = 1e-5
G_RTOL = 1e-5


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _clouds(seed, r, p, q, offset=0.0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(r, p, 3)) + offset).astype(np.float32)
    y = (rng.normal(size=(q, 3)) + offset).astype(np.float32)
    return x, y


def _jax_sym(x, y):
    return jax.vmap(lambda a: jd.nearest_dists_sq_sym(a, jnp.asarray(y)))(
        jnp.asarray(x))


@pytest.mark.parametrize("r,p,q,offset", [
    (1, 200, 300, 0.0),
    (3, 500, 5000, 0.0),        # two of JAX's 4,096-column chunks
    (2, 300, 4100, 100.0),      # a large frame offset: the centring
])
def test_sym_twin_matches_jax(r, p, q, offset):
    x, y = _clouds(r * p, r, p, q, offset)
    jx, jy = _jax_sym(x, y)
    dx, dy = td.nearest_dists_sq_sym(torch.from_numpy(x), torch.from_numpy(y))
    assert dx.shape == (r, p) and dy.shape == (r, q)
    assert _rel(dx, jx) <= D_RTOL
    assert _rel(dy, jy) <= D_RTOL


@pytest.mark.parametrize("r,p,q,offset", [(1, 150, 260, 0.0),
                                          (3, 200, 4200, 50.0)])
def test_gradients_match_jax_grad(r, p, q, offset):
    """d(Σ g_x·d_x + Σ g_y·d_y) in both clouds against ``jax.grad``."""
    x, y = _clouds(r + q, r, p, q, offset)
    rng = np.random.default_rng(9)
    gx = rng.normal(size=(r, p)).astype(np.float32)
    gy = rng.normal(size=(r, q)).astype(np.float32)

    def loss(a, b):
        d1, d2 = jax.vmap(lambda aa: jd.nearest_dists_sq_sym(aa, b))(a)
        return jnp.sum(d1 * gx) + jnp.sum(d2 * gy)

    ja, jb = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    xt = torch.tensor(x, requires_grad=True)
    yt = torch.tensor(y, requires_grad=True)
    dx, dy = td.nearest_dists_sq_sym(xt, yt)
    ((dx * torch.from_numpy(gx)).sum()
     + (dy * torch.from_numpy(gy)).sum()).backward()
    assert _rel(xt.grad, ja) <= G_RTOL
    assert _rel(yt.grad, jb) <= G_RTOL


def test_fit_padded_target_gradient_matches_jax():
    """The fit's chamfer: the target padded to a power of two with copies
    of its first point, the target side masked. The copies tie exactly, so
    JAX splits their cotangent and the first argmin gives it to one: the
    same gradient in the generated side."""
    rng = np.random.default_rng(3)
    gen = rng.normal(size=(2, 120, 3)).astype(np.float32)
    t_sub = rng.normal(size=(100, 3)).astype(np.float32)
    q_pad = 128
    t_pad = np.concatenate([t_sub, np.broadcast_to(t_sub[:1], (28, 3))])
    mask = (np.arange(q_pad) < 100).astype(np.float32)

    def loss(g):
        def one(gg):
            d_g, d_t = jd.nearest_dists_sq_sym(gg, jnp.asarray(t_pad))
            return jnp.mean(d_g) + jnp.sum(d_t * mask) / 100.0
        return jnp.sum(jax.vmap(one)(g))

    jg = jax.grad(loss)(jnp.asarray(gen))
    g = torch.tensor(gen, requires_grad=True)
    d_g, d_t = td.nearest_dists_sq_sym(g, torch.from_numpy(t_pad))
    (d_g.mean(1) + (d_t * torch.from_numpy(mask)).sum(1) / 100.0).sum() \
        .backward()
    assert float(loss(jnp.asarray(gen))) == pytest.approx(
        float((d_g.mean(1) + (d_t * torch.from_numpy(mask)).sum(1)
               / 100.0).sum().detach()), rel=1e-5)
    assert _rel(g.grad, jg) <= G_RTOL


def test_argmin_csr_walks_each_segment_in_order():
    idx_v = torch.tensor([[2, 0, 2, 1, 0], [1, 1, 1, 1, 1]],
                         dtype=torch.int32)
    perm, off = td.argmin_csr(idx_v, 3)
    assert perm.dtype == torch.int32 and off.dtype == torch.int32
    np.testing.assert_array_equal(perm.numpy(), [[1, 4, 3, 0, 2],
                                                 [0, 1, 2, 3, 4]])
    np.testing.assert_array_equal(off.numpy(), [[0, 2, 3, 5], [0, 0, 5, 5]])


def test_bwd_twin_is_the_scatter_of_the_jvp():
    """The CSR walk sums the same contributions as a direct scatter."""
    x, y = _clouds(11, 2, 60, 90)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    mu = yt.mean(0)
    d_x, d_y, a, b = td.nearest_dists_sq_sym_plain(xt, yt)
    rng = np.random.default_rng(2)
    gx = torch.from_numpy(rng.normal(size=(2, 60)).astype(np.float32))
    gy = torch.from_numpy(rng.normal(size=(2, 90)).astype(np.float32))
    perm, off = td.argmin_csr(b, 60)
    got = td.nearest_sq_bwd_plain(xt, yt, mu, gx, d_x, a, gy, d_y, perm, off)
    xc, yc = x - mu.numpy(), y - mu.numpy()
    want = np.zeros_like(x)
    for r in range(2):
        for p in range(60):
            want[r, p] += 2 * gx[r, p].item() * (xc[r, p] - yc[a[r, p]])
        for q in range(90):
            p = int(b[r, q])
            want[r, p] += 2 * gy[r, q].item() * (xc[r, p] - yc[q])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_nearest_and_chamfer_match_jax():
    x, y = _clouds(4, 2, 40, 60)
    np.testing.assert_allclose(
        td.nearest_dists_sq(torch.from_numpy(x[0]), torch.from_numpy(y)),
        np.asarray(jd.nearest_dists_sq(jnp.asarray(x[0]), jnp.asarray(y))),
        rtol=1e-5, atol=1e-6)
    y2 = np.stack([y, y[::-1] * 0.5])
    got = td.chamfer_distance(torch.from_numpy(x), torch.from_numpy(y2))
    want = jd.chamfer_distance(jnp.asarray(x), jnp.asarray(y2))
    assert got.shape == (2,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    one = td.chamfer_distance(torch.from_numpy(x[0]), torch.from_numpy(y))
    assert one.dim() == 0
    assert float(td.chamfer_distance(torch.from_numpy(x[0]),
                                     torch.from_numpy(x[0]))) < 1e-6


def test_point_mesh_distance_matches_jax():
    from craniofacialsd_vae_tpu_torch.geometry.synthetic import octasphere

    verts, faces = octasphere(1)
    rng = np.random.default_rng(6)
    pts = (verts[faces].mean(axis=1) + rng.normal(
        scale=0.05, size=(len(faces), 3))).astype(np.float32)
    got = td.point_mesh_distance(torch.from_numpy(pts), verts, faces)
    assert got == pytest.approx(
        jd.point_mesh_distance(jnp.asarray(pts), verts, faces), rel=1e-12)
    on = td.point_mesh_distance(verts[faces].mean(axis=1), verts, faces)
    assert on < 1e-10


def test_cuda_tensor_without_the_kernel_raises(monkeypatch):
    """A CUDA tensor goes to the kernel or raises: no fallback."""
    def no_card(*args, **kwargs):
        raise RuntimeError("no CUDA device")

    monkeypatch.setattr(td.kernels, "nearest_sq", no_card)
    x = torch.zeros((4, 3))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda s: True))
    with pytest.raises(RuntimeError, match="CUDA"):
        td.nearest_dists_sq_sym(x, x)

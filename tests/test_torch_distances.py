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


def _first_argmins(x, y):
    """The lowest index reaching each minimum, both directions, by numpy
    on the exact squared distances of the centred clouds (float64)."""
    mu = y.astype(np.float64).mean(0)
    d2 = (((x.astype(np.float64) - mu)[:, None, :]
           - (y.astype(np.float64) - mu)[None, :, :]) ** 2).sum(-1)
    return np.argmin(d2, axis=1), np.argmin(d2, axis=0)


def test_exact_ties_go_to_the_lowest_index_in_both_directions():
    """Duplicated points of either cloud tie exactly: the twin's argmins
    (what k8_fwd must give) take the lowest index, as ``np.argmin`` does,
    and its distances equal JAX's."""
    rng = np.random.default_rng(21)
    x = rng.normal(size=(300, 3)).astype(np.float32)
    y = rng.normal(size=(500, 3)).astype(np.float32)
    x[250:280] = x[10:40]          # rows tied for the columns near them
    y[400:480] = y[50:130]         # columns tied for the rows near them
    d_x, d_y, a, b = td.nearest_dists_sq_sym_plain(torch.from_numpy(x[None]),
                                                   torch.from_numpy(y))
    want_a, want_b = _first_argmins(x, y)
    np.testing.assert_array_equal(a[0].numpy(), want_a)
    np.testing.assert_array_equal(b[0].numpy(), want_b)
    assert not ((a[0] >= 400) & (a[0] < 480)).any()
    assert not ((b[0] >= 250) & (b[0] < 280)).any()
    jx, jy = jd.nearest_dists_sq_sym(jnp.asarray(x), jnp.asarray(y))
    assert _rel(d_x[0], jx) <= D_RTOL and _rel(d_y[0], jy) <= D_RTOL


@pytest.mark.parametrize("q,q_pad", [(100, 128), (4500, 8192)])
def test_padded_target_ties_and_gradient_match_jax(q, q_pad):
    """The fit's padded target: the copies of its first point never win a
    row (the first copy, index 0, does), each copy takes the argmin its
    original takes, and the masked chamfer's gradient in the generated
    side equals ``jax.grad`` (JAX splits the copies' zero cotangents; the
    lowest argmin gives them to one point)."""
    rng = np.random.default_rng(q)
    gen = rng.normal(size=(2, 300, 3)).astype(np.float32)
    t_sub = rng.normal(size=(q, 3)).astype(np.float32)
    t_pad = np.concatenate([t_sub, np.broadcast_to(t_sub[:1],
                                                   (q_pad - q, 3))])
    mask = (np.arange(q_pad) < q).astype(np.float32)
    _, _, a, b = td.nearest_dists_sq_sym_plain(torch.from_numpy(gen),
                                               torch.from_numpy(t_pad))
    assert int((a >= q).sum()) == 0
    assert torch.equal(b[:, q:], b[:, :1].expand(-1, q_pad - q))

    def loss(g):
        def one(gg):
            d_g, d_t = jd.nearest_dists_sq_sym(gg, jnp.asarray(t_pad))
            return jnp.mean(d_g) + jnp.sum(d_t * mask) / q
        return jnp.sum(jax.vmap(one)(g))

    jg = jax.grad(loss)(jnp.asarray(gen))
    g = torch.tensor(gen, requires_grad=True)
    d_g, d_t = td.nearest_dists_sq_sym(g, torch.from_numpy(t_pad))
    (d_g.mean(1) + (d_t * torch.from_numpy(mask)).sum(1) / q).sum() \
        .backward()
    assert _rel(g.grad, jg) <= G_RTOL


def test_argmin_csr_walks_a_padded_segment_in_order():
    """A padded target's copies all pick one generated point: its segment
    holds hundreds of entries, in increasing ``j``, and the CSR walk sums
    them in that order (the twin equals a sequential float32 sum)."""
    rng = np.random.default_rng(5)
    q, q_pad, p = 7500, 8192, 400
    idx_v = rng.integers(0, p, size=(2, q_pad)).astype(np.int32)
    idx_v[:, q:] = idx_v[:, :1]
    perm, off = td.argmin_csr(torch.from_numpy(idx_v), p)
    for r in range(2):
        pt = int(idx_v[r, 0])
        seg = perm[r, off[r, pt]:off[r, pt + 1]].numpy()
        assert len(seg) >= q_pad - q + 1
        assert (np.diff(seg) > 0).all()
        assert seg[0] == 0 and set(range(q, q_pad)) <= set(seg.tolist())
        np.testing.assert_array_equal(np.diff(off[r].numpy()),
                                      np.bincount(idx_v[r], minlength=p))
    # the walk: each point's own term, then its segment in increasing j
    x = rng.normal(size=(2, p, 3)).astype(np.float32)
    y = rng.normal(size=(q_pad, 3)).astype(np.float32)
    y[q:] = y[0]
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    mu = yt.mean(0)
    d_x, d_y, a, b = td.nearest_dists_sq_sym_plain(xt, yt)
    gx = torch.from_numpy(rng.normal(size=(2, p)).astype(np.float32))
    gy = torch.from_numpy(rng.normal(size=(2, q_pad)).astype(np.float32))
    perm, off = td.argmin_csr(b, p)
    got = td.nearest_sq_bwd_plain(xt, yt, mu, gx, d_x, a, gy, d_y, perm, off)
    xc, yc = (xt - mu).numpy(), (yt - mu).numpy()
    for r in range(2):
        pt = int(b[r, 0])
        acc = (np.float32(2) * gx[r, pt].numpy()
               * (xc[r, pt] - yc[a[r, pt]])).astype(np.float32)
        for j in perm[r, off[r, pt]:off[r, pt + 1]].numpy():
            c = np.float32(2) * gy[r, j].numpy() if d_y[r, j] > 0 \
                else np.float32(0)
            acc = (acc + (c * (xc[r, pt] - yc[j])).astype(np.float32)) \
                .astype(np.float32)
        np.testing.assert_array_equal(got[r, pt].numpy(), acc)


def test_one_direction_matches_jax_and_the_symmetric_twin():
    """``nearest_dists_sq`` (one direction: k8_fwd with its column
    reduction off on the card) against JAX and the symmetric twin's rows,
    on a batched-size cloud with ties."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(700, 3)).astype(np.float32)
    y = rng.normal(size=(5000, 3)).astype(np.float32)
    y[4500:] = y[:500]
    got = td.nearest_dists_sq(torch.from_numpy(x), torch.from_numpy(y))
    assert got.shape == (700,)
    want = jd.nearest_dists_sq(jnp.asarray(x), jnp.asarray(y))
    assert _rel(got, want) <= D_RTOL
    sym = td.nearest_dists_sq_sym_plain(torch.from_numpy(x[None]),
                                        torch.from_numpy(y))[0][0]
    assert torch.equal(got, sym)


@pytest.mark.parametrize("batch,nx,ny", [(16, 4097, 8192), (1, 4097, 8192),
                                         (3, 100, 5000), (2, 50, 70),
                                         (16, 4260, 131072)])
def test_k8_plans_fit_the_kernel(batch, nx, ny):
    """K8's launch plans (pure Python; the CUDA source checks them):
    column ranges of a multiple of 32 up to 1,024 within 65,535 ranges,
    at most 8 row tiles a block, and backward blocks of at most 512 query
    points over at most 65,535 blocks, no more points a block than a
    share of two blocks a streaming multiprocessor gives."""
    from craniofacialsd_vae_tpu_torch import kernels

    cols, tiles_per_group = kernels.k8_plan(batch, nx, ny)
    assert cols % 32 == 0 and 32 <= cols <= 1024
    assert -(-ny // cols) <= 65535 and 1 <= tiles_per_group <= 8
    tiles = -(-nx // 192)
    groups = -(-tiles // tiles_per_group)
    assert groups == -(-tiles // 8)
    bins = kernels.k8_bwd_bins(batch, nx)
    assert 1 <= bins <= 512 and -(-nx // bins) <= 65535
    assert bins <= -(-nx // min(nx, -(-2 * 132 // batch)))

"""The port's ``mixed`` and ``bfloat16`` activation policies (plain
versions, CPU) against the JAX package on the same numpy inputs.

Inputs are rounded to bf16 once in numpy-land, so both packages see the
same bits. Tolerances, each with its reason:

- a bf16 output within one bf16 ulp of JAX's: the same fp32 products and
  sums, taken in another order by XLA and by PyTorch, can round to the
  neighbouring bf16 value;
- an fp32 output of bf16 operands within 1e-5 of the array's max (fp32
  summation order);
- gradients within 1e-2 of each leaf's max: bf16 cotangents pass through
  several rounded products, whose rounding differs where an fp32 sum
  lands near a bf16 tie;
- the whole model's outputs within 2e-2 of the max, the step's losses
  within 1e-2: those differences compound over the layers; the whole
  gradient's cosine above 0.999, the JAX package's own bar for the
  mixed gradient against fp32.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from craniofacialsd_vae_tpu import ops as jops
from craniofacialsd_vae_tpu.geometry.precompute import _save_bundle
from craniofacialsd_vae_tpu.manager import ModelManager as JManager
from craniofacialsd_vae_tpu.models import SDVAEConfig as JConfig
from craniofacialsd_vae_tpu.models import decode as jax_decode
from craniofacialsd_vae_tpu.models import forward as jax_forward
from craniofacialsd_vae_tpu.models import init_sdvae as jax_init
from craniofacialsd_vae_tpu.ops import sparse as jsparse
from craniofacialsd_vae_tpu.training import LossWeights as JWeights
from craniofacialsd_vae_tpu.training import coupled_adam as jax_adam
from craniofacialsd_vae_tpu.training import trainer as jtrainer
from craniofacialsd_vae_tpu_torch import kernels
from craniofacialsd_vae_tpu_torch import ops as tops
from craniofacialsd_vae_tpu_torch.data import dataset as tdataset
from craniofacialsd_vae_tpu_torch.geometry import load_bundle
from craniofacialsd_vae_tpu_torch.manager import ModelManager
from craniofacialsd_vae_tpu_torch.models import (SDVAE, SDVAEConfig,
                                                 SpiralGeometry,
                                                 params_from_jax)
from craniofacialsd_vae_tpu_torch.ops import sparse as tsparse
from craniofacialsd_vae_tpu_torch.serving import DiagnosisService
from craniofacialsd_vae_tpu_torch.training import (LOSS_KEYS, LossWeights,
                                                   coupled_adam,
                                                   compute_losses,
                                                   make_train_step)
from tests.test_torch_manager import jax_draws, make_workspace
from tests.test_training import _tiny_geometry

BF16 = torch.bfloat16
F32_RTOL = 1e-5
GRAD_RTOL = 1e-2
MODEL_RTOL = 2e-2
LOSS_RTOL = 1e-2
B, Z = 3, 6
WEIGHTS = dict(kl=1e-4, laplacian=0.1, latent_consistency=0.5)


def _bf16(a):
    """``a`` rounded to bf16, as float32 numpy (the bits both packages
    get)."""
    return np.array(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
                    .astype(jnp.float32))


def _rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _within_ulp(got, want):
    """Every element of two bf16 arrays within one bf16 ulp of the larger
    magnitude (8 significant bits)."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 2.0 ** -120))) - 7)
    assert bool(np.all(np.abs(got - want) <= ulp)), \
        float(np.max(np.abs(got - want) / ulp))


def _close(got, want, rtol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (err, scale)


def _skewed_idx(rng, n=70):
    """Gather indices whose transpose has overflow tiers."""
    idx = np.concatenate([np.zeros(200, int), np.ones(60, int),
                          np.full(20, 2), rng.integers(3, n, 120)])
    rng.shuffle(idx)
    return idx


# ----------------------------------------------------------- ELL in bf16
def test_xla_forms_a_bf16_ell_sum_in_fp32_with_one_rounding():
    """Where XLA on the CPU rounds JAX's bf16 ``ell_matmul_raw``: fp32
    products of the bf16 values and one rounding of their fp32 sum. The
    port's twin (and K4-bf16) equals it bit for bit; rounding after every
    product and add, the other candidate, does not."""
    rng = np.random.default_rng(0)
    m, n, k, d = 400, 300, 5, 64
    cols = rng.integers(0, n, (m, k)).astype(np.int32)
    vals = _rand(rng, m, k)
    x = _bf16(_rand(rng, n, d))
    want = jsparse.ell_matmul_raw(jnp.asarray(cols), jnp.asarray(vals),
                                  jnp.asarray(x, jnp.bfloat16))
    got = tsparse.ell_matmul_plain(torch.from_numpy(cols),
                                   torch.from_numpy(vals),
                                   torch.from_numpy(x).to(BF16))
    assert got.dtype == BF16
    np.testing.assert_array_equal(_np(got), _np(want))
    v = torch.from_numpy(vals).to(BF16)
    g = torch.from_numpy(x).to(BF16)[torch.from_numpy(cols).long()]
    stepwise = v[:, 0, None] * g[:, 0]
    for j in range(1, k):
        stepwise = stepwise + v[:, j, None] * g[:, j]
    assert (_np(stepwise) != _np(want)).mean() > 0.1


@pytest.mark.parametrize("m,n,k,d", [(50, 40, 3, 16), (120, 30, 4, 7)])
def test_ell_matmul_bf16_matches_jax(m, n, k, d):
    rng = np.random.default_rng(m)
    cols = rng.integers(0, n, (m, k)).astype(np.int32)
    vals = _rand(rng, m, k)
    x = _bf16(_rand(rng, n, 2, d))
    want = jsparse.ell_matmul_raw(jnp.asarray(cols), jnp.asarray(vals),
                                  jnp.asarray(x, jnp.bfloat16))
    got = tsparse.ell_matmul_raw(torch.from_numpy(cols),
                                 torch.from_numpy(vals),
                                 torch.from_numpy(x).to(BF16))
    assert got.dtype == BF16 and got.shape == (m, 2, d)
    _within_ulp(got, want)


_FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                        "geometry.npz")


@pytest.fixture(scope="module")
def fixture_up_pools():
    """The fixture's four up-pools (level l+1 -> l) as COO arrays."""
    return [(u.rows, u.cols, u.vals, u.shape)
            for u in load_bundle(_FIXTURE).up]


@pytest.mark.parametrize("level", [0, 1, 2, 3])
@pytest.mark.parametrize("m", [256, 301])
def test_ell_matmul_bf16_on_the_fixture_up_pools_bit_equal_to_jax(
        fixture_up_pools, level, m):
    """K4-bf16's twin on the fixture's real up-pool tables (K = 3, the
    kernel's compiled case), cut to their first ``m`` rows (301: odd, a
    block's last rows past M), bit for bit against JAX
    ``ell_matmul_raw`` on bf16 rows at B = 3 of 32 channels."""
    rows, cols, vals, (n_rows, n_cols) = fixture_up_pools[level]
    keep = rows < min(m, n_rows)
    mat_t = tsparse.from_coo(rows[keep], cols[keep], vals[keep],
                             (min(m, n_rows), n_cols), with_transpose=False)
    mat_j = jsparse.from_coo(rows[keep], cols[keep], vals[keep],
                             (min(m, n_rows), n_cols))
    assert mat_t.cols.shape[1] == 3
    np.testing.assert_array_equal(mat_t.cols.numpy(), np.asarray(mat_j.cols))
    rng = np.random.default_rng(level * 1000 + m)
    x = _bf16(_rand(rng, n_cols, 3, 32))
    want = jsparse.ell_matmul_raw(mat_j.cols, mat_j.vals,
                                  jnp.asarray(x, jnp.bfloat16))
    got = tsparse.ell_matmul_raw(mat_t.cols, mat_t.vals,
                                 torch.from_numpy(x).to(BF16))
    assert got.dtype == BF16 and got.shape == (min(m, n_rows), 3, 32)
    np.testing.assert_array_equal(_np(got), _np(want))


def test_capped_ell_apply_bf16_matches_jax():
    """A table with overflow tiers: the main sum, each tier's sum and the
    landing rounded where JAX rounds them; the fused kernel's walk twin
    equals the plain landing bit for bit."""
    rng = np.random.default_rng(2)
    idx = _skewed_idx(rng)
    vals = _rand(rng, len(idx))
    ce_t = tsparse.capped_ell(idx, np.arange(len(idx)), vals, 70)
    ce_j = jsparse.capped_ell(idx, np.arange(len(idx)), vals, 70)
    assert len(ce_t.tiers) >= 2
    x = _bf16(_rand(rng, len(idx), 3, 5))
    want = ce_j.apply(jnp.asarray(x, jnp.bfloat16))
    xt = torch.from_numpy(x).to(BF16)
    got = ce_t.apply(xt)
    assert got.dtype == BF16
    _within_ulp(got, want)
    walk = tsparse.ell_matmul_capped_plain(ce_t.cols, ce_t.vals, ce_t.tiers,
                                           ce_t.links, xt)
    assert torch.equal(walk, got)


def test_ell_matmul_backward_bf16_matches_jax():
    """The up-pool's backward in bf16: dy gathered through the capped
    transpose in bf16 (JAX ``_ell_bwd``)."""
    rng = np.random.default_rng(3)
    m, n = 400, 70
    rows, cols = np.arange(m), _skewed_idx(rng, n)
    vals = _rand(rng, m)
    mat_t = tsparse.from_coo(rows, cols, vals, (m, n))
    mat_j = jsparse.from_coo(rows, cols, vals, (m, n))
    x, dy = _bf16(_rand(rng, n, 3, 2)), _bf16(_rand(rng, m, 3, 2))
    _, vjp = jax.vjp(lambda x_: jsparse.ell_matmul(mat_j, x_),
                     jnp.asarray(x, jnp.bfloat16))
    x_t = torch.from_numpy(x).to(BF16).requires_grad_()
    tsparse.ell_matmul(mat_t, x_t).backward(torch.from_numpy(dy).to(BF16))
    assert x_t.grad.dtype == BF16
    _within_ulp(x_t.grad, vjp(jnp.asarray(dy, jnp.bfloat16))[0])


# ------------------------------------------------------ spiral conv in bf16
def _conv_case(rng, identity, m=40, n_src=None, seq=7, b=3, c_in=8, c_out=6):
    n_src = m if n_src is None else n_src
    table = rng.integers(0, n_src, size=(m, seq))
    if identity:
        table[:, 0] = np.arange(m)
    w = _rand(rng, seq * c_in, c_out) * 0.3
    bias = _rand(rng, c_out)
    x = _bf16(_rand(rng, n_src, b, c_in))
    dy = _rand(rng, m, b, c_out)
    return table, n_src, w, bias, x, dy


def _conv_both(table, n_src, w, bias, x, dy, fn_j, fn_t, dy_dtype):
    """Forward and VJP of one conv form in both packages: (out, dw, db,
    dx) of each."""
    jop = jops.build_spiral_op(table, n_src=n_src)
    out_j, vjp = jax.vjp(lambda w_, b_, x_: fn_j({"w": w_, "b": b_}, x_, jop),
                         jnp.asarray(w), jnp.asarray(bias),
                         jnp.asarray(x, jnp.bfloat16))
    dy_j = jnp.asarray(dy).astype(dy_dtype)
    grads_j = vjp(dy_j)
    top = tops.build_spiral_op(table, n_src=n_src)
    w_t = torch.from_numpy(w).requires_grad_()
    b_t = torch.from_numpy(bias).requires_grad_()
    x_t = torch.from_numpy(x).to(BF16).requires_grad_()
    out_t = fn_t({"w": w_t, "b": b_t}, x_t, top)
    out_t.backward(torch.from_numpy(np.asarray(dy_j.astype(jnp.float32)))
                   .to(out_t.dtype))
    return (out_j, *grads_j), (out_t, w_t.grad, b_t.grad, x_t.grad)


@pytest.mark.parametrize("identity,n_src", [(True, None), (False, 90)])
def test_spiral_conv_bf16_forward_and_vjp_match_jax(identity, n_src):
    """The bf16 conv (K1-bf16's twin) and its backward (dg and the
    identity columns in bf16, the capped transposes in bf16, dW and db
    in fp32 rounded once), on an identity table and on one composed with
    a down-selection. The parameters' gradients come back fp32."""
    rng = np.random.default_rng(4 + (n_src or 0))
    case = _conv_case(rng, identity, n_src=n_src)
    (out_j, dw_j, db_j, dx_j), (out_t, dw_t, db_t, dx_t) = _conv_both(
        *case, jops.spiral_conv, tops.spiral_conv, jnp.bfloat16)
    assert out_t.dtype == BF16 and out_j.dtype == jnp.bfloat16
    _within_ulp(out_t, out_j)
    assert dw_t.dtype == torch.float32 and db_t.dtype == torch.float32
    assert dx_t.dtype == BF16
    for got, want in ((dw_t, dw_j), (db_t, db_j), (dx_t, dx_j)):
        _close(got, want, GRAD_RTOL)
    # dW and db were rounded to bf16 once, as JAX's
    assert torch.equal(dw_t, dw_t.to(BF16).float())


def test_spiral_conv_f32out_matches_jax():
    """K3a's form: the bf16 conv's fp32 accumulator unrounded, its
    backward from the fp32 cotangent rounded to bf16 once."""
    rng = np.random.default_rng(7)
    case = _conv_case(rng, True, c_out=3)
    (out_j, dw_j, db_j, dx_j), (out_t, dw_t, db_t, dx_t) = _conv_both(
        *case,
        lambda p, x, op: jops.spiral_conv(p, x, op, out_dtype=jnp.float32),
        lambda p, x, op: tops.spiral_conv(p, x, op, torch.float32),
        jnp.float32)
    assert out_t.dtype == torch.float32
    _close(out_t, out_j, F32_RTOL)
    assert (_np(out_t) != _bf16(_np(out_t))).mean() > 0.5
    for got, want in ((dw_t, dw_j), (db_t, db_j), (dx_t, dx_j)):
        _close(got, want, GRAD_RTOL)


@pytest.mark.parametrize("identity", [True, False])
def test_spiral_conv_out_gather_matches_jax(identity):
    """The matmul-first final conv on ``TestSpiralConvOutGather``'s shapes
    (30 vertices, 5 positions, 8 → 3 channels, batch 4): fp32 out; the
    gradients' dtypes are jax.vjp's (x bf16, W and b fp32, W rounded to
    bf16 once)."""
    rng = np.random.default_rng(8)
    table, n_src, w, bias, x, dy = _conv_case(rng, identity, m=30, seq=5,
                                              b=4, c_in=8, c_out=3)
    (out_j, dw_j, db_j, dx_j), (out_t, dw_t, db_t, dx_t) = _conv_both(
        table, n_src, w, bias, x, dy, jops.spiral_conv_out_gather,
        tops.spiral_conv_out_gather, jnp.float32)
    assert out_t.dtype == torch.float32
    _close(out_t, out_j, F32_RTOL)
    assert (dx_t.dtype, dw_t.dtype, db_t.dtype) == (BF16, torch.float32,
                                                    torch.float32)
    assert dx_j.dtype == jnp.bfloat16 and dw_j.dtype == jnp.float32
    for got, want in ((dw_t, dw_j), (db_t, db_j), (dx_t, dx_j)):
        _close(got, want, GRAD_RTOL)
    assert torch.equal(dw_t, dw_t.to(BF16).float())
    # the same function as the gather-first fp32-output form, where the
    # bias (which that form casts to bf16) is bf16-exact
    params = {"w": torch.from_numpy(w), "b": torch.from_numpy(_bf16(bias))}
    x_t, op = torch.from_numpy(x).to(BF16), tops.build_spiral_op(table)
    _close(tops.spiral_conv_out_gather(params, x_t, op),
           tops.spiral_conv(params, x_t, op, torch.float32), 1e-4)


def test_out_gather_sum_twin_is_the_position_order_sum():
    """K3b's twin on the position-major ``u [L, O, N, B]``: the bias, then
    each position's gathered rows added in position order (the kernel's
    order)."""
    rng = np.random.default_rng(9)
    n, b, seq, o = 25, 2, 4, 3
    table = torch.from_numpy(rng.integers(0, n, (n, seq)).astype(np.int32))
    u = torch.from_numpy(_rand(rng, seq, o, n, b))
    bias = torch.from_numpy(_rand(rng, o))
    got = tops.out_gather_sum_plain(u, table, bias)
    want = bias.expand(n, b, o).clone()
    for l in range(seq):
        want = want + u[l][:, table[:, l].long()].permute(1, 2, 0)
    assert got.shape == (n, b, o)
    assert torch.equal(got, want)


@pytest.mark.parametrize("m,b,c_in,c_out", [(40, 3, 8, 16), (300, 4, 32, 3),
                                            (17, 1, 3, 32)])
def test_spiral_conv_dw_bf16_chunked_twin(m, b, c_in, c_out):
    """K2-dW-bf16's chunk-order twin against the plain twin and JAX's
    dW einsum: within one bf16 ulp."""
    rng = np.random.default_rng(m)
    seq = 9
    table = rng.integers(0, m, (m, seq)).astype(np.int32)
    x, dy = _bf16(_rand(rng, m, b, c_in)), _bf16(_rand(rng, m, b, c_out))
    plan = kernels.plan_spiral_conv_dw_bf16(m, b, seq, c_in, c_out)
    xt, dt = torch.from_numpy(x).to(BF16), torch.from_numpy(dy).to(BF16)
    tt = torch.from_numpy(table)
    chunked = tops.spiral_conv_dw_chunked_plain(xt, tt, dt, plan)
    plain = tops.spiral_conv_dw_plain(xt, tt, dt)
    assert chunked.dtype == BF16 and chunked.shape == (seq, c_in, c_out)
    _within_ulp(chunked, plain)
    want = jnp.stack([jnp.einsum(
        "nbc,nbo->co", jnp.asarray(x[table[:, i]], jnp.bfloat16),
        jnp.asarray(dy, jnp.bfloat16), preferred_element_type=jnp.float32)
        for i in range(seq)]).astype(jnp.bfloat16)
    _within_ulp(plain, want)


# ------------------------------------------------------------- the plans
@pytest.mark.parametrize("m,b,seq,c_in,c_out,path", [
    (1065, 16, 9, 32, 32, "bf16"), (267, 16, 9, 64, 64, "bf16"),
    (17039, 16, 9, 32, 3, "bf16"), (4260, 16, 9, 3, 32, "bf16_elem"),
    (40, 3, 7, 8, 6, "bf16_elem"), (100, 1, 9, 24, 130 - 2, "bf16_elem")])
def test_plan_spiral_conv_bf16(m, b, seq, c_in, c_out, path):
    """K1-bf16's plan: the vector path only where a 16-deep step lies in
    one position, W's rows (depth padded to 16) in a stride of an odd
    number of 16-byte units (conflict-free ldmatrix), at most one row tile
    per warp and as many blocks as the SMs hold."""
    plan = kernels.plan_spiral_conv(m, b, seq, c_in, c_out, True, True,
                                    BF16)
    assert plan.path == path and plan.kernel == "spiral_conv_bf16"
    assert plan.nt >= c_out and plan.nt // 8 in (1, 2, 4, 8, 16)
    assert plan.kp * 16 >= seq * c_in > (plan.kp - 1) * 16
    assert plan.ldw >= plan.nt and (plan.ldw // 8) % 2 == 1
    assert plan.ldw % 8 == 0 and plan.smem >= 2 * plan.kp * 16 * plan.ldw
    assert 1 <= plan.blocks <= max(1, -(-m * b // 16) // 8 + 1)
    assert kernels.plan_spiral_conv(m, b, seq, c_in, c_out, False, True,
                                    BF16).path == "bf16_elem"


def test_plan_spiral_conv_refuses_other_dtypes():
    with pytest.raises(ValueError):
        kernels.plan_spiral_conv(10, 1, 9, 32, 32, True, True, torch.float16)
    with pytest.raises(ValueError):
        kernels.plan_spiral_conv(10, 1, 9, 32, 300, True, True, BF16)
    with pytest.raises(ValueError):
        kernels.plan_spiral_conv_dw_bf16(10, 1, 9, 256, 32)


@pytest.mark.parametrize("m,b,seq,c_in,c_out", [
    (17039, 16, 9, 32, 32), (267, 16, 9, 64, 64), (67, 16, 9, 32, 64),
    (4260, 16, 9, 3, 32), (5, 1, 9, 8, 16)])
def test_plan_spiral_conv_dw_bf16(m, b, seq, c_in, c_out):
    """Chunks of whole vertices, each at least one staged tile of rows,
    covering M; fragments enough for the warps; shared memory under
    48 KB."""
    plan = kernels.plan_spiral_conv_dw_bf16(m, b, seq, c_in, c_out)
    assert plan.n_chunks == -(-m // plan.chunk_v)
    assert plan.chunk_v * b >= min(64, m * b) or plan.chunk_v >= m
    assert 4 * plan.fpw >= -(-c_in // 16) * -(-c_out // 8)
    assert plan.smem <= 48 * 1024
    assert plan.n_chunks * seq <= 132 * 8 + seq


# ------------------------------------------------------------- the model
@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    geom_j, bundle_j = _tiny_geometry(np.random.default_rng(11),
                                      return_bundle=True)
    path = str(tmp_path_factory.mktemp("mixed") / "geometry.npz")
    _save_bundle(path, bundle_j)
    geom_t = SpiralGeometry.from_bundle(
        load_bundle(path), device="cpu",
        laplacian=bundle_j.template.laplacian,
        region_masks=np.asarray(geom_j.region_masks))
    cfg = JConfig(out_channels=(8, 16), latent_size=Z)
    params = jax_init(jax.random.PRNGKey(0), cfg, geom_j)
    return dict(geom_j=geom_j, geom_t=geom_t, params=params,
                n=int(geom_j.region_masks.shape[1]),
                regions=int(geom_j.region_masks.shape[0]))


def _models(tiny, policy, final_out_gather=True):
    cfg_j = JConfig(out_channels=(8, 16), latent_size=Z,
                    compute_dtype=policy, final_out_gather=final_out_gather)
    model = SDVAE(SDVAEConfig(out_channels=(8, 16), latent_size=Z,
                              compute_dtype=policy,
                              final_out_gather=final_out_gather),
                  tiny["geom_t"])
    model.load_state_dict(params_from_jax(tiny["params"]))
    return cfg_j, model


@pytest.mark.parametrize("final_out_gather", [True, False])
@pytest.mark.parametrize("policy", ["mixed", "bfloat16"])
def test_model_forward_matches_jax(tiny, policy, final_out_gather):
    """JAX ``forward`` and the port's on the same weights and scans: out
    and mu within 2e-2 of the max, both fp32, and the parameters fp32."""
    cfg_j, model = _models(tiny, policy, final_out_gather)
    x = _rand(np.random.default_rng(12), tiny["n"], 5, 3)
    out_j, _, mu_j, lv_j = jax_forward(tiny["params"], tiny["geom_j"], cfg_j,
                                       jnp.asarray(x))
    with torch.no_grad():
        out_t, _, mu_t, lv_t = model(torch.from_numpy(x))
    assert out_t.dtype == mu_t.dtype == lv_t.dtype == torch.float32
    _close(out_t, out_j, MODEL_RTOL)
    _close(mu_t, mu_j, MODEL_RTOL)
    _close(lv_t, lv_j, MODEL_RTOL)
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_mixed_recon_not_bf16_quantized(tiny):
    """The final conv returns its fp32 accumulator unrounded under
    ``mixed`` (the port's twin of JAX's
    ``test_mixed_recon_not_bf16_quantized``)."""
    _, model = _models(tiny, "mixed")
    x = _rand(np.random.default_rng(13), tiny["n"], 4, 3)
    with torch.no_grad():
        out = model(torch.from_numpy(x))[0].numpy()
    assert (out != _bf16(out)).mean() > 0.5


def test_decode_formulation_switch(tiny):
    """``final_out_gather`` picks the matmul-first or the gather-first
    final conv under ``mixed``; both agree to fp32 summation order and
    with JAX's decode."""
    _, og = _models(tiny, "mixed", True)
    cfg_j, gf = _models(tiny, "mixed", False)
    z = _rand(np.random.default_rng(14), 3, Z)
    with torch.no_grad():
        out_og = og.decode(torch.from_numpy(z))
        out_gf = gf.decode(torch.from_numpy(z))
    assert out_og.dtype == out_gf.dtype == torch.float32
    _close(out_og, out_gf, 1e-4)
    _close(out_gf, jax_decode(tiny["params"], tiny["geom_j"], cfg_j,
                              jnp.asarray(z)), MODEL_RTOL)


def test_from_dict_reads_the_policy_and_final_out_gather():
    cfg = {"in_channels": 3, "out_channels": [8, 16], "latent_size": 6,
           "compute_dtype": "mixed", "final_out_gather": False}
    got = SDVAEConfig.from_dict(cfg, "1e-4")
    want = JConfig.from_dict(cfg, "1e-4")
    for f in dataclasses.fields(want):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.deep_dtype == BF16 and got.activation_dtype == torch.float32
    assert SDVAEConfig.from_dict(
        {**cfg, "compute_dtype": "bfloat16"}, 0).activation_dtype == BF16
    assert SDVAEConfig.from_dict({k: v for k, v in cfg.items()
                                  if k != "final_out_gather"},
                                 0).final_out_gather is True


# -------------------------------------------------------------- training
def _grads_vector(named):
    return np.concatenate([np.asarray(named[k]).ravel()
                           for k in sorted(named)])


@pytest.mark.parametrize("swap", [True, False])
def test_mixed_gradients_match_jax_grad(tiny, swap):
    """loss.backward() under ``mixed`` against ``jax.grad`` of
    ``_compute_losses``: the loss within 1e-2, every leaf fp32, the whole
    gradient's cosine above 0.999."""
    cfg_j, model = _models(tiny, "mixed")
    geom_j = tiny["geom_j"]
    rng = np.random.default_rng(15)
    x_grid = _rand(rng, tiny["n"], B * B if swap else B, 3)
    region, key = 1, jax.random.PRNGKey(4)

    def loss_fn(p):
        return jtrainer._compute_losses(
            p, None, geom_j, cfg_j, JWeights(**WEIGHTS), jnp.asarray(x_grid),
            jnp.int32(region), None, None, B, key, training=True, swap=swap)

    (loss_j, _), grads_j = jax.value_and_grad(loss_fn, has_aux=True)(
        tiny["params"])
    eps = np.array(jax.random.normal(key, (x_grid.shape[1], Z)))
    loss_t, _ = compute_losses(model, LossWeights(**WEIGHTS),
                               torch.from_numpy(x_grid), region, B,
                               eps=torch.from_numpy(eps), swap=swap)
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=LOSS_RTOL)
    want = {k: v.numpy() for k, v in params_from_jax(
        jax.tree.map(np.asarray, grads_j)).items()}
    got = {k: p.grad for k, p in model.named_parameters()}
    assert set(got) == set(want)
    assert all(g.dtype == torch.float32 for g in got.values())
    va = _grads_vector({k: g.numpy() for k, g in got.items()})
    vb = _grads_vector(want)
    cos = float(va @ vb / (np.linalg.norm(va) * np.linalg.norm(vb)))
    assert cos > 0.999, cos


def _injected(tiny, key, rows):
    k_region, k_reparam = jax.random.split(key)
    region = int(jax.random.randint(k_region, (), 0, tiny["regions"]))
    eps = np.array(jax.random.normal(k_reparam, (rows, Z), jnp.float32))
    return region, torch.from_numpy(eps)


def test_mixed_train_step_matches_jax_step(tiny):
    """One ``make_train_step`` step under ``mixed`` against JAX's with the
    region and ε injected: every loss within 1e-2."""
    cfg_j, model = _models(tiny, "mixed")
    opt = jax_adam(1e-3, 0.0)
    jstep = jtrainer.make_train_step(cfg_j, JWeights(**WEIGHTS), opt,
                                     batch_size=B)
    state = jtrainer.create_train_state(
        jax.tree.map(jnp.copy, tiny["params"]), opt)
    tstep = make_train_step(model, LossWeights(**WEIGHTS),
                            coupled_adam(model.parameters(), 1e-3, 0.0), B)
    x = _rand(np.random.default_rng(16), B, tiny["n"], 3)
    key = jax.random.PRNGKey(17)
    _, m_j = jstep(state, tiny["geom_j"], jnp.asarray(x), None, None, key)
    region, eps = _injected(tiny, key, B * B)
    m_t = tstep(torch.from_numpy(x), region_idx=region, eps=eps)
    for k in LOSS_KEYS:
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]),
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=k)


def test_mixed_train_steps_converge(tiny):
    """30 steps under ``mixed`` (Adam at 1e-2, as JAX's
    ``test_train_step_converges``): the loss falls and every parameter
    and Adam moment stays fp32."""
    _, model = _models(tiny, "mixed")
    opt = coupled_adam(model.parameters(), 1e-2, 0.0)
    step = make_train_step(model, LossWeights(**WEIGHTS), opt, B)
    x = torch.from_numpy(_rand(np.random.default_rng(18), B, tiny["n"], 3))
    gen = torch.Generator().manual_seed(2)
    tots = [float(step(x, generator=gen)["tot"]) for _ in range(30)]
    assert np.all(np.isfinite(tots)) and tots[-1] < tots[0]
    for p in model.parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
        st = opt.state[p]
        assert st["exp_avg"].dtype == st["exp_avg_sq"].dtype == torch.float32


# ------------------------------------------- manager, checkpoints, service
@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mixed_mgr"))
    config = make_workspace(root)
    config["model"]["compute_dtype"] = "mixed"
    jm = JManager(config, config["data"]["precomputed_path"])
    tm = ModelManager(config, config["data"]["precomputed_path"],
                      device="cpu")
    train, val, _, norm, weights = tdataset.build_datasets(config,
                                                           tm.template)
    jm.set_class_conversions_and_weights(weights)
    tm.set_class_conversions_and_weights(weights)
    return dict(root=root, config=config, jm=jm, tm=tm, train=train,
                norm=norm)


def test_manager_run_epoch_mixed_tracks_jax(ws):
    """``run_epoch`` under ``mixed`` on the CPU from JAX's weights, with
    JAX's batches and draws: each training loss within 1e-2 of JAX's
    epoch, the parameters fp32."""
    from craniofacialsd_vae_tpu.data import dataset as jdataset
    from craniofacialsd_vae_tpu_torch.models import mlp_from_jax

    jm, tm, config = ws["jm"], ws["tm"], ws["config"]
    assert tm.net_config.compute_dtype == "mixed"
    tm.model.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, jm.state.params)))
    tm.head.load_state_dict(mlp_from_jax(
        jax.tree.map(np.asarray, jm.state.clf_params)))
    tm._step_draws = jax_draws(0, len(tm.template.region_names),
                               config["model"]["latent_size"])
    c2i = jm._class2idx_dict
    want = jm.run_epoch(jdataset.BatchIterator(
        ws["train"], 2, shuffle=True, seed=0, class2idx=c2i), train=True)
    got = tm.run_epoch(tdataset.BatchIterator(
        ws["train"], 2, shuffle=True, seed=0, class2idx=c2i), train=True)
    for k in LOSS_KEYS:
        np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL,
                                   atol=1e-6, err_msg=k)
    assert all(p.dtype == torch.float32 for p in tm.model.parameters())


def test_jax_mixed_checkpoint_gives_the_same_forward(ws):
    """A run dir written by the JAX manager under ``mixed`` resumes in the
    port's: the weights equal bit for bit (fp32 in the JAX layout) and
    the mixed forward agrees within 2e-2."""
    jm = ws["jm"]
    d = os.path.join(ws["root"], "mixed_j2t")
    jm.save_weights(d, 0)
    tm = ModelManager(ws["config"], ws["config"]["data"]["precomputed_path"],
                      device="cpu")
    assert tm.resume(d) == 1
    want = params_from_jax(jax.tree.map(np.asarray, jm.state.params))
    for k, v in tm.model.state_dict().items():
        assert v.dtype == torch.float32 and torch.equal(v, want[k]), k
    x = ws["train"].x[:2]
    _close(tm.forward(x)[0], jm.forward(x)[0], MODEL_RTOL)
    _close(tm.encode(x), jm.encode(x), MODEL_RTOL)


def test_mixed_service_answers_reconstruct(tiny, tmp_path):
    """A ``DiagnosisService`` of the mixed model answers ``reconstruct``
    (bucketed and chunked) within 2e-2 of JAX's mixed forward and within
    JAX's own fp32 tolerance (5e-2) of the fp32 service."""
    geom_j, bundle_j = _tiny_geometry(np.random.default_rng(11),
                                      return_bundle=True)
    path = str(tmp_path / "geometry.npz")
    _save_bundle(path, bundle_j)
    bundle = load_bundle(path)
    n = tiny["n"]
    rng = np.random.default_rng(19)
    norm = {"mean": _rand(rng, n, 3), "std": 1.0 + 0.1 * rng.random(
        (n, 3)).astype(np.float32)}
    sd = params_from_jax(tiny["params"])
    cfg = SDVAEConfig(out_channels=(8, 16), latent_size=Z,
                      compute_dtype="mixed")
    svc = DiagnosisService.from_bundle(bundle, cfg, norm, 10.0, params=sd,
                                       max_batch=4, device="cpu")
    svc32 = DiagnosisService.from_bundle(bundle, dataclasses.replace(
        cfg, compute_dtype="float32"), norm, 10.0, params=sd, max_batch=4,
        device="cpu")
    scans = norm["mean"] + norm["std"] * _rand(rng, 6, n, 3)
    ans, ref = svc.reconstruct(scans), svc32.reconstruct(scans)
    assert ans["vertices"].shape == (6, n, 3) and ans["latent"].shape == (6, Z)
    assert all(np.isfinite(v).all() for v in ans.values())
    cfg_j = JConfig(out_channels=(8, 16), latent_size=Z,
                    compute_dtype="mixed")
    xn = (scans - norm["mean"]) / norm["std"]
    out_j = np.asarray(jax_forward(tiny["params"], geom_j, cfg_j,
                                   jnp.asarray(xn.transpose(1, 0, 2)))[0])
    _close(ans["vertices"], out_j.transpose(1, 0, 2) * norm["std"]
           + norm["mean"], MODEL_RTOL)
    for k in ("vertices", "latent"):
        _close(ans[k], ref[k], 5e-2)

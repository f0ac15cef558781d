"""The serving kernels as ``torch.library`` custom ops
(``craniofacialsd_vae_tpu_torch/ops/library.py``), on the CPU.

Each op's CPU implementation is its kernel's plain twin, so every
comparison with the twin is bit for bit; the spiral conv's is also held
bit-equal to the gathers' form the twin had before it read the table.
The fake implementations give the CPU outputs' shapes and dtypes, and
``torch.library.opcheck`` passes on each op. A ``meta`` tensor raises
(no implementation but CPU and CUDA). The model's gradients, whose
forwards now go through the ops, are held against ``jax.grad`` with
``tests/test_torch_grad.py``'s set-up and tolerance."""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import jax
import jax.numpy as jnp
from craniofacialsd_vae_tpu.training import LossWeights as JWeights
from craniofacialsd_vae_tpu.training.trainer import _compute_losses
from craniofacialsd_vae_tpu_torch import ops
from craniofacialsd_vae_tpu_torch.geometry import extract_spirals, octasphere
from craniofacialsd_vae_tpu_torch.models import (SDVAE, SDVAEConfig,
                                                 params_from_jax)
from craniofacialsd_vae_tpu_torch.ops import library
from craniofacialsd_vae_tpu_torch.training import LossWeights, compute_losses
from tests.test_torch_grad import _close, _rand, tiny  # noqa: F401

OPS = torch.ops.cfsdvae
BF16 = torch.bfloat16


@pytest.fixture(scope="module")
def conv_op():
    """A spiral op on the octasphere of subdivision 2 (66 vertices,
    L = 9), with its vertex tiles."""
    pos, face = octasphere(2)
    return ops.build_spiral_op(extract_spirals(np.asarray(face),
                                               np.asarray(pos), 9))


def _conv_args(op, dtype, batch, c_in, c_out, f32_out, tiled, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(op.n_src, batch, c_in, generator=g).to(dtype)
    w_l = (0.3 * torch.randn(op.seq_length, c_in, c_out,
                             generator=g)).to(dtype)
    b = torch.randn(c_out, generator=g).to(dtype)
    tiles = ops.tile_args(op.tiles if tiled else None)
    return (x, op.table, w_l, b, f32_out, *tiles)


CONV_CASES = [(torch.float32, 4, 3, 8, False), (torch.float32, 1, 8, 3,
                                                 False),
              (BF16, 4, 8, 16, False), (BF16, 2, 8, 3, True)]


@pytest.mark.parametrize("tiled", [True, False], ids=["tiles", "no_tiles"])
@pytest.mark.parametrize("dtype,batch,c_in,c_out,f32_out", CONV_CASES)
def test_spiral_conv_op_equals_its_twin(conv_op, dtype, batch, c_in, c_out,
                                        f32_out, tiled):
    args = _conv_args(conv_op, dtype, batch, c_in, c_out, f32_out, tiled)
    x, _, w_l, b = args[:4]
    out = OPS.spiral_conv_fwd(*args)
    out_dtype = torch.float32 if f32_out else None
    assert torch.equal(out, ops.spiral_conv_plain(w_l, b, x, conv_op,
                                                  out_dtype))
    # the gathers' form (each position through its GatherRows, the
    # identity position x itself), in the same order and roundings
    acc = b.float() if dtype == BF16 else b
    for i, g in enumerate(conv_op.gathers):
        xi = x if g is None else ops.gather_rows(g, x)
        acc = acc + (xi.float() @ w_l[i].float() if dtype == BF16
                     else xi @ w_l[i])
    want = acc if dtype == torch.float32 or f32_out else acc.to(dtype)
    assert out.dtype == want.dtype and torch.equal(out, want)


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("trailing", [(5,), (3, 4)])
def test_ell_matmul_op_equals_its_twin(dtype, trailing):
    rng = np.random.default_rng(3)
    rows = np.repeat(np.arange(20), 3)
    cols = rng.integers(0, 30, size=rows.size)
    mat = ops.from_coo(rows, cols, rng.random(rows.size), (20, 30))
    x = torch.from_numpy(rng.normal(size=(30, *trailing)).astype(
        np.float32)).to(dtype)
    out = OPS.ell_matmul_fwd(mat.cols, mat.vals, x)
    assert out.shape == (20, *trailing) and out.dtype == dtype
    assert torch.equal(out, ops.ell_matmul_plain(mat.cols, mat.vals, x))
    assert torch.equal(ops.ell_matmul_raw(mat.cols, mat.vals, x), out)


@pytest.mark.parametrize("o,batch", [(3, 4), (8, 1)])
def test_out_gather_sum_op_equals_its_twin(conv_op, o, batch):
    g = torch.Generator().manual_seed(5)
    u = torch.randn(conv_op.seq_length, o, conv_op.n_src, batch, generator=g)
    b = torch.randn(o, generator=g)
    out = OPS.out_gather_sum(u, conv_op.table, b)
    assert torch.equal(out, ops.out_gather_sum_plain(u, conv_op.table, b))


def _op_cases(conv_op):
    """(op, args) of each op at one shape."""
    rng = np.random.default_rng(7)
    rows = np.repeat(np.arange(12), 2)
    mat = ops.from_coo(rows, rng.integers(0, 9, rows.size),
                       rng.random(rows.size), (12, 9))
    u = torch.from_numpy(rng.normal(size=(conv_op.seq_length, 3,
                                          conv_op.n_src, 2)).astype(
        np.float32))
    return [
        ("spiral_conv_fwd", _conv_args(conv_op, torch.float32, 2, 4, 8,
                                       False, True)),
        ("spiral_conv_fwd", _conv_args(conv_op, BF16, 2, 8, 3, True, True)),
        ("ell_matmul_fwd", (mat.cols, mat.vals, torch.from_numpy(
            rng.normal(size=(9, 2, 3)).astype(np.float32)))),
        ("out_gather_sum", (u, conv_op.table, torch.zeros(3))),
    ]


def test_fake_implementations_give_the_cpu_shapes_and_dtypes(conv_op):
    for name, args in _op_cases(conv_op):
        real = getattr(OPS, name)(*args)
        with FakeTensorMode() as mode:
            fake_args = [mode.from_tensor(a) if isinstance(a, torch.Tensor)
                         else a for a in args]
            fake = getattr(OPS, name)(*fake_args)
        assert fake.shape == real.shape and fake.dtype == real.dtype, name


def test_opcheck_passes(conv_op):
    for name, args in _op_cases(conv_op):
        result = torch.library.opcheck(getattr(library, name), args)
        assert set(result.values()) == {"SUCCESS"}, (name, result)


def test_meta_tensors_raise(conv_op):
    """Only CPU and CUDA have implementations: a ``meta`` tensor reaches
    neither a twin nor a kernel."""
    for name, args in _op_cases(conv_op):
        meta = [a.to("meta") if isinstance(a, torch.Tensor) else a
                for a in args]
        with pytest.raises(NotImplementedError, match="cpu and cuda"):
            getattr(OPS, name)(*meta)


def test_model_gradients_through_the_ops_match_jax_grad(tiny,  # noqa: F811
                                                        monkeypatch):
    """The forwards call the ops (each CPU implementation counted), and
    ``loss.backward()`` equals ``jax.grad`` of ``_compute_losses`` leaf
    by leaf (``tests/test_torch_grad.py``'s swap case)."""
    calls = {"spiral": 0, "ell": 0}
    conv, ell = library.spiral_conv_table_plain, library.ell_matmul_plain

    def spy_conv(*a, **kw):
        calls["spiral"] += 1
        return conv(*a, **kw)

    def spy_ell(*a, **kw):
        calls["ell"] += 1
        return ell(*a, **kw)

    monkeypatch.setattr(library, "spiral_conv_table_plain", spy_conv)
    monkeypatch.setattr(library, "ell_matmul_plain", spy_ell)
    b, z = 3, 6
    geom_j = tiny["geom_j"]
    n = geom_j.region_masks.shape[1]
    rng = np.random.default_rng(12)
    x_grid = _rand(rng, n, b * b, 3)
    weights = dict(kl=1e-4, laplacian=0.1, latent_consistency=0.5)
    key = jax.random.PRNGKey(4)

    def loss_fn(p):
        return _compute_losses(p, None, geom_j, tiny["cfg_j"],
                               JWeights(**weights), jnp.asarray(x_grid),
                               jnp.int32(1), None, None, b, key,
                               training=True, swap=True)

    (loss_j, _), grads_j = jax.value_and_grad(loss_fn, has_aux=True)(
        tiny["params"])
    eps = np.array(jax.random.normal(key, (x_grid.shape[1], z)))
    model = SDVAE(SDVAEConfig(out_channels=(8, 16), latent_size=z),
                  tiny["geom_t"])
    model.load_state_dict(params_from_jax(tiny["params"]))
    loss_t, _ = compute_losses(model, LossWeights(**weights),
                               torch.from_numpy(x_grid), 1, b,
                               eps=torch.from_numpy(eps), swap=True)
    # 2 encoder convs, 2 decoder convs and the final conv; 2 up-pools and
    # the Laplacian (forward), then the transposes without tiers
    assert calls["spiral"] == 5 and calls["ell"] >= 3
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=1e-5)
    want = params_from_jax(jax.tree.map(np.asarray, grads_j))
    for name, p in model.named_parameters():
        _close(p.grad, want[name].numpy())

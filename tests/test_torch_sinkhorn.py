"""``sinkhorn_divergence``'s plain twin (``ops.distances.
sinkhorn_divergence_plain``, what the host runs and the card's kernels are
held against) against the JAX ``sinkhorn_divergence`` on the same numpy
clouds: its value, and its gradient against ``jax.grad``, the clamp's tie
included (``sinkhorn(x, x)`` is exactly 0 on its diagonal, where JAX's
``maximum`` and ``torch.maximum`` each send half the cotangent).

Tolerances: the value within 1e-5 of itself for clouds 2 apart and
within 1e-4 of the largest cost's coupling for identical clouds, where
the value is a small difference of large terms; gradients within 1e-3
of their max: 50 log-space iterations in fp32 (against a float64 run of
the twin, the twin's gradients are up to 4.6e-4 of their max off and
JAX's up to 1.5e-4 on these clouds)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from craniofacialsd_vae_tpu.ops.distances import \
    sinkhorn_divergence as jax_sinkhorn
from craniofacialsd_vae_tpu_torch import ops
from craniofacialsd_vae_tpu_torch.ops.distances import \
    sinkhorn_divergence_plain

GRAD_RTOL = 1e-3


def _clouds(p, q, shift, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(p, 3)).astype(np.float32)
    y = (rng.normal(size=(q, 3)) + shift).astype(np.float32)
    return x, y


@pytest.mark.parametrize("eps", [0.05, 0.01])
@pytest.mark.parametrize("p,q", [(30, 30), (120, 70)])
def test_value_matches_jax(p, q, eps):
    x, y = _clouds(p, q, 2.0)
    want = float(jax_sinkhorn(jnp.asarray(x), jnp.asarray(y), epsilon=eps))
    got = float(ops.sinkhorn_divergence(torch.from_numpy(x),
                                        torch.from_numpy(y), eps))
    assert abs(got - want) <= 1e-5 * abs(want)


@pytest.mark.parametrize("eps", [0.05, 0.01])
def test_identical_clouds_match_jax(eps):
    x, _ = _clouds(30, 30, 0.0)
    want = float(jax_sinkhorn(jnp.asarray(x), jnp.asarray(x), epsilon=eps))
    got = float(ops.sinkhorn_divergence(torch.from_numpy(x),
                                        torch.from_numpy(x), eps))
    cost = ((x[:, None] - x[None]) ** 2).sum(-1)
    assert abs(got - want) <= 1e-4 * float(cost.max()) / len(x)


def test_jax_test_cases():
    """tests/test_distances.py::TestSinkhorn on the port."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(30, 3)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(30, 3)).astype(np.float32) + 2.0)
    assert float(ops.sinkhorn_divergence(x, x, epsilon=0.01)) < 0.05
    assert float(ops.sinkhorn_divergence(x, y, epsilon=0.01)) > 1.0


def _grads(x, y, eps, n_iters=50):
    gj = jax.grad(lambda a, b: jax_sinkhorn(a, b, epsilon=eps,
                                            n_iters=n_iters),
                  argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    xt = torch.from_numpy(x).requires_grad_()
    yt = torch.from_numpy(y).requires_grad_()
    sinkhorn_divergence_plain(xt, yt, eps, n_iters).backward()
    return (xt.grad, yt.grad), gj


@pytest.mark.parametrize("eps", [0.05, 0.01])
@pytest.mark.parametrize("shift", [2.0, 0.3])
def test_gradient_matches_jax_grad(shift, eps):
    x, y = _clouds(40, 25, shift)
    got, want = _grads(x, y, eps)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert float(np.abs(g.numpy() - w).max()) <= \
            GRAD_RTOL * float(np.abs(w).max())


def test_gradient_at_the_clamp_tie_matches_jax_grad():
    """sinkhorn(x, x): the diagonal's raw cost is exactly 0 in both
    packages (|x|² + |x|² − 2·x·x on integer-valued points), so the
    clamp ties there; JAX splits the cotangent, and so does the twin."""
    rng = np.random.default_rng(9)
    x = rng.integers(-2, 3, size=(24, 3)).astype(np.float32)
    xx = (x * x).sum(-1)
    assert np.all(xx + xx - 2.0 * (x * x).sum(-1) == 0.0)
    got, want = _grads(x, x.copy(), 0.05, n_iters=10)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert float(np.abs(g.numpy() - w).max()) <= \
            GRAD_RTOL * max(float(np.abs(w).max()), 1e-6)
    # the tie's half, in both packages' maximum
    half_j = jax.grad(lambda r: jnp.maximum(r, 0.0).sum())(jnp.zeros(3))
    raw = torch.zeros(3, requires_grad=True)
    torch.maximum(raw, torch.zeros(3)).sum().backward()
    assert np.all(np.asarray(half_j) == 0.5) and bool((raw.grad == 0.5).all())


def test_runs_on_the_inputs_device_and_rejects_bad_shapes():
    x, y = _clouds(10, 12, 1.0)
    out = ops.sinkhorn_divergence(torch.from_numpy(x), torch.from_numpy(y))
    assert out.device.type == "cpu" and out.dim() == 0
    with pytest.raises(ValueError):
        ops.sinkhorn_divergence(torch.zeros(4, 2), torch.zeros(4, 3))

"""The port's SD-VAE (plain versions, CPU) against the JAX model: the
fp32 golden forward and encode/decode on the same weights and inputs.

Weights come from the JAX init through ``params_from_jax``. Tolerance:
rtol 1e-5, atol 1e-6 (fp32 matmuls summed in another order by XLA and by
PyTorch on the CPU)."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from craniofacialsd_vae_tpu.geometry.precompute import _save_bundle
from craniofacialsd_vae_tpu.models import SDVAEConfig as JConfig
from craniofacialsd_vae_tpu.models import decode as jax_decode
from craniofacialsd_vae_tpu.models import encode as jax_encode
from craniofacialsd_vae_tpu.models import init_sdvae as jax_init
from craniofacialsd_vae_tpu_torch.geometry import load_bundle
from craniofacialsd_vae_tpu_torch.models import (SDVAE, SDVAEConfig,
                                                 SpiralGeometry, init_sdvae,
                                                 params_from_jax,
                                                 reparameterize)
from tests.test_training import _tiny_geometry

TOL = dict(rtol=1e-5, atol=1e-6)
GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures",
                      "fp32_forward_golden.npz")


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The golden fixture's geometry (rng 11) for both packages, and the
    JAX init at PRNGKey(0) carried across."""
    geom_j, bundle_j = _tiny_geometry(np.random.default_rng(11),
                                      return_bundle=True)
    path = str(tmp_path_factory.mktemp("tiny") / "geometry.npz")
    _save_bundle(path, bundle_j)
    bundle_t = load_bundle(path)
    cfg_j = JConfig(out_channels=(8, 16), latent_size=6)
    params_j = jax_init(jax.random.PRNGKey(0), cfg_j, geom_j)
    geom_t = SpiralGeometry.from_bundle(bundle_t, device="cpu")
    model = SDVAE(SDVAEConfig(out_channels=(8, 16), latent_size=6), geom_t)
    model.load_state_dict(params_from_jax(params_j))
    return dict(geom_j=geom_j, cfg_j=cfg_j, params_j=params_j,
                bundle_t=bundle_t, model=model.eval(), path=path)


def test_param_layout_matches_jax(tiny):
    sd = tiny["model"].state_dict()
    pj = tiny["params_j"]
    assert sd["en_convs.0.w"].shape == pj["en_convs"][0]["w"].shape
    assert sd["mu.w"].shape == pj["mu"]["w"].shape
    assert sd["final_conv.w"].shape == pj["final_conv"]["w"].shape
    assert set(sd) == set(params_from_jax(pj))


def test_forward_reproduces_fp32_golden(tiny):
    golden = np.load(GOLDEN)
    with torch.no_grad():
        out, z, mu, logvar = tiny["model"](torch.from_numpy(golden["x"]))
    np.testing.assert_allclose(out.numpy(), golden["out"], **TOL)
    np.testing.assert_allclose(mu.numpy(), golden["mu"], **TOL)
    np.testing.assert_allclose(logvar.numpy(), golden["logvar"], **TOL)
    np.testing.assert_array_equal(z.numpy(), mu.numpy())


def test_encode_decode_match_jax(tiny):
    rng = np.random.default_rng(3)
    n = tiny["geom_j"].spirals[0].num_vertices
    x = rng.normal(size=(n, 5, 3)).astype(np.float32)
    mu_j, lv_j = jax_encode(tiny["params_j"], tiny["geom_j"], tiny["cfg_j"],
                            jnp.asarray(x))
    with torch.no_grad():
        mu_t, lv_t = tiny["model"].encode(torch.from_numpy(x))
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), **TOL)
    np.testing.assert_allclose(lv_t.numpy(), np.asarray(lv_j), **TOL)

    z = rng.normal(size=(4, 6)).astype(np.float32)
    out_j = jax_decode(tiny["params_j"], tiny["geom_j"], tiny["cfg_j"],
                       jnp.asarray(z))
    with torch.no_grad():
        out_t = tiny["model"].decode(torch.from_numpy(z))
    assert out_t.shape == (n, 4, 3)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)


def test_seeded_init_is_reproducible_and_xavier(tiny):
    geom = SpiralGeometry.from_bundle(tiny["bundle_t"], device="cpu")
    cfg = SDVAEConfig(out_channels=(8, 16), latent_size=6)
    a = init_sdvae(cfg, geom, torch.Generator().manual_seed(5)).state_dict()
    b = init_sdvae(cfg, geom, torch.Generator().manual_seed(5)).state_dict()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    w = a["en_convs.0.w"]                       # [L·3, 8]
    limit = float(np.sqrt(6.0 / (w.shape[0] + w.shape[1])))
    assert float(w.abs().max()) <= limit and float(w.std()) > limit / 4
    assert float(a["en_convs.0.b"].abs().max()) == 0.0


def test_reparameterize_uses_generator():
    mu = torch.zeros(3, 4)
    logvar = torch.zeros(3, 4)
    a = reparameterize(mu, logvar, torch.Generator().manual_seed(1))
    b = reparameterize(mu, logvar, torch.Generator().manual_seed(1))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert float(a.abs().sum()) > 0


def test_only_fp32_policy_is_ported(tiny):
    """Only the JAX package's policies (float32, mixed, bfloat16) are
    ported: an unknown one raises."""
    geom = SpiralGeometry.from_bundle(tiny["bundle_t"], device="cpu")
    with pytest.raises(ValueError):
        SDVAE(SDVAEConfig(out_channels=(8, 16), latent_size=6,
                          compute_dtype="float16"), geom)


def test_geometry_defaults_to_the_card(tiny, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        SpiralGeometry.from_bundle(tiny["bundle_t"])

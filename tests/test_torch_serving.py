"""The port's raw-scan programs and DiagnosisService (plain versions,
CPU) against the JAX ``build_raw_programs`` on the same weights, plus the
service's bucketing, padding and input validation.

Tolerances: recon and latents rtol 1e-5 (atol 1e-6), per-vertex error
atol 1e-4 mm — fp32 matmuls summed in another order by XLA and PyTorch."""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from craniofacialsd_vae_tpu.geometry.precompute import _save_bundle
from craniofacialsd_vae_tpu.models import SDVAEConfig as JConfig
from craniofacialsd_vae_tpu.models import init_sdvae as jax_init
from craniofacialsd_vae_tpu.serving import \
    build_raw_programs as jax_build_raw_programs
from craniofacialsd_vae_tpu_torch.geometry import load_bundle
from craniofacialsd_vae_tpu_torch.models import SDVAEConfig, params_from_jax
from craniofacialsd_vae_tpu_torch.serving import (DiagnosisService,
                                                  load_normalization,
                                                  run_normalization)
from tests.test_training import _tiny_geometry

TO_MM = 10.0
MAX_BATCH = 4


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    geom_j, bundle_j = _tiny_geometry(np.random.default_rng(11),
                                      return_bundle=True)
    root = tmp_path_factory.mktemp("serve")
    _save_bundle(str(root / "geometry.npz"), bundle_j)
    bundle_t = load_bundle(str(root / "geometry.npz"))
    cfg_j = JConfig(out_channels=(8, 16), latent_size=6)
    params_j = jax_init(jax.random.PRNGKey(0), cfg_j, geom_j)
    n = geom_j.spirals[0].num_vertices
    rng = np.random.default_rng(21)
    mean = rng.normal(size=(n, 3)).astype(np.float32)
    std = (0.5 + rng.random((n, 3))).astype(np.float32)
    np.savez(str(root / "norm.npz"), mean=mean, std=std)
    norm = {"mean": mean, "std": std}
    manager = types.SimpleNamespace(geometry=geom_j, net_config=cfg_j,
                                    to_mm_const=TO_MM)
    svc = DiagnosisService.from_bundle(
        bundle_t, SDVAEConfig(out_channels=(8, 16), latent_size=6), norm,
        TO_MM, params=params_from_jax(params_j), max_batch=MAX_BATCH,
        device="cpu")
    return dict(n=n, norm=norm, params_j=params_j, root=root,
                programs_j=jax_build_raw_programs(manager, norm),
                bundle_t=bundle_t, svc=svc, rng=rng)


def _scans(setup, b):
    rng = np.random.default_rng(100 + b)
    return (setup["norm"]["mean"] + rng.normal(
        size=(b, setup["n"], 3)) * setup["norm"]["std"]).astype(np.float32)


@pytest.mark.parametrize("b", [1, 3, MAX_BATCH + 1])
def test_reconstruct_matches_jax(setup, b):
    x = _scans(setup, b)
    recon_j, err_j, mu_j = setup["programs_j"]["reconstruct"](
        setup["params_j"], jnp.asarray(x))
    out = setup["svc"].reconstruct(x)
    assert out["vertices"].shape == (b, setup["n"], 3)
    assert out["vertex_errors_mm"].shape == (b, setup["n"])
    np.testing.assert_allclose(out["vertices"], np.asarray(recon_j),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out["vertex_errors_mm"], np.asarray(err_j),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(out["latent"], np.asarray(mu_j),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out["mean_error_mm"],
                               np.asarray(err_j).mean(axis=1), atol=1e-4)


def test_encode_decode_match_jax(setup):
    x = _scans(setup, 3)
    mu_j = setup["programs_j"]["encode"](setup["params_j"], jnp.asarray(x))
    mu = setup["svc"].encode(x)
    np.testing.assert_allclose(mu, np.asarray(mu_j), rtol=1e-5, atol=1e-6)
    z = np.random.default_rng(5).normal(size=(3, 6)).astype(np.float32)
    out_j = setup["programs_j"]["decode"](setup["params_j"], jnp.asarray(z))
    out = setup["svc"].decode(z)
    np.testing.assert_allclose(out, np.asarray(out_j), rtol=1e-5, atol=1e-6)
    # unbatched inputs come back unbatched
    assert setup["svc"].encode(x[0]).shape == (6,)
    assert setup["svc"].decode(z[0]).shape == (setup["n"], 3)


@pytest.mark.parametrize("b,calls", [(1, [1]), (3, [4]),
                                     (MAX_BATCH + 1, [4, 1])])
def test_buckets_pad_with_first_mesh_and_chunk(setup, b, calls):
    svc = setup["svc"]
    assert svc.buckets == [1, 2, 4]
    seen = []

    def fn(x):
        seen.append(x.clone())
        return x * 2.0

    x = _scans(setup, b)
    out = svc._run_bucketed(fn, x)
    assert [s.shape[0] for s in seen] == calls
    np.testing.assert_array_equal(out, 2.0 * x)
    for s, lo in zip(seen, range(0, b, MAX_BATCH)):
        n = min(MAX_BATCH, b - lo)
        for extra in s[n:]:            # padding repeats the chunk's first
            torch.testing.assert_close(extra, s[0], rtol=0, atol=0)


def test_padding_does_not_change_results(setup):
    x = _scans(setup, 3)
    whole = setup["svc"].reconstruct(x)
    for i in range(3):
        one = setup["svc"].reconstruct(x[i])
        np.testing.assert_allclose(one["vertices"], whole["vertices"][i],
                                   rtol=1e-5, atol=1e-6)


def test_rejects_bad_input(setup):
    svc = setup["svc"]
    with pytest.raises(ValueError):
        svc.reconstruct(np.zeros((2, setup["n"] + 1, 3), np.float32))
    with pytest.raises(ValueError):
        svc.reconstruct(np.zeros((0, setup["n"], 3), np.float32))
    with pytest.raises(ValueError):
        svc.decode(np.zeros((2, 7), np.float32))


def test_counters(setup):
    svc = setup["svc"]
    before = svc.stats()
    svc.encode(_scans(setup, 3))
    after = svc.stats()
    assert after["requests"] == before["requests"] + 1
    assert after["meshes"] == before["meshes"] + 3
    assert after["p50_ms"] is not None and after["device"] == "cpu"


def test_normalization_readers(setup):
    norm = load_normalization(str(setup["root"]))
    np.testing.assert_array_equal(norm["mean"], setup["norm"]["mean"])
    cfg = {"data": {"precomputed_path": str(setup["root"])}}
    assert run_normalization(cfg)["std"].shape == (setup["n"], 3)
    cfg["data"]["normalize_data"] = False
    assert run_normalization(cfg) is None
    with pytest.raises(FileNotFoundError):
        load_normalization(str(setup["root"] / "missing"))


def test_service_defaults_to_the_card(setup, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        DiagnosisService.from_bundle(
            setup["bundle_t"],
            SDVAEConfig(out_channels=(8, 16), latent_size=6),
            setup["norm"], TO_MM)

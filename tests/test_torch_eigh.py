"""The port's Laplacian eigensolver (``ops/eigh.py``) against the JAX
package's and scipy's: K9's plain twin against JAX's ELL matvec composed
with the same scalars, the Chebyshev solver and the dense solve (eigenvalues
rtol 1e-4, subspace overlap within 1e-4, at a k that falls in a gap of
the octasphere's spectrum), ``auto``'s switch and its residual fallback,
the basis cache read and written across both packages, the spectral
products, and the source's and modules' isolation rules."""

import glob
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from craniofacialsd_vae_tpu.geometry.synthetic import \
    synthetic_template as jsynthetic
from craniofacialsd_vae_tpu.ops import eigh as jeigh
from craniofacialsd_vae_tpu.ops import sparse as jsparse
from craniofacialsd_vae_tpu_torch.geometry import synthetic_template
from craniofacialsd_vae_tpu_torch.ops import eigh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EIG_RTOL = 1e-4       # eigenvalues against scipy's f64 and JAX's
OVERLAP_ATOL = 1e-4   # O Oᵀ against I for two orthonormal bases
STEP_RTOL = 1e-6      # K9's twin against JAX, of max |out|: fp32 sums of
#                       the same products in another order (einsum)
# the largest k ≤ 32 with λ_{k+1} − λ_k > 1e-3 λ_k (octasphere multiplets)
GAP_K = {4: 31, 6: 31}


def _templates(subdivisions):
    return synthetic_template(subdivisions, 3), jsynthetic(subdivisions, 3)


def _scipy_sorted(tpl, k):
    vals, vecs = eigh._scipy_eigsh(tpl, k)
    order = np.argsort(vals)
    return vals[order], vecs[:, order]


def _same_subspace(a, b):
    ov = np.asarray(a, np.float64).T @ np.asarray(b, np.float64)
    np.testing.assert_allclose(ov @ ov.T, np.eye(ov.shape[0]),
                               atol=OVERLAP_ATOL)


# ------------------------------------------------------------------ K9
@pytest.mark.parametrize("subdivisions", [2, 3])
@pytest.mark.parametrize("form", ["first", "body", "b0", "columns"])
def test_cheby_step_twin_matches_jax_matvec(subdivisions, form):
    """The twin equals JAX's ``_laplacian_matvec`` (``from_coo`` +
    ``ell_matmul_raw``) composed with the same a, c, b: the first filter
    step, the filter body, ``w = L q`` and the per-column residual."""
    tpl, jtpl = _templates(subdivisions)
    lap = eigh._EllLaplacian(tpl, torch.device("cpu"))
    lap_mv, shift = jeigh._laplacian_matvec(jtpl)
    assert lap.ub == shift
    n, d = tpl.num_vertices, 19
    rng = np.random.default_rng(subdivisions)
    x = rng.standard_normal((n, d), dtype=np.float32)
    p = rng.standard_normal((n, d), dtype=np.float32)
    cs = (rng.uniform(0, shift, d)).astype(np.float32)
    a, b, c = {"first": (-0.21, 0.0, cs[:1].repeat(d)),
               "body": (-0.43, 0.98, cs[:1].repeat(d)),
               "b0": (1.0, 0.0, np.zeros(d, np.float32)),
               "columns": (1.0, 0.0, cs)}[form]
    a, b = np.float32(a), np.float32(b)
    want = a * (lap_mv(jnp.asarray(x)) - jnp.asarray(c)[None] * x)
    if b:
        want = want - b * p
    got = eigh.cheby_step(lap.cols, lap.vals, torch.from_numpy(x),
                          torch.from_numpy(c), float(a), float(b),
                          torch.from_numpy(p))
    want = np.asarray(want)
    assert float(np.abs(got.numpy() - want).max()) \
        <= STEP_RTOL * float(np.abs(want).max())


def test_ell_laplacian_is_jax_from_coo():
    """The ELL table K9 walks is JAX's, entry for entry (padding
    included)."""
    tpl, jtpl = _templates(3)
    lap = eigh._EllLaplacian(tpl, torch.device("cpu"))
    n = tpl.num_vertices
    rows, cols, vals, _ = eigh._laplacian_coo(tpl, np.float32)
    jmat = jsparse.from_coo(rows, cols, vals, (n, n), with_transpose=False)
    np.testing.assert_array_equal(lap.cols.numpy(), np.asarray(jmat.cols))
    np.testing.assert_array_equal(lap.vals.numpy(), np.asarray(jmat.vals))


@pytest.mark.parametrize("ub,lb,degree,want", [
    (13.0, 1.4, 80, [40, 40]),        # the octasphere at k = 1000
    (61.0, 1.4, 80, [80]),            # a loose bound: one segment
    (13.0, 6.5, 80, [16] * 5),        # a first pass on a small mesh
    (13.0, 1.4, 7, [7]),
])
def test_filter_segments(ub, lb, degree, want):
    """Segments sum to the degree, each within FILTER_GROWTH at λ = 0."""
    segs = eigh.filter_segments(ub, lb, degree)
    assert sum(segs) == degree and max(segs) - min(segs) <= 1
    t0 = (ub + lb) / (ub - lb)
    assert max(segs) * np.arccosh(t0) <= np.log(eigh.FILTER_GROWTH) \
        or max(segs) == 1
    assert segs == want


# ------------------------------------------------------- the Chebyshev solver
@pytest.mark.parametrize("subdivisions,k", [(2, 6), (4, GAP_K[4])])
def test_chebyshev_smallest_matches_jax_and_scipy(subdivisions, k,
                                                  monkeypatch):
    """JAX's ``test_cheby_matches_scipy_small`` (subdivision 2, k = 6) and
    the octasphere of subdivision 4 at k = 31: eigenvalues within rtol
    1e-4 of scipy's and JAX's, the same subspace; the twin of K9 runs
    passes × (degree + 2) times."""
    tpl, jtpl = _templates(subdivisions)
    calls = []
    plain = eigh.cheby_step_plain

    def counted(*args):
        calls.append(1)
        return plain(*args)

    monkeypatch.setattr(eigh, "cheby_step_plain", counted)
    vals, vecs, info = eigh._chebyshev_smallest(tpl, k, device="cpu")
    assert {"passes", "block", "degree", "seconds", "max_residual",
            "device", "filter_s", "qr_s", "eigh_s",
            "polish_s"} <= set(info)
    assert info["device"] == "cpu" and info["degree"] == 80
    assert info["block"] == min(k + max(8, k // 8),
                                tpl.num_vertices // 2)
    assert len(calls) == info["passes"] * (info["degree"] + 2)
    assert info["max_residual"] < 1e-3
    s_vals, s_vecs = _scipy_sorted(tpl, k)
    j_vals, j_vecs, j_info = jeigh._chebyshev_smallest(jtpl, k)
    assert j_info["block"] == info["block"]
    for ref in (s_vals, j_vals):
        np.testing.assert_allclose(vals, ref, rtol=EIG_RTOL, atol=1e-8)
    _same_subspace(vecs, s_vecs)
    _same_subspace(vecs, j_vecs)


@pytest.mark.parametrize("subdivisions", [4, 6])
def test_gap_k_is_the_largest_k_in_a_spectral_gap(subdivisions):
    """GAP_K (and chip_smoke's CHEBY_GAP_K) is the largest k ≤ 32 whose
    next eigenvalue is apart by more than 1e-3 of it, from ARPACK."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    vals, _ = _scipy_sorted(synthetic_template(subdivisions, 3), 40)
    gaps = [k for k in range(1, 33)
            if vals[k] - vals[k - 1] > 1e-3 * vals[k - 1]]
    assert gaps[-1] == GAP_K[subdivisions]
    assert chip_smoke.CHEBY_GAP_K == GAP_K[6]


def test_chebyshev_solver_of_a_degenerate_window_stays_in_fp32_reach():
    """Subdivision 4 at k = 64 (the octasphere's window of k = 1000 at
    subdivision 6, scaled by the vertex count): JAX's single degree-80
    filter stalls above the acceptance residual; the segmented filter
    converges."""
    tpl, jtpl = _templates(4)
    vals, _, info = eigh._chebyshev_smallest(tpl, 64, device="cpu")
    assert info["max_residual"] < 1e-4
    assert info["passes"] < 12
    _, _, j_info = jeigh._chebyshev_smallest(jtpl, 64)
    assert j_info["max_residual"] > eigh.ACCEPT_RESIDUAL
    s_vals, _ = _scipy_sorted(tpl, 64)
    np.testing.assert_allclose(vals, s_vals, rtol=EIG_RTOL, atol=1e-8)


# ------------------------------------------------ laplacian_eigendecomposition
def test_dense_matches_jax_dense():
    """JAX's dense backend (``tpu``) in both packages: eigenvalues within
    rtol 1e-4 at k = 5 (JAX's ``test_dense_matches_scipy_small``), the
    same subspace at k = 6 (a gap), and L v = λ v."""
    tpl, jtpl = _templates(2)
    vals, vecs = eigh.laplacian_eigendecomposition(tpl, 6, backend="tpu",
                                                   device="cpu")
    j_vals, j_vecs = jeigh.laplacian_eigendecomposition(jtpl, 6,
                                                        backend="tpu")
    assert vals.dtype == np.float32 and vecs.shape == (66, 6)
    np.testing.assert_allclose(vals[:5], j_vals[:5], rtol=EIG_RTOL,
                               atol=1e-4)
    _same_subspace(vecs, j_vecs)
    lap = eigh.unnormalized_laplacian_dense(tpl.num_vertices, tpl.edges)
    np.testing.assert_array_equal(
        lap, jeigh.unnormalized_laplacian_dense(jtpl.num_vertices,
                                                jtpl.edges))
    assert np.abs(lap @ vecs - vecs * vals[None]).max() < 1e-3
    assert eigh.solves.last["solver"] == "dense"


def test_auto_switches_at_8192_vertices(monkeypatch):
    """``auto`` takes the dense solve up to DENSE_MAX_VERTICES (8,192, as
    JAX) and the Chebyshev solver above."""
    assert eigh.DENSE_MAX_VERTICES == 8192
    with open(jeigh.__file__) as f:
        assert "n > 8192" in f.read()
    tpl = synthetic_template(2, 3)
    for cut, solver in ((66, "dense"), (65, "cheby")):
        monkeypatch.setattr(eigh, "DENSE_MAX_VERTICES", cut)
        eigh.solves.reset()
        eigh.laplacian_eigendecomposition(tpl, 6, device="cpu")
        assert eigh.solves.last["solver"] == solver


def test_auto_residual_fallback_prints_and_records_scipy(monkeypatch,
                                                         capsys):
    """A Chebyshev basis above the acceptance residual is replaced by
    ARPACK's, as in JAX; the port says so and records it."""
    tpl = synthetic_template(2, 3)
    monkeypatch.setattr(eigh, "DENSE_MAX_VERTICES", 10)
    monkeypatch.setattr(eigh, "ACCEPT_RESIDUAL", 1e-30)
    vals, vecs = eigh.laplacian_eigendecomposition(tpl, 6, device="cpu")
    out = capsys.readouterr().out
    assert "scipy ARPACK" in out and "Chebyshev subspace on cpu" in out
    last = eigh.solves.last
    assert last["solver"] == "scipy" and last["rejected"]["passes"] >= 1
    s_vals, s_vecs = _scipy_sorted(tpl, 6)    # ARPACK starts at random
    np.testing.assert_allclose(np.sort(vals), s_vals, rtol=1e-10,
                               atol=1e-12)
    _same_subspace(vecs, s_vecs)


def test_kernel_failures_are_not_caught(monkeypatch):
    """Nothing falls back where a solve on the device raises."""
    tpl = synthetic_template(2, 3)
    monkeypatch.setattr(eigh, "DENSE_MAX_VERTICES", 10)

    def broken(*args):
        raise RuntimeError("cheby_step: CUDA error 700 at launch")

    monkeypatch.setattr(eigh, "cheby_step_plain", broken)
    with pytest.raises(RuntimeError, match="700"):
        eigh.laplacian_eigendecomposition(tpl, 6, device="cpu")


def test_basis_cache_crosses_both_packages(tmp_path):
    """Either package reads the other's cached basis: the same file name,
    keys and k' ≥ k slicing; a smaller cached k is solved again."""
    tpl, jtpl = _templates(2)
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    vals, vecs = eigh.laplacian_eigendecomposition(
        tpl, 10, backend="tpu", cache_dir=port_dir, device="cpu")
    (written,) = glob.glob(os.path.join(port_dir, "*.npz"))
    j_vals, j_vecs = jeigh.laplacian_eigendecomposition(
        jtpl, 7, backend="tpu", cache_dir=port_dir)
    assert glob.glob(os.path.join(port_dir, "*.npz")) == [written]
    np.testing.assert_array_equal(j_vals, vals[:7])
    np.testing.assert_array_equal(j_vecs, vecs[:, :7])

    jeigh.laplacian_eigendecomposition(jtpl, 9, backend="scipy",
                                       cache_dir=jax_dir)
    (j_written,) = glob.glob(os.path.join(jax_dir, "*.npz"))
    assert os.path.basename(j_written) == \
        eigh._cache_stem(tpl, "scipy") + "_k9.npz"
    assert os.path.basename(written) == \
        eigh._cache_stem(tpl, "tpu") + "_k10.npz"
    got = eigh.laplacian_eigendecomposition(tpl, 4, backend="scipy",
                                            cache_dir=jax_dir)
    assert eigh.solves.last["solver"] == "cache"
    with np.load(j_written) as z:
        assert set(z.files) == {"vals", "vecs"}
        np.testing.assert_array_equal(got[0], z["vals"][:4])
        np.testing.assert_array_equal(got[1], z["vecs"][:, :4])
    eigh.laplacian_eigendecomposition(tpl, 12, backend="scipy",
                                      cache_dir=jax_dir)
    assert eigh.solves.last["solver"] == "scipy"
    assert len(glob.glob(os.path.join(jax_dir, "*.npz"))) == 2


def test_spectral_products_match_jax():
    rng = np.random.default_rng(5)
    u = rng.standard_normal((40, 7)).astype(np.float32)
    x = rng.standard_normal((3, 40, 3)).astype(np.float32)
    s_new = rng.standard_normal((3, 7, 3)).astype(np.float32)
    s = eigh.spectral_project(torch.from_numpy(u), torch.from_numpy(x))
    np.testing.assert_allclose(
        s.numpy(), np.asarray(jeigh.spectral_project(u, x)), rtol=1e-5,
        atol=1e-5)
    r = eigh.spectral_reconstruct(torch.from_numpy(u), torch.from_numpy(x),
                                  s, torch.from_numpy(s_new))
    np.testing.assert_allclose(
        r.numpy(),
        np.asarray(jeigh.spectral_reconstruct(u, x, np.asarray(s), s_new)),
        rtol=1e-5, atol=1e-5)


def test_full_fp32_restores_the_process_setting():
    before = torch.backends.cuda.matmul.allow_tf32
    try:
        for setting in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = setting
            with eigh.full_fp32():
                assert torch.backends.cuda.matmul.allow_tf32 is False
            assert torch.backends.cuda.matmul.allow_tf32 is setting
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


# ------------------------------------------------------------- isolation
def test_cheby_step_source_exports_its_entry_point():
    from craniofacialsd_vae_tpu_torch import kernels

    assert "cheby_step.cu" in kernels.SOURCES
    assert "cheby_step" in kernels.KERNEL_NAMES
    with open(os.path.join(REPO, "craniofacialsd_vae_tpu_torch", "csrc",
                           "cheby_step.cu")) as f:
        src = f.read()
    assert 'extern "C" int cfs_cheby_step(' in src
    assert "craniofacialsd_vae_tpu/ops/eigh.py" in src and "Replaces" in src


@pytest.mark.parametrize("module", ["ops.eigh", "data.augmentation"])
def test_new_modules_import_with_jax_blocked(module):
    blocked = ("jax", "jaxlib", "flax", "optax", "craniofacialsd_vae_tpu",
               "yaml", "msgpack", "matplotlib", "sklearn", "pandas")
    code = (f"import sys; sys.modules.update(dict.fromkeys({blocked!r})); "
            f"import craniofacialsd_vae_tpu_torch.{module}")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr

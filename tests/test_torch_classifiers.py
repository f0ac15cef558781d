"""The port's classifier zoo (``analysis/classifiers.py``) against the JAX
package's on the same seeded latents: each head, the per-region LDA/QDA,
``classifiers.npz`` written by either package and read by the other, and
the reference's sklearn pickles both ways.

Tolerances: LDA and QDA are the same numpy code in both packages, so
their arrays agree to 1e-12. The SVM (500 full-batch Adam steps from
zeros) and the MLP (coupled Adam, JAX's initial weights carried across)
fit with ``torch.optim.Adam`` against optax's ``adam``: equal in math,
rounded differently, so their parameters agree within 1e-4 of each
array's largest entry, and their predictions exactly."""

import os

import numpy as np
import pytest
import torch

from craniofacialsd_vae_tpu.analysis import classifiers as jc
from craniofacialsd_vae_tpu_torch.analysis import classifiers as tc

FIT_RTOL = 1e-4


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


@pytest.fixture(scope="module")
def blobs():
    rng = np.random.default_rng(3)
    means = np.array([[0, 0, 0, 0, 0, 0], [3, 0, 0, 0, 1, 0],
                      [0, 3, 0, 2, 0, 0], [2, 2, 3, 0, 0, 1]], np.float64)
    xs, ys = [], []
    for c, m in enumerate(means):
        cov = np.eye(6) + 0.3 * rng.random((6, 6))
        xs.append(rng.multivariate_normal(m, cov @ cov.T, size=30))
        ys.append(np.full(30, c))
    x = np.concatenate(xs).astype(np.float32)
    y = np.concatenate(ys)
    order = rng.permutation(len(y))
    x, y = x[order], y[order]
    return x[:90], y[:90], x[90:], y[90:]


@pytest.fixture(scope="module")
def few():
    """Fewer samples per class than dimensions: QDA's Ledoit-Wolf
    auto-shrinkage and LDA's rank truncation engage."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(18, 12)).astype(np.float32)
    y = np.repeat(np.arange(3), 6)
    x[y == 1] += 1.5
    return x, y


class Recorder:
    def __init__(self):
        self.rows = []

    def add_scalar(self, tag, value, step):
        self.rows.append((tag, float(value), int(step)))


@pytest.mark.parametrize("which", ["blobs", "few"])
def test_qda_matches_jax(which, blobs, few):
    x, y = (blobs[0], blobs[1]) if which == "blobs" else few
    mine, ref = tc.QDAClassifier().fit(x, y), jc.QDAClassifier().fit(x, y)
    for k in ("means", "covs", "priors", "classes"):
        np.testing.assert_allclose(getattr(mine, k), getattr(ref, k),
                                   rtol=1e-12, atol=1e-12)
    assert (mine.auto_shrinkage_ is None) == (which == "blobs")
    if which == "few":
        np.testing.assert_allclose(mine.auto_shrinkage_,
                                   ref.auto_shrinkage_, rtol=1e-12)
    np.testing.assert_allclose(mine.log_posteriors(x),
                               ref.log_posteriors(x), rtol=1e-10)
    np.testing.assert_array_equal(mine.predict(x), ref.predict(x))
    assert mine.mahalanobis(x[0], 1) == pytest.approx(
        ref.mahalanobis(x[0], 1), rel=1e-12)
    np.testing.assert_allclose(mine.sample(2, 5, seed=4),
                               ref.sample(2, 5, seed=4), rtol=1e-12)
    with pytest.raises(ValueError, match="fitted classes"):
        mine.mahalanobis(x[0], 7)


@pytest.mark.parametrize("which", ["blobs", "few"])
def test_lda_matches_jax(which, blobs, few):
    x, y = (blobs[0], blobs[1]) if which == "blobs" else few
    mine, ref = tc.LDAClassifier().fit(x, y), jc.LDAClassifier().fit(x, y)
    for k in ("means", "cov", "priors", "scalings", "xbar", "coef",
              "intercept"):
        np.testing.assert_allclose(getattr(mine, k), getattr(ref, k),
                                   rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(mine.transform(x), ref.transform(x),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_array_equal(mine.predict(x), ref.predict(x))


def test_svm_matches_jax(blobs):
    """From zeros, 500 full-batch Adam steps in both packages."""
    x, y, xv, _ = blobs
    mine, ref = tc.LinearSVM().fit(x, y), jc.LinearSVM().fit(x, y)
    assert _rel(mine.w, ref.w) <= FIT_RTOL
    assert _rel(mine.b, ref.b) <= FIT_RTOL
    np.testing.assert_array_equal(mine.predict(xv), ref.predict(xv))
    np.testing.assert_array_equal(mine.classes, ref.classes)


@pytest.mark.parametrize("batch", [None, 16])     # 16: a short last batch
def test_mlp_fit_matches_jax_from_its_initial_weights(blobs, batch):
    """The head starts from JAX's ``init_mlp(PRNGKey(0))`` weights in
    both packages: same epochs, same per-epoch losses (logged), same
    parameters after, within FIT_RTOL."""
    x, y, xv, yv = blobs
    cw = np.array([0.2, 0.3, 0.25, 0.25], np.float32)
    kw = dict(lr=3e-3, epochs=4, weight_decay=1e-3, batch_size=batch)
    ref = jc.MLPTrainer(6, [16, 8], 4, seed=0, **kw)
    mine = tc.MLPTrainer(6, [16, 8], 4, seed=0, **kw)
    mine.params = [{k: np.asarray(v) for k, v in l.items()}
                   for l in ref.params]
    rec_j, rec_t = Recorder(), Recorder()
    ref.fit(x, y, xv, yv, class_weights=cw, writer=rec_j)
    mine.fit(x, y, xv, yv, class_weights=cw, writer=rec_t)
    assert [r[0] for r in rec_t.rows] == [r[0] for r in rec_j.rows]
    for (tag, got, _), (_, want, _) in zip(rec_t.rows, rec_j.rows):
        assert got == pytest.approx(want, rel=FIT_RTOL, abs=1e-6), tag
    for lt, lj in zip(mine.params, ref.params):
        assert _rel(lt["w"], lj["w"]) <= FIT_RTOL
        assert _rel(lt["b"], lj["b"]) <= FIT_RTOL
    np.testing.assert_array_equal(mine.predict(xv), ref.predict(xv))


@pytest.mark.parametrize("scores,picked,fits", [
    ([0.5, 0.8, 0.8, 0.6], 1, 4),     # ties keep the lowest seed
    ([0.5, 1.0, 0.9, 0.9], 1, 2),     # a perfect score stops the search
    ([0.7, 0.7, 0.7, 0.7], 0, 4),
])
def test_mlp_restart_selection_matches_jax(blobs, monkeypatch, scores,
                                           picked, fits):
    """The restarts (seeds 0..3) with injected validation scores: both
    packages keep the same seed after the same number of fits."""
    x, y, xv, yv = blobs
    results = {}
    for name, mod in (("jax", jc), ("torch", tc)):
        seen = []

        def fit(self, *a, _seen=seen, **k):
            _seen.append(self)
            return self

        def score(self, *a, _seen=seen):
            return scores[_seen.index(self)]

        monkeypatch.setattr(mod.MLPTrainer, "fit", fit)
        monkeypatch.setattr(mod.MLPTrainer, "score", score)
        monkeypatch.setattr(mod.LinearSVM, "fit",
                            lambda self, *a, **k: self)
        monkeypatch.setattr(mod.LinearSVM, "score", lambda self, *a: 0.0)
        zoo = mod.LatentClassifiers(latent_size=6, mlp_hidden=[8],
                                    mlp_epochs=1, mlp_restarts=4)
        rec = Recorder()
        zoo.fit_all(x, y, xv, yv, writer=rec)
        results[name] = (seen.index(zoo.mlp), len(seen),
                         [r for r in rec.rows
                          if r[0] == "classifier/selected_seed"])
    assert results["torch"] == results["jax"]
    assert results["torch"][:2] == (picked, fits)


@pytest.fixture(scope="module")
def zoos(blobs):
    """Both packages' zoos, fitted on the same latents with per-region
    heads and the same end-to-end MLP head."""
    x, y, xv, yv = blobs
    regions = {"r0": (0, 2), "r1": (2, 4), "r2": (4, 6)}
    from craniofacialsd_vae_tpu.models.mlp import init_mlp
    import jax
    head = [{k: np.asarray(v) for k, v in l.items()}
            for l in init_mlp(jax.random.PRNGKey(2), 6, [8], 4)]
    kw = dict(latent_size=6, latent_regions=regions, mlp_hidden=[8])
    ref = jc.LatentClassifiers(**kw)
    mine = tc.LatentClassifiers(**kw)
    accs_j = ref.fit_all(x, y, xv, yv, mlp_init=head)
    accs_t = mine.fit_all(x, y, xv, yv, mlp_init=head)
    return dict(ref=ref, mine=mine, accs_j=accs_j, accs_t=accs_t, xv=xv)


def test_zoo_matches_jax(zoos):
    assert zoos["accs_t"] == zoos["accs_j"]
    ref, mine, xv = zoos["ref"], zoos["mine"], zoos["xv"]
    for model in ("qda", "lda", "svm", "mlp"):
        np.testing.assert_array_equal(mine.predict(xv, model),
                                      ref.predict(xv, model))
    assert list(mine.region_qdas) == list(ref.region_qdas)
    for k in ref.region_qdas:
        np.testing.assert_allclose(mine.region_qdas[k].covs,
                                   ref.region_qdas[k].covs, rtol=1e-12)
        np.testing.assert_allclose(mine.region_ldas[k].coef,
                                   ref.region_ldas[k].coef, rtol=1e-10)
    assert mine.mahalanobis(xv[0], 2, "r1") == pytest.approx(
        ref.mahalanobis(xv[0], 2, "r1"), rel=1e-12)
    np.testing.assert_allclose(mine.lda_transform(xv), ref.lda_transform(xv),
                               rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_classifiers_npz_crosses_both_ways(zoos, tmp_path, writer):
    """``classifiers.npz`` written by one package, read by the other:
    every head predicts the same, the arrays are the same."""
    src = zoos["mine"] if writer == "torch" else zoos["ref"]
    src.save(str(tmp_path))
    back = (jc if writer == "torch" else tc).LatentClassifiers(
        latent_size=6, mlp_hidden=[8]).load(str(tmp_path))
    xv = zoos["xv"]
    for model in ("qda", "lda", "svm", "mlp"):
        np.testing.assert_array_equal(back.predict(xv, model),
                                      src.predict(xv, model))
    np.testing.assert_allclose(back.qda.log_posteriors(xv),
                               src.qda.log_posteriors(xv), rtol=1e-12)
    assert list(back.region_ldas) == list(src.region_ldas)
    with np.load(os.path.join(str(tmp_path), "classifiers.npz")) as z:
        assert "mlp0_w" in z and "region_keys" in z


def test_reference_pickles_both_ways(zoos, tmp_path):
    """The port writes the reference's sklearn pickles; the port and the
    JAX package read them back to the same decisions, and sklearn's own
    estimators read them too."""
    pytest.importorskip("sklearn")
    mine, xv = zoos["mine"], zoos["xv"]
    mine.save_reference_pickles(str(tmp_path))
    for name in ("lda_classifier.pkl", "qda_classifier.pkl",
                 "svm_classifier.pkl", "region_ldas.pkl", "region_qdas.pkl"):
        assert os.path.exists(os.path.join(str(tmp_path), name))
    back_t = tc.LatentClassifiers(latent_size=6).load_reference_pickles(
        str(tmp_path))
    back_j = jc.LatentClassifiers(latent_size=6).load_reference_pickles(
        str(tmp_path))
    for model in ("qda", "lda", "svm"):
        np.testing.assert_array_equal(back_t.predict(xv, model),
                                      mine.predict(xv, model))
        np.testing.assert_array_equal(back_j.predict(xv, model),
                                      mine.predict(xv, model))
    assert list(back_t.region_qdas) == list(mine.region_qdas)
    np.testing.assert_allclose(back_t.lda_transform(xv),
                               back_j.lda_transform(xv), rtol=1e-10)


def test_reference_made_pickles_predict_like_sklearn(blobs, tmp_path):
    """Pickles made by sklearn itself (the reference's
    ``model_manager.py:708-725``) and the reference's MLP ``.pt``."""
    pytest.importorskip("sklearn")
    import pickle

    from sklearn.discriminant_analysis import (LinearDiscriminantAnalysis,
                                               QuadraticDiscriminantAnalysis)
    from sklearn.svm import LinearSVC

    x, y, xv, _ = blobs
    skl = {"lda_classifier.pkl": LinearDiscriminantAnalysis(
               solver="svd", store_covariance=True).fit(x, y),
           "qda_classifier.pkl": QuadraticDiscriminantAnalysis(
               store_covariance=True).fit(x, y),
           "svm_classifier.pkl": LinearSVC(class_weight="balanced").fit(
               x, y)}
    for name, est in skl.items():
        with open(os.path.join(str(tmp_path), name), "wb") as f:
            pickle.dump(est, f)
    mlp = torch.nn.Module()
    mlp.model = torch.nn.Sequential(torch.nn.Linear(6, 8), torch.nn.ReLU(),
                                    torch.nn.Linear(8, 4), torch.nn.ReLU())
    torch.save({"model": mlp.state_dict()},
               os.path.join(str(tmp_path), "mlp_classifier.pt"))
    zoo = tc.LatentClassifiers(latent_size=6).load_reference_pickles(
        str(tmp_path))
    for model, name in (("lda", "lda_classifier.pkl"),
                        ("qda", "qda_classifier.pkl"),
                        ("svm", "svm_classifier.pkl")):
        np.testing.assert_array_equal(zoo.predict(xv, model),
                                      skl[name].predict(xv))
    with torch.no_grad():
        logits = mlp.model(torch.from_numpy(xv))
    np.testing.assert_array_equal(zoo.predict(xv, "mlp"),
                                  logits.argmax(1).numpy())

"""The reference's sklearn pickles read by the port without sklearn.

``LatentClassifiers.load_reference_pickles`` of the port unpickles the
reference's ``{lda,qda,svm}_classifier.pkl`` and ``region_{ldas,qdas}.pkl``
through ``ReferenceUnpickler``, which needs no sklearn (the card's machine
has none). Each case reads the pickles in a subprocess where
``sys.modules["sklearn"] = None`` and holds what it reads against
``from_sklearn`` on the real estimators, the JAX package's
``load_reference_pickles`` and sklearn's own outputs: LDA decisions and
transform, QDA posteriors and log posteriors, SVM decisions and every
head's labels.

``tests/fixtures/reference_pickles/`` is a small committed set (latent 6,
three classes, two latent regions) written by ``write_fixture`` below with
sklearn 1.9.0, beside ``expected.npz`` (the outputs of ``from_sklearn`` on
the real estimators at its probe latents); ``chip_smoke.py`` reads it on
the card's machine.

Tolerances: against ``from_sklearn`` and the JAX package's reader, the
same numpy code on the same arrays, 1e-10 of each array's largest entry.
Against sklearn's own outputs 1e-5: the latents are float32, so the fitted
arrays are too, and sklearn's QDA forms ``R·S^-½`` where both packages
form ``R/√S``, rounded in float32. Labels exactly."""

import inspect
import io
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from craniofacialsd_vae_tpu.analysis import classifiers as jc
from craniofacialsd_vae_tpu_torch.analysis import classifiers as tc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "reference_pickles")
REGIONS = {"r0": (0, 3), "r1": (3, 6)}
RTOL = 1e-10
SKLEARN_RTOL = 1e-5
PICKLES = ("lda_classifier.pkl", "qda_classifier.pkl", "svm_classifier.pkl",
           "region_ldas.pkl", "region_qdas.pkl")


def _blobs(seed, n_classes, per_class, dims=6):
    rng = np.random.default_rng(seed)
    xs, ys = [], []
    for c in range(n_classes):
        m = rng.normal(scale=2.0, size=dims)
        a = np.eye(dims) + 0.3 * rng.random((dims, dims))
        xs.append(rng.multivariate_normal(m, a @ a.T, size=per_class))
        ys.append(np.full(per_class, c))
    return (np.concatenate(xs).astype(np.float32), np.concatenate(ys),
            rng.normal(scale=2.0, size=(12, dims)).astype(np.float32))


def _estimators(x, y, regions):
    """The reference's heads as sklearn fits them (model_manager.py:
    448-546): svd LDA with two components (fewer with fewer classes) and
    QDA, both keeping their covariances, a balanced LinearSVC, and the
    per-region LDA/QDA on the region's latent slice."""
    from sklearn.discriminant_analysis import (LinearDiscriminantAnalysis,
                                               QuadraticDiscriminantAnalysis)
    from sklearn.svm import LinearSVC

    def lda(a):
        return LinearDiscriminantAnalysis(
            solver="svd", n_components=min(2, len(np.unique(y)) - 1),
            store_covariance=True).fit(a, y)

    def qda(a):
        return QuadraticDiscriminantAnalysis(store_covariance=True).fit(a, y)

    return {"lda_classifier.pkl": lda(x), "qda_classifier.pkl": qda(x),
            "svm_classifier.pkl": LinearSVC(class_weight="balanced").fit(
                x, y),
            "region_ldas.pkl": {k: lda(x[:, lo:hi])
                                for k, (lo, hi) in regions.items()},
            "region_qdas.pkl": {k: qda(x[:, lo:hi])
                                for k, (lo, hi) in regions.items()}}


def _write_pickles(root, est):
    os.makedirs(root, exist_ok=True)
    for name, obj in est.items():
        with open(os.path.join(root, name), "wb") as f:
            pickle.dump(obj, f)


def _sklearn_outputs(est, z):
    """sklearn's own outputs of the reference's heads on ``z``, in the
    zoo's layout: a binary decision as one column (LDA) or as its two
    signed columns (the SVM), QDA's log posteriors unnormalized."""
    lda, qda, svm = (est["lda_classifier.pkl"], est["qda_classifier.pkl"],
                     est["svm_classifier.pkl"])
    lda_d = lda.decision_function(z)
    svm_d = svm.decision_function(z)
    out = {"lda_decision": lda_d[:, None] if lda_d.ndim == 1 else lda_d,
           "lda_transform": lda.transform(z), "lda_label": lda.predict(z),
           "qda_proba": qda.predict_proba(z),
           "qda_log_proba": qda._decision_function(z),
           "qda_label": qda.predict(z),
           "svm_decision": np.stack([-svm_d, svm_d], axis=1)
           if svm_d.ndim == 1 else svm_d,
           "svm_label": svm.predict(z)}
    for k, (lo, hi) in REGIONS.items():
        out[f"{k}_lda_transform"] = est["region_ldas.pkl"][k].transform(
            z[:, lo:hi])
        out[f"{k}_qda_proba"] = est["region_qdas.pkl"][k].predict_proba(
            z[:, lo:hi])
    return out


def _from_sklearn(est):
    """The port's zoo from the real estimators."""
    zoo = tc.LatentClassifiers(latent_size=6, latent_regions=REGIONS)
    zoo.lda = tc.LDAClassifier.from_sklearn(est["lda_classifier.pkl"])
    zoo.qda = tc.QDAClassifier.from_sklearn(est["qda_classifier.pkl"])
    zoo.svm = tc.LinearSVM.from_sklearn(est["svm_classifier.pkl"])
    zoo.region_ldas = {k: tc.LDAClassifier.from_sklearn(v)
                       for k, v in est["region_ldas.pkl"].items()}
    zoo.region_qdas = {k: tc.QDAClassifier.from_sklearn(v)
                       for k, v in est["region_qdas.pkl"].items()}
    return zoo


def write_fixture(root=FIXTURE):
    """The committed fixture: three classes of 20 latents (6 dims), the
    reference's heads fitted by sklearn, their pickles, and the outputs of
    ``from_sklearn`` on the real estimators at 12 probe latents in
    ``expected.npz``."""
    x, y, z = _blobs(11, 3, 20)
    est = _estimators(x, y, REGIONS)
    _write_pickles(root, est)
    np.savez(os.path.join(root, "expected.npz"), probe=z,
             **zoo_outputs(_from_sklearn(est), z, REGIONS))


def zoo_outputs(zoo, z, regions):
    """The same outputs from a zoo of either package."""
    out = {"lda_decision": zoo.lda.decision_function(z),
           "lda_transform": zoo.lda_transform(z),
           "lda_label": zoo.predict(z, "lda"),
           "qda_proba": zoo.qda.predict_proba(z),
           "qda_log_proba": zoo.qda.log_posteriors(z),
           "qda_label": zoo.predict(z, "qda"),
           "svm_decision": np.asarray(z, np.float64) @ zoo.svm.w + zoo.svm.b,
           "svm_label": zoo.predict(z, "svm")}
    for k, (lo, hi) in regions.items():
        out[f"{k}_lda_transform"] = \
            zoo.region_ldas[k].transform_sklearn_style(z[:, lo:hi])
        out[f"{k}_qda_proba"] = zoo.region_qdas[k].predict_proba(z[:, lo:hi])
    return {k: np.asarray(v) for k, v in out.items()}


def _read_without_sklearn(tmp_path, pickles_dir, z, resume=False):
    """The port's reader in a fresh interpreter where sklearn cannot be
    imported: ``load_reference_pickles`` (``resume``: through
    ``ModelManager._resume_classifiers``, the path a run dir takes), then
    ``zoo_outputs`` on ``z``."""
    probe = os.path.join(str(tmp_path), "probe.npy")
    out = os.path.join(str(tmp_path), "blocked.npz")
    np.save(probe, z)
    script = "\n".join([
        "import sys, types",
        "sys.modules['sklearn'] = None",
        f"sys.path.insert(0, {REPO!r})",
        "import numpy as np",
        "from craniofacialsd_vae_tpu_torch.analysis.classifiers import "
        "LatentClassifiers",
        "from craniofacialsd_vae_tpu_torch.manager import ModelManager",
        inspect.getsource(zoo_outputs),
        f"regions = {REGIONS!r}",
        "def fresh():",
        "    return LatentClassifiers(latent_size=6, latent_regions=regions)",
        f"if {resume!r}:",
        "    mgr = types.SimpleNamespace(classifiers=None)",
        "    mgr.build_classifiers = lambda: setattr(mgr, 'classifiers', "
        "fresh())",
        f"    ModelManager._resume_classifiers(mgr, {pickles_dir!r})",
        "    zoo = mgr.classifiers",
        "else:",
        f"    zoo = fresh().load_reference_pickles({pickles_dir!r})",
        "assert 'sklearn.discriminant_analysis' not in sys.modules",
        f"z = np.load({probe!r})",
        f"np.savez({out!r}, **zoo_outputs(zoo, z, regions))",
    ])
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300, env=env, cwd=REPO)
    assert res.returncode == 0, res.stderr[-3000:]
    with np.load(out) as f:
        return dict(f)


def _assert_same(got, want, what, rtol=RTOL):
    assert set(got) == set(want), what
    for k, w in want.items():
        g = np.asarray(got[k])
        w = np.asarray(w)
        assert g.shape == w.shape, (what, k, g.shape, w.shape)
        if k.endswith("_label"):
            np.testing.assert_array_equal(g, w, err_msg=f"{what}: {k}")
        else:
            scale = max(float(np.abs(w).max()), 1e-30)
            err = float(np.abs(g - w).max()) / scale
            assert err <= rtol, (what, k, err)


@pytest.mark.parametrize("case", [
    (3, 3, 25),      # more samples than dims, as in the reference
    (5, 4, 30),      # the reference's four syndromes
    (7, 5, 20),      # the stand-in dataset's five classes
])
def test_blocked_reader_matches_sklearn_and_jax(tmp_path, case):
    seed, n_classes, per_class = case
    x, y, z = _blobs(seed, n_classes, per_class)
    est = _estimators(x, y, REGIONS)
    root = os.path.join(str(tmp_path), "ckpt")
    _write_pickles(root, est)
    blocked = _read_without_sklearn(tmp_path, root, z)
    _assert_same(blocked, zoo_outputs(_from_sklearn(est), z, REGIONS),
                 "blocked reader vs from_sklearn")
    ref = jc.LatentClassifiers(latent_size=6, latent_regions=REGIONS) \
        .load_reference_pickles(root)
    _assert_same(blocked, zoo_outputs(ref, z, REGIONS),
                 "blocked reader vs the JAX package's reader")
    _assert_same(blocked, _sklearn_outputs(est, z),
                 "blocked reader vs sklearn", SKLEARN_RTOL)


def test_committed_fixture_reads_without_sklearn(tmp_path):
    """The fixture ``chip_smoke.py`` reads on the card's machine: its
    pickles read without sklearn give ``expected.npz``."""
    for name in PICKLES:
        assert os.path.exists(os.path.join(FIXTURE, name)), name
    with np.load(os.path.join(FIXTURE, "expected.npz")) as f:
        want = dict(f)
    z = want.pop("probe")
    _assert_same(_read_without_sklearn(tmp_path, FIXTURE, z), want,
                 "fixture without sklearn vs expected.npz")


def test_committed_fixture_is_what_sklearn_reads():
    """``expected.npz`` is what ``from_sklearn`` makes of the committed
    pickles unpickled by sklearn, sklearn's own outputs agree, and so does
    the JAX package's reader."""
    est = {}
    for name in PICKLES:
        with open(os.path.join(FIXTURE, name), "rb") as f:
            est[name] = pickle.load(f)
    with np.load(os.path.join(FIXTURE, "expected.npz")) as f:
        want = dict(f)
    z = want.pop("probe")
    _assert_same(zoo_outputs(_from_sklearn(est), z, REGIONS), want,
                 "from_sklearn vs expected.npz")
    _assert_same(_sklearn_outputs(est, z), want, "sklearn vs expected.npz",
                 SKLEARN_RTOL)
    ref = jc.LatentClassifiers(latent_size=6, latent_regions=REGIONS) \
        .load_reference_pickles(FIXTURE)
    _assert_same(zoo_outputs(ref, z, REGIONS), want, "JAX vs expected.npz")


def test_manager_resume_reads_the_pickles_without_sklearn(tmp_path):
    """``ModelManager._resume_classifiers`` on a checkpoint dir holding
    only the reference's pickles (no ``classifiers.npz``), sklearn
    blocked: the run dir a migrated reference run serves from."""
    with np.load(os.path.join(FIXTURE, "expected.npz")) as f:
        want = dict(f)
    z = want.pop("probe")
    root = os.path.join(str(tmp_path), "ckpt")
    os.makedirs(root)
    for name in PICKLES:
        with open(os.path.join(FIXTURE, name), "rb") as src, \
                open(os.path.join(root, name), "wb") as dst:
            dst.write(src.read())
    _assert_same(_read_without_sklearn(tmp_path, root, z, resume=True), want,
                 "resume without sklearn vs expected.npz")


def test_other_sklearn_classes_raise_naming_the_class(tmp_path):
    """A pickle holding an sklearn class the reference never saves is
    refused by name, also where sklearn is installed."""
    from sklearn.preprocessing import StandardScaler

    path = os.path.join(str(tmp_path), "lda_classifier.pkl")
    with open(path, "wb") as f:
        pickle.dump({"scaler": StandardScaler().fit(np.eye(3))}, f)
    with open(path, "rb") as f:
        with pytest.raises(pickle.UnpicklingError,
                           match=r"sklearn\.preprocessing.*StandardScaler"):
            tc.ReferenceUnpickler(f).load()


def test_holders_read_like_the_estimators():
    """``from_sklearn`` on a holder reads the attributes it reads on the
    estimator; numpy arrays come back as arrays."""
    x, y, _ = _blobs(2, 3, 20)
    est = _estimators(x, y, REGIONS)
    held = tc.ReferenceUnpickler(
        io.BytesIO(pickle.dumps(est["qda_classifier.pkl"]))).load()
    assert isinstance(held, tc._FittedState)
    assert isinstance(held.rotations_[0], np.ndarray)
    np.testing.assert_array_equal(held.means_, est["qda_classifier.pkl"].means_)

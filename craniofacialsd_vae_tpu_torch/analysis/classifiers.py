"""Latent-space syndrome classifiers (counterpart of
``analysis/classifiers.py``; the reference's model_manager.py:96-147,
448-546).

LDA and QDA are closed-form numpy, as in the JAX package: class means,
covariances (QDA with Ledoit-Wolf auto-shrinkage where a class has fewer
samples than dimensions) and Gaussian log-posteriors. The linear SVM
(one-vs-rest squared hinge with balanced class weights, LinearSVC's
objective, from zeros with full-batch Adam) and the MLP head (coupled
Adam, class-weighted cross entropy, one step per latent minibatch) fit in
torch on the device they are given. ``LatentClassifiers`` is the zoo with
its ``classifiers.npz`` layout, which the JAX package reads and writes
too, and the reference's sklearn pickles both ways (those need
``sklearn``, imported only by the ``to_sklearn`` methods; no path on the
card reaches them).
"""

from __future__ import annotations

import os
import pickle
from dataclasses import dataclass, field

import numpy as np
import torch

__all__ = ["QDAClassifier", "LDAClassifier", "LinearSVM", "MLPTrainer",
           "LatentClassifiers"]

# ---------------------------------------------------------------------------
@dataclass
class QDAClassifier:
    """Quadratic discriminant analysis: per-class Gaussian with full
    covariance, priors from data (sklearn semantics; reference
    model_manager.py:492-495).

    Decisions use sklearn's factorized form: per-class rotations R and
    scalings S2 (eigenpairs of the class covariance) give
    ``-0.5·(‖(x-μ)·R·S2^-½‖² + Σlog S2) + log prior``.

    ``reg_param=None`` (default) is *auto*: 0 when every class covariance
    is full rank — exactly sklearn's default — otherwise each class
    covariance is Ledoit-Wolf-shrunk toward its scaled identity
    ``(1-ρ)·Σ + ρ·μ·I`` with the closed-form optimal intensity ρ (Ledoit
    & Wolf 2004; the per-class intensities land in ``auto_shrinkage_``).
    Without this, a 75-dim latent QDA fit on tens of samples per class
    degenerates: rank-deficient pseudo-inverse log-pdfs are not
    comparable across classes and the argmax collapses — measured on the
    hard synthetic benchmark, the unshrunk head (which the reference's
    unregularized sklearn QDA shares, model_manager.py:492-495) scored
    0.40 with three classes at F1 0.0 while every other head exceeded
    0.65 (round-4 hard_benchmark_record). A fixed token reg (1e-3, round
    2-4) rescued only well-separated classes; LW adapts the intensity to
    the class's own sample-noise level."""
    means: np.ndarray = None       # [C, D]
    covs: np.ndarray = None        # [C, D, D] (post-shrinkage when reg > 0)
    priors: np.ndarray = None      # [C]
    classes: np.ndarray = None     # [C] label ids
    reg_param: float | None = None
    rotations: list = None         # [C] of [D, r_k]
    scalings: list = None          # [C] of [r_k]
    auto_shrinkage_: list = None   # per-class LW ρ when auto engaged

    @staticmethod
    def ledoit_wolf_covariance(xc: np.ndarray):
        """(shrunk covariance, intensity ρ) for one class's samples —
        the Ledoit-Wolf 2004 closed form toward the scaled identity,
        matching sklearn.covariance.ledoit_wolf (MLE base covariance).
        ρ = min(b̄², d²)/d² with d² = ‖S−μI‖²_F/p and
        b̄² = (Σ_k‖x_k‖⁴/n − ‖S‖²_F) / (n·p)."""
        xc = np.asarray(xc, np.float64)
        n, p = xc.shape
        xc = xc - xc.mean(axis=0)
        s = xc.T @ xc / n
        mu = np.trace(s) / p
        delta2 = np.sum((s - mu * np.eye(p)) ** 2) / p
        if delta2 <= 0:            # S already isotropic (or n == 1)
            return mu * np.eye(p), 1.0
        beta2 = (np.sum(np.sum(xc ** 2, axis=1) ** 2) / n
                 - np.sum(s ** 2)) / (n * p)
        rho = min(beta2, delta2) / delta2
        return (1.0 - rho) * s + rho * mu * np.eye(p), rho

    def fit(self, x: np.ndarray, y: np.ndarray) -> "QDAClassifier":
        self.classes = np.unique(y)
        d = x.shape[1]
        means, covs, priors, counts = [], [], [], []
        for c in self.classes:
            xc = x[y == c]
            means.append(xc.mean(axis=0))
            covs.append(np.cov(xc, rowvar=False, ddof=1)
                        if len(xc) > 1 else np.zeros((d, d)))
            priors.append(len(xc) / len(x))
            counts.append(len(xc))
        self.means = np.stack(means)
        self.priors = np.asarray(priors)

        reg = self.reg_param
        self.auto_shrinkage_ = None
        if reg is None:
            reg = 0.0
            if min(counts) - 1 < d:    # degenerate: auto-engage LW
                shrunk = [self.ledoit_wolf_covariance(x[y == c])
                          for c in self.classes]
                covs = [cv for cv, _ in shrunk]
                self.auto_shrinkage_ = [rho for _, rho in shrunk]
        if reg > 0.0:
            scale = float(np.mean([np.trace(cv) / d for cv in covs]))
            scale = scale if scale > 0 else 1.0
            covs = [(1.0 - reg) * cv + reg * scale * np.eye(d)
                    for cv in covs]
        self.covs = np.stack(covs)
        self._factorize()
        return self

    def _factorize(self):
        """Eigendecompose each class covariance into sklearn-style
        (rotations, scalings), truncating non-positive eigenvalues (the
        rank-deficient sklearn-pickle-derived case projects onto the class
        subspace, matching sklearn's thin-SVD decision function)."""
        self.rotations, self.scalings = [], []
        for cov in self.covs:
            ev, vec = np.linalg.eigh(cov)
            keep = ev > max(float(ev.max()), 1.0) * 1e-12
            if not keep.any():
                keep[-1] = True
            self.rotations.append(vec[:, keep])
            self.scalings.append(np.maximum(ev[keep], 1e-300))

    def _ensure_factors(self):
        if self.rotations is None:
            if self.covs is None:
                raise ValueError(
                    "QDA has neither covariances nor factorizations — "
                    "imported from a store_covariance=False pickle and "
                    "stripped of its rotations/scalings?")
            self._factorize()

    @staticmethod
    def _solve_cov(cov: np.ndarray, rhs: np.ndarray) -> np.ndarray:
        """Solve cov @ x = rhs, falling back to the pseudo-inverse when the
        class covariance is rank-deficient (fewer samples than dims)."""
        try:
            sol = np.linalg.solve(cov, rhs)
            if np.isfinite(sol).all():
                return sol
        except np.linalg.LinAlgError:
            pass
        return np.linalg.pinv(cov) @ rhs

    def log_posteriors(self, x: np.ndarray) -> np.ndarray:
        self._ensure_factors()
        x = np.atleast_2d(x)
        out = np.empty((len(x), len(self.classes)))
        for i, _ in enumerate(self.classes):
            diff = x - self.means[i]
            r, s2 = self.rotations[i], self.scalings[i]
            x2 = diff @ (r / np.sqrt(s2))
            out[:, i] = -0.5 * (np.sum(x2 ** 2, axis=1)
                                + np.sum(np.log(s2))) \
                + np.log(self.priors[i])
        return out

    def predict(self, x: np.ndarray) -> np.ndarray:
        return self.classes[np.argmax(self.log_posteriors(x), axis=1)]

    def predict_proba(self, x: np.ndarray) -> np.ndarray:
        lp = self.log_posteriors(x)
        lp = lp - lp.max(axis=1, keepdims=True)
        p = np.exp(lp)
        return p / p.sum(axis=1, keepdims=True)

    def score(self, x, y) -> float:
        return float(np.mean(self.predict(x) == y))

    def _class_index(self, class_idx: int) -> int:
        """Position of a fitted class label in ``self.classes`` — loud on
        a label the head never saw (e.g. 'b' merged into 'n' upstream)."""
        hits = np.where(self.classes == class_idx)[0]
        if len(hits) == 0:
            raise ValueError(
                f"class index {class_idx} was not among the QDA's fitted "
                f"classes {list(self.classes)}")
        return int(hits[0])

    def class_covariance(self, class_idx: int):
        """(mean, covariance) of the fitted class Gaussian. Rebuilds the
        covariance from its R·diag(S2)·Rᵀ factorization when the head was
        imported from a ``store_covariance=False`` sklearn pickle."""
        i = self._class_index(class_idx)
        if self.covs is not None:
            return np.asarray(self.means[i]), np.asarray(self.covs[i])
        self._ensure_factors()
        r, s = self.rotations[i], self.scalings[i]
        return np.asarray(self.means[i]), (r * s) @ r.T

    def sample(self, class_idx: int, n: int = 1, seed: int = 0):
        """Draw from the fitted class Gaussian (reference mm.py:509-514)."""
        mean, cov = self.class_covariance(class_idx)
        return np.random.default_rng(seed).multivariate_normal(mean, cov, n)

    def mahalanobis(self, z, class_idx: int) -> float:
        """Mahalanobis distance of z to the class Gaussian
        (reference mm.py:516-529)."""
        self._ensure_factors()
        i = self._class_index(class_idx)
        diff = np.asarray(z).reshape(-1) - self.means[i]
        proj = diff @ self.rotations[i]
        return float(np.sqrt(np.sum(proj ** 2 / self.scalings[i])))

    @classmethod
    def from_sklearn(cls, skl) -> "QDAClassifier":
        c = cls()
        c.means = np.asarray(skl.means_)
        # covariance_ requires store_covariance=True (the reference's
        # setting); decisions use the always-present rotations_/scalings_
        covs = getattr(skl, "covariance_", None)
        c.covs = None if covs is None else \
            np.stack([np.asarray(m) for m in covs])
        c.priors = np.asarray(skl.priors_)
        c.classes = np.asarray(skl.classes_)
        # sklearn's own thin-SVD factors → bit-identical decision values
        if getattr(skl, "rotations_", None) is not None:
            c.rotations = [np.asarray(r) for r in skl.rotations_]
            c.scalings = [np.asarray(s) for s in skl.scalings_]
        return c

    def to_sklearn(self):
        """Inverse of from_sklearn: a fitted
        sklearn.QuadraticDiscriminantAnalysis with OUR factors installed —
        its predict/decision_function reproduce ours, so a user migrating
        back to the reference toolchain keeps identical diagnoses. A
        covariance-less instance (imported from a store_covariance=False
        pickle) exports without covariance_ — decisions never need it."""
        from sklearn.discriminant_analysis import \
            QuadraticDiscriminantAnalysis
        skl = QuadraticDiscriminantAnalysis(
            store_covariance=self.covs is not None)
        skl.means_ = np.asarray(self.means, np.float64)
        if self.covs is not None:
            skl.covariance_ = [np.asarray(c, np.float64) for c in self.covs]
        skl.priors_ = np.asarray(self.priors, np.float64)
        skl.classes_ = np.asarray(self.classes)
        self._ensure_factors()
        skl.rotations_ = [np.asarray(r, np.float64) for r in self.rotations]
        skl.scalings_ = [np.asarray(s, np.float64) for s in self.scalings]
        return skl

    def to_arrays(self, prefix=""):
        out = {f"{prefix}means": self.means, f"{prefix}priors": self.priors,
               f"{prefix}classes": self.classes}
        if self.covs is not None:
            out[f"{prefix}covs"] = self.covs
        else:
            # store_covariance=False pickle import: the sklearn factors are
            # the only decision data — persist them per class (ranks vary)
            self._ensure_factors()
            for i, (r, s) in enumerate(zip(self.rotations, self.scalings)):
                out[f"{prefix}rot{i}"] = r
                out[f"{prefix}scal{i}"] = s
        return out

    @classmethod
    def from_arrays(cls, z, prefix=""):
        c = cls(means=z[f"{prefix}means"],
                covs=(z[f"{prefix}covs"]
                      if f"{prefix}covs" in z else None),
                priors=z[f"{prefix}priors"],
                classes=z[f"{prefix}classes"])
        if c.covs is None and f"{prefix}rot0" in z:
            c.rotations, c.scalings = [], []
            i = 0
            while f"{prefix}rot{i}" in z:
                c.rotations.append(z[f"{prefix}rot{i}"])
                c.scalings.append(z[f"{prefix}scal{i}"])
                i += 1
        return c


# ---------------------------------------------------------------------------
@dataclass
class LDAClassifier:
    """Linear discriminant analysis with a 2-D discriminant projection
    (reference uses n_components=2, store_covariance=True).

    Fitting whitens the pooled within-class scatter via a rank-truncated
    thin SVD of the centered data and solves for the discriminant axes in
    that subspace (the classical Fisher/`svd`-solver formulation). This is
    essential in the flagship regime — 75-dim latents, tens of training
    samples — where the pooled covariance has rank n−C < D: inverting it
    (or pinv-ing, as round 2 initially did) amplifies null-space noise and
    cost the trained run half its LDA test accuracy."""
    means: np.ndarray = None       # [C, D]
    cov: np.ndarray = None         # [D, D] pooled within-class
    priors: np.ndarray = None
    classes: np.ndarray = None
    scalings: np.ndarray = None    # [D, r] full discriminant basis
    xbar: np.ndarray = None        # overall weighted mean
    coef: np.ndarray = None        # [C, D] decision hyperplanes
    intercept: np.ndarray = None   # [C]
    n_components: int = 2
    tol: float = 1e-4

    def fit(self, x: np.ndarray, y: np.ndarray) -> "LDAClassifier":
        x = np.asarray(x, np.float64)
        self.classes = np.unique(y)
        c = len(self.classes)
        n = len(x)
        means, priors, centered = [], [], []
        for cl in self.classes:
            xc = x[y == cl]
            means.append(xc.mean(axis=0))
            priors.append(len(xc) / n)
            centered.append(xc - xc.mean(axis=0))
        self.means = np.stack(means)
        self.priors = np.asarray(priors)
        self.xbar = self.priors @ self.means
        xw = np.concatenate(centered)            # within-class centered rows
        fac = 1.0 / max(n - c, 1)
        self.cov = (xw.T @ xw) * fac             # pooled (store_covariance)

        # Σ_w^(-1/2) restricted to the data span: per-dim standardization,
        # thin SVD, drop singular values below tol (absolute, post-scaling).
        std = xw.std(axis=0)
        std[std == 0] = 1.0
        _, s, vt = np.linalg.svd(np.sqrt(fac) * (xw / std),
                                 full_matrices=False)
        rank = max(int(np.sum(s > self.tol)), 1)
        whiten = (vt[:rank] / std).T / s[:rank]  # [D, rank]

        # Between-class directions inside the whitened subspace.
        mw = (np.sqrt(n * self.priors * fac)[:, None]
              * (self.means - self.xbar)) @ whiten
        _, sb, vbt = np.linalg.svd(mw, full_matrices=False)
        rank_b = max(int(np.sum(sb > self.tol * sb[0])), 1) \
            if sb.size and sb[0] > 0 else 1
        self.scalings = whiten @ vbt[:rank_b].T  # [D, rank_b]
        # normalize sign for determinism: largest-magnitude entry positive
        for j in range(self.scalings.shape[1]):
            i = np.argmax(np.abs(self.scalings[:, j]))
            if self.scalings[i, j] < 0:
                self.scalings[:, j] *= -1

        proj = (self.means - self.xbar) @ self.scalings  # [C, rank_b]
        self.intercept = -0.5 * np.sum(proj ** 2, axis=1) \
            + np.log(self.priors)
        self.coef = proj @ self.scalings.T               # [C, D]
        self.intercept = self.intercept - self.xbar @ self.coef.T
        return self

    def decision_function(self, x: np.ndarray) -> np.ndarray:
        x = np.atleast_2d(x)
        if self.coef is not None:
            return x @ self.coef.T + self.intercept
        # legacy path (pre-round-2 npz checkpoints store only means/cov)
        sol = QDAClassifier._solve_cov(self.cov, self.means.T)  # [D, C]
        linear = x @ sol
        const = -0.5 * np.einsum("cd,dc->c", self.means, sol) + \
            np.log(self.priors)
        return linear + const

    def predict(self, x: np.ndarray) -> np.ndarray:
        return self.classes[np.argmax(self.decision_function(x), axis=1)]

    def score(self, x, y) -> float:
        return float(np.mean(self.predict(x) == y))

    def transform(self, x: np.ndarray) -> np.ndarray:
        return (np.atleast_2d(x) - self.xbar) \
            @ self.scalings[:, :self.n_components]

    @classmethod
    def from_sklearn(cls, skl) -> "LDAClassifier":
        c = cls()
        c.means = np.asarray(skl.means_)
        # covariance_ only exists under store_covariance=True (the
        # reference's setting); the hyperplane decision path needs no cov
        cov = getattr(skl, "covariance_", None)
        c.cov = None if cov is None else np.asarray(cov)
        c.priors = np.asarray(skl.priors_)
        c.classes = np.asarray(skl.classes_)
        c.xbar = np.asarray(getattr(skl, "xbar_", c.priors @ c.means))
        c.scalings = np.asarray(skl.scalings_)
        if getattr(skl, "coef_", None) is not None:
            c.coef = np.asarray(skl.coef_)
            c.intercept = np.asarray(skl.intercept_)
        c._sklearn_transform = True
        return c

    def transform_sklearn_style(self, x: np.ndarray) -> np.ndarray:
        """Exactly sklearn's svd-solver transform: (x - xbar_) @ scalings_,
        truncated to n_components."""
        return (np.atleast_2d(x) - self.xbar) \
            @ self.scalings[:, :self.n_components]

    def to_sklearn(self):
        """Inverse of from_sklearn: a fitted svd-solver
        sklearn.LinearDiscriminantAnalysis carrying OUR hyperplanes and
        discriminant basis — predict/decision_function/transform all
        reproduce ours in the reference toolchain."""
        from sklearn.discriminant_analysis import LinearDiscriminantAnalysis
        skl = LinearDiscriminantAnalysis(
            solver="svd", n_components=self.n_components,
            store_covariance=self.cov is not None)
        skl.means_ = np.asarray(self.means, np.float64)
        if self.cov is not None:
            skl.covariance_ = np.asarray(self.cov, np.float64)
        skl.priors_ = np.asarray(self.priors, np.float64)
        skl.classes_ = np.asarray(self.classes)
        skl.xbar_ = np.asarray(self.xbar, np.float64)
        skl.scalings_ = np.asarray(self.scalings, np.float64)
        if self.coef is None:
            raise ValueError("legacy npz-restored LDA lacks hyperplanes; "
                             "refit before exporting to sklearn")
        skl.coef_ = np.asarray(self.coef, np.float64)
        skl.intercept_ = np.asarray(self.intercept, np.float64)
        # sklearn's transform truncates to min(n_components, C-1, rank)
        skl._max_components = min(self.n_components,
                                  self.scalings.shape[1])
        return skl

    def to_arrays(self, prefix=""):
        out = {f"{prefix}means": self.means,
               f"{prefix}priors": self.priors,
               f"{prefix}classes": self.classes,
               f"{prefix}scalings": self.scalings,
               f"{prefix}xbar": self.xbar}
        if self.cov is not None:     # absent for store_covariance=False
            out[f"{prefix}cov"] = self.cov  # pickle imports
        if self.coef is not None:
            out[f"{prefix}coef"] = self.coef
            out[f"{prefix}intercept"] = self.intercept
        return out

    @classmethod
    def from_arrays(cls, z, prefix=""):
        return cls(means=z[f"{prefix}means"],
                   cov=z[f"{prefix}cov"] if f"{prefix}cov" in z else None,
                   priors=z[f"{prefix}priors"],
                   classes=z[f"{prefix}classes"],
                   scalings=z[f"{prefix}scalings"], xbar=z[f"{prefix}xbar"],
                   coef=z[f"{prefix}coef"] if f"{prefix}coef" in z else None,
                   intercept=z[f"{prefix}intercept"]
                   if f"{prefix}intercept" in z else None)



# ---------------------------------------------------------------------------
@dataclass
class LinearSVM:
    """One-vs-rest L2-regularized squared-hinge linear SVM with 'balanced'
    class weights — LinearSVC's objective (reference mm.py:123, 480-483) —
    fitted from zeros with full-batch Adam in torch on ``device``."""
    w: np.ndarray = None           # [D, C]
    b: np.ndarray = None           # [C]
    classes: np.ndarray = None
    c_reg: float = 1.0

    def fit(self, x: np.ndarray, y: np.ndarray, steps: int = 500,
            lr: float = 0.05, device="cpu") -> "LinearSVM":
        self.classes = np.unique(y)
        n, d = x.shape
        c = len(self.classes)
        y_idx = np.searchsorted(self.classes, y)
        targets = np.full((n, c), -1.0, np.float32)
        targets[np.arange(n), y_idx] = 1.0
        counts = np.bincount(y_idx, minlength=c)
        sample_w = (n / (c * counts))[y_idx].astype(np.float32)

        dev = torch.device(device)
        xt = torch.as_tensor(np.asarray(x, np.float32), device=dev)
        tt = torch.as_tensor(targets, device=dev)
        swt = torch.as_tensor(sample_w, device=dev)
        w = torch.zeros((d, c), device=dev, requires_grad=True)
        b = torch.zeros(c, device=dev, requires_grad=True)
        opt = torch.optim.Adam([w, b], lr=lr)
        for _ in range(steps):
            scores = xt @ w + b
            hinge = torch.clamp_min(1.0 - tt * scores, 0.0) ** 2
            loss = 0.5 * torch.sum(w ** 2) + \
                self.c_reg * torch.sum(swt[:, None] * hinge)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
        self.w = w.detach().cpu().numpy()
        self.b = b.detach().cpu().numpy()
        return self

    def predict(self, x: np.ndarray) -> np.ndarray:
        scores = np.atleast_2d(x) @ self.w + self.b
        if len(self.classes) == 2:
            return self.classes[(scores[:, 1] > scores[:, 0]).astype(int)]
        return self.classes[np.argmax(scores, axis=1)]

    def score(self, x, y) -> float:
        return float(np.mean(self.predict(x) == y))

    def to_arrays(self, prefix=""):
        return {f"{prefix}w": self.w, f"{prefix}b": self.b,
                f"{prefix}classes": self.classes}

    @classmethod
    def from_arrays(cls, z, prefix=""):
        return cls(w=z[f"{prefix}w"], b=z[f"{prefix}b"],
                   classes=z[f"{prefix}classes"])

    @classmethod
    def from_sklearn(cls, skl) -> "LinearSVM":
        """sklearn LinearSVC (reference mm.py:123, saved as
        svm_classifier.pkl) → the [D, C] layout. Binary sklearn models keep
        a single signed hyperplane, expanded to ±w columns so the two-column
        argmax matches sklearn's sign rule."""
        c = cls()
        coef = np.asarray(skl.coef_, np.float64)
        intercept = np.asarray(skl.intercept_, np.float64)
        c.classes = np.asarray(skl.classes_)
        if coef.shape[0] == 1 and len(c.classes) == 2:
            coef = np.concatenate([-coef, coef])
            intercept = np.concatenate([-intercept, intercept])
        c.w = coef.T
        c.b = intercept
        return c

    def to_sklearn(self):
        """Inverse of from_sklearn: a fitted sklearn.svm.LinearSVC carrying
        these hyperplanes (one-vs-rest layout)."""
        from sklearn.svm import LinearSVC
        skl = LinearSVC(C=self.c_reg, class_weight="balanced")
        skl.coef_ = np.asarray(self.w, np.float64).T
        skl.intercept_ = np.asarray(self.b, np.float64)
        skl.classes_ = np.asarray(self.classes)
        return skl


# ---------------------------------------------------------------------------
class MLPTrainer:
    """Post-hoc MLP head training (reference mm.py:428-471): coupled Adam
    (the config's weight decay in the gradient, reference mm.py:118-121)
    and one update per latent minibatch per epoch, the minibatches fixed
    across epochs (the reference's cached latents list), then a last short
    batch where the set does not divide. The head starts from weights
    drawn from ``torch.Generator().manual_seed(seed)``; these are not the
    JAX package's draws for the same seed (``PRNGKey(seed)``), so a
    parity check carries JAX's initial weights across (``params``)."""

    def __init__(self, latent_size, hidden, n_classes, lr=1e-4, epochs=50,
                 seed=0, weight_decay=0.0, batch_size=None, device="cpu"):
        from ..models.mlp import init_mlp

        self.device = torch.device(device)
        self.head = init_mlp(latent_size, hidden, n_classes,
                             torch.Generator().manual_seed(seed)
                             ).to(self.device)
        self.lr = lr
        self.epochs = epochs
        self.weight_decay = weight_decay
        self.batch_size = batch_size

    @classmethod
    def from_params(cls, layers: list, device="cpu", **kwargs
                    ) -> "MLPTrainer":
        """A trainer holding the head ``layers`` (the JAX layout: a list
        of ``{"w": [n_in, n_out], "b": [n_out]}``)."""
        trainer = cls(int(np.shape(layers[0]["w"])[0]),
                      [int(np.shape(l["w"])[1]) for l in layers[:-1]],
                      int(np.shape(layers[-1]["w"])[1]), device=device,
                      **kwargs)
        trainer.params = layers
        return trainer

    @property
    def params(self) -> list:
        """The head's layers in the JAX layout (float32 numpy)."""
        from ..models.mlp import mlp_to_jax
        return mlp_to_jax(self.head.state_dict())

    @params.setter
    def params(self, layers: list) -> None:
        from ..models.mlp import mlp_from_jax
        self.head.load_state_dict(mlp_from_jax(
            [{k: np.asarray(v) for k, v in l.items()} for l in layers]))

    def fit(self, x, y, x_val=None, y_val=None, class_weights=None,
            writer=None, tag_suffix=""):
        from ..training.losses import weighted_cross_entropy
        from ..training.trainer import coupled_adam

        dev = self.device
        n_classes = self.head.layers[-1].b.shape[0]
        cw = torch.as_tensor(
            np.asarray(class_weights, np.float32) if class_weights is not
            None else np.ones(n_classes, np.float32), device=dev)
        xt = torch.as_tensor(np.asarray(x, np.float32), device=dev)
        yt = torch.as_tensor(np.asarray(y), dtype=torch.long, device=dev)
        n = len(xt)
        bs = min(self.batch_size or n, n)
        n_full = n // bs
        batches = [(xt[i * bs:(i + 1) * bs], yt[i * bs:(i + 1) * bs])
                   for i in range(n_full)]
        if n % bs:          # 0 with the reference's drop_last loaders
            batches.append((xt[n_full * bs:], yt[n_full * bs:]))
        opt = coupled_adam(self.head.parameters(), self.lr,
                           self.weight_decay)
        xv = yv = None
        if x_val is not None:
            xv = torch.as_tensor(np.asarray(x_val, np.float32), device=dev)
            yv = torch.as_tensor(np.asarray(y_val), dtype=torch.long,
                                 device=dev)
        for epoch in range(self.epochs):
            loss_sum = acc_sum = 0.0
            for xs, ys in batches:
                logits, _ = self.head(xs)
                loss, acc = weighted_cross_entropy(logits, ys, cw)
                opt.zero_grad(set_to_none=True)
                loss.backward()
                opt.step()
                loss_sum = loss_sum + loss.detach()
                acc_sum = acc_sum + acc.detach()
            if writer is not None:
                # reference cadence: epoch means over batches, both phases
                # (mm.py:455-467)
                writer.add_scalar(f"train/class_loss{tag_suffix}",
                                  float(loss_sum) / len(batches), epoch + 1)
                writer.add_scalar(f"train/class_acc{tag_suffix}",
                                  float(acc_sum) / len(batches), epoch + 1)
                if xv is not None:
                    with torch.no_grad():
                        v_loss, v_acc = weighted_cross_entropy(
                            self.head(xv)[0], yv, cw)
                    writer.add_scalar(f"validation/class_loss{tag_suffix}",
                                      float(v_loss), epoch + 1)
                    writer.add_scalar(f"validation/class_acc{tag_suffix}",
                                      float(v_acc), epoch + 1)
        return self

    def predict(self, x) -> np.ndarray:
        with torch.no_grad():
            _, labels = self.head(torch.as_tensor(
                np.asarray(x, np.float32), device=self.device))
        return labels.cpu().numpy()

    def score(self, x, y) -> float:
        return float(np.mean(self.predict(x) == np.asarray(y)))


# ---------------------------------------------------------------------------
@dataclass
class LatentClassifiers:
    """The full zoo: MLP + SVM + LDA + QDA + per-region LDA/QDA
    (reference mm.py:96-147, 448-546). The SVM and the MLP fit on
    ``device``."""
    latent_size: int = 75
    latent_regions: dict | None = None
    mlp_hidden: list = field(default_factory=lambda: [512, 128, 64])
    mlp_lr: float = 1e-4
    mlp_epochs: int = 50
    mlp_weight_decay: float = 0.0   # config optimization.weight_decay
    mlp_batch: int | None = None    # loader batch size
    # best of N restarts by validation accuracy (the head is
    # init-seed-brittle on small latent sets); 1 = one fixed-seed fit
    mlp_restarts: int = 4
    device: str | torch.device = "cpu"

    mlp: MLPTrainer = None
    svm: LinearSVM = None
    lda: LDAClassifier = None
    qda: QDAClassifier = None
    region_ldas: dict = None
    region_qdas: dict = None

    def _make_mlp(self, n_classes: int, seed: int) -> MLPTrainer:
        return MLPTrainer(self.latent_size, self.mlp_hidden, n_classes,
                          self.mlp_lr, self.mlp_epochs, seed=seed,
                          weight_decay=self.mlp_weight_decay,
                          batch_size=self.mlp_batch, device=self.device)

    def fit_all(self, z, y, z_val, y_val, class_weights=None, mlp_init=None,
                writer=None) -> dict:
        """Fit every head on the train latents; returns the validation
        accuracies. ``mlp_init`` (the JAX layout: a head trained end to
        end with the network) is taken as the MLP head as it is, with no
        post-hoc fit."""
        accs = {}
        n_classes = int(np.max(y)) + 1
        if mlp_init is not None:
            self.mlp = self._make_mlp(n_classes, 0)
            self.mlp.params = mlp_init
        else:
            # best-of-N restarts by validation accuracy (ties → lowest
            # seed); stop at a perfect validation score. Each restart logs
            # under its own seed-suffixed tag; the winning seed lands in
            # classifier/selected_seed.
            restarts = max(1, int(self.mlp_restarts))
            best = None
            for seed in range(restarts):
                cand = self._make_mlp(n_classes, seed)
                cand.fit(z, y, z_val, y_val, class_weights=class_weights,
                         writer=writer,
                         tag_suffix=f"_seed{seed}" if restarts > 1 else "")
                v = cand.score(z_val, y_val)
                if best is None or v > best[0]:
                    best = (v, cand, seed)
                if v >= 1.0:
                    break
            self.mlp = best[1]
            if writer is not None and restarts > 1:
                writer.add_scalar("classifier/selected_seed", best[2], 0)
        accs["mlp"] = self.mlp.score(z_val, y_val)

        self.svm = LinearSVM().fit(z, y, device=self.device)
        accs["svm"] = self.svm.score(z_val, y_val)
        self.lda = LDAClassifier().fit(z, y)
        accs["lda"] = self.lda.score(z_val, y_val)
        self.qda = QDAClassifier().fit(z, y)
        accs["qda"] = self.qda.score(z_val, y_val)

        if self.latent_regions:
            self.region_ldas, self.region_qdas = {}, {}
            for key, (lo, hi) in self.latent_regions.items():
                self.region_ldas[key] = LDAClassifier().fit(z[:, lo:hi], y)
                self.region_qdas[key] = QDAClassifier().fit(z[:, lo:hi], y)
        for k, v in accs.items():
            print(f"{k.upper()} validation accuracy = {v:.4f}")
        return accs

    def predict(self, z, model: str = "qda") -> np.ndarray:
        z = np.atleast_2d(z)
        if model == "mlp":
            return self.mlp.predict(z)
        return {"svm": self.svm, "lda": self.lda,
                "qda": self.qda}[model].predict(z)

    def lda_transform(self, z) -> np.ndarray:
        return self.lda.transform_sklearn_style(z) \
            if hasattr(self.lda, "_sklearn_transform") \
            else self.lda.transform(z)

    def mahalanobis(self, z, class_idx: int, region: str = "all") -> float:
        qda = self.qda if region == "all" else self.region_qdas[region]
        zz = np.asarray(z).reshape(-1)
        if region != "all":
            lo, hi = self.latent_regions[region]
            if zz.shape[0] == self.latent_size:
                zz = zz[lo:hi]
        return qda.mahalanobis(zz, class_idx)

    def qda_sample(self, class_idx: int, n: int = 1, seed: int = 0):
        return self.qda.sample(class_idx, n, seed)

    # -- persistence --------------------------------------------------------
    def save(self, checkpoint_dir: str):
        """``classifiers.npz`` in the JAX package's key layout."""
        os.makedirs(checkpoint_dir, exist_ok=True)
        arrays = {}
        if self.svm is not None:
            arrays.update(self.svm.to_arrays("svm_"))
        if self.lda is not None:
            arrays.update(self.lda.to_arrays("lda_"))
        if self.qda is not None:
            arrays.update(self.qda.to_arrays("qda_"))
        if self.region_ldas:
            for i, (k, c) in enumerate(self.region_ldas.items()):
                arrays.update(c.to_arrays(f"rlda{i}_"))
            arrays["region_keys"] = np.asarray(list(self.region_ldas.keys()))
        if self.region_qdas:
            for i, (k, c) in enumerate(self.region_qdas.items()):
                arrays.update(c.to_arrays(f"rqda{i}_"))
        if self.mlp is not None:
            for i, layer in enumerate(self.mlp.params):
                arrays[f"mlp{i}_w"] = layer["w"]
                arrays[f"mlp{i}_b"] = layer["b"]
        np.savez(os.path.join(checkpoint_dir, "classifiers.npz"), **arrays)

    def load(self, checkpoint_dir: str):
        path = os.path.join(checkpoint_dir, "classifiers.npz")
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        with np.load(path, allow_pickle=False) as npz:
            z = dict(npz)
        if "svm_w" in z:
            self.svm = LinearSVM.from_arrays(z, "svm_")
        if "lda_means" in z:
            self.lda = LDAClassifier.from_arrays(z, "lda_")
        if "qda_means" in z:
            self.qda = QDAClassifier.from_arrays(z, "qda_")
        if "region_keys" in z:
            keys = [str(k) for k in z["region_keys"]]
            self.region_ldas = {
                k: LDAClassifier.from_arrays(z, f"rlda{i}_")
                for i, k in enumerate(keys)}
            self.region_qdas = {
                k: QDAClassifier.from_arrays(z, f"rqda{i}_")
                for i, k in enumerate(keys)}
        if "mlp0_w" in z:
            layers = []
            i = 0
            while f"mlp{i}_w" in z:
                layers.append({"w": z[f"mlp{i}_w"], "b": z[f"mlp{i}_b"]})
                i += 1
            self.mlp = MLPTrainer.from_params(
                layers, device=self.device, lr=self.mlp_lr,
                epochs=self.mlp_epochs)
        return self

    # -- reference interop ----------------------------------------------
    def load_reference_pickles(self, checkpoint_dir: str):
        """Import the reference's saved classifiers
        ({lda,qda,svm}_classifier.pkl, region_{ldas,qdas}.pkl,
        mlp_classifier.pt — reference model_manager.py:708-725). Unpickling
        an sklearn estimator needs ``sklearn``."""
        for name, attr, cls in (("lda_classifier.pkl", "lda", LDAClassifier),
                                ("qda_classifier.pkl", "qda", QDAClassifier),
                                ("svm_classifier.pkl", "svm", LinearSVM)):
            path = os.path.join(checkpoint_dir, name)
            if os.path.exists(path):
                with open(path, "rb") as f:
                    setattr(self, attr, cls.from_sklearn(pickle.load(f)))
        mlp_path = os.path.join(checkpoint_dir, "mlp_classifier.pt")
        if os.path.exists(mlp_path):
            from ..training.torch_import import import_reference_mlp
            self.mlp = MLPTrainer.from_params(
                import_reference_mlp(mlp_path), device=self.device)
        for name, attr, cls in (
                ("region_ldas.pkl", "region_ldas", LDAClassifier),
                ("region_qdas.pkl", "region_qdas", QDAClassifier)):
            path = os.path.join(checkpoint_dir, name)
            if os.path.exists(path):
                with open(path, "rb") as f:
                    ref = pickle.load(f)
                setattr(self, attr,
                        {k: cls.from_sklearn(v) for k, v in ref.items()})
        return self

    def save_reference_pickles(self, checkpoint_dir: str):
        """Inverse of load_reference_pickles: every fitted LDA/QDA/SVM
        (global and per region) as sklearn pickles under the reference's
        file names."""
        os.makedirs(checkpoint_dir, exist_ok=True)
        for name, head in (("lda_classifier.pkl", self.lda),
                           ("qda_classifier.pkl", self.qda),
                           ("svm_classifier.pkl", self.svm)):
            if head is not None:
                with open(os.path.join(checkpoint_dir, name), "wb") as f:
                    pickle.dump(head.to_sklearn(), f)
        for name, attr in (("region_ldas.pkl", "region_ldas"),
                           ("region_qdas.pkl", "region_qdas")):
            regions = getattr(self, attr, None)
            if regions:
                with open(os.path.join(checkpoint_dir, name), "wb") as f:
                    pickle.dump({k: v.to_sklearn()
                                 for k, v in regions.items()}, f)
        return self

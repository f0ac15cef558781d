"""Diagnosis uncertainty via VAE posterior sampling (counterpart of
``analysis/uncertainty.py``).

Sample ``z_k ~ q(z|x) = N(mu, diag(exp(logvar)))``, classify every
sample with the QDA head, and summarize the spread per scan: the share of
samples that agree with the point diagnosis, per-class votes, the
mean/std of the sample posteriors and the predictive entropy of their
mean.

The noise of row ``i`` of a chunk is drawn on the host from a generator
seeded by ``(seed, i)`` (``sample_eps``), so a row's draws do not depend
on the bucket it is padded into, and the card and the host draw the same
numbers. JAX folds its key per row instead (``fold_in(key, i)``), which a
torch generator cannot reproduce: the program therefore also takes
``eps`` as an input, and the parity tests pass it JAX's draws.
"""

from __future__ import annotations

import numpy as np
import torch

from .saliency import _norm_tensors, make_qda_log_posterior

__all__ = ["make_uncertainty_fn", "sample_eps", "summarize_uncertainty",
           "summarize_ensemble"]


def sample_eps(seed: int, rows: int, n_samples: int, zdim: int
               ) -> torch.Tensor:
    """``[rows, n_samples, zdim]`` standard normal draws on the host, row
    ``i`` from its own generator seeded by ``(seed, i)``."""
    out = torch.empty((rows, n_samples, zdim))
    for i in range(rows):
        seq = np.random.SeedSequence([int(seed) % 2 ** 32, i])
        g = torch.Generator().manual_seed(int(seq.generate_state(1)[0]))
        out[i] = torch.randn((n_samples, zdim), generator=g)
    return out


def make_uncertainty_fn(manager, normalization: dict | None, qda,
                        n_samples: int):
    """``fn(x_raw, seed=0, eps=None)``: raw ``[B, N, 3]`` → ``(mu [B, Z],
    lp_mu [B, C], sample_lp [B, K, C], sample_pred [B, K], z [B, K, Z])``,
    class positions indexing ``qda.classes``. ``eps [B, K, Z]``, when
    given, replaces the seeded draws."""
    if not manager.net_config.is_vae:
        raise ValueError(
            "posterior-sampling uncertainty requires a VAE run "
            "(kl_weight > 0) — an AE encoder has no posterior to sample")
    if int(n_samples) < 1:
        raise ValueError(f"n_samples must be >= 1; got {n_samples}")
    model = manager.model
    dev = manager.device
    mean, std = _norm_tensors(normalization, dev)
    log_post = make_qda_log_posterior(qda, dev)
    k = int(n_samples)

    def fn(x_raw, seed: int = 0, eps=None):
        xn = (x_raw - mean) / std
        mu, logvar = model.encode(xn.transpose(0, 1))
        sigma = torch.exp(0.5 * logvar)
        b, zdim = mu.shape
        if eps is None:
            eps = sample_eps(seed, b, k, zdim)
        eps = torch.as_tensor(eps, dtype=torch.float32).to(dev)
        z = mu[:, None, :] + eps * sigma[:, None, :]
        sample_lp = log_post(z.reshape(-1, zdim)).reshape(b, k, -1)
        sample_pred = torch.argmax(sample_lp, dim=-1).to(torch.int32)
        return mu, log_post(mu), sample_lp, sample_pred, z

    return fn


def _softmax(lp: np.ndarray) -> np.ndarray:
    p = np.exp(lp - lp.max(axis=-1, keepdims=True))
    return p / p.sum(axis=-1, keepdims=True)


def summarize_uncertainty(lp_mu, sample_lp, sample_pred, qda_classes,
                          idx2class) -> list:
    """Per-scan summaries on the host: ``label`` (the point diagnosis),
    ``label_agreement``, ``sample_votes``, ``posterior_mean``,
    ``posterior_std``, ``predictive_entropy_nats`` and ``n_samples``
    (``qda_classes``: the QDA's class labels; ``idx2class``: label index
    → class letter)."""
    lp_mu = np.asarray(lp_mu, np.float64)
    sample_lp = np.asarray(sample_lp, np.float64)
    if sample_lp.ndim != 3 or sample_lp.shape[0] != lp_mu.shape[0]:
        raise ValueError(
            f"sample_lp must be [B, K, C] matching lp_mu [B, C]; got "
            f"{sample_lp.shape} vs {lp_mu.shape}")
    sample_pred = np.asarray(sample_pred)
    labels = [idx2class[int(c)] for c in np.asarray(qda_classes)]
    n_classes = len(labels)
    k = sample_lp.shape[1]

    point_pos = np.argmax(lp_mu, axis=-1)
    sample_post = _softmax(sample_lp)
    mean_post = sample_post.mean(axis=1)
    std_post = sample_post.std(axis=1)
    entropy = np.maximum(
        -np.sum(mean_post * np.log(np.clip(mean_post, 1e-12, None)),
                axis=-1), 0.0)

    out = []
    for i in range(lp_mu.shape[0]):
        votes = np.bincount(sample_pred[i], minlength=n_classes)
        out.append({
            "label": labels[int(point_pos[i])],
            "label_agreement": float(
                (sample_pred[i] == point_pos[i]).mean()),
            "sample_votes": {labels[c]: int(votes[c])
                             for c in range(n_classes)},
            "posterior_mean": {labels[c]: float(mean_post[i, c])
                               for c in range(n_classes)},
            "posterior_std": {labels[c]: float(std_post[i, c])
                              for c in range(n_classes)},
            "predictive_entropy_nats": float(entropy[i]),
            "n_samples": int(k),
        })
    return out


def summarize_ensemble(member_reports) -> list:
    """Cross-member consensus over ``[K][B]`` per-member diagnosis reports
    (each with ``label`` and the QDA ``posteriors``): majority ``label``
    (ties to the alphabetically first), ``member_agreement``,
    ``member_votes``, ``posterior_mean``/``posterior_std`` over members,
    ``predictive_entropy_nats`` of the member-averaged posterior and
    ``n_members``."""
    k = len(member_reports)
    if k == 0:
        raise ValueError("need at least one member's reports")
    b = len(member_reports[0])
    if any(len(r) != b for r in member_reports):
        raise ValueError("members reported different scan counts: "
                         f"{[len(r) for r in member_reports]}")
    classes = list(member_reports[0][0]["posteriors"])
    out = []
    for i in range(b):
        labels = [member_reports[m][i]["label"] for m in range(k)]
        post = np.array([[member_reports[m][i]["posteriors"][c]
                          for c in classes] for m in range(k)], np.float64)
        votes = {c: labels.count(c) for c in sorted(set(labels))}
        top = max(votes.values())
        majority = sorted(c for c, n in votes.items() if n == top)[0]
        mean_post = post.mean(axis=0)
        out.append({
            "label": majority,
            "member_agreement": votes[majority] / k,
            "member_votes": {c: votes.get(c, 0) for c in classes},
            "posterior_mean": {c: float(mean_post[j])
                               for j, c in enumerate(classes)},
            "posterior_std": {c: float(post[:, j].std())
                              for j, c in enumerate(classes)},
            "predictive_entropy_nats": float(max(-np.sum(
                mean_post * np.log(np.clip(mean_post, 1e-12, None))), 0.0)),
            "n_members": k,
        })
    return out

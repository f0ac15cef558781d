"""The port's exact t-SNE (``analysis/tsne.py``) against sklearn 1.9's
``TSNE(method="exact")`` on the CPU, from the same start.

Tolerances: the joint probabilities P within 1e-12 of their largest entry
(float64 sums in another order); the embedding after 250 iterations (the
exaggerated phase alone, sklearn's minimum) and after 300 and 1000, and
the final KL divergence, within 1e-5 relative (the same float32 and
float64 steps as sklearn's; the runs agree bit for bit on this box)."""

import numpy as np
import pytest
import torch
from scipy.spatial.distance import squareform

from craniofacialsd_vae_tpu_torch.analysis import tsne as T


def clusters(n_per: int = 20, dim: int = 6, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.normal(c, 1.0, (n_per, dim))
                           for c in (0.0, 3.0, 6.0)]).astype(np.float32)


@pytest.mark.parametrize("perplexity", [5.0, 30.0])
def test_joint_probabilities_match_sklearn(perplexity):
    from sklearn.manifold._t_sne import _joint_probabilities
    from sklearn.metrics import pairwise_distances

    x = clusters()
    want = squareform(_joint_probabilities(
        pairwise_distances(x, squared=True), perplexity, 0))
    got = T.joint_probabilities(torch.as_tensor(x), perplexity).numpy()
    assert np.abs(got - want).max() <= 1e-12 * want.max()
    np.testing.assert_array_equal(np.diag(got), 0.0)


@pytest.mark.parametrize("max_iter", [250, 300, 1000])
def test_embedding_and_kl_match_sklearn_exact(max_iter):
    from sklearn.manifold import TSNE

    x = clusters()
    y0 = T.random_init(len(x), torch.Generator().manual_seed(1)).numpy()
    want = TSNE(method="exact", init=y0.copy(), max_iter=max_iter,
                random_state=0).fit(x)
    got = T.tsne(x, init=y0, max_iter=max_iter)
    scale = np.abs(want.embedding_).max()
    assert np.abs(got["embedding"] - want.embedding_).max() <= 1e-5 * scale
    assert got["n_iter"] == want.n_iter_
    assert got["kl_divergence"] == pytest.approx(want.kl_divergence_,
                                                 rel=1e-5)


def test_start_from_a_seeded_generator_and_perplexity_bound():
    """The start is ``1e-4 · N(0, 1)`` float32 from the generator, so a
    seed repeats the embedding; sklearn's bound on the perplexity holds."""
    x = clusters(n_per=12)
    a = T.tsne(x, generator=torch.Generator().manual_seed(3), max_iter=300)
    b = T.tsne(x, generator=torch.Generator().manual_seed(3), max_iter=300)
    np.testing.assert_array_equal(a["embedding"], b["embedding"])
    y0 = T.random_init(5, torch.Generator().manual_seed(3))
    assert y0.dtype == torch.float32 and float(y0.abs().max()) < 1e-3
    with pytest.raises(ValueError, match="perplexity"):
        T.tsne(x[:30])
    with pytest.raises(ValueError, match="max_iter"):
        T.tsne(x, max_iter=100)

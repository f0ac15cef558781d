"""The classifier zoo, the diagnosis analyses and the evaluation harness
(counterpart of ``analysis/``): classifiers, the classification metrics,
latent statistics, posterior-sampling uncertainty, saliency, surgical
planning, scan fitting and the ``Tester``."""

from .classifiers import (LatentClassifiers, LDAClassifier, LinearSVM,
                          MLPTrainer, QDAClassifier)
from .tester import TEMPLATE_LANDMARKS_IDX, Tester, compute_latent_stats

__all__ = ["QDAClassifier", "LDAClassifier", "LinearSVM", "MLPTrainer",
           "LatentClassifiers", "TEMPLATE_LANDMARKS_IDX", "Tester",
           "compute_latent_stats"]

"""The classifier zoo and the diagnosis analyses (counterpart of
``analysis/``): classifiers, latent statistics, posterior-sampling
uncertainty, saliency, surgical planning and scan fitting."""

from .classifiers import (LatentClassifiers, LDAClassifier, LinearSVM,
                          MLPTrainer, QDAClassifier)
from .tester import TEMPLATE_LANDMARKS_IDX, compute_latent_stats

__all__ = ["QDAClassifier", "LDAClassifier", "LinearSVM", "MLPTrainer",
           "LatentClassifiers", "TEMPLATE_LANDMARKS_IDX",
           "compute_latent_stats"]

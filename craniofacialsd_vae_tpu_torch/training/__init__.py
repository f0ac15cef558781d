from .losses import (kl_divergence_loss, laplacian_loss,
                     latent_consistency_loss, mse_loss, region_feature_mask,
                     weighted_cross_entropy)
from .trainer import (LOSS_KEYS, LossWeights, assemble_epoch_plans,
                      compute_losses, coupled_adam, make_eval_step,
                      make_scanned_train_epochs, make_scanned_train_step,
                      make_train_step, run_steps, step_draws)

__all__ = ["kl_divergence_loss", "laplacian_loss", "latent_consistency_loss",
           "mse_loss", "region_feature_mask", "weighted_cross_entropy",
           "LOSS_KEYS", "LossWeights", "compute_losses", "coupled_adam",
           "make_eval_step", "make_train_step", "run_steps", "step_draws",
           "assemble_epoch_plans", "make_scanned_train_step",
           "make_scanned_train_epochs"]

from .mlp import MLP, init_mlp, mlp_from_jax, mlp_to_jax
from .sdvae import (SDVAE, SDVAEConfig, SpiralGeometry, init_sdvae,
                    latent_regions, params_from_jax, params_to_jax,
                    reparameterize)

__all__ = ["MLP", "init_mlp", "mlp_from_jax", "mlp_to_jax", "SDVAE",
           "SDVAEConfig", "SpiralGeometry", "init_sdvae", "latent_regions",
           "params_from_jax", "params_to_jax", "reparameterize"]

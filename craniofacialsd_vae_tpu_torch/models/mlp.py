"""MLP latent classifier head (counterpart of ``models/mlp.py``).

A linear stack with ReLU after every layer *including the last*, as the
reference has it: the logits are therefore non-negative, and the argmax
of their log-softmax gives the reference's predicted labels. Parameters
keep the JAX layout, one ``{"w": [n_in, n_out], "b": [n_out]}`` per layer.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .sdvae import Dense

__all__ = ["MLP", "init_mlp", "mlp_from_jax", "mlp_to_jax"]


class MLP(nn.Module):
    def __init__(self, in_features: int, hidden_features, out_classes: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        feats = [in_features] + list(hidden_features) + [out_classes]
        self.layers = nn.ModuleList(
            Dense(generator, feats[i - 1], feats[i])
            for i in range(1, len(feats)))

    def forward(self, x: torch.Tensor):
        """Returns (logits [..., n_classes], predicted labels [...])."""
        h = x
        for layer in self.layers:
            h = torch.relu(layer(h))
        return h, torch.argmax(torch.log_softmax(h, dim=-1), dim=-1)


def init_mlp(in_features: int, hidden_features, out_classes: int,
             generator: torch.Generator | None = None) -> MLP:
    """A head with weights drawn on the host from ``generator``."""
    return MLP(in_features, hidden_features, out_classes, generator)


def mlp_from_jax(layers: list) -> dict:
    """The JAX head's list of ``{"w", "b"}`` → a ``state_dict`` for
    ``MLP``."""
    sd = {}
    for i, layer in enumerate(layers):
        sd[f"layers.{i}.w"] = torch.from_numpy(
            np.array(layer["w"], dtype=np.float32))
        sd[f"layers.{i}.b"] = torch.from_numpy(
            np.array(layer["b"], dtype=np.float32))
    return sd


def mlp_to_jax(state_dict: dict) -> list:
    """An ``MLP`` ``state_dict`` → the JAX head's list of ``{"w", "b"}``."""
    n = len({k.split(".")[1] for k in state_dict})
    return [{"w": state_dict[f"layers.{i}.w"].detach().cpu().numpy().astype(
                np.float32, copy=True),
             "b": state_dict[f"layers.{i}.b"].detach().cpu().numpy().astype(
                np.float32, copy=True)}
            for i in range(n)]

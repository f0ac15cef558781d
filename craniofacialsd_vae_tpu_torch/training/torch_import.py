"""The reference's torch checkpoints, both ways (counterpart of
``training/torch_import.py``).

The reference saves ``torch.save({'model': net.state_dict()},
model_<epoch>.pt)`` (reference model_manager.py:682-696) with keys

    en_layers.{i}.conv.layer.{weight,bias}   i < L          (SpiralEnblock)
    en_layers.{L}.{weight,bias}              first latent Linear
    en_layers.{L+1}.{weight,bias}            second latent Linear (VAE only)
    de_layers.0.{weight,bias}                latent → features Linear
    de_layers.{j}.conv.layer.{weight,bias}   1 ≤ j ≤ L      (SpiralDeblock)
    de_layers.{L+1}.layer.{weight,bias}      final SpiralConv

where L = len(out_channels). Both sides are torch ``state_dict``s, so the
mapping is a renaming plus one transpose per weight: ``nn.Linear`` stores
``[out, in]``, the port's ``Dense`` and spiral weights ``[in, out]``
(the JAX layout). The spiral flatten order (sequence-major,
channel-minor) and the latent heads' vertex-major flatten are the same
on both sides. Under ``is_vae`` the encoder's *last* appended Linear is
mu and the first logvar (reference model.py:114-119, 146-158).

The reference's Adam state (``optimizer.pt``) holds one entry per
parameter in the reference's registration order; the port's
``torch.optim.Adam`` holds the same raw moments per parameter, so they
map one to one by name, with the weights' moments transposed.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["import_reference_checkpoint", "export_reference_checkpoint",
           "import_reference_mlp", "import_reference_optimizer",
           "export_reference_optimizer", "reference_names"]


def _load_state_dict(path_or_sd, payload_key: str):
    if isinstance(path_or_sd, (str, bytes)):
        sd = torch.load(path_or_sd, map_location="cpu", weights_only=True)
    else:
        sd = path_or_sd
    if isinstance(sd, dict) and payload_key in sd:
        sd = sd[payload_key]
    return sd


def _tensor(t) -> torch.Tensor:
    if torch.is_tensor(t):
        return t.detach().cpu().to(torch.float32)
    return torch.from_numpy(np.array(t, dtype=np.float32))


def reference_names(config) -> list:
    """``[(reference prefix, port prefix)]`` in the reference's
    ``model.parameters()`` order; each prefix names one Linear (weight
    then bias)."""
    n = len(config.out_channels)
    pairs = [(f"en_layers.{i}.conv.layer", f"en_convs.{i}")
             for i in range(n)]
    if config.is_vae:
        pairs += [(f"en_layers.{n}", "logvar"), (f"en_layers.{n + 1}", "mu")]
    else:
        pairs.append((f"en_layers.{n}", "mu"))
    pairs.append(("de_layers.0", "de_dense"))
    pairs += [(f"de_layers.{j + 1}.conv.layer", f"de_convs.{j}")
              for j in range(n)]
    pairs.append((f"de_layers.{n + 1}.layer", "final_conv"))
    return pairs


def _leaves(config) -> list:
    """``[(reference key, port key, transpose)]`` in the reference's
    parameter order."""
    out = []
    for ref, port in reference_names(config):
        out.append((ref + ".weight", port + ".w", True))
        out.append((ref + ".bias", port + ".b", False))
    return out


def import_reference_checkpoint(path_or_sd, config) -> dict:
    """Reference ``model_*.pt`` (a path, a state dict or a ``{'model':
    state_dict}`` wrapper) → a ``state_dict`` for the port's ``SDVAE``.
    ``KeyError`` on a missing key, ``ValueError`` on keys left over (an
    architecture other than ``config``'s)."""
    sd = _load_state_dict(path_or_sd, "model")
    out, used = {}, set()
    for ref, port, transpose in _leaves(config):
        if ref not in sd:
            raise KeyError(
                f"reference checkpoint is missing '{ref}' — architecture "
                f"mismatch with this config (have keys like "
                f"{sorted(sd)[:4]}…)")
        t = _tensor(sd[ref])
        out[port] = (t.T if transpose else t).contiguous()
        used.add(ref)
    unused = set(sd) - used
    if unused:
        raise ValueError(
            f"reference checkpoint has {len(unused)} unconsumed keys "
            f"(e.g. {sorted(unused)[:3]}) — is_vae/out_channels mismatch "
            "with this config")
    return out


def export_reference_checkpoint(state_dict: dict, config, path: str) -> None:
    """A port ``SDVAE`` ``state_dict`` → reference-named
    ``torch.save({'model': ...})``."""
    sd = {}
    for ref, port, transpose in _leaves(config):
        t = _tensor(state_dict[port])
        sd[ref] = (t.T if transpose else t).contiguous().clone()
    torch.save({"model": sd}, path)


def import_reference_optimizer(path_or_sd, model, config,
                               optimizer: torch.optim.Optimizer) -> None:
    """Reference ``optimizer.pt`` (``torch.save({'optimizer':
    torch.optim.Adam(...).state_dict()})``) → the state of ``optimizer``,
    a ``torch.optim.Adam`` over ``model``'s parameters: each parameter's
    ``step``, ``exp_avg`` and ``exp_avg_sq``, weights' moments
    transposed."""
    sd = _load_state_dict(path_or_sd, "optimizer")
    state = {int(k): v for k, v in sd["state"].items()}
    leaves = _leaves(config)
    if len(state) != len(leaves):
        raise ValueError(
            f"reference optimizer has state for {len(state)} params, this "
            f"architecture has {len(leaves)} — config mismatch")
    steps = {float(_tensor(v["step"])) for v in state.values()}
    if len(steps) != 1:
        raise ValueError(f"per-param torch steps disagree ({steps})")
    step = steps.pop()
    params = dict(model.named_parameters())
    for idx, (_, port, transpose) in enumerate(leaves):
        p = params[port]
        moments = {}
        for key in ("exp_avg", "exp_avg_sq"):
            m = _tensor(state[idx][key])
            m = m.T if transpose else m
            if tuple(m.shape) != tuple(p.shape):
                raise ValueError(
                    f"optimizer moment {idx} ({key}) has shape "
                    f"{tuple(m.shape)}, {port} is {tuple(p.shape)} — "
                    "architecture mismatch")
            moments[key] = m.contiguous().to(p.device)
        optimizer.state[p] = {"step": torch.tensor(step), **moments}


def export_reference_optimizer(optimizer: torch.optim.Optimizer, model,
                               config, path: str, lr: float,
                               weight_decay: float = 0.0) -> None:
    """Inverse of ``import_reference_optimizer``: ``torch.save({'optimizer':
    ...})`` loadable by the reference's ``torch.optim.Adam(
    model.parameters(), ...).load_state_dict``. ``lr`` and
    ``weight_decay`` are written into its param group, since torch's
    ``load_state_dict`` takes the saved hyperparameters over the live
    ones."""
    params = dict(model.named_parameters())
    state, idxs = {}, []
    for idx, (_, port, transpose) in enumerate(_leaves(config)):
        st = optimizer.state[params[port]]
        m, v = _tensor(st["exp_avg"]), _tensor(st["exp_avg_sq"])
        if transpose:
            m, v = m.T, v.T
        state[idx] = {"step": torch.tensor(float(st["step"])),
                      "exp_avg": m.contiguous().clone(),
                      "exp_avg_sq": v.contiguous().clone()}
        idxs.append(idx)
    group = {"params": idxs, "lr": float(lr), "betas": (0.9, 0.999),
             "eps": 1e-8, "weight_decay": float(weight_decay),
             "amsgrad": False, "maximize": False, "foreach": None,
             "capturable": False, "differentiable": False, "fused": None,
             "decoupled_weight_decay": False}
    torch.save({"optimizer": {"state": state, "param_groups": [group]}},
               path)


def import_reference_mlp(path_or_sd) -> list:
    """Reference ``mlp_classifier.pt`` (model_manager.py:708-711) → the
    head's layers in the JAX layout (``[{"w": [in, out], "b": [out]}]``,
    float32 numpy). The reference's Sequential interleaves Linear and
    ReLU, so the Linears sit at even indices: ``model.{2i}.weight``."""
    sd = _load_state_dict(path_or_sd, "model")
    layers = []
    i = 0
    while f"model.{2 * i}.weight" in sd:
        layers.append({
            "w": _tensor(sd[f"model.{2 * i}.weight"]).T.contiguous().numpy(),
            "b": _tensor(sd[f"model.{2 * i}.bias"]).numpy(),
        })
        i += 1
    if not layers:
        raise KeyError(
            f"no 'model.{{2i}}.weight' keys found (have {sorted(sd)[:4]}…) "
            "— not a reference MLPClassifier checkpoint")
    return layers

"""Checkpoints in the JAX package's layout (counterpart of
``training/checkpoint.py``), so that a run dir written by either package
resumes in the other.

One ``model_%08d.ckpt`` per save holds ``{"params", "clf_params"}`` and a
single rolling ``optimizer.ckpt`` holds ``{"opt_state", "clf_opt_state",
"epoch"}``, each written atomically as flax's msgpack state dict
(``training/msgpack.py``). Resume picks the last model file by name and
parses the epoch from it.

The trees are the JAX ones: the SD-VAE's parameter tree
(``models.params_to_jax``), the MLP head as a list of ``{"w", "b"}`` and
optax's Adam state. ``coupled_adam`` (``training/trainer.py`` of the JAX
package) is ``adam`` alone with decay 0 and ``chain(add_decayed_weights,
adam)`` otherwise, so its state dict is ``{'0': adam, '1': {}}`` or
``{'0': {}, '1': {'0': adam, '1': {}}}``, with ``adam = {"count": int32,
"mu": tree, "nu": tree}``. ``adam_to_optax`` and ``adam_from_optax`` map
that to and from ``torch.optim.Adam``'s ``step``, ``exp_avg`` and
``exp_avg_sq``.
"""

from __future__ import annotations

import os
import re

import numpy as np
import torch

from .msgpack import list_from_state_dict, packb, to_state_dict, unpackb

__all__ = ["save_checkpoint", "latest_checkpoint", "read_checkpoint",
           "tree_from_named", "named_from_tree", "adam_to_optax",
           "adam_from_optax", "MODEL_RE"]

MODEL_RE = re.compile(r"model_(\d{8})\.ckpt$")


def _atomic_write(path: str, data: bytes) -> None:
    """Write via tmp + rename, so that a crash mid-write never leaves a
    partial checkpoint."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def save_checkpoint(checkpoint_dir: str, state: dict, epoch: int,
                    keep_last: int | None = None) -> str:
    """Write ``model_%08d.ckpt`` and ``optimizer.ckpt`` (atomically) from
    ``state = {"params", "clf_params", "opt_state", "clf_opt_state"}``
    (JAX-layout trees, numpy leaves; the head's entries may be None).
    ``epoch`` is 1-based. ``keep_last`` keeps only the newest N model
    files."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    model_path = os.path.join(checkpoint_dir, f"model_{epoch:08d}.ckpt")
    _atomic_write(model_path, packb(to_state_dict(
        {"params": state["params"], "clf_params": state["clf_params"]})))
    _atomic_write(os.path.join(checkpoint_dir, "optimizer.ckpt"),
                  packb(to_state_dict(
                      {"opt_state": state["opt_state"],
                       "clf_opt_state": state["clf_opt_state"],
                       "epoch": int(epoch)})))
    if keep_last is not None:
        models = sorted(f for f in os.listdir(checkpoint_dir)
                        if MODEL_RE.search(f))
        for old in models[:-keep_last]:
            os.remove(os.path.join(checkpoint_dir, old))
    return model_path


def latest_checkpoint(checkpoint_dir: str) -> str | None:
    if not os.path.isdir(checkpoint_dir):
        return None
    models = sorted(f for f in os.listdir(checkpoint_dir)
                    if MODEL_RE.search(f))
    return os.path.join(checkpoint_dir, models[-1]) if models else None


def read_checkpoint(path: str):
    """The raw state dict of a checkpoint file (maps keyed as written)."""
    with open(path, "rb") as f:
        return unpackb(f.read())


# ------------------------------------------------------------ named trees
def _is_index(part: str) -> bool:
    return part.isdigit()


def tree_from_named(named: dict):
    """``{"en_convs.0.w": a, …}`` → ``{"en_convs": [{"w": a, …}], …}``:
    dotted names to a nested tree, numeric parts as list indices."""
    root: dict = {}
    for name, value in named.items():
        node, parts = root, name.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(_is_index(k) for k in node):
            return list_from_state_dict(node)
        return node

    return listify(root)


def named_from_tree(tree, prefix: str = "") -> dict:
    """The inverse of ``tree_from_named``; also reads state dicts, whose
    lists are ``{'0': …}`` maps (taken in integer key order)."""
    out = {}
    if isinstance(tree, dict):
        keys = list(tree)
        if keys and all(isinstance(k, str) and _is_index(k) for k in keys):
            items = enumerate(list_from_state_dict(tree))
        else:
            items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    for k, v in items:
        out.update(named_from_tree(v, f"{prefix}{k}."))
    return out


# ------------------------------------------------------------ Adam state
def adam_to_optax(optimizer: torch.optim.Adam, named_params: dict,
                  weight_decay: float, root: str | None = None) -> dict:
    """A ``torch.optim.Adam``'s state → optax's ``coupled_adam`` state dict
    (numpy leaves). ``named_params``: ``{name: parameter}`` in the tree's
    naming; ``root`` drops a leading name part (the head's ``layers``).
    A parameter with no state yet (no step taken) gives zero moments."""
    counts = set()
    mu, nu = {}, {}
    for name, p in named_params.items():
        st = optimizer.state.get(p, {})
        counts.add(int(st["step"]) if "step" in st else 0)
        zeros = np.zeros(tuple(p.shape), np.float32)
        mu[name] = (st["exp_avg"].detach().cpu().numpy().astype(np.float32)
                    if "exp_avg" in st else zeros)
        nu[name] = (st["exp_avg_sq"].detach().cpu().numpy().astype(
            np.float32) if "exp_avg_sq" in st else zeros)
    if len(counts) > 1:
        raise ValueError(f"the parameters have taken different numbers of "
                         f"Adam steps ({sorted(counts)}); optax keeps one "
                         "count")
    mu_t, nu_t = tree_from_named(mu), tree_from_named(nu)
    if root is not None:
        mu_t, nu_t = mu_t[root], nu_t[root]
    adam = {"count": np.asarray(counts.pop() if counts else 0, np.int32),
            "mu": mu_t, "nu": nu_t}
    inner = {"0": adam, "1": {}}
    return {"0": {}, "1": inner} if weight_decay else inner


def _adam_part(state, weight_decay: float) -> dict:
    """The ``scale_by_adam`` state inside a ``coupled_adam`` state dict;
    raises ``ValueError`` when the layout is not the one ``weight_decay``
    gives."""
    try:
        inner = state
        if weight_decay:
            if state["0"] != {} or set(state) != {"0", "1"}:
                raise KeyError("0")
            inner = state["1"]
        if set(inner) != {"0", "1"} or inner["1"] != {}:
            raise KeyError("1")
        adam = inner["0"]
        if set(adam) != {"count", "mu", "nu"}:
            raise KeyError("count")
        return adam
    except (KeyError, TypeError):
        raise ValueError(
            f"the optimizer state is not coupled_adam's with weight decay "
            f"{weight_decay}") from None


def adam_from_optax(optimizer: torch.optim.Adam, named_params: dict,
                    state, weight_decay: float,
                    root: str | None = None) -> None:
    """Load optax's ``coupled_adam`` state dict into ``optimizer``
    (``named_params`` as for ``adam_to_optax``). Raises ``ValueError``
    (and leaves the optimizer as it was) when the layout, the names or a
    shape do not match."""
    adam = _adam_part(state, weight_decay)
    count = int(np.asarray(adam["count"]))
    moments = []
    for key in ("mu", "nu"):
        tree = adam[key] if root is None else {root: adam[key]}
        moments.append(named_from_tree(tree))
    mu, nu = moments
    if set(mu) != set(named_params) or set(nu) != set(named_params):
        raise ValueError(f"optimizer state names {sorted(mu)} do not match "
                         f"the parameters {sorted(named_params)}")
    for name, p in named_params.items():
        for m in (mu[name], nu[name]):
            if tuple(np.shape(m)) != tuple(p.shape):
                raise ValueError(f"optimizer state {name}: shape "
                                 f"{np.shape(m)} vs parameter "
                                 f"{tuple(p.shape)}")
    for name, p in named_params.items():
        if count == 0:
            optimizer.state.pop(p, None)
            continue
        # a capturable Adam keeps its count on the parameter's device
        capturable = optimizer.defaults.get("capturable", False)
        optimizer.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32,
                                 device=p.device if capturable else None),
            "exp_avg": torch.as_tensor(np.asarray(mu[name], np.float32)).to(
                p.device).clone(),
            "exp_avg_sq": torch.as_tensor(np.asarray(nu[name],
                                                     np.float32)).to(
                p.device).clone()}

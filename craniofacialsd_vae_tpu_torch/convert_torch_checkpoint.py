"""Convert a reference torch checkpoint into the JAX package's checkpoint
format, or back (counterpart of ``tools/convert_torch_checkpoint.py``).

    python -m craniofacialsd_vae_tpu_torch.convert_torch_checkpoint \\
        --torch_model /path/to/model_00000600.pt \\
        --config configurations/craniofacial.yaml \\
        --out outputs/imported/checkpoints \\
        [--torch_mlp /path/to/mlp_classifier.pt] \\
        [--torch_opt /path/to/optimizer.pt] [--epoch 600] [--reverse]

Forward mode writes ``model_%08d.ckpt`` (flax's msgpack, the layout of
``training/checkpoint.py``, which either package resumes) into --out.
With --torch_opt the reference's Adam moments go into optimizer.ckpt
(mid-training continuation); without it Adam starts fresh, as the
reference's does when only the net's weights are present.

--reverse converts the latest checkpoint in --out back into a
reference-named ``torch.save({'model': ...})`` at --torch_model (and its
``optimizer.ckpt`` into ``<torch_model>_optimizer.pt``), loadable by the
reference's ``Model.load_state_dict``.

It runs on the host, over ``training/torch_import.py`` and the port's
msgpack codec, with no flax and no pyyaml.
"""

from __future__ import annotations

import argparse
import os
import re

import numpy as np
import torch


class _Named:
    """A state dict's tensors as the parameters ``torch_import``'s
    optimizer functions read from a model (``named_parameters``)."""

    def __init__(self, state_dict: dict):
        self.params = {k: torch.nn.Parameter(torch.as_tensor(
            np.asarray(v, np.float32)).clone()) for k, v in
            state_dict.items()}

    def named_parameters(self):
        return iter(self.params.items())


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--torch_model", required=True,
                        help="reference model_*.pt (input, or output "
                             "with --reverse)")
    parser.add_argument("--config", required=True,
                        help="yaml config describing the architecture")
    parser.add_argument("--out", required=True,
                        help="checkpoint dir (output, or input with "
                             "--reverse)")
    parser.add_argument("--torch_mlp", default=None,
                        help="optional reference mlp_classifier.pt to "
                             "import as the end2end head")
    parser.add_argument("--torch_opt", default=None,
                        help="optional reference optimizer.pt: converts "
                             "the Adam moments too, for mid-training "
                             "continuation")
    parser.add_argument("--epoch", type=int, default=None,
                        help="epoch stamped into the output filename "
                             "(default: parsed from the torch filename, "
                             "else 0)")
    parser.add_argument("--reverse", action="store_true",
                        help="our checkpoint → reference torch format")
    args = parser.parse_args(argv)

    from .models import SDVAEConfig, params_to_jax
    from .training import coupled_adam
    from .training.checkpoint import (_atomic_write, adam_from_optax,
                                      adam_to_optax, latest_checkpoint,
                                      named_from_tree, read_checkpoint)
    from .training.msgpack import packb, to_state_dict
    from .training.torch_import import (export_reference_checkpoint,
                                        export_reference_optimizer,
                                        import_reference_checkpoint,
                                        import_reference_mlp,
                                        import_reference_optimizer)
    from .utils import get_config

    cfg = get_config(args.config)
    config = SDVAEConfig.from_dict(cfg["model"],
                                   cfg["optimization"]["kl_weight"])
    lr = float(cfg["optimization"]["lr"])
    wd = float(cfg["optimization"]["weight_decay"])

    if args.reverse:
        path = latest_checkpoint(args.out)
        if path is None:
            raise SystemExit(f"no model_*.ckpt under {args.out}")
        named = _Named(named_from_tree(read_checkpoint(path)["params"]))
        export_reference_checkpoint(named.params, config, args.torch_model)
        msg = f"{path} → {args.torch_model} (reference torch format)"
        opt_ckpt = os.path.join(args.out, "optimizer.ckpt")
        if os.path.exists(opt_ckpt):
            optimizer = coupled_adam(named.params.values(), lr, wd)
            adam_from_optax(optimizer, named.params,
                            read_checkpoint(opt_ckpt)["opt_state"], wd)
            opt_out = os.path.splitext(args.torch_model)[0] \
                + "_optimizer.pt"
            export_reference_optimizer(optimizer, named, config, opt_out,
                                       lr, wd)
            msg += f" + {opt_out}"
        print(msg)
        return

    state_dict = import_reference_checkpoint(args.torch_model, config)
    clf_params = (import_reference_mlp(args.torch_mlp)
                  if args.torch_mlp else None)
    opt_state = None
    if args.torch_opt:
        named = _Named(state_dict)
        optimizer = coupled_adam(named.params.values(), lr, wd)
        import_reference_optimizer(args.torch_opt, named, config, optimizer)
        opt_state = adam_to_optax(optimizer, named.params, wd)

    epoch = args.epoch
    if epoch is None:
        m = re.search(r"model_(\d+)\.pt$",
                      os.path.basename(args.torch_model))
        epoch = int(m.group(1)) if m else 0
    os.makedirs(args.out, exist_ok=True)
    out_path = os.path.join(args.out, f"model_{epoch:08d}.ckpt")
    _atomic_write(out_path, packb(to_state_dict(
        {"params": params_to_jax(state_dict), "clf_params": clf_params})))
    if opt_state is not None:
        _atomic_write(os.path.join(args.out, "optimizer.ckpt"),
                      packb(to_state_dict(
                          {"opt_state": opt_state, "clf_opt_state": None,
                           "epoch": epoch})))
    print(f"{args.torch_model} → {out_path}"
          + (f" (+ MLP head from {args.torch_mlp})" if args.torch_mlp
             else "")
          + (" (+ Adam moments from optimizer.pt)" if opt_state is not None
             else ""))


if __name__ == "__main__":
    main()

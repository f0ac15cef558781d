"""Swap-augmentation visual check (counterpart of the root
``visualize_in_batch.py``)::

    python -m craniofacialsd_vae_tpu_torch.visualize_in_batch
        --template PLY [--region 0] [--out swap_viz] [--device cuda|cpu]

Builds a batch of 4 meshes (the template shifted by 0.05 each) with one
colour a mesh, swaps one region on the device through ``data/swap.py``
(vertices and colours alike) and writes the 16 swapped meshes as
coloured PLYs, ``swap_<identity>_<donor>.ply``: each shows its donor's
region in the donor's colour. Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

__all__ = ["main", "PALETTE"]

PALETTE = np.array([[230, 80, 80, 255], [80, 180, 90, 255],
                    [80, 120, 230, 255], [230, 200, 60, 255]], np.uint8)


def main(argv=None) -> list:
    """Write the 16 PLYs; returns their paths."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", type=str, default="swap_viz")
    parser.add_argument("--region", type=int, default=0)
    parser.add_argument("--template", type=str, required=True,
                        help="a coloured template PLY")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the card)")
    args = parser.parse_args(argv)

    from .data.swap import swap_features
    from .device import resolve_device
    from .geometry import load_template, write_ply

    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    tpl = load_template(args.template)
    n, b = tpl.num_vertices, len(PALETTE)
    batch = np.stack([tpl.pos + 0.05 * i for i in range(b)])
    colors = np.stack([np.tile(PALETTE[i], (n, 1)) for i in range(b)])

    mask = torch.as_tensor(tpl.region_masks()[args.region], device=device)
    x_vm = torch.as_tensor(np.swapaxes(batch, 0, 1), dtype=torch.float32,
                           device=device)
    c_vm = torch.as_tensor(np.swapaxes(colors, 0, 1), dtype=torch.float32,
                           device=device)
    swapped = np.swapaxes(swap_features(x_vm, mask).cpu().numpy(), 0, 1)
    swapped_colors = np.swapaxes(
        swap_features(c_vm, mask).cpu().numpy(), 0, 1).astype(np.uint8)

    paths = []
    for i in range(b * b):
        paths.append(os.path.join(args.out, f"swap_{i // b}_{i % b}.ply"))
        write_ply(paths[-1], swapped[i], tpl.face, swapped_colors[i])
    print(f"wrote {b * b} meshes (swapped region "
          f"{tpl.region_names[args.region]}) → {args.out}")
    return paths


if __name__ == "__main__":
    main()

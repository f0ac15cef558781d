"""Time the port's exact t-SNE (``analysis/tsne.py``) on one card as the
number of latents grows, with its peak device memory.

Run from the root of a checkout, on a machine with one CUDA card::

    python -m craniofacialsd_vae_tpu_torch.tsne_scale
        [--sizes 36,520,1000,...] [--json PATH]

Each size n embeds n latents of the study's width (75), four Gaussian
clusters drawn from ``default_rng(n)``, with the Tester's call
(perplexity 30, 1,000 iterations at most, the start from
``torch.Generator`` seed 0). Per size: the seconds of the joint
probabilities and of the whole embedding (host clock, the card
synchronized), the iterations run and the peak memory the allocator
held. A size that runs out of device memory is recorded as such and ends
the sweep. Prints one JSON line a size.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .analysis import tsne

LATENT = 75
SIZES = (36, 520, 1000, 2000, 4000, 8000, 16000, 24000)


def latents(n: int) -> np.ndarray:
    rng = np.random.default_rng(n)
    centres = rng.normal(0.0, 3.0, (4, LATENT))
    return (centres[np.arange(n) % 4]
            + rng.normal(0.0, 1.0, (n, LATENT))).astype(np.float32)


def one_size(n: int) -> dict:
    dev = torch.device("cuda")
    x = latents(n)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tsne.joint_probabilities(torch.as_tensor(x, device=dev))
    torch.cuda.synchronize()
    p_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = tsne.tsne(x, generator=torch.Generator(device=dev).manual_seed(0),
                    device=dev)
    torch.cuda.synchronize()
    return {"n": n, "p_s": p_s, "tsne_s": time.perf_counter() - t0,
            "n_iter": out["n_iter"], "kl": out["kl_divergence"],
            "finite": bool(np.isfinite(out["embedding"]).all()),
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--sizes", default=",".join(map(str, SIZES)))
    parser.add_argument("--json", metavar="PATH")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("tsne_scale needs a CUDA card", file=sys.stderr)
        return 1
    lines = []
    for n in map(int, args.sizes.split(",")):
        try:
            line = one_size(n)
        except torch.cuda.OutOfMemoryError as e:
            line = {"n": n, "out_of_memory": str(e).splitlines()[0]}
        lines.append(line)
        print(json.dumps(line), flush=True)
        if "out_of_memory" in line:
            break
    if args.json:
        with open(args.json, "w") as f:
            json.dump(lines, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

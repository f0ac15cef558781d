"""Minimal JSONL metrics writer with TensorBoard's ``add_scalar`` /
``add_image`` surface (counterpart of ``viz/logging.py``). The card's
machine has no ``tensorboardX``, so the port's training always logs
through it, to ``<logdir>/metrics.jsonl``."""

from __future__ import annotations

import json
import os
import time

__all__ = ["JsonlWriter"]


class JsonlWriter:
    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self._f = open(os.path.join(logdir, "metrics.jsonl"), "a")

    def add_scalar(self, tag: str, value, step: int | None = None):
        self._f.write(json.dumps(
            {"tag": tag, "value": float(value), "step": step,
             "ts": time.time()}) + "\n")
        self._f.flush()

    def add_image(self, tag: str, img_tensor=None, global_step=None,
                  **kwargs):
        pass  # a JSONL log holds scalars only

    def close(self):
        self._f.close()

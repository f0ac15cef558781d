"""Read what slows K9's tile build inside the eigensolver's set-up.

Run from the root of a checkout, on a machine with one CUDA card::

    python -m craniofacialsd_vae_tpu_torch.k9_tiles_probe [--reps 20]
        [--json PATH]

The eigensolver (``ops.eigh._chebyshev_smallest``) builds the Laplacian
and K9's vertex tiles while a second thread draws the starting panel on
the host (``eigh._draw``, 16,386 × 1,125 normals) and times the build
alone as ``tiles_s``. This probe builds the same tiles (the octasphere of
subdivision 6, as ``chip_smoke.py``'s phase 10) in fresh processes, one
for each state left behind by what ran before:

- ``none``: nothing;
- ``encode_card_float``: TRAVERSAL_FRAMES traversal-sized float32 frames
  (256 × 512) encoded on the card with each chunk uploaded as float32
  and quantised there;
- ``encode_card``: the same frames through ``viz.jpeg.encode_jpegs``
  (quantised on the host, uint8 uploaded);
- ``encode_host``: HOST_FRAMES of them encoded on the host.

In each, ``--reps`` rounds of four builds (``_EllLaplacian``'s own
``tiles_s``): warm (the allocator's cache kept), after ``empty_cache``
alone, after ``empty_cache`` beside the panel draw on a second thread
(the solver's set-up), and after ``empty_cache`` beside the same draw in
a second process (the host's cores shared, no interpreter lock shared).
Each build also records the garbage collections that fell inside it and
the device allocations it made. Then the main thread's stalls while the
draw runs: a loop that reads the clock for DRAW_WINDOW_S, alone, beside
the draw thread and beside the draw process; the sum and the longest of
its gaps over 1 ms.

Prints one JSON line a state (medians, maxima and every value) and, with
``--json``, writes them all to PATH.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import gc
import json
import subprocess
import sys
import time

import numpy as np
import torch

from .geometry import synthetic_template
from .ops import eigh

SUBDIVISIONS, BLOCK, SEED = 6, 1125, 20
STATES = ("none", "encode_card_float", "encode_card", "encode_host")
TRAVERSAL_FRAMES = 900          # a latent-75 traversal's two videos
HOST_FRAMES = 40
FRAME_HW = (256, 512)
DRAW_WINDOW_S = 0.25
DRAW_CHILD = ("import sys, numpy as np; print('go', flush=True); "
              "[np.random.default_rng(0).standard_normal(({n}, {b}), "
              "dtype=np.float32) for _ in range(3)]")


def frames(n: int) -> np.ndarray:
    """``n`` smooth float32 RGB frames in [0, 1], each a shifted ramp."""
    h, w = FRAME_HW
    ramp = (np.arange(h)[:, None, None] / h + np.arange(w)[None, :, None]
            / (2 * w) + np.arange(3) / 3.0).astype(np.float32)
    out = np.empty((n, h, w, 3), np.float32)
    for t in range(n):
        np.mod(ramp + np.float32(t / n), 1.0, out=out[t])
    return out


def leave_state(state: str, dev) -> float:
    """Run what ``state`` names; returns its seconds."""
    from .viz import jpeg

    t0 = time.perf_counter()
    if state == "encode_card_float":
        f = frames(TRAVERSAL_FRAMES)
        step = max(jpeg.CHUNK_PIXELS // (f.shape[1] * f.shape[2]), 1)
        for s0 in range(0, len(f), step):
            chunk = torch.from_numpy(f[s0:s0 + step]).to(dev)
            jpeg.encode_jpegs((chunk.clamp(0, 1) * 255).to(torch.uint8))
    elif state == "encode_card":
        jpeg.encode_jpegs(frames(TRAVERSAL_FRAMES), device=dev)
    elif state == "encode_host":
        jpeg.encode_jpegs(frames(HOST_FRAMES))
    torch.cuda.synchronize()
    return time.perf_counter() - t0


class Collections:
    """The garbage collections (generation, ms) between enter and exit."""

    def __enter__(self):
        self.found, self._t = [], None

        def cb(phase, info):
            if phase == "start":
                self._t = time.perf_counter()
            elif self._t is not None:
                self.found.append((info["generation"], round(
                    (time.perf_counter() - self._t) * 1e3, 3)))
        self._cb = cb
        gc.callbacks.append(cb)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._cb)


def device_allocs() -> int:
    return torch.cuda.memory_stats().get("num_device_alloc", 0)


def build(tpl, dev, how: str) -> dict:
    """One ``_EllLaplacian`` (its ``tiles_s``) as ``how`` says."""
    if how != "warm":
        torch.cuda.empty_cache()
    child = None
    if how == "draw_process":
        child = subprocess.Popen([sys.executable, "-c", DRAW_CHILD.format(
            n=tpl.num_vertices, b=BLOCK)], stdout=subprocess.PIPE, text=True)
        child.stdout.readline()
    a0 = device_allocs()
    with Collections() as gcs:
        if how == "draw_thread":
            with concurrent.futures.ThreadPoolExecutor(1) as pool:
                drawn = pool.submit(eigh._draw, tpl.num_vertices, BLOCK, SEED)
                lap = eigh._EllLaplacian(tpl, dev)
                drawn.result()
        else:
            lap = eigh._EllLaplacian(tpl, dev)
    if child is not None:
        child.kill()
        child.wait()
    return {"tiles_s": lap.tiles_s, "gc": gcs.found,
            "device_allocs": device_allocs() - a0}


def stalls(tpl, beside: str) -> dict:
    """The main thread's gaps over 1 ms while it reads the clock for
    DRAW_WINDOW_S, beside ``beside`` (none, thread or process)."""
    def loop():
        t0 = last = time.perf_counter()
        total, most = 0.0, 0.0
        while last - t0 < DRAW_WINDOW_S:
            now = time.perf_counter()
            if now - last > 1e-3:
                total += now - last
                most = max(most, now - last)
            last = now
        return {"stalled_ms": round(total * 1e3, 3),
                "longest_ms": round(most * 1e3, 3)}

    if beside == "thread":
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            drawn = pool.submit(eigh._draw, tpl.num_vertices, BLOCK, SEED)
            out = loop()
            drawn.result()
        return out
    if beside == "process":
        child = subprocess.Popen([sys.executable, "-c", DRAW_CHILD.format(
            n=tpl.num_vertices, b=BLOCK)], stdout=subprocess.PIPE, text=True)
        child.stdout.readline()
        out = loop()
        child.kill()
        child.wait()
        return out
    return loop()


def probe(state: str, reps: int) -> dict:
    dev = torch.device("cuda")
    tpl = synthetic_template(SUBDIVISIONS, 3)
    eigh._EllLaplacian(tpl, dev)             # the process's first build
    t0 = time.perf_counter()
    t_draw = eigh._draw(tpl.num_vertices, BLOCK, SEED)
    draw_s = time.perf_counter() - t0
    del t_draw
    state_s = leave_state(state, dev)
    hows = ("warm", "cold", "draw_thread", "draw_process")
    runs = {h: [] for h in hows}
    for _ in range(reps):
        for h in hows:
            runs[h].append(build(tpl, dev, h))
    out = {"state": state, "state_s": state_s, "draw_s": draw_s,
           "gc_objects": len(gc.get_objects()), "builds": {}}
    for h, rs in runs.items():
        t = [r["tiles_s"] for r in rs]
        out["builds"][h] = {
            "median_s": float(np.median(t)), "max_s": max(t),
            "over_0.015": sum(v > 0.015 for v in t), "tiles_s": t,
            "with_gc": sum(bool(r["gc"]) for r in rs),
            "gc": [r["gc"] for r in rs if r["gc"]],
            "device_allocs": [r["device_allocs"] for r in rs]}
    out["stalls"] = {b: [stalls(tpl, b) for _ in range(3)]
                     for b in ("none", "thread", "process")}
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--json", metavar="PATH")
    parser.add_argument("--state", choices=STATES,
                        help="probe one state in this process")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("k9_tiles_probe needs a CUDA card", file=sys.stderr)
        return 1
    if args.state:
        print(json.dumps(probe(args.state, args.reps)), flush=True)
        return 0
    lines = []
    for state in STATES:
        got = subprocess.run(
            [sys.executable, "-m", __spec__.name, "--state", state,
             "--reps", str(args.reps)], capture_output=True, text=True)
        if got.returncode != 0:
            print(got.stderr, file=sys.stderr)
            return got.returncode
        line = json.loads(got.stdout.strip().splitlines()[-1])
        lines.append(line)
        short = {h: {k: b[k] for k in ("median_s", "max_s", "over_0.015",
                                       "with_gc")}
                 for h, b in line["builds"].items()}
        print(json.dumps({"state": state, "state_s": line["state_s"],
                          "draw_s": line["draw_s"], "builds": short,
                          "stalls": line["stalls"]}), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(lines, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Image files with the standard library alone (the card's machine has
neither PIL nor imageio): 8-bit RGB PNG through ``zlib``, and the frame
strip that stands in for a video.

Float images are quantised as the JAX package's ``Tester._save_image``
does, ``(clip(x, 0, 1) * 255).astype(uint8)`` (truncation, not
rounding).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["to_uint8", "write_png", "write_frame_strip"]

PNG_LEVEL = 1       # zlib level: grids and strips are mostly background


def to_uint8(image: np.ndarray) -> np.ndarray:
    """Float ``[H, W, 3]`` in [0, 1] → uint8, truncated; uint8 passes."""
    image = np.asarray(image)
    if image.dtype == np.uint8:
        return image
    return (np.clip(image, 0, 1) * 255).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, image: np.ndarray) -> str:
    """Write ``image`` (``[H, W, 3]`` float in [0, 1], or uint8) as an
    8-bit RGB PNG; returns ``path``."""
    rgb = to_uint8(image)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"write_png takes [H, W, 3]; got {rgb.shape}")
    h, w, _ = rgb.shape
    # each scanline: filter type 0 (none), then its bytes
    raw = np.zeros((h, 1 + 3 * w), np.uint8)
    raw[:, 1:] = rgb.reshape(h, 3 * w)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", header))
        f.write(_chunk(b"IDAT", zlib.compress(raw.tobytes(), PNG_LEVEL)))
        f.write(_chunk(b"IEND", b""))
    return path


def write_frame_strip(path: str, frames: np.ndarray) -> str:
    """Frames ``[T, H, W, 3]`` that the JAX package writes as a video,
    written as its last resort does: one PNG of the frames side by side,
    ``<name>_strip.png`` beside the video's name. Prints and returns the
    path."""
    strip = path.rsplit(".", 1)[0] + "_strip.png"
    write_png(strip, np.concatenate([to_uint8(f) for f in frames], axis=1))
    print(f"[tester] video frames written as a strip: {strip}")
    return strip

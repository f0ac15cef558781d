"""Image files with the standard library alone (the card's machine has
neither PIL nor imageio): 8-bit RGB and RGBA PNG through ``zlib``.

Float images are quantised as the JAX package's ``Tester._save_image``
does, ``(clip(x, 0, 1) * 255).astype(uint8)`` (truncation, not
rounding).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["to_uint8", "png_bytes", "write_png"]

PNG_LEVEL = 1       # zlib level: grids are mostly background


def to_uint8(image: np.ndarray) -> np.ndarray:
    """Float ``[H, W, 3]`` in [0, 1] → uint8, truncated; uint8 passes."""
    image = np.asarray(image)
    if image.dtype == np.uint8:
        return image
    return (np.clip(image, 0, 1) * 255).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def png_bytes(image: np.ndarray) -> bytes:
    """``image`` (``[H, W, 3|4]`` float in [0, 1], or uint8) as the bytes
    of an 8-bit RGB or RGBA PNG."""
    px = to_uint8(image)
    if px.ndim != 3 or px.shape[2] not in (3, 4):
        raise ValueError(f"a PNG takes [H, W, 3] or [H, W, 4]; got "
                         f"{px.shape}")
    h, w, c = px.shape
    # each scanline: filter type 0 (none), then its bytes
    raw = np.zeros((h, 1 + c * w), np.uint8)
    raw[:, 1:] = px.reshape(h, c * w)
    header = struct.pack(">IIBBBBB", w, h, 8, 2 if c == 3 else 6, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), PNG_LEVEL))
            + _chunk(b"IEND", b""))


def write_png(path: str, image: np.ndarray) -> str:
    """Write ``image`` (``[H, W, 3]`` float in [0, 1], or uint8) as an
    8-bit RGB PNG; returns ``path``."""
    if np.shape(image)[-1:] != (3,) or np.ndim(image) != 3:
        raise ValueError(f"write_png takes [H, W, 3]; got {np.shape(image)}")
    with open(path, "wb") as f:
        f.write(png_bytes(image))
    return path

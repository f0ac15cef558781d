"""Motion-JPEG in an AVI (RIFF) container (counterpart of
``viz/video.py``), its frames encoded by the port's own JPEG encoder
(``viz/jpeg.py``) in one batched pass on the frames' device.

The container is the JAX package's byte for byte: the same ``avih``,
``strh`` and ``strf`` (BITMAPINFOHEADER) layouts, one ``00dc`` chunk a
frame and an ``idx1`` index with every frame a keyframe.
"""

from __future__ import annotations

import struct

import numpy as np

from .jpeg import QUALITY, encode_jpegs

__all__ = ["write_mjpeg_avi", "write_video"]


def _chunk(fourcc: bytes, payload: bytes) -> bytes:
    pad = b"\x00" if len(payload) % 2 else b""
    return fourcc + struct.pack("<I", len(payload)) + payload + pad


def _list(list_type: bytes, payload: bytes) -> bytes:
    return _chunk(b"LIST", list_type + payload)


def write_mjpeg_avi(path: str, frames, fps: float = 4.0,
                    quality: int = QUALITY, device=None) -> str:
    """``frames``: ``[T, H, W, 3]`` RGB, uint8 or float in [0, 1] (numpy
    or torch; ``encode_jpegs``). Writes a standard AVI 1.0 file with an
    ``idx1`` index (every frame a keyframe), its frames encoded on
    ``device`` (default: where the frames are); returns ``path``."""
    jpegs = encode_jpegs(frames, quality, device)
    t, h, w, _ = np.shape(frames)
    max_size = max(len(j) for j in jpegs)
    scale = 1000                        # fps = rate / scale
    rate = int(round(fps * scale))
    avih = struct.pack(
        "<IIIIIIIIIIIIII",
        int(round(1e6 / fps)), int(max_size * fps), 0,
        0x10 | 0x100,                   # AVIF_HASINDEX | AVIF_ISINTERLEAVED
        t, 0, 1, max_size, w, h, 0, 0, 0, 0)
    strh = struct.pack(
        "<4s4sIHHIIIIIIIIhhhh", b"vids", b"MJPG", 0, 0, 0, 0,
        scale, rate, 0, t, max_size, 10000, 0,
        0, 0, np.int16(w), np.int16(h))
    strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, b"MJPG",
                       w * h * 3, 0, 0, 0, 0)
    hdrl = _list(b"hdrl", _chunk(b"avih", avih) + _list(
        b"strl", _chunk(b"strh", strh) + _chunk(b"strf", strf)))
    movi, index, offset = [b"movi"], [], 4
    for j in jpegs:
        frame_chunk = _chunk(b"00dc", j)
        movi.append(frame_chunk)
        index.append(struct.pack("<4sIII", b"00dc", 0x10, offset, len(j)))
        offset += len(frame_chunk)
    riff = b"AVI " + hdrl + _chunk(b"LIST", b"".join(movi)) \
        + _chunk(b"idx1", b"".join(index))
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(riff)) + riff)
    return path


def write_video(path: str, frames, fps: float = 4.0, device=None) -> str:
    """Float frames in [0, 1] (``[T, H, W, 3]``, numpy or torch) as the
    JAX Tester's ``_write_video`` writes them without ffmpeg: quantised as
    ``(clip(x, 0, 1) * 255).astype(uint8)`` and written as ``<name>.avi``
    beside the ``.mp4`` name asked for, encoded on ``device``; returns
    the AVI's path."""
    avi = path.rsplit(".", 1)[0] + ".avi"
    return write_mjpeg_avi(avi, frames, fps=fps, device=device)

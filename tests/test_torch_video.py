"""The port's JPEG encoder and Motion-JPEG AVI writer (``viz/jpeg.py``,
``viz/video.py``) against PIL and the JAX package's ``write_mjpeg_avi``,
on the CPU.

Tolerances: PIL decodes every port JPEG, and on JAX's smooth test frames
(``tests/test_viz.py``'s) the mean absolute error against the frame is at
most PIL's own quality-90 error plus 1; the quantisation tables equal
libjpeg's (as PIL writes them) exactly; the AVI is byte-equal to JAX's
when JAX's frames are encoded by the port's encoder."""

import io
import struct

import numpy as np
import pytest
import torch
from PIL import Image

from craniofacialsd_vae_tpu_torch.viz import jpeg, video


def smooth_frames(n: int = 6) -> np.ndarray:
    """``tests/test_viz.py::TestMJPEGVideo``'s frames: smooth gradients."""
    yy, xx = np.mgrid[0:48, 0:64]
    base = np.stack([yy * 4, xx * 3, (yy + xx) * 2],
                    axis=-1).astype(np.uint8)
    return np.stack([(base * (1 - i / 8)).astype(np.uint8)
                     for i in range(n)])


def _decode(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _pil_jpeg(frame: np.ndarray, quality: int = 90) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def test_jpegs_decode_within_pils_own_error():
    frames = smooth_frames()
    jpegs = jpeg.encode_jpegs(frames)
    assert len(jpegs) == len(frames)
    for data, frame in zip(jpegs, frames):
        assert data[:2] == b"\xff\xd8" and data[-2:] == b"\xff\xd9"
        got = _decode(data)
        assert got.shape == frame.shape
        ours = np.abs(got.astype(int) - frame).mean()
        pils = np.abs(_decode(_pil_jpeg(frame)).astype(int) - frame).mean()
        assert ours <= pils + 1, (ours, pils)


@pytest.mark.parametrize("shape", [(1, 1), (8, 8), (9, 17), (37, 53),
                                   (16, 40)])
def test_any_size_and_noise_decode(shape):
    """Edges padded by replication, 0xFF bytes stuffed: noise (every
    coefficient category, long scans) decodes, within PIL's own error on
    the same frame plus 1."""
    rng = np.random.default_rng(sum(shape))
    frames = rng.integers(0, 256, (3, *shape, 3), dtype=np.uint8)
    for data, frame in zip(jpeg.encode_jpegs(frames), frames):
        got = _decode(data)
        assert got.shape == frame.shape
        ours = np.abs(got.astype(int) - frame).mean()
        pils = np.abs(_decode(_pil_jpeg(frame)).astype(int) - frame).mean()
        assert ours <= pils + 1, (ours, pils)


@pytest.mark.parametrize("quality", [90, 50, 10])
def test_quant_tables_are_libjpegs(quality):
    """The tables written are libjpeg's scaling of the standard ones (PIL
    reads both files' tables in natural order)."""
    frame = smooth_frames(1)[0]
    ours = Image.open(io.BytesIO(jpeg.encode_jpeg(frame, quality)))
    pils = Image.open(io.BytesIO(_pil_jpeg(frame, quality)))
    assert {k: list(v) for k, v in ours.quantization.items()} == \
        {k: list(v) for k, v in pils.quantization.items()}
    np.testing.assert_array_equal(jpeg.quant_tables(quality),
                                  [list(ours.quantization[t])
                                   for t in (0, 1)])


def test_batched_and_single_encodes_agree():
    """One batched pass equals frame-by-frame encodes, also across
    chunks."""
    frames = smooth_frames(5)
    single = [jpeg.encode_jpeg(f) for f in frames]
    assert jpeg.encode_jpegs(frames) == single
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpeg, "CHUNK_PIXELS", 2 * 48 * 64)
        assert jpeg.encode_jpegs(torch.as_tensor(frames)) == single


def test_avi_is_byte_equal_to_jax_with_the_ports_jpegs(tmp_path,
                                                       monkeypatch):
    from craniofacialsd_vae_tpu.viz import video as jvideo

    monkeypatch.setattr(jvideo, "_jpeg_bytes",
                        lambda f, q: jpeg.encode_jpeg(f, q))
    frames = smooth_frames()
    for fps in (4, 2.5):
        jvideo.write_mjpeg_avi(str(tmp_path / "j.avi"), frames, fps=fps)
        video.write_mjpeg_avi(str(tmp_path / "t.avi"), frames, fps=fps)
        assert (tmp_path / "t.avi").read_bytes() == \
            (tmp_path / "j.avi").read_bytes()


def walk_avi(data: bytes) -> dict:
    """The RIFF chunks of an AVI: the ``00dc`` payloads, the ``idx1``
    entries and the ``avih`` frame count."""
    assert data[:4] == b"RIFF" and data[8:12] == b"AVI "
    assert struct.unpack("<I", data[4:8])[0] == len(data) - 8
    out = {"frames": [], "index": [], "total": None}

    def walk(lo, hi):
        pos = lo
        while pos < hi:
            cc = data[pos:pos + 4]
            size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
            body = pos + 8
            if cc == b"LIST":
                walk(body + 4, body + size)
            elif cc == b"00dc":
                out["frames"].append(data[body:body + size])
            elif cc == b"idx1":
                out["index"] = [struct.unpack("<4sIII", data[k:k + 16])
                                for k in range(body, body + size, 16)]
            elif cc == b"avih":
                out["total"] = struct.unpack("<I", data[body + 16:
                                                        body + 20])[0]
            pos = body + size + size % 2

    walk(12, len(data))
    return out


def test_write_video_quantises_like_jax_and_walks(tmp_path):
    """Float frames quantised as JAX's ``_write_video`` does, written as
    ``<name>.avi``: as many ``00dc`` chunks, ``idx1`` entries and
    ``avih`` frames as frames, each payload SOI … EOI."""
    rng = np.random.default_rng(3)
    frames = rng.uniform(-0.2, 1.2, (4, 16, 24, 3)).astype(np.float32)
    path = video.write_video(str(tmp_path / "clip.mp4"), frames, fps=2)
    assert path.endswith("clip.avi")
    walked = walk_avi(open(path, "rb").read())
    assert walked["total"] == len(walked["index"]) \
        == len(walked["frames"]) == 4
    eight = (np.clip(frames, 0, 1) * 255).astype(np.uint8)
    for data, want in zip(walked["frames"], jpeg.encode_jpegs(eight)):
        assert data == want and data[:2] == b"\xff\xd8" \
            and data[-2:] == b"\xff\xd9"

"""Baseline JPEG encoding in torch, for the videos (the card's machine has
neither PIL nor imageio).

``encode_jpegs`` turns ``[T, H, W, 3]`` uint8 RGB frames into T baseline
JFIF files in one batched pass, with no Python loop over blocks or
coefficients, on the frames' device (the card when they are there):

- RGB → YCbCr with libjpeg's fixed-point coefficients (``jccolor.c``),
  4:4:4 (no chroma subsampling), edges padded to 8 by replication;
- the 8 × 8 DCT as two float64 products of an integer-valued DCT matrix
  (scaled by 2^20) with integer samples: every partial sum is an integer
  below 2^53, so the products are exact in any summation order and the
  card's coefficients equal the host's bit for bit;
- quantisation by the standard tables at libjpeg's quality scaling
  (``jpeg_quality_scaling``, baseline-clamped), rounding half away from
  zero as libjpeg does;
- Huffman coding with the standard tables of ITU T.81 Annex K.3: each
  emitted code's bit offset comes from prefix sums, and the codes are
  packed into 32-bit words by index additions (their bits never
  overlap, so a sum is an OR); each frame is padded with 1-bits and
  byte-stuffed (``0xFF`` → ``0xFF 0x00``).
"""

from __future__ import annotations

import struct

import numpy as np
import torch

__all__ = ["encode_jpegs", "encode_jpeg", "quant_tables", "QUALITY"]

QUALITY = 90
CHUNK_PIXELS = 1 << 22      # frames encoded together, to bound memory

_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_CHROMA_Q = np.full(64, 99)
_CHROMA_Q[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = \
    [17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]

# zigzag position k → natural (row-major) index
ZIGZAG = np.array(sorted(range(64), key=lambda n: (
    n // 8 + n % 8, n // 8 if (n // 8 + n % 8) % 2 else -(n // 8))))

# the standard Huffman tables: code counts by length 1..16, then symbols
_DC_BITS = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0],
            [0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0])
_DC_VALS = (list(range(12)), list(range(12)))
_AC_BITS = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d],
            [0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77])
_AC_VALS = (bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a838485868788898a"
    "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6"
    "c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9"
    "fa"), bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa"))


def _huffman_codes(bits, vals, n_symbols: int) -> tuple:
    """Canonical codes of a (bits, vals) table → (code, length) arrays
    indexed by symbol."""
    code = np.zeros(n_symbols, np.int64)
    length = np.zeros(n_symbols, np.int64)
    c, k = 0, 0
    for n_bits, count in enumerate(bits, start=1):
        for _ in range(count):
            code[vals[k]], length[vals[k]] = c, n_bits
            c, k = c + 1, k + 1
        c <<= 1
    return code, length


_DC_CODES = [_huffman_codes(b, v, 12) for b, v in zip(_DC_BITS, _DC_VALS)]
_AC_CODES = [_huffman_codes(b, v, 256) for b, v in zip(_AC_BITS, _AC_VALS)]


def quant_tables(quality: int = QUALITY) -> np.ndarray:
    """``[2, 64]`` luma and chroma tables in natural order at libjpeg's
    scaling of ``quality`` (baseline: entries within 1..255)."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((np.stack([_LUMA_Q, _CHROMA_Q]) * scale + 50) // 100,
                   1, 255)


def _dct_matrix() -> np.ndarray:
    """T.81's 8-point DCT, ``A[u, x] = α(u)/2 · cos((2x+1)uπ/16)``,
    scaled by 2^20 and rounded to integers."""
    u, x = np.mgrid[0:8, 0:8]
    a = 0.5 * np.cos((2 * x + 1) * u * np.pi / 16)
    a[0] *= np.sqrt(0.5)
    return np.round(a * (1 << 20))


def _header(h: int, w: int, q: np.ndarray) -> bytes:
    """SOI, JFIF APP0, the two quantisation tables, SOF0 (3 components,
    no subsampling), the four Huffman tables and SOS."""
    def seg(marker: int, payload: bytes) -> bytes:
        return struct.pack(">HH", marker, len(payload) + 2) + payload

    out = b"\xff\xd8" + seg(0xFFE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01"
                            b"\x00\x00")
    out += seg(0xFFDB, b"".join(bytes([t]) + bytes(q[t][ZIGZAG].tolist())
                                for t in (0, 1)))
    out += seg(0xFFC0, struct.pack(">BHHB", 8, h, w, 3)
               + bytes([1, 0x11, 0, 2, 0x11, 1, 3, 0x11, 1]))
    dht = b""
    for t in (0, 1):
        dht += bytes([t]) + bytes(_DC_BITS[t]) + bytes(_DC_VALS[t])
        dht += bytes([0x10 | t]) + bytes(_AC_BITS[t]) + bytes(_AC_VALS[t])
    out += seg(0xFFC4, dht)
    out += seg(0xFFDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0]))
    return out


def _coefficients(frames: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """uint8 ``[T, H, W, 3]`` → quantised coefficients ``[T, blocks, 3,
    64]`` int32 in zigzag order, blocks in raster order."""
    dev = frames.device
    t, h, w, _ = frames.shape
    x = frames.to(torch.int32)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]

    def fix(c):
        return int(c * 65536 + 0.5)

    off = (128 << 16) + 32767
    ycc = torch.stack([
        (fix(0.299) * r + fix(0.587) * g + fix(0.114) * b + 32768) >> 16,
        (-fix(0.16874) * r - fix(0.33126) * g + 32768 * b + off) >> 16,
        (32768 * r - fix(0.41869) * g - fix(0.08131) * b + off) >> 16],
        dim=-1) - 128
    h8, w8 = -(-h // 8) * 8, -(-w // 8) * 8
    rows = torch.arange(h8, device=dev).clamp_(max=h - 1)
    cols = torch.arange(w8, device=dev).clamp_(max=w - 1)
    ycc = ycc[:, rows][:, :, cols]
    blocks = ycc.reshape(t, h8 // 8, 8, w8 // 8, 8, 3).permute(
        0, 1, 3, 5, 2, 4).reshape(-1, 8, 8).to(torch.float64)
    a = torch.as_tensor(_dct_matrix(), device=dev)
    coef = torch.matmul(torch.matmul(a, blocks), a.T).to(torch.int64)
    coef = coef.reshape(t, -1, 3, 64)
    div = q.to(torch.int64)[torch.tensor([0, 1, 1], device=dev)] << 40
    mag = (coef.abs() + (div >> 1)) // div
    coef = torch.where(coef < 0, -mag, mag)
    return coef[..., torch.as_tensor(ZIGZAG, device=dev)].to(torch.int32)


def _nbits(v: torch.Tensor) -> torch.Tensor:
    """The JPEG magnitude category: bits of |v| (0 for 0)."""
    bounds = torch.tensor([1 << i for i in range(16)], device=v.device)
    return torch.bucketize(v.abs().to(torch.int64), bounds, right=True)


def _extra(v: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    v = v.to(torch.int64)
    return torch.where(v < 0, v + (1 << s) - 1, v)


def _excl(x: torch.Tensor) -> torch.Tensor:
    c = torch.cumsum(x, 0)
    return c - x


def _scans(coef: torch.Tensor) -> list:
    """Entropy-coded, byte-stuffed scans of quantised coefficients
    ``[T, blocks, 3, 64]``, one ``bytes`` per frame."""
    dev = coef.device
    i64 = torch.int64
    n_frames, n_blocks = coef.shape[:2]
    units = n_frames * n_blocks * 3               # MCU order: Y, Cb, Cr
    tab = (torch.arange(units, device=dev) % 3 > 0).to(i64)
    dc_code, dc_len, ac_code, ac_len = (
        torch.as_tensor(np.stack([c[j] for c in table]), device=dev)
        for table in (_DC_CODES, _AC_CODES) for j in (0, 1))

    dc = coef[..., 0]
    diff = (dc - torch.nn.functional.pad(dc, (0, 0, 1, 0))[:, :-1]).reshape(-1)
    ac = coef[..., 1:].reshape(units, 63)
    nz_u, nz_k = (ac != 0).nonzero(as_tuple=True)
    kpos = nz_k + 1
    prev = torch.roll(kpos, 1)
    if len(kpos):
        first = torch.ones_like(nz_u, dtype=torch.bool)
        first[1:] = nz_u[1:] != nz_u[:-1]
        prev = torch.where(first, 0, prev)
    run = kpos - prev - 1
    zrl = run // 16
    per_nz = zrl + 1
    unit_nz = torch.zeros(units, dtype=i64, device=dev).index_add_(
        0, nz_u, per_nz)
    eob = ac[:, 62] == 0
    unit_items = 1 + unit_nz + eob.to(i64)
    unit_start = _excl(unit_items)
    total = int(unit_items.sum())
    slot = unit_start[nz_u] + torch.cumsum(per_nz, 0) - _excl(unit_nz)[nz_u]

    item_len = torch.empty(total, dtype=i64, device=dev)
    item_val = torch.empty(total, dtype=i64, device=dev)
    s = _nbits(diff)
    item_len[unit_start] = dc_len[tab, s] + s
    item_val[unit_start] = (dc_code[tab, s] << s) | _extra(diff, s)
    vals = ac[nz_u, nz_k]
    s = _nbits(vals)
    t = tab[nz_u]
    sym = (run % 16) * 16 + s
    item_len[slot] = ac_len[t, sym] + s
    item_val[slot] = (ac_code[t, sym] << s) | _extra(vals, s)
    if int(zrl.max()) if len(zrl) else 0:
        reps = zrl[zrl > 0]
        base = torch.repeat_interleave(slot[zrl > 0] - reps, reps)
        idx = base + torch.arange(len(base), device=dev) \
            - torch.repeat_interleave(_excl(reps), reps)
        tz = torch.repeat_interleave(t[zrl > 0], reps)
        item_len[idx] = ac_len[tz, 0xF0]
        item_val[idx] = ac_code[tz, 0xF0]
    eu = eob.nonzero(as_tuple=True)[0]
    last = unit_start[eu] + unit_items[eu] - 1
    item_len[last] = ac_len[tab[eu], 0]
    item_val[last] = ac_code[tab[eu], 0]

    # bit offsets: each frame starts on a 32-bit word, ends padded with 1s
    frame_items = unit_items.reshape(n_frames, -1).sum(1)
    frame_of = torch.repeat_interleave(
        torch.arange(n_frames, device=dev), frame_items)
    bit_excl = _excl(item_len)
    frame_bits = torch.zeros(n_frames, dtype=i64, device=dev).index_add_(
        0, frame_of, item_len)
    n_bytes = (frame_bits + 7) // 8
    n_words = (n_bytes + 3) // 4
    word0 = _excl(n_words)
    pos = bit_excl - bit_excl[_excl(frame_items)][frame_of] \
        + 32 * word0[frame_of]
    pad = 8 * n_bytes - frame_bits
    pos = torch.cat([pos, 32 * word0 + frame_bits])
    item_len = torch.cat([item_len, pad])
    item_val = torch.cat([item_val, (1 << pad) - 1])

    word = pos >> 5
    end = (pos & 31) + item_len
    hi = torch.where(end <= 32, item_val << (32 - end).clamp(min=0),
                     item_val >> (end - 32).clamp(min=0))
    lo = torch.where(end > 32, (item_val << (64 - end).clamp(max=63))
                     & 0xFFFFFFFF, 0)
    words = torch.zeros(int(n_words.sum()) + 2, dtype=i64, device=dev)
    words.index_add_(0, word, hi).index_add_(0, word + 1, lo)
    stream = torch.stack([(words >> sh) & 255 for sh in (24, 16, 8, 0)],
                         -1).reshape(-1)

    # each frame's bytes, then 0xFF → 0xFF 0x00
    byte_frame = torch.repeat_interleave(
        torch.arange(n_frames, device=dev), 4 * n_words)
    keep = torch.arange(len(byte_frame), device=dev) \
        - 4 * word0[byte_frame] < n_bytes[byte_frame]
    data = stream[:len(byte_frame)][keep]
    frame = byte_frame[keep]
    ff = (data == 255).to(i64)
    out = torch.zeros(len(data) + int(ff.sum()), dtype=torch.uint8,
                      device=dev)
    out[torch.arange(len(data), device=dev) + _excl(ff)] = \
        data.to(torch.uint8)
    sizes = n_bytes + torch.zeros(n_frames, dtype=i64, device=dev) \
        .index_add_(0, frame, ff)
    blob = out.cpu().numpy().tobytes()
    bounds = np.concatenate([[0], np.cumsum(sizes.cpu().numpy())])
    return [blob[a:b] for a, b in zip(bounds[:-1], bounds[1:])]


def encode_jpegs(frames, quality: int = QUALITY, device=None) -> list:
    """``[T, H, W, 3]`` RGB frames (numpy or torch) → T baseline JPEG
    files as ``bytes``, encoded on ``device`` (default: where the frames
    are; numpy frames on the host). uint8 frames are taken as they are;
    float frames in [0, 1] are quantised as ``(clip(x, 0, 1) * 255)
    .astype(uint8)`` where they lie, then go to the device CHUNK_PIXELS at
    a time."""
    frames = torch.as_tensor(frames)
    if frames.ndim != 4 or frames.shape[-1] != 3 or not (
            frames.dtype == torch.uint8 or frames.is_floating_point()):
        raise ValueError(f"encode_jpegs takes [T, H, W, 3] uint8 or float; "
                         f"got {tuple(frames.shape)} {frames.dtype}")
    dev = frames.device if device is None else torch.device(device)
    _, h, w, _ = frames.shape
    q = quant_tables(quality)
    header = _header(h, w, q)
    qt = torch.as_tensor(q, device=dev)
    step = max(CHUNK_PIXELS // (h * w), 1)
    out = []
    for s0 in range(0, len(frames), step):
        chunk = frames[s0:s0 + step]
        if chunk.dtype != torch.uint8:
            chunk = (chunk.clamp(0, 1) * 255).to(torch.uint8)
        chunk = chunk.to(dev)
        out += [header + scan + b"\xff\xd9"
                for scan in _scans(_coefficients(chunk, qt))]
    return out


def encode_jpeg(frame, quality: int = QUALITY, device=None) -> bytes:
    """One ``[H, W, 3]`` uint8 frame → a JPEG file's bytes."""
    return encode_jpegs(torch.as_tensor(frame)[None], quality, device)[0]

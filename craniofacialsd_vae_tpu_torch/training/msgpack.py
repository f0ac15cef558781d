"""A small msgpack codec for flax's state-dict layout, so that the port
reads and writes the JAX package's checkpoints without ``flax`` or
``msgpack``.

flax's ``serialization.to_bytes`` turns a pytree into a state dict (a list
or tuple becomes a map keyed ``'0'``, ``'1'``, …; a NamedTuple a map keyed
by its fields; ``None`` stays nil) and packs it with msgpack, an ndarray
as ext type 1 holding the msgpack array ``(shape, dtype name, C-order
bytes)`` and a numpy scalar as ext type 3 in the same form. ``packb`` and
``unpackb`` write and read that encoding; ``to_state_dict`` and
``list_from_state_dict`` convert lists to and from the keyed maps, in
integer key order (sorting the keys as strings would put ``'10'`` before
``'2'``).
"""

from __future__ import annotations

import struct

import numpy as np

__all__ = ["packb", "unpackb", "to_state_dict", "list_from_state_dict"]

EXT_NDARRAY = 1
EXT_NPSCALAR = 3


# ---------------------------------------------------------------- state dicts
def to_state_dict(tree):
    """flax's ``to_state_dict`` for dicts, lists, tuples, arrays and
    Python scalars: lists and tuples become ``{'0': …, '1': …}``."""
    if isinstance(tree, dict):
        keys = [str(k) for k in tree]
        if len(set(keys)) != len(keys):
            raise ValueError(f"dict keys do not have unique strings: {keys}")
        return {str(k): to_state_dict(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): to_state_dict(v) for i, v in enumerate(tree)}
    return tree


def list_from_state_dict(state: dict) -> list:
    """A ``{'0': …, '1': …}`` map back to a list, in integer key order."""
    n = len(state)
    if set(state) != {str(i) for i in range(n)}:
        raise ValueError(f"not a list's state dict: keys {sorted(state)}")
    return [state[str(i)] for i in range(n)]


# ------------------------------------------------------------------- packing
def _pack_int(v: int, out: list) -> None:
    if 0 <= v < 0x80:
        out.append(struct.pack("B", v))
    elif -32 <= v < 0:
        out.append(struct.pack("b", v))
    elif v >= 0:
        for fmt, code, top in (("B", 0xcc, 1 << 8), (">H", 0xcd, 1 << 16),
                               (">I", 0xce, 1 << 32), (">Q", 0xcf, 1 << 64)):
            if v < top:
                out.append(bytes([code]) + struct.pack(fmt, v))
                return
        raise OverflowError(f"integer {v} does not fit msgpack")
    else:
        for fmt, code, bot in (("b", 0xd0, -(1 << 7)), (">h", 0xd1, -(1 << 15)),
                               (">i", 0xd2, -(1 << 31)),
                               (">q", 0xd3, -(1 << 63))):
            if v >= bot:
                out.append(bytes([code]) + struct.pack(fmt, v))
                return
        raise OverflowError(f"integer {v} does not fit msgpack")


def _pack_len(n: int, fix_code: int, fix_max: int, codes, out: list) -> None:
    """A length header: the fix form below ``fix_max`` (if any), else the
    8/16/32-bit forms of ``codes`` (None where the form does not exist)."""
    if fix_code is not None and n < fix_max:
        out.append(bytes([fix_code | n]))
        return
    for (fmt, top), code in zip((("B", 1 << 8), (">H", 1 << 16),
                                 (">I", 1 << 32)), codes):
        if code is not None and n < top:
            out.append(bytes([code]) + struct.pack(fmt, n))
            return
    raise ValueError(f"msgpack object of length {n} is too long")


def _ndarray_payload(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.names is not None:
        raise ValueError("object and structured dtypes are not supported")
    return packb([list(arr.shape), arr.dtype.name, arr.tobytes("C")])


def _pack_ext(code: int, data: bytes, out: list) -> None:
    n = len(data)
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixed:
        out.append(bytes([fixed[n], code]))
    else:
        _pack_len(n, None, 0, (0xc7, 0xc8, 0xc9), out)
        out.append(bytes([code]))
    out.append(data)


def _pack(obj, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, np.ndarray):
        _pack_ext(EXT_NDARRAY, _ndarray_payload(obj), out)
    elif isinstance(obj, np.generic):
        _pack_ext(EXT_NPSCALAR, _ndarray_payload(np.asarray(obj)), out)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(len(data), 0xa0, 32, (0xd9, 0xda, 0xdb), out)
        out.append(data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _pack_len(len(data), None, 0, (0xc4, 0xc5, 0xc6), out)
        out.append(data)
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 16, (None, 0xdc, 0xdd), out)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 16, (None, 0xde, 0xdf), out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot pack {type(obj).__name__}")


def packb(obj) -> bytes:
    """msgpack bytes of ``obj`` (None, bool, int, float, str, bytes, list,
    tuple, dict, numpy arrays and scalars), as flax's
    ``msgpack_serialize`` writes them."""
    out = []
    _pack(obj, out)
    return b"".join(out)


# ----------------------------------------------------------------- unpacking
class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


def _ndarray_from_payload(data: bytes) -> np.ndarray:
    shape, name, buf = unpackb(data)
    if isinstance(name, bytes):
        name = name.decode("ascii")
    if name == "bfloat16":
        raise ValueError("bfloat16 arrays are not supported")
    return np.frombuffer(bytes(buf), dtype=np.dtype(name)).reshape(
        tuple(shape), order="C").copy()


def _ext(code: int, data: bytes):
    if code == EXT_NDARRAY:
        return _ndarray_from_payload(data)
    if code == EXT_NPSCALAR:
        return _ndarray_from_payload(data)[()]
    raise ValueError(f"unsupported msgpack ext type {code}")


def _read(r: _Reader):
    b = r.unpack("B")
    if b <= 0x7f:
        return b
    if b >= 0xe0:
        return b - 0x100
    if 0x80 <= b <= 0x8f:
        return _read_map(r, b & 0x0f)
    if 0x90 <= b <= 0x9f:
        return [_read(r) for _ in range(b & 0x0f)]
    if 0xa0 <= b <= 0xbf:
        return bytes(r.take(b & 0x1f)).decode("utf-8")
    simple = {0xc0: None, 0xc2: False, 0xc3: True}
    if b in simple:
        return simple[b]
    ints = {0xcc: "B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q", 0xd0: "b",
            0xd1: ">h", 0xd2: ">i", 0xd3: ">q", 0xca: ">f", 0xcb: ">d"}
    if b in ints:
        return r.unpack(ints[b])
    lens = {0xd9: "B", 0xda: ">H", 0xdb: ">I"}
    if b in lens:
        return bytes(r.take(r.unpack(lens[b]))).decode("utf-8")
    bins = {0xc4: "B", 0xc5: ">H", 0xc6: ">I"}
    if b in bins:
        return bytes(r.take(r.unpack(bins[b])))
    if b in (0xdc, 0xdd):
        n = r.unpack(">H" if b == 0xdc else ">I")
        return [_read(r) for _ in range(n)]
    if b in (0xde, 0xdf):
        return _read_map(r, r.unpack(">H" if b == 0xde else ">I"))
    fixext = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
    if b in fixext:
        code = r.unpack("b")
        return _ext(code, bytes(r.take(fixext[b])))
    if b in (0xc7, 0xc8, 0xc9):
        n = r.unpack({0xc7: "B", 0xc8: ">H", 0xc9: ">I"}[b])
        code = r.unpack("b")
        return _ext(code, bytes(r.take(n)))
    raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")


def _read_map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        k = _read(r)
        out[k] = _read(r)
    if "__msgpack_chunked_array__" in out:
        raise ValueError("chunked arrays (over 1 GiB) are not supported")
    return out


def unpackb(data: bytes):
    """The object msgpack ``data`` encodes; ext types 1 and 3 become numpy
    arrays and scalars, as flax's ``msgpack_restore`` gives them."""
    r = _Reader(data)
    out = _read(r)
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after the msgpack object")
    return out

"""Pure-NumPy mesh I/O, PLY and OBJ (counterpart of
``geometry/mesh_io.py``, held equal to it by the tests).

The two formats the pipeline uses are parsed with NumPy: binary/ascii PLY
with per-vertex uchar RGBA colors (the segmented template) and OBJ vertex
soups (the dataset meshes share the template topology, so faces are optional).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

__all__ = ["MeshData", "read_mesh", "read_ply", "read_obj",
           "write_obj", "write_ply"]

_PLY_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


@dataclass
class MeshData:
    """A raw mesh as parsed from disk."""
    vertices: np.ndarray                       # [N, 3] float
    faces: np.ndarray | None = None            # [F, 3] int
    vertex_colors: np.ndarray | None = None    # [N, 4] uint8 (RGBA)
    path: str = field(default="")


def read_mesh(path: str) -> MeshData:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".ply":
        return read_ply(path)
    if ext == ".obj":
        return read_obj(path)
    raise ValueError(f"Unsupported mesh format: {path}")


def _parse_ply_header(f):
    """Parse a PLY header; returns (fmt, elements) where elements is a list of
    (name, count, properties) and properties is a list of
    (prop_name, dtype_str) or ('list', count_dtype, item_dtype, name)."""
    magic = f.readline().strip()
    if magic != b"ply":
        raise ValueError("Not a PLY file")
    fmt = None
    elements = []
    cur = None
    while True:
        line = f.readline()
        if not line:
            raise ValueError("Unexpected EOF in PLY header")
        tokens = line.decode("ascii", "replace").strip().split()
        if not tokens:
            continue
        key = tokens[0]
        if key == "format":
            fmt = tokens[1]
        elif key == "comment":
            continue
        elif key == "element":
            cur = (tokens[1], int(tokens[2]), [])
            elements.append(cur)
        elif key == "property":
            if tokens[1] == "list":
                cur[2].append(("list", _PLY_DTYPES[tokens[2]],
                               _PLY_DTYPES[tokens[3]], tokens[4]))
            else:
                cur[2].append((tokens[2], _PLY_DTYPES[tokens[1]]))
        elif key == "end_header":
            break
    return fmt, elements


def read_ply(path: str) -> MeshData:
    with open(path, "rb") as f:
        fmt, elements = _parse_ply_header(f)
        if fmt == "ascii":
            return _read_ply_ascii(f, elements, path)
        if fmt == "binary_little_endian":
            endian = "<"
        elif fmt == "binary_big_endian":
            endian = ">"
        else:
            raise ValueError(f"Unknown PLY format {fmt}")
        return _read_ply_binary(f, elements, endian, path)


def _extract_vertex_arrays(names, cols):
    verts = np.stack([cols[n] for n in ("x", "y", "z")], axis=1)
    verts = verts.astype(np.float64)
    colors = None
    if {"red", "green", "blue"} <= set(names):
        alpha = cols.get("alpha",
                         np.full_like(cols["red"], 255))
        colors = np.stack(
            [cols["red"], cols["green"], cols["blue"], alpha], axis=1
        ).astype(np.uint8)
    return verts, colors


def _read_ply_binary(f, elements, endian, path):
    verts = faces = colors = None
    for name, count, props in elements:
        if name == "vertex":
            dtype = np.dtype([(p[0], endian + p[1]) for p in props])
            raw = np.frombuffer(f.read(dtype.itemsize * count), dtype=dtype)
            cols = {p[0]: raw[p[0]] for p in props}
            verts, colors = _extract_vertex_arrays([p[0] for p in props], cols)
        elif name == "face":
            # Assume triangle-only lists (true for every mesh this framework
            # touches); then the layout is fixed-size and vectorizable.
            (tag, cnt_dt, item_dt, _), = props
            assert tag == "list"
            cnt_size = np.dtype(cnt_dt).itemsize
            item_size = np.dtype(item_dt).itemsize
            rec = np.dtype([("n", endian + cnt_dt),
                            ("idx", endian + item_dt, (3,))])
            raw = np.frombuffer(
                f.read((cnt_size + 3 * item_size) * count), dtype=rec)
            if not np.all(raw["n"] == 3):
                raise ValueError("Non-triangular PLY faces not supported")
            faces = raw["idx"].astype(np.int64)
        else:  # skip unknown fixed-size elements
            dtype = np.dtype([(p[0], endian + p[1]) for p in props])
            f.read(dtype.itemsize * count)
    return MeshData(vertices=verts, faces=faces, vertex_colors=colors,
                    path=path)


def _read_ply_ascii(f, elements, path):
    verts = faces = colors = None
    for name, count, props in elements:
        rows = [f.readline().split() for _ in range(count)]
        if name == "vertex":
            arr = np.array(rows, dtype=np.float64)
            cols = {p[0]: arr[:, i] for i, p in enumerate(props)}
            verts, colors = _extract_vertex_arrays([p[0] for p in props], cols)
        elif name == "face":
            faces = np.array([r[1:4] for r in rows], dtype=np.int64)
    return MeshData(vertices=verts, faces=faces, vertex_colors=colors,
                    path=path)


def read_obj(path: str) -> MeshData:
    verts, faces = [], []
    with open(path, "r") as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append((float(parts[1]), float(parts[2]),
                              float(parts[3])))
            elif line.startswith("f "):
                idx = [int(p.split("/")[0]) - 1 for p in line.split()[1:4]]
                faces.append(idx)
    vertices = np.asarray(verts, dtype=np.float64)
    f_arr = np.asarray(faces, dtype=np.int64) if faces else None
    return MeshData(vertices=vertices, faces=f_arr, path=path)


def write_obj(path: str, vertices: np.ndarray,
              faces: np.ndarray | None = None) -> None:
    with open(path, "w") as f:
        for v in np.asarray(vertices):
            f.write(f"v {v[0]:.8f} {v[1]:.8f} {v[2]:.8f}\n")
        if faces is not None:
            for face in np.asarray(faces):
                f.write(f"f {face[0] + 1} {face[1] + 1} {face[2] + 1}\n")


def write_ply(path: str, vertices: np.ndarray,
              faces: np.ndarray | None = None,
              vertex_colors: np.ndarray | None = None) -> None:
    """Binary little-endian PLY with optional RGBA vertex colors."""
    vertices = np.asarray(vertices, dtype=np.float32)
    n = len(vertices)
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if vertex_colors is not None:
        header += ["property uchar red", "property uchar green",
                   "property uchar blue", "property uchar alpha"]
    if faces is not None:
        header += [f"element face {len(faces)}",
                   "property list uchar int vertex_indices"]
    header.append("end_header")

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if vertex_colors is None:
            f.write(vertices.astype("<f4").tobytes())
        else:
            rec = np.dtype([("xyz", "<f4", (3,)), ("rgba", "u1", (4,))])
            buf = np.empty(n, dtype=rec)
            buf["xyz"] = vertices
            buf["rgba"] = np.asarray(vertex_colors, dtype=np.uint8)
            f.write(buf.tobytes())
        if faces is not None:
            rec = np.dtype([("n", "u1"), ("idx", "<i4", (3,))])
            buf = np.empty(len(faces), dtype=rec)
            buf["n"] = 3
            buf["idx"] = np.asarray(faces, dtype=np.int32)
            f.write(buf.tobytes())

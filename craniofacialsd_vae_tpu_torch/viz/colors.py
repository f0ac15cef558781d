"""Colormaps without matplotlib (counterpart of ``viz/colors.py`` and of
the colour half of ``viz/plots.py``).

``errors_to_colors`` reproduces ``matplotlib.colormaps["plasma"](values,
bytes=True)[..., :3]`` exactly: the 256-entry table below is matplotlib's
plasma LUT as it converts it to bytes (``(lut * 255).astype(uint8)``), and
the lookup follows its rules for the ends (values below 0 take the first
entry, values at or above 1 the last) and for NaN (black).

``YLGNBU_LUT`` (the confusion-matrix heatmaps) and ``BWR_LUT``
(``per_vertex_eigenvector_color``) are matplotlib's 256-entry float RGBA
tables of those colormaps, built as ``LinearSegmentedColormap.from_list``
builds them from their ColorBrewer anchors; ``lookup`` indexes a table by
matplotlib's rules and ``create_alpha_cmap`` is the white-to-colour table
of ``viz/plots.py``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["PLASMA_LUT", "YLGNBU_LUT", "BWR_LUT", "errors_to_colors",
           "lookup", "to_rgb", "create_alpha_cmap"]

#: matplotlib's plasma colormap, 256 RGB entries as uint8
PLASMA_LUT = np.array([
    (12, 7, 134), (16, 7, 135), (19, 6, 137), (21, 6, 138),
    (24, 6, 139), (27, 6, 140), (29, 6, 141), (31, 5, 142),
    (33, 5, 143), (35, 5, 144), (37, 5, 145), (39, 5, 146),
    (41, 5, 147), (43, 5, 148), (45, 4, 148), (47, 4, 149),
    (49, 4, 150), (51, 4, 151), (52, 4, 152), (54, 4, 152),
    (56, 4, 153), (58, 4, 154), (59, 3, 154), (61, 3, 155),
    (63, 3, 156), (64, 3, 156), (66, 3, 157), (68, 3, 158),
    (69, 3, 158), (71, 2, 159), (73, 2, 159), (74, 2, 160),
    (76, 2, 161), (78, 2, 161), (79, 2, 162), (81, 1, 162),
    (82, 1, 163), (84, 1, 163), (86, 1, 163), (87, 1, 164),
    (89, 1, 164), (90, 0, 165), (92, 0, 165), (94, 0, 165),
    (95, 0, 166), (97, 0, 166), (98, 0, 166), (100, 0, 167),
    (101, 0, 167), (103, 0, 167), (104, 0, 167), (106, 0, 167),
    (108, 0, 168), (109, 0, 168), (111, 0, 168), (112, 0, 168),
    (114, 0, 168), (115, 0, 168), (117, 0, 168), (118, 1, 168),
    (120, 1, 168), (121, 1, 168), (123, 2, 168), (124, 2, 167),
    (126, 3, 167), (127, 3, 167), (129, 4, 167), (130, 4, 167),
    (132, 5, 166), (133, 6, 166), (134, 7, 166), (136, 7, 165),
    (137, 8, 165), (139, 9, 164), (140, 10, 164), (142, 12, 164),
    (143, 13, 163), (144, 14, 163), (146, 15, 162), (147, 16, 161),
    (149, 17, 161), (150, 18, 160), (151, 19, 160), (153, 20, 159),
    (154, 21, 158), (155, 23, 158), (157, 24, 157), (158, 25, 156),
    (159, 26, 155), (160, 27, 155), (162, 28, 154), (163, 29, 153),
    (164, 30, 152), (165, 31, 151), (167, 33, 151), (168, 34, 150),
    (169, 35, 149), (170, 36, 148), (172, 37, 147), (173, 38, 146),
    (174, 39, 145), (175, 40, 144), (176, 42, 143), (177, 43, 143),
    (178, 44, 142), (180, 45, 141), (181, 46, 140), (182, 47, 139),
    (183, 48, 138), (184, 50, 137), (185, 51, 136), (186, 52, 135),
    (187, 53, 134), (188, 54, 133), (189, 55, 132), (190, 56, 131),
    (191, 57, 130), (192, 59, 129), (193, 60, 128), (194, 61, 128),
    (195, 62, 127), (196, 63, 126), (197, 64, 125), (198, 65, 124),
    (199, 66, 123), (200, 68, 122), (201, 69, 121), (202, 70, 120),
    (203, 71, 119), (204, 72, 118), (205, 73, 117), (206, 74, 117),
    (207, 75, 116), (208, 77, 115), (209, 78, 114), (209, 79, 113),
    (210, 80, 112), (211, 81, 111), (212, 82, 110), (213, 83, 109),
    (214, 85, 109), (215, 86, 108), (215, 87, 107), (216, 88, 106),
    (217, 89, 105), (218, 90, 104), (219, 91, 103), (220, 93, 102),
    (220, 94, 102), (221, 95, 101), (222, 96, 100), (223, 97, 99),
    (223, 98, 98), (224, 100, 97), (225, 101, 96), (226, 102, 96),
    (227, 103, 95), (227, 104, 94), (228, 106, 93), (229, 107, 92),
    (229, 108, 91), (230, 109, 90), (231, 110, 90), (232, 112, 89),
    (232, 113, 88), (233, 114, 87), (234, 115, 86), (234, 116, 85),
    (235, 118, 84), (236, 119, 84), (236, 120, 83), (237, 121, 82),
    (237, 123, 81), (238, 124, 80), (239, 125, 79), (239, 126, 78),
    (240, 128, 77), (240, 129, 77), (241, 130, 76), (242, 132, 75),
    (242, 133, 74), (243, 134, 73), (243, 135, 72), (244, 137, 71),
    (244, 138, 71), (245, 139, 70), (245, 141, 69), (246, 142, 68),
    (246, 143, 67), (246, 145, 66), (247, 146, 65), (247, 147, 65),
    (248, 149, 64), (248, 150, 63), (248, 152, 62), (249, 153, 61),
    (249, 154, 60), (250, 156, 59), (250, 157, 58), (250, 159, 58),
    (250, 160, 57), (251, 162, 56), (251, 163, 55), (251, 164, 54),
    (252, 166, 53), (252, 167, 53), (252, 169, 52), (252, 170, 51),
    (252, 172, 50), (252, 173, 49), (253, 175, 49), (253, 176, 48),
    (253, 178, 47), (253, 179, 46), (253, 181, 45), (253, 182, 45),
    (253, 184, 44), (253, 185, 43), (253, 187, 43), (253, 188, 42),
    (253, 190, 41), (253, 192, 41), (253, 193, 40), (253, 195, 40),
    (253, 196, 39), (253, 198, 38), (252, 199, 38), (252, 201, 38),
    (252, 203, 37), (252, 204, 37), (252, 206, 37), (251, 208, 36),
    (251, 209, 36), (251, 211, 36), (250, 213, 36), (250, 214, 36),
    (250, 216, 36), (249, 217, 36), (249, 219, 36), (248, 221, 36),
    (248, 223, 36), (247, 224, 36), (247, 226, 37), (246, 228, 37),
    (246, 229, 37), (245, 231, 38), (245, 233, 38), (244, 234, 38),
    (243, 236, 38), (243, 238, 38), (242, 240, 38), (242, 241, 38),
    (241, 243, 38), (240, 245, 37), (240, 246, 35), (239, 248, 33),
], dtype=np.uint8)


def errors_to_colors(values, min_value=None, max_value=None,
                     cmap: str = "plasma") -> np.ndarray:
    """Per-vertex scalar errors → RGB uint8 colours (reference
    utils.py:168-177)."""
    if cmap != "plasma":
        raise ValueError(f"only the plasma colormap is vendored; got {cmap!r}")
    values = np.asarray(values, np.float64)
    lo = values.min() if min_value is None else min_value
    hi = values.max() if max_value is None else max_value
    if lo != hi:
        values = (values - lo) / (hi - lo)
    n = len(PLASMA_LUT)
    xa = values * n
    xa[xa == n] = n - 1                  # 1.0 is the last entry, not over
    under, over, bad = xa < 0, xa >= n, np.isnan(xa)
    with np.errstate(invalid="ignore"):
        idx = xa.astype(np.int64)
    idx[under] = 0
    idx[over] = n - 1
    idx[bad] = 0
    rgb = PLASMA_LUT[idx]
    rgb[bad] = 0
    return rgb


def _linear_lut(anchors, n: int = 256) -> np.ndarray:
    """matplotlib's ``LinearSegmentedColormap.from_list(anchors, N=n)``
    table: ``_create_lookup_table`` per channel, alpha 1."""
    anchors = np.asarray(anchors, np.float64)
    x = np.linspace(0, 1, len(anchors)) * (n - 1)
    xind = (n - 1) * np.linspace(0, 1, n)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.ones((n, 4))
    for c in range(3):
        y = anchors[:, c]
        lut[:, c] = np.clip(np.concatenate([
            [y[0]], distance * (y[ind] - y[ind - 1]) + y[ind - 1],
            [y[-1]]]), 0.0, 1.0)
    return lut


#: matplotlib's YlGnBu (ColorBrewer), 256 RGBA float entries
YLGNBU_LUT = _linear_lut([
    (1.0, 1.0, 0.8509803921568627),
    (0.9294117647058824, 0.9725490196078431, 0.6941176470588235),
    (0.7803921568627451, 0.9137254901960784, 0.7058823529411765),
    (0.4980392156862745, 0.803921568627451, 0.7333333333333333),
    (0.2549019607843137, 0.7137254901960784, 0.7686274509803922),
    (0.11372549019607843, 0.5686274509803921, 0.7529411764705882),
    (0.13333333333333333, 0.3686274509803922, 0.6588235294117647),
    (0.1450980392156863, 0.20392156862745098, 0.5803921568627451),
    (0.03137254901960784, 0.11372549019607843, 0.34509803921568627)])

#: matplotlib's bwr, 256 RGBA float entries
BWR_LUT = _linear_lut([(0.0, 0.0, 1.0), (1.0, 1.0, 1.0), (1.0, 0.0, 0.0)])


def lookup(table: np.ndarray, values) -> np.ndarray:
    """``Colormap.__call__`` on values already normalised to [0, 1]:
    below 0 the first entry, at or above 1 the last, NaN transparent
    black; returns ``[..., table columns]``."""
    xa = np.array(values, copy=True)
    n = len(table)
    if xa.dtype.kind == "f":
        xa *= n
        xa[xa == n] = n - 1
    under, over, bad = xa < 0, xa >= n, np.isnan(xa)
    with np.errstate(invalid="ignore"):
        idx = xa.astype(np.int64)
    idx[under] = 0
    idx[over] = n - 1
    out = table[np.clip(idx, 0, n - 1)]
    out[bad] = 0.0
    return out


_BASE_COLORS = {"b": (0, 0, 1), "g": (0, 0.5, 0), "r": (1, 0, 0),
                "c": (0, 0.75, 0.75), "m": (0.75, 0, 0.75),
                "y": (0.75, 0.75, 0), "k": (0, 0, 0), "w": (1, 1, 1),
                "white": (1, 1, 1), "black": (0, 0, 0)}


def to_rgb(color) -> tuple:
    """``"#rrggbb"``, a one-letter base colour or an RGB(A) tuple in
    [0, 1] → an RGB float tuple (matplotlib's ``to_rgba`` for those)."""
    if isinstance(color, str):
        if color in _BASE_COLORS:
            return tuple(float(c) for c in _BASE_COLORS[color])
        h = color.lstrip("#")
        if len(h) not in (6, 8):
            raise ValueError(f"not a colour: {color!r}")
        return tuple(int(h[i:i + 2], 16) / 255 for i in (0, 2, 4))
    return tuple(float(c) for c in color[:3])


def create_alpha_cmap(base_color) -> np.ndarray:
    """White → ``base_color`` table with a transparent ramp-in over its
    first ten entries (JAX ``viz/plots.py:12-22``; matplotlib's
    ``ListedColormap`` colours): ``[256, 4]`` float RGBA."""
    vals = np.ones((256, 4))
    base = to_rgb(base_color)
    for c in range(3):
        vals[:, c] = np.linspace(1, base[c], 256)
    vals[:10, 3] = np.linspace(0, 1, 10)
    return vals

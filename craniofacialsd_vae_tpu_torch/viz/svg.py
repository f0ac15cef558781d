"""A small figure model with two outputs, for the Tester's figures without
matplotlib: SVG text, and a ``[H, W, 3]`` float frame (the counterpart of
the JAX Tester's ``_fig_to_frame``) for the overlay videos.

A ``Figure`` (sizes in inches, drawn in points, 72 to the inch) holds
``Axes`` placed by figure fractions, as ``Figure.add_axes`` places them.
Each axes maps data to points with limits set by hand or autoscaled as
matplotlib does (the data's extent with 5 % margins, which stop at the
edges of an image), and carries nice ticks, labels, a title and a
legend. Its marks: scatter markers (round or by style), lines with
markers, rectangles, ellipses, arrows, heatmap cells with their
annotations, and an embedded raster image.

Every ``<g class="axes">`` of the SVG states its box (``data-box``: x,
y, width, height in points from the top left) and limits (``data-xlim``,
``data-ylim``, ``data-yinverted``); every marker is an element of class
``marker`` whose ``cx``/``cy`` (or ``translate``) is its centre, so a
reader maps markers back to data.

The frames carry no text: the SVG always does, a frame shows the marks,
the axes' frames and their tick marks, with hard (not antialiased) edges,
drawn in the order they were added.
"""

from __future__ import annotations

import base64
import math
from xml.sax.saxutils import escape

import numpy as np

from .colors import lookup, to_rgb
from .images import png_bytes

__all__ = ["Figure", "Axes", "overlay_frames", "MARKERS", "DPI"]

DPI = 100
FONT = "DejaVu Sans, Arial, sans-serif"
MARKERS = ("o", "X", "D", "P", "s", "^", "v")


def hex_color(color) -> str:
    r, g, b = (int(round(c * 255)) for c in to_rgb(color))
    return f"#{r:02x}{g:02x}{b:02x}"


def _n(v: float) -> str:
    s = f"{float(v):.6f}".rstrip("0").rstrip(".")
    return "0" if s in ("-0", "") else s


def nice_ticks(lo: float, hi: float, max_ticks: int = 9) -> np.ndarray:
    """Ticks at a multiple of 1, 2, 2.5 or 5 × 10^k inside [lo, hi], at
    most ``max_ticks`` intervals (MaxNLocator's steps)."""
    if not hi > lo:
        return np.array([lo])
    raw = (hi - lo) / max(max_ticks, 1)
    mag = 10.0 ** math.floor(math.log10(raw))
    step = next(m * mag for m in (1, 2, 2.5, 5, 10) if m * mag >= raw)
    first = math.ceil(lo / step - 1e-9) * step
    ticks = np.arange(first, hi + step * 1e-9, step)
    return np.round(ticks / step) * step


def _tick_label(v: float) -> str:
    s = f"{v:.6g}"
    return s.replace("-", "−")


def _marker_path(marker: str, d: float) -> str:
    """SVG path of a marker of size ``d`` points about (0, 0)."""
    r = d / 2
    if marker == "s":
        pts = [(-r, -r), (r, -r), (r, r), (-r, r)]
    elif marker == "D":
        pts = [(0, -r), (r, 0), (0, r), (-r, 0)]
    elif marker in ("^", "v"):
        s = -1 if marker == "^" else 1
        pts = [(0, s * r), (r, -s * r), (-r, -s * r)]
    else:                               # "X" and "P": crosses
        w = r / 3
        arm = [(-w, -r), (w, -r), (w, -w), (r, -w), (r, w), (w, w), (w, r),
               (-w, r), (-w, w), (-r, w), (-r, -w), (-w, -w)]
        if marker == "X":
            c = s = math.sqrt(0.5)
            arm = [(x * c - y * s, x * s + y * c) for x, y in arm]
        pts = arm
    return "M" + "L".join(f"{_n(x)} {_n(y)}" for x, y in pts) + "Z"


class Axes:
    """One axes: a box in figure points, limits, ticks and marks."""

    def __init__(self, fig: "Figure", box: tuple):
        self.fig = fig
        self.box = box                  # x0, y0 (top), width, height
        self.marks = []
        self.xlim = self.ylim = None
        self.y_inverted = False
        self.title = self.xlabel = self.ylabel = ""
        self.xticks = self.yticks = None      # [(position, label)]
        self.xtick_rotation = 0
        self.legend = None              # [(title or None, entries)]
        self.legend_outside = False

    # ----------------------------------------------------------- marks
    def scatter(self, x, y, color, size: float = 36.0, marker: str = "o",
                alpha: float = 1.0, edgecolor=None):
        """Markers of area ``size`` points² (matplotlib's ``s``); ``color``
        one colour or one per point."""
        x, y = np.atleast_1d(np.asarray(x, np.float64)), \
            np.atleast_1d(np.asarray(y, np.float64))
        colors = [color] * len(x) if isinstance(color, str) or \
            np.ndim(color) == 1 and len(color) in (3, 4) and \
            not isinstance(color[0], str) else list(color)
        self.marks.append(("scatter", dict(x=x, y=y, colors=colors,
                                           size=size, marker=marker,
                                           alpha=alpha, edge=edgecolor)))

    def plot(self, x, y, color, marker: str | None = None,
             markersize: float = 6.0, linewidth: float = 1.5):
        x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
        self.marks.append(("line", dict(x=x, y=y, color=color,
                                        width=linewidth)))
        if marker:
            self.scatter(x, y, color, markersize ** 2, marker)

    def rect(self, x0, y0, x1, y1, facecolor=None, edgecolor=None,
             linewidth: float = 1.0, alpha: float = 1.0):
        self.marks.append(("rect", dict(x0=x0, y0=y0, x1=x1, y1=y1,
                                        face=facecolor, edge=edgecolor,
                                        width=linewidth, alpha=alpha)))

    def ellipse(self, center, width, height, angle, facecolor,
                edgecolor=None, alpha: float = 1.0, linewidth: float = 1.0):
        """An ellipse of full axes ``width``/``height`` (data units)
        rotated by ``angle`` degrees, as matplotlib's ``Ellipse``."""
        self.marks.append(("ellipse", dict(
            c=np.asarray(center, np.float64).reshape(2), w=float(width),
            h=float(height), angle=float(angle), face=facecolor,
            edge=edgecolor, alpha=alpha, width=linewidth)))

    def arrow(self, tail, head, color, scale: float = 15.0):
        """A line from ``tail`` to ``head`` with a filled head of
        ``scale`` points (FancyArrowPatch ``-|>``)."""
        self.marks.append(("arrow", dict(
            t=np.asarray(tail, np.float64).reshape(2),
            h=np.asarray(head, np.float64).reshape(2), color=color,
            scale=scale)))

    def image(self, rgba: np.ndarray, extent: tuple):
        """A raster ``[h, w, 4]`` (float, row 0 at the top) over the data
        ``extent`` (x0, x1, y0, y1); its edges hold the autoscale."""
        self.marks.append(("image", dict(rgba=np.asarray(rgba, np.float64),
                                         extent=tuple(map(float, extent)))))

    def heatmap(self, matrix, table, vmin: float, vmax: float,
                annot: list | None = None):
        """Cells of ``matrix`` coloured by ``table`` between ``vmin`` and
        ``vmax``, row 0 at the top, with optional annotation strings."""
        m = np.asarray(matrix, np.float64)
        rgba = lookup(table, (m - vmin) / (vmax - vmin))
        self.marks.append(("cells", dict(rgba=rgba, annot=annot)))
        self.xlim, self.ylim = (0.0, float(m.shape[1])), \
            (0.0, float(m.shape[0]))
        self.y_inverted = True

    # ---------------------------------------------------------- layout
    def _data_extent(self, axis: int):
        vals, sticky = [], []
        for kind, m in self.marks:
            if kind in ("scatter", "line"):
                vals.append((m["x"], m["y"])[axis])
            elif kind == "rect":
                vals.append(np.array([(m["x0"], m["y0"])[axis],
                                      (m["x1"], m["y1"])[axis]]))
            elif kind == "ellipse":
                r = max(m["w"], m["h"]) / 2
                vals.append(np.array([m["c"][axis] - r, m["c"][axis] + r]))
            elif kind == "arrow":
                vals.append(np.array([m["t"][axis], m["h"][axis]]))
            elif kind == "image":
                e = m["extent"][2 * axis:2 * axis + 2]
                vals.append(np.array(e))
                sticky += list(e)
        vals = [v[np.isfinite(v)] for v in vals]
        vals = [v for v in vals if len(v)]
        if not vals:
            return None, sticky
        v = np.concatenate(vals)
        return (float(v.min()), float(v.max())), sticky

    def limits(self) -> tuple:
        """(xlim, ylim): as set, else the data extent with 5 % margins
        that stop at an image's edge."""
        out = []
        for axis, fixed in ((0, self.xlim), (1, self.ylim)):
            if fixed is not None:
                out.append(tuple(map(float, fixed)))
                continue
            ext, sticky = self._data_extent(axis)
            if ext is None:
                out.append((0.0, 1.0))
                continue
            lo, hi = ext
            pad = 0.05 * (hi - lo) if hi > lo else max(abs(lo) * 0.05, 0.05)
            nlo, nhi = lo - pad, hi + pad
            nlo = max([s for s in sticky if nlo <= s <= lo], default=nlo)
            nhi = min([s for s in sticky if hi <= s <= nhi], default=nhi)
            out.append((nlo, nhi))
        return tuple(out)

    def transform(self, x, y, limits=None) -> tuple:
        """Data → figure points (x right, y down)."""
        (xlo, xhi), (ylo, yhi) = limits or self.limits()
        x0, y0, w, h = self.box
        px = x0 + (np.asarray(x, np.float64) - xlo) / (xhi - xlo) * w
        fy = (np.asarray(y, np.float64) - ylo) / (yhi - ylo)
        py = y0 + (fy if self.y_inverted else 1 - fy) * h
        return px, py

    def inverse(self, px, py, limits=None) -> tuple:
        """Figure points → data (``transform``'s inverse)."""
        (xlo, xhi), (ylo, yhi) = limits or self.limits()
        x0, y0, w, h = self.box
        x = xlo + (np.asarray(px, np.float64) - x0) / w * (xhi - xlo)
        fy = (np.asarray(py, np.float64) - y0) / h
        y = ylo + (fy if self.y_inverted else 1 - fy) * (yhi - ylo)
        return x, y

    def _ticks(self, limits) -> tuple:
        out = []
        for axis, given in ((0, self.xticks), (1, self.yticks)):
            if given is not None:
                out.append(list(given))
                continue
            lo, hi = limits[axis]
            span = self.box[2 + axis]
            out.append([(float(t), _tick_label(t)) for t in nice_ticks(
                lo, hi, max(min(int(span // 30), 9), 1))])
        return tuple(out)

    # ------------------------------------------------------------- SVG
    def svg(self, index: int) -> str:
        lim = self.limits()
        x0, y0, w, h = self.box
        out = [f'<g class="axes" id="axes{index}" data-box="{_n(x0)} '
               f'{_n(y0)} {_n(w)} {_n(h)}" data-xlim="{lim[0][0]!r} '
               f'{lim[0][1]!r}" data-ylim="{lim[1][0]!r} {lim[1][1]!r}" '
               f'data-yinverted="{int(self.y_inverted)}">',
               f'<clipPath id="clip{index}"><rect x="{_n(x0)}" y="{_n(y0)}" '
               f'width="{_n(w)}" height="{_n(h)}"/></clipPath>',
               f'<g clip-path="url(#clip{index})">']
        for kind, m in self.marks:
            out += self._svg_mark(kind, m, lim)
        out.append("</g>")
        xt, yt = self._ticks(lim)
        out.append(f'<rect x="{_n(x0)}" y="{_n(y0)}" width="{_n(w)}" '
                   f'height="{_n(h)}" fill="none" stroke="#262626" '
                   'stroke-width="0.8"/>')
        for pos, label in xt:
            px, _ = self.transform(pos, lim[1][0], lim)
            if not x0 - 1e-6 <= px <= x0 + w + 1e-6:
                continue
            out.append(f'<line x1="{_n(px)}" y1="{_n(y0 + h)}" x2="{_n(px)}" '
                       f'y2="{_n(y0 + h + 3.5)}" stroke="#262626" '
                       'stroke-width="0.8"/>')
            rot = (f' transform="rotate({-self.xtick_rotation} {_n(px)} '
                   f'{_n(y0 + h + 14)})"' if self.xtick_rotation else "")
            anchor = "end" if self.xtick_rotation else "middle"
            out.append(self._text(px, y0 + h + 14, label, 9, anchor, rot))
        for pos, label in yt:
            _, py = self.transform(lim[0][0], pos, lim)
            if not y0 - 1e-6 <= py <= y0 + h + 1e-6:
                continue
            out.append(f'<line x1="{_n(x0 - 3.5)}" y1="{_n(py)}" '
                       f'x2="{_n(x0)}" y2="{_n(py)}" stroke="#262626" '
                       'stroke-width="0.8"/>')
            out.append(self._text(x0 - 5, py + 3, label, 9, "end"))
        if self.xlabel:
            out.append(self._text(x0 + w / 2, y0 + h + 30, self.xlabel, 10))
        if self.ylabel:
            out.append(f'<text x="0" y="0" font-size="10" font-family="{FONT}"'
                       f' text-anchor="middle" transform="translate('
                       f'{_n(x0 - 32)} {_n(y0 + h / 2)}) rotate(-90)">'
                       f'{escape(self.ylabel)}</text>')
        if self.title:
            out.append(self._text(x0 + w / 2, y0 - 6, self.title, 10))
        if self.legend:
            out += self._svg_legend()
        out.append("</g>")
        return "\n".join(out)

    @staticmethod
    def _text(x, y, s, size, anchor="middle", extra="") -> str:
        return (f'<text x="{_n(x)}" y="{_n(y)}" font-size="{size}" '
                f'font-family="{FONT}" text-anchor="{anchor}"{extra}>'
                f'{escape(str(s))}</text>')

    def _svg_mark(self, kind, m, lim) -> list:
        out = []
        if kind == "scatter":
            px, py = self.transform(m["x"], m["y"], lim)
            d = math.sqrt(m["size"])
            edge = (f' stroke="{hex_color(m["edge"])}" stroke-width="0.5"'
                    if m["edge"] is not None else "")
            op = f' fill-opacity="{m["alpha"]}"' if m["alpha"] < 1 else ""
            for x, y, c in zip(px, py, m["colors"]):
                if m["marker"] == "o":
                    out.append(f'<circle class="marker" cx="{_n(x)}" '
                               f'cy="{_n(y)}" r="{_n(d / 2)}" '
                               f'fill="{hex_color(c)}"{op}{edge}/>')
                else:
                    out.append(f'<path class="marker" d="'
                               f'{_marker_path(m["marker"], d)}" transform='
                               f'"translate({_n(x)} {_n(y)})" '
                               f'fill="{hex_color(c)}"{op}{edge}/>')
        elif kind == "line":
            px, py = self.transform(m["x"], m["y"], lim)
            pts = " ".join(f"{_n(x)},{_n(y)}" for x, y in zip(px, py))
            out.append(f'<polyline points="{pts}" fill="none" stroke='
                       f'"{hex_color(m["color"])}" stroke-width='
                       f'"{_n(m["width"])}"/>')
        elif kind == "rect":
            (ax, bx), (ay, by) = self.transform(
                [m["x0"], m["x1"]], [m["y0"], m["y1"]], lim)
            fill = hex_color(m["face"]) if m["face"] is not None else "none"
            stroke = (f' stroke="{hex_color(m["edge"])}" stroke-width='
                      f'"{_n(m["width"])}"' if m["edge"] is not None else "")
            out.append(f'<rect x="{_n(min(ax, bx))}" y="{_n(min(ay, by))}" '
                       f'width="{_n(abs(bx - ax))}" '
                       f'height="{_n(abs(by - ay))}"'
                       f' fill="{fill}" fill-opacity="{m["alpha"]}"{stroke}/>')
        elif kind == "ellipse":
            # a rotation in data space is a shear in points unless the
            # scales agree: drawn as a polygon
            t = np.linspace(0, 2 * np.pi, 73)
            ex, ey = self._ellipse_points(m, t)
            px, py = self.transform(ex, ey, lim)
            pts = " ".join(f"{_n(x)},{_n(y)}" for x, y in zip(px, py))
            out.append(f'<polygon points="{pts}" fill="{hex_color(m["face"])}"'
                       f' fill-opacity="{m["alpha"]}" stroke='
                       f'"{hex_color(m["edge"] or m["face"])}" '
                       f'stroke-opacity="{m["alpha"]}" stroke-width='
                       f'"{_n(m["width"])}"/>')
        elif kind == "arrow":
            (tx, hx), (ty, hy) = self.transform(
                [m["t"][0], m["h"][0]], [m["t"][1], m["h"][1]], lim)
            tri = self._arrow_head(tx, ty, hx, hy, m["scale"])
            c = hex_color(m["color"])
            out.append(f'<line x1="{_n(tx)}" y1="{_n(ty)}" '
                       f'x2="{_n(tri[3][0])}" y2="{_n(tri[3][1])}" '
                       f'stroke="{c}" stroke-width="1"/>')
            out.append('<polygon points="' + " ".join(
                f"{_n(x)},{_n(y)}" for x, y in tri[:3]) + f'" fill="{c}"/>')
        elif kind == "image":
            x0, x1, y0, y1 = m["extent"]
            (ax, bx), (ay, by) = self.transform([x0, x1], [y1, y0], lim)
            data = base64.b64encode(png_bytes(m["rgba"])).decode()
            out.append(f'<image x="{_n(min(ax, bx))}" y="{_n(min(ay, by))}" '
                       f'width="{_n(abs(bx - ax))}" '
                       f'height="{_n(abs(by - ay))}"'
                       ' preserveAspectRatio="none" '
                       f'xlink:href="data:image/png;base64,{data}"/>')
        elif kind == "cells":
            rgba = m["rgba"]
            for i in range(rgba.shape[0]):
                for j in range(rgba.shape[1]):
                    (ax, bx), (ay, by) = self.transform(
                        [j, j + 1], [i, i + 1], lim)
                    out.append(f'<rect class="cell" x="{_n(ax)}" y="{_n(ay)}" '
                               f'width="{_n(bx - ax)}" height="{_n(by - ay)}" '
                               f'fill="{hex_color(rgba[i, j])}"/>')
                    if m["annot"] is not None:
                        lum = _luminance(rgba[i, j])
                        color = "#262626" if lum > 0.408 else "#ffffff"
                        out.append(
                            f'<text class="annot" x="{_n((ax + bx) / 2)}" '
                            f'y="{_n((ay + by) / 2 + 3.5)}" font-size="10" '
                            f'font-family="{FONT}" text-anchor="middle" '
                            f'fill="{color}">{escape(m["annot"][i][j])}'
                            "</text>")
        return out

    @staticmethod
    def _ellipse_points(m, t) -> tuple:
        a = math.radians(m["angle"])
        u, v = m["w"] / 2 * np.cos(t), m["h"] / 2 * np.sin(t)
        return (m["c"][0] + u * math.cos(a) - v * math.sin(a),
                m["c"][1] + u * math.sin(a) + v * math.cos(a))

    @staticmethod
    def _arrow_head(tx, ty, hx, hy, scale) -> list:
        """The head triangle (tip, two corners) and the base's centre, in
        points."""
        d = math.hypot(hx - tx, hy - ty) or 1.0
        ux, uy = (hx - tx) / d, (hy - ty) / d
        length, half = 0.4 * scale, 0.2 * scale
        bx, by = hx - ux * length, hy - uy * length
        return [(hx, hy), (bx - uy * half, by + ux * half),
                (bx + uy * half, by - ux * half), (bx, by)]

    def _svg_legend(self) -> list:
        x0, y0, w, _ = self.box
        rows = []
        for title, entries in self.legend:
            if title:
                rows.append((title, None))
            rows += [(label, spec) for label, spec in entries]
        lx = x0 + w + 10 if self.legend_outside else x0 + w - 70
        ly = y0 + 8
        out = [f'<g class="legend"><rect x="{_n(lx - 4)}" y="{_n(ly - 4)}" '
               f'width="66" height="{_n(14 * len(rows) + 4)}" fill="#ffffff" '
               'fill-opacity="0.8" stroke="#cccccc" stroke-width="0.5"/>']
        for k, (label, spec) in enumerate(rows):
            y = ly + 14 * k + 6
            if spec is None:
                out.append(self._text(lx, y + 3, label, 9, "start"))
                continue
            color, marker = spec
            if marker in ("o", None):
                out.append(f'<circle cx="{_n(lx + 5)}" cy="{_n(y)}" r="3" '
                           f'fill="{hex_color(color)}"/>')
            elif marker == "-":
                out.append(f'<line x1="{_n(lx)}" y1="{_n(y)}" '
                           f'x2="{_n(lx + 10)}" y2="{_n(y)}" '
                           f'stroke="{hex_color(color)}" stroke-width="1.5"/>')
            else:
                out.append(f'<path d="{_marker_path(marker, 6)}" transform='
                           f'"translate({_n(lx + 5)} {_n(y)})" '
                           f'fill="{hex_color(color)}"/>')
            out.append(self._text(lx + 14, y + 3, label, 9, "start"))
        out.append("</g>")
        return out

    # ----------------------------------------------------------- frame
    def clip(self, s: float) -> tuple:
        """The axes box in pixels at ``s`` pixels a point: (c0, r0, c1,
        r1)."""
        x0, y0, w, h = self.box
        return (int(round(x0 * s)), int(round(y0 * s)),
                int(round((x0 + w) * s)), int(round((y0 + h) * s)))

    def draw(self, canvas: np.ndarray, s: float) -> None:
        """Draw the marks, the frame and the tick marks into ``canvas``
        (``[H, W, 3]`` float) at ``s`` pixels a point."""
        lim = self.limits()
        clip = self.clip(s)
        for kind, m in self.marks:
            _RASTER[kind](self, canvas, s, m, lim, clip)
        dark = np.array(to_rgb("#262626"))
        c0, r0, c1, r1 = clip
        canvas[r0:r1 + 1, [c0, min(c1, canvas.shape[1] - 1)]] = dark
        canvas[[r0, min(r1, canvas.shape[0] - 1)], c0:c1 + 1] = dark
        xt, yt = self._ticks(lim)
        for pos, _ in xt:
            px, _ = self.transform(pos, lim[1][0], lim)
            c = int(px * s)
            if clip[0] <= c <= clip[2]:
                canvas[clip[3]:clip[3] + int(3.5 * s), c] = dark
        for pos, _ in yt:
            _, py = self.transform(lim[0][0], pos, lim)
            r = int(py * s)
            if clip[1] <= r <= clip[3]:
                canvas[r, max(clip[0] - int(3.5 * s), 0):clip[0]] = dark


def _luminance(rgba) -> float:
    """seaborn's ``relative_luminance`` of an RGB(A) colour."""
    rgb = np.asarray(rgba[:3], np.float64)
    rgb = np.where(rgb <= .03928, rgb / 12.92, ((rgb + .055) / 1.055) ** 2.4)
    return float(rgb @ [.2126, .7152, .0722])


# ------------------------------------------------------------- raster
def _blend(canvas, rows, cols, color, alpha, clip) -> None:
    c0, r0, c1, r1 = clip
    keep = (rows >= r0) & (rows < r1) & (cols >= c0) & (cols < c1)
    rows, cols = rows[keep], cols[keep]
    color = np.asarray(color, np.float64)
    if color.ndim == 2:
        color = color[keep]
    if alpha >= 1:
        canvas[rows, cols] = color
    else:
        canvas[rows, cols] = (1 - alpha) * canvas[rows, cols] + alpha * color


def _discs(canvas, px, py, radius, colors, alpha, clip) -> None:
    """Filled discs at pixel centres ``px``, ``py`` (the pixel holding
    each centre always drawn)."""
    if not len(px):
        return
    r = max(radius, 0.5)
    k = int(math.ceil(r))
    oy, ox = np.mgrid[-k:k + 1, -k:k + 1]
    ix, iy = np.floor(px).astype(np.int64), np.floor(py).astype(np.int64)
    dx = ix[:, None] + ox.ravel() + 0.5 - px[:, None]
    dy = iy[:, None] + oy.ravel() + 0.5 - py[:, None]
    inside = (dx * dx + dy * dy <= r * r) | \
        ((ox.ravel() == 0) & (oy.ravel() == 0))[None]
    rows = (iy[:, None] + oy.ravel())[inside]
    cols = (ix[:, None] + ox.ravel())[inside]
    cols_rgb = np.asarray(colors, np.float64)
    if cols_rgb.ndim == 2:
        cols_rgb = np.broadcast_to(cols_rgb[:, None], inside.shape + (3,))[
            inside]
    _blend(canvas, rows, cols, cols_rgb, alpha, clip)


def _r_scatter(ax, canvas, s, m, lim, clip):
    px, py = ax.transform(m["x"], m["y"], lim)
    rgb = np.array([to_rgb(c) for c in m["colors"]])
    _discs(canvas, px * s, py * s, math.sqrt(m["size"]) / 2 * s, rgb,
           m["alpha"], clip)


def _r_polyline(canvas, px, py, width, color, alpha, clip):
    xs, ys = [], []
    for a in range(len(px) - 1):
        n = max(int(math.hypot(px[a + 1] - px[a], py[a + 1] - py[a]) * 2), 1)
        t = np.linspace(0, 1, n + 1)
        xs.append(px[a] + t * (px[a + 1] - px[a]))
        ys.append(py[a] + t * (py[a + 1] - py[a]))
    if xs:
        _discs(canvas, np.concatenate(xs), np.concatenate(ys), width / 2,
               to_rgb(color), alpha, clip)


def _r_line(ax, canvas, s, m, lim, clip):
    px, py = ax.transform(m["x"], m["y"], lim)
    _r_polyline(canvas, px * s, py * s, m["width"] * s, m["color"], 1.0,
                clip)


def _fill_polygon(canvas, px, py, color, alpha, clip):
    """Fill a convex or star-shaped polygon (even-odd rule) of pixel
    coordinates."""
    r0, r1 = int(max(np.floor(py.min()), 0)), int(np.ceil(py.max()))
    c0, c1 = int(max(np.floor(px.min()), 0)), int(np.ceil(px.max()))
    yy, xx = np.mgrid[r0:r1 + 1, c0:c1 + 1] + 0.5
    inside = np.zeros(yy.shape, bool)
    x1, y1 = px, py
    x2, y2 = np.roll(px, -1), np.roll(py, -1)
    for a in range(len(px)):
        cond = (y1[a] > yy) != (y2[a] > yy)
        xc = x1[a] + (yy - y1[a]) * (x2[a] - x1[a]) / (y2[a] - y1[a] + 1e-300)
        inside ^= cond & (xx < xc)
    rows, cols = np.nonzero(inside)
    _blend(canvas, rows + r0, cols + c0, to_rgb(color), alpha, clip)


def _r_rect(ax, canvas, s, m, lim, clip):
    (ax_, bx), (ay, by) = ax.transform([m["x0"], m["x1"]],
                                       [m["y0"], m["y1"]], lim)
    xs = np.array([ax_, bx, bx, ax_]) * s
    ys = np.array([ay, ay, by, by]) * s
    if m["face"] is not None:
        _fill_polygon(canvas, xs, ys, m["face"], m["alpha"], clip)
    if m["edge"] is not None:
        _r_polyline(canvas, np.append(xs, xs[0]), np.append(ys, ys[0]),
                    m["width"] * s, m["edge"], 1.0, clip)


def _r_ellipse(ax, canvas, s, m, lim, clip):
    ex, ey = ax._ellipse_points(m, np.linspace(0, 2 * np.pi, 73))
    px, py = ax.transform(ex, ey, lim)
    _fill_polygon(canvas, px * s, py * s, m["face"], m["alpha"], clip)


def _r_arrow(ax, canvas, s, m, lim, clip):
    (tx, hx), (ty, hy) = ax.transform([m["t"][0], m["h"][0]],
                                      [m["t"][1], m["h"][1]], lim)
    tri = ax._arrow_head(tx, ty, hx, hy, m["scale"])
    _r_polyline(canvas, np.array([tx, tri[3][0]]) * s,
                np.array([ty, tri[3][1]]) * s, s, m["color"], 1.0, clip)
    _fill_polygon(canvas, np.array([p[0] for p in tri[:3]]) * s,
                  np.array([p[1] for p in tri[:3]]) * s, m["color"], 1.0,
                  clip)


def _r_image(ax, canvas, s, m, lim, clip):
    """Nearest-sample the image at every pixel centre of the axes box it
    covers, alpha-blended."""
    c0, r0, c1, r1 = clip
    rgba = m["rgba"]
    x0, x1, y0, y1 = m["extent"]
    rows, cols = np.mgrid[r0:r1, c0:c1]
    dx, dy = ax.inverse((cols + 0.5) / s, (rows + 0.5) / s, lim)
    j = np.floor((dx - x0) / (x1 - x0) * rgba.shape[1]).astype(np.int64)
    i = np.floor((y1 - dy) / (y1 - y0) * rgba.shape[0]).astype(np.int64)
    ok = (i >= 0) & (i < rgba.shape[0]) & (j >= 0) & (j < rgba.shape[1])
    px = rgba[i[ok], j[ok]]
    rr, cc = rows[ok], cols[ok]
    a = px[:, 3:4]
    canvas[rr, cc] = (1 - a) * canvas[rr, cc] + a * px[:, :3]


def _r_cells(ax, canvas, s, m, lim, clip):
    rgba = m["rgba"]
    n_rows, n_cols = rgba.shape[:2]
    c0, r0, c1, r1 = clip
    rows, cols = np.mgrid[r0:r1, c0:c1]
    dx, dy = ax.inverse((cols + 0.5) / s, (rows + 0.5) / s, lim)
    i = np.clip(np.floor(dy).astype(np.int64), 0, n_rows - 1)
    j = np.clip(np.floor(dx).astype(np.int64), 0, n_cols - 1)
    canvas[rows, cols] = rgba[i, j, :3]


_RASTER = {"scatter": _r_scatter, "line": _r_line, "rect": _r_rect,
           "ellipse": _r_ellipse, "arrow": _r_arrow, "image": _r_image,
           "cells": _r_cells}


class Figure:
    """A figure of ``width`` × ``height`` inches."""

    def __init__(self, width: float = 6.4, height: float = 4.8):
        self.width, self.height = float(width), float(height)
        self.axes = []

    @property
    def size_pt(self) -> tuple:
        return self.width * 72, self.height * 72

    def add_axes(self, rect=(0.125, 0.11, 0.775, 0.77)) -> Axes:
        """An axes at ``(left, bottom, width, height)`` figure fractions
        (matplotlib's default subplot by default)."""
        w, h = self.size_pt
        left, bottom, fw, fh = rect
        ax = Axes(self, (left * w, (1 - bottom - fh) * h, fw * w, fh * h))
        self.axes.append(ax)
        return ax

    def to_svg(self) -> str:
        w, h = self.size_pt
        out = ['<?xml version="1.0" encoding="utf-8" standalone="no"?>',
               f'<svg xmlns="http://www.w3.org/2000/svg" '
               f'xmlns:xlink="http://www.w3.org/1999/xlink" '
               f'width="{_n(w)}pt" height="{_n(h)}pt" '
               f'viewBox="0 0 {_n(w)} {_n(h)}" version="1.1">',
               f'<rect width="{_n(w)}" height="{_n(h)}" fill="#ffffff"/>']
        out += [ax.svg(i) for i, ax in enumerate(self.axes)]
        out.append("</svg>")
        return "\n".join(out) + "\n"

    def save_svg(self, path: str) -> str:
        with open(path, "w", encoding="utf-8") as f:
            f.write(self.to_svg())
        return path

    def to_frame(self, dpi: int = DPI) -> np.ndarray:
        """The figure as a ``[H, W, 3]`` float32 frame at ``dpi`` (no
        text)."""
        s = dpi / 72.0
        w, h = self.size_pt
        canvas = np.ones((int(round(h * s)), int(round(w * s)), 3))
        for ax in self.axes:
            ax.draw(canvas, s)
        return canvas.astype(np.float32)


def overlay_frames(fig: Figure, layers: list, dpi: int = DPI) -> np.ndarray:
    """Video frames of ``fig`` with points added one at a time (the JAX
    Tester's overlay videos): frame p draws, for each layer ``(axes,
    points [P, 2], size points², colour, cumulative)``, its point p, or
    its points 0..p with ``cumulative``. Each axes' limits are fixed
    first to hold all its layers' points, so the frames share one
    transform. Returns ``[P, H, W, 3]`` float32."""
    for ax, pts, size, color, _ in layers:
        if ax.xlim is None or ax.ylim is None:
            pts = np.asarray(pts, np.float64)
            ax.scatter(pts[:, 0], pts[:, 1], color, size)
            ax.xlim, ax.ylim = ax.limits()
            ax.marks.pop()
    s = dpi / 72.0
    base = fig.to_frame(dpi).astype(np.float64)
    n = max(len(pts) for _, pts, *_ in layers)
    frames = np.empty((n,) + base.shape, np.float32)
    for p in range(n):
        frame = base.copy()
        for ax, pts, size, color, cumulative in layers:
            pts = np.asarray(pts, np.float64)
            sel = pts[:p + 1] if cumulative else pts[p:p + 1]
            px, py = ax.transform(sel[:, 0], sel[:, 1])
            _discs(frame, px * s, py * s, math.sqrt(size) / 2 * s,
                   to_rgb(color), 1.0, ax.clip(s))
        frames[p] = frame
    return frames

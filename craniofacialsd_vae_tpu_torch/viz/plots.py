"""Plotting without matplotlib or seaborn (counterpart of ``viz/plots.py``)
and the Tester's figures, drawn through ``viz/svg.py``.

The helpers of JAX ``viz/plots.py``: ``gaussian_ellipse`` (the same
eigen-decomposition and angle, as the parameters of matplotlib's
``Ellipse``), ``plot_2d_arrow``, ``per_vertex_eigenvector_color`` (bwr)
and ``plot_confusion_matrix`` (seaborn's heatmap: YlGnBu, vmin 0, vmax 1,
``.2g`` annotations). ``create_alpha_cmap`` lives in ``viz/colors.py``.
``load_pickled_figure`` is not ported: it repairs matplotlib pickles, and
the port keeps a figure's data in an ``.npz`` instead.

``kde_bands`` is seaborn 0.13's bivariate ``kdeplot(fill=True,
levels=5)``: ``_statistics.KDE``'s defaults (Scott's factor, ``gridsize
200``, ``cut 3``) on scipy's ``gaussian_kde``, and iso-proportion levels
from ``thresh=0.05``; its filled bands are drawn as an image.

The figure functions take the numbers the JAX Tester hands seaborn and
return a ``Figure``: the embedding scatters, the KDE distribution figure
and the per-region grid (both rebuilt from their ``.npz`` state), the
traversal line plots, the confusion matrices and the pre/post boxplots.
"""

from __future__ import annotations

import numpy as np

from .colors import BWR_LUT, YLGNBU_LUT, lookup, to_rgb
from .svg import MARKERS, Figure

__all__ = ["gaussian_ellipse", "plot_2d_arrow",
           "per_vertex_eigenvector_color", "plot_confusion_matrix",
           "kde_bands", "heatmap_annotations", "confusion_figure",
           "region_confusion_figure", "scatter_figure",
           "distribution_state", "distribution_figure", "region_grid_state",
           "region_grid_figure", "traversal_figures", "boxplot_figure",
           "string_to_color", "class_palette",
           "CLASS_COLOURS", "OVERLAY_COLOUR"]

CLASS_COLOURS = ("#ed6e5d", "#74bfc2", "#eecd4a", "#124d81", "#dbcbbe")
CLASS_ORDER = ("n", "a", "c", "m")
OVERLAY_COLOUR = "#e881a7"
DEEP = ("#4c72b0", "#dd8452", "#55a868", "#c44e52", "#8172b3", "#937860",
        "#da8bc3", "#8c8c8c", "#ccb974", "#64b5cd")   # seaborn "deep"


# ------------------------------------------------- JAX viz/plots.py
def gaussian_ellipse(mean, covariance, color, n_sigma: int = 3) -> dict:
    """The ellipse of a 2-D Gaussian at ``n_sigma`` (JAX ``:25-38``): its
    matplotlib ``Ellipse``'s parameters (``center``, full ``width`` and
    ``height``, ``angle`` in degrees, colours, ``alpha`` 0.2,
    ``linewidth`` 2) as the keyword arguments of ``Axes.ellipse``."""
    from scipy.linalg import eigh

    v, w = eigh(covariance)
    u = w[0] / np.linalg.norm(w[0])
    angle = 180 * np.arctan2(u[1], u[0]) / np.pi
    return {"center": np.asarray(mean), "width": n_sigma * v[0] ** 0.5,
            "height": n_sigma * v[1] ** 0.5, "angle": 180 + angle,
            "facecolor": color, "edgecolor": color, "linewidth": 2,
            "alpha": 0.2}


def plot_2d_arrow(tail_coords, head_coords, ax, color: str = OVERLAY_COLOUR,
                  scale: int = 15):
    """An arrow between two embedding points (JAX ``:41-52``)."""
    ax.arrow(np.squeeze(tail_coords), np.squeeze(head_coords), color, scale)


def per_vertex_eigenvector_color(eigvecs: np.ndarray,
                                 eigenvec_n: int) -> np.ndarray:
    """RGBA float vertex colours from one Laplacian eigenvector through
    bwr, normalised between its min and max (JAX ``:55-64``)."""
    e = np.asarray(eigvecs)[:, eigenvec_n]
    if e.dtype.kind != "f":
        e = e.astype(np.float64)
    vmin, vmax = e.min(), e.max()
    norm = np.zeros_like(e) if vmin == vmax else (e - vmin) / (vmax - vmin)
    return lookup(BWR_LUT, norm)


def heatmap_annotations(matrix) -> list:
    """seaborn's ``annot=True`` text with ``fmt=".2g"``."""
    return [[format(float(v), ".2g") for v in row] for row in
            np.asarray(matrix)]


def _heatmap(fig, rect, cm, labels, title=""):
    left, bottom, width, height = rect
    ax = fig.add_axes((left, bottom, width * 0.8, height))
    ax.heatmap(cm, YLGNBU_LUT, 0.0, 1.0, heatmap_annotations(cm))
    ax.xticks = [(j + 0.5, str(c)) for j, c in enumerate(labels)]
    ax.yticks = [(i + 0.5, str(c)) for i, c in enumerate(labels)]
    ax.xlabel, ax.ylabel, ax.title = "Predicted Label", "True Label", title
    bar = fig.add_axes((left + width * 0.85, bottom, width * 0.05, height))
    ramp = lookup(YLGNBU_LUT, np.linspace(1, 0, 256))[:, None, :]
    bar.image(ramp, (0, 1, 0, 1))
    bar.xticks = []
    bar.yticks = [(t, f"{t:g}") for t in (0, 0.2, 0.4, 0.6, 0.8, 1.0)]
    return ax


def confusion_figure(cm, labels) -> Figure:
    """seaborn's ``heatmap(cm, annot=True, cmap="YlGnBu", vmin=0,
    vmax=1)`` with the labels on both axes."""
    fig = Figure()
    _heatmap(fig, (0.125, 0.11, 0.775, 0.77), cm, labels)
    return fig


def plot_confusion_matrix(data, labels, output_filename) -> str:
    """Heatmap SVG (JAX ``:67-81``)."""
    return confusion_figure(data, labels).save_svg(output_filename)


def region_confusion_figure(panels: list, n_cols: int = 5) -> Figure:
    """``panels``: ``[(title, matrix, labels)]`` on a grid of ``n_cols``
    columns, 7.5 × 6 inches each (JAX ``region_confmats_<m>.svg``)."""
    n_rows = -(-len(panels) // n_cols)
    fig = Figure(7.5 * n_cols, 6 * n_rows)
    for n, (title, cm, labels) in enumerate(panels):
        r, c = divmod(n, n_cols)
        _heatmap(fig, ((c + 0.15) / n_cols, 1 - (r + 0.88) / n_rows,
                       0.8 / n_cols, 0.7 / n_rows), cm, labels, title)
    return fig


# ---------------------------------------------------------------- KDE
def kde_bands(x1, x2, levels: int = 5, thresh: float = 0.05,
              gridsize: int = 200, cut: float = 3) -> dict | None:
    """seaborn 0.13's bivariate KDE of the points: the support grids
    ``x`` and ``y`` (``gridsize`` each, ``cut`` bandwidths past the
    data), ``density [y, x]`` and the iso-proportion ``levels`` (lowest
    first); None where seaborn skips it (no variance, or a singular
    covariance)."""
    from scipy.stats import gaussian_kde

    x1 = np.asarray(x1, np.float64)
    x2 = np.asarray(x2, np.float64)
    if min(np.var(x1, ddof=1), np.var(x2, ddof=1)) == 0:
        return None
    try:
        kde = gaussian_kde([x1, x2], bw_method="scott")
    except np.linalg.LinAlgError:
        return None
    kde.set_bandwidth(kde.factor)
    bw = np.sqrt(np.diag(kde.covariance).squeeze())
    grids = [np.linspace(v.min() - b * cut, v.max() + b * cut, gridsize)
             for v, b in zip((x1, x2), bw)]
    xx1, xx2 = np.meshgrid(*grids)
    density = kde([xx1.ravel(), xx2.ravel()]).reshape(xx1.shape)
    iso = np.linspace(thresh, 1, levels)
    values = np.sort(density.ravel())[::-1]
    idx = np.searchsorted(np.cumsum(values) / density.sum(), 1 - iso)
    return {"x": grids[0], "y": grids[1], "density": density,
            "levels": np.take(values, idx, mode="clip")}


def _band_image(kde: dict, color, alpha: float = 0.5) -> tuple:
    """The filled bands between the levels as an RGBA image (row 0 at the
    top) and its extent: band ``b`` of 4 a tint of ``color`` from light
    to full, like seaborn's sequential map from one colour."""
    band = np.digitize(kde["density"], kde["levels"]) - 1
    n = len(kde["levels"]) - 1
    band = np.where(band >= n, n - 1, band)
    rgb = np.asarray(to_rgb(color))
    f = 0.25 + 0.75 * (np.arange(n) + 0.5) / n
    tints = (1 - f[:, None]) + f[:, None] * rgb
    img = np.zeros(band.shape + (4,))
    on = band >= 0
    img[on, :3] = tints[band[on]]
    img[on, 3] = alpha
    x, y = kde["x"], kde["y"]
    dx, dy = (x[1] - x[0]) / 2, (y[1] - y[0]) / 2
    return img[::-1], (x[0] - dx, x[-1] + dx, y[0] - dy, y[-1] + dy)


# ------------------------------------------------------ the embeddings
def class_palette(present) -> tuple:
    """(hue order, {class: colour}) of JAX ``plot_embeddings``: classes
    n, a, c, m in that order where present, each its own colour."""
    order = [c for c in CLASS_ORDER if c in set(present)]
    return order, dict(zip(CLASS_ORDER, CLASS_COLOURS))


def scatter_figure(x1, x2, hue, style, hue_order, palette: dict,
                   style_order, hue_title: str = "class",
                   style_title: str = "type") -> Figure:
    """seaborn's ``scatterplot(hue=…, style=…)``: markers of area 36 with
    white edges, one marker shape a style level, a legend of both."""
    fig = Figure()
    ax = fig.add_axes()
    hue, style = np.asarray(hue), np.asarray(style)
    for k, s in enumerate(style_order):
        on = style == s
        ax.scatter(np.asarray(x1)[on], np.asarray(x2)[on],
                   [palette[c] for c in hue[on]], 36, MARKERS[k],
                   edgecolor="w")
    ax.xlabel, ax.ylabel = "x1", "x2"
    ax.legend = [(hue_title, [(c, (palette[c], "o")) for c in hue_order]),
                 (style_title, [(str(s), ("#404040", MARKERS[k]))
                                for k, s in enumerate(style_order)])]
    return fig


def distribution_state(x1, x2, cls, hue_order, palette: dict) -> dict:
    """The KDE distribution figure's data (JAX ``*_emb_distributions``):
    the real train points and their classes, and per class of at least
    five points its KDE grid, density and levels; arrays for
    ``np.savez``."""
    x1, x2, cls = np.asarray(x1, np.float64), np.asarray(x2, np.float64), \
        np.asarray(cls).astype(str)
    state = {"x1": x1, "x2": x2, "cls": cls,
             "hue_order": np.asarray(hue_order, dtype=str),
             "colors": np.asarray([palette[c] for c in hue_order],
                                  dtype=str)}
    for c in hue_order:
        on = cls == c
        kde = kde_bands(x1[on], x2[on]) if on.sum() >= 5 else None
        if kde is not None:
            for k, v in kde.items():
                state[f"kde_{k}_{c}"] = v
    return state


def distribution_figure(state: dict) -> tuple:
    """The figure of ``distribution_state``: per class its filled KDE
    bands (alpha 0.5), then its points (area 6); a legend of the
    classes. Returns (figure, axes)."""
    fig = Figure()
    ax = fig.add_axes()
    cls = np.asarray(state["cls"]).astype(str)
    order = [str(c) for c in state["hue_order"]]
    colors = dict(zip(order, [str(c) for c in state["colors"]]))
    for c in order:
        if f"kde_levels_{c}" in state:
            img, extent = _band_image({k: state[f"kde_{k}_{c}"] for k in (
                "x", "y", "density", "levels")}, colors[c])
            ax.image(img, extent)
        on = cls == c
        ax.scatter(state["x1"][on], state["x2"][on], colors[c], 6)
    ax.legend = [(None, [(c, (colors[c], "o")) for c in order])]
    return fig, ax


def region_grid_state(x1, x2, cls, region, hue_order) -> dict:
    """The per-region grid's data (JAX ``emb_all_train_dist``): every
    real train point's 2-D projection in its region's panel, the regions
    in order of appearance, the class colours by position in
    ``hue_order``."""
    region = np.asarray(region).astype(str)
    _, first = np.unique(region, return_index=True)
    return {"x1": np.asarray(x1, np.float64),
            "x2": np.asarray(x2, np.float64),
            "cls": np.asarray(cls).astype(str), "region": region,
            "region_order": region[np.sort(first)],
            "hue_order": np.asarray(hue_order, dtype=str),
            "colors": np.asarray(CLASS_COLOURS[:len(hue_order)], dtype=str)}


def _facets(n: int, col_wrap: int, height: float) -> tuple:
    """A FacetGrid's figure and its ``n`` panels on ``col_wrap`` columns
    of ``height``-inch squares, with a legend column on the right."""
    n_cols, n_rows = min(n, col_wrap), -(-n // col_wrap)
    legend_w = 1.2
    fig = Figure(n_cols * height + legend_w, n_rows * height)
    fw = n_cols * height + legend_w
    axes = []
    for k in range(n):
        r, c = divmod(k, col_wrap)
        axes.append(fig.add_axes(((c * height + 0.22 * height) / fw,
                                  1 - (r + 0.82) / n_rows,
                                  0.7 * height / fw, 0.66 / n_rows)))
    return fig, axes


def _share_limits(axes, extra_points=()) -> None:
    """FacetGrid's shared axes: every panel the limits of their union,
    autoscaled over ``extra_points`` too."""
    pts = np.asarray(extra_points, np.float64).reshape(-1, 2)
    lims = []
    for ax in axes:
        if len(pts):
            ax.scatter(pts[:, 0], pts[:, 1], "k")
        lims.append(ax.limits())
        if len(pts):
            ax.marks.pop()
    ax_lims = [(min(l[a][0] for l in lims), max(l[a][1] for l in lims))
               for a in (0, 1)]
    for ax in axes:
        ax.xlim, ax.ylim = ax_lims


def region_grid_figure(state: dict, extra_points=()) -> tuple:
    """The per-region FacetGrid (``col_wrap=5``, 2-inch panels, points of
    area 10 by class, shared limits that also hold ``extra_points``).
    Returns (figure, {region name: axes})."""
    order = [str(r) for r in state["region_order"]]
    classes = [str(c) for c in state["hue_order"]]
    colors = dict(zip(classes, [str(c) for c in state["colors"]]))
    fig, axes = _facets(len(order), 5, 2.0)
    region = np.asarray(state["region"]).astype(str)
    cls = np.asarray(state["cls"]).astype(str)
    for ax, name in zip(axes, order):
        for c in classes:
            on = (region == name) & (cls == c)
            ax.scatter(state["x1"][on], state["x2"][on], colors[c], 10,
                       edgecolor="w")
        ax.title = name
    _share_limits(axes, extra_points)
    axes[-1].legend = [("class", [(c, (colors[c], "o")) for c in classes])]
    axes[-1].legend_outside = True
    return fig, dict(zip(order, axes))


# ------------------------------------------------ traversals, boxplots
def traversal_figures(rows: list, palette: dict) -> tuple:
    """JAX ``latent_traversals``' plots of the rows ``{"mean_dist",
    "z_var", "region"}``: the FacetGrid by region (``col_wrap=4``,
    3-inch panels, lines with round markers) and the relplot of every
    region's line on one axes. Returns (split figure, line figure)."""
    regions = list(dict.fromkeys(r["region"] for r in rows))
    series = {g: ([r["z_var"] for r in rows if r["region"] == g],
                  [r["mean_dist"] for r in rows if r["region"] == g])
              for g in regions}
    split, axes = _facets(len(regions), 4, 3.0)
    for ax, g in zip(axes, regions):
        ax.plot(*series[g], palette[g], marker="o")
        ax.title = f"region = {g}"
        ax.xlabel, ax.ylabel = "z_var", "mean_dist"
    _share_limits(axes)
    line = Figure(5 + 1.8, 5)
    ax = line.add_axes((0.12, 0.1, 0.6, 0.85))
    for g in regions:
        ax.plot(*series[g], palette[g])
    ax.xlabel, ax.ylabel = "z_var", "mean_dist"
    ax.legend = [("region", [(g, (palette[g], "-")) for g in regions])]
    ax.legend_outside = True
    return split, line


def _box_stats(v: np.ndarray) -> dict:
    """matplotlib's ``boxplot_stats`` at ``whis=1.5``."""
    q1, med, q3 = np.percentile(v, [25, 50, 75])
    iqr = q3 - q1
    lo = v[v >= q1 - 1.5 * iqr]
    hi = v[v <= q3 + 1.5 * iqr]
    return {"q1": q1, "med": med, "q3": q3,
            "whislo": lo.min() if len(lo) else q1,
            "whishi": hi.max() if len(hi) else q3,
            "fliers": v[(v < q1 - 1.5 * iqr) | (v > q3 + 1.5 * iqr)]}


def boxplot_figure(rows: list, hue: str = "Procedure",
                   drop=("Syndrome",)) -> tuple:
    """seaborn's ``boxplot(data=melt(rows, id_vars=hue), x="variable",
    y="value", hue=hue)``, missing values 0, x labels turned 30°.
    Returns (figure, {(variable, hue level): box stats})."""
    columns = []
    for r in rows:
        columns += [k for k in r if k not in columns and k != hue
                    and k not in drop]
    levels = list(dict.fromkeys(str(r.get(hue)) for r in rows))
    fig = Figure()
    ax = fig.add_axes()
    width = 0.8 / max(len(levels), 1)
    stats = {}
    for i, var in enumerate(columns):
        for j, level in enumerate(levels):
            v = np.asarray([float(r.get(var) or 0.0) for r in rows
                            if str(r.get(hue)) == level])
            if not len(v):
                continue
            st = stats[(var, level)] = _box_stats(v)
            x = i - 0.4 + width * (j + 0.5)
            c = DEEP[j % len(DEEP)]
            ax.rect(x - width * 0.4, st["q1"], x + width * 0.4, st["q3"],
                    c, "#3f3f3f")
            for a, b in ((st["whislo"], st["q1"]), (st["q3"], st["whishi"])):
                ax.plot([x, x], [a, b], "#3f3f3f", linewidth=1)
            ax.plot([x - width * 0.4, x + width * 0.4], [st["med"]] * 2,
                    "#3f3f3f", linewidth=1.5)
            if len(st["fliers"]):
                ax.scatter(np.full(len(st["fliers"]), x), st["fliers"],
                           "#3f3f3f", 25, "D")
    ax.xlim = (-0.5, len(columns) - 0.5)
    ax.xticks = [(i, c) for i, c in enumerate(columns)]
    ax.xtick_rotation = 30
    ax.xlabel, ax.ylabel = "variable", "value"
    ax.legend = [(hue, [(lv, (DEEP[j % len(DEEP)], "s"))
                        for j, lv in enumerate(levels)])]
    return fig, stats


def string_to_color(key: str, swap_bw: bool = True) -> tuple:
    """A region key ``"[r g b a]"`` as an RGB float tuple, white as black
    (the JAX Tester's ``string_to_color``)."""
    vals = [int(c) / 255 for c in key[1:-1].split()[:-1]]
    if vals == [1.0, 1.0, 1.0] and swap_bw:
        vals = [0.0, 0.0, 0.0]
    return tuple(vals)

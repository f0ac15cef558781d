"""The port's figures without matplotlib (``viz/colors.py``,
``viz/plots.py``, ``viz/svg.py`` and the Tester's figures) against
matplotlib, seaborn and the JAX Tester, on the CPU.

The run dir is ``tests/test_torch_diagnosis.py``'s JAX-written one (the
3-region octasphere of subdivision 2, latent 6, a fitted zoo); Testers
render at 32² (``small_tester_renders``).

Tolerances: the colour tables equal matplotlib's exactly; the Gaussian
ellipse's centre, axes and angle within 1e-12 of JAX's ``Ellipse``;
seaborn's KDE grid, density and levels within 1e-6 relative; markers read
back from an SVG through its axes' inverse transform within 1e-6 of the
axis span of the Tester's figure data; heatmap annotations equal JAX's
confusion matrices as ``.2g`` text; overlay pixels exactly the overlay
colour; the Tester's set of files equal to JAX's with ``.pkl`` read as
``.npz`` and ``.mp4`` as ``.avi``."""

import os
import re
import xml.etree.ElementTree as ET

import numpy as np
import pytest

import jax  # noqa: F401  (both packages in one process, JAX on the CPU)
from craniofacialsd_vae_tpu_torch.viz import colors as C
from craniofacialsd_vae_tpu_torch.viz import plots as P
from craniofacialsd_vae_tpu_torch.viz import svg as S
from tests.test_torch_diagnosis import jax_run  # noqa: F401  (fixture)
from tests.test_torch_tester import (_jax_side, _patient_files, _port_side,
                                     small_tester_renders)
from tests.test_torch_tester import one_torch_thread  # noqa: F401
from tests.test_torch_video import walk_avi

NS = "{http://www.w3.org/2000/svg}"


# ------------------------------------------------------------- colours
@pytest.mark.parametrize("name", ["YlGnBu", "bwr"])
def test_colour_tables_equal_matplotlib(name):
    import matplotlib

    cmap = matplotlib.colormaps[name]
    table = {"YlGnBu": C.YLGNBU_LUT, "bwr": C.BWR_LUT}[name]
    np.testing.assert_array_equal(table, cmap(np.linspace(0, 1, 256)))
    x = np.concatenate([np.linspace(-0.2, 1.2, 2001), [np.nan, 1.0, 0.0]])
    np.testing.assert_array_equal(C.lookup(table, x), cmap(x))


@pytest.mark.parametrize("color", ["#ed6e5d", "#124d81", "r", "k"])
def test_alpha_cmap_equals_jax(color):
    from craniofacialsd_vae_tpu.viz.plots import create_alpha_cmap

    np.testing.assert_array_equal(C.create_alpha_cmap(color),
                                  create_alpha_cmap(color).colors)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_eigenvector_colours_equal_jax(dtype):
    from craniofacialsd_vae_tpu.viz.plots import per_vertex_eigenvector_color

    vecs = np.random.default_rng(0).normal(size=(300, 4)).astype(dtype)
    for k in range(4):
        np.testing.assert_array_equal(
            P.per_vertex_eigenvector_color(vecs, k),
            per_vertex_eigenvector_color(vecs, k))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gaussian_ellipse_equals_jax_patch(seed):
    from craniofacialsd_vae_tpu.viz.plots import gaussian_ellipse

    rng = np.random.default_rng(seed)
    a = rng.normal(size=(2, 2))
    cov, mean = a @ a.T + 0.1 * np.eye(2), rng.normal(size=2)
    want = gaussian_ellipse(mean, cov, "#74bfc2")
    got = P.gaussian_ellipse(mean, cov, "#74bfc2")
    np.testing.assert_allclose(got["center"], want.get_center(),
                               atol=1e-12)
    for k in ("width", "height", "angle"):
        assert got[k] == pytest.approx(getattr(want, k), abs=1e-12), k
    assert got["alpha"] == want.get_alpha()
    assert got["linewidth"] == want.get_linewidth()
    fig = S.Figure()
    fig.add_axes().ellipse(**got)          # drawn as matplotlib draws it
    ET.fromstring(fig.to_svg())


# ------------------------------------------------------------------ KDE
@pytest.mark.parametrize("seed", [0, 1])
def test_kde_grid_and_levels_match_seaborn(seed):
    from seaborn._statistics import KDE
    from seaborn.distributions import _DistributionPlotter

    rng = np.random.default_rng(seed)
    x1 = rng.normal(size=25)
    x2 = 0.5 * x1 + rng.normal(scale=0.7, size=25)
    density, (gx, gy) = KDE()(x1, x2)
    levels = _DistributionPlotter._quantile_to_level(
        None, density, np.linspace(0.05, 1, 5))
    got = P.kde_bands(x1, x2)
    for g, w in ((got["x"], gx), (got["y"], gy),
                 (got["density"], density), (got["levels"], levels)):
        assert np.abs(g - w).max() <= 1e-6 * np.abs(w).max()
    assert P.kde_bands(np.ones(6), np.arange(6.0)) is None


# ----------------------------------------------------- Tester's figures
@pytest.fixture(scope="module")
def port_figures(jax_run, tmp_path_factory):
    """The port's Tester on the JAX run dir: the LDA embeddings and the
    classifiers' figures drawn."""
    with small_tester_renders():
        tt, _ = _port_side(jax_run["run_dir"],
                           str(tmp_path_factory.mktemp("figures")))
        tt.plot_embeddings()
        tt.test_classifiers()
    return tt


def svg_axes(path: str) -> list:
    """Each axes of an SVG: its markers ``[M, 2]`` in data coordinates
    (through the axes' inverse transform), their fills, its span, and its
    annotation texts."""
    out = []
    for g in ET.parse(path).getroot().iter(NS + "g"):
        if g.get("class") != "axes":
            continue
        x0, y0, w, h = map(float, g.get("data-box").split())
        xlo, xhi = map(float, g.get("data-xlim").split())
        ylo, yhi = map(float, g.get("data-ylim").split())
        inverted = g.get("data-yinverted") == "1"
        pts, fills = [], []
        for el in g.iter():
            if el.get("class") != "marker":
                continue
            if el.tag == NS + "circle":
                px, py = float(el.get("cx")), float(el.get("cy"))
            else:
                px, py = map(float, re.match(
                    r"translate\(([-\d.]+) ([-\d.]+)\)",
                    el.get("transform")).groups())
            fy = (py - y0) / h
            pts.append((xlo + (px - x0) / w * (xhi - xlo),
                        ylo + (fy if inverted else 1 - fy) * (yhi - ylo)))
            fills.append(el.get("fill"))
        annot = [el.text for el in g.iter(NS + "text")
                 if el.get("class") == "annot"]
        out.append({"points": np.asarray(pts).reshape(-1, 2),
                    "fills": fills, "span": (xhi - xlo, yhi - ylo),
                    "annot": annot})
    return out


def test_scatter_markers_read_back_equal_the_figure_data(port_figures):
    tt = port_figures
    for name, style, order in (
            ("lda_emb_train_vs_test.svg", "type", ["train", "test"]),
            ("lda_emb_real_vs_aug.svg", "aug", [False, True])):
        data = tt.figure_data[name]
        ax = svg_axes(os.path.join(tt._out_dir, name))[0]
        want = np.concatenate([np.stack([data["x1"], data["x2"]], 1)[
            np.asarray(data[style]) == s] for s in order])
        assert ax["points"].shape == want.shape
        span = np.asarray(ax["span"])
        assert (np.abs(ax["points"] - want) <= 1e-6 * span).all()
        classes = np.concatenate([np.asarray(data["class"])[
            np.asarray(data[style]) == s] for s in order])
        palette = dict(zip(P.CLASS_ORDER, P.CLASS_COLOURS))
        assert ax["fills"] == [palette[c] for c in classes]
    # the KDE figure: its .npz state, its points, one band image a class
    state = tt.figure_data["lda_emb_distributions.svg"]
    with np.load(os.path.join(tt._out_dir, "lda_emb_distributions.npz")) \
            as z:
        for k in state:
            np.testing.assert_array_equal(z[k], state[k])
    ax = svg_axes(os.path.join(tt._out_dir, "lda_emb_distributions.svg"))[0]
    want = np.concatenate([np.stack([state["x1"], state["x2"]], 1)[
        state["cls"] == c] for c in state["hue_order"]])
    assert (np.abs(ax["points"] - want) <= 1e-6 * np.asarray(ax["span"])
            ).all()
    # the per-region grid: a panel a region, its points the real train
    # latents' projections
    grid = tt.figure_data["emb_all_train.svg"]
    panels = svg_axes(os.path.join(tt._out_dir, "emb_all_train.svg"))
    assert len(panels) == len(grid["region_order"])
    for ax, region in zip(panels, grid["region_order"]):
        on = grid["region"] == region
        want = np.concatenate([np.stack([grid["x1"], grid["x2"]], 1)[
            on & (grid["cls"] == c)] for c in grid["hue_order"]])
        assert (np.abs(ax["points"] - want) <= 1e-6 * np.asarray(
            ax["span"])).all()


def test_confusion_annotations_equal_jax(jax_run, port_figures, tmp_path,
                                         monkeypatch):
    """Each ``confmat_<head>.svg``'s cell texts are JAX's normalised
    confusion matrix as seaborn's ``.2g`` text, row by row."""
    from craniofacialsd_vae_tpu.analysis.tester import Tester as JTester

    seen = {}
    monkeypatch.setattr(JTester, "_plot_confusion_matrix", staticmethod(
        lambda cm, labels, path: seen.__setitem__(
            os.path.basename(path), (cm, list(labels)))))
    monkeypatch.setattr(JTester, "confusion_matrices_per_region",
                        lambda *a, **k: None)
    with small_tester_renders():
        jt, _ = _jax_side(jax_run["run_dir"], str(tmp_path))
        jt.test_classifiers()
    tt = port_figures
    assert set(seen) == {n for n in tt.figure_data
                         if n.startswith("confmat_")}
    for name, (cm, labels) in seen.items():
        ax = svg_axes(os.path.join(tt._out_dir, name))[0]
        assert ax["annot"] == [format(float(v), ".2g")
                               for v in np.asarray(cm).ravel()], name
        assert list(tt.figure_data[name]["labels"]) == labels
    panels = svg_axes(os.path.join(tt._out_dir, "region_confmats_qda.svg"))
    want = tt.figure_data["region_confmats_qda.svg"]
    cells = [p for p in panels if p["annot"]]
    assert [p["annot"] for p in cells] == [
        [format(float(v), ".2g") for v in cm.ravel()]
        for _, cm in want.values()]


def test_overlay_frames_show_the_points_in_the_overlay_colour(
        port_figures):
    """Frame p of a walk's videos: on the KDE figure, points 0..p at
    their transformed pixels in ``#e881a7``; on the region grid, point p
    in every panel."""
    tt = port_figures
    state = tt._figure_state("lda_emb_distributions")
    rng = np.random.default_rng(0)
    lo = np.array([state["x1"].min(), state["x2"].min()])
    hi = np.array([state["x1"].max(), state["x2"].max()])
    walk = lo + rng.uniform(size=(5, 2)) * (hi - lo)
    fig, ax = P.distribution_figure(state)
    frames = S.overlay_frames(fig, [(ax, walk, 6, P.OVERLAY_COLOUR, True)])
    assert frames.shape == (5, 480, 640, 3)
    pink = np.asarray(C.to_rgb(P.OVERLAY_COLOUR), np.float32)
    s = S.DPI / 72
    for p in range(5):
        px, py = ax.transform(walk[:p + 1, 0], walk[:p + 1, 1])
        got = frames[p][(py * s).astype(int), (px * s).astype(int)]
        np.testing.assert_array_equal(got, np.broadcast_to(pink, got.shape))
    grid = tt._figure_state("emb_all_train_dist")
    fig, axes = P.region_grid_figure(grid, walk)
    frames = S.overlay_frames(fig, [(a, walk, 2, P.OVERLAY_COLOUR, False)
                                    for a in axes.values()])
    for p in range(5):
        for a in axes.values():
            px, py = a.transform(walk[p, 0], walk[p, 1])
            np.testing.assert_array_equal(
                frames[p][int(py * s), int(px * s)], pink)


def _files(root: str) -> set:
    out = set()
    for d, _, names in os.walk(root):
        for n in names:
            rel = os.path.relpath(os.path.join(d, n), root)
            out.add(re.sub(r"\.pkl$", ".npz", re.sub(r"\.mp4$", ".avi",
                                                      rel)))
    return out


def test_tester_writes_the_files_jax_writes(jax_run, tmp_path, monkeypatch):
    """The traversals, embeddings, classifiers, interpolations, a plan
    with its overlays, a patient's projection and the pre/post batch with
    its boxplots, on both Testers: the same files."""
    from craniofacialsd_vae_tpu.geometry import template as jtpl
    from craniofacialsd_vae_tpu_torch.geometry import template as ttpl

    scans = _patient_files(jax_run, str(tmp_path))
    names = [os.path.basename(p) for p in scans]
    table = tmp_path / "pairs.csv"
    table.write_text("PID,Pre name,Post name,Surgery regions,Procedure,"
                     f"Syndrome\n1,{names[0]},{names[1]},monobloc,monobloc,"
                     f"Apert\n2,{names[1]},{names[2]},monobloc,le_fort_III,"
                     "Crouzon\n")
    dirs = {}
    with small_tester_renders():
        jt, _ = _jax_side(jax_run["run_dir"], str(tmp_path / "jax"))
        tt, _ = _port_side(jax_run["run_dir"], str(tmp_path / "port"))
        keys = list(tt._manager.latent_regions)[:2]
        for tab in (jtpl.PROCEDURES2ATTRIBUTES, ttpl.PROCEDURES2ATTRIBUTES):
            monkeypatch.setitem(tab, "monobloc", keys)
        raw = jax_run["raw"]
        for t in (jt, tt):
            t.set_rendering_background_color(1.0)
            t.latent_traversals(use_z_stats=False)
            t.plot_embeddings()
            t.test_classifiers()
            t.interpolate(raw[0], raw[3])
            t.interpolate_syndrome_to_normal(scans[0])
            t.classify_and_project(scans[1])
            t.evaluate_all_pre_post_pairs_in_excel(str(tmp_path), str(table))
            dirs[t] = t._out_dir
    assert _files(dirs[tt]) == _files(dirs[jt])
    # every SVG parses, every video walks to its frames
    for rel in _files(dirs[tt]):
        path = os.path.join(dirs[tt], rel)
        if rel.endswith(".svg"):
            ET.parse(path)
        elif rel.endswith(".avi"):
            walked = walk_avi(open(path, "rb").read())
            assert walked["total"] == len(walked["index"]) \
                == len(walked["frames"]) > 0
    svgs = {r for r in _files(dirs[tt]) if r.endswith(".svg")}
    assert svgs <= set(tt.figure_data)
    walk = os.path.join("interpolations", "scan_0_all_attributes",
                        "scan_0_all_attributes_emb_interpolate.avi")
    walked = walk_avi(open(os.path.join(dirs[tt], walk), "rb").read())
    data = tt.figure_data[walk]
    assert len(walked["frames"]) == data["frames"] == len(data["points"]) > 1


def test_tsne_embedding_figures(port_figures, monkeypatch):
    """``plot_embeddings("tsne")`` writes the three t-SNE figures from the
    port's t-SNE (at perplexity 5 here: this run has fewer latents than
    the default 30 needs, where sklearn raises as the port does)."""
    from craniofacialsd_vae_tpu_torch.analysis import tsne

    tt = port_figures
    with pytest.raises(ValueError, match="perplexity"):
        tt.plot_embeddings("tsne")
    run = tsne.tsne
    monkeypatch.setattr(tsne, "tsne", lambda x, **k: run(
        x, perplexity=5.0, max_iter=300, **k))
    out = tt.plot_embeddings("tsne")
    for name in ("tsne_emb_train_vs_test.svg", "tsne_emb_real_vs_aug.svg",
                 "tsne_emb_distributions.svg",
                 "tsne_emb_distributions.npz"):
        assert os.path.isfile(os.path.join(tt._out_dir, name)), name
    data = tt.figure_data["tsne_emb_train_vs_test.svg"]
    np.testing.assert_array_equal(
        data["x1"], np.concatenate([out["train"][:, 0], out["test"][:, 0]]))
    again = tt.plot_embeddings("tsne")
    np.testing.assert_array_equal(again["train"], out["train"])


def test_pkl_only_run_dir_recomputes_the_figure_state(port_figures):
    """A run dir with JAX's pickled figures and no ``.npz``: the overlays
    recompute the state from the run's train latents (the same as the
    ``.npz`` the port writes)."""
    tt = port_figures
    out = tt._out_dir
    for name in ("lda_emb_distributions", "emb_all_train_dist"):
        want = tt._figure_state(name)
        os.rename(os.path.join(out, name + ".npz"),
                  os.path.join(out, name + ".npz.bak"))
        try:
            assert tt._figure_state(name) is None
            open(os.path.join(out, name + ".pkl"), "wb").close()
            got = tt._figure_state(name)
        finally:
            os.remove(os.path.join(out, name + ".pkl"))
            os.rename(os.path.join(out, name + ".npz.bak"),
                      os.path.join(out, name + ".npz"))
        assert set(got) == set(want)
        for k in want:
            if want[k].dtype.kind == "f":
                np.testing.assert_allclose(got[k], want[k], rtol=1e-12)
            else:
                np.testing.assert_array_equal(got[k], want[k])



def test_figures_videos_and_tsne_run_with_the_missing_libraries_blocked(
        tmp_path):
    """In a process where matplotlib, seaborn, PIL, imageio, sklearn,
    pandas and JAX cannot be imported: the KDE figure, a confusion
    matrix, a boxplot, t-SNE and an AVI, written."""
    import subprocess
    import sys

    from tests.test_torch_isolation import FORBIDDEN, REPO

    code = f"""
import sys
sys.modules.update(dict.fromkeys({FORBIDDEN!r}))
import numpy as np
from craniofacialsd_vae_tpu_torch.analysis import tester, tsne
from craniofacialsd_vae_tpu_torch.viz import plots, svg, video
rng = np.random.default_rng(0)
x = rng.normal(size=(40, 2))
cls = np.array(list("nac") * 13 + ["n"])
order, pal = plots.class_palette(cls)
fig, ax = plots.distribution_figure(plots.distribution_state(
    x[:, 0], x[:, 1], cls, order, pal))
fig.save_svg({str(tmp_path / "kde.svg")!r})
plots.plot_confusion_matrix(np.eye(3) / 2, order, {str(tmp_path / "cm.svg")!r})
plots.boxplot_figure([{{"Procedure": "m", "chin": 1.0}}])[0].save_svg(
    {str(tmp_path / "box.svg")!r})
emb = tsne.tsne(rng.normal(size=(35, 4)).astype(np.float32), max_iter=250)
frames = svg.overlay_frames(fig, [(ax, emb["embedding"][:3], 6, "#e881a7",
                                   True)])
video.write_video({str(tmp_path / "walk.mp4")!r}, frames, fps=4)
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    for name in ("kde.svg", "cm.svg", "box.svg", "walk.avi"):
        assert (tmp_path / name).is_file(), name

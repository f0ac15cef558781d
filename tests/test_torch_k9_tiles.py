"""K9's vertex tiles (``ops/eigh.py::build_k9_tiles``) and the panel
layout of the Chebyshev solver, on the CPU.

The tiles are what the card's K9 walks: each block stages one tile's
rows and forms its vertices' sums through the local indices. So besides
the tile build's invariants, the plain step is computed here tile by tile
through those indices, the kernel's data flow, and held bit-equal to
``cheby_step_plain``; ``tests/test_torch_eigh.py`` holds the twin against
JAX's ``_laplacian_matvec``.
"""

import numpy as np
import pytest
import torch

from craniofacialsd_vae_tpu_torch.geometry import synthetic_template
from craniofacialsd_vae_tpu_torch.ops import eigh

SUBDIVISIONS = [2, 3, 4, 5, 6]


def _lap(subdivisions):
    tpl = synthetic_template(subdivisions, 3)
    return tpl, eigh._EllLaplacian(tpl, torch.device("cpu"))


def _random_table(n, k, seed):
    """A runtime-K table (K ≠ 7): random columns, some padding entries
    (row 0, weight 0)."""
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, n, (n, k)).astype(np.int32)
    vals = rng.standard_normal((n, k)).astype(np.float32)
    pad = rng.random((n, k)) < 0.2
    cols[pad], vals[pad] = 0, 0.0
    return torch.from_numpy(cols), torch.from_numpy(vals)


def _check_tiles(tiles, cols, max_verts, max_rows):
    """Every vertex owned once; each tile's rows sorted, distinct and
    within the maxima; local indices inside the tile; ``table()`` is the
    table and the row itself."""
    n, k = cols.shape
    verts = tiles.verts.long()
    starts, off = tiles.starts.long(), tiles.src_off.long()
    assert torch.equal(torch.sort(verts).values, torch.arange(n))
    assert int(starts[0]) == 0 and int(starts[-1]) == n
    assert int(off[0]) == 0 and int(off[-1]) == tiles.src.shape[0]
    sizes, rows = torch.diff(starts), torch.diff(off)
    assert bool((sizes >= 1).all()) and bool((rows >= 1).all())
    assert int(sizes.max()) == tiles.max_verts <= max_verts
    assert int(rows.max()) == tiles.max_rows <= max_rows
    tile = torch.repeat_interleave(torch.arange(tiles.n_tiles), sizes)
    local = tiles.local.long()
    assert local.shape == (n, k + 1)
    assert bool((local >= 0).all()) and bool((local < rows[tile, None]).all())
    for t in range(tiles.n_tiles):
        src = tiles.src[off[t]:off[t + 1]].long()
        assert bool((src[1:] > src[:-1]).all())          # sorted, distinct
        owned = verts[starts[t]:starts[t + 1]]
        want = torch.unique(torch.cat([cols[owned].long().reshape(-1),
                                       owned]))
        assert torch.equal(src, want)                    # no row unused
    table = tiles.table()
    assert torch.equal(table[:, :k], cols)
    assert torch.equal(table[:, k].long(), torch.arange(n))


@pytest.mark.parametrize("subdivisions", SUBDIVISIONS)
def test_k9_tiles_of_the_laplacian(subdivisions):
    """The solver's tiles of the octasphere's ELL Laplacian (padding
    entries included: the six degree-4 vertices' rows end in row 0)."""
    tpl, lap = _lap(subdivisions)
    _check_tiles(lap.tiles, lap.cols, eigh.K9_TILE_VERTS, eigh.K9_TILE_ROWS)
    assert bool((lap.vals == 0).any())
    assert lap.tiles_s > 0.0
    n = tpl.num_vertices
    if n > eigh.K9_TILE_VERTS:      # Morton runs: a compact patch a tile
        assert lap.tiles.src.shape[0] / n < 1.9


@pytest.mark.parametrize("k,max_rows", [(11, 256), (11, 40), (1, 256),
                                        (32, 33)])
def test_k9_tiles_of_a_runtime_k_table(k, max_rows):
    """A table whose rows are not 7 wide, in vertex order; small row
    budgets force the halving (down to single vertices at 33 rows for
    K = 32)."""
    cols, _ = _random_table(300, k, seed=k + max_rows)
    tiles = eigh.build_k9_tiles(cols, max_rows=max_rows)
    _check_tiles(tiles, cols, eigh.K9_TILE_VERTS, max_rows)
    if max_rows < 2 * (k + 1):
        assert tiles.n_tiles > 300 // eigh.K9_TILE_VERTS + 1


def test_k9_tile_sizes_match_the_kernel():
    """``build_k9_tiles``' default tiles are ones the wrapper takes: at most
    its vertices a tile (the kernel's 64: 32 p values a lane), and rows
    of a 128-column slice within 64 KB of shared memory a block (the
    card test ``test_cheby_step_tiles_fit_the_card`` holds both against
    the kernel's own limit)."""
    from craniofacialsd_vae_tpu_torch import kernels

    assert eigh.K9_TILE_VERTS == kernels._CHEBY_MAX_VERTS == 64
    assert eigh.K9_TILE_ROWS * 128 * 4 == 64 * 1024
    tpl, lap = _lap(4)
    assert lap.tiles.max_verts <= kernels._CHEBY_MAX_VERTS
    assert lap.tiles.max_rows <= eigh.K9_TILE_ROWS


def test_k9_tiles_are_deterministic():
    """Two builds give the same tiles, field by field."""
    tpl, lap = _lap(5)
    a = eigh.build_k9_tiles(lap.cols, tpl.pos)
    b = eigh.build_k9_tiles(lap.cols.clone(), tpl.pos.copy())
    for field in ("verts", "starts", "src", "src_off", "local"):
        assert torch.equal(getattr(a, field), getattr(b, field))
    assert (a.max_rows, a.max_verts) == (b.max_rows, b.max_verts)


def test_k9_tiles_of_a_diagonal_table_stage_each_row_once():
    """The diagonal-only table of the stream floor: a tile stages exactly
    its own rows."""
    tpl, _ = _lap(4)
    n = tpl.num_vertices
    cols = torch.arange(n, dtype=torch.int32)[:, None]
    tiles = eigh.build_k9_tiles(cols, tpl.pos)
    _check_tiles(tiles, cols, eigh.K9_TILE_VERTS, eigh.K9_TILE_ROWS)
    assert tiles.src.shape[0] == n
    assert bool((tiles.local[:, 0] == tiles.local[:, 1]).all())


def test_k9_tiles_refuse_a_row_budget_below_one_vertex():
    cols, _ = _random_table(50, 11, seed=0)
    with pytest.raises(ValueError):
        eigh.build_k9_tiles(cols, max_rows=11)


def tiled_step(tiles, vals, x, c, a, b=0.0, p=None):
    """The plain step in K9's data flow: each tile's rows staged, each of
    its vertices' sum formed from the staged copy through the local
    indices (x[m] for ``c · x`` too), in the twin's order and
    roundings, scattered to the vertices' rows."""
    k = vals.shape[1]
    starts, off = tiles.starts.long(), tiles.src_off.long()
    out = torch.empty_like(x)
    for t in range(tiles.n_tiles):
        owned = tiles.verts[starts[t]:starts[t + 1]].long()
        staged = x[tiles.src[off[t]:off[t + 1]].long()]
        local = tiles.local[starts[t]:starts[t + 1]].long()
        w = vals[owned]
        lap = w[:, 0, None] * staged[local[:, 0]]
        for j in range(1, k):
            lap = lap + w[:, j, None] * staged[local[:, j]]
        r = (lap - c[None, :] * staged[local[:, k]]) \
            * float(np.float32(a))
        if b != 0.0:
            r = r - float(np.float32(b)) * p[owned]
        out[owned] = r
    return out


def _forms(c, d, ub):
    return {"body": (c.new_full((d,), float(c[0])), 0.37, -1.25),
            "b0": (c.new_full((d,), float(c[0])), -0.11, 0.0),
            "columns": (c * ub, 1.0, 0.0)}


@pytest.mark.parametrize("subdivisions", SUBDIVISIONS)
@pytest.mark.parametrize("form", ["body", "b0", "columns"])
def test_tile_order_twin_equals_plain(subdivisions, form):
    """Tile by tile through the local indices equals ``cheby_step_plain``
    bit for bit: the same products and sums in the same order."""
    _, lap = _lap(subdivisions)
    n, d = lap.cols.shape[0], 19
    g = torch.Generator().manual_seed(subdivisions)
    x = torch.randn((n, d), generator=g)
    p = torch.randn((n, d), generator=g)
    c, a, b = _forms(torch.rand((d,), generator=g), d, lap.ub)[form]
    want = eigh.cheby_step_plain(lap.cols, lap.vals, x, c, a, b, p)
    got = tiled_step(lap.tiles, lap.vals, x, c, a, b, p)
    assert torch.equal(got, want)


@pytest.mark.parametrize("form", ["body", "b0", "columns"])
def test_tile_order_twin_equals_plain_at_runtime_k(form):
    """The same on a K = 11 table with padding, in tiles of at most 40
    rows."""
    n, k, d = 300, 11, 70
    cols, vals = _random_table(n, k, seed=3)
    tiles = eigh.build_k9_tiles(cols, max_rows=40)
    g = torch.Generator().manual_seed(3)
    x = torch.randn((n, d), generator=g)
    p = torch.randn((n, d), generator=g)
    c, a, b = _forms(torch.randn((d,), generator=g), d, 1.0)[form]
    want = eigh.cheby_step_plain(cols, vals, x, c, a, b, p)
    assert torch.equal(tiled_step(tiles, vals, x, c, a, b, p), want)


@pytest.mark.parametrize("d,ld", [(1125, 1128), (37, 40), (128, 128),
                                  (5, 8)])
def test_panel_pads_rows_to_a_sector(d, ld):
    x = eigh.panel(7, d, "cpu")
    assert x.shape == (7, d) and x.stride() == (ld, 1)


def test_solver_hands_k9_padded_panels(monkeypatch):
    """Every K9 step of a solve gets panels at the padded stride (the
    initial panel, drawn on the host by another thread, each QR's Q,
    ``v = q s`` and
    the filter's outputs), and the solve's info records the set-up and
    the tile build."""
    seen = []
    plain = eigh.cheby_step_plain

    def recorded(cols, vals, x, c, a, b=0.0, p=None):
        seen.append((x.stride(), None if p is None else p.stride()))
        out = plain(cols, vals, x, c, a, b, p)
        res = eigh.panel(*out.shape, out.device)
        res.copy_(out)
        return res

    monkeypatch.setattr(eigh, "cheby_step_plain", recorded)
    tpl = synthetic_template(3, 3)
    vals, _, info = eigh._chebyshev_smallest(tpl, 6, device="cpu")
    block = info["block"]
    ld = -(-block // eigh.PANEL_ALIGN) * eigh.PANEL_ALIGN
    assert len(seen) == info["passes"] * (info["degree"] + 2)
    assert all(xs == (ld, 1) and ps in (None, (ld, 1)) for xs, ps in seen)
    assert info["max_residual"] < 1e-3
    assert info["setup_s"] >= info["tiles_s"] > 0.0

"""K3b backward's runs (``ops.OutGatherRuns``) and their tile-order twin
(CPU), held against the port's twin, the per-position transposes and
``jax.vjp`` of the JAX package's matmul-first conv.

The kernel (``csrc/out_gather_sum.cu::out_gather_sum_bwd_kernel``) reads
only the runs: consecutive source vertices, the sorted distinct dout rows
they read, and each (position, vertex)'s entries as indices into that
list with the weight in the top bit. These tests check that the lists
hold every entry of every position's capped transpose in the walk's
order, that the twin which reads them as the kernel does equals the
port's twin bit for bit, and the walk of a launch's items. Tolerances:

- the tile-order twin bit-equal to ``out_gather_sum_bwd_plain`` and to
  the stack of ``CappedEll.apply``: the same operations in the same
  order (NaN where dout is not finite, compared with ``equal_nan``);
- against ``jax.vjp`` of JAX's gather-sum with respect to ``u``: within
  1e-5 of the array's max, ``tests/test_torch_final_conv.py``'s fp32
  tolerance (XLA's summation order).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from craniofacialsd_vae_tpu import ops as jops
from craniofacialsd_vae_tpu_torch import kernels
from craniofacialsd_vae_tpu_torch import ops as tops
from craniofacialsd_vae_tpu_torch.geometry import (extract_spirals,
                                                   load_bundle, octasphere)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "geometry.npz")
F32_RTOL = 1e-5


def hub_table(n, seq, seed):
    """A spiral table whose in-degrees follow a power law (entries
    ``n · u³``): most positions' transposes get three overflow tiers."""
    rng = np.random.default_rng(seed)
    table = (n * rng.random((n, seq)) ** 3).astype(np.int64)
    table[:, 0] = np.arange(n)
    return table


@pytest.fixture(scope="module")
def tables():
    pos, face = octasphere(6)
    return {"fixture": np.asarray(load_bundle(FIXTURE).spirals[0]),
            "octasphere": extract_spirals(np.asarray(face), np.asarray(pos),
                                          9),
            "hubs": hub_table(3000, 9, 3000),
            "small_hubs": hub_table(500, 9, 500)}


@pytest.fixture(scope="module")
def op_of(tables):
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = tops.build_spiral_op(tables[name])
        return cache[name]
    return get


def _walk(g, n):
    """Each source vertex's entries of one gather's transpose (None: the
    identity), found from the tiers' own row lists rather than their
    links: ``(rows, weights)`` lists in the main row's then the tiers'
    order, and the number of tiers that list each vertex."""
    if g is None:
        return [([v], [1.0]) for v in range(n)], np.zeros(n, np.int64)
    t = g.transpose
    out = list(zip(t.cols.tolist(), t.vals.tolist()))
    reached = np.zeros(n, np.int64)
    for rows, cols, vals in t.tiers:
        reached[rows.numpy()] += 1
        for v, c, w in zip(rows.tolist(), cols.tolist(), vals.tolist()):
            out[v] = (out[v][0] + c, out[v][1] + w)
    return out, reached


def _same(a, b):
    torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    assert torch.equal(torch.signbit(a), torch.signbit(b))


@pytest.mark.parametrize("name,verts,rows", [
    ("fixture", 32, 256), ("octasphere", 32, 256), ("hubs", 32, 256),
    ("small_hubs", 16, 64), ("fixture", 1, 256)])
def test_runs_cover_every_source_vertex_once_in_order(op_of, tables, name,
                                                      verts, rows):
    """The runs are consecutive, start at 0, end at N and stay within the
    vertex cap; each run's list is sorted, unique and within the row cap
    unless one vertex needs more alone; the blobs lie on 16 bytes."""
    op = op_of(name)
    runs = tops.build_out_gather_runs(op.out_bwd, verts, rows)
    n = tables[name].shape[0]
    starts = runs.starts.tolist()
    assert starts[0] == 0 and starts[-1] == n == runs.n_src
    sizes = np.diff(starts)
    assert sizes.min() >= 1 and sizes.max() <= verts == runs.max_verts
    off, blob_off = runs.row_off.tolist(), runs.blob_off.tolist()
    assert all(b % 4 == 0 for b in blob_off)
    assert max(np.diff(blob_off)) == runs.max_blob
    for t in range(runs.n_runs):
        listed = runs.rows[off[t]:off[t + 1]]
        assert bool((listed[1:] > listed[:-1]).all())
        assert len(listed) <= rows or sizes[t] == 1
    assert runs.max_rows == max(np.diff(off))
    if verts == 1:
        assert runs.n_runs == n


@pytest.mark.parametrize("name", ["fixture", "octasphere", "hubs"])
def test_run_lists_rebuild_each_transpose(op_of, tables, name):
    """Decoded from the runs, each position's entries are its transpose's:
    the main row's K (padding's row 0 and weight 0 kept), then each tier
    the vertex's walk reaches, in order; the identity position's one
    entry is the vertex's own row. The hub table reaches three tiers."""
    op = op_of(name)
    n = tables[name].shape[0]
    if name == "hubs":
        assert max(len(g.transpose.tiers) for g in op.gathers[1:]) == 3
    for l, (rows, ws, reached) in enumerate(op.out_bwd.runs.entries()):
        want, want_reached = _walk(op.gathers[l], n)
        assert np.array_equal(reached, want_reached), l
        for v, (got_rows, got_ws, (want_rows, want_ws)) in enumerate(zip(
                rows.tolist(), ws.tolist(), want)):
            k = len(want_rows)
            assert got_rows[:k] == want_rows and min(got_rows[k:],
                                                     default=-1) == -1, (l, v)
            assert got_ws[:k] == want_ws, (l, v)


@pytest.mark.parametrize("name,b,o,verts", [
    ("fixture", 16, 3, 32), ("fixture", 1, 3, 32), ("fixture", 4, 8, 1),
    ("octasphere", 16, 3, 32), ("hubs", 3, 5, 32), ("hubs", 20, 1, 1),
    ("small_hubs", 4, 3, 16)])
def test_tiles_twin_equals_the_twin_and_the_stack(op_of, tables, name, b, o,
                                                   verts):
    """The tile-order twin is bit-equal to ``out_gather_sum_bwd_plain``
    and to the stack of the positions' ``CappedEll.apply``, single-vertex
    runs (``verts`` 1) included."""
    op = op_of(name)
    runs = tops.build_out_gather_runs(op.out_bwd, verts)
    n = tables[name].shape[0]
    dout = torch.from_numpy(np.random.default_rng(b + o).normal(
        size=(n, b, o)).astype(np.float32))
    got = tops.out_gather_sum_bwd_tiles_plain(dout, runs)
    stack = torch.stack([dout if g is None else g.transpose.apply(dout)
                         for g in op.gathers]).permute(0, 3, 1, 2)
    assert got.shape == (tables[name].shape[1], o, n, b)
    _same(got, tops.out_gather_sum_bwd_plain(dout, op.out_bwd))
    _same(got, stack)


@pytest.mark.parametrize("name", ["fixture", "small_hubs"])
def test_tiles_twin_with_a_non_finite_row_0(op_of, tables, name):
    """Padding reads dout's row 0 with weight 0: a NaN or an infinity
    there gives NaN through 0 · x wherever a sum holds padding, and -0
    stays what the twin makes of it."""
    op = op_of(name)
    n = tables[name].shape[0]
    dout = torch.from_numpy(np.random.default_rng(1).normal(
        size=(n, 4, 3)).astype(np.float32))
    dout[0, 0] = float("nan")
    dout[0, 1] = float("inf")
    dout[1] = -0.0
    got = tops.out_gather_sum_bwd_tiles_plain(dout, op.out_bwd.runs)
    want = tops.out_gather_sum_bwd_plain(dout, op.out_bwd)
    assert bool(got.isnan().any())
    _same(got, want)


@pytest.mark.parametrize("name,b", [("fixture", 4), ("hubs", 3)])
def test_tiles_twin_matches_jax_vjp(tables, name, b):
    """The tile-order twin against ``jax.vjp``, with respect to ``u``, of
    the JAX package's gather-sum (``spiral_conv_out_gather``'s ``out = b
    + Σ_l u_l gathered``, JAX's layout ``[L, N, B, O]``), on the same
    numpy inputs."""
    table = tables[name]
    n, seq = table.shape
    rng = np.random.default_rng(n + b)
    u = rng.normal(size=(seq, n, b, 3)).astype(np.float32)
    dout = rng.normal(size=(n, b, 3)).astype(np.float32)
    jop = jops.build_spiral_op(table)

    def gather_sum(u_):
        out = jnp.zeros(u_.shape[1:], jnp.float32)
        for i, g in enumerate(jop.gathers):
            out = out + (u_[i] if g is None else jops.gather_rows(g, u_[i]))
        return out
    _, vjp = jax.vjp(gather_sum, jnp.asarray(u))
    (du_j,) = vjp(jnp.asarray(dout))
    want = np.asarray(du_j).transpose(0, 3, 1, 2)        # [L, O, N, B]
    got = tops.out_gather_sum_bwd_tiles_plain(
        torch.from_numpy(dout), tops.build_spiral_op(table).out_bwd.runs)
    err = float(np.abs(got.numpy() - want).max())
    assert err <= F32_RTOL * float(np.abs(want).max()), err


def test_runs_take_only_weights_of_one_or_zero(tables):
    """The entries carry their weight in one bit: a transpose with
    another weight is refused when the runs are built."""
    op = tops.build_spiral_op(tables["small_hubs"])
    bwd = op.out_bwd
    bwd.vals = bwd.vals.clone()
    bwd.vals[0] = 0.5
    with pytest.raises(ValueError):
        tops.build_out_gather_runs(bwd)


def _launch_items(nv, bw, threads, seq):
    """The (l, i, b) items each thread of one block walks, as the kernel
    steps them: from its index, ``threads`` items at a time."""
    nvb = nv * bw
    step_i, step_b = divmod(threads, bw)
    seen = []
    for tid in range(threads):
        l, r = divmod(tid, nvb)
        i, b = divmod(r, bw)
        while l < seq:
            seen.append((l, i, b))
            b += step_b
            if b >= bw:
                b, i = b - bw, i + 1
            i += step_i
            if i >= nv:
                l, i = l + i // nv, i % nv
    return seen


@pytest.mark.parametrize("nv,bw,threads", [
    (32, 16, 256), (32, 16, 512), (32, 1, 256), (7, 3, 64), (1, 20, 32),
    (5, 4, 128), (32, 20, 96)])
def test_launch_walks_each_item_once(nv, bw, threads):
    """A block's threads walk every (position, vertex, batch row) of its
    run once, batch rows fastest."""
    items = _launch_items(nv, bw, threads, 9)
    assert sorted(items) == [(l, i, b) for l in range(9) for i in range(nv)
                             for b in range(bw)]


@pytest.mark.parametrize("b,o,max_rows,max_blob,want_bs", [
    (16, 3, 180, 580, 16), (1, 3, 180, 580, 1), (20, 8, 256, 600, 8),
    (40, 8, 1371, 1004, 2), (64, 8, 256, 600, 8), (3, 5, 30000, 4000, 1),
    (21, 8, 256, 600, 11)])
def test_bwd_plan_slices_the_batch(b, o, max_rows, max_blob, want_bs):
    """The plan of K3b's backward: the whole batch where the largest
    run's rows fit the cap, else equal slices that do (at least one row),
    cut to a multiple of 4 where B is one; a block's shared memory is
    the lists and its rows; threads as the registers allow where the
    grid fits one wave."""
    runs = type("R", (), {"max_rows": max_rows, "max_blob": max_blob,
                          "n_runs": 533})
    bs, smem, threads = kernels.out_gather_bwd_plan(runs, b, o)
    assert bs == want_bs
    assert smem == 4 * (max_blob + -(-max_rows // 4) * 4) \
        + 4 * max_rows * o * bs
    per_sm = kernels._SMEM_SM // (smem + kernels._SMEM_RESERVED)
    share = -(-533 * -(-b // bs) // kernels._SMS)
    assert threads % 32 == 0 and 128 <= threads <= 512
    if share <= per_sm:              # one wave: registers for its share
        assert share * threads * kernels._OUT_GATHER_BWD_REGS <= 65536 \
            or threads == 128
    else:
        assert threads == 128
    slices = -(-b // bs)
    assert (slices - 1) * bs < b <= slices * bs
    assert smem <= kernels._OUT_GATHER_BWD_SMEM or bs == 1

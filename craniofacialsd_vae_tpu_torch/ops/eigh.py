"""Mesh-Laplacian eigendecomposition (counterpart of ``ops/eigh.py``).

The k smallest eigenpairs of the unnormalized graph Laplacian ``D − A``
of a template, the basis of the spectral augmentation modes:

  * dense (the backend JAX names ``tpu``, and ``auto`` for N ≤ 8,192):
    ``torch.linalg.eigh`` of the dense fp32 Laplacian on the device;
  * ``cheby`` (and ``auto`` above 8,192 vertices): Chebyshev-filtered
    subspace iteration on the device. Each pass filters an ``[N, block]``
    fp32 panel by a degree-80 Chebyshev polynomial in L, one kernel K9
    launch a step (``kernels.cheby_step``: the ELL matvec fused with the
    recurrence's arithmetic, over the Laplacian's vertex tiles,
    ``build_k9_tiles``; the panels' rows at a stride padded to a multiple
    of 8 floats, ``panel``), then a Rayleigh–Ritz step (tall QR,
    ``w = L q`` and the residual ``L v − v θ`` through K9, a block × block
    ``eigh``); one float64 Rayleigh–Ritz polish on the host ends it. The
    filter runs in segments whose growth fp32 can carry (two of degree 40
    on the octasphere), a QR between them;
  * ``scipy``: ARPACK shift-invert on the host.

``auto`` accepts the Chebyshev result where its float64 residual is
below 1e-3 and otherwise solves again with ARPACK, as JAX does; it prints
which solver produced the basis and records it in ``solves``. Unlike JAX,
nothing here catches an exception: a kernel that fails to build or
launch, or an out-of-memory, raises.

Every product here runs in full fp32, TF32 off for its duration
(``full_fp32``). The initial panel is drawn by numpy's
``default_rng(seed)``, not JAX's threefry, so the iterates differ from
JAX's; the eigenpairs agree. The basis cache is JAX's: the same file name
(``eigbasis_{n}_{digest}_{backend}_k{k}.npz``, the digest a SHA-1 of the
faces), the keys ``vals``/``vecs``, a cached k' ≥ k sliced, and an atomic
write, so a dataset directory serves either package.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import glob
import hashlib
import math
import os
import threading
import time

import numpy as np
import torch

from .. import kernels
from ..device import resolve_device
from .sparse import from_coo
from .spiral_conv import SpiralTiles

__all__ = ["unnormalized_laplacian_dense", "laplacian_eigendecomposition",
           "spectral_project", "spectral_reconstruct", "cheby_step",
           "cheby_step_plain", "build_k9_tiles", "panel", "full_fp32",
           "solves", "DENSE_MAX_VERTICES", "ACCEPT_RESIDUAL"]

DENSE_MAX_VERTICES = 8192      # auto: dense eigh up to here, Chebyshev above
ACCEPT_RESIDUAL = 1e-3         # auto: the Chebyshev basis's f64 residual
FILTER_GROWTH = 2.0 ** 48      # a filter segment's most growth: fp32's u⁻²
K9_TILE_VERTS = 64             # csrc/cheby_step.cu kMaxVerts: rows a tile owns
K9_TILE_ROWS = 128             # most rows a K9 tile stages (64 KB a slice)
PANEL_ALIGN = 8                # floats: a panel row starts on a 32-byte sector


class SolveLog:
    """What produced the last basis: ``last`` is a dict with ``solver``
    (``cache``, ``dense``, ``cheby`` or ``scipy``), ``n``, ``k`` and, for
    the Chebyshev solver, its info (``auto``'s rejected attempt under
    ``rejected``); None after ``reset``."""

    def __init__(self):
        self._lock = threading.Lock()
        self.last = None

    def reset(self) -> None:
        with self._lock:
            self.last = None

    def record(self, **entry) -> None:
        with self._lock:
            self.last = entry


solves = SolveLog()


@contextlib.contextmanager
def full_fp32():
    """fp32 products in full fp32 (TF32 off) for the block's duration,
    the process's setting restored after it."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def _laplacian_coo(template, dtype):
    n = template.num_vertices
    src = np.concatenate([template.edges[:, 0], template.edges[:, 1]])
    dst = np.concatenate([template.edges[:, 1], template.edges[:, 0]])
    deg = np.bincount(src, minlength=n).astype(dtype)
    rows = np.concatenate([src, np.arange(n)])
    cols = np.concatenate([dst, np.arange(n)])
    vals = np.concatenate([-np.ones(len(src), dtype), deg])
    return rows, cols, vals, deg


def unnormalized_laplacian_dense(num_vertices: int,
                                 edges: np.ndarray) -> np.ndarray:
    """Dense L = D - A (float32) from unique undirected edges."""
    lap = np.zeros((num_vertices, num_vertices), dtype=np.float32)
    src = np.concatenate([edges[:, 0], edges[:, 1]])
    dst = np.concatenate([edges[:, 1], edges[:, 0]])
    lap[src, dst] = -1.0
    deg = np.bincount(src, minlength=num_vertices).astype(np.float32)
    lap[np.arange(num_vertices), np.arange(num_vertices)] = deg
    return lap


def _scipy_laplacian_f64(template):
    import scipy.sparse as sp

    n = template.num_vertices
    rows, cols, vals, _ = _laplacian_coo(template, np.float64)
    return sp.coo_matrix((vals, (rows, cols)), shape=(n, n))


def _scipy_eigsh(template, k):
    """ARPACK shift-invert about −0.01 (the same smallest-k pairs as
    ``which='SM'``, far faster); ``which='SM'`` where the shifted
    factorization fails."""
    from scipy.sparse.linalg import eigsh

    lap = _scipy_laplacian_f64(template).tocsc()
    try:
        return eigsh(lap, k=k, sigma=-0.01, which="LM")
    except RuntimeError:        # a singular factor, or no convergence
        return eigsh(lap, k=k, which="SM")


# ------------------------------------------------------------------ K9
def cheby_step_plain(cols: torch.Tensor, vals: torch.Tensor,
                     x: torch.Tensor, c: torch.Tensor, a: float,
                     b: float = 0.0,
                     p: torch.Tensor | None = None) -> torch.Tensor:
    """Plain twin of K9: ``a · (L x − c ⊙ x) − b · p`` with ``L x`` summed
    over the ELL entries in ascending k (padding included), each product
    and sum rounded, then ``c ⊙ x``, the difference, the scale and (b ≠
    0) ``b · p`` and the last difference, each rounded: the kernel's
    order, so the two agree bit for bit on the card."""
    m, k = cols.shape
    g = x.index_select(0, cols.reshape(-1)).view(m, k, -1)
    lap = vals[:, 0, None] * g[:, 0]
    for j in range(1, k):
        lap = lap + vals[:, j, None] * g[:, j]
    out = (lap - c[None, :] * x) * float(np.float32(a))
    if b != 0.0:
        out = out - float(np.float32(b)) * p
    return out


def cheby_step(cols, vals, x, c, a, b=0.0, p=None,
               tiles: SpiralTiles | None = None) -> torch.Tensor:
    """K9 on the card (``kernels.cheby_step``, which needs the table's
    vertex ``tiles``), its plain twin on the host."""
    if not x.is_cuda:
        return cheby_step_plain(cols, vals, x, c, a, b, p)
    return kernels.cheby_step(cols, vals, x, c, a, b, p, tiles=tiles)


def _morton_order(pos: np.ndarray, device) -> torch.Tensor:
    """The vertices in Morton (Z-curve) order of their positions, each
    axis quantized to 10 bits over the bounding box (float64, so every
    device gives the same codes); ties keep the vertex order."""
    pos = torch.as_tensor(np.asarray(pos), device=device).double()
    lo, hi = pos.min(0).values, pos.max(0).values
    v = ((pos - lo) / (hi - lo).clamp_min(1e-30) * 1023).long() & 0x3FF
    for shift, mask in ((16, 0x030000FF), (8, 0x0300F00F), (4, 0x030C30C3),
                        (2, 0x09249249)):
        v = (v | (v << shift)) & mask        # an axis's bits 3 apart
    code = (v << torch.arange(3, device=device)).sum(1)
    return torch.argsort(code, stable=True)


def build_k9_tiles(cols: torch.Tensor, pos: np.ndarray | None = None,
                   max_verts: int = K9_TILE_VERTS,
                   max_rows: int = K9_TILE_ROWS) -> SpiralTiles:
    """K9's vertex tiles of an ELL table ``cols [M, K]``, built with torch
    ops on its device. The vertices in Morton order of ``pos [M, 3]`` (in
    their own order without ``pos``) are cut into runs of ``max_verts``;
    a run whose distinct rows exceed ``max_rows`` is halved until none
    does. Each tile stages the rows its vertices read: their K entries
    and the vertex itself (``c · x`` reads ``x[m]``), so the tiles'
    ``table()`` is ``[cols | arange(M)]``, ``local [M, K + 1]``; padding
    entries (row 0) stage row 0."""
    dev = cols.device
    m, k = cols.shape
    if max_rows < k + 1:
        raise ValueError(f"{max_rows} rows a tile cannot hold one vertex's "
                         f"{k + 1}")
    rows = torch.arange(m, device=dev)
    order = rows if pos is None else _morton_order(pos, dev)
    table = torch.cat([cols.long(), rows[:, None]], 1)[order]
    cuts = torch.arange(0, m, max_verts, device=dev)
    while True:
        sizes = torch.diff(cuts, append=cuts.new_tensor([m]))
        run = torch.repeat_interleave(
            torch.arange(cuts.shape[0], device=dev), sizes, output_size=m)
        keys, idx = torch.sort((run[:, None] * m + table).reshape(-1),
                               stable=True)
        first = torch.ones_like(keys, dtype=torch.bool)
        first[1:] = keys[1:] != keys[:-1]
        counts = torch.zeros_like(cuts).scatter_add_(0, keys // m,
                                                     first.long())
        over = counts > max_rows
        if not bool(over.any()):
            break
        cuts = torch.sort(torch.cat([cuts, cuts[over]
                                     + sizes[over] // 2])).values
    rank = torch.cumsum(first, 0) - 1
    inv = torch.empty_like(rank)
    inv[idx] = rank
    src_off = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    local = inv.view(m, k + 1) - src_off[run][:, None]
    most_rows, most_verts = torch.stack([counts.max(), sizes.max()]).tolist()
    i32 = lambda t: t.to(torch.int32)  # noqa: E731
    return SpiralTiles(
        verts=i32(order), starts=i32(torch.cat([cuts, cuts.new_tensor([m])])),
        src=i32(keys[first] % m), src_off=i32(src_off), local=i32(local),
        max_rows=most_rows, max_verts=most_verts)


def panel(n: int, d: int, device) -> torch.Tensor:
    """An uninitialized ``[n, d]`` fp32 panel whose rows lie at a stride
    of d rounded up to ``PANEL_ALIGN`` floats: K9 then stages them with
    16-byte copies, and each row starts on a 32-byte sector."""
    ld = -(-d // PANEL_ALIGN) * PANEL_ALIGN
    return torch.empty((n, ld), dtype=torch.float32, device=device)[:, :d]


def _as_panel(t: torch.Tensor) -> torch.Tensor:
    """``t`` copied into a ``panel`` (in place of ``.contiguous()``)."""
    out = panel(t.shape[0], t.shape[1], t.device)
    out.copy_(t)
    return out


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _EllLaplacian:
    """The ELL Laplacian D − A on a device (``from_coo``'s order, the
    diagonal included), its Gershgorin bound ub = 2·deg_max + 1 and K9's
    vertex tiles of it (``build_k9_tiles`` over the template's positions,
    built in ``tiles_s`` seconds)."""

    def __init__(self, template, device):
        n = template.num_vertices
        rows, cols, vals, deg = _laplacian_coo(template, np.float32)
        mat = from_coo(rows, cols, vals, (n, n), with_transpose=False)
        self.cols = mat.cols.to(device)
        self.vals = mat.vals.to(device)
        self.ub = float(2.0 * deg.max() + 1.0)
        _sync(self.cols.device)             # the build alone in tiles_s
        t0 = time.perf_counter()
        self.tiles = build_k9_tiles(self.cols, template.pos)
        _sync(self.cols.device)
        self.tiles_s = time.perf_counter() - t0

    def step(self, x, c, a, b=0.0, p=None):
        """``a · (L x − c ⊙ x) − b · p`` with ``c [D]``."""
        return cheby_step(self.cols, self.vals, x, c, a, b, p,
                          tiles=self.tiles)


def filter_segments(ub: float, lb: float, degree: int) -> list:
    """The degrees of the segments a degree-``degree`` filter on the
    window [lb, ub] is applied in: as few as keep each segment's growth
    |T_d(t(0))| ≈ e^{d·acosh(t(0))} within ``FILTER_GROWTH``, as equal as
    can be, summing to ``degree``."""
    t0 = (ub + lb) / (ub - lb)
    n = math.ceil(degree * math.acosh(t0) / math.log(FILTER_GROWTH))
    n = min(max(n, 1), degree)
    base, extra = divmod(degree, n)
    return [base + (i < extra) for i in range(n)]


def _chebyshev(lap: _EllLaplacian, x, lb: float, degree: int):
    """JAX ``filter_pass``: the scaled Chebyshev T_d on t(λ) = (2λ −
    (ub + lb)) / (ub − lb), |T_d| ≤ 1 on the unwanted [lb, ub], with the
    Zhou–Saad σ recurrence keeping the columns' scale (T̃_d(0) = 1);
    ``degree`` K9 launches."""
    ub = lap.ub
    e = (ub - lb) / 2.0
    c = (ub + lb) / 2.0
    sigma = e / (0.0 - c)
    c_vec = torch.full((x.shape[1],), c, dtype=torch.float32,
                       device=x.device)
    t_prev = x
    t_cur = lap.step(x, c_vec, sigma / e)
    sigma_prev = sigma
    for _ in range(degree - 1):
        sigma_new = 1.0 / (2.0 / sigma - sigma_prev)
        t_next = lap.step(t_cur, c_vec, 2.0 * (sigma_new / e),
                          sigma_new * sigma_prev, t_prev)
        t_prev, t_cur, sigma_prev = t_cur, t_next, sigma_new
    return t_cur


def _filter_pass(lap: _EllLaplacian, x, lb: float, degree: int):
    """The degree-``degree`` filter of one pass, in ``filter_segments``'
    segments with a QR between them: ``degree`` K9 launches. JAX applies
    T_80 in one go; its growth at λ = 0 (about 1e24 where ub = 13, the
    octasphere's) buries the top of the wanted window below fp32's
    rounding, and the solve stalls. Two segments give T_40², which is
    (1 + T_80) / 2: the same damping, each half within fp32's reach."""
    for i, d in enumerate(filter_segments(lap.ub, lb, degree)):
        if i:
            with full_fp32():
                x = _as_panel(torch.linalg.qr(x)[0])
        x = _chebyshev(lap, x, lb, d)
    return x


def _rayleigh_ritz(lap: _EllLaplacian, x, times: dict | None = None):
    """JAX ``rayleigh_ritz``: tall QR, ``w = L q`` (K9), the symmetrized
    projection, its ``eigh``, ``v = q s`` and each column's residual
    ``‖L v − v θ‖`` (K9, then a norm), all in full fp32. ``times``
    accumulates the seconds of the QR, the ``eigh`` and the rest (the
    device synchronized between them)."""
    dev = x.device
    with full_fp32():
        t0 = time.perf_counter()
        q = _as_panel(torch.linalg.qr(x)[0])  # cuSOLVER's Q: column-major
        _sync(dev)
        t1 = time.perf_counter()
        w = lap.step(q, q.new_zeros(q.shape[1]), 1.0)
        gram = q.T @ w
        gram = (gram + gram.T) / 2.0
        _sync(dev)
        t2 = time.perf_counter()
        theta, s = torch.linalg.eigh(gram)
        _sync(dev)
        t3 = time.perf_counter()
        v = torch.matmul(q, s, out=panel(*q.shape, dev))
        resid = torch.linalg.vector_norm(lap.step(v, theta, 1.0), dim=0)
        _sync(dev)
        t4 = time.perf_counter()
    if times is not None:
        times["qr_s"] += t1 - t0
        times["eigh_s"] += t3 - t2
        times["rr_other_s"] += (t2 - t1) + (t4 - t3)
    return v, theta, resid


def _draw(n: int, block: int, seed: int) -> np.ndarray:
    """The starting panel's values on the host: standard normals from
    ``default_rng(seed)`` (JAX draws threefry normals from
    ``PRNGKey(seed)``)."""
    return np.random.default_rng(seed).standard_normal((n, block),
                                                       dtype=np.float32)


def _initial_panel(n: int, block: int, seed: int, device) -> torch.Tensor:
    """The starting ``panel``: ``_draw``'s values on ``device``."""
    return _as_panel(torch.from_numpy(_draw(n, block, seed)).to(device))


def _chebyshev_smallest(template, k, degree: int = 80, max_passes: int = 12,
                        guard: int | None = None, seed: int = 0,
                        tol: float = 1e-6, device=None):
    """Smallest-k Laplacian eigenpairs by Chebyshev-filtered subspace
    iteration on ``device`` (None: the card), JAX's algorithm and
    defaults: block = k + max(8, k // 8) (at most N // 2); the first
    window lb = min(ub/2, 3·ub·block/N); each pass a degree-``degree``
    filter (in segments, ``_filter_pass``: JAX's one T_80 stalls where
    the bound is tight) and a Rayleigh–Ritz step; the next lb at 1.02 × the top Ritz
    value, clipped to [1e-4·ub, 0.9·ub]; stop when the k wanted residuals
    are below ``tol``·ub or the wanted Ritz values stop moving. Then one
    float64 Rayleigh–Ritz on the host (scipy's sparse L, numpy's QR and
    eigh). A pass launches K9 ``degree + 2`` times.

    Returns (evals [k] ascending, evecs [N, k] float64, info): info has
    ``passes``, ``block``, ``degree``, ``seconds``, ``max_residual`` (the
    f64 residual), ``device``, each pass's lb (``windows``) and filter
    segments, and the seconds of the set-up (``setup_s``: the Laplacian
    and its K9 tiles, built while another thread draws the initial
    panel on the host, and the panel's copy to the device), of the tile
    build alone (``tiles_s``), the filter, the QR,
    the ``eigh``, the rest of the Rayleigh–Ritz steps and the polish."""
    dev = resolve_device(device)
    n = template.num_vertices
    t0 = time.perf_counter()
    g = guard if guard is not None else max(8, k // 8)
    block = min(k + g, n // 2)
    if block < k:
        raise ValueError(f"template too small for k={k} (n={n})")

    # the initial panel's host draw (numpy fills without the GIL) runs
    # beside the Laplacian's build and its K9 tiles'; all device work
    # stays on this thread, so tiles_s times the build alone
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        drawn = pool.submit(_draw, n, block, seed)
        lap = _EllLaplacian(template, dev)
        x = _as_panel(torch.from_numpy(drawn.result()).to(dev))
    ub = lap.ub
    times = dict(setup_s=time.perf_counter() - t0, tiles_s=lap.tiles_s,
                 filter_s=0.0, qr_s=0.0, eigh_s=0.0, rr_other_s=0.0)
    lb = float(min(ub * 0.5, ub * 3.0 * block / n))
    passes = 0
    theta_prev = None
    windows = []
    for passes in range(1, max_passes + 1):
        tf = time.perf_counter()
        windows.append(lb)
        x = _filter_pass(lap, x, lb, degree)
        _sync(dev)
        times["filter_s"] += time.perf_counter() - tf
        x, theta, resid = _rayleigh_ritz(lap, x, times)
        theta = theta.cpu().numpy()
        lb = float(np.clip(theta[-1] * 1.02, ub * 1e-4, ub * 0.9))
        if float(resid[:k].max()) < tol * ub:
            break
        if theta_prev is not None and np.allclose(
                theta[:k], theta_prev[:k], rtol=1e-7,
                atol=float(ub) * 1e-9):
            break
        theta_prev = theta

    tp = time.perf_counter()
    lap64 = _scipy_laplacian_f64(template).tocsr()
    x64 = x.cpu().numpy().astype(np.float64)
    q, _ = np.linalg.qr(x64)
    w = lap64 @ q
    gram = q.T @ w
    theta64, s = np.linalg.eigh((gram + gram.T) / 2.0)
    v = q @ s
    evals, vecs = theta64[:k], v[:, :k]
    res = np.linalg.norm(lap64 @ vecs - vecs * evals[None, :], axis=0)
    times["polish_s"] = time.perf_counter() - tp

    info = {"passes": passes, "degree": degree, "block": block,
            "seconds": time.perf_counter() - t0,
            "max_residual": float(res.max()), "device": str(dev),
            "windows": windows,
            "segments": [filter_segments(ub, w, degree) for w in windows],
            **times}
    return evals, vecs, info


def _cache_stem(template, backend: str) -> str:
    digest = hashlib.sha1(
        np.ascontiguousarray(template.face).tobytes()).hexdigest()[:12]
    return f"eigbasis_{template.num_vertices}_{digest}_{backend}"


def laplacian_eigendecomposition(template, k: int = 500,
                                 backend: str = "auto",
                                 cache_dir: str | None = None, device=None):
    """(eigenvalues [k], eigenvectors [N, k]) of the k smallest eigenpairs
    of the unnormalized graph Laplacian, as numpy arrays.

    backend: ``tpu`` (JAX's name for the dense solve, kept so that the
    cache key is the same): ``torch.linalg.eigh`` of the dense fp32
    Laplacian on ``device``; ``cheby``: the Chebyshev solver
    on ``device``; ``scipy``: ARPACK on the host; ``auto``: dense up to
    ``DENSE_MAX_VERTICES`` vertices, else Chebyshev, accepted if its f64
    residual is below ``ACCEPT_RESIDUAL``, else ARPACK. ``device`` (None:
    the card) is resolved only where a solve runs on it.

    cache_dir: the basis is read from, or written to, an npz there keyed
    by the vertex count, the faces' digest, the backend and k (a cached
    k' ≥ k is sliced), the JAX package's file."""
    cache_path = None
    if cache_dir is not None:
        os.makedirs(cache_dir, exist_ok=True)
        stem = _cache_stem(template, backend)
        for path in sorted(glob.glob(os.path.join(cache_dir,
                                                  f"{stem}_k*.npz"))):
            cached_k = int(path.rsplit("_k", 1)[1][:-4])
            if cached_k >= k:
                with np.load(path) as z:
                    vals, vecs = z["vals"][:k], z["vecs"][:, :k]
                solves.record(solver="cache", n=template.num_vertices, k=k,
                              path=path)
                return vals, vecs
        cache_path = os.path.join(cache_dir, f"{stem}_k{k}.npz")

    def _finish(vals, vecs, **entry):
        if cache_path is not None:
            tmp = cache_path + ".tmp"
            with open(tmp, "wb") as f:
                np.savez(f, vals=np.asarray(vals), vecs=np.asarray(vecs))
            os.replace(tmp, cache_path)
        solves.record(n=template.num_vertices, k=k, **entry)
        return vals, vecs

    n = template.num_vertices
    if backend == "scipy":
        return _finish(*_scipy_eigsh(template, k), solver="scipy")
    if backend == "cheby":
        vals, vecs, info = _chebyshev_smallest(template, k, device=device)
        return _finish(vals, vecs, solver="cheby", info=info)
    if backend == "auto" and n > DENSE_MAX_VERTICES:
        vals, vecs, info = _chebyshev_smallest(template, k, device=device)
        print(f"[eigh] Chebyshev subspace on {info['device']}: k={k} "
              f"block={info['block']} in {info['passes']} passes / "
              f"{info['seconds']:.1f}s, max residual "
              f"{info['max_residual']:.2e}")
        if info["max_residual"] < ACCEPT_RESIDUAL:
            print("[eigh] basis from the Chebyshev solver (K9)")
            return _finish(vals, vecs, solver="cheby", info=info)
        print("[eigh] residuals above tolerance; the basis comes from "
              "scipy ARPACK")
        return _finish(*_scipy_eigsh(template, k), solver="scipy",
                       rejected=info)
    if backend not in ("auto", "tpu"):
        raise ValueError(f"unknown eigh backend {backend!r}")
    dev = resolve_device(device)
    lap = torch.from_numpy(unnormalized_laplacian_dense(n, template.edges))
    with full_fp32():
        vals, vecs = torch.linalg.eigh(lap.to(dev))
    return _finish(vals[:k].cpu().numpy(), vecs[:, :k].cpu().numpy(),
                   solver="dense", device=str(dev))


def spectral_project(eigvecs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """s = Uᵀ x — [N, k]ᵀ @ [..., N, 3] → [..., k, 3], in full fp32."""
    with full_fp32():
        return torch.einsum("nk,...nc->...kc", eigvecs, x)


def spectral_reconstruct(eigvecs: torch.Tensor, x: torch.Tensor,
                         s_orig: torch.Tensor,
                         s_new: torch.Tensor) -> torch.Tensor:
    """x + U (s_new − s_orig), in full fp32."""
    with full_fp32():
        return x + torch.einsum("nk,...kc->...nc", eigvecs, s_new - s_orig)

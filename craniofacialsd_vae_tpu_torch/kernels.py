"""Build, load and launch the hand-written CUDA kernels.

The sources under ``csrc/`` export a plain C interface. At first use each
source is compiled by its own ``nvcc`` process for ``sm_90a`` (all of
them at once) and the objects are linked into one shared library under
``build/kernels/<hash>/`` at the root of the checkout; ``ctypes`` binds
it. The hash covers the sources and the flags, so an edit rebuilds.

Each launch function checks device, dtype, shape, alignment and
contiguity, allocates its output (and K2-dW its scratch) with
``torch.empty``, launches on PyTorch's current stream, adds one to its
entry in ``launches`` and raises if the C function reports a CUDA
error. None of them falls back to a plain version: the callers choose
the plain twin only for CPU tensors.

The ``mixed`` and ``bfloat16`` policies' kernels go through the same
wrappers: K4 and its capped form, K1 and K2-dW each take bf16 rows
(``csrc/*_bf16.cu``, counted under their own names), which none of them
converts; K3b (``out_gather_sum``) is the matmul-first final conv's
gather-sum and ``out_gather_sum_bwd`` its backward.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import itertools
import os
import shutil
import subprocess
import tempfile
import threading
import dataclasses
from dataclasses import dataclass

import torch

__all__ = ["SOURCES", "KERNEL_NAMES", "launches", "build", "library",
           "ell_matmul_fwd", "ell_matmul_capped", "SpiralPlan",
           "plan_spiral_conv", "narrow_tile_plan", "bf16_tile_plan",
           "spiral_conv_fwd",
           "DwPlan", "plan_spiral_conv_dw", "DwBf16Plan",
           "plan_spiral_conv_dw_bf16",
           "spiral_conv_dw", "out_gather_sum", "out_gather_sum_bwd",
           "raster_sweep", "nearest_sq", "nearest_sq_bwd"]

_PKG = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "kernels")
SOURCES = ("ell_matmul.cu", "raster_sweep.cu", "spiral_conv.cu",
           "spiral_conv_dw.cu", "ell_matmul_bf16.cu", "spiral_conv_bf16.cu",
           "spiral_conv_dw_bf16.cu", "out_gather_sum.cu", "distances.cu")
HEADERS = ("common.cuh", "bf16.cuh")
_LIB_NAME = "libcfsdvae_kernels.so"
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
_CFLAGS = _ARCH + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                   "-Xptxas", "-v")

KERNEL_NAMES = ("spiral_conv_tc", "spiral_conv_narrow", "ell_matmul_fwd",
                "raster_sweep", "spiral_conv_dw", "ell_matmul_capped",
                "spiral_conv_bf16", "spiral_conv_f32out",
                "spiral_conv_dw_bf16", "ell_matmul_bf16",
                "ell_matmul_capped_bf16", "out_gather_sum",
                "out_gather_sum_bwd", "k8_fwd", "k8_bwd")

# K1 planner constants (csrc/spiral_conv.cu checks every plan it gets)
_SMS = 132                    # H100 SXM
_SMEM_BLOCK = 232448          # per block, above 48 KB only by opt-in
_SMEM_SM = 233472             # per SM, shared by its blocks (228 KB)
_SMEM_RESERVED = 1024         # per block, kept by the runtime
_TC_MAX_THREADS = 256
_PATH_IDS = {"tc": 1, "tc_pad_k": 1, "narrow_out": 2, "narrow_tile": 3}


class LaunchCounts:
    """Launches per kernel since the last ``reset``."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.counts = dict.fromkeys(KERNEL_NAMES, 0)

    def add(self, name: str) -> None:
        with self._lock:
            self.counts[name] += 1

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self.counts)


launches = LaunchCounts()
_lib_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found under $CUDA_HOME/bin or on PATH; "
                       "the CUDA kernels cannot be built")


def _build_dir() -> str:
    h = hashlib.sha256(" ".join(_CFLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return os.path.join(_BUILD_ROOT, h.hexdigest()[:16])


def build(verbose: bool = False) -> str:
    """Compile the kernels if this checkout has not yet; returns the
    library's path. ``verbose`` prints nvcc's output (registers, shared
    memory and spills per kernel, from ``-Xptxas -v``)."""
    out_dir = _build_dir()
    lib_path = os.path.join(out_dir, _LIB_NAME)
    if os.path.exists(lib_path):
        return lib_path
    nvcc = _nvcc()
    os.makedirs(_BUILD_ROOT, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="tmp-", dir=_BUILD_ROOT)
    try:
        objs, procs = [], []
        for name in SOURCES:
            obj = os.path.join(tmp, name.replace(".cu", ".o"))
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *_CFLAGS, "-c", os.path.join(_CSRC, name),
                 "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs, failed = [], []
        for name, p in zip(SOURCES, procs):
            out, _ = p.communicate()
            logs.append(f"== {name}\n{out}")
            if p.returncode:
                failed.append(name)
        if not failed:
            link = subprocess.run(
                [nvcc, *_ARCH, "-shared", "-o",
                 os.path.join(tmp, _LIB_NAME), *objs],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            logs.append(f"== link\n{link.stdout}")
            if link.returncode:
                failed.append("link")
        log = "\n".join(logs)
        with open(os.path.join(tmp, "build.log"), "w") as f:
            f.write(log)
        if verbose or failed:
            print(log, flush=True)
        if failed:
            raise RuntimeError(f"nvcc failed for {', '.join(failed)}")
        try:
            os.rename(tmp, out_dir)
        except OSError:
            if not os.path.exists(lib_path):  # not a concurrent build
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib_path


def library() -> ctypes.CDLL:
    """The built library with its C signatures declared (built on first
    use)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.cfs_ell_matmul_fwd.argtypes = [p, p, p, p, i, i, i, p]
            lib.cfs_spiral_conv_fwd.argtypes = [p, p, p, p, p, i, i, i, i,
                                                i, ctypes.POINTER(i), p]
            lib.cfs_raster_sweep.argtypes = [p, p, p, p, p, p, p, i, i, i,
                                             i, p]
            lib.cfs_ell_matmul_capped.argtypes = [
                p, p, p, p, p, i, i, i, i, ctypes.POINTER(p),
                ctypes.POINTER(i), p]
            lib.cfs_spiral_conv_dw.argtypes = [p, p, p, p, p, i, i, i, i, i,
                                               ctypes.POINTER(i), p]
            lib.cfs_ell_matmul_bf16.argtypes = [p, p, p, p, i, i, i, p]
            lib.cfs_ell_matmul_capped_bf16.argtypes = \
                lib.cfs_ell_matmul_capped.argtypes
            lib.cfs_spiral_conv_bf16.argtypes = [p, p, p, p, p] + [i] * 12 \
                + [p]
            lib.cfs_spiral_conv_dw_bf16.argtypes = [p, p, p, p, p] \
                + [i] * 9 + [p]
            lib.cfs_out_gather_sum.argtypes = [p, p, p, p, i, i, i, i, i, p]
            lib.cfs_out_gather_sum_bwd.argtypes = [p, p, p, p, p, p, i, i, i,
                                                   i, i, p]
            lib.cfs_spiral_conv_narrow_tile.argtypes = [
                p] * 9 + [i] * 6 + [ctypes.POINTER(i), p]
            lib.cfs_spiral_conv_bf16_tile.argtypes = [p] * 9 + [i] * 12 \
                + [p]
            lib.cfs_nearest_sq.argtypes = [p, i, i, p, i, i, p, i, p, p, p]
            lib.cfs_nearest_sq_bwd.argtypes = [p, i, i, p, i, i, p, i] \
                + [p] * 8 + [p]
            for fn in (lib.cfs_ell_matmul_fwd, lib.cfs_spiral_conv_fwd,
                       lib.cfs_raster_sweep, lib.cfs_ell_matmul_capped,
                       lib.cfs_spiral_conv_dw, lib.cfs_ell_matmul_bf16,
                       lib.cfs_ell_matmul_capped_bf16,
                       lib.cfs_spiral_conv_bf16, lib.cfs_spiral_conv_dw_bf16,
                       lib.cfs_out_gather_sum, lib.cfs_out_gather_sum_bwd,
                       lib.cfs_spiral_conv_narrow_tile,
                       lib.cfs_spiral_conv_bf16_tile, lib.cfs_nearest_sq,
                       lib.cfs_nearest_sq_bwd):
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def _require(t: torch.Tensor, name: str, dtype: torch.dtype,
             ndim: int, device: torch.device) -> None:
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{name} must be a CUDA tensor on {device}; "
                         f"got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}; got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims; got {t.shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _fits_int32(*sizes: int) -> None:
    if any(s >= 2 ** 31 for s in sizes):
        raise ValueError("sizes must fit in int32")


def _rows_dtype(t: torch.Tensor) -> torch.dtype:
    """The dtype of a kernel's activation rows: float32 or bfloat16; any
    other raises (no wrapper converts)."""
    if t.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be torch.float32 or torch.bfloat16; got "
                         f"{t.dtype}")
    return t.dtype


def _launch(name: str, fn, device: torch.device, *args) -> None:
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = fn(*args, ctypes.c_void_p(stream))
    launches.add(name)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def ell_matmul_fwd(cols: torch.Tensor, vals: torch.Tensor,
                   x2: torch.Tensor) -> torch.Tensor:
    """K4: ``out[m, :] = Σ_k vals[m,k] · x2[cols[m,k], :]`` over the
    packed ``[N, D]`` view; returns ``[M, D]`` in x2's dtype. The kernel
    picks its launch from M, D and the operands' alignment
    (``csrc/ell_matmul.cu``). bf16 ``x2``: K4-bf16
    (``csrc/ell_matmul_bf16.cu``), the values rounded to bf16, fp32 sums
    rounded once; ``vals`` stay float32 either way."""
    dev = x2.device
    bf16 = _rows_dtype(x2) == torch.bfloat16
    _require(x2, "x", x2.dtype, 2, dev)
    _require(cols, "cols", torch.int32, 2, dev)
    _require(vals, "vals", torch.float32, 2, dev)
    if cols.shape != vals.shape:
        raise ValueError(f"cols {tuple(cols.shape)} and vals "
                         f"{tuple(vals.shape)} differ")
    (m, k), (n, d) = cols.shape, x2.shape
    _fits_int32(m, k, d, n)
    out = torch.empty((m, d), dtype=x2.dtype, device=dev)
    if m == 0 or d == 0:
        return out
    if n == 0 or k == 0:
        raise ValueError("ell_matmul needs at least one source row and "
                         "one entry per row")
    lib = library()
    _launch(*(("ell_matmul_bf16", lib.cfs_ell_matmul_bf16) if bf16
              else ("ell_matmul_fwd", lib.cfs_ell_matmul_fwd)), dev,
            _ptr(cols), _ptr(vals), _ptr(x2), _ptr(out), m, k, d)
    return out


_MAX_TIERS = 3                  # csrc/ell_matmul.cu's kMaxTiers


def ell_matmul_capped(cols: torch.Tensor, vals: torch.Tensor, tiers,
                      links, x2: torch.Tensor) -> torch.Tensor:
    """K4 with a capped table's overflow tiers landed in the same launch:
    ``out[m] = Σ_k vals[m,k] · x2[cols[m,k]]``, plus for each tier ``t``
    holding row ``m`` that tier's sum, added in tier order with one
    rounding each, over the packed ``[N, D]`` view; returns ``[M, D]``.
    ``tiers``: 1 to 3 ``(rows [R], cols [R, K_t], vals [R, K_t])``;
    ``links``: their walk (``sparse.tier_links``), ``link0 [M]`` then one
    ``[R]`` per tier. The kernel reads the walk, not ``rows``. bf16
    ``x2``: the main sum rounded to bf16, each tier's sum rounded, and
    each landed with a bf16 add (``csrc/ell_matmul_bf16.cu``)."""
    dev = x2.device
    bf16 = _rows_dtype(x2) == torch.bfloat16
    _require(x2, "x", x2.dtype, 2, dev)
    _require(cols, "cols", torch.int32, 2, dev)
    _require(vals, "vals", torch.float32, 2, dev)
    (m, k), (n, d) = cols.shape, x2.shape
    if vals.shape != cols.shape:
        raise ValueError(f"cols {tuple(cols.shape)} and vals "
                         f"{tuple(vals.shape)} differ")
    if not 1 <= len(tiers) <= _MAX_TIERS or len(links) != len(tiers) + 1:
        raise ValueError(f"{len(tiers)} tiers with {len(links)} links: need "
                         f"1 to {_MAX_TIERS} tiers and one link more")
    _require(links[0], "link0", torch.int32, 1, dev)
    if links[0].shape[0] != m:
        raise ValueError(f"link0 {tuple(links[0].shape)} does not fit {m} "
                         "rows")
    ptrs, ks = [], []
    for t, ((_, t_cols, t_vals), nxt) in enumerate(zip(tiers, links[1:])):
        _require(t_cols, f"tier {t} cols", torch.int32, 2, dev)
        _require(t_vals, f"tier {t} vals", torch.float32, 2, dev)
        _require(nxt, f"tier {t} next", torch.int32, 1, dev)
        if (t_vals.shape != t_cols.shape or nxt.shape[0] != t_cols.shape[0]
                or t_cols.shape[1] < 1):
            raise ValueError(f"tier {t}: cols {tuple(t_cols.shape)}, vals "
                             f"{tuple(t_vals.shape)} and next "
                             f"{tuple(nxt.shape)} do not describe one tier")
        _fits_int32(*t_cols.shape)
        ptrs += [t_cols.data_ptr(), t_vals.data_ptr(), nxt.data_ptr()]
        ks.append(t_cols.shape[1])
    _fits_int32(m, k, d, n)
    out = torch.empty((m, d), dtype=x2.dtype, device=dev)
    if m == 0 or d == 0:
        return out
    if n == 0 or k == 0:
        raise ValueError("ell_matmul needs at least one source row and "
                         "one entry per row")
    lib = library()
    _launch(*(("ell_matmul_capped_bf16", lib.cfs_ell_matmul_capped_bf16)
              if bf16 else ("ell_matmul_capped", lib.cfs_ell_matmul_capped)),
            dev,
            _ptr(cols), _ptr(vals), _ptr(links[0]), _ptr(x2), _ptr(out), m,
            k, d, len(ks), (ctypes.c_void_p * len(ptrs))(*ptrs),
            (ctypes.c_int * len(ks))(*ks))
    return out


@dataclass(frozen=True)
class SpiralPlan:
    """One K1 launch: its path, grid and tile. The fields from ``tm`` to
    ``warps_m`` belong to the tensor-core kernel and are 0 on the narrow
    paths; ``narrow_tile`` uses ``rows`` (the source rows a vertex tile
    stages) and ``vec_x``. The bf16 paths (``csrc/spiral_conv_bf16.cu``)
    use ``threads``, ``grid``, ``smem``, ``kp`` (16-deep steps), ``ldw``
    (W's row stride, bf16 values) and ``nt`` (columns, 8 per tile);
    ``bf16_tile`` uses ``threads``, ``grid``, ``smem``, ``tb``,
    ``n_btiles`` and ``rows``, as ``narrow_tile`` does."""
    path: str             # "tc", "tc_pad_k" (C_in < 8), "narrow_tile",
    #                       "narrow_out" (no tiles, another shape, or rows
    #                       that do not fit), "bf16", "bf16_elem"
    #                       (C_in % 16 != 0) or "bf16_tile" (the final
    #                       conv's shape, C_out < 8, with tiles)
    threads: int
    grid: tuple           # (row tiles walked, C_out column blocks)
    smem: int             # dynamic shared memory, bytes
    tb: int               # batch rows per tile (per warp on narrow paths)
    n_btiles: int
    tm: int = 0           # vertices per tile
    n_rtiles: int = 0     # row tiles: vertex tiles x batch tiles
    positions: int = 0    # spiral positions per stage, a divisor of L
    kp: int = 0           # depth per stage, positions·C_in padded to 8
    lda: int = 0          # row strides in shared memory, floats
    ldw: int = 0
    nt: int = 0           # C_out columns per block
    stages: int = 0       # ring stages
    vec_x: bool = False   # 16-byte gathers (else 4-byte)
    vec_w: bool = False
    vec_out: bool = False
    mi: int = 0           # warp tile: 16·mi rows x 8·ni columns
    ni: int = 0
    warps_m: int = 0
    rows: int = 0         # narrow_tile: staged source rows per vertex tile

    @property
    def kernel(self) -> str:
        """The launch-count name of the kernel this plan runs (the bf16
        kernel with an fp32 output counts as ``spiral_conv_f32out``)."""
        if self.path.startswith("bf16"):
            return "spiral_conv_bf16"
        return ("spiral_conv_narrow" if self.path.startswith("narrow")
                else "spiral_conv_tc")

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1]

    def as_ints(self) -> tuple:
        """The plan as csrc/spiral_conv.cu's PlanField array."""
        return (_PATH_IDS[self.path], self.threads, self.grid[0],
                self.grid[1], self.smem, self.tm, self.tb, self.n_btiles,
                self.n_rtiles, self.kp, self.lda, self.ldw, self.nt,
                self.stages, int(self.vec_x),
                int(self.vec_w), int(self.vec_out), self.mi, self.ni,
                self.warps_m, self.positions, self.rows)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round16(n: int) -> int:
    return _cdiv(n, 16) * 16


def _odd_stride(width: int) -> int:
    """A shared row stride of at least ``width`` bf16 values that is an
    odd number of 16-byte units: the 8 rows an ldmatrix reads then hit 8
    distinct bank groups (csrc's ``odd_stride``)."""
    units = _cdiv(width, 8)
    return 8 * (units if units % 2 else units + 1)


@functools.lru_cache(maxsize=1024)
def plan_spiral_conv(m: int, b: int, seq: int, c_in: int, c_out: int,
                     x_aligned: bool = True, w_aligned: bool = True,
                     dtype: torch.dtype = torch.float32, n_tiles: int = 0,
                     tile_rows: int = 0) -> SpiralPlan:
    """The K1 launch for ``out [m, b, c_out]`` from ``seq`` positions of
    ``c_in`` channels; ``x_aligned``/``w_aligned``: whether x and W start
    on 16 bytes (bf16: x on 4 bytes). C_out < 8 takes a narrow-output
    kernel: ``narrow_tile`` where the op's vertex tiles are given
    (``n_tiles`` tiles of at most ``tile_rows`` source rows,
    ``ops.SpiralTiles``) and their rows fit in shared memory, else
    ``narrow_out``; the rest the tensor-core kernel (C_in < 8: the
    positions that fill a depth of 32 share a stage). Wherever
    ``m·b ≥ 132·16`` the tensor-core grid has at least 132 blocks.
    ``dtype`` bfloat16: the tiled bf16 kernel for C_out < 8 where the
    tiles are given, the shape is the one it is compiled for and their
    rows fit (``_plan_bf16_tile``), else the bf16 kernel
    (``_plan_bf16``). Raises for a shape that no path takes."""
    if min(m, b, seq, c_in) < 1:
        raise ValueError(f"spiral conv needs M, B, L, C_in ≥ 1; got "
                         f"{m}, {b}, {seq}, {c_in}")
    if dtype == torch.bfloat16:
        plan = None
        if 1 <= c_out < 8 and n_tiles > 0 and tile_rows > 0 and x_aligned:
            plan = _plan_bf16_tile(b, seq, c_in, n_tiles, tile_rows)
        return plan or _plan_bf16(m, b, seq, c_in, c_out, x_aligned)
    if dtype != torch.float32:
        raise ValueError(f"spiral conv takes float32 or bfloat16; got "
                         f"{dtype}")
    if not 1 <= c_out <= 256:
        raise ValueError(f"C_out {c_out} must be in [1, 256]")
    if c_out < 8:
        plan = None
        if n_tiles > 0 and tile_rows > 0:
            plan = _plan_narrow_tile(b, seq, c_in, n_tiles, tile_rows,
                                     x_aligned)
        return plan or _plan_narrow(m, b, seq, c_in, c_out)
    return _plan_tc(m, b, seq, c_in, c_out, x_aligned, w_aligned)


_NARROW_TILE_PER_SM = 3       # blocks an SM holds, so that copies overlap
_TILE_SHAPE = (9, 32)         # csrc/spiral_conv.cu's kTileL, kTileCin


def narrow_tile_plan(b, c_in, n_tiles, rows, tb, threads,
                     vec_x) -> SpiralPlan:
    """The ``narrow_tile`` launch with ``tb`` batch rows per block (at
    most 8, in even batch tiles) and ``threads`` threads: one block per
    vertex tile and batch tile, the tile's ``rows`` source rows in shared
    memory at a stride of the kernel's 1, 4 or 8 register rows."""
    tb = min(b, tb)
    tb = _cdiv(b, _cdiv(b, tb))
    n_bt = _cdiv(b, tb)
    tbm = 1 if tb <= 1 else 4 if tb <= 4 else 8     # the kernel's row stride
    return SpiralPlan("narrow_tile", threads=threads, grid=(n_tiles * n_bt, 1),
                      smem=_round16(4 * rows * tbm * c_in), tb=tb,
                      n_btiles=n_bt, rows=rows, vec_x=vec_x)


def _plan_narrow_tile(b, seq, c_in, n_tiles, rows,
                      x_aligned) -> SpiralPlan | None:
    """The most batch rows per block (8, 4, 2 or 1) whose staged rows let
    three blocks share an SM; else one block an SM. Eight warps a block
    where the kernel keeps 8 batch rows (more than 4), four below
    (``k1_sweep``'s fastest on both hierarchies, PERF.md). None (``narrow_out`` then) for another shape
    than the kernel is compiled for, the final conv of every
    configuration (L = 9, C_in = 32), or where not even one batch row of
    the tile fits."""
    if (seq, c_in) != _TILE_SHAPE:
        return None
    for cap in (_SMEM_SM // _NARROW_TILE_PER_SM - _SMEM_RESERVED,
                _SMEM_BLOCK):
        for tb in (8, 4, 2, 1):
            plan = narrow_tile_plan(b, c_in, n_tiles, rows, tb, 256,
                                    x_aligned)
            if plan.smem <= cap:
                return (plan if plan.tb > 4 else dataclasses.replace(
                    plan, threads=128))
    return None


_BF16_TILE_ENTRY = 80         # bytes a staged (row, batch): csrc kTileStride
_BF16_TILE_VERTS = 64         # most vertices a tile owns: csrc kTileVerts
_BF16_TILE_FIXED = (4 * _BF16_TILE_VERTS * (9 + 1)  # its local and verts,
                    + 2 * 9 * 32 * 8)               # W padded to 8 columns


def bf16_tile_plan(b, n_tiles, rows, tb, threads) -> SpiralPlan:
    """The ``bf16_tile`` launch (K3a at the final conv's shape) with
    ``tb`` batch rows per block, in even batch tiles, and ``threads``
    threads: one block per vertex tile and batch tile, the tile's
    ``rows`` source rows of ``tb`` batch rows in shared memory, each
    entry 80 bytes (32 channels and a 16-byte pad), after the rows of
    ``local`` and ``verts`` of at most 64 vertices and W."""
    tb = min(b, tb)
    tb = _cdiv(b, _cdiv(b, tb))
    n_bt = _cdiv(b, tb)
    return SpiralPlan("bf16_tile", threads=threads,
                      grid=(n_tiles * n_bt, 1),
                      smem=_round16(_BF16_TILE_FIXED
                                    + _BF16_TILE_ENTRY * rows * tb), tb=tb,
                      n_btiles=n_bt, rows=rows)


_BF16_TILE_THREADS = 128      # four warps: faster than eight at every tb


def _plan_bf16_tile(b, seq, c_in, n_tiles, rows) -> SpiralPlan | None:
    """``_plan_narrow_tile``'s rule with bf16's half-size rows: the most
    batch rows per block (16, 8, 4, 2 or 1) whose staged rows let three
    blocks share an SM, else one block an SM; four warps a block (eight
    hold two blocks an SM by their registers, and were slower at every
    batch tile on an H100, PERF.md). None for another shape than the
    kernel is compiled for (L = 9, C_in = 32) or where not one batch row
    fits."""
    if (seq, c_in) != _TILE_SHAPE:
        return None
    for cap in (_SMEM_SM // _NARROW_TILE_PER_SM - _SMEM_RESERVED,
                _SMEM_BLOCK):
        for tb in (16, 8, 4, 2, 1):
            plan = bf16_tile_plan(b, n_tiles, rows, tb, _BF16_TILE_THREADS)
            if plan.smem <= cap:
                return plan
    return None


def _plan_narrow(m, b, seq, c_in, c_out) -> SpiralPlan:
    smem = _round16(4 * seq * c_in * c_out)
    if smem > _SMEM_BLOCK:
        raise ValueError(f"W [{seq}, {c_in}, {c_out}] does not fit in "
                         "shared memory")
    # at most 8 batch rows per warp (measured best at B = 16), in even
    # batch tiles
    tb = min(b, 8)
    tb, warps = _cdiv(b, _cdiv(b, tb)), 8
    busy = m * b >= _SMS * 16

    def blocks():
        return _cdiv(m * _cdiv(b, tb), warps)

    while busy and blocks() < _SMS and warps > 1:
        warps //= 2
    while busy and blocks() < _SMS and tb > 1:
        tb = _cdiv(tb, 2)
    return SpiralPlan("narrow_out", threads=32 * warps, grid=(blocks(), 1),
                      smem=smem, tb=tb, n_btiles=_cdiv(b, tb))


def _tc_tiles(m, b, c_out):
    """Tensor-core tiles: all of C_out or (C_out a multiple of 16, ≥ 32)
    half of it per block; 256 to 16 rows; warp tiles 8 to 32 columns
    wide."""
    widths = [_cdiv(c_out, 8) * 8]
    if c_out % 16 == 0 and c_out >= 32:
        widths.append(c_out // 2)
    for width, rows, ni in itertools.product(
            widths, (256, 128, 64, 32, 16), (4, 2, 1)):
        if ni > 1 and width < 8 * ni:
            continue
        nt = _cdiv(width, 8 * ni) * 8 * ni
        warps_n = nt // (8 * ni)
        mi = 2 if rows >= 32 else 1
        warps_m = rows // (16 * mi)
        threads = 32 * warps_m * warps_n
        if threads > _TC_MAX_THREADS:
            continue
        tb = min(b, rows)
        tm = rows // tb
        n_bt = _cdiv(b, tb)
        n_rt = _cdiv(m, tm) * n_bt
        yield dict(rows=rows, mi=mi, ni=ni, warps_m=warps_m, nt=nt,
                   ldw=nt + 8 if nt % 16 == 0 else nt,
                   n_split=_cdiv(c_out, nt), threads=threads, tb=tb,
                   tm=tm, n_btiles=n_bt, n_rtiles=n_rt,
                   tiles=n_rt * _cdiv(c_out, nt))


def _fit_tc(t, seq, c_in, positions, stages, per_sm, path,
            vec) -> SpiralPlan | None:
    """The tile ``t`` with ``positions`` spiral positions per stage and
    at most ``stages`` ring stages (and at most stages per tile + 1), as
    many as fit in the shared memory that lets ``per_sm`` blocks share an
    SM (one block: all of it); None if not even 2 fit."""
    kp = _cdiv(positions * c_in, 8) * 8
    lda, spt = kp + 4, seq // positions
    a_b, w_b, ts_b = 4 * t["rows"] * lda, 4 * kp * t["ldw"], 8 * t["tm"] * seq
    cap = min(_SMEM_BLOCK, _SMEM_SM // per_sm - _SMEM_RESERVED)
    ns = min(stages, spt + 1, (cap - ts_b) // (a_b + w_b))
    if ns < 2:
        return None
    smem = _round16(ns * (a_b + w_b) + ts_b)
    threads = t["threads"]
    regs = 128                    # the kernel's launch bounds allow 128
    per_sm = max(1, min(_SMEM_SM // (smem + _SMEM_RESERVED), 2048 // threads,
                        65536 // (threads * regs), 32))
    grid_x = min(t["n_rtiles"], max(1, _SMS * per_sm // t["n_split"]))
    return SpiralPlan(path, threads=threads, grid=(grid_x, t["n_split"]),
                      smem=smem, tb=t["tb"], n_btiles=t["n_btiles"],
                      tm=t["tm"], n_rtiles=t["n_rtiles"],
                      positions=positions, kp=kp, lda=lda, ldw=t["ldw"],
                      nt=t["nt"], stages=ns, vec_x=vec[0], vec_w=vec[1],
                      vec_out=vec[2], mi=t["mi"], ni=t["ni"],
                      warps_m=t["warps_m"])


def _plan_tc(m, b, seq, c_in, c_out, x_aligned, w_aligned) -> SpiralPlan:
    """Tile rules by GEMM rows M·B, from a sweep of every tile on this
    model's convs at B = 16, 4 and 1 on the fixture's and the
    octasphere's hierarchies on an H100 (``k1_sweep``, PERF.md): small
    levels gather 3 positions per stage into 16-row tiles with one warp
    per 8 columns; larger levels take larger tiles with fewer stages in
    flight and more warps per SM. A tile that does not fit falls back to
    the next, narrow warps (more of them) first. Wherever the level has
    132·16 rows, the small class's tiles and the fallbacks are sized for
    two blocks an SM, so that the grid covers the tiles (one block an SM
    capped it at 132 blocks walking two tiles each, and a 32-thread tile
    was the first fallback: 2.1x the library at the octasphere's
    M = 257)."""
    rows_total = m * b
    busy = rows_total >= _SMS * 16
    path = "tc" if c_in >= 8 else "tc_pad_k"
    vec = (c_in % 4 == 0 and x_aligned, c_out % 4 == 0 and w_aligned,
           c_out % 4 == 0)
    if c_in < 8:      # the positions whose channels fill a depth of 32
        positions = max(p for p in range(1, seq + 1)
                        if seq % p == 0 and (p == 1 or p * c_in <= 32))
    elif rows_total <= 8192:
        positions = max(p for p in (1, 2, 3) if seq % p == 0)
    else:
        positions = 1
    # (rows, warp width / 8, stages, blocks per SM)
    per_sm = 2 if busy else 1
    if rows_total <= 8192:
        kp = _cdiv(positions * c_in, 8) * 8
        width = c_out // 2 if not busy and c_out % 16 == 0 else c_out
        # 16 rows, unless a stage of W outweighs 3 such stages of x
        prefs = ([(16, 1, 3, per_sm)] if kp * width <= 3 * 16 * (kp + 4)
                 else [])
        prefs.append((64, 2, 3, per_sm))
    elif rows_total <= 32768:
        prefs = [(64, 2, 5, 3)]
    else:
        prefs = [(128, 4, 2, 4)]
    prefs += [(r, n, 3, per_sm) for r in (128, 64, 32, 16)
              for n in (1, 2, 4)]
    tiles = list(_tc_tiles(m, b, c_out))
    # busy: the full width per block; small: as many blocks as possible
    tiles.sort(key=lambda t: t["n_split"] if busy else -t["n_split"])
    for rows, ni, stages, per_sm in prefs:
        for t in tiles:
            if (t["rows"] != rows or t["ni"] != ni
                    or (busy and t["tiles"] < _SMS)):
                continue
            plan = _fit_tc(t, seq, c_in, positions, stages, per_sm, path,
                           vec)
            if plan is not None:
                return plan
    raise ValueError(f"no K1 tile fits C_in={c_in}, C_out={c_out}, L={seq} "
                     "in shared memory")


_BF16_TILES = (1, 2, 4, 8, 16)      # csrc/spiral_conv_bf16.cu's NT
_BF16_THREADS = 256


def _plan_bf16(m, b, seq, c_in, c_out, x_aligned) -> SpiralPlan:
    """The bf16 kernel: 8 warps a block, 16 rows a warp, all of C_out in
    column tiles of 8 (a power of two of them), W in shared memory as it
    lies in device memory, its depth padded to 16; the vector path where
    a 16-deep step lies in one position and x starts on 4 bytes, else the
    element path. Blocks are persistent: as many as the SMs hold, at most
    one a row tile per warp."""
    if not 1 <= c_out <= 8 * _BF16_TILES[-1]:
        raise ValueError(f"C_out {c_out} must be in [1, "
                         f"{8 * _BF16_TILES[-1]}] for the bf16 kernel")
    nt = next(t for t in _BF16_TILES if 8 * t >= c_out)
    ksteps = _cdiv(seq * c_in, 16)
    ldw = _odd_stride(8 * nt)
    smem = _round16(2 * ksteps * 16 * ldw)
    if smem > _SMEM_BLOCK:
        raise ValueError(f"W [{seq}, {c_in}, {c_out}] does not fit in "
                         "shared memory")
    per_sm = max(1, min(_SMEM_SM // (smem + _SMEM_RESERVED),
                        2048 // _BF16_THREADS))
    warps = _BF16_THREADS // 32
    blocks = max(1, min(_cdiv(_cdiv(m * b, 16), warps), _SMS * per_sm))
    path = "bf16" if c_in % 16 == 0 and x_aligned else "bf16_elem"
    return SpiralPlan(path, threads=_BF16_THREADS, grid=(blocks, 1),
                      smem=smem, tb=0, n_btiles=0, kp=ksteps, ldw=ldw,
                      nt=8 * nt)


def _tile_ptrs(tiles, table: torch.Tensor, plan: SpiralPlan,
               device: torch.device) -> tuple:
    """The pointers of the op's vertex tiles (verts, starts, src,
    src_off, local) for a tiled plan, after checking that they describe
    ``table`` in tiles of at most ``plan.rows`` source rows."""
    if tiles is None:
        raise ValueError(f"the {plan.path} plan needs the op's tiles")
    arrays = ((tiles.verts, "verts", 1), (tiles.starts, "starts", 1),
              (tiles.src, "src", 1), (tiles.src_off, "src_off", 1),
              (tiles.local, "local", 2))
    for t, name, ndim in arrays:
        _require(t, f"tiles.{name}", torch.int32, ndim, device)
    if (tiles.verts.shape[0] != table.shape[0]
            or tiles.local.shape != table.shape
            or tiles.src_off.shape[0] != tiles.n_tiles + 1
            or tiles.max_rows > plan.rows):
        raise ValueError(f"tiles do not describe table "
                         f"{tuple(table.shape)} in {plan.rows}-row tiles")
    return tuple(_ptr(t) for t, _, _ in arrays)


def spiral_conv_fwd(x: torch.Tensor, table: torch.Tensor,
                    w_l: torch.Tensor, b: torch.Tensor,
                    plan: SpiralPlan | None = None,
                    out_dtype: torch.dtype | None = None,
                    tiles=None) -> torch.Tensor:
    """K1: ``out[m] = b + Σ_l x[table[m, l]] @ w_l[l]`` for
    ``x [N_src, B, C_in]``, ``table [M, L]``, ``w_l [L, C_in, C_out]``;
    returns ``[M, B, C_out]``. ``plan`` defaults to
    ``plan_spiral_conv``'s (with ``tiles``, the op's ``ops.SpiralTiles``,
    for C_out < 8: the ``narrow_tile`` and ``bf16_tile`` kernels read the
    table through them); the kernel rejects a plan it cannot run.

    bf16 ``x`` (with ``w_l`` and ``b`` bf16): K1-bf16, an fp32
    accumulator from ``b`` rounded to bf16 once; with ``out_dtype``
    float32, K3a: the same accumulator returned unrounded."""
    dev = x.device
    dtype = _rows_dtype(x)
    _require(x, "x", dtype, 3, dev)
    _require(table, "table", torch.int32, 2, dev)
    _require(w_l, "w", dtype, 3, dev)
    _require(b, "b", dtype, 1, dev)
    if out_dtype not in (None, dtype, torch.float32):
        raise ValueError(f"out_dtype {out_dtype} for {dtype} x")
    f32out = dtype == torch.bfloat16 and out_dtype == torch.float32
    n_src, bsz, c_in = x.shape
    m, seq = table.shape
    if w_l.shape[:2] != (seq, c_in) or b.shape[0] != w_l.shape[2]:
        raise ValueError(f"w {tuple(w_l.shape)} / b {tuple(b.shape)} do "
                         f"not fit L={seq}, C_in={c_in}")
    c_out = w_l.shape[2]
    _fits_int32(n_src * bsz * c_in, m * bsz * c_out, m * seq)
    out = torch.empty((m, bsz, c_out),
                      dtype=torch.float32 if f32out else dtype, device=dev)
    if m == 0 or bsz == 0 or c_out == 0:
        return out
    if n_src == 0 or seq == 0 or c_in == 0:
        raise ValueError("spiral conv needs source rows, positions and "
                         "input channels")
    n_tiles = tiles.n_tiles if tiles else 0
    tile_rows = tiles.max_rows if tiles else 0
    if dtype == torch.bfloat16:
        if plan is None:
            plan = plan_spiral_conv(m, bsz, seq, c_in, c_out,
                                    x.data_ptr() % 4 == 0, True, dtype,
                                    n_tiles, tile_rows)
        if not plan.path.startswith("bf16"):
            raise ValueError(f"plan path {plan.path!r} is not a bf16 path")
        name = "spiral_conv_f32out" if f32out else plan.kernel
        if plan.path == "bf16_tile":
            if tiles is not None and tiles.max_verts > _BF16_TILE_VERTS:
                raise ValueError(f"tiles of {tiles.max_verts} vertices: the "
                                 f"bf16_tile kernel takes at most "
                                 f"{_BF16_TILE_VERTS}")
            _launch(name, library().cfs_spiral_conv_bf16_tile, dev, _ptr(x),
                    *_tile_ptrs(tiles, table, plan, dev), _ptr(w_l), _ptr(b),
                    _ptr(out), m, seq, bsz, c_in, c_out, n_tiles, plan.rows,
                    plan.tb, plan.n_btiles, plan.threads, plan.smem,
                    int(f32out))
            return out
        _launch(name, library().cfs_spiral_conv_bf16, dev, _ptr(x),
                _ptr(table), _ptr(w_l), _ptr(b), _ptr(out), m, seq, bsz,
                c_in, c_out, plan.nt // 8, int(plan.path == "bf16_elem"),
                plan.kp, plan.ldw, plan.blocks, plan.smem, int(f32out))
        return out
    if plan is None:
        plan = plan_spiral_conv(m, bsz, seq, c_in, c_out,
                                x.data_ptr() % 16 == 0,
                                w_l.data_ptr() % 16 == 0,
                                n_tiles=n_tiles, tile_rows=tile_rows)
    if plan.path.startswith("bf16"):
        raise ValueError(f"plan path {plan.path!r} needs bf16 x")
    fields = plan.as_ints()
    if plan.path == "narrow_tile":
        _launch(plan.kernel, library().cfs_spiral_conv_narrow_tile, dev,
                _ptr(x), *_tile_ptrs(tiles, table, plan, dev), _ptr(w_l),
                _ptr(b), _ptr(out), m, seq, bsz, c_in, c_out, n_tiles,
                (ctypes.c_int * len(fields))(*fields))
        return out
    _launch(plan.kernel, library().cfs_spiral_conv_fwd, dev,
            _ptr(x), _ptr(table), _ptr(w_l), _ptr(b), _ptr(out),
            m, seq, bsz, c_in, c_out, (ctypes.c_int * len(fields))(*fields))
    return out


# K2-dW planner constants (csrc/spiral_conv_dw.cu checks every plan)
_DW_MAX_WARPS = 9             # its launch bounds: 288 threads, 2 blocks an SM
_DW_BLOCKS_PER_SM = 2
_DW_ROWS = (64, 32)           # reduction rows per vertex tile, at most
_DW_MIN_ROWS = 16             # ... and at least, where B allows
_DW_STAGES = (3, 2)           # ring stages, the most that fit first
_DW_BAR_FLOATS = 16           # shared memory of the stages' mbarriers


@dataclass(frozen=True)
class DwPlan:
    """One K2-dW launch. The wider of C_in and C_out is the MMA's M side
    (``x_on_m``: C_in), the other its N side. A warp owns ``mi`` x ``ni``
    fragments (16 x 8 each) of one position; ``fgm`` x ``fgn`` such warp
    blocks make a block's output block for each of its ``positions``.
    Grid: (chunks, position groups, output blocks ``zm`` x ``zn``)."""
    x_on_m: bool
    mi: int
    ni: int
    fgm: int
    fgn: int
    positions: int        # spiral positions per block, a divisor of L
    stages: int           # ring stages, one vertex tile (all positions) each
    tmv: int              # vertices per tile (all B batch rows of each)
    rows_p: int           # a tile's reduction rows, padded to 8
    ldx: int              # row strides in shared memory, floats
    ldd: int
    n_vtiles: int
    tiles_per_chunk: int
    n_chunks: int
    groups: int
    zm: int
    zn: int
    threads: int
    smem: int             # dynamic shared memory, bytes
    vec_x: bool           # 16-byte copies (else 4-byte)
    vec_d: bool

    @property
    def grid(self) -> tuple:
        return (self.n_chunks, self.groups, self.zm * self.zn)

    @property
    def blocks(self) -> int:
        return self.n_chunks * self.groups * self.zm * self.zn

    def as_ints(self) -> tuple:
        """The plan as csrc/spiral_conv_dw.cu's DwField array."""
        return (int(self.x_on_m), self.mi, self.ni, self.fgm, self.fgn,
                self.positions, self.stages, self.tmv, self.rows_p,
                self.ldx, self.ldd, self.n_vtiles, self.tiles_per_chunk,
                self.n_chunks, self.groups, self.zm, self.zn, self.threads,
                self.smem, int(self.vec_x), int(self.vec_d))


def _dw_stride(width: int) -> int:
    """The least row stride ≥ ``width`` that is 8 or 24 mod 32 floats:
    the lanes' fragment loads (k = tig, column gid) then hit 32 banks."""
    ld = _cdiv(width, 8) * 8
    while ld % 32 not in (8, 24):
        ld += 8
    return ld


def _dw_warp_blocks(seq, wide, narrow):
    """``(P, MI, NI, fgm, fgn, zm, zn)``: warp tiles of up to 32 x 32,
    the position's output in at most nine of them per block (grid.z over
    the rest), and the most positions whose warps make at most nine."""
    mi = 2 if wide > 16 else 1
    ni = 4 if narrow > 16 else 2 if narrow > 8 else 1
    fm, fn = _cdiv(wide, 16 * mi), _cdiv(narrow, 8 * ni)
    fgm = min(fm, 3)
    fgn = min(fn, _DW_MAX_WARPS // fgm)
    p = max(d for d in range(1, seq + 1)
            if seq % d == 0 and d * fgm * fgn <= _DW_MAX_WARPS)
    return p, mi, ni, fgm, fgn, _cdiv(fm, fgm), _cdiv(fn, fgn)


@functools.lru_cache(maxsize=1024)
def plan_spiral_conv_dw(m: int, b: int, seq: int, c_in: int, c_out: int,
                        x_aligned: bool = True,
                        dy_aligned: bool = True) -> DwPlan:
    """The K2-dW launch for ``dW [seq, c_in, c_out]`` over ``m`` vertices
    of ``b`` batch rows; ``x_aligned``/``dy_aligned``: whether x and dy
    start on 16 bytes. The largest tile (64 or 32 reduction rows) and
    then the deepest ring (three stages or two) with which two blocks
    still fit on an SM (``k2_sweep``); one block an SM where not even
    that fits. Raises for a shape that does not fit."""
    for rows in _DW_ROWS:
        for stages in _DW_STAGES:
            plan = _dw_plan(m, b, seq, c_in, c_out, x_aligned, dy_aligned,
                            rows, stages, _DW_BLOCKS_PER_SM)
            if plan.smem <= _SMEM_SM // _DW_BLOCKS_PER_SM - _SMEM_RESERVED:
                return plan
    plan = _dw_plan(m, b, seq, c_in, c_out, x_aligned, dy_aligned,
                    _DW_ROWS[-1], _DW_STAGES[-1], 1)
    if plan.smem > _SMEM_BLOCK:
        raise ValueError(f"no K2-dW tile of C_in={c_in}, C_out={c_out}, "
                         f"B={b}, L={seq} fits in shared memory")
    return plan


def _dw_plan(m, b, seq, c_in, c_out, x_aligned, dy_aligned, rows, stages,
            per_sm) -> DwPlan:
    """A K2-dW launch with vertex tiles of at most ``rows`` reduction rows
    (halved, down to 16 rows, while the grid has fewer than ``per_sm``
    blocks per SM), ``stages`` ring stages and chunks of whole tiles, as
    many as ``per_sm`` blocks per SM hold in one wave. Its shared memory
    may exceed what the card offers: the caller checks."""
    if min(m, b, seq, c_in, c_out) < 1:
        raise ValueError(f"spiral conv dW needs M, B, L, C_in, C_out ≥ 1; "
                         f"got {m}, {b}, {seq}, {c_in}, {c_out}")
    x_on_m = c_in >= c_out
    wide, narrow = (c_in, c_out) if x_on_m else (c_out, c_in)
    p, mi, ni, fgm, fgn, zm, zn = _dw_warp_blocks(seq, wide, narrow)
    bm, bn = 16 * mi * fgm, 8 * ni * fgn
    cover_x, cover_d = ((zm * bm, zn * bn) if x_on_m else (zn * bn, zm * bm))
    ldx, ldd = _dw_stride(cover_x), _dw_stride(cover_d)
    groups = seq // p
    target = _SMS * per_sm
    tmv = max(1, rows // b)
    tmv_min = min(tmv, _cdiv(_DW_MIN_ROWS, b))
    while tmv > tmv_min and _cdiv(m, tmv) * groups * zm * zn < target:
        tmv = max(tmv // 2, tmv_min)
    rows_p = _cdiv(tmv * b, 8) * 8
    n_vtiles = _cdiv(m, tmv)
    # at most one wave: no more chunks than the SMs hold at once, each
    # with its table slice (tiles·tmv vertices x p positions)
    tpc = _cdiv(n_vtiles, max(1, target // (groups * zm * zn)))
    smem = _round16(4 * (_DW_BAR_FLOATS + stages * rows_p * (p * ldx + ldd)
                         + tpc * tmv * p))
    return DwPlan(x_on_m=x_on_m, mi=mi, ni=ni, fgm=fgm, fgn=fgn,
                  positions=p, stages=stages, tmv=tmv, rows_p=rows_p,
                  ldx=ldx, ldd=ldd, n_vtiles=n_vtiles, tiles_per_chunk=tpc,
                  n_chunks=_cdiv(n_vtiles, tpc), groups=groups, zm=zm, zn=zn,
                  threads=32 * p * fgm * fgn, smem=smem,
                  vec_x=c_in % 4 == 0 and x_aligned,
                  vec_d=c_out % 4 == 0 and dy_aligned)


_DW_BF16_WARPS = 4            # csrc/spiral_conv_dw_bf16.cu's kWarps
_DW_BF16_FPW = (1, 2, 4, 8, 16, 32)
_DW_BF16_TILE = 64            # rows per staged tile, two stages
_DW_BF16_BLOCKS_PER_SM = 8



@dataclass(frozen=True)
class DwBf16Plan:
    """One K2-dW-bf16 launch: grid (``n_chunks``, L), each block one
    position over ``chunk_v`` vertices; its 4 warps hold at most ``fpw``
    16 x 8 fragments of the position's dW each."""
    fpw: int
    chunk_v: int
    n_chunks: int
    smem: int


@functools.lru_cache(maxsize=1024)
def plan_spiral_conv_dw_bf16(m: int, b: int, seq: int, c_in: int,
                             c_out: int) -> DwBf16Plan:
    """The K2-dW-bf16 launch for ``dW [seq, c_in, c_out]`` over ``m``
    vertices of ``b`` batch rows: chunks of whole vertices, at least one
    staged tile of rows each, as many as 8 blocks an SM hold over the
    ``seq`` positions; shared memory for two stages of 64 rows of x and
    dy. Raises for channels beyond 128."""
    if min(m, b, seq, c_in, c_out) < 1:
        raise ValueError(f"spiral conv dW needs M, B, L, C_in, C_out ≥ 1; "
                         f"got {m}, {b}, {seq}, {c_in}, {c_out}")
    if max(c_in, c_out) > 128:
        raise ValueError(f"C_in {c_in} and C_out {c_out} must be ≤ 128 for "
                         "the bf16 kernel")
    fm, fn = _cdiv(c_in, 16), _cdiv(c_out, 8)
    fpw = next(f for f in _DW_BF16_FPW if _DW_BF16_WARPS * f >= fm * fn)
    target = max(1, _SMS * _DW_BF16_BLOCKS_PER_SM // seq)
    chunk_v = max(_cdiv(m, target), _cdiv(_DW_BF16_TILE, b))
    return DwBf16Plan(fpw=fpw, chunk_v=chunk_v, n_chunks=_cdiv(m, chunk_v),
                      smem=2 * _DW_BF16_TILE * 2 * (_odd_stride(16 * fm)
                                                    + _odd_stride(8 * fn)))


def spiral_conv_dw(x: torch.Tensor, table: torch.Tensor,
                   dy: torch.Tensor, plan: DwPlan | DwBf16Plan | None = None
                   ) -> torch.Tensor:
    """K2-dW: ``dW[l] = Σ_{m,b} x[table[m, l], b]ᵀ dy[m, b]`` for
    ``x [N_src, B, C_in]``, ``table [M, L]``, ``dy [M, B, C_out]``;
    returns ``[L, C_in, C_out]``. Deterministic: fixed chunks summed in a
    fixed order through a scratch buffer allocated here. ``plan`` defaults
    to ``plan_spiral_conv_dw``'s; the kernel rejects one it cannot run.
    bf16 x and dy: K2-dW-bf16 (``plan_spiral_conv_dw_bf16``), fp32 sums
    rounded to a bf16 dW once."""
    dev = x.device
    dtype = _rows_dtype(x)
    _require(x, "x", dtype, 3, dev)
    _require(table, "table", torch.int32, 2, dev)
    _require(dy, "dy", dtype, 3, dev)
    n_src, bsz, c_in = x.shape
    m, seq = table.shape
    if dy.shape[:2] != (m, bsz):
        raise ValueError(f"dy {tuple(dy.shape)} does not fit table "
                         f"{tuple(table.shape)} and batch {bsz}")
    c_out = dy.shape[2]
    _fits_int32(n_src * bsz * c_in, m * bsz * c_out, m * seq,
                seq * c_in * c_out)
    out = torch.empty((seq, c_in, c_out), dtype=dtype, device=dev)
    if seq == 0 or c_in == 0 or c_out == 0:
        return out
    if m == 0 or bsz == 0:
        return out.zero_()
    if n_src == 0:
        raise ValueError("spiral conv dW needs source rows")
    if dtype == torch.bfloat16:
        if plan is None:
            plan = plan_spiral_conv_dw_bf16(m, bsz, seq, c_in, c_out)
        if not isinstance(plan, DwBf16Plan):
            raise ValueError("bf16 x needs a DwBf16Plan")
        _fits_int32(plan.n_chunks * seq * c_in * c_out)
        part = torch.empty(plan.n_chunks * seq * c_in * c_out,
                           dtype=torch.float32, device=dev)
        _launch("spiral_conv_dw_bf16", library().cfs_spiral_conv_dw_bf16,
                dev, _ptr(x), _ptr(table), _ptr(dy), _ptr(part), _ptr(out),
                m, seq, bsz, c_in, c_out, plan.fpw, plan.chunk_v,
                plan.n_chunks, plan.smem)
        return out
    if plan is None:
        plan = plan_spiral_conv_dw(m, bsz, seq, c_in, c_out,
                                   x.data_ptr() % 16 == 0,
                                   dy.data_ptr() % 16 == 0)
    if not isinstance(plan, DwPlan):
        raise ValueError("float32 x needs a DwPlan")
    _fits_int32(plan.n_chunks * seq * c_in * c_out)
    part = torch.empty(plan.n_chunks * seq * c_in * c_out,
                       dtype=torch.float32, device=dev)
    fields = plan.as_ints()
    _launch("spiral_conv_dw", library().cfs_spiral_conv_dw, dev,
            _ptr(x), _ptr(table), _ptr(dy), _ptr(part), _ptr(out), m, seq,
            bsz, c_in, c_out, (ctypes.c_int * len(fields))(*fields))
    return out


_OUT_GATHER_MAX_O = 8           # csrc/out_gather_sum.cu's kMaxO
_OUT_GATHER_FIELDS = 16         # ops.OutGatherBwd.info's columns


def out_gather_sum(u: torch.Tensor, table: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """K3b: ``out[m, b, o] = bias[o] + Σ_l u[l, o, table[m, l], b]`` in
    position order, one rounding per add, for the position-major ``u [L,
    O, N, B]`` (the matmul-first conv's products of every position),
    ``table [M, L]``, ``b [O]`` (O ≤ 8), all float32 but the table;
    returns ``[M, B, O]``."""
    dev = u.device
    _require(u, "u", torch.float32, 4, dev)
    _require(table, "table", torch.int32, 2, dev)
    _require(b, "b", torch.float32, 1, dev)
    seq, o, n, bsz = u.shape
    m = table.shape[0]
    if table.shape[1] != seq or b.shape[0] != o:
        raise ValueError(f"u {tuple(u.shape)}, table {tuple(table.shape)} "
                         f"and b {tuple(b.shape)} do not fit")
    if o > _OUT_GATHER_MAX_O:
        raise ValueError(f"out_gather_sum takes at most {_OUT_GATHER_MAX_O} "
                         f"outputs; got {o}")
    _fits_int32(u.numel(), m * bsz * o, m * seq)
    out = torch.empty((m, bsz, o), dtype=torch.float32, device=dev)
    if m == 0 or bsz == 0 or o == 0:
        return out
    if n == 0 or seq == 0:
        raise ValueError("out_gather_sum needs source rows and positions")
    _launch("out_gather_sum", library().cfs_out_gather_sum, dev, _ptr(u),
            _ptr(table), _ptr(b), _ptr(out), m, n, seq, bsz, o)
    return out


def out_gather_sum_bwd(dout: torch.Tensor, bwd) -> torch.Tensor:
    """K3b's backward in one launch: for each position ``l`` of ``bwd``
    (an ``ops.OutGatherBwd``, every position's capped transpose over the
    N source rows), ``du[l] = transpose_l.apply(dout)`` in
    ``CappedEll.apply``'s order and roundings (``dout`` itself at the
    identity position), for ``dout [M, B, O]`` float32 (O ≤ 8); returns
    ``du`` in ``u``'s layout, ``[L, O, N, B]``."""
    dev = dout.device
    _require(dout, "dout", torch.float32, 3, dev)
    _require(bwd.info, "info", torch.int32, 2, dev)
    _require(bwd.cols, "cols", torch.int32, 1, dev)
    _require(bwd.vals, "vals", torch.float32, 1, dev)
    _require(bwd.links, "links", torch.int32, 1, dev)
    m, bsz, o = dout.shape
    seq, n = bwd.info.shape[0], bwd.n_src
    if (bwd.info.shape[1] != _OUT_GATHER_FIELDS or m != bwd.m
            or bwd.vals.shape != bwd.cols.shape):
        raise ValueError(f"dout {tuple(dout.shape)} does not fit the "
                         f"backward table of {bwd.m} rows, or the table is "
                         "malformed")
    if o > _OUT_GATHER_MAX_O:
        raise ValueError(f"out_gather_sum_bwd takes at most "
                         f"{_OUT_GATHER_MAX_O} outputs; got {o}")
    _fits_int32(seq * o * n * bsz, m * bsz * o)
    du = torch.empty((seq, o, n, bsz), dtype=torch.float32, device=dev)
    if du.numel() == 0:
        return du
    if m == 0:
        raise ValueError("out_gather_sum_bwd needs cotangent rows")
    _launch("out_gather_sum_bwd", library().cfs_out_gather_sum_bwd, dev,
            _ptr(dout), _ptr(bwd.info), _ptr(bwd.cols), _ptr(bwd.vals),
            _ptr(bwd.links), _ptr(du), m, n, seq, bsz, o)
    return du


def raster_sweep(coef: torch.Tensor, box: torch.Tensor,
                 block_box: torch.Tensor, b_ymin: torch.Tensor,
                 b_ymax: torch.Tensor, image_size: int,
                 cull_tile: int) -> tuple:
    """K7: the z-buffer sweep of a batch of meshes over an
    ``image_size²`` image: ``coef [B, Fp, 16]`` (Fp a multiple of 256),
    each triangle's widened ``box [B, Fp, 4]``, each block's
    ``block_box [B, nb, 4]`` and row range ``ymin``/``ymax [B, nb]``,
    culled per ``cull_tile`` pixels as the plain twin culls
    (``viz/raster.py``); returns ``(z [B, P] f32, winner [B, P] i32)``."""
    dev = coef.device
    _require(coef, "coef", torch.float32, 3, dev)
    _require(box, "box", torch.float32, 3, dev)
    _require(block_box, "block_box", torch.float32, 3, dev)
    _require(b_ymin, "ymin", torch.float32, 2, dev)
    _require(b_ymax, "ymax", torch.float32, 2, dev)
    bsz, n_tblocks = b_ymin.shape
    fp = n_tblocks * 256
    if (coef.shape != (bsz, fp, 16) or box.shape != (bsz, fp, 4)
            or block_box.shape != (bsz, n_tblocks, 4)
            or b_ymax.shape != (bsz, n_tblocks)):
        raise ValueError(
            f"coef {tuple(coef.shape)}, box {tuple(box.shape)}, block_box "
            f"{tuple(block_box.shape)}, ymax {tuple(b_ymax.shape)} do not "
            f"hold {bsz} meshes of {n_tblocks} blocks of 256 triangles")
    if not 1 <= bsz <= 65535 or n_tblocks < 1:
        raise ValueError(f"{bsz} meshes of {n_tblocks} blocks: need 1 to "
                         "65535 meshes and at least one block")
    if any(t.data_ptr() % 16 for t in (coef, box, block_box)):
        raise ValueError("coef, box and block_box must be 16-byte aligned")
    n_pix = image_size * image_size
    if image_size < 1 or not 1 <= cull_tile <= n_pix:
        raise ValueError("image_size must be positive and cull_tile in "
                         "[1, image_size²]")
    _fits_int32((image_size + 16) ** 2 + 1024, bsz * fp * 4)
    z = torch.empty((bsz, n_pix), dtype=torch.float32, device=dev)
    winner = torch.empty((bsz, n_pix), dtype=torch.int32, device=dev)
    _launch("raster_sweep", library().cfs_raster_sweep, dev,
            _ptr(coef), _ptr(box), _ptr(block_box), _ptr(b_ymin),
            _ptr(b_ymax), _ptr(z), _ptr(winner), bsz, n_tblocks, image_size,
            cull_tile)
    return z, winner


def _cloud(t: torch.Tensor, name: str, dev: torch.device) -> tuple:
    """A point cloud ``[n, 3]`` (shared by every batch: stride 0) or
    ``[R, n, 3]`` (one per batch) → (R or None, n, stride)."""
    if t.dim() not in (2, 3) or t.shape[-1] != 3:
        raise ValueError(f"{name} must be [n, 3] or [R, n, 3]; got "
                         f"{tuple(t.shape)}")
    _require(t, name, torch.float32, t.dim(), dev)
    n = t.shape[-2]
    if t.dim() == 2:
        return None, n, 0
    return t.shape[0], n, n * 3


def _batch_of(*rs) -> int:
    given = {r for r in rs if r is not None}
    if len(given) > 1:
        raise ValueError(f"the clouds' batch sizes {sorted(given)} differ")
    batch = given.pop() if given else 1
    if not 1 <= batch <= 65535:
        raise ValueError(f"batch {batch} is not in [1, 65535]")
    return batch


def nearest_sq(query: torch.Tensor, ref: torch.Tensor,
               mu: torch.Tensor) -> tuple:
    """K8 forward (``csrc/distances.cu``, counted as ``k8_fwd``): for each
    point of ``query`` ([nq, 3] or [R, nq, 3]), its squared distance to
    the nearest point of ``ref`` ([nr, 3] or [R, nr, 3]) after both are
    centred on ``mu [3]``, in the expansion form ``‖u‖² + min (‖v‖² −
    2u·v)`` clamped at 0, and the first index reaching it. Returns ``(d
    [R, nq] f32, idx [R, nq] i32)`` (R = 1 when neither cloud is
    batched)."""
    dev = query.device
    rq, nq, q_stride = _cloud(query, "query", dev)
    rr, nr, r_stride = _cloud(ref, "ref", dev)
    _require(mu, "mu", torch.float32, 1, dev)
    if mu.shape[0] != 3:
        raise ValueError(f"mu must be [3]; got {tuple(mu.shape)}")
    batch = _batch_of(rq, rr)
    if nq < 1 or nr < 1:
        raise ValueError("both clouds need at least one point")
    _fits_int32(batch * nq * 3, batch * nr * 3)
    d = torch.empty((batch, nq), dtype=torch.float32, device=dev)
    idx = torch.empty((batch, nq), dtype=torch.int32, device=dev)
    _launch("k8_fwd", library().cfs_nearest_sq, dev, _ptr(query), q_stride,
            nq, _ptr(ref), r_stride, nr, _ptr(mu), batch, _ptr(d), _ptr(idx))
    return d, idx


def nearest_sq_bwd(query: torch.Tensor, ref: torch.Tensor, mu: torch.Tensor,
                   g_u: torch.Tensor, d_u: torch.Tensor, idx_u: torch.Tensor,
                   g_v: torch.Tensor, d_v: torch.Tensor, perm: torch.Tensor,
                   offsets: torch.Tensor) -> torch.Tensor:
    """K8 backward (``csrc/distances.cu``, counted as ``k8_bwd``): the
    gradient in ``query`` of ``Σ g_u·d_u + Σ g_v·d_v``, where ``d_u, idx_u
    [R, nq]`` are the query side's distances and argmins and ``d_v [R,
    nr]`` the other side's, whose argmins are given as a CSR over the
    query points (``perm [R, nr]``: each batch's ``j`` sorted stably by
    their argmin; ``offsets [R, nq + 1]``: each query point's segment).
    Returns ``[R, nq, 3]`` f32."""
    dev = query.device
    rq, nq, q_stride = _cloud(query, "query", dev)
    rr, nr, r_stride = _cloud(ref, "ref", dev)
    _require(mu, "mu", torch.float32, 1, dev)
    batch = _batch_of(rq, rr)
    for t, name, dtype, cols in ((g_u, "g_u", torch.float32, nq),
                                 (d_u, "d_u", torch.float32, nq),
                                 (idx_u, "idx_u", torch.int32, nq),
                                 (g_v, "g_v", torch.float32, nr),
                                 (d_v, "d_v", torch.float32, nr),
                                 (perm, "perm", torch.int32, nr),
                                 (offsets, "offsets", torch.int32, nq + 1)):
        _require(t, name, dtype, 2, dev)
        if tuple(t.shape) != (batch, cols):
            raise ValueError(f"{name} must be {(batch, cols)}; got "
                             f"{tuple(t.shape)}")
    if mu.shape[0] != 3 or nq < 1 or nr < 1:
        raise ValueError("mu must be [3] and both clouds non-empty")
    _fits_int32(batch * nq * 3, batch * nr * 3)
    out = torch.empty((batch, nq, 3), dtype=torch.float32, device=dev)
    _launch("k8_bwd", library().cfs_nearest_sq_bwd, dev, _ptr(query),
            q_stride, nq, _ptr(ref), r_stride, nr, _ptr(mu), batch,
            _ptr(g_u), _ptr(d_u), _ptr(idx_u), _ptr(g_v), _ptr(d_v),
            _ptr(perm), _ptr(offsets), _ptr(out))
    return out

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
error. None of them falls back to a plain version: the callers (for the
serving kernels, the custom ops of ``ops/library.py``) choose the plain
twin only for CPU tensors.

The ``mixed`` and ``bfloat16`` policies' kernels go through the same
wrappers: K4 and its capped form, K1 and K2-dW each take bf16 rows
(``csrc/*_bf16.cu``, counted under their own names), which none of them
converts; K3b (``out_gather_sum``) is the matmul-first final conv's
gather-sum and ``out_gather_sum_bwd`` its backward. K2-dx
(``spiral_conv_dx``, fp32 or bf16 rows) is the spiral conv's input
gradient. K9 (``cheby_step``) is one step of the Laplacian eigensolver's
Chebyshev filter, over the Laplacian's vertex tiles; its panels may be
row-strided views. K8-sinkhorn (``sinkhorn_fwd``, ``sinkhorn_bwd``) is
the Sinkhorn divergence and its gradient, each one wrapper call.
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
           "bf16_vec_plan", "spiral_conv_fwd",
           "DwPlan", "plan_spiral_conv_dw", "DwBf16Plan", "dw_bf16_plan",
           "plan_spiral_conv_dw_bf16",
           "spiral_conv_dw", "DxPlan", "plan_spiral_conv_dx",
           "spiral_conv_dx", "out_gather_sum", "out_gather_bwd_plan",
           "out_gather_sum_bwd",
           "raster_sweep", "k8_plan", "k8_bwd_bins", "nearest_sq",
           "nearest_sq_sym", "nearest_sq_bwd", "cheby_step",
           "sinkhorn_fwd", "sinkhorn_bwd"]

_PKG = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "kernels")
SOURCES = ("ell_matmul.cu", "raster_sweep.cu", "spiral_conv.cu",
           "spiral_conv_dw.cu", "ell_matmul_bf16.cu", "spiral_conv_bf16.cu",
           "spiral_conv_dw_bf16.cu", "out_gather_sum.cu", "distances.cu",
           "cheby_step.cu", "spiral_conv_dx.cu", "sinkhorn.cu")
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
                "out_gather_sum_bwd", "k8_fwd", "k8_bwd", "cheby_step",
                "spiral_conv_dx", "spiral_conv_dx_bf16", "sinkhorn_fwd",
                "sinkhorn_bwd")

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

    def add(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counts[name] += n

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
            lib.cfs_spiral_conv_bf16.argtypes = [p, p, p, p, p] + [i] * 11 \
                + [p]
            lib.cfs_spiral_conv_bf16_vec.argtypes = [p] * 9 + [i] * 15 + [p]
            lib.cfs_spiral_conv_dw_bf16.argtypes = [p] * 9 + [i] * 6 + [
                ctypes.POINTER(i), p]
            lib.cfs_out_gather_sum.argtypes = [p, p, p, p, i, i, i, i, i, p]
            lib.cfs_out_gather_sum_bwd.argtypes = [p] * 8 + [i] * 10 + [p]
            lib.cfs_spiral_conv_narrow_tile.argtypes = [
                p] * 9 + [i] * 6 + [ctypes.POINTER(i), p]
            lib.cfs_spiral_conv_bf16_tile.argtypes = [p] * 9 + [i] * 12 \
                + [p]
            lib.cfs_nearest_sq.argtypes = [p, i, i, p, i, i, p, i, i, i] \
                + [p] * 6 + [p]
            lib.cfs_nearest_sq_bwd.argtypes = [p, i, i, p, i, i, p, i] \
                + [p] * 6 + [i] + [p] * 4 + [p]
            lib.cfs_cheby_step.argtypes = [p] * 6 + [i] * 3 + [p] * 4 + [
                i] * 4 + [ctypes.c_float, ctypes.c_float, p]
            lib.cfs_spiral_conv_dx.argtypes = [p] * 5 + [i] * 7 + [
                ctypes.POINTER(i), p]
            lib.cfs_sinkhorn_fwd.argtypes = [p, p, i, i, ctypes.c_float, i,
                                             p, p, p, p, p]
            lib.cfs_sinkhorn_bwd.argtypes = [p, p, i, i, ctypes.c_float, i,
                                             p, p, p, p, p, p, p, p]
            lib.cfs_cheby_step_smem.argtypes = [i, i, i]
            lib.cfs_cheby_step_smem.restype = ctypes.c_int
            lib.cfs_cheby_step_blocks_per_sm.argtypes = [i, i, i]
            lib.cfs_cheby_step_blocks_per_sm.restype = ctypes.c_int
            for fn in (lib.cfs_ell_matmul_fwd, lib.cfs_spiral_conv_fwd,
                       lib.cfs_raster_sweep, lib.cfs_ell_matmul_capped,
                       lib.cfs_spiral_conv_dw, lib.cfs_ell_matmul_bf16,
                       lib.cfs_ell_matmul_capped_bf16,
                       lib.cfs_spiral_conv_bf16, lib.cfs_spiral_conv_bf16_vec,
                       lib.cfs_spiral_conv_dw_bf16,
                       lib.cfs_out_gather_sum, lib.cfs_out_gather_sum_bwd,
                       lib.cfs_spiral_conv_narrow_tile,
                       lib.cfs_spiral_conv_bf16_tile, lib.cfs_nearest_sq,
                       lib.cfs_nearest_sq_bwd, lib.cfs_cheby_step,
                       lib.cfs_spiral_conv_dx, lib.cfs_sinkhorn_fwd,
                       lib.cfs_sinkhorn_bwd):
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
    (W's row stride, bf16 values) and ``nt`` (columns a block, 8 per
    column tile); ``bf16`` (the tiled vector path) also ``tb``,
    ``n_btiles``, ``rows``, ``mi`` (16-row tiles a warp takes at once)
    and ``grid[1]`` (column slices of ``nt``); ``bf16_tile`` uses
    ``threads``, ``grid``, ``smem``, ``tb``, ``n_btiles`` and ``rows``,
    as ``narrow_tile`` does."""
    path: str             # "tc", "tc_pad_k" (C_in < 8), "narrow_tile",
    #                       "narrow_out" (no tiles, another shape, or rows
    #                       that do not fit), "bf16" (C_in % 16 == 0, with
    #                       tiles), "bf16_elem" (any other bf16 conv) or
    #                       "bf16_tile" (the final conv's shape, C_out < 8,
    #                       with tiles)
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
    rows: int = 0         # tiled paths: staged source rows per vertex tile

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
    ``dtype`` bfloat16, x on 4 bytes and the tiles given: K3a's tiled
    kernel for C_out < 8 at the shape it is compiled for
    (``_plan_bf16_tile``), else the tiled vector kernel where C_in is a
    multiple of 16 (``_plan_bf16_vec``); any other bf16 conv the element
    path (``_plan_bf16``). Raises for a shape that no path takes."""
    if min(m, b, seq, c_in) < 1:
        raise ValueError(f"spiral conv needs M, B, L, C_in ≥ 1; got "
                         f"{m}, {b}, {seq}, {c_in}")
    if dtype == torch.bfloat16:
        plan = None
        if n_tiles > 0 and tile_rows > 0 and x_aligned and c_out >= 1:
            if c_out < 8:
                plan = _plan_bf16_tile(b, seq, c_in, n_tiles, tile_rows)
            if plan is None and c_in % 16 == 0:
                plan = _plan_bf16_vec(m, b, seq, c_in, c_out, n_tiles,
                                      tile_rows)
        return plan or _plan_bf16(m, b, seq, c_in, c_out)
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


def _plan_bf16(m, b, seq, c_in, c_out) -> SpiralPlan:
    """The bf16 kernel's element path: 8 warps a block, 16 rows a warp,
    all of C_out in column tiles of 8 (a power of two of them), W in
    shared memory as it lies in device memory, its depth padded to 16,
    each value of the A fragments loaded on its own. Blocks are
    persistent: as many as the SMs hold, at most one a row tile per
    warp."""
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
    return SpiralPlan("bf16_elem", threads=_BF16_THREADS, grid=(blocks, 1),
                      smem=smem, tb=0, n_btiles=0, kp=ksteps, ldw=ldw,
                      nt=8 * nt)


_BF16_VEC_THREADS = 256       # csrc/spiral_conv_bf16.cu's kVecThreads
_BF16_VEC_PER_SM = 2          # blocks an SM holds, where they fit
_BF16_VEC_MT2_ROWS = 96       # an item's rows from which a warp takes two
#                               16-row tiles at once


def bf16_vec_plan(b, seq, c_in, c_out, n_tiles, rows, tb, nt, mt=1,
                  per_sm=_BF16_VEC_PER_SM) -> SpiralPlan:
    """The ``bf16`` launch (the tiled vector kernel) with ``tb`` batch
    rows per item, in even batch tiles, ``nt`` column tiles of 8 per
    block (C_out in ``grid[1]`` slices) and ``mt`` 16-row tiles per warp
    at a time. An item is one vertex tile's batch tile; ``n_rtiles``
    items a slice, walked by ``grid[0]`` persistent blocks a slice, as
    many as the SMs hold over the slices at up to ``per_sm`` blocks an
    SM. Shared memory:
    the slice of W (``L·C_in`` rows at a stride of an odd number of
    16-byte units), two ring stages, each the tile's ``local`` and
    ``verts`` (64 vertices) and ``rows`` staged source rows of ``tb``
    batch rows, ``C_in + 8`` values each, and the offsets of four items
    and the source rows of two."""
    tb = min(b, tb)
    tb = _cdiv(b, _cdiv(b, tb))
    n_bt = _cdiv(b, tb)
    ldw = _odd_stride(8 * nt)
    index_ints = (_BF16_TILE_VERTS * (seq + 1) + 3) // 4 * 4
    stage = 4 * index_ints + 2 * rows * tb * (c_in + 8)
    splits = _cdiv(c_out, 8 * nt)
    items = n_tiles * n_bt
    smem = _round16(2 * seq * c_in * ldw + 2 * stage
                    + 4 * (16 + _cdiv(2 * rows, 4) * 4))
    per_sm = max(1, min(per_sm, _SMEM_SM // (smem + _SMEM_RESERVED)))
    return SpiralPlan("bf16", threads=_BF16_VEC_THREADS,
                      grid=(min(items, max(1, _SMS * per_sm // splits)),
                            splits), smem=smem, tb=tb, n_btiles=n_bt, n_rtiles=items,
                      kp=seq * c_in // 16, ldw=ldw, nt=8 * nt, mi=mt,
                      rows=rows)


def _plan_bf16_vec(m, b, seq, c_in, c_out, n_tiles, rows) -> SpiralPlan | None:
    """The tiled vector kernel's plan, from ``bf16_compare --sweep`` on
    the mixed model's convs at B = 16, 4 and 1 (PERF.md): all of C_out a
    block (up to 64 columns), and the most batch rows an item (16, 8, 4,
    2 or 1) with which two blocks share an SM, where that is at least 8
    (or all of B) and leaves two items an SM; else, on the smaller
    levels, the most batch rows with which one block fits, then, while
    the items of all slices are fewer than half the SMs, half the
    columns down to 32, half the batch rows, half the columns again. Two
    16-row tiles a warp at once where an item has
    ``_BF16_VEC_MT2_ROWS`` rows on average and a block at most 32
    columns (the kernel is compiled so). None where not even one batch
    row fits."""
    nt = next(t for t in (1, 2, 4, 8) if t == 8 or 8 * t >= c_out)

    def fitting(per_sm, nt):
        cap = min(_SMEM_BLOCK, _SMEM_SM // per_sm - _SMEM_RESERVED)
        return next((p for p in (
            bf16_vec_plan(b, seq, c_in, c_out, n_tiles, rows, tb, nt)
            for tb in (16, 8, 4, 2, 1)) if p.smem <= cap), None)

    plan = fitting(_BF16_VEC_PER_SM, nt)
    if (plan is None or plan.tb < min(b, 8)
            or plan.n_rtiles * plan.grid[1] < _BF16_VEC_PER_SM * _SMS):
        plan = fitting(1, nt)
        if plan is None:
            return None
        while plan.n_rtiles * plan.grid[1] < _SMS // 2:
            tb = plan.tb
            if nt > 4:
                nt //= 2
            elif tb > 1:
                tb //= 2
            elif nt > 1:
                nt //= 2
            else:
                break
            plan = bf16_vec_plan(b, seq, c_in, c_out, n_tiles, rows, tb, nt)
    per_item = m / n_tiles * plan.tb
    return dataclasses.replace(
        plan, mi=2 if per_item >= _BF16_VEC_MT2_ROWS and plan.nt <= 32
        else 1)


def _tile_ptrs(tiles, shape: tuple, device: torch.device, what: str,
               max_rows: int | None = None,
               max_verts: int | None = None) -> tuple:
    """The pointers of an op's vertex tiles (verts, starts, src, src_off,
    local), after checking that they describe a table of ``shape`` (their
    ``local``'s) in tiles of at most ``max_rows`` source rows and
    ``max_verts`` vertices, where given. ``what`` names the caller."""
    if tiles is None:
        raise ValueError(f"{what} needs the op's tiles")
    arrays = ((tiles.verts, "verts", 1), (tiles.starts, "starts", 1),
              (tiles.src, "src", 1), (tiles.src_off, "src_off", 1),
              (tiles.local, "local", 2))
    for t, name, ndim in arrays:
        _require(t, f"tiles.{name}", torch.int32, ndim, device)
    if (tiles.verts.shape[0] != shape[0]
            or tuple(tiles.local.shape) != tuple(shape)
            or tiles.src_off.shape[0] != tiles.n_tiles + 1
            or max_rows is not None and tiles.max_rows > max_rows
            or max_verts is not None
            and not 1 <= tiles.max_verts <= max_verts):
        raise ValueError(f"tiles do not describe table {tuple(shape)} in "
                         f"tiles of at most {max_rows} rows and {max_verts} "
                         f"vertices ({tiles.n_tiles} tiles, "
                         f"{tiles.max_rows} rows, {tiles.max_verts} "
                         f"vertices)")
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
    float32, K3a: the same accumulator returned unrounded. The tiled
    bf16 paths (``bf16``, ``bf16_tile``) need ``tiles``; without them
    the planner names the element path."""
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
        if plan.path == "bf16":
            _launch(name, library().cfs_spiral_conv_bf16_vec, dev, _ptr(x),
                    *_tile_ptrs(tiles, table.shape, dev,
                                f"the {plan.path} plan", plan.rows,
                                _BF16_TILE_VERTS),
                    _ptr(w_l), _ptr(b), _ptr(out), m, seq, bsz, c_in, c_out,
                    n_tiles, plan.rows, plan.tb, plan.n_btiles, plan.nt // 8,
                    plan.mi, plan.grid[1], plan.blocks, plan.smem,
                    int(f32out))
            return out
        if plan.path == "bf16_tile":
            _launch(name, library().cfs_spiral_conv_bf16_tile, dev, _ptr(x),
                    *_tile_ptrs(tiles, table.shape, dev,
                                f"the {plan.path} plan", plan.rows,
                                _BF16_TILE_VERTS),
                    _ptr(w_l), _ptr(b),
                    _ptr(out), m, seq, bsz, c_in, c_out, n_tiles, plan.rows,
                    plan.tb, plan.n_btiles, plan.threads, plan.smem,
                    int(f32out))
            return out
        _launch(name, library().cfs_spiral_conv_bf16, dev, _ptr(x),
                _ptr(table), _ptr(w_l), _ptr(b), _ptr(out), m, seq, bsz,
                c_in, c_out, plan.nt // 8, plan.kp, plan.ldw, plan.blocks,
                plan.smem, int(f32out))
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
                _ptr(x), *_tile_ptrs(tiles, table.shape, dev,
                                     f"the {plan.path} plan", plan.rows),
                _ptr(w_l), _ptr(b), _ptr(out), m, seq, bsz, c_in, c_out,
                n_tiles, (ctypes.c_int * len(fields))(*fields))
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


_DW_BF16_MAX_WARPS = 8        # csrc/spiral_conv_dw_bf16.cu's kMaxWarps
_DW_BF16_FN = (1, 2, 4, 8, 16)   # its compiled column fragments a unit
_DW_BF16_MAX_UPW = 4          # ... and units a warp, at most
_DW_BF16_MAX_FRAGS = 16       # fragments (64 fp32 accumulators) a warp,
#                               at most
_DW_BF16_PER_SM = 2           # blocks an SM holds, where they fit
_DW_BF16_PART_BYTES = 10 << 20  # the chunks' partials, at most, where the
#                                 batch is split


@dataclass(frozen=True)
class DwBf16Plan:
    """One K2-dW-bf16 launch: grid (``n_chunks``, ``groups``); a block
    owns a chunk, ``tpc`` consecutive vertex tiles (``ops.SpiralTiles``)
    times ``bpc`` consecutive batch tiles of ``tb`` rows, and a group of
    ``positions`` spiral positions; it walks the chunk's (tile, batch
    tile) items through two ring stages in shared memory, each sized for
    ``rows`` source rows and ``verts`` vertices. Chunks run tile runs
    major, batch runs minor. A unit is one (position, 16 channels) row of
    dW's 16 x 8 fragments across ``fn`` column fragments; each of the
    ``warps`` warps owns ``upw`` units. ``vec_x``/``vec_d``: 16-byte
    copies (else value by value)."""
    fn: int
    upw: int
    warps: int
    positions: int
    groups: int
    tb: int
    n_btiles: int
    tpc: int
    bpc: int
    n_chunks: int
    rows: int
    verts: int
    vec_x: bool
    vec_d: bool
    smem: int

    def as_ints(self) -> tuple:
        """The plan as csrc/spiral_conv_dw_bf16.cu's plan array."""
        return (self.fn, self.upw, self.warps, self.positions, self.tb,
                self.n_btiles, self.tpc, self.bpc, self.n_chunks, self.rows,
                self.verts, int(self.vec_x), int(self.vec_d), self.smem)


def _dw_bf16_stage(seq, c_in, c_out, rows, verts, tb) -> int:
    """Bytes of one of the two ring stages (csrc's ``stage_of``): x's
    entries ``[rows·tb + 1]`` (the last zero) and dy's rows
    ``[verts·tb]``, padded to 16 rows, at strides of an odd number of
    16-byte units, and the tile's ``local``."""
    xst = _odd_stride(16 * _cdiv(c_in, 16))
    dst = _odd_stride(8 * _cdiv(c_out, 8))
    return (2 * (_cdiv((rows * tb + 1) * xst, 8) * 8
                 + _round16(verts * tb) * dst) + _round16(4 * verts * seq))


def _dw_bf16_tail(rows, verts) -> int:
    """Bytes after the two stages (csrc's ``tail_ints``): the offsets of
    four items and the source rows and vertices of two."""
    return 4 * (16 + _cdiv(2 * (rows + verts), 4) * 4)


def _dw_bf16_units(seq, c_in, c_out) -> tuple:
    """``(fn, positions, upw, warps)``: the most positions a block whose
    units fit in at most 8 warps, each warp at most 16 fragments; among
    those the fewest idle unit slots, then the most warps."""
    fn = next(f for f in _DW_BF16_FN if 8 * f >= c_out)
    fm = _cdiv(c_in, 16)
    for p in (d for d in range(seq, 0, -1) if seq % d == 0):
        units = p * fm
        best = None
        for upw in range(1, min(_DW_BF16_MAX_UPW,
                                _DW_BF16_MAX_FRAGS // fn) + 1):
            warps = _cdiv(units, upw)
            key = (warps * upw - units, -warps)
            if warps <= _DW_BF16_MAX_WARPS and (best is None
                                                or key < best[0]):
                best = (key, upw, warps)
        if best is not None:
            return fn, p, best[1], best[2]
    raise ValueError(f"no K2-dW-bf16 warp layout for C_in={c_in}, "
                     f"C_out={c_out}")


def dw_bf16_plan(m, b, seq, c_in, c_out, n_tiles, rows, verts, tb,
                 per_sm, bgroups=None, x_aligned=True,
                 dy_aligned=True) -> DwBf16Plan:
    """A K2-dW-bf16 launch with batch tiles of ``tb`` rows (even tiles)
    and runs of whole tiles, as many as ``per_sm`` blocks an SM hold over
    the position groups (at most one run an SM); the batch tiles split
    into ``bgroups`` runs (default: as many as make two blocks an SM in
    all while the chunks' partials stay within ``_DW_BF16_PART_BYTES``).
    Its shared memory may exceed what the card offers: the caller
    checks."""
    fn, p, upw, warps = _dw_bf16_units(seq, c_in, c_out)
    tb = min(b, tb)
    tb = _cdiv(b, _cdiv(b, tb))
    n_bt = _cdiv(b, tb)
    groups = seq // p
    n_tg = min(n_tiles, max(1, _SMS * per_sm // groups), _SMS)
    tpc = _cdiv(n_tiles, n_tg)
    n_tg = _cdiv(n_tiles, tpc)
    if bgroups is None:
        bgroups = min(n_bt, max(1, 2 * _SMS // (n_tg * groups)))
        while (bgroups > 1 and n_tg * bgroups * seq * c_in * c_out * 4
               > _DW_BF16_PART_BYTES):
            bgroups -= 1
    bpc = _cdiv(n_bt, bgroups)
    return DwBf16Plan(
        fn=fn, upw=upw, warps=warps, positions=p, groups=groups, tb=tb,
        n_btiles=n_bt, tpc=tpc, bpc=bpc, n_chunks=n_tg * _cdiv(n_bt, bpc),
        rows=rows, verts=verts, vec_x=c_in % 8 == 0 and x_aligned,
        vec_d=c_out % 8 == 0 and dy_aligned,
        smem=_round16(2 * _dw_bf16_stage(seq, c_in, c_out, rows, verts, tb)
                      + _dw_bf16_tail(rows, verts)))


@functools.lru_cache(maxsize=1024)
def plan_spiral_conv_dw_bf16(m: int, b: int, seq: int, c_in: int,
                             c_out: int, n_tiles: int, tile_rows: int,
                             tile_verts: int, x_aligned: bool = True,
                             dy_aligned: bool = True) -> DwBf16Plan:
    """The K2-dW-bf16 launch for ``dW [seq, c_in, c_out]`` over ``m``
    vertices of ``b`` batch rows in the op's ``n_tiles`` vertex tiles of
    at most ``tile_rows`` source rows and ``tile_verts`` vertices;
    ``x_aligned``/``dy_aligned``: whether x and dy start on 16 bytes.
    The most batch rows an item (16, 8, 4, 2 or 1) whose two stages let
    two blocks share an SM, else one block an SM; chunks as
    ``dw_bf16_plan`` cuts them. Raises for channels beyond 128 or a tile
    that does not fit."""
    if min(m, b, seq, c_in, c_out, n_tiles, tile_rows, tile_verts) < 1:
        raise ValueError(f"spiral conv dW needs M, B, L, C_in, C_out and "
                         f"tiles ≥ 1; got {m}, {b}, {seq}, {c_in}, {c_out}, "
                         f"{n_tiles}")
    if max(c_in, c_out) > 128:
        raise ValueError(f"C_in {c_in} and C_out {c_out} must be ≤ 128 for "
                         "the bf16 kernel")
    for per_sm in (_DW_BF16_PER_SM, 1):
        cap = min(_SMEM_BLOCK, _SMEM_SM // per_sm - _SMEM_RESERVED)
        for tb in (16, 8, 4, 2, 1):
            plan = dw_bf16_plan(m, b, seq, c_in, c_out, n_tiles, tile_rows,
                                tile_verts, tb, per_sm, x_aligned=x_aligned,
                                dy_aligned=dy_aligned)
            if plan.smem <= cap:
                return plan
    raise ValueError(f"no K2-dW-bf16 stage of C_in={c_in}, C_out={c_out}, "
                     f"{tile_rows} rows fits in shared memory")


def spiral_conv_dw(x: torch.Tensor, table: torch.Tensor,
                   dy: torch.Tensor, plan: DwPlan | DwBf16Plan | None = None,
                   tiles=None) -> torch.Tensor:
    """K2-dW: ``dW[l] = Σ_{m,b} x[table[m, l], b]ᵀ dy[m, b]`` for
    ``x [N_src, B, C_in]``, ``table [M, L]``, ``dy [M, B, C_out]``;
    returns ``[L, C_in, C_out]``. Deterministic: fixed chunks summed in a
    fixed order through a scratch buffer allocated here. ``plan`` defaults
    to ``plan_spiral_conv_dw``'s; the kernel rejects one it cannot run.
    bf16 x and dy: K2-dW-bf16 (``plan_spiral_conv_dw_bf16``) through the
    op's vertex tiles ``tiles`` (``ops.SpiralTiles``, required), fp32 sums
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
        if tiles is None:
            raise ValueError("K2-dW-bf16 needs the op's tiles")
        if plan is None:
            plan = plan_spiral_conv_dw_bf16(
                m, bsz, seq, c_in, c_out, tiles.n_tiles, tiles.max_rows,
                tiles.max_verts, x.data_ptr() % 16 == 0,
                dy.data_ptr() % 16 == 0)
        if not isinstance(plan, DwBf16Plan):
            raise ValueError("bf16 x needs a DwBf16Plan")
        ptrs = _tile_ptrs(tiles, table.shape, dev, "K2-dW-bf16", plan.rows,
                          plan.verts)
        _fits_int32(plan.n_chunks * seq * c_in * c_out)
        part = torch.empty(plan.n_chunks * seq * c_in * c_out,
                           dtype=torch.float32, device=dev)
        fields = plan.as_ints()
        _launch("spiral_conv_dw_bf16", library().cfs_spiral_conv_dw_bf16,
                dev, _ptr(x), *ptrs, _ptr(dy), _ptr(part), _ptr(out), m,
                seq, bsz, c_in, c_out, tiles.n_tiles,
                (ctypes.c_int * len(fields))(*fields))
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


# K2-dx planner constants (csrc/spiral_conv_dx.cu checks every plan)
_DX_ROWS = 64                 # product rows a block: vertices x batch rows
_DX_DEPTH = 128               # a position chunk's depth, P·C_out, at most
#                               (one position where C_out is wider)
_DX_DEPTH_BF16 = 288          # the same in bf16: all nine positions of a
#                               32-wide conv, one chunk a tile
_DX_MAX_DEPTH = 1024          # a chunk's depth kc, at most (C_out too)


_DX_RESIDENT_SMEM = 110 * 1024   # a block's shared memory with every
#                                  chunk's Wᵀ staged once, at most
_DX_BLOCKS_PER_SM = 3         # its launch bounds (80 registers a thread)


@dataclass(frozen=True)
class DxPlan:
    """One K2-dx launch: a block owns ``tv`` vertices times ``tb`` batch
    rows at a time and ``8·nf`` columns of dx; grid (``grid[0]`` blocks
    over the vertex tiles, batch slices, ``zc`` column blocks). Positions
    go ``positions`` at a time, a chunk ``kc`` deep (``positions ·
    C_out`` rounded up to 16), ``du``'s rows ``lda`` elements apart in
    shared memory and Wᵀ's ``ldw``. ``resident``: every chunk's Wᵀ is
    staged once, and each block walks the tiles ``blockIdx.x``,
    ``blockIdx.x + grid[0]``, …; else a block a tile, each chunk's Wᵀ
    staged with it."""
    tb: int
    tv: int
    positions: int
    kc: int
    lda: int
    nf: int
    zc: int
    smem: int
    ldw: int
    resident: bool
    grid: tuple
    threads: int = 256

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]

    def as_ints(self) -> tuple:
        """The plan as csrc/spiral_conv_dx.cu's DxField array."""
        return (self.tb, self.tv, self.positions, self.kc, self.lda,
                self.nf, self.zc, self.smem, self.ldw, int(self.resident),
                self.grid[0])


@functools.lru_cache(maxsize=1024)
def plan_spiral_conv_dx(n_src: int, b: int, seq: int, c_in: int,
                        c_out: int, bf16: bool = False) -> DxPlan:
    """The K2-dx launch for ``dx [n_src, B, C_in]`` from ``dy [M, B,
    C_out]`` over ``seq`` positions: the batch rows of a block's vertices
    (all B up to 64), as many vertices as fill 64 rows, the fewest
    8-column fragments that cover C_in (64 columns a block at most),
    fewer where the grid would not fill the SMs twice; the fewest chunks
    whose depth stays within 128 (bf16: 288), the positions spread evenly
    over them;
    Wᵀ resident where every chunk's fits in ``_DX_RESIDENT_SMEM`` with
    the rest, the blocks then as many as the SMs hold at once. Raises for
    a shape that does not fit."""
    if min(n_src, b, seq, c_in, c_out) < 1:
        raise ValueError(f"spiral conv dx needs n_src, B, L, C_in, C_out ≥ "
                         f"1; got {n_src}, {b}, {seq}, {c_in}, {c_out}")
    tb = min(b, _DX_ROWS)
    tv = _DX_ROWS // tb
    n_tiles = _cdiv(n_src, tv)
    nf = next(f for f in (1, 2, 4, 8) if 8 * f >= min(c_in, 64))
    # a small level's few tiles: narrower column blocks, more of them
    # (each gathers the tile's du again), until the grid fills the SMs
    # twice over
    while nf > 1 and n_tiles * _cdiv(b, tb) * _cdiv(c_in, 8 * nf) \
            < 2 * _SMS:
        nf //= 2
    zc = _cdiv(c_in, 8 * nf)
    depth = _DX_DEPTH_BF16 if bf16 else _DX_DEPTH
    chunks = _cdiv(seq, max(1, min(seq, depth // c_out)))
    positions = _cdiv(seq, chunks)
    kc = _cdiv(positions * c_out, 16) * 16
    pad = 8 if bf16 else 4
    lda = kc + pad

    def smem_of(ldw):
        return ((2 * (_DX_ROWS * lda + 8 * nf * ldw) if bf16
                 else 4 * (_DX_ROWS * lda + 16 * nf * ldw))
                + 12 * tv * seq)

    ldw = -(-seq // positions) * kc + pad
    smem = smem_of(ldw)
    resident = smem <= _DX_RESIDENT_SMEM
    if resident:
        per_sm = min(_DX_BLOCKS_PER_SM,
                     _SMEM_SM // (smem + _SMEM_RESERVED))
        grid_x = min(n_tiles, _SMS * per_sm)
    else:
        ldw, grid_x = lda, n_tiles
        smem = smem_of(ldw)
    if smem > _SMEM_BLOCK or kc > _DX_MAX_DEPTH:
        raise ValueError(f"no K2-dx chunk of C_out={c_out} fits: depth "
                         f"{kc} (at most {_DX_MAX_DEPTH}), {smem} B of "
                         "shared memory")
    return DxPlan(tb=tb, tv=tv, positions=positions, kc=kc, lda=lda, nf=nf,
                  zc=zc, smem=smem, ldw=ldw, resident=resident,
                  grid=(grid_x, _cdiv(b, tb), zc))


def spiral_conv_dx(dy: torch.Tensor, w_l: torch.Tensor, ptr: torch.Tensor,
                   idx: torch.Tensor, n_src: int,
                   plan: DxPlan | None = None) -> torch.Tensor:
    """K2-dx: ``dx[v] = Σ_l du_l[v] @ W_lᵀ`` with ``du_l[v]`` the sum of
    ``dy``'s rows in the list of ``(v, l)`` (``ops.SpiralDx``: ``ptr
    [n_src·L + 1]``, ``idx``, −1 for ``0 · dy[0]``), for ``dy [M, B,
    C_out]`` and ``w_l [L, C_in, C_out]``; returns ``[n_src, B, C_in]`` in
    dy's dtype, every row written (0 where no list reaches it). bf16 dy
    and w_l: K2-dx-bf16, ``du`` rounded to bf16 once, ``dx`` once.
    ``plan`` defaults to ``plan_spiral_conv_dx``'s."""
    dev = dy.device
    dtype = _rows_dtype(dy)
    _require(dy, "dy", dtype, 3, dev)
    _require(w_l, "w_l", dtype, 3, dev)
    _require(ptr, "ptr", torch.int32, 1, dev)
    _require(idx, "idx", torch.int32, 1, dev)
    m, bsz, c_out = dy.shape
    seq, c_in = w_l.shape[0], w_l.shape[1]
    if w_l.shape[2] != c_out or ptr.shape[0] != n_src * seq + 1:
        raise ValueError(f"dy {tuple(dy.shape)}, w_l {tuple(w_l.shape)} and "
                         f"the lists of {ptr.shape[0]} offsets do not fit "
                         f"{n_src} source rows")
    _fits_int32(m * bsz * c_out, n_src * bsz * c_in, n_src * seq + 1,
                idx.numel())
    out = torch.empty((n_src, bsz, c_in), dtype=dtype, device=dev)
    if out.numel() == 0:
        return out
    if m == 0 or c_out == 0 or seq == 0:
        return out.zero_()
    bf16 = dtype == torch.bfloat16
    if plan is None:
        plan = plan_spiral_conv_dx(n_src, bsz, seq, c_in, c_out, bf16)
    fields = plan.as_ints()
    _launch("spiral_conv_dx_bf16" if bf16 else "spiral_conv_dx",
            library().cfs_spiral_conv_dx, dev, _ptr(dy), _ptr(w_l),
            _ptr(ptr), _ptr(idx) if idx.numel() else _ptr(ptr), _ptr(out),
            n_src, m, seq, bsz, c_in, c_out, int(bf16),
            (ctypes.c_int * len(fields))(*fields))
    return out


_OUT_GATHER_MAX_O = 8           # csrc/out_gather_sum.cu's kMaxO
_OUT_GATHER_BWD_SMEM = 100 * 1024   # most shared memory a block stages
_OUT_GATHER_BWD_REGS = 64       # registers a thread, rounded up (ptxas)


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


def out_gather_bwd_plan(runs, bsz: int, o: int) -> tuple:
    """``(Bs, smem, threads)`` of K3b's backward: the batch rows a block
    stages (the whole batch unless the largest run's rows would take more
    than ``_OUT_GATHER_BWD_SMEM`` bytes; then as few equal slices as fit,
    at least one row, cut to a multiple of 4 where B is one, so that
    threads keep four batch rows each), the bytes of shared memory a block
    takes, and its threads: where the grid fits one wave (each SM holding
    its share of the blocks in shared memory), as many as the registers
    allow at that share, else 128; 128 to 512."""
    lists = 4 * (runs.max_blob + _cdiv(runs.max_rows, 4) * 4)
    row = 4 * runs.max_rows * o
    fit = max(1, (_OUT_GATHER_BWD_SMEM - lists) // max(row, 1))
    slices = _cdiv(bsz, min(bsz, fit))
    bs = _cdiv(bsz, slices)
    if bs < bsz and bsz % 4 == 0 and bs >= 4:
        bs -= bs % 4
    smem = lists + row * bs
    share = _cdiv(runs.n_runs * _cdiv(bsz, bs), _SMS)
    warps = 4
    if share <= _SMEM_SM // (smem + _SMEM_RESERVED):
        warps = min(16, max(4, 2048 // (_OUT_GATHER_BWD_REGS * share)))
    return bs, smem, 32 * warps


def out_gather_sum_bwd(dout: torch.Tensor, bwd,
                       threads: int | None = None) -> torch.Tensor:
    """K3b's backward in one launch: for each position ``l`` of ``bwd``
    (an ``ops.OutGatherBwd``, every position's capped transpose over the
    N source rows), ``du[l] = transpose_l.apply(dout)`` in
    ``CappedEll.apply``'s order and roundings (``dout`` itself at the
    identity position), for ``dout [M, B, O]`` float32 (O ≤ 8); returns
    ``du`` in ``u``'s layout, ``[L, O, N, B]``. The kernel reads the
    transposes' runs (``bwd.runs``), one block a run and batch slice
    (``out_gather_bwd_plan``; ``threads`` in place of the plan's)."""
    dev = dout.device
    runs = bwd.runs
    _require(dout, "dout", torch.float32, 3, dev)
    for name in ("starts", "rows", "row_off", "blob", "blob_off", "pos"):
        _require(getattr(runs, name), name, torch.int32,
                 2 if name == "pos" else 1, dev)
    m, bsz, o = dout.shape
    seq, n = runs.pos.shape[0], bwd.n_src
    if (m != bwd.m or runs.pos.shape[1] != 4 or seq != bwd.info.shape[0]
            or runs.n_src != n):
        raise ValueError(f"dout {tuple(dout.shape)} does not fit the "
                         f"backward table of {bwd.m} rows, or the runs "
                         "are not that table's")
    if o > _OUT_GATHER_MAX_O:
        raise ValueError(f"out_gather_sum_bwd takes at most "
                         f"{_OUT_GATHER_MAX_O} outputs; got {o}")
    if threads is not None and (threads % 32 or not 32 <= threads <= 512):
        raise ValueError(f"threads must be a multiple of 32 up to 512; got "
                         f"{threads}")
    if runs.blob.data_ptr() % 16:
        raise ValueError("the runs' blob must lie on 16 bytes")
    _fits_int32(seq * o * n * bsz, m * bsz * o)
    du = torch.empty((seq, o, n, bsz), dtype=torch.float32, device=dev)
    if du.numel() == 0:
        return du
    if m == 0:
        raise ValueError("out_gather_sum_bwd needs cotangent rows")
    bs, smem, plan_threads = out_gather_bwd_plan(runs, bsz, o)
    if smem > _SMEM_BLOCK:
        raise ValueError(f"a run's lists and one batch row of its staged "
                         f"rows take {smem} bytes of shared memory")
    _launch("out_gather_sum_bwd", library().cfs_out_gather_sum_bwd, dev,
            _ptr(dout), _ptr(runs.starts), _ptr(runs.rows),
            _ptr(runs.row_off), _ptr(runs.blob), _ptr(runs.blob_off),
            _ptr(runs.pos), _ptr(du), runs.n_runs, m, n, seq, bsz, o, bs,
            threads or plan_threads, smem, int(dout.data_ptr() % 16 == 0))
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


# K8's launch geometry (csrc/distances.cu)
_K8_TILE_ROWS = 192           # rows a warp holds (6 a lane)
_K8_WARPS = 8                 # warps (row tiles) a block
_K8_MAX_COLS = 1024           # columns a block holds in shared memory
_K8_MAX_BINS = 512            # query points a backward block owns


def k8_plan(batch: int, nx: int, ny: int) -> tuple:
    """K8's forward tiling: ``(cols_per_block, tiles_per_group)``. Rows
    go in tiles of 192 (a warp's), spread evenly over the fewest groups
    of at most 8 (a block's warps); columns in ranges of a multiple of
    32, at most 1,024. The range is the one whose grid takes the fewest
    instruction slots on the busiest SM: waves of two blocks a streaming
    multiprocessor, each block's warps about 1,400 instructions a
    32-column chunk plus 500 to load and resolve their rows. At the fit's
    16 restarts of 4,097 rows against 8,192 columns: 768 columns, groups
    of 8 tiles, 528 blocks; at one restart 96 columns, 258 blocks."""
    tiles = -(-nx // _K8_TILE_ROWS)
    groups = -(-tiles // _K8_WARPS)
    best = None
    for cols in range(32, _K8_MAX_COLS + 1, 32):
        splits = -(-ny // cols)
        if splits > 65535:
            continue
        waves = -(-batch * groups * splits // (2 * _SMS))
        cost = waves * (cols // 32 * 1400 + 500)
        if best is None or cost < best[0]:
            best = (cost, cols)
    if best is None:
        raise ValueError(f"{ny} columns need more than 65,535 ranges of "
                         f"{_K8_MAX_COLS}")
    return best[1], -(-tiles // groups)


def k8_bwd_bins(batch: int, nq: int) -> int:
    """The query points each block of K8's backward owns (at most 512,
    what its shared counters hold): enough blocks for two a streaming
    multiprocessor over the batch, and more where ``nq`` needs them."""
    blocks = max(-(-nq // _K8_MAX_BINS), min(nq, -(-2 * _SMS // batch)))
    return -(-nq // blocks)


def _k8_fwd(x: torch.Tensor, y: torch.Tensor, mu: torch.Tensor,
            both: bool) -> tuple:
    dev = x.device
    rx, nx, x_stride = _cloud(x, "x", dev)
    ry, ny, y_stride = _cloud(y, "y", dev)
    _require(mu, "mu", torch.float32, 1, dev)
    if mu.shape[0] != 3:
        raise ValueError(f"mu must be [3]; got {tuple(mu.shape)}")
    batch = _batch_of(rx, ry)
    if nx < 1 or ny < 1:
        raise ValueError("both clouds need at least one point")
    _fits_int32(batch * nx * 3, batch * ny * 3)
    cols, tiles_per_group = k8_plan(batch, nx, ny)
    row_groups = -(-nx // (_K8_TILE_ROWS * tiles_per_group))
    n_row = batch * -(-ny // cols) * nx     # a key a row and column range
    n_col = batch * row_groups * ny if both else 0   # a column, row group
    part = torch.empty(n_row + n_col, dtype=torch.int64, device=dev)
    d_x = torch.empty((batch, nx), dtype=torch.float32, device=dev)
    a = torch.empty((batch, nx), dtype=torch.int32, device=dev)
    none = ctypes.c_void_p(None)
    if both:
        d_y = torch.empty((batch, ny), dtype=torch.float32, device=dev)
        b = torch.empty((batch, ny), dtype=torch.int32, device=dev)
        col_args = (ctypes.c_void_p(part.data_ptr() + 8 * n_row), _ptr(d_y),
                    _ptr(b))
    else:
        col_args = (none, none, none)
    _launch("k8_fwd", library().cfs_nearest_sq, dev, _ptr(x), x_stride, nx,
            _ptr(y), y_stride, ny, _ptr(mu), batch, cols, tiles_per_group,
            _ptr(part), col_args[0], _ptr(d_x), _ptr(a), col_args[1],
            col_args[2])
    return (d_x, d_y, a, b) if both else (d_x, a)


def nearest_sq_sym(x: torch.Tensor, y: torch.Tensor,
                   mu: torch.Tensor) -> tuple:
    """K8 forward (``csrc/distances.cu``, counted as ``k8_fwd``: the pair
    pass and its reduction, two CUDA launches): one pass over the pairs of
    ``x`` ([nx, 3] or [R, nx, 3]) and ``y`` ([ny, 3] or [R, ny, 3]), both
    centred on ``mu [3]``, reduced along both axes. Each pair is ``‖u‖² +
    ‖v‖² − 2u·v`` (an add and three FMAs); each minimum is clamped at 0
    and its argmin is the lowest index reaching it. Returns ``(d_x [R,
    nx], d_y [R, ny], a [R, nx], b [R, ny])`` (f32, f32, i32, i32; R = 1
    when neither cloud is batched)."""
    return _k8_fwd(x, y, mu, True)


def nearest_sq(query: torch.Tensor, ref: torch.Tensor,
               mu: torch.Tensor) -> tuple:
    """K8 forward in one direction (the same kernel with the column
    reduction off, counted as ``k8_fwd``): for each point of ``query``
    ([nq, 3] or [R, nq, 3]), its squared distance to the nearest point of
    ``ref`` after both are centred on ``mu``, and the lowest index reaching
    it. Returns ``(d [R, nq] f32, idx [R, nq] i32)``."""
    return _k8_fwd(query, ref, mu, False)


def nearest_sq_bwd(query: torch.Tensor, ref: torch.Tensor, mu: torch.Tensor,
                   g_u: torch.Tensor, d_u: torch.Tensor, idx_u: torch.Tensor,
                   g_v: torch.Tensor, d_v: torch.Tensor, idx_v: torch.Tensor,
                   csr: bool = False):
    """K8 backward (``csrc/distances.cu``, counted as ``k8_bwd``, one
    launch): the gradient in ``query`` of ``Σ g_u·d_u + Σ g_v·d_v``, where
    ``d_u, idx_u [R, nq]`` are the query side's distances and argmins and
    ``d_v, idx_v [R, nr]`` the other side's. The kernel builds the CSR of
    ``idx_v`` over the query points itself (a stable counting sort) and
    sums each point's own term, then its segment in increasing ``j``.
    Returns ``[R, nq, 3]`` f32; with ``csr``, also the CSR it walked,
    ``(perm [R, nr], offsets [R, nq + 1])`` int32, equal to
    ``ops.distances.argmin_csr(idx_v, nq)``. Each block owns at most 512
    query points; the grid takes at most 65,535 blocks a restart."""
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
                                 (idx_v, "idx_v", torch.int32, nr)):
        _require(t, name, dtype, 2, dev)
        if tuple(t.shape) != (batch, cols):
            raise ValueError(f"{name} must be {(batch, cols)}; got "
                             f"{tuple(t.shape)}")
    if mu.shape[0] != 3 or nq < 1 or nr < 1:
        raise ValueError("mu must be [3] and both clouds non-empty")
    bins = k8_bwd_bins(batch, nq)
    if -(-nq // bins) > 65535:
        raise ValueError(
            f"{nq} query points need {-(-nq // bins)} blocks of "
            f"{_K8_MAX_BINS} (the bins a block's shared memory holds); "
            "K8's backward takes at most 65,535 a restart")
    _fits_int32(batch * nq * 3, batch * nr * 4)
    out = torch.empty((batch, nq, 3), dtype=torch.float32, device=dev)
    terms = torch.empty((batch, nr, 4), dtype=torch.float32, device=dev)
    perm = off = None
    if csr:
        perm = torch.empty((batch, nr), dtype=torch.int32, device=dev)
        off = torch.empty((batch, nq + 1), dtype=torch.int32, device=dev)
    none = ctypes.c_void_p(None)
    _launch("k8_bwd", library().cfs_nearest_sq_bwd, dev, _ptr(query),
            q_stride, nq, _ptr(ref), r_stride, nr, _ptr(mu), batch,
            _ptr(g_u), _ptr(d_u), _ptr(idx_u), _ptr(g_v), _ptr(d_v),
            _ptr(idx_v), bins, _ptr(terms),
            _ptr(perm) if csr else none, _ptr(off) if csr else none,
            _ptr(out))
    return (out, perm, off) if csr else out


def _sinkhorn_clouds(x: torch.Tensor, y: torch.Tensor) -> tuple:
    dev = x.device
    _require(x, "x", torch.float32, 2, dev)
    _require(y, "y", torch.float32, 2, dev)
    if x.shape[1] != 3 or y.shape[1] != 3 or min(x.shape[0],
                                                  y.shape[0]) < 1:
        raise ValueError(f"x and y must be [P, 3] and [Q, 3] with P, Q ≥ 1; "
                         f"got {tuple(x.shape)} and {tuple(y.shape)}")
    _fits_int32(3 * x.shape[0], 3 * y.shape[0])
    return dev, x.shape[0], y.shape[0]


def sinkhorn_fwd(x: torch.Tensor, y: torch.Tensor, epsilon: float,
                 n_iters: int) -> tuple:
    """K8-sinkhorn's forward: ``(out [], f_hist [n_iters + 1, P], g_hist
    [n_iters + 1, Q])`` for the clouds ``x [P, 3]``, ``y [Q, 3]`` (fp32):
    ``n_iters`` row-LSE passes of f and of g from zeros, each iteration's
    potentials kept (row 0 the zeros), then ``Σ coupling · cost`` by rows
    and one fixed-order sum (``csrc/sinkhorn.cu``; one wrapper call, 2
    n_iters + 2 launches)."""
    dev, p, q = _sinkhorn_clouds(x, y)
    if not epsilon > 0 or n_iters < 0:
        raise ValueError(f"epsilon must be > 0 and n_iters ≥ 0; got "
                         f"{epsilon}, {n_iters}")
    f_hist = torch.empty((n_iters + 1, p), dtype=torch.float32, device=dev)
    g_hist = torch.empty((n_iters + 1, q), dtype=torch.float32, device=dev)
    part = torch.empty(p, dtype=torch.float32, device=dev)
    out = torch.empty((), dtype=torch.float32, device=dev)
    _launch("sinkhorn_fwd", library().cfs_sinkhorn_fwd, dev, _ptr(x),
            _ptr(y), p, q, ctypes.c_float(epsilon), n_iters, _ptr(f_hist),
            _ptr(g_hist), _ptr(part), _ptr(out))
    return out, f_hist, g_hist


def sinkhorn_bwd(x: torch.Tensor, y: torch.Tensor, epsilon: float,
                 n_iters: int, f_hist: torch.Tensor, g_hist: torch.Tensor,
                 grad: torch.Tensor) -> tuple:
    """K8-sinkhorn's backward: ``(x̄ [P, 3], ȳ [Q, 3])`` for the output's
    cotangent ``grad`` (a one-element fp32 tensor on the card), from the
    forward's potentials: the output's own term, then the reverse sweep,
    a row pass over x and a column pass over y an iteration
    (``csrc/sinkhorn.cu``; one wrapper call, 2 n_iters + 2 launches)."""
    dev, p, q = _sinkhorn_clouds(x, y)
    _require(f_hist, "f_hist", torch.float32, 2, dev)
    _require(g_hist, "g_hist", torch.float32, 2, dev)
    if (f_hist.shape != (n_iters + 1, p) or g_hist.shape != (n_iters + 1, q)
            or grad.numel() != 1 or grad.dtype != torch.float32
            or grad.device != dev):
        raise ValueError("the potentials or the cotangent do not fit the "
                         "clouds and n_iters")
    grad = grad.reshape(1).contiguous()
    fbar = torch.empty(p, dtype=torch.float32, device=dev)
    gbar = torch.empty((2, q), dtype=torch.float32, device=dev)
    xbar = torch.empty((p, 3), dtype=torch.float32, device=dev)
    ybar = torch.empty((q, 3), dtype=torch.float32, device=dev)
    _launch("sinkhorn_bwd", library().cfs_sinkhorn_bwd, dev, _ptr(x),
            _ptr(y), p, q, ctypes.c_float(epsilon), n_iters, _ptr(f_hist),
            _ptr(g_hist), _ptr(grad), _ptr(fbar), _ptr(gbar), _ptr(xbar),
            _ptr(ybar))
    return xbar, ybar


_CHEBY_MAX_K = 32               # csrc/cheby_step.cu kMaxK
_CHEBY_MAX_VERTS = 64           # csrc/cheby_step.cu kMaxVerts


def _require_rows(t: torch.Tensor, name: str, device: torch.device) -> None:
    """An fp32 ``[N, D]`` panel on ``device`` whose rows are contiguous
    and do not overlap: a row stride of at least D floats."""
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{name} must be a CUDA tensor on {device}; "
                         f"got {t.device}")
    if t.dtype != torch.float32 or t.dim() != 2:
        raise ValueError(f"{name} must be a 2-D torch.float32 panel; got "
                         f"{t.dtype} {tuple(t.shape)}")
    if t.shape[1] > 1 and t.stride(1) != 1 or (
            t.shape[0] > 1 and t.stride(0) < t.shape[1]):
        raise ValueError(f"{name} must have contiguous rows at a stride of "
                         f"at least {t.shape[1]}; got strides {t.stride()}")


def cheby_step(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor,
               c: torch.Tensor, a: float, b: float = 0.0,
               p: torch.Tensor | None = None, tiles=None) -> torch.Tensor:
    """K9 (``csrc/cheby_step.cu``): one step of the eigensolver's
    Chebyshev filter over the ELL Laplacian ``cols, vals [N, K]`` (K ≤ 32)
    and an ``[N, D]`` fp32 panel ``x``: ``out = a · (L x − c ⊙ x) − b · p``
    with ``c [D]`` per column, JAX's grouping, each operation rounded as
    the twin (``ops.eigh.cheby_step_plain``) rounds it. ``tiles`` are the
    table's vertex tiles (``ops.eigh.build_k9_tiles``), required: the
    kernel forms its sums through them (their ``table()`` is ``[cols |
    arange(N)]``) and reads ``cols`` for its shape alone, so tiles built
    from another table of that shape give other sums. ``x``
    may be a view whose rows lie at a stride ≥ D (``ops.eigh.panel``);
    ``p`` must have x's strides, and ``out`` gets them. ``b == 0`` leaves
    the ``b · p`` term out and ``p`` unread; otherwise ``p [N, D]`` is
    required. ``a`` and ``b`` are taken as float32. Returns ``[N, D]``."""
    dev = x.device
    _require_rows(x, "x", dev)
    _require(cols, "cols", torch.int32, 2, dev)
    _require(vals, "vals", torch.float32, 2, dev)
    _require(c, "c", torch.float32, 1, dev)
    (n, d), (m, k) = x.shape, cols.shape
    if vals.shape != cols.shape or m != n or c.shape[0] != d:
        raise ValueError(f"cols {tuple(cols.shape)}, vals "
                         f"{tuple(vals.shape)}, x {tuple(x.shape)} and c "
                         f"{tuple(c.shape)} do not hold a square operator "
                         "on the panel's rows and one c per column")
    if b != 0.0:
        if p is None:
            raise ValueError("b != 0 needs p")
        _require_rows(p, "p", dev)
        if p.shape != x.shape or p.stride() != x.stride():
            raise ValueError(f"p {tuple(p.shape)} at strides {p.stride()} "
                             f"differs from x {tuple(x.shape)} at "
                             f"{x.stride()}")
    if not 1 <= k <= _CHEBY_MAX_K or n < 1 or d < 1:
        raise ValueError(f"K = {k} entries a row (1 to {_CHEBY_MAX_K}) on "
                         f"a non-empty [{n}, {d}] panel")
    ld = x.stride(0) if n > 1 else d
    _fits_int32(n * (k + 1), ld, n)
    tile_ptrs = _tile_ptrs(tiles, (n, k + 1), dev,
                           "K9 (ops.eigh.build_k9_tiles)",
                           max_verts=_CHEBY_MAX_VERTS)
    if library().cfs_cheby_step_smem(tiles.max_rows, tiles.max_verts,
                                     k) == 0:
        raise ValueError(f"K9's tiles of {tiles.max_rows} rows and "
                         f"{tiles.max_verts} vertices overflow a block's "
                         "shared memory")
    out = torch.empty((n, ld), dtype=torch.float32, device=dev)[:, :d]
    _launch("cheby_step", library().cfs_cheby_step, dev, _ptr(vals),
            *tile_ptrs, tiles.n_tiles, tiles.max_rows, tiles.max_verts,
            _ptr(x), _ptr(c),
            _ptr(p) if b != 0.0 else ctypes.c_void_p(None), _ptr(out), n, k,
            d, ld, ctypes.c_float(a), ctypes.c_float(b))
    return out

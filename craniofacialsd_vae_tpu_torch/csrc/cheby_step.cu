// K9: one step of the Laplacian eigensolver's Chebyshev filter.
//
// Replaces craniofacialsd_vae_tpu/ops/eigh.py::_laplacian_matvec (an
// ell_matmul_raw over the ELL Laplacian D - A, an XLA gather + einsum on
// the TPU) together with the elementwise arithmetic around it in
// filter_pass and rayleigh_ritz (:144-152, 166, 171):
//
//   out[m, j] = a · ((Σ_k vals[m,k] · x[cols[m,k], j]) − c[j] · x[m, j])
//               − b · p[m, j]
//
// over an [N, D] fp32 panel (D = block = 1,125 at k = 1,000), one launch
// per filter step, no atomics. One kernel serves every call: the first
// filter step (b = 0, c[j] = c), the filter body, w = L q (a = 1, c = 0,
// b = 0) and the residual L v − v θ (a = 1, c[j] = θ_j, b = 0). With b = 0
// the kernel does not read p.
//
// Rounding: the ELL sum runs over k ascending, padded entries included
// (row 0, weight 0), each product and sum rounded (__fmul_rn, __fadd_rn),
// then c·x, the difference, the scale, b·p and the last difference, each
// rounded: JAX's grouping, and the plain twin's (ops/eigh.py::
// cheby_step_plain) operation for operation, so the two agree bit for bit
// on the card.
//
// What bounds it on an H100: bytes. A step does 2·K + 5 flops per output
// and must read x once, p once (b ≠ 0), the table once and write out once:
// at N = 16,386, D = 1,125 that is 221 MB, 0.066 ms at 3.35 TB/s, against
// 0.006 ms of fp32 issue. Each source row is read by about 7 output rows
// (K = 7 with the diagonal), and the octasphere's vertex order has no
// locality, so gathering rows straight from global memory moves 7 panels
// through L2 a step; and a stream of rows cut into narrow column slices
// at a stride that is not a multiple of 16 bytes reaches well under the
// card's rate even with no gather (PERF.md: the diagonal-only floor).
//
// So the rows come in vertex tiles (ops/eigh.py::build_k9_tiles,
// Morton-ordered runs of the template's vertices): a tile owns at most
// kMaxVerts = 64 output rows and stages the sorted distinct rows they
// read (their ELL columns and themselves: about 1.8 rows a vertex on the
// octasphere, at most 128). One block takes one (tile, 128-column slice),
// the slices of a tile side by side in the grid, so the blocks in flight
// read whole rows (whole DRAM pages), and a halo row that a neighbouring
// tile stages too comes from L2 where the two tiles run close in time
// (Morton order keeps most neighbours close). A block first loads its tile's
// staged-row and vertex indices into shared memory (one round trip, so
// that no copy waits on an index load), then copies the rows' slice
// into shared memory once with cp.async (16 bytes where the row stride
// is a multiple of 4 floats and the panels are 16-byte aligned, as the
// solver's padded panels are: ops/eigh.py::panel; else 4 bytes), with
// the tile's local indices and values, and loads its p into registers
// with streaming loads while the copies fly. Then each warp forms its
// rows' sums from shared memory (lane l holds columns 4l to 4l + 3 as a
// float4 on the vector path, l + 32 t otherwise) and writes out with
// streaming stores.

#include <cuda_runtime.h>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kSlice = 128;                // columns a block
constexpr int kCpl = kSlice / 32;          // columns a lane: one float4
constexpr int kMaxVerts = 64;              // output rows a tile: 32 p a lane
constexpr int kRowsPerWarp = kMaxVerts / kWarps;
constexpr int kMaxK = 32;
constexpr int kSmemLimit = 227 * 1024;

struct Cols {
  float v[kCpl];
};

// a lane's t-th column of a slice row: kCpl side by side on the vector
// path (one 16-byte access), 32 apart on the scalar one
template <bool VEC>
__device__ __forceinline__ int col_of(int lane, int t) {
  return VEC ? kCpl * lane + t : lane + 32 * t;
}

template <bool VEC>
__device__ __forceinline__ Cols lds(const float* row, int lane) {
  Cols r;
  if constexpr (VEC) {
    const float4 v = *reinterpret_cast<const float4*>(row + 4 * lane);
    r.v[0] = v.x, r.v[1] = v.y, r.v[2] = v.z, r.v[3] = v.w;
  } else {
#pragma unroll
    for (int t = 0; t < kCpl; ++t) r.v[t] = row[col_of<VEC>(lane, t)];
  }
  return r;
}

// p's values of this lane in a row slice (streaming: read once)
template <bool VEC>
__device__ __forceinline__ Cols ldg_stream(const float* row, int lane,
                                           int width) {
  Cols r;
  const bool whole = col_of<VEC>(lane, kCpl - 1) < width;
  if (VEC && whole) {
    const float4 v = __ldcs(reinterpret_cast<const float4*>(row + 4 * lane));
    r.v[0] = v.x, r.v[1] = v.y, r.v[2] = v.z, r.v[3] = v.w;
    return r;
  }
#pragma unroll
  for (int t = 0; t < kCpl; ++t) {
    const int j = col_of<VEC>(lane, t);
    r.v[t] = j < width ? __ldcs(row + j) : 0.f;
  }
  return r;
}

template <bool VEC>
__device__ __forceinline__ void stg_stream(float* row, int lane, int width,
                                           const Cols& r) {
  const bool whole = col_of<VEC>(lane, kCpl - 1) < width;
  if (VEC && whole) {
    __stcs(reinterpret_cast<float4*>(row + 4 * lane),
           make_float4(r.v[0], r.v[1], r.v[2], r.v[3]));
    return;
  }
#pragma unroll
  for (int t = 0; t < kCpl; ++t) {
    const int j = col_of<VEC>(lane, t);
    if (j < width) __stcs(row + j, r.v[t]);
  }
}

// KK: the ELL row length when compiled in (7), else 0 (K ≤ 32 at run
// time). local [N, K + 1] in tile order: a row's K entries, then the row
// itself, as indices into its tile's staged rows.
template <int KK, bool HAS_P, bool VEC>
__global__ void __launch_bounds__(kThreads, 3)
cheby_tile_kernel(const float* __restrict__ vals,
                  const int* __restrict__ verts,
                  const int* __restrict__ starts,
                  const int* __restrict__ src,
                  const int* __restrict__ src_off,
                  const int* __restrict__ local,
                  const float* __restrict__ x, const float* __restrict__ c,
                  const float* __restrict__ p, float* __restrict__ out,
                  int k_rt, int D, int ld, float a, float b) {
  const int K = KK ? KK : k_rt;
  const int K1 = K + 1;
  const int t = blockIdx.y;                   // the tile
  const int j0 = blockIdx.x * kSlice;         // its slice
  const int width = min(kSlice, D - j0);
  const int v0 = __ldg(starts + t), nv = __ldg(starts + t + 1) - v0;
  const int r0 = __ldg(src_off + t), nr = __ldg(src_off + t + 1) - r0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                                    // [nr][kSlice]
  int* s_local = reinterpret_cast<int*>(xs + nr * kSlice);  // [nv][K1]
  float* s_vals = reinterpret_cast<float*>(s_local + nv * K1);  // [nv][K]
  int* s_verts = reinterpret_cast<int*>(s_vals + nv * K);   // [nv]
  int* s_src = s_verts + nv;                                // [nr]

  // this lane's c; the tile's staged rows and its vertices, in one round
  // trip, so that no copy below waits on an index load
  Cols cv;
#pragma unroll
  for (int u = 0; u < kCpl; ++u) {
    const int j = col_of<VEC>(lane, u);
    cv.v[u] = j < width ? __ldg(c + j0 + j) : 0.f;
  }
  for (int e = threadIdx.x; e < nr; e += kThreads)
    s_src[e] = __ldg(src + r0 + e);
  for (int e = threadIdx.x; e < nv; e += kThreads)
    s_verts[e] = __ldg(verts + v0 + e);
  __syncthreads();

  // the staged rows' slice, the tile's local indices and values
  if (VEC) {
    constexpr int kChunks = kSlice / 4;
    for (int e = threadIdx.x; e < nr * kChunks; e += kThreads) {
      const int r = e / kChunks, j = 4 * (e % kChunks);
      if (j >= width) continue;
      const float* g = x + (size_t)s_src[r] * ld + j0 + j;
      float* s = xs + r * kSlice + j;
      if (j + 4 <= width) {
        cp_async16(s, g);
      } else {
        for (int u = 0; u < width - j; ++u) cp_async4(s + u, g + u);
      }
    }
  } else {
    for (int e = threadIdx.x; e < nr * kSlice; e += kThreads) {
      const int r = e / kSlice, j = e % kSlice;
      if (j < width)
        cp_async4(xs + r * kSlice + j, x + (size_t)s_src[r] * ld + j0 + j);
    }
  }
  for (int e = threadIdx.x; e < nv * K1; e += kThreads)
    cp_async4(s_local + e, local + (size_t)v0 * K1 + e);
  for (int e = threadIdx.x; e < nv * K; e += kThreads) {
    const int i = e / K, k = e - i * K;
    cp_async4(s_vals + e, vals + (size_t)s_verts[i] * K + k);
  }
  cp_async_commit();

  // while they fly: this warp's rows' p
  Cols pv[kRowsPerWarp];
#pragma unroll
  for (int q = 0; q < kRowsPerWarp; ++q) {
    const int i = warp + kWarps * q;
    if (HAS_P && i < nv)
      pv[q] = ldg_stream<VEC>(p + (size_t)s_verts[i] * ld + j0, lane, width);
  }
  cp_async_wait<0>();
  __syncthreads();

#pragma unroll
  for (int q = 0; q < kRowsPerWarp; ++q) {
    const int i = warp + kWarps * q;
    if (i >= nv) continue;
    const int* li = s_local + i * K1;
    const float* vi = s_vals + i * K;
    Cols acc{};
#pragma unroll
    for (int k = 0; k < (KK ? KK : kMaxK); ++k) {
      if (!KK && k >= K) break;
      const float w = vi[k];
      const Cols g = lds<VEC>(xs + li[k] * kSlice, lane);
#pragma unroll
      for (int u = 0; u < kCpl; ++u)
        acc.v[u] = k == 0 ? __fmul_rn(w, g.v[u])
                          : __fadd_rn(acc.v[u], __fmul_rn(w, g.v[u]));
    }
    const Cols xm = lds<VEC>(xs + li[K] * kSlice, lane);
    Cols r;
#pragma unroll
    for (int u = 0; u < kCpl; ++u) {
      r.v[u] = __fmul_rn(a, __fsub_rn(acc.v[u], __fmul_rn(cv.v[u], xm.v[u])));
      if (HAS_P) r.v[u] = __fsub_rn(r.v[u], __fmul_rn(b, pv[q].v[u]));
    }
    stg_stream<VEC>(out + (size_t)s_verts[i] * ld + j0, lane, width, r);
  }
}

// the largest dynamic shared memory an instance has been opted in to
template <int KK, bool HAS_P, bool VEC>
int& smem_done() {
  static int done = 0;
  return done;
}

template <int KK, bool HAS_P, bool VEC>
int launch(dim3 grid, int smem, cudaStream_t s, const float* vals,
           const int* verts, const int* starts, const int* src,
           const int* src_off, const int* local, const float* x,
           const float* c, const float* p, float* out, int K, int D, int ld,
           float a, float b) {
  auto* kern = cheby_tile_kernel<KK, HAS_P, VEC>;
  if (const int rc = set_smem(kern, smem, smem_done<KK, HAS_P, VEC>()))
    return rc;
  kern<<<grid, kThreads, smem, s>>>(vals, verts, starts, src, src_off, local,
                                    x, c, p, out, K, D, ld, a, b);
  return 0;
}

template <int KK>
int dispatch(dim3 grid, int smem, cudaStream_t s, bool vec,
             const float* vals, const int* verts, const int* starts,
             const int* src, const int* src_off, const int* local,
             const float* x, const float* c, const float* p, float* out,
             int K, int D, int ld, float a, float b) {
  if (p && vec)
    return launch<KK, true, true>(grid, smem, s, vals, verts, starts, src,
                                  src_off, local, x, c, p, out, K, D, ld, a,
                                  b);
  if (p)
    return launch<KK, true, false>(grid, smem, s, vals, verts, starts, src,
                                   src_off, local, x, c, p, out, K, D, ld,
                                   a, b);
  if (vec)
    return launch<KK, false, true>(grid, smem, s, vals, verts, starts, src,
                                   src_off, local, x, c, nullptr, out, K, D,
                                   ld, a, b);
  return launch<KK, false, false>(grid, smem, s, vals, verts, starts, src,
                                  src_off, local, x, c, nullptr, out, K, D,
                                  ld, a, b);
}

template <int KK, bool HAS_P, bool VEC>
int occupancy(int smem) {
  auto* kern = cheby_tile_kernel<KK, HAS_P, VEC>;
  int blocks = 0;
  if (set_smem(kern, smem, smem_done<KK, HAS_P, VEC>()) ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, kThreads,
                                                    smem) != cudaSuccess)
    return -1;
  return blocks;
}

}  // namespace

// Shared memory a block of K9 takes for tiles of at most `max_rows`
// staged rows and `max_verts` output rows, K entries a row; 0 where that
// is more than a block can have.
extern "C" int cfs_cheby_step_smem(int max_rows, int max_verts, int K) {
  if (max_verts > kMaxVerts) return 0;
  const long long bytes = 4LL * ((long long)max_rows * (kSlice + 1) +
                                 (long long)max_verts * (2 * K + 2));
  return bytes > kSmemLimit ? 0 : static_cast<int>(bytes);
}

// Blocks of K9 an SM holds at `smem` bytes (the runtime's occupancy
// calculator) for the K = 7 instance with (has_p) or without p, on the
// vector (vec) or scalar path; -1 on a CUDA error.
extern "C" int cfs_cheby_step_blocks_per_sm(int smem, int has_p, int vec) {
  if (has_p)
    return vec ? occupancy<7, true, true>(smem)
               : occupancy<7, true, false>(smem);
  return vec ? occupancy<7, false, true>(smem)
             : occupancy<7, false, false>(smem);
}

// K9: out [N, D] = a · (L x − c ⊙ x) − b · p over the ELL Laplacian's
// values vals [N, K] (K ≤ 32) in its vertex tiles (verts [N], starts and
// src_off [n_tiles + 1], src, local [N, K + 1]: ops/eigh.py::
// build_k9_tiles), c [D] per column; x, p and out have rows of D floats
// at a stride of ld ≥ D floats. p may be null, and then the b · p term is
// left out. Returns a cudaError_t.
extern "C" int cfs_cheby_step(const float* vals, const int* verts,
                              const int* starts, const int* src,
                              const int* src_off, const int* local,
                              int n_tiles, int max_rows, int max_verts,
                              const float* x, const float* c, const float* p,
                              float* out, int N, int K, int D, int ld,
                              float a, float b, void* stream) {
  const int smem = cfs_cheby_step_smem(max_rows, max_verts, K);
  if (N < 1 || K < 1 || K > kMaxK || D < 1 || ld < D || n_tiles < 1 ||
      max_verts < 1 || max_verts > kMaxVerts || max_rows < 1 || smem == 0 ||
      n_tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = ld % 4 == 0 && !misaligned(x) && !misaligned(out) &&
                   (!p || !misaligned(p));
  const dim3 grid((D + kSlice - 1) / kSlice, n_tiles);
  const int rc =
      K == 7 ? dispatch<7>(grid, smem, s, vec, vals, verts, starts, src,
                           src_off, local, x, c, p, out, K, D, ld, a, b)
             : dispatch<0>(grid, smem, s, vec, vals, verts, starts, src,
                           src_off, local, x, c, p, out, K, D, ld, a, b);
  if (rc) return rc;
  return static_cast<int>(cudaGetLastError());
}

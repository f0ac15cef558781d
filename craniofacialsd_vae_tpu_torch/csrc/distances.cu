// K8: the chamfer's nearest-neighbour distances and their gradient.
//
// Replaces craniofacialsd_vae_tpu/ops/distances.py::nearest_dists_sq_sym
// (an XLA op: per 4,096-column chunk, ‖x‖² + ‖y‖² − 2x·y at HIGHEST
// precision, min-reduced along both axes while the chunk is hot) and the
// gradient JAX's autodiff takes through it (the reduce_min and minimum
// JVPs, transposed).
//
// Both clouds are centred on mu = mean(y) (passed in; the JAX function
// centres them first too, so that the expansion's cancellation error
// scales with the cloud's size, not with its frame offset). All
// arithmetic is fp32 on the CUDA cores: K = 3 gives the tensor cores
// nothing to do, and TF32 would blur nearest-neighbour ties.
//
// cfs_nearest_sq (k8_fwd): for rows x [R, nx] (or one cloud shared by
// every restart: stride 0) against columns y, one pass over the pair
// matrix feeds both minima. Each pair's
//   d(i, j) = ‖ũ_i‖² + ‖ṽ_j‖² − 2ũ_i·ṽ_j
// is formed once, as an add and three FMAs (columns held as (−2ṽ, ‖ṽ‖²)),
// and reduced along the row (d_x[i], a[i]) and along the column (d_y[j],
// b[j]). Each argmin is the lowest index reaching its minimum, i.e. the
// lexicographic minimum of (d, index), which is the same whatever the
// order of the reduction; distances are clamped at 0 after it. With the
// column reduction off (one direction, `nearest_dists_sq`) only d_x and a
// are formed.
//
// What bounds it on an H100: operations (9 a pair: the FMAs as 6, the
// add, a compare per direction; the bytes are each point read once). On
// the card an SM sub-partition starts about one FP32 add or FMA a clock,
// an fminf at about half that rate (k8_parts: swapping the rows' fminf
// for adds speeds the kernel up), so a pair costs about 4 + 2 × 1.8
// instruction slots however it is arranged. The design:
// - Register micro-tile. A warp owns 192 rows, 6 a lane, held in
//   registers; the block's columns sit in shared memory and stream as
//   broadcasts, so one 16-byte load feeds 6 pairs. Six rows a lane was
//   the fastest of 2, 3, 4, 6, 8 and 16 (k8_parts): more rows amortise the
//   column scan below, fewer registers leave more warps to hide latency.
// - The index stays off the hot loop. Per row the loop keeps value-only
//   fminf minima of each group of 8 columns (even and odd columns apart:
//   shorter dependent chains); one compare a group records the group
//   where the row's minimum last dropped, and after the last chunk the
//   row's index is found by recomputing that one group (the same
//   instructions give the same bits; the group is read from a lane-rotated
//   start, so the lanes' reads hit different banks). Per column, each
//   lane takes a value-only min over its 6 rows and writes it into a
//   32 × 32 transpose in shared memory; after each 32-column chunk lane c
//   scans column c over the 32 lanes (the first lane reaching the minimum)
//   and recomputes that lane's 6 pairs, from a padded copy of the rows in
//   shared memory, to find the row.
// - The card is filled at one restart as at 16: the pair matrix is tiled
//   in 2-D across blocks, up to 8 row tiles (spread evenly over the row
//   groups, so that the blocks are alike) by a column range that
//   kernels.k8_plan chooses for whole waves of blocks. A block's partial
//   minima are 64-bit keys (orderable float bits, index), so a minimum of
//   keys is the lexicographic minimum and needs no order: the warps of a
//   block meet in a shared-memory atomicMin on each column's key, and a
//   second small launch takes the minimum of each row's (one key a column
//   range) and column's (one a row group) partial keys, a few MB at the
//   fit's shapes, mostly from L2. Chosen over global atomics: those need
//   the keys set first (another launch) and, a block a row, about two
//   million of them at the fit's shapes.
//
// cfs_nearest_sq_bwd (k8_bwd): with g_u, g_v the cotangents of d_u, d_v,
//   out[r, i] = 2·g_u[r,i]·[d_u>0]·(ũ_i − ṽ_{idx_u(i)})
//             + Σ_{j : idx_v(r,j) = i} 2·g_v[r,j]·[d_v>0]·(ũ_i − ṽ_j).
// The sum over j is a scatter; it is walked as a gather instead, through
// a CSR of idx_v (the j sorted stably by idx_v, and each i's segment)
// that the kernel builds itself, in one launch: each block owns up to 512
// query points (bins) of one restart and
// 1. counts, per warp, the entries of its contiguous slice of j that fall
//    in its bins (integer atomics in shared memory: the counts are exact)
//    and how many fall below them;
// 2. turns the counts into positions: a prefix over the warps of each bin,
//    then a block scan over the bins;
// 3. places the entries stably, each warp walking its slice in rounds of
//    32 in increasing j, ranked within a round by __match_any_sync; the
//    entry's term 2·g_v·[d_v>0]·(ũ_i − ṽ_j) is written at its position;
// 4. sums, per point, its own term and then its segment in increasing j
//    (a long segment, as the fit's padded target makes, with 16 loads in
//    flight).
// So each sum has a fixed order: no float atomics, and the fit's choice
// among restarts does not depend on a race. The products and sums are
// rounded one by one (no FMA), as the plain twin rounds them. JAX splits
// a cotangent equally among tied minima; the lowest argmin gives the whole
// of it to one of them, which is the same total wherever the tied points
// are identical (the fit's target padding repeats its first point).
// Bound: bytes (each point, cotangent, distance and argmin read once).
// Each block reads all of its restart's argmins twice, from L2, and the
// grid has about two blocks a streaming multiprocessor, so the bins are
// not limited by shared memory: a block holds 512, and a restart takes up
// to 65,535 blocks.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr float kInf = __builtin_huge_valf();

// forward
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 6;                    // rows a lane holds
constexpr int kTileRows = 32 * kRows;       // rows a warp holds
constexpr int kChunk = 32;                  // columns a step
constexpr int kGroup = 8;                   // columns a row's drop is kept at
constexpr int kMaxCols = 1024;              // columns a block
constexpr int kXp = 36;                     // transpose row stride (floats)
constexpr int kRowStride = kRows + 1;       // a lane's rows in shared memory

// backward
constexpr int kMaxBins = 512;
constexpr int kBatch = 8;                   // rounds of 32 entries loaded
constexpr int kWalk = 16;                   // a segment's loads in flight

__device__ __forceinline__ float3 centred(const float* p, const float* mu) {
  return make_float3(__fsub_rn(p[0], mu[0]), __fsub_rn(p[1], mu[1]),
                     __fsub_rn(p[2], mu[2]));
}

__device__ __forceinline__ float norm2(float3 a) {
  return __fmaf_rn(a.z, a.z, __fmaf_rn(a.y, a.y, __fmul_rn(a.x, a.x)));
}

// u = (ũ, ‖ũ‖²), v = (−2ṽ, ‖ṽ‖²): one pair's squared distance, unclamped
__device__ __forceinline__ float pair_d(float4 u, float4 v) {
  return __fmaf_rn(u.x, v.x,
                   __fmaf_rn(u.y, v.y, __fmaf_rn(u.z, v.z,
                                                 __fadd_rn(u.w, v.w))));
}

// (d, index) → a key whose unsigned order is the lexicographic order
__device__ __forceinline__ unsigned long long pack(float d, int idx) {
  unsigned b = __float_as_uint(d);
  b ^= (b & 0x80000000u) ? 0xffffffffu : 0x80000000u;
  return (static_cast<unsigned long long>(b) << 32) |
         static_cast<unsigned>(idx);
}

__device__ __forceinline__ float key_d(unsigned long long key) {
  unsigned b = static_cast<unsigned>(key >> 32);
  b ^= (b & 0x80000000u) ? 0x80000000u : 0xffffffffu;
  return __uint_as_float(b);
}

// grid (row groups, column ranges, restarts); rows x against columns y.
// Row group g holds tiles [g·tiles_per_group, ...) of 256 rows, one a
// warp (warps past the group's last tile only meet the barriers).
template <bool kCols>
__global__ void __launch_bounds__(kThreads)
nearest_pairs_kernel(const float* __restrict__ x, int x_stride, int nx,
                     const float* __restrict__ y, int y_stride, int ny,
                     const float* __restrict__ mu, int cols_per_block,
                     int tiles_per_group,
                     unsigned long long* __restrict__ row_part,
                     unsigned long long* __restrict__ col_part) {
  extern __shared__ __align__(16) float4 smem4[];
  float4* cols = smem4;                                   // [cols_per_block]
  float4* rows_s = cols + cols_per_block;                 // [8 · 32 · 9]
  float* xp = reinterpret_cast<float*>(rows_s + kWarps * 32 * kRowStride);
  unsigned long long* colkey = reinterpret_cast<unsigned long long*>(
      xp + kWarps * 32 * kXp);                            // [cols_per_block]

  const int r = blockIdx.z;
  const int c0 = blockIdx.y * cols_per_block;
  const int ncols = min(ny, c0 + cols_per_block) - c0;
  const int nchunks = (ncols + kChunk - 1) / kChunk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tile = blockIdx.x * tiles_per_group + warp;
  const int row0 = tile * kTileRows + lane * kRows;
  const bool active = warp < tiles_per_group && tile * kTileRows < nx;
  const float* xr = x + static_cast<long>(r) * x_stride;
  const float* yr = y + static_cast<long>(r) * y_stride;

  for (int c = threadIdx.x; c < cols_per_block; c += kThreads) {
    float4 v = make_float4(0.f, 0.f, 0.f, kInf);
    if (c < ncols) {
      const float3 w = centred(yr + 3L * (c0 + c), mu);
      v = make_float4(-2.f * w.x, -2.f * w.y, -2.f * w.z, norm2(w));
    }
    cols[c] = v;
    if (kCols) colkey[c] = ~0ull;
  }
  // this lane's rows, in registers and (padded: no bank conflicts when
  // another lane reads them) in shared memory
  float4 u[kRows];
  float4* rw = rows_s + warp * 32 * kRowStride;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    u[k] = make_float4(0.f, 0.f, 0.f, kInf);
    if (active && row0 + k < nx) {
      const float3 w = centred(xr + 3L * (row0 + k), mu);
      u[k] = make_float4(w.x, w.y, w.z, norm2(w));
    }
    if (kCols) rw[lane * kRowStride + k] = u[k];
  }
  __syncthreads();

  // per row: the running minimum, its value at the last drop, and the
  // group of kGroup columns where it dropped last
  // per row: the minimum so far and the group of kGroup columns where it
  // dropped last; within a group, two running minima (even and odd
  // columns: shorter dependent chains), merged at the group's end
  float best[kRows], ev[kRows], od[kRows];
  int bg[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    best[k] = kInf;
    bg[k] = 0;
  }
  float* xw = xp + warp * 32 * kXp;
  for (int ch = 0; active && ch < nchunks; ++ch) {
    const float4* cc = cols + ch * kChunk;
    float cm[4];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const float4 v = cc[c];
      float m = kInf;
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const float d = pair_d(u[k], v);
        float& run = c % 2 ? od[k] : ev[k];
        run = c % kGroup < 2 ? d : fminf(run, d);
        if (kCols) m = k == 0 ? d : fminf(m, d);
      }
      if (kCols) {
        // lane l's column minima become row l of the transpose, 4 at once
        cm[c % 4] = m;
        if (c % 4 == 3)
          *reinterpret_cast<float4*>(xw + lane * kXp + c - 3) =
              make_float4(cm[0], cm[1], cm[2], cm[3]);
      }
      if (c % kGroup == kGroup - 1) {
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          const float g = fminf(ev[k], od[k]);
          if (g < best[k]) {
            best[k] = g;
            bg[k] = (ch * kChunk + c) / kGroup;
          }
        }
      }
    }
    if (kCols) {
      // lane c reads column c of the transpose
      __syncwarp();
      float w = xw[lane];
      int src = 0;
#pragma unroll
      for (int s = 1; s < 32; ++s) {
        const float e = xw[s * kXp + lane];
        if (e < w) {
          w = e;
          src = s;
        }
      }
      __syncwarp();
      const int c = ch * kChunk + lane;
      if (c < ncols) {
        const float4 v = cols[c];
        int kw = kRows - 1;
#pragma unroll
        for (int k = kRows - 1; k >= 0; --k)
          if (pair_d(rw[src * kRowStride + k], v) == w) kw = k;
        atomicMin(colkey + c, pack(w, tile * kTileRows + src * kRows + kw));
      }
    }
  }
  if (active) {
    // each row's index: the lowest column of its group reaching the
    // minimum, the group read from a lane-rotated start (no bank conflicts)
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int i = row0 + k;
      if (i < nx) {
        const float4* cg = cols + bg[k] * kGroup;
        int arg = kGroup;
#pragma unroll
        for (int c = 0; c < kGroup; ++c) {
          const int cr = (c + lane) & (kGroup - 1);
          if (pair_d(u[k], cg[cr]) == best[k] && cr < arg) arg = cr;
        }
        row_part[(static_cast<long>(r) * gridDim.y + blockIdx.y) * nx + i] =
            pack(best[k], c0 + bg[k] * kGroup + arg);
      }
    }
  }
  if (kCols) {
    __syncthreads();
    for (int c = threadIdx.x; c < ncols; c += kThreads)
      col_part[(static_cast<long>(r) * gridDim.x + blockIdx.x) * ny + c0 +
               c] = colkey[c];
  }
}

// the minimum of each row's and column's partial keys: 32 outputs a block,
// 8 threads over each output's partials
__global__ void __launch_bounds__(256)
nearest_reduce_kernel(const unsigned long long* __restrict__ row_part,
                      int n_row_parts, int nx,
                      const unsigned long long* __restrict__ col_part,
                      int n_col_parts, int ny, int batch,
                      float* __restrict__ d_x, int* __restrict__ a,
                      float* __restrict__ d_y, int* __restrict__ b) {
  __shared__ unsigned long long red[8][32];
  const long e = static_cast<long>(blockIdx.x) * 32 + threadIdx.x;
  const long n_rows = static_cast<long>(batch) * nx;
  const long n_all = n_rows + (d_y ? static_cast<long>(batch) * ny : 0);
  unsigned long long key = ~0ull;
  const bool is_row = e < n_rows;
  if (e < n_all) {
    const long f = is_row ? e : e - n_rows;
    const int n = is_row ? nx : ny;
    const int parts = is_row ? n_row_parts : n_col_parts;
    const long rr = f / n, i = f - rr * n;
    const unsigned long long* p =
        (is_row ? row_part : col_part) + rr * parts * n + i;
    for (int s = threadIdx.y; s < parts; s += 8) key = min(key, p[s * n]);
  }
  red[threadIdx.y][threadIdx.x] = key;
  __syncthreads();
  if (threadIdx.y != 0 || e >= n_all) return;
#pragma unroll
  for (int s = 1; s < 8; ++s) key = min(key, red[s][threadIdx.x]);
  const float d = fmaxf(key_d(key), 0.f);
  const int idx = static_cast<int>(key & 0xffffffffu);
  if (is_row) {
    d_x[e] = d;
    a[e] = idx;
  } else {
    d_y[e - n_rows] = d;
    b[e - n_rows] = idx;
  }
}

__device__ __forceinline__ float3 term(float c, float3 u, float3 v) {
  return make_float3(__fmul_rn(c, __fsub_rn(u.x, v.x)),
                     __fmul_rn(c, __fsub_rn(u.y, v.y)),
                     __fmul_rn(c, __fsub_rn(u.z, v.z)));
}

// grid (blocks of `bins` query points, restarts)
__global__ void __launch_bounds__(kThreads)
nearest_sq_bwd_kernel(const float* __restrict__ query, int q_stride, int nq,
                      const float* __restrict__ ref, int r_stride, int nr,
                      const float* __restrict__ mu,
                      const float* __restrict__ g_u,
                      const float* __restrict__ d_u,
                      const int* __restrict__ idx_u,
                      const float* __restrict__ g_v,
                      const float* __restrict__ d_v,
                      const int* __restrict__ idx_v, int bins,
                      float4* __restrict__ terms, int* __restrict__ perm_out,
                      int* __restrict__ off_out, float* __restrict__ out) {
  __shared__ int cnt[kWarps][kMaxBins];
  __shared__ int seg[kMaxBins + 1];
  __shared__ int wsum[kWarps];
  const int r = blockIdx.y;
  const int i0 = blockIdx.x * bins;
  const int nb = min(nq, i0 + bins) - i0;
  const int i1 = i0 + nb;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned lower = (1u << lane) - 1u;
  const float* q_pts = query + static_cast<long>(r) * q_stride;
  const float* r_pts = ref + static_cast<long>(r) * r_stride;
  const long row = static_cast<long>(r) * nr;
  const int* bv = idx_v + row;

  for (int t = threadIdx.x; t < kWarps * nb; t += kThreads)
    cnt[t / nb][t % nb] = 0;
  __syncthreads();

  // 1. counts of this warp's slice [j0, j1) in each bin, and below i0;
  // kBatch rounds of 32 entries are loaded at once
  const int slice = (nr + kWarps - 1) / kWarps;
  const int j0 = min(nr, warp * slice), j1 = min(nr, j0 + slice);
  int below = 0;
  for (int base = j0; base < j1; base += 32 * kBatch) {
    int bin[kBatch];
#pragma unroll
    for (int t = 0; t < kBatch; ++t) {
      const int j = base + 32 * t + lane;
      bin[t] = j < j1 ? bv[j] : -1;
      below += (j < j1 && bin[t] < i0) ? 1 : 0;
    }
#pragma unroll
    for (int t = 0; t < kBatch; ++t)
      if (bin[t] >= i0 && bin[t] < i1) atomicAdd(&cnt[warp][bin[t] - i0], 1);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) below += __shfl_xor_sync(~0u, below, o);
  if (lane == 0) wsum[warp] = below;
  __syncthreads();
  int first = 0;  // the CSR position of this block's first entry
#pragma unroll
  for (int w = 0; w < kWarps; ++w) first += wsum[w];

  // 2. positions: a prefix over the warps in each bin, then over the bins
  for (int b = threadIdx.x; b < nb; b += kThreads) {
    int run = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = cnt[w][b];
      cnt[w][b] = run;
      run += c;
    }
    seg[b] = run;
  }
  __syncthreads();
  {
    // exclusive scan of seg[0, nb), two bins a thread (nb ≤ 512)
    const int b = 2 * threadIdx.x;
    const int t0 = b < nb ? seg[b] : 0, t1 = b + 1 < nb ? seg[b + 1] : 0;
    int incl = t0 + t1;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(~0u, incl, o);
      if (lane >= o) incl += v;
    }
    __syncthreads();  // every wsum read above is done
    if (lane == 31) wsum[warp] = incl;
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      before += w < warp ? wsum[w] : 0;
      total += wsum[w];
    }
    const int excl = before + incl - t0 - t1;
    if (b < nb) seg[b] = excl;
    if (b + 1 < nb) seg[b + 1] = excl + t0;
    if (threadIdx.x == 0) seg[nb] = total;
  }
  __syncthreads();
  for (int b = threadIdx.x; b < nb; b += kThreads) {
    const int s = first + seg[b];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) cnt[w][b] += s;
  }
  __syncthreads();

  // 3. stable placement, in rounds of 32 in increasing j: the positions
  // of kBatch rounds first (shared memory only), then their terms
  for (int base = j0; base < j1; base += 32 * kBatch) {
    int bin[kBatch], pos[kBatch];
#pragma unroll
    for (int t = 0; t < kBatch; ++t) {
      const int j = base + 32 * t + lane;
      bin[t] = j < j1 ? bv[j] : -1;
      if (bin[t] < i0 || bin[t] >= i1) bin[t] = -1;
    }
#pragma unroll
    for (int t = 0; t < kBatch; ++t) {
      const bool in = bin[t] >= 0;
      const unsigned peers = __match_any_sync(~0u, bin[t]);
      pos[t] = in ? cnt[warp][bin[t] - i0] + __popc(peers & lower) : 0;
      __syncwarp();
      if (in && (peers & lower) == 0) cnt[warp][bin[t] - i0] += __popc(peers);
      __syncwarp();
    }
#pragma unroll
    for (int t = 0; t < kBatch; ++t) {
      if (bin[t] >= 0) {
        const int j = base + 32 * t + lane;
        const float c = d_v[row + j] > 0.f ? 2.f * g_v[row + j] : 0.f;
        const float3 e = term(c, centred(q_pts + 3L * bin[t], mu),
                              centred(r_pts + 3L * j, mu));
        terms[row + pos[t]] = make_float4(e.x, e.y, e.z, 0.f);
        if (perm_out) perm_out[row + pos[t]] = j;
      }
    }
  }
  __syncthreads();

  // 4. each point: its own term, then its segment in increasing j
  for (int b = threadIdx.x; b < nb; b += kThreads) {
    const int i = i0 + b;
    const long o = static_cast<long>(r) * nq + i;
    const float c = d_u[o] > 0.f ? 2.f * g_u[o] : 0.f;
    float3 acc = term(c, centred(q_pts + 3L * i, mu),
                      centred(r_pts + 3L * idx_u[o], mu));
    const int start = first + seg[b], end = first + seg[b + 1];
    // a long segment (the fit's padded target) in batches of loads in
    // flight, summed in order
    int k = start;
    for (; k + kWalk <= end; k += kWalk) {
      float4 t[kWalk];
#pragma unroll
      for (int w = 0; w < kWalk; ++w) t[w] = terms[row + k + w];
#pragma unroll
      for (int w = 0; w < kWalk; ++w) {
        acc.x = __fadd_rn(acc.x, t[w].x);
        acc.y = __fadd_rn(acc.y, t[w].y);
        acc.z = __fadd_rn(acc.z, t[w].z);
      }
    }
    for (; k < end; ++k) {
      const float4 t = terms[row + k];
      acc.x = __fadd_rn(acc.x, t.x);
      acc.y = __fadd_rn(acc.y, t.y);
      acc.z = __fadd_rn(acc.z, t.z);
    }
    out[3 * o] = acc.x;
    out[3 * o + 1] = acc.y;
    out[3 * o + 2] = acc.z;
    if (off_out) off_out[static_cast<long>(r) * (nq + 1) + i] = start;
  }
  if (off_out && i1 == nq && threadIdx.x == 0)
    off_out[static_cast<long>(r) * (nq + 1) + nq] = first + seg[nb];
}

template <bool kCols>
int launch_pairs(dim3 grid, int smem, cudaStream_t st, const float* x,
                 int x_stride, int nx, const float* y, int y_stride, int ny,
                 const float* mu, int cols_per_block, int tiles_per_group,
                 unsigned long long* row_part,
                 unsigned long long* col_part) {
  static int done = 0;
  const int rc = set_smem(nearest_pairs_kernel<kCols>, smem, done);
  if (rc) return rc;
  nearest_pairs_kernel<kCols><<<grid, kThreads, smem, st>>>(
      x, x_stride, nx, y, y_stride, ny, mu, cols_per_block, tiles_per_group,
      row_part, col_part);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// row_part: [batch, ceil(ny / cols_per_block), nx] keys; col_part: [batch,
// ceil(ceil(nx / 256) / tiles_per_group), ny] keys, or null (with d_y, b)
// for the row direction alone
extern "C" int cfs_nearest_sq(const float* x, int x_stride, int nx,
                              const float* y, int y_stride, int ny,
                              const float* mu, int batch, int cols_per_block,
                              int tiles_per_group,
                              unsigned long long* row_part,
                              unsigned long long* col_part, float* d_x,
                              int* a, float* d_y, int* b, void* stream) {
  const bool cols = col_part != nullptr;
  if (nx < 1 || ny < 1 || batch < 1 || batch > 65535 ||
      cols_per_block < kChunk || cols_per_block > kMaxCols ||
      cols_per_block % kChunk || tiles_per_group < 1 ||
      tiles_per_group > kWarps || cols != (d_y != nullptr) ||
      cols != (b != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (nx + kTileRows - 1) / kTileRows;
  const int splits = (ny + cols_per_block - 1) / cols_per_block;
  const dim3 grid((tiles + tiles_per_group - 1) / tiles_per_group, splits,
                  batch);
  if (grid.x > 65535 || grid.y > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (cols) {
    const int smem = cols_per_block * 16 + kWarps * 32 * kRowStride * 16 +
                     kWarps * 32 * kXp * 4 + cols_per_block * 8;
    rc = launch_pairs<true>(grid, smem, st, x, x_stride, nx, y, y_stride, ny,
                            mu, cols_per_block, tiles_per_group, row_part,
                            col_part);
  } else {
    rc = launch_pairs<false>(grid, cols_per_block * 16, st, x, x_stride, nx,
                             y, y_stride, ny, mu, cols_per_block,
                             tiles_per_group, row_part, nullptr);
  }
  if (rc) return rc;
  const long outputs = static_cast<long>(batch) * nx +
                       (cols ? static_cast<long>(batch) * ny : 0);
  const long blocks = (outputs + 31) / 32;
  if (blocks > 2147483647L) return static_cast<int>(cudaErrorInvalidValue);
  nearest_reduce_kernel<<<static_cast<unsigned>(blocks), dim3(32, 8), 0,
                          st>>>(row_part, splits, nx, col_part, grid.x, ny,
                                batch, d_x, a, d_y, b);
  return static_cast<int>(cudaGetLastError());
}

// terms: [batch, nr] float4 scratch; perm_out [batch, nr] and off_out
// [batch, nq + 1] are written where not null (the CSR, for checks)
extern "C" int cfs_nearest_sq_bwd(const float* query, int q_stride, int nq,
                                  const float* ref, int r_stride, int nr,
                                  const float* mu, int batch,
                                  const float* g_u, const float* d_u,
                                  const int* idx_u, const float* g_v,
                                  const float* d_v, const int* idx_v,
                                  int bins, float4* terms, int* perm_out,
                                  int* off_out, float* out, void* stream) {
  if (nq < 1 || nr < 1 || batch < 1 || batch > 65535 || bins < 1 ||
      bins > kMaxBins)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (nq + bins - 1) / bins;
  if (blocks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  nearest_sq_bwd_kernel<<<dim3(blocks, batch), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      query, q_stride, nq, ref, r_stride, nr, mu, g_u, d_u, idx_u, g_v, d_v,
      idx_v, bins, terms, perm_out, off_out, out);
  return static_cast<int>(cudaGetLastError());
}

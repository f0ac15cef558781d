// K4: ELL sparse-times-dense forward over a packed [N, D] operand.
//
// Replaces craniofacialsd_vae_tpu/ops/sparse.py::ell_matmul_raw (an XLA
// gather + einsum on the TPU). On the serving path it carries the
// decoder's up-pools: three barycentric weights per row, D = B·C.
//
//   out[m, :] = sum_k vals[m, k] * x[cols[m, k], :],  k ascending
//
// What bounds it on an H100: bytes, and before them the latency of two
// dependent loads (the index, then the gathered row) per output. It does
// 2·K flops per output float; the least it can move is each source row
// once and each output once. Two paths, chosen by cfs_ell_matmul_fwd:
//
// - direct (D % 4 == 0, operands on 16 bytes): a warp, or D/4 threads
//   when the row is narrower, walks a row segment in 16-byte pieces, and
//   each thread carries R output rows with all R·K gathers in flight
//   before the first sum (K = 3, the up-pools', is compiled apart and
//   fully unrolled). R = 2 where that grid still gives 16 blocks per SM,
//   else 1. The gathers come from L2: neighbouring rows share sources, so
//   device memory moves each source row about once. Staging a row tile's
//   distinct source rows in shared memory first (read from L2 once, then
//   from shared memory) measured slower on an H100 at the up-pools at
//   B = 16 and 1 (PERF.md): it adds a barrier and a copy per tile, and
//   L2 was not what bound this kernel.
// - scalar (D % 4 != 0 or an operand off 16 bytes): a block row of
//   threads walks one output row in plain floats.
//
// Padded entries point at row 0 with weight 0. No path branches on them:
// every entry is computed, as the plain twin does. Products and sums are
// rounded one by one (__fmul_rn, __fadd_rn) in the plain twin's order, so
// both paths agree with it bit for bit.
//
// ell_matmul_capped (cfs_ell_matmul_capped) is K4 with the overflow tiers
// of a capped table landed inside the same launch. It replaces
// craniofacialsd_vae_tpu/ops/sparse.py::CappedEll.apply (lines 101-104:
// the main ELL product, then `out.at[o_rows].add(ell_matmul_raw(o_cols,
// o_vals, x))` per tier). The tiers' rows are unique, and tier t's rows
// are a subset of tier t-1's (capped_ell builds them so), so the host
// stores a walk (kernels.py, sparse.py::tier_links): link0[m] is main row
// m's slot in tier 1 (-1 if none), next_t[r] tier t's row r's slot in
// tier t+1. The thread that forms main row m in K4's order goes on along
// the walk, forms each tier's sum in K4's order and adds it to its
// accumulator with one rounding, then writes the row once: the rounding
// sequence of K4 followed by one index_add per tier, so the result is
// bit-equal to that plain twin, with no atomics and no second read and
// write of a landed row. Bound, as K4, by bytes: the main table's and the
// tiers' gathered rows and one write of each output row. Tables without
// tiers take K4 itself: the CAPPED template flag compiles the tier walk
// out, so the serving path runs the same code as before.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTiers = 3;

// The overflow tiers' walk, by value in the kernel's parameters.
struct Tiers {
  const int* link0;                  // [M]: slot in tier 1, or -1
  const int* cols[kMaxTiers];        // [R_t, K_t]
  const float* vals[kMaxTiers];
  const int* next[kMaxTiers];        // [R_t]: slot in tier t + 1, or -1
  int k[kMaxTiers];
};

__device__ __forceinline__ float4 madd4(float4 acc, float w, float4 g) {
  acc.x = __fadd_rn(acc.x, __fmul_rn(w, g.x));
  acc.y = __fadd_rn(acc.y, __fmul_rn(w, g.y));
  acc.z = __fadd_rn(acc.z, __fmul_rn(w, g.z));
  acc.w = __fadd_rn(acc.w, __fmul_rn(w, g.w));
  return acc;
}

__device__ __forceinline__ float4 mul4(float w, float4 g) {
  return make_float4(__fmul_rn(w, g.x), __fmul_rn(w, g.y), __fmul_rn(w, g.z),
                     __fmul_rn(w, g.w));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

// acc + each tier's sum of row m, in tier order (CAPPED launches only)
__device__ __forceinline__ float4 add_tiers4(const Tiers& t, int m,
                                             const float4* __restrict__ x,
                                             int dw, int j, float4 acc) {
  int s = __ldg(t.link0 + m);
#pragma unroll
  for (int q = 0; q < kMaxTiers; ++q) {
    if (s < 0) break;
    const int K = t.k[q];
    const int* c = t.cols[q] + (size_t)s * K;
    const float* v = t.vals[q] + (size_t)s * K;
    float4 sum = mul4(__ldg(v), __ldg(x + (size_t)__ldg(c) * dw + j));
    for (int k = 1; k < K; ++k)
      sum = madd4(sum, __ldg(v + k), __ldg(x + (size_t)__ldg(c + k) * dw + j));
    acc = add4(acc, sum);
    s = __ldg(t.next[q] + s);
  }
  return acc;
}

__device__ __forceinline__ float add_tiers(const Tiers& t, int s,
                                           const float* __restrict__ x,
                                           int dw, int j, float acc) {
#pragma unroll
  for (int q = 0; q < kMaxTiers; ++q) {
    if (s < 0) break;
    const int K = t.k[q];
    const int* c = t.cols[q] + (size_t)s * K;
    const float* v = t.vals[q] + (size_t)s * K;
    float sum = __fmul_rn(__ldg(v), __ldg(x + (size_t)__ldg(c) * dw + j));
    for (int k = 1; k < K; ++k)
      sum = __fadd_rn(sum, __fmul_rn(__ldg(v + k),
                                     __ldg(x + (size_t)__ldg(c + k) * dw + j)));
    acc = __fadd_rn(acc, sum);
    s = __ldg(t.next[q] + s);
  }
  return acc;
}

// Block (tx, 256 / tx), grid (row groups, column segments); each thread
// computes R rows of one 16-byte column; KK = K when it is a compile-time
// constant (the up-pools' 3), else 0. CAPPED: each row's overflow tiers
// are added before it is written.
template <int R, int KK, bool CAPPED>
__global__ void __launch_bounds__(kThreads)
ell_matmul_direct(const Tiers tiers, const int* __restrict__ cols,
                  const float* __restrict__ vals,
                  const float4* __restrict__ x, float4* __restrict__ out,
                  int M, int k_rt, int dw) {
  const int K = KK ? KK : k_rt;
  const int j = blockIdx.y * blockDim.x + threadIdx.x;
  const int m0 = (blockIdx.x * blockDim.y + threadIdx.y) * R;
  if (j >= dw || m0 >= M) return;
  int mr[R];
  float4 acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) mr[r] = min(m0 + r, M - 1);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float w[R];
    float4 g[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const size_t e = (size_t)mr[r] * K + k;
      w[r] = __ldg(vals + e);
      g[r] = __ldg(x + (size_t)__ldg(cols + e) * dw + j);
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
      acc[r] = k == 0 ? mul4(w[r], g[r]) : madd4(acc[r], w[r], g[r]);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (m0 + r >= M) continue;
    if (CAPPED) acc[r] = add_tiers4(tiers, m0 + r, x, dw, j, acc[r]);
    out[(size_t)(m0 + r) * dw + j] = acc[r];
  }
}

template <bool CAPPED>
__global__ void __launch_bounds__(kThreads)
ell_matmul_scalar(const Tiers tiers, const int* __restrict__ cols,
                  const float* __restrict__ vals,
                  const float* __restrict__ x, float* __restrict__ out,
                  int M, int K, int dw) {
  const int m = blockIdx.x * blockDim.y + threadIdx.y;
  if (m >= M) return;
  const int* c = cols + (size_t)m * K;
  const float* v = vals + (size_t)m * K;
  const int s = CAPPED ? __ldg(tiers.link0 + m) : -1;
  for (int j = threadIdx.x; j < dw; j += blockDim.x) {
    float acc = __fmul_rn(v[0], __ldg(x + (size_t)c[0] * dw + j));
    for (int k = 1; k < K; ++k)
      acc = __fadd_rn(acc, __fmul_rn(v[k], __ldg(x + (size_t)c[k] * dw + j)));
    if (CAPPED) acc = add_tiers(tiers, s, x, dw, j, acc);
    out[(size_t)m * dw + j] = acc;
  }
}

int blocks_along(int n, int per_block) {
  return (n + per_block - 1) / per_block;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0;
}

template <int R, bool CAPPED>
int launch_direct(const Tiers& tiers, const int* cols, const float* vals,
                  const float* x, float* out, int M, int K, int dw, int tx,
                  cudaStream_t s) {
  const dim3 block(tx, kThreads / tx);
  const dim3 grid(blocks_along(M, block.y * R), blocks_along(dw, tx));
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* o4 = reinterpret_cast<float4*>(out);
  if (K == 3)
    ell_matmul_direct<R, 3, CAPPED><<<grid, block, 0, s>>>(
        tiers, cols, vals, x4, o4, M, K, dw);
  else
    ell_matmul_direct<R, 0, CAPPED><<<grid, block, 0, s>>>(
        tiers, cols, vals, x4, o4, M, K, dw);
  return static_cast<int>(cudaGetLastError());
}

// The launch rule shared by K4 and its capped form.
template <bool CAPPED>
int launch_ell(const Tiers& tiers, const int* cols, const float* vals,
               const float* x, float* out, int M, int K, int D,
               cudaStream_t s) {
  if (M < 1 || K < 1 || D < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (D % 4 || !aligned16(x) || !aligned16(out)) {
    int tx = 32;                     // threads along the row: a warp or more
    while (tx < D && tx < kThreads) tx *= 2;
    const dim3 block(tx, kThreads / tx);
    ell_matmul_scalar<CAPPED><<<blocks_along(M, block.y), block, 0, s>>>(
        tiers, cols, vals, x, out, M, K, D);
    return static_cast<int>(cudaGetLastError());
  }
  const int dw = D / 4;
  int tx = 32;                       // a warp, or the row where narrower
  while (tx / 2 >= dw) tx /= 2;
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long two = static_cast<long long>(
      blocks_along(M, 2 * (kThreads / tx))) * blocks_along(dw, tx);
  return two >= 16LL * sms
             ? launch_direct<2, CAPPED>(tiers, cols, vals, x, out, M, K, dw, tx,
                                        s)
             : launch_direct<1, CAPPED>(tiers, cols, vals, x, out, M, K, dw, tx,
                                        s);
}

}  // namespace

// K4: out [M, D] = the ELL product. Returns a cudaError_t.
extern "C" int cfs_ell_matmul_fwd(const int* cols, const float* vals,
                                  const float* x, float* out, int M, int K,
                                  int D, void* stream) {
  return launch_ell<false>(Tiers{}, cols, vals, x, out, M, K, D,
                           static_cast<cudaStream_t>(stream));
}

// ell_matmul_capped: out [M, D] = the main ELL product plus its n_tiers
// (1 to 3) overflow tiers. link0 [M] is the walk's first link; tier_ptrs
// holds 3 device pointers per tier (cols [R_t, K_t], vals [R_t, K_t],
// next [R_t]) and tier_k each tier's K_t, both in host memory. Returns a
// cudaError_t.
extern "C" int cfs_ell_matmul_capped(const int* cols, const float* vals,
                                     const int* link0, const float* x,
                                     float* out, int M, int K, int D,
                                     int n_tiers, void* const* tier_ptrs,
                                     const int* tier_k, void* stream) {
  if (n_tiers < 1 || n_tiers > kMaxTiers || link0 == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Tiers t{};
  t.link0 = link0;
  for (int q = 0; q < n_tiers; ++q) {
    t.cols[q] = static_cast<const int*>(tier_ptrs[3 * q]);
    t.vals[q] = static_cast<const float*>(tier_ptrs[3 * q + 1]);
    t.next[q] = static_cast<const int*>(tier_ptrs[3 * q + 2]);
    t.k[q] = tier_k[q];
    if (!t.cols[q] || !t.vals[q] || !t.next[q] || t.k[q] < 1)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_ell<true>(t, cols, vals, x, out, M, K, D,
                          static_cast<cudaStream_t>(stream));
}

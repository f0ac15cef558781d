// K4-bf16: the ELL sparse-times-dense product over packed [N, D] bf16 rows,
// and its capped form with the overflow tiers landed in the same launch.
//
// Replaces craniofacialsd_vae_tpu/ops/sparse.py::ell_matmul_raw (lines
// 191-205: an XLA gather + einsum) and CappedEll.apply (lines 101-105)
// where the rows are bf16, as they are under the `mixed` and `bfloat16`
// policies: the decoder's up-pools, and in the backward the capped
// transposes that gather dy of the up-pools and dg of the bf16 convs.
//
//   out[m, :] = bf16( sum_k bf16(vals[m, k]) * x[cols[m, k], :] )
//
// with the products and their sum in fp32 (a product of two bf16 values
// is exact in fp32), k ascending, rounded once: what XLA's bf16 einsum
// gives on the CPU. The capped form keeps the JAX package's rounding
// points: the main sum is rounded, each tier's sum is rounded, and the
// tier lands with a bf16 add (out.at[o_rows].add), so
//
//   acc = bf16(main); for each tier t holding m: acc = bf16(acc + bf16(sum_t))
//
// in tier order. Every step is an fp32 operation followed by one
// round-to-nearest-even, as in the plain twins (ops/sparse.py), so the
// kernel equals them bit for bit.
//
// What bounds it on an H100: bytes (2·K flops per 2-byte output; the
// level-0 up-pool writes 17.4 MB at B = 16), and before them the latency
// of two dependent loads per gathered row, the index and then the row.
// The tier walk is the one of csrc/ell_matmul.cu (sparse.py::tier_links):
// the thread that forms row m goes on along link0[m], next_t[...], so no
// row is written twice and no atomics are needed. Two paths:
//
// - vector (D % 8 == 0, x and out on 16 bytes): a thread forms 8
//   columns (one 16-byte piece) of one row, D/8 threads (at most 32)
//   along a row. K = 3, the up-pools', is compiled apart and fully
//   unrolled: the row's three indices and weights are loaded, then its
//   three gathered rows, before the first product, so every load of the
//   row is in flight at once (the first design walked a run-time K with
//   one index-then-row pair in flight; PERF.md §6 has both designs'
//   times). Other K (the transposes, 2 to 27, and the overflow tiers) are
//   walked four entries a step the same way. Two rows a thread, two
//   16-byte pieces a thread and evict-first stores of the level-0 output
//   measured no faster on any table and are not kept;
// - scalar: a thread forms one column of one row.
//
// Padded entries point at row 0 with weight 0 and are computed as the
// twin computes them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTiers = 3;
constexpr int kKC = 4;                 // entries a run-time K step loads

struct Tiers {
  const int* link0;                  // [M]: slot in tier 1, or -1
  const int* cols[kMaxTiers];        // [R_t, K_t]
  const float* vals[kMaxTiers];
  const int* next[kMaxTiers];        // [R_t]: slot in tier t + 1, or -1
  int k[kMaxTiers];
};

// bf16(v) as a float, round to nearest even
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void load8(const uint4& q, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

__device__ __forceinline__ uint4 store8(const float (&f)[8]) {
  uint4 q;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return q;
}

// acc = w·g (FIRST) or acc + w·g over 8 columns, each product and each
// add rounded to fp32
template <bool FIRST>
__device__ __forceinline__ void madd8(float (&acc)[8], float w,
                                      const uint4& q) {
  float g[8];
  load8(q, g);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    acc[i] = FIRST ? __fmul_rn(w, g[i]) : __fadd_rn(acc[i], __fmul_rn(w, g[i]));
}

// sum_k bf16(v[k]) * x[c[k], column vector j] over a row's K entries (c
// and v point at the row), fp32, k ascending, KC entries at a time: a
// chunk's indices and weights, then its gathered rows, then its products
// (entries past K are skipped, never added as zeros). KK: K where it is a
// compile-time constant (the up-pools' 3, one chunk), else 0.
template <int KK>
__device__ __forceinline__ void row_sum(const int* __restrict__ c,
                                        const float* __restrict__ v, int K,
                                        const uint4* __restrict__ x, int dw,
                                        int j, float (&acc)[8]) {
  constexpr int KC = KK ? KK : kKC;
  if (KK) K = KK;
  for (int k0 = 0; k0 < K; k0 += KC) {
    int cc[KC];
    float w[KC];
#pragma unroll
    for (int q = 0; q < KC; ++q) {
      const int k = KK ? q : min(k0 + q, K - 1);
      cc[q] = __ldg(c + k);
      w[q] = round_bf16(__ldg(v + k));
    }
    uint4 g[KC];
#pragma unroll
    for (int q = 0; q < KC; ++q) g[q] = __ldg(x + (size_t)cc[q] * dw + j);
#pragma unroll
    for (int q = 0; q < KC; ++q) {
      if (k0 + q >= K) break;
      if (k0 + q == 0)
        madd8<true>(acc, w[q], g[q]);
      else
        madd8<false>(acc, w[q], g[q]);
    }
  }
}

__device__ __forceinline__ float row_sum1(const int* __restrict__ c,
                                          const float* __restrict__ v, int K,
                                          const __nv_bfloat16* __restrict__ x,
                                          int d, int j) {
  float acc = 0.f;
  for (int k = 0; k < K; ++k) {
    const float p = __fmul_rn(round_bf16(__ldg(v + k)),
                              __bfloat162float(x[(size_t)__ldg(c + k) * d + j]));
    acc = k == 0 ? p : __fadd_rn(acc, p);
  }
  return acc;
}

// Block (tx, 256 / tx), grid (row groups, column segments of tx); each
// thread forms column vector j of one row. KK = K where it is a
// compile-time constant (the up-pools' 3), else 0. CAPPED: the row's
// overflow tiers are added before it is written.
template <int KK, bool CAPPED>
__global__ void __launch_bounds__(kThreads)
ell_bf16_vector(const Tiers tiers, const int* __restrict__ cols,
                const float* __restrict__ vals, const uint4* __restrict__ x,
                uint4* __restrict__ out, int M, int K, int dw) {
  const int j = blockIdx.y * blockDim.x + threadIdx.x;
  const int m = blockIdx.x * blockDim.y + threadIdx.y;
  if (j >= dw || m >= M) return;
  float acc[8];
  row_sum<KK>(cols + (size_t)m * K, vals + (size_t)m * K, K, x, dw, j, acc);
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = round_bf16(acc[i]);
  if (CAPPED) {
    int s = __ldg(tiers.link0 + m);
#pragma unroll
    for (int q = 0; q < kMaxTiers; ++q) {
      if (s < 0) break;
      const int Kt = tiers.k[q];
      float t[8];
      row_sum<0>(tiers.cols[q] + (size_t)s * Kt,
                 tiers.vals[q] + (size_t)s * Kt, Kt, x, dw, j, t);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        acc[i] = round_bf16(__fadd_rn(acc[i], round_bf16(t[i])));
      s = __ldg(tiers.next[q] + s);
    }
  }
  out[(size_t)m * dw + j] = store8(acc);
}

template <bool CAPPED>
__global__ void __launch_bounds__(kThreads)
ell_bf16_scalar(const Tiers tiers, const int* __restrict__ cols,
                const float* __restrict__ vals,
                const __nv_bfloat16* __restrict__ x,
                __nv_bfloat16* __restrict__ out, int M, int K, int d) {
  const int m = blockIdx.x * blockDim.y + threadIdx.y;
  if (m >= M) return;
  const int s0 = CAPPED ? __ldg(tiers.link0 + m) : -1;
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    float acc = round_bf16(row_sum1(cols + (size_t)m * K, vals + (size_t)m * K,
                                    K, x, d, j));
    int s = s0;
#pragma unroll
    for (int q = 0; q < kMaxTiers; ++q) {
      if (!CAPPED || s < 0) break;
      const int Kt = tiers.k[q];
      const float t = row_sum1(tiers.cols[q] + (size_t)s * Kt,
                               tiers.vals[q] + (size_t)s * Kt, Kt, x, d, j);
      acc = round_bf16(__fadd_rn(acc, round_bf16(t)));
      s = __ldg(tiers.next[q] + s);
    }
    out[(size_t)m * d + j] = __float2bfloat16_rn(acc);
  }
}

int blocks_along(int n, int per_block) {
  return (n + per_block - 1) / per_block;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0;
}

// The vector path where D % 8 == 0 and x and out lie on 16 bytes, else
// the scalar path.
template <bool CAPPED>
int launch(const Tiers& tiers, const int* cols, const float* vals,
           const void* x, void* out, int M, int K, int D, cudaStream_t s) {
  if (M < 1 || K < 1 || D < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (D % 8 || !aligned16(x) || !aligned16(out)) {
    int tx = 32;
    while (tx < D && tx < kThreads) tx *= 2;
    const dim3 block(tx, kThreads / tx);
    ell_bf16_scalar<CAPPED><<<blocks_along(M, block.y), block, 0, s>>>(
        tiers, cols, vals, static_cast<const __nv_bfloat16*>(x),
        static_cast<__nv_bfloat16*>(out), M, K, D);
    return static_cast<int>(cudaGetLastError());
  }
  const int dw = D / 8;
  int tx = 32;                       // a warp, or the row where narrower
  while (tx / 2 >= dw) tx /= 2;
  const dim3 block(tx, kThreads / tx);
  const dim3 grid(blocks_along(M, block.y), blocks_along(dw, tx));
  const uint4* x4 = static_cast<const uint4*>(x);
  uint4* o4 = static_cast<uint4*>(out);
  if (K == 3)
    ell_bf16_vector<3, CAPPED><<<grid, block, 0, s>>>(tiers, cols, vals, x4,
                                                      o4, M, K, dw);
  else
    ell_bf16_vector<0, CAPPED><<<grid, block, 0, s>>>(tiers, cols, vals, x4,
                                                      o4, M, K, dw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K4-bf16: out [M, D] bf16 = the ELL product of bf16 rows x [N, D] with
// fp32 vals rounded to bf16. Returns a cudaError_t.
extern "C" int cfs_ell_matmul_bf16(const int* cols, const float* vals,
                                   const void* x, void* out, int M, int K,
                                   int D, void* stream) {
  return launch<false>(Tiers{}, cols, vals, x, out, M, K, D,
                       static_cast<cudaStream_t>(stream));
}

// The capped form: the main product plus its n_tiers (1 to 3) overflow
// tiers, walked from link0 [M]; tier_ptrs holds 3 device pointers per tier
// (cols [R_t, K_t], vals [R_t, K_t], next [R_t]) and tier_k each K_t, both
// in host memory. Returns a cudaError_t.
extern "C" int cfs_ell_matmul_capped_bf16(const int* cols, const float* vals,
                                          const int* link0, const void* x,
                                          void* out, int M, int K, int D,
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
  return launch<true>(t, cols, vals, x, out, M, K, D,
                      static_cast<cudaStream_t>(stream));
}

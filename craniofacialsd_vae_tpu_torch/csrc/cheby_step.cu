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
// 0.006 ms of fp32 issue. The panel (73.7 MB) does not fit the 50 MB L2,
// and each source row is gathered by about 7 output rows. So the grid
// runs over row blocks fastest and column slices slowest: the blocks in
// flight share one 128-column slice, whose N × 128 × 4 bytes (8.4 MB)
// stay in L2 while its rows are gathered. A warp owns one row of a
// slice; lane k holds the row's k-th (col, val) in registers, handed to
// every lane by a shuffle, and each lane carries 4 columns (j = lane +
// 32 t), so a row's K·4 gathers are in flight at once where K is the
// compiled 7 (a triangle mesh's vertices of degree ≤ 6). A row of 1,125
// floats is not a multiple of 16 bytes, so the lanes read it with
// coalesced 4-byte loads.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kWarps = 8;              // rows per block
constexpr int kCols = 4;               // columns per lane
constexpr int kSlice = 32 * kCols;     // columns per block

// KK: the row length when compiled in (7), else 0 (K ≤ 32 at run time).
template <int KK, bool HAS_P>
__global__ void __launch_bounds__(32 * kWarps)
cheby_step_kernel(const int* __restrict__ cols,
                  const float* __restrict__ vals,
                  const float* __restrict__ x, const float* __restrict__ c,
                  const float* __restrict__ p, float* __restrict__ out,
                  int N, int k_rt, int D, float a, float b) {
  const int K = KK ? KK : k_rt;
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (m >= N) return;
  const int j0 = blockIdx.y * kSlice + lane;
  int my_col = 0;
  float my_val = 0.f;
  if (lane < K) {
    my_col = __ldg(cols + (size_t)m * K + lane);
    my_val = __ldg(vals + (size_t)m * K + lane);
  }
  float acc[kCols];
  bool live[kCols];
#pragma unroll
  for (int t = 0; t < kCols; ++t) live[t] = j0 + 32 * t < D;
#pragma unroll
  for (int k = 0; k < (KK ? KK : 32); ++k) {
    if (!KK && k >= K) break;
    const int src = __shfl_sync(0xffffffffu, my_col, k);
    const float w = __shfl_sync(0xffffffffu, my_val, k);
    const float* row = x + (size_t)src * D + j0;
#pragma unroll
    for (int t = 0; t < kCols; ++t) {
      const float g = live[t] ? __ldg(row + 32 * t) : 0.f;
      acc[t] = k == 0 ? __fmul_rn(w, g) : __fadd_rn(acc[t], __fmul_rn(w, g));
    }
  }
#pragma unroll
  for (int t = 0; t < kCols; ++t) {
    if (!live[t]) continue;
    const int j = j0 + 32 * t;
    const size_t e = (size_t)m * D + j;
    const float d = __fsub_rn(acc[t], __fmul_rn(__ldg(c + j), __ldg(x + e)));
    float r = __fmul_rn(a, d);
    if (HAS_P) r = __fsub_rn(r, __fmul_rn(b, __ldg(p + e)));
    out[e] = r;
  }
}

template <int KK>
void launch(const int* cols, const float* vals, const float* x,
            const float* c, const float* p, float* out, int N, int K, int D,
            float a, float b, cudaStream_t s) {
  const dim3 grid((N + kWarps - 1) / kWarps, (D + kSlice - 1) / kSlice);
  if (p)
    cheby_step_kernel<KK, true><<<grid, 32 * kWarps, 0, s>>>(
        cols, vals, x, c, p, out, N, K, D, a, b);
  else
    cheby_step_kernel<KK, false><<<grid, 32 * kWarps, 0, s>>>(
        cols, vals, x, c, nullptr, out, N, K, D, a, b);
}

}  // namespace

// K9: out [N, D] = a · (L x − c ⊙ x) − b · p over the ELL Laplacian
// (cols, vals [N, K], K ≤ 32), c [D] per column; p may be null, and then
// the b · p term is left out. Returns a cudaError_t.
extern "C" int cfs_cheby_step(const int* cols, const float* vals,
                              const float* x, const float* c, const float* p,
                              float* out, int N, int K, int D, float a,
                              float b, void* stream) {
  if (N < 1 || K < 1 || K > 32 || D < 1 || (D + kSlice - 1) / kSlice > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K == 7)
    launch<7>(cols, vals, x, c, p, out, N, K, D, a, b, s);
  else
    launch<0>(cols, vals, x, c, p, out, N, K, D, a, b, s);
  return static_cast<int>(cudaGetLastError());
}

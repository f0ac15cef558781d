// K3b: the gather-sum of the matmul-first ("out-gather") spiral conv, and
// its backward.
//
//   out[m, b, o] = bias[o] + sum_l u[l, o, table[m, l], b]      (fp32)
//
// Replaces the gathers and sums of craniofacialsd_vae_tpu/ops/spiral_conv.py
// ::spiral_conv_out_gather (lines 259-263: u = einsum("...c,lco->l...o"),
// position-major so that each gather source u[l] is contiguous, then out =
// b and out + u_l gathered through each position's GatherRows; XLA on the
// TPU), the final decoder conv under the `mixed` and `bfloat16` policies
// with final_out_gather (the default), and that function's VJP, which JAX
// autodiff forms from ops/sparse.py::_gather_rows_bwd (:280): each
// position's du_l is its gather's capped transpose applied to dout, and
// the identity position's du_0 is dout itself.
//
// Layout. u comes from one plain fp32 product of the bf16 values,
// W_cat^T @ x^T, laid out [L, O, N, B] (kernels.py, ops/spiral_conv.py):
// position-major as in JAX, and the product's own rows, so neither the
// product nor its backward copies u or du. For vertex m and position l
// the B batch rows of output o are one contiguous run of B floats, 64
// bytes at B = 16, where the earlier [N, B, L, O] layout gave 12 useful
// bytes out of every 108-byte run.
//
// Forward (out_gather_sum_kernel): one thread per (m, b), lanes along b,
// so a warp's loads of one (l, o) are contiguous runs. It starts from the
// bias and adds the L gathered values in position order with one
// rounding each (__fadd_rn), as the plain twin
// (ops/spiral_conv.py::out_gather_sum_plain) does: bit-equal. The
// identity position reads its own row through the table (table[m, 0] =
// m), the value the twin takes directly.
//
// Backward (out_gather_sum_bwd_kernel): one launch over every position,
// grid (N·B / 256, L). The positions' capped transposes (sparse.py::
// CappedEll: a main ELL table and up to three overflow tiers reached by
// a walk of links, as cfs_ell_matmul_capped walks them) are concatenated
// into one device table when the SpiralOp is built (ops.OutGatherBwd:
// a 16-int descriptor per position, offsets into flat cols, vals and
// links). The thread of (l, n, b) forms the main table's sum in K4's
// order (products and sums rounded one by one), then adds each tier's
// sum, formed in the same order, with one rounding: the roundings of
// CappedEll.apply, so du is bit-equal to the stack of the positions'
// transposes, with no atomics, no stack and no launch per position. It
// writes du[l, o, n, b] straight into u's layout (lanes along b: runs of
// B floats); at the identity position it copies dout transposed.
//
// What bounds both on an H100: bytes. Forward: u read once (29 MB at
// M = 17,039, B = 16), the output written once; the gathers re-read u's
// rows from L2, where the product just left them. Backward: du written
// once (29 MB), dout (3.3 MB) gathered from L2 by every position, and the
// tables.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxO = 8;          // kernels.py's _OUT_GATHER_MAX_O
constexpr int kMaxTiers = 3;
constexpr int kFields = 4 + 4 * kMaxTiers;   // ops.OutGatherBwd.info

template <int O>
__global__ void __launch_bounds__(kThreads)
out_gather_sum_kernel(const float* __restrict__ u,
                      const int* __restrict__ table,
                      const float* __restrict__ bias, float* __restrict__ out,
                      int M, int N, int L, int B) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)M * B) return;
  const int m = static_cast<int>(i / B);
  const int b = static_cast<int>(i - (long long)m * B);
  const int* row = table + (size_t)m * L;
  const size_t plane = (size_t)N * B;      // floats of one (l, o)
  float acc[O];
#pragma unroll
  for (int o = 0; o < O; ++o) acc[o] = __ldg(bias + o);
  for (int l = 0; l < L; ++l) {
    const float* p = u + (size_t)l * O * plane + (size_t)__ldg(row + l) * B + b;
#pragma unroll
    for (int o = 0; o < O; ++o) acc[o] = __fadd_rn(acc[o], __ldg(p + o * plane));
  }
  float* dst = out + (size_t)i * O;
#pragma unroll
  for (int o = 0; o < O; ++o) dst[o] = acc[o];
}

// acc[o] = sum_k vals[k] * x[cols[k], o] over one row of K entries, in
// K4's order: the first product, then each later one added, every
// product and sum rounded (x: dout at batch row b, row stride B·O).
template <int O>
__device__ __forceinline__ void ell_row(const int* __restrict__ c,
                                        const float* __restrict__ v, int K,
                                        const float* __restrict__ x,
                                        size_t stride, float (&acc)[O]) {
  const float w0 = __ldg(v);
  const float* x0 = x + (size_t)__ldg(c) * stride;
#pragma unroll
  for (int o = 0; o < O; ++o) acc[o] = __fmul_rn(w0, __ldg(x0 + o));
  for (int k = 1; k < K; ++k) {
    const float w = __ldg(v + k);
    const float* xk = x + (size_t)__ldg(c + k) * stride;
#pragma unroll
    for (int o = 0; o < O; ++o)
      acc[o] = __fadd_rn(acc[o], __fmul_rn(w, __ldg(xk + o)));
  }
}

// The walk's first link is loaded before the main row's sum, so that
// the two chains of dependent loads overlap.
template <int O>
__global__ void __launch_bounds__(kThreads)
out_gather_sum_bwd_kernel(const float* __restrict__ dout,
                          const int* __restrict__ info,
                          const int* __restrict__ cols,
                          const float* __restrict__ vals,
                          const int* __restrict__ links,
                          float* __restrict__ du, int N, int B) {
  const int l = blockIdx.y;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)N * B) return;
  const int n = static_cast<int>(i / B);
  const int b = static_cast<int>(i - (long long)n * B);
  const int* f = info + l * kFields;
  const int K = __ldg(f + 1);
  const size_t stride = (size_t)B * O;
  const float* x = dout + (size_t)b * O;     // batch row b of row 0
  float acc[O];
  if (K == 0) {                              // the identity position
    const float* src = x + (size_t)n * stride;
#pragma unroll
    for (int o = 0; o < O; ++o) acc[o] = __ldg(src + o);
  } else {
    const int l0 = __ldg(f + 2);
    int s = l0 < 0 ? -1 : __ldg(links + l0 + n);
    const size_t e = (size_t)__ldg(f) + (size_t)n * K;
    ell_row<O>(cols + e, vals + e, K, x, stride, acc);
    const int n_tiers = __ldg(f + 3);
    for (int q = 0; q < n_tiers && s >= 0; ++q) {
      const int* t = f + 4 + 4 * q;
      const int tk = __ldg(t + 1);
      const size_t te = (size_t)__ldg(t) + (size_t)s * tk;
      float sum[O];
      ell_row<O>(cols + te, vals + te, tk, x, stride, sum);
#pragma unroll
      for (int o = 0; o < O; ++o) acc[o] = __fadd_rn(acc[o], sum[o]);
      s = __ldg(links + __ldg(t + 3) + s);
    }
  }
  const size_t plane = (size_t)N * B;
  float* dst = du + (size_t)l * O * plane + i;
#pragma unroll
  for (int o = 0; o < O; ++o) dst[o * plane] = acc[o];
}

int blocks_of(long long n) {
  return static_cast<int>((n + kThreads - 1) / kThreads);
}

template <int O>
int launch_fwd(const float* u, const int* table, const float* bias,
               float* out, int M, int N, int L, int B, cudaStream_t st) {
  out_gather_sum_kernel<O><<<blocks_of((long long)M * B), kThreads, 0, st>>>(
      u, table, bias, out, M, N, L, B);
  return static_cast<int>(cudaGetLastError());
}

template <int O>
int launch_bwd(const float* dout, const int* info, const int* cols,
               const float* vals, const int* links, float* du, int N, int L,
               int B, cudaStream_t st) {
  out_gather_sum_bwd_kernel<O>
      <<<dim3(blocks_of((long long)N * B), L), kThreads, 0, st>>>(
          dout, info, cols, vals, links, du, N, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K3b for u [L, O, N, B], table [M, L], bias [O], out [M, B, O], all fp32
// but the table; O <= 8. Returns a cudaError_t.
extern "C" int cfs_out_gather_sum(const float* u, const int* table,
                                  const float* bias, float* out, int M, int N,
                                  int L, int B, int O, void* stream) {
  if (M < 1 || N < 1 || L < 1 || B < 1 || O < 1 || O > kMaxO ||
      ((long long)M * B + kThreads - 1) / kThreads > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (O) {
    case 1: return launch_fwd<1>(u, table, bias, out, M, N, L, B, st);
    case 2: return launch_fwd<2>(u, table, bias, out, M, N, L, B, st);
    case 3: return launch_fwd<3>(u, table, bias, out, M, N, L, B, st);
    case 4: return launch_fwd<4>(u, table, bias, out, M, N, L, B, st);
    case 5: return launch_fwd<5>(u, table, bias, out, M, N, L, B, st);
    case 6: return launch_fwd<6>(u, table, bias, out, M, N, L, B, st);
    case 7: return launch_fwd<7>(u, table, bias, out, M, N, L, B, st);
    default: return launch_fwd<8>(u, table, bias, out, M, N, L, B, st);
  }
}

// K3b's backward: du [L, O, N, B] from dout [M, B, O] through the
// concatenated transposes (info [L, 16], cols, vals, links; see
// ops.OutGatherBwd). An identity position (K = 0) needs N == M. Returns a
// cudaError_t.
extern "C" int cfs_out_gather_sum_bwd(const float* dout, const int* info,
                                      const int* cols, const float* vals,
                                      const int* links, float* du, int M,
                                      int N, int L, int B, int O,
                                      void* stream) {
  if (M < 1 || N < 1 || L < 1 || L > 65535 || B < 1 || O < 1 || O > kMaxO ||
      ((long long)N * B + kThreads - 1) / kThreads > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (O) {
    case 1: return launch_bwd<1>(dout, info, cols, vals, links, du, N, L, B, st);
    case 2: return launch_bwd<2>(dout, info, cols, vals, links, du, N, L, B, st);
    case 3: return launch_bwd<3>(dout, info, cols, vals, links, du, N, L, B, st);
    case 4: return launch_bwd<4>(dout, info, cols, vals, links, du, N, L, B, st);
    case 5: return launch_bwd<5>(dout, info, cols, vals, links, du, N, L, B, st);
    case 6: return launch_bwd<6>(dout, info, cols, vals, links, du, N, L, B, st);
    case 7: return launch_bwd<7>(dout, info, cols, vals, links, du, N, L, B, st);
    default: return launch_bwd<8>(dout, info, cols, vals, links, du, N, L, B, st);
  }
}

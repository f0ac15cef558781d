// K3b: the gather-sum of the matmul-first ("out-gather") spiral conv.
//
//   out[m, b, o] = bias[o] + sum_l u[table[m, l], b, l, o]      (fp32)
//
// Replaces the gathers and sums of craniofacialsd_vae_tpu/ops/spiral_conv.py
// ::spiral_conv_out_gather (lines 260-263: out = b, then out + u_l
// gathered through each position's GatherRows, XLA on the TPU), the final
// decoder conv under the `mixed` and `bfloat16` policies with
// final_out_gather (the default). u = x @ W_l for every position comes
// from one plain fp32 product of the bf16 values, laid out [N, B, L, O]
// (the product's own rows, so no transpose is made); its row of vertex s,
// batch row b holds the L positions' O outputs.
//
// One thread per output value. It starts from the bias and adds the L
// gathered values in position order with one rounding each (__fadd_rn),
// as the plain twin (ops/spiral_conv.py::out_gather_sum_plain) does, so
// the two are bit-equal. The identity position reads its own row through
// the table (table[m, 0] = m), the value the twin takes directly.
//
// What bounds it on an H100: bytes. At the final conv (O = 3, B = 16) a
// warp's 32 outputs are 32 of the 48 values of one or two gathered rows
// per position; the gathered rows come from L2, where the product just
// left u (27 MB at B = 16).

#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(256)
out_gather_sum_kernel(const float* __restrict__ u,
                      const int* __restrict__ table,
                      const float* __restrict__ bias, float* __restrict__ out,
                      int M, int L, int B, int O) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)M * B * O) return;
  const int o = static_cast<int>(i % O);
  const long long t = i / O;
  const int b = static_cast<int>(t % B);
  const int m = static_cast<int>(t / B);
  const int* row = table + (size_t)m * L;
  float acc = __ldg(bias + o);
  for (int l = 0; l < L; ++l)
    acc = __fadd_rn(acc, __ldg(u + (((size_t)__ldg(row + l) * B + b) * L + l) * O + o));
  out[i] = acc;
}

}  // namespace

// K3b for u [N, B, L, O], table [M, L], bias [O], out [M, B, O], all fp32
// but the table. Returns a cudaError_t.
extern "C" int cfs_out_gather_sum(const float* u, const int* table,
                                  const float* bias, float* out, int M, int L,
                                  int B, int O, void* stream) {
  if (M < 1 || L < 1 || B < 1 || O < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n = (long long)M * B * O;
  const long long blocks = (n + 255) / 256;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  out_gather_sum_kernel<<<static_cast<unsigned>(blocks), 256, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      u, table, bias, out, M, L, B, O);
  return static_cast<int>(cudaGetLastError());
}

// K2-dW: the weight gradient of the spiral conv, fp32.
//
// Replaces the dW half of craniofacialsd_vae_tpu/ops/spiral_conv.py::
// _score_bwd (lines 208-211; XLA einsums on the TPU, one per position):
//
//   dW[l, c, o] = sum_{m, b} x[S[m, l], b, c] * dy[m, b, o]
//
// for x [N_src, B, C_in], the spiral table S [M, L] and dy [M, B, C_out].
// The gathers are recomputed: the [M, B, L*C_in] concatenation is never
// written.
//
// What bounds it on an H100: operations. It is a tall-skinny product with
// a long reduction (M*B rows, 272,624 at the full-resolution decoder conv
// of a 16-mesh swap grid) into a small [C_in, C_out] matrix per position;
// 2*M*B*C_in*C_out flops per position against one read of x and dy. This
// first kernel runs on the CUDA cores in fp32; its design:
//
// - Deterministic, no atomics. Pass 1 gives each block a fixed chunk of
//   the flat (m, b) rows and one position l (blockIdx.x, so that the L
//   blocks of a chunk run together and share dy in L2), and writes the
//   chunk's partial [C_in, C_out] to a scratch buffer the wrapper
//   allocates. Pass 2 sums the chunks of each output in chunk order.
// - A block stages rows of x (gathered through the table) and of dy in
//   shared memory, 4-float aligned and zero-padded, then each thread adds
//   the outer product of a 4-channel slice of x and a 4-channel slice of
//   dy (two 16-byte shared loads, 16 FMAs) for the rows of its group.
//   The 4x4 tiles of [C_in, C_out] are spread over the threads; where
//   they are fewer than 256, several groups of threads take interleaved
//   rows, and their partials are summed in group order at the end.
//   grid.z walks tiles past 256 (C_in * C_out > 4096).
// - Loads and compute alternate on one buffer (no ring yet): the kernel
//   relies on several blocks per SM to hide the gathers' latency.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTiles = 256;            // 4x4 output tiles per block
constexpr int kStageRows = 64;
constexpr int kSmemFloats = 12288;     // 48 KB: no opt-in needed

// acc[4i + j] += a_i * d_j (written out: no local arrays, no stack)
__device__ __forceinline__ void outer_row(float* acc, float a, float4 d) {
  acc[0] = fmaf(a, d.x, acc[0]);
  acc[1] = fmaf(a, d.y, acc[1]);
  acc[2] = fmaf(a, d.z, acc[2]);
  acc[3] = fmaf(a, d.w, acc[3]);
}

__device__ __forceinline__ void outer4(float (&acc)[16], float4 a, float4 d) {
  outer_row(acc, a.x, d);
  outer_row(acc + 4, a.y, d);
  outer_row(acc + 8, a.z, d);
  outer_row(acc + 12, a.w, d);
}

__global__ void __launch_bounds__(kThreads)
spiral_conv_dw_partial(const float* __restrict__ x,
                       const int* __restrict__ table,
                       const float* __restrict__ dy, float* __restrict__ part,
                       int M, int L, int B, int C_in, int C_out,
                       long long chunk_rows, int stage_rows) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ci4 = (C_in + 3) & ~3, co4 = (C_out + 3) & ~3;
  const int to = co4 / 4;
  const int n_tiles = (ci4 / 4) * to;
  const int tile0 = blockIdx.z * kTiles;
  const int tiles_here = min(n_tiles - tile0, kTiles);
  const int groups = kThreads / tiles_here;
  const int g = threadIdx.x / tiles_here;
  const int tile = tile0 + threadIdx.x % tiles_here;
  const bool active = g < groups;
  const int ic = tile / to, io = tile % to;
  const int l = blockIdx.x;
  float* xs = smem;                            // [stage_rows][ci4]
  float* ds = smem + stage_rows * ci4;         // [stage_rows][co4]

  const long long rows_total = (long long)M * B;
  const long long q0 = (long long)blockIdx.y * chunk_rows;
  const long long q1 = min(q0 + chunk_rows, rows_total);
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;

  for (long long s = q0; s < q1; s += stage_rows) {
    const int n = (int)min((long long)stage_rows, q1 - s);
    for (int e = threadIdx.x; e < stage_rows * ci4; e += kThreads) {
      const int r = e / ci4, c = e - r * ci4;
      float v = 0.f;
      if (r < n && c < C_in) {
        const long long q = s + r;
        const int m = (int)(q / B), b = (int)(q - (long long)m * B);
        const int src = __ldg(table + (size_t)m * L + l);
        v = __ldg(x + ((size_t)src * B + b) * C_in + c);
      }
      xs[e] = v;
    }
    for (int e = threadIdx.x; e < stage_rows * co4; e += kThreads) {
      const int r = e / co4, o = e - r * co4;
      ds[e] = (r < n && o < C_out)
                  ? __ldg(dy + (size_t)(s + r) * C_out + o) : 0.f;
    }
    __syncthreads();
    if (active) {
      for (int r = g; r < n; r += groups) {
        const float4 a = *reinterpret_cast<const float4*>(xs + r * ci4 + ic * 4);
        const float4 d = *reinterpret_cast<const float4*>(ds + r * co4 + io * 4);
        outer4(acc, a, d);
      }
    }
    __syncthreads();
  }

  // the groups' partials, summed in group order
  float* red = smem;                           // [groups][tiles_here][16]
  if (active) {
#pragma unroll
    for (int i = 0; i < 16; ++i)
      red[(g * tiles_here + (tile - tile0)) * 16 + i] = acc[i];
  }
  __syncthreads();
  float* dst = part + ((size_t)blockIdx.y * L + l) * C_in * C_out;
  for (int e = threadIdx.x; e < tiles_here * 16; e += kThreads) {
    float sum = red[e];
    for (int gg = 1; gg < groups; ++gg) sum += red[gg * tiles_here * 16 + e];
    const int t = tile0 + e / 16, i = (e % 16) / 4, j = e % 4;
    const int c = (t / to) * 4 + i, o = (t % to) * 4 + j;
    if (c < C_in && o < C_out) dst[(size_t)c * C_out + o] = sum;
  }
}

// out[e] = sum over chunks of part[chunk][e], in chunk order.
__global__ void __launch_bounds__(kThreads)
spiral_conv_dw_sum(const float* __restrict__ part, float* __restrict__ out,
                   int n_chunks, int n) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= n) return;
  float s = part[e];
  for (int c = 1; c < n_chunks; ++c) s += part[(size_t)c * n + e];
  out[e] = s;
}

}  // namespace

// dW [L, C_in, C_out] from x [N_src, B, C_in], table [M, L] and
// dy [M, B, C_out]; part holds n_chunks * L * C_in * C_out floats and
// chunk_rows * n_chunks covers the M * B rows. Returns a cudaError_t.
extern "C" int cfs_spiral_conv_dw(const float* x, const int* table,
                                  const float* dy, float* part, float* out,
                                  int M, int L, int B, int C_in, int C_out,
                                  int n_chunks, long long chunk_rows,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ci4 = (C_in + 3) & ~3, co4 = (C_out + 3) & ~3;
  if (M < 1 || L < 1 || B < 1 || C_in < 1 || C_out < 1 || n_chunks < 1 ||
      n_chunks > 65535 || chunk_rows < 1 || ci4 + co4 > kSmemFloats ||
      chunk_rows * n_chunks < (long long)M * B)
    return static_cast<int>(cudaErrorInvalidValue);
  int stage_rows = kStageRows;
  while (stage_rows > 1 && stage_rows * (ci4 + co4) > kSmemFloats)
    stage_rows /= 2;
  const int n_tiles = (ci4 / 4) * (co4 / 4);
  // the reduction buffer, groups * tiles * 16 floats, is at most 4096
  const int floats = stage_rows * (ci4 + co4) > 4096
                         ? stage_rows * (ci4 + co4) : 4096;
  const dim3 grid(L, n_chunks, (n_tiles + kTiles - 1) / kTiles);
  spiral_conv_dw_partial<<<grid, kThreads, floats * sizeof(float), s>>>(
      x, table, dy, part, M, L, B, C_in, C_out, chunk_rows, stage_rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n = L * C_in * C_out;
  spiral_conv_dw_sum<<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      part, out, n_chunks, n);
  return static_cast<int>(cudaGetLastError());
}

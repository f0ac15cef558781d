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
// Backward (out_gather_sum_bwd_kernel): one launch over every position.
// Each position's capped transpose (sparse.py::CappedEll: a main ELL
// table and up to three overflow tiers) is walked on the host when the
// SpiralOp is built, into runs of consecutive source vertices
// (ops/spiral_conv.py::OutGatherRuns, at most 32 vertices and 256
// distinct dout rows a run): each run lists the sorted distinct dout rows
// its vertices read at every position (every entry's row, padding's row 0
// and its own rows for the identity position), and for each (position,
// vertex) its entries as 16-bit indices into that list with the weight
// (1, or 0 for padding) in the top bit: the main row's K, then each tier
// the walk reaches, in the walk's order. The device walks no links.
//
// One block per (run, batch slice): it copies the run's lists into
// shared memory (one round trip, so that no row's copy then waits on a
// load of its index), then the B-slice of each listed dout row ([M, B,
// O]: B·O contiguous floats), once, with cp.async (16 bytes where the
// slice's rows are whole 16-byte runs, else 4): a dout row that the
// run's nine positions and neighbouring vertices read about 4.5 times
// (17 reads a vertex against 3.8 staged rows at 32 vertices a run)
// crosses L2 once a run. Then the block's threads walk the (position,
// vertex, batch rows) items, batch rows fastest, four batch rows an item
// where B allows (16-byte loads from shared memory and 16-byte stores):
// for each, the sums from shared memory in CappedEll.apply's roundings
// (every product and sum rounded, __fmul_rn and __fadd_rn, the main row
// first, each tier summed apart and added with one rounding; the
// identity position copies its own row), stored into du[l, o, n, b]:
// u's layout, so a run's stores of one (l, o) are one contiguous span of
// nv·B floats. Bit-equal to the twins (ops/spiral_conv.py::
// out_gather_sum_bwd_plain, the stack of the positions' transposes, and
// out_gather_sum_bwd_tiles_plain, which walks the runs), with no
// atomics. A batch slice is the whole batch unless the staged rows
// would take more than kernels.py's cap of shared memory.
//
// What bounds both on an H100: bytes. Forward: u read once (29 MB at
// M = 17,039, B = 16), the output written once; the gathers re-read u's
// rows from L2, where the product just left them. Backward: du written
// once (29 MB); dout (3.3 MB) and the runs' lists (1.5 MB) read about
// once, dout's rows once a run from L2. Its stores alone come near
// torch's own write of du; the launch and the two round trips before a
// block's first store are what stays above the bound (PERF.md).

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxO = 8;          // kernels.py's _OUT_GATHER_MAX_O
constexpr int kMaxBwdThreads = 512;

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

// The BV·O staged floats of BV consecutive batch rows at xr ([b][o]):
// O 16-byte loads where BV = 4 (xr then lies on 16 bytes).
template <int O, int BV>
__device__ __forceinline__ void load_rows(const float* xr,
                                          float (&x)[BV * O]) {
  if constexpr (BV == 4) {
#pragma unroll
    for (int q = 0; q < O; ++q) {
      const float4 v = reinterpret_cast<const float4*>(xr)[q];
      x[4 * q] = v.x, x[4 * q + 1] = v.y, x[4 * q + 2] = v.z,
      x[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < BV * O; ++k) x[k] = xr[k];
  }
}

// acc[k] = sum_j w_j · x[row_j][k] over K 16-bit entries (the staged
// row's index, the weight 1 or 0 in the top bit) for the thread's BV·O
// values, in K4's order: the first product, then each later one added,
// every product and sum rounded. x: the staged rows at the thread's
// first batch row, W floats a row.
template <int O, int BV>
__device__ __forceinline__ void entry_sum(const unsigned short* e, int K,
                                          const float* x, int W,
                                          float (&acc)[BV * O]) {
  float v[BV * O];
  {
    const unsigned h = e[0];
    const float w = (h >> 15) ? 1.f : 0.f;
    load_rows<O, BV>(x + (h & 0x7fff) * W, v);
#pragma unroll
    for (int k = 0; k < BV * O; ++k) acc[k] = __fmul_rn(w, v[k]);
  }
  for (int j = 1; j < K; ++j) {
    const unsigned h = e[j];
    const float w = (h >> 15) ? 1.f : 0.f;
    load_rows<O, BV>(x + (h & 0x7fff) * W, v);
#pragma unroll
    for (int k = 0; k < BV * O; ++k)
      acc[k] = __fadd_rn(acc[k], __fmul_rn(w, v[k]));
  }
}

// Copies W floats of each of the nr dout rows listed at `list` (in
// shared memory; from src, dout's batch slice, at `stride` floats a row)
// into srows, W floats a row: 16 bytes a copy where W and the addresses
// allow it.
__device__ __forceinline__ void stage_rows(float* srows, const float* src,
                                           const int* list, int nr, int W,
                                           int stride, int vec) {
  if (vec && (W & 3) == 0) {
    const int ch = W / 4;
    for (int i = threadIdx.x; i < nr * ch; i += blockDim.x) {
      const int r = i / ch, c = i - r * ch;
      cp_async16(srows + r * W + 4 * c,
                 src + (size_t)list[r] * stride + 4 * c);
    }
  } else {
    for (int i = threadIdx.x; i < nr * W; i += blockDim.x) {
      const int r = i / W, c = i - r * W;
      cp_async4(srows + i, src + (size_t)list[r] * stride + c);
    }
  }
}

// Stores a thread's item: for each o, its BV batch rows of du[l, o, n]
// at dst (one 16-byte store where BV = 4).
template <int O, int BV>
__device__ __forceinline__ void store_item(float* dst, size_t plane,
                                           const float (&acc)[BV * O]) {
#pragma unroll
  for (int o = 0; o < O; ++o) {
    if constexpr (BV == 4)
      *reinterpret_cast<float4*>(dst + o * plane) =
          make_float4(acc[o], acc[O + o], acc[2 * O + o], acc[3 * O + o]);
    else
      dst[o * plane] = acc[o];
  }
}

// One block per (run, batch slice of Bs rows); pos [L, 4]: each
// position's main K (0: the identity) and its tiers' K. A thread's item
// is BV consecutive batch rows of one (position, vertex): BV = 4 (16-byte
// loads and stores) where O <= 4 and the slice's width, B and the
// pointers allow it, else 1.
template <int O, int BV>
__global__ void __launch_bounds__(kMaxBwdThreads)
out_gather_sum_bwd_kernel(const float* __restrict__ dout,
                          const int* __restrict__ starts,
                          const int* __restrict__ rows,
                          const int* __restrict__ row_off,
                          const int* __restrict__ blob,
                          const int* __restrict__ blob_off,
                          const int* __restrict__ pos,
                          float* __restrict__ du, int N, int L, int B,
                          int Bs, int vec) {
  extern __shared__ __align__(16) int smem[];
  const int t = blockIdx.x;
  const int b0 = blockIdx.y * Bs;
  const int bw = min(Bs, B - b0);
  const int W = bw * O;                      // floats of a staged row
  const int n0 = __ldg(starts + t), nv = __ldg(starts + t + 1) - n0;
  const int r0 = __ldg(row_off + t), nr = __ldg(row_off + t + 1) - r0;
  const int w0 = __ldg(blob_off + t), nw = __ldg(blob_off + t + 1) - w0;
  // shared memory: the run's blob, its row list, then the staged rows.
  // The lists come first, in one round trip, so that no row's copy
  // waits on a load of its index.
  int* slist = smem + nw;
  float* srows = reinterpret_cast<float*>(slist + ((nr + 3) & ~3));
  for (int i = threadIdx.x; i < nw / 4; i += blockDim.x)
    cp_async16(smem + 4 * i, blob + w0 + 4 * i);
  for (int i = threadIdx.x; i < nr; i += blockDim.x)
    cp_async4(slist + i, rows + r0 + i);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  stage_rows(srows, dout + (size_t)b0 * O, slist, nr, W, B * O, vec);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const unsigned short* ent =
      reinterpret_cast<const unsigned short*>(smem + nv * L);
  const size_t plane = (size_t)N * B;        // floats of one (l, o)
  // item j = (l · nv + i) · gw + g (batch rows BV·g on), walked
  // blockDim.x at a time
  const int gw = bw / BV, nvg = nv * gw;
  int l = threadIdx.x / nvg;
  int r = threadIdx.x - l * nvg;
  int i = r / gw, g = r - i * gw;
  const int step_i = blockDim.x / gw, step_g = blockDim.x - step_i * gw;
  while (l < L) {
    const int h = smem[l * nv + i];
    const unsigned short* e = ent + (h >> 2);
    const int K = __ldg(pos + 4 * l);
    const float* x = srows + g * BV * O;
    float acc[BV * O];
    if (K == 0) {                            // the identity position
      load_rows<O, BV>(x + (e[0] & 0x7fff) * W, acc);
    } else {
      entry_sum<O, BV>(e, K, x, W, acc);
      e += K;
      for (int q = 0; q < (h & 3); ++q) {
        const int tk = __ldg(pos + 4 * l + 1 + q);
        float sum[BV * O];
        entry_sum<O, BV>(e, tk, x, W, sum);
        e += tk;
#pragma unroll
        for (int k = 0; k < BV * O; ++k) acc[k] = __fadd_rn(acc[k], sum[k]);
      }
    }
    store_item<O, BV>(du + (size_t)l * O * plane + (size_t)(n0 + i) * B +
                          b0 + g * BV,
                      plane, acc);
    g += step_g;
    if (g >= gw) { g -= gw; ++i; }
    i += step_i;
    if (i >= nv) { l += i / nv; i -= (i / nv) * nv; }
  }
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

template <int O, int BV>
int launch_bwd_bv(const float* dout, const int* starts, const int* rows,
                  const int* row_off, const int* blob, const int* blob_off,
                  const int* pos, float* du, int n_runs, int N, int L, int B,
                  int Bs, int threads, int smem, int vec, cudaStream_t st) {
  static int smem_done = 0;
  const int rc = set_smem(out_gather_sum_bwd_kernel<O, BV>, smem,
                          smem_done);
  if (rc) return rc;
  out_gather_sum_bwd_kernel<O, BV>
      <<<dim3(n_runs, (B + Bs - 1) / Bs), threads, smem, st>>>(
          dout, starts, rows, row_off, blob, blob_off, pos, du, N, L, B, Bs,
          vec);
  return static_cast<int>(cudaGetLastError());
}

template <int O>
int launch_bwd(const float* dout, const int* starts, const int* rows,
               const int* row_off, const int* blob, const int* blob_off,
               const int* pos, float* du, int n_runs, int N, int L, int B,
               int Bs, int threads, int smem, int vec, cudaStream_t st) {
  if constexpr (O <= 4) {
    if (vec && B % 4 == 0 && Bs % 4 == 0 && !misaligned(du))
      return launch_bwd_bv<O, 4>(dout, starts, rows, row_off, blob,
                                 blob_off, pos, du, n_runs, N, L, B, Bs,
                                 threads, smem, vec, st);
  }
  return launch_bwd_bv<O, 1>(dout, starts, rows, row_off, blob, blob_off,
                             pos, du, n_runs, N, L, B, Bs, threads, smem,
                             vec, st);
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

// K3b's backward: du [L, O, N, B] from dout [M, B, O] through the runs
// (starts, rows, row_off, blob, blob_off, pos; see ops.OutGatherRuns),
// one block of `threads` per run and batch slice of Bs rows, `smem`
// bytes of dynamic shared memory (the largest run's lists and staged
// rows at Bs), `vec` 1 where dout lies on 16 bytes (its rows then go by
// 16-byte copies where B·O and Bs·O are multiples of 4). An identity
// position (K = 0) needs N == M. Returns a cudaError_t.
extern "C" int cfs_out_gather_sum_bwd(const float* dout, const int* starts,
                                      const int* rows, const int* row_off,
                                      const int* blob, const int* blob_off,
                                      const int* pos, float* du, int n_runs,
                                      int M, int N, int L, int B, int O,
                                      int Bs, int threads, int smem, int vec,
                                      void* stream) {
  if (n_runs < 1 || M < 1 || N < 1 || L < 1 ||
      B < 1 || O < 1 || O > kMaxO || Bs < 1 || Bs > B ||
      (B + Bs - 1) / Bs > 65535 || threads < 32 ||
      threads > kMaxBwdThreads || threads % 32 || smem < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  vec = vec && (B * O) % 4 == 0 && (Bs * O) % 4 == 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define K3B_BWD(OO)                                                         \
  return launch_bwd<OO>(dout, starts, rows, row_off, blob, blob_off, pos, \
                        du, n_runs, N, L, B, Bs, threads, smem, vec, st)
  switch (O) {
    case 1: K3B_BWD(1);
    case 2: K3B_BWD(2);
    case 3: K3B_BWD(3);
    case 4: K3B_BWD(4);
    case 5: K3B_BWD(5);
    case 6: K3B_BWD(6);
    case 7: K3B_BWD(7);
    default: K3B_BWD(8);
  }
#undef K3B_BWD
}

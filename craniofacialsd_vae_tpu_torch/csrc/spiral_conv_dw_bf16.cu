// K2-dW-bf16: the spiral convolution's weight gradient for bf16 x and dy,
// fp32 accumulation, rounded to bf16 once.
//
//   dW[l] = bf16( sum over the M·B rows (m, b) of x[table[m, l], b, :]^T dy[m, b, :] )
//
// Replaces the dW einsums of craniofacialsd_vae_tpu/ops/spiral_conv.py::
// _score_bwd (lines 206-213: preferred_element_type=float32, then one
// astype to bf16) under the `mixed` and `bfloat16` policies: the backward
// of every bf16 conv of a training step, and of the final conv when it
// runs gather-first (K3a).
//
// The reduction runs over rows, which are neither x's nor dy's contiguous
// dimension. A block stages tiles of 64 rows of the gathered x and of dy
// in shared memory as they lie in device memory, row-major (a row's 16-byte
// pieces by cp.async, all in flight at once; two stages, so that the next
// tile arrives while this one is multiplied), and reads the mma's A (x^T,
// channels x rows) and B (rows x C_out) fragments with transposing
// ldmatrix loads. Row strides are an odd number of 16-byte units, so the 8
// rows of an ldmatrix hit 8 distinct bank groups. Rows narrower than 8
// channels or off 16 bytes (3-channel data, the final conv's 3-channel dy)
// are staged value by value instead. Grid (chunks, L): a block owns one
// spiral position and one chunk of whole vertices, and its 4 warps share
// the position's 16 x 8 output fragments round robin, each in fp32
// registers over all of the chunk's tiles. Each chunk's fp32 partial goes
// to a scratch buffer; a second kernel sums the chunks in chunk order and
// rounds once. No atomics: the result is the same every run, and the plain
// twin ops/spiral_conv.py::spiral_conv_dw_chunked_plain sums the chunks in
// the same order (inside a chunk the tensor cores' order differs from the
// twin's matmul: fp32 rounding, within one bf16 ulp after the rounding).
//
// What bounds it on an H100: bytes at these widths (2·C_in·C_out flops per
// row of 2·(C_in + C_out) bytes; x rows are gathered L times, from L2).

#include "bf16.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;            // rows per staged tile

// a row stride of `width` bf16 values and more, an odd number of 16-byte
// units (kernels.py's _dw_bf16_stride)
__host__ __device__ __forceinline__ int odd_stride(int width) {
  const int units = (width + 7) / 8;
  return 8 * (units % 2 ? units : units + 1);
}

// Issues the copies of rows [rt, rt + 64) of one operand into `dst`
// ([64][ld] bf16): by cp.async in 16-byte pieces where `vec`, value by
// value otherwise; channels from `c` on and rows from `r1` on are zero.
// `table` (with position l and batch B) gathers x's rows; null: dy's.
__device__ __forceinline__ void stage(uint16_t* dst, int ld, int width,
                                      const __nv_bfloat16* __restrict__ src,
                                      int c, bool vec,
                                      const int* __restrict__ table, int l,
                                      int L, int B, int rt, int r1) {
  const int pieces = width / 8;
  for (int i = threadIdx.x; i < kTile * pieces; i += kThreads) {
    const int rr = i / pieces;
    const int j = i - rr * pieces;
    const int r = rt + rr;
    uint16_t* d = dst + rr * ld + 8 * j;
    if (r >= r1 || 8 * j >= c) {
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
      continue;
    }
    size_t row = r;
    if (table) {
      const int m = r / B;
      row = (size_t)__ldg(table + (size_t)m * L + l) * B + (r - m * B);
    }
    const __nv_bfloat16* s = src + row * c + 8 * j;
    if (vec) {
      cp_async16(d, s);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        d[e] = 8 * j + e < c ? bf16_bits(s[e]) : 0;
    }
  }
}

template <int FPW>
__global__ void __launch_bounds__(kThreads)
spiral_conv_dw_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                           const int* __restrict__ table,
                           const __nv_bfloat16* __restrict__ dy,
                           float* __restrict__ part, int M, int L, int B,
                           int C_in, int C_out, int fm, int fn, int chunk_v,
                           int vec_x, int vec_d) {
  extern __shared__ __align__(16) uint16_t smem[];
  const int ldx = odd_stride(16 * fm), ldd = odd_stride(8 * fn);
  const int per_stage = kTile * (ldx + ldd);
  const int l = blockIdx.y;
  const int chunk = blockIdx.x;
  const int v0 = chunk * chunk_v;
  const int r0 = v0 * B, r1 = min(M, v0 + chunk_v) * B;
  const int n_tiles = (r1 - r0 + kTile - 1) / kTile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int frags = fm * fn;
  // ldmatrix rows of this lane: A's matrix q = lane / 8 is (rows 8·(q/2),
  // channels 8·(q%2)) of a 16 x 16 block; B's (lanes 0-15) rows 8·(q%2)
  const int a_row = ((lane >> 4) << 3) + (lane & 7), a_col = (lane >> 3 & 1) << 3;
  const int b_row = ((lane >> 3 & 1) << 3) + (lane & 7);

  float acc[FPW][4];
#pragma unroll
  for (int i = 0; i < FPW; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  auto issue = [&](int t) {
    uint16_t* sx = smem + (t & 1) * per_stage;
    const int rt = r0 + t * kTile;
    stage(sx, ldx, 16 * fm, x, C_in, vec_x, table, l, L, B, rt, r1);
    stage(sx + kTile * ldx, ldd, 8 * fn, dy, C_out, vec_d, nullptr, l, L,
          B, rt, r1);
    cp_async_commit();
  };

  if (n_tiles > 0) issue(0);
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      issue(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint16_t* sx = smem + (t & 1) * per_stage;
    const uint16_t* sd = sx + kTile * ldx;
#pragma unroll
    for (int ks = 0; ks < kTile / 16; ++ks) {
#pragma unroll
      for (int i = 0; i < FPW; ++i) {
        const int f = warp + kWarps * i;
        if (f >= frags) break;
        const int fmi = f / fn, fni = f - fmi * fn;
        uint32_t a[4], b0, b1;
        ldsm_x4_trans(a, sx + (ks * 16 + a_row) * ldx + fmi * 16 + a_col);
        ldsm_x2_trans(b0, b1, sd + (ks * 16 + b_row) * ldd + fni * 8);
        mma_bf16(acc[i], a, b0, b1);
      }
    }
    __syncthreads();                 // before the stage is refilled
  }
  float* dst = part + ((size_t)chunk * L + l) * C_in * C_out;
#pragma unroll
  for (int i = 0; i < FPW; ++i) {
    const int f = warp + kWarps * i;
    if (f >= frags) break;
    const int fmi = f / fn, fni = f - fmi * fn;
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int c = fmi * 16 + gid + (h < 2 ? 0 : 8);
      const int o = fni * 8 + 2 * tig + (h & 1);
      if (c < C_in && o < C_out) dst[(size_t)c * C_out + o] = acc[i][h];
    }
  }
}

// out[i] = bf16(sum over chunks, in chunk order, of part[chunk][i])
__global__ void __launch_bounds__(256)
spiral_conv_dw_bf16_sum(const float* __restrict__ part,
                        __nv_bfloat16* __restrict__ out, int n_chunks, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = part[i];
  for (int c = 1; c < n_chunks; ++c) s = __fadd_rn(s, part[(size_t)c * n + i]);
  out[i] = __float2bfloat16_rn(s);
}

template <int FPW>
int launch(const __nv_bfloat16* x, const int* table, const __nv_bfloat16* dy,
           float* part, int M, int L, int B, int C_in, int C_out, int fm,
           int fn, int chunk_v, int n_chunks, int smem, int vec_x, int vec_d,
           cudaStream_t s) {
  static int done = 0;
  const int e = set_smem(spiral_conv_dw_bf16_kernel<FPW>, smem, done);
  if (e) return e;
  spiral_conv_dw_bf16_kernel<FPW><<<dim3(n_chunks, L), kThreads, smem, s>>>(
      x, table, dy, part, M, L, B, C_in, C_out, fm, fn, chunk_v, vec_x,
      vec_d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K2-dW-bf16 for x [N_src, B, C_in], table [M, L], dy [M, B, C_out] (x, dy
// bf16); part: n_chunks·L·C_in·C_out floats of scratch; out [L, C_in,
// C_out] bf16. The plan (kernels.py, plan_spiral_conv_dw_bf16): fpw
// fragments per warp at most (1, 2, 4, 8, 16 or 32, 4·fpw >= ceil(C_in /
// 16)·ceil(C_out / 8)), chunk_v vertices per chunk, n_chunks = ceil(M /
// chunk_v), smem = 2 stages of 64 rows of both operands' strides, bytes.
// Returns a cudaError_t.
extern "C" int cfs_spiral_conv_dw_bf16(const void* x, const int* table,
                                       const void* dy, float* part, void* out,
                                       int M, int L, int B, int C_in,
                                       int C_out, int fpw, int chunk_v,
                                       int n_chunks, int smem, void* stream) {
  const int fm = (C_in + 15) / 16, fn = (C_out + 7) / 8;
  const int need = 2 * kTile * (odd_stride(16 * fm) + odd_stride(8 * fn)) * 2;
  if (M < 1 || L < 1 || L > 65535 || B < 1 || C_in < 1 || C_out < 1 ||
      chunk_v < 1 || n_chunks != (M + chunk_v - 1) / chunk_v ||
      kWarps * fpw < fm * fn || smem < need || smem > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* db = static_cast<const __nv_bfloat16*>(dy);
  // 16-byte pieces where a row is whole pieces on 16-byte boundaries
  const int vec_x = C_in % 8 == 0 && !misaligned(x);
  const int vec_d = C_out % 8 == 0 && !misaligned(dy);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int (*run)(const __nv_bfloat16*, const int*, const __nv_bfloat16*, float*,
             int, int, int, int, int, int, int, int, int, int, int, int,
             cudaStream_t);
  switch (fpw) {
    case 1: run = launch<1>; break;
    case 2: run = launch<2>; break;
    case 4: run = launch<4>; break;
    case 8: run = launch<8>; break;
    case 16: run = launch<16>; break;
    case 32: run = launch<32>; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  const int e = run(xb, table, db, part, M, L, B, C_in, C_out, fm, fn,
                    chunk_v, n_chunks, smem, vec_x, vec_d, s);
  if (e) return e;
  const int n = L * C_in * C_out;
  spiral_conv_dw_bf16_sum<<<(n + 255) / 256, 256, 0, s>>>(
      part, static_cast<__nv_bfloat16*>(out), n_chunks, n);
  return static_cast<int>(cudaGetLastError());
}

// K1-bf16 and K3a: the spiral convolution with bf16 operands on the
// tensor cores, fp32 accumulators.
//
//   acc[m, b, :] = float(bias) + sum_l x[table[m, l], b, :] @ W_l      (fp32)
//   out = bf16(acc)          K1-bf16: _spiral_conv_core's bf16 branch
//   out = acc                K3a: _spiral_conv_core_f32out (unrounded)
//
// Replaces craniofacialsd_vae_tpu/ops/spiral_conv.py::_spiral_conv_core
// (lines 160-169, XLA einsums with preferred_element_type=float32) and
// _spiral_conv_core_f32out (lines 266-275) under the `mixed` and
// `bfloat16` policies: encoder convs 1-3, the four decoder convs, the final
// conv when it runs gather-first, and under `bfloat16` the first conv.
//
// The product is a GEMM of M·B rows by C_out columns over a depth of
// L·C_in, whose A rows are gathered: row (m, b) at depth l·C_in + c is
// x[table[m, l], b, c]. Each warp owns 16 rows and all of C_out (NT tiles
// of 8 columns, fp32 accumulators in registers, started from the bias) and
// walks the depth 16 at a time with mma.sync m16n8k16 bf16. W, small, is
// staged once per block in shared memory as it lies in device memory,
// [L·C_in rows, padded to 16][ldw] (16-byte pieces by cp.async, all in
// flight at once, where C_out fills its 8-column tiles and W starts on 16
// bytes; value by value otherwise), with ldw an odd number of 16-byte
// units, and the B fragments come from it by transposing ldmatrix loads,
// conflict-free; the blocks are persistent and walk the row tiles. The A
// fragments come straight from device memory:
//
// - vector path (C_in % 16 == 0, x on 4 bytes): a 16-deep step lies in one
//   spiral position, and each register is one 32-bit load of two
//   neighbouring channels of one gathered row (the 4 lanes of a row read
//   one 32-byte sector);
// - element path (any C_in: the `bfloat16` first conv's 3 channels, 6
//   bytes a row, which no wider load can take): each bf16 value of the
//   fragment is loaded on its own, depth k -> (l, c) = (k / C_in, k % C_in),
//   depth beyond L·C_in reading 0.
//
// What bounds it on an H100: at the model's widths (C_in, C_out <= 64)
// bytes, 2·L·C_in·C_out flops for each 2·C_out bytes written and 2·C_in
// bytes of each source row; the design reads each gathered row from L2
// per position, as the twin does, and does not stage rows in shared
// memory (a later redesign's work). The bias is added first and the L
// position products after it in one fp32 accumulator; the plain twin sums
// per position, so the two agree to fp32 rounding, within one bf16 ulp
// after the final rounding.

#include "bf16.cuh"

namespace {

constexpr int kThreads = 256;

// the bf16 value at depth k of gathered row (m, b), 0 beyond the depth
__device__ __forceinline__ uint16_t elem(const __nv_bfloat16* __restrict__ x,
                                         const int* __restrict__ trow, int b,
                                         int B, int C_in, int K, int k) {
  if (k >= K) return 0;
  const int l = k / C_in;
  const int c = k - l * C_in;
  return bf16_bits(x[((size_t)__ldg(trow + l) * B + b) * C_in + c]);
}

// B fragments (b0, b1) of column tiles nt and nt + 1 at depth step ks
// from W staged k-major: matrix q of the ldmatrix is (rows 8·(q%2),
// columns 8·(q/2)) of the 16 x 16 block
__device__ __forceinline__ void w_frags(const uint16_t* ws, int ldw, int ks,
                                        int nt, int lane, uint32_t (&b)[4]) {
  const int row = ks * 16 + ((lane >> 3 & 1) << 3) + (lane & 7);
  ldsm_x4_trans(b, ws + row * ldw + nt * 8 + ((lane >> 4) << 3));
}

__device__ __forceinline__ void w_frags1(const uint16_t* ws, int ldw, int ks,
                                         int nt, int lane, uint32_t& b0,
                                         uint32_t& b1) {
  const int row = ks * 16 + ((lane >> 3 & 1) << 3) + (lane & 7);
  ldsm_x2_trans(b0, b1, ws + row * ldw + nt * 8);
}

template <int NT, bool ELEM>
__global__ void __launch_bounds__(kThreads)
spiral_conv_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                        const int* __restrict__ table,
                        const __nv_bfloat16* __restrict__ w,
                        const __nv_bfloat16* __restrict__ bias,
                        void* __restrict__ out, int M, int L, int B, int C_in,
                        int C_out, int ksteps, int ldw, int f32out,
                        int w_vec) {
  extern __shared__ __align__(16) uint16_t ws[];   // [ksteps·16][ldw]
  const int K = L * C_in;
  if (w_vec) {                           // C_out == 8·NT, W on 16 bytes
    const int pieces = C_out / 8;
    for (int i = threadIdx.x; i < ksteps * 16 * pieces; i += blockDim.x) {
      const int k = i / pieces;
      const int j = i - k * pieces;
      uint16_t* d = ws + k * ldw + 8 * j;
      if (k < K)
        cp_async16(d, w + (size_t)k * C_out + 8 * j);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
    }
    cp_async_commit();
    cp_async_wait<0>();
  } else {
    for (int i = threadIdx.x; i < ksteps * 16 * 8 * NT; i += blockDim.x) {
      const int k = i / (8 * NT);
      const int o = i - k * (8 * NT);
      ws[k * ldw + o] = k < K && o < C_out
                            ? bf16_bits(w[(size_t)k * C_out + o]) : 0;
    }
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int warps = blockDim.x >> 5;
  const int rows = M * B;
  const int n_tiles = (rows + 15) >> 4;
  for (int t = blockIdx.x * warps + (threadIdx.x >> 5); t < n_tiles;
       t += gridDim.x * warps) {
    const int ra = t * 16 + gid, rb = ra + 8;
    const int ca = min(ra, rows - 1), cb = min(rb, rows - 1);
    const int ma = ca / B, ba = ca - ma * B;
    const int mb = cb / B, bb = cb - mb * B;
    const int* ta = table + (size_t)ma * L;
    const int* tb = table + (size_t)mb * L;
    float acc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = nt * 8 + 2 * tig;
      const float b0 = col < C_out ? __bfloat162float(bias[col]) : 0.f;
      const float b1 = col + 1 < C_out ? __bfloat162float(bias[col + 1]) : 0.f;
      acc[nt][0] = b0;
      acc[nt][1] = b1;
      acc[nt][2] = b0;
      acc[nt][3] = b1;
    }
    if (!ELEM) {
      const int cs_n = C_in >> 4;
      for (int l = 0; l < L; ++l) {
        const uint32_t* pa = reinterpret_cast<const uint32_t*>(
            x + ((size_t)__ldg(ta + l) * B + ba) * C_in);
        const uint32_t* pb = reinterpret_cast<const uint32_t*>(
            x + ((size_t)__ldg(tb + l) * B + bb) * C_in);
        for (int cs = 0; cs < cs_n; ++cs) {
          uint32_t a[4];
          a[0] = __ldg(pa + cs * 8 + tig);
          a[1] = __ldg(pb + cs * 8 + tig);
          a[2] = __ldg(pa + cs * 8 + 4 + tig);
          a[3] = __ldg(pb + cs * 8 + 4 + tig);
          const int ks = l * cs_n + cs;
#pragma unroll
          for (int nt = 0; nt + 1 < NT; nt += 2) {
            uint32_t b[4];
            w_frags(ws, ldw, ks, nt, lane, b);
            mma_bf16(acc[nt], a, b[0], b[1]);
            mma_bf16(acc[nt + 1], a, b[2], b[3]);
          }
          if (NT % 2) {
            uint32_t b0, b1;
            w_frags1(ws, ldw, ks, NT - 1, lane, b0, b1);
            mma_bf16(acc[NT - 1], a, b0, b1);
          }
        }
      }
    } else {
      for (int ks = 0; ks < ksteps; ++ks) {
        const int k0 = ks * 16 + 2 * tig;
        uint32_t a[4];
        a[0] = pack_bf16(elem(x, ta, ba, B, C_in, K, k0),
                         elem(x, ta, ba, B, C_in, K, k0 + 1));
        a[1] = pack_bf16(elem(x, tb, bb, B, C_in, K, k0),
                         elem(x, tb, bb, B, C_in, K, k0 + 1));
        a[2] = pack_bf16(elem(x, ta, ba, B, C_in, K, k0 + 8),
                         elem(x, ta, ba, B, C_in, K, k0 + 9));
        a[3] = pack_bf16(elem(x, tb, bb, B, C_in, K, k0 + 8),
                         elem(x, tb, bb, B, C_in, K, k0 + 9));
#pragma unroll
        for (int nt = 0; nt + 1 < NT; nt += 2) {
          uint32_t b[4];
          w_frags(ws, ldw, ks, nt, lane, b);
          mma_bf16(acc[nt], a, b[0], b[1]);
          mma_bf16(acc[nt + 1], a, b[2], b[3]);
        }
        if (NT % 2) {
          uint32_t b0, b1;
          w_frags1(ws, ldw, ks, NT - 1, lane, b0, b1);
          mma_bf16(acc[NT - 1], a, b0, b1);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = nt * 8 + 2 * tig;
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int r = h < 2 ? ra : rb;
        const int c = col + (h & 1);
        if (r >= rows || c >= C_out) continue;
        const size_t o = (size_t)r * C_out + c;
        if (f32out)
          static_cast<float*>(out)[o] = acc[nt][h];
        else
          static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(acc[nt][h]);
      }
    }
  }
}

template <int NT, bool ELEM>
int launch(const __nv_bfloat16* x, const int* table, const __nv_bfloat16* w,
           const __nv_bfloat16* b, void* out, int M, int L, int B, int C_in,
           int C_out, int ksteps, int ldw, int blocks, int smem, int f32out,
           cudaStream_t s) {
  static int done = 0;
  const int e = set_smem(spiral_conv_bf16_kernel<NT, ELEM>, smem, done);
  if (e) return e;
  const int w_vec = C_out == 8 * NT && !misaligned(w);
  spiral_conv_bf16_kernel<NT, ELEM><<<blocks, kThreads, smem, s>>>(
      x, table, w, b, out, M, L, B, C_in, C_out, ksteps, ldw, f32out, w_vec);
  return static_cast<int>(cudaGetLastError());
}

template <bool ELEM>
int launch_nt(int nt, const __nv_bfloat16* x, const int* table,
              const __nv_bfloat16* w, const __nv_bfloat16* b, void* out, int M,
              int L, int B, int C_in, int C_out, int ksteps, int ldw,
              int blocks, int smem, int f32out, cudaStream_t s) {
  switch (nt) {
    case 1: return launch<1, ELEM>(x, table, w, b, out, M, L, B, C_in, C_out,
                                   ksteps, ldw, blocks, smem, f32out, s);
    case 2: return launch<2, ELEM>(x, table, w, b, out, M, L, B, C_in, C_out,
                                   ksteps, ldw, blocks, smem, f32out, s);
    case 4: return launch<4, ELEM>(x, table, w, b, out, M, L, B, C_in, C_out,
                                   ksteps, ldw, blocks, smem, f32out, s);
    case 8: return launch<8, ELEM>(x, table, w, b, out, M, L, B, C_in, C_out,
                                   ksteps, ldw, blocks, smem, f32out, s);
    case 16: return launch<16, ELEM>(x, table, w, b, out, M, L, B, C_in, C_out,
                                     ksteps, ldw, blocks, smem, f32out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// K1-bf16 (f32out = 0: bf16 out) and K3a (f32out = 1: fp32 out) for
// x [N_src, B, C_in], table [M, L], w [L, C_in, C_out], b [C_out], all
// bf16 but the table; out [M, B, C_out]. The plan (kernels.py,
// plan_spiral_conv with dtype bfloat16): nt column tiles of 8 (1, 2, 4, 8
// or 16, 8·nt >= C_out), elem (the element path), ksteps = ceil(L·C_in /
// 16), ldw (bf16 values, >= 8·nt, an odd number of 16-byte units), blocks
// and smem (ksteps·16·ldw·2 bytes). Returns a cudaError_t.
extern "C" int cfs_spiral_conv_bf16(const void* x, const int* table,
                                    const void* w, const void* b, void* out,
                                    int M, int L, int B, int C_in, int C_out,
                                    int nt, int elem, int ksteps, int ldw,
                                    int blocks, int smem, int f32out,
                                    void* stream) {
  if (M < 1 || L < 1 || B < 1 || C_in < 1 || C_out < 1 || C_out > 8 * nt ||
      ksteps * 16 < L * C_in || ldw < 8 * nt || ldw % 16 != 8 ||
      blocks < 1 || smem < ksteps * 16 * ldw * 2 || (!elem && C_in % 16) ||
      (!elem && reinterpret_cast<uintptr_t>(x) % 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  const auto* bb = static_cast<const __nv_bfloat16*>(b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return elem ? launch_nt<true>(nt, xb, table, wb, bb, out, M, L, B, C_in,
                                C_out, ksteps, ldw, blocks, smem, f32out, s)
              : launch_nt<false>(nt, xb, table, wb, bb, out, M, L, B, C_in,
                                 C_out, ksteps, ldw, blocks, smem, f32out, s);
}

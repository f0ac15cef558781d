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
// bytes of each source row; this kernel reads each gathered row from L2
// per position, as the twin does. The bias is added first and the L
// position products after it in one fp32 accumulator; the plain twin sums
// per position, so the two agree to fp32 rounding, within one bf16 ulp
// after the final rounding.
//
// The final conv's shape (L = 9, C_in = 32, C_out < 8), gather-first
// under bf16 (K3a, the vertex tiles given: spiral_conv_bf16_tile_kernel).
// Above, its A rows would cross from L2 to the SMs once per position
// (9 x 17.4 MB at B = 16) and 5/8 of each 8-column tile would be
// padding. The tiled kernel takes K1 narrow's vertex tiles
// (ops.SpiralTiles: compact patches whose distinct source rows each serve
// about 4 spiral entries, at most 64 rows and 64 vertices a tile): one
// block of four warps per (tile, batch tile) copies the tile's rows for
// its batch rows into shared memory once (cp.async, 16 bytes where x
// lies on 16, else 4; each thread loads the source indices of 8 copies
// before it issues them), each (row, batch) entry at a stride of five
// 16-byte units (odd: the 8 rows of an ldmatrix that are 8 batch rows of
// one source row hit 8 distinct bank groups), and the tile's rows of
// `local` and `verts` beside them, so the products' loop reads no table
// from device memory. W, 288 x C_out, is padded to 8 columns in shared
// memory. The warps walk 16-row tiles of the tile's (vertex, batch)
// rows, vertex-major: per spiral position each lane gives ldmatrix its
// row's staged entry, local[v, l], one transposing ldmatrix gives the
// position's two k16 steps of W, and two mma.sync take its 32 channels,
// into two accumulators (the bias in the first) added at the end. The
// used columns are written as fp32 (or rounded to bf16). What bounds it
// (PERF.md, k3a_parts): the chain of dependent loads each block starts
// with (its tile's offsets, then its source indices, then the copies),
// more than the copies or the products.

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

constexpr int kTileL = 9;            // the final conv's shape (kernels.py
constexpr int kTileCin = 32;         // _TILE_SHAPE)
constexpr int kTileDepth = kTileL * kTileCin;
constexpr int kCopyBatch = 8;        // copies whose indices load together
constexpr int kTileVerts = 64;       // most vertices a tile owns
//                                      (ops/spiral_conv.py _TILE_VERTICES)
constexpr int kTileStride = 40;      // bf16 values a staged (row, batch)
constexpr int kTileThreads = 128;    // four warps a block (kernels.py
//                                      _BF16_TILE_THREADS)

template <bool VEC>
__device__ __forceinline__ void cp_async_piece(void* dst, const void* src) {
  if (VEC)
    cp_async16(dst, src);
  else
    cp_async4(dst, src);
}

// One block per (vertex tile, batch tile): see the header. VEC: x on 16
// bytes (16-byte copies), else 4-byte copies.
template <bool VEC>
__global__ void __launch_bounds__(kTileThreads)
spiral_conv_bf16_tile_kernel(const __nv_bfloat16* __restrict__ x,
                             const int* __restrict__ verts,
                             const int* __restrict__ starts,
                             const int* __restrict__ src,
                             const int* __restrict__ src_off,
                             const int* __restrict__ local,
                             const __nv_bfloat16* __restrict__ w,
                             const __nv_bfloat16* __restrict__ bias,
                             void* __restrict__ out, int B, int C_out, int TB,
                             int n_btiles, int f32out) {
  extern __shared__ __align__(16) int smem[];
  int* ls = smem;                               // local [kTileVerts][L]
  int* vs = ls + kTileVerts * kTileL;           // verts [kTileVerts]
  uint16_t* ws = reinterpret_cast<uint16_t*>(vs + kTileVerts);
  //                                               W [kTileDepth][8]
  uint16_t* xs = ws + kTileDepth * 8;           // [rows][TB][kTileStride]
  const int t = blockIdx.x / n_btiles;
  const int b0 = (blockIdx.x - t * n_btiles) * TB;
  const int tb = min(TB, B - b0);
  const int s0 = __ldg(src_off + t);
  const int rows = __ldg(src_off + t + 1) - s0;
  const int v0 = __ldg(starts + t);
  const int nv = __ldg(starts + t + 1) - v0;    // at most kTileVerts
  // the tile's rows of local and verts, beside its source rows: no
  // dependent load of the table remains in the products' loop
  for (int i = threadIdx.x; i < nv * (kTileL + 1); i += blockDim.x) {
    if (i < nv * kTileL)
      cp_async4(ls + i, local + (size_t)v0 * kTileL + i);
    else
      cp_async4(vs + i - nv * kTileL, verts + v0 + i - nv * kTileL);
  }
  // copy k of rows·per_row: piece j of source row d, whose tb batch rows
  // lie contiguous in x; d = k / per_row through a float reciprocal,
  // exact for these sizes (k < 2^15, per_row <= 256). kCopyBatch copies'
  // source indices load before their cp.async are issued (a cp.async is
  // a compiler barrier, so a load after one waits for the one before)
  constexpr int V = VEC ? 8 : 2;               // bf16 values a copy
  constexpr int SH = VEC ? 2 : 4;              // log2 of copies a (row, batch)
  const int per_row = tb << SH;
  const int total = rows * per_row;
  const float inv = 1.f / per_row;
  for (int k0 = threadIdx.x; k0 < total; k0 += kCopyBatch * blockDim.x) {
    int d[kCopyBatch], sr[kCopyBatch];
#pragma unroll
    for (int u = 0; u < kCopyBatch; ++u) {
      const int k = min(k0 + u * (int)blockDim.x, total - 1);
      d[u] = static_cast<int>((k + 0.5f) * inv);
      sr[u] = __ldg(src + s0 + d[u]);
    }
#pragma unroll
    for (int u = 0; u < kCopyBatch; ++u) {
      const int k = k0 + u * blockDim.x;
      if (k >= total) break;
      const int j = k - d[u] * per_row;
      const int b = j >> SH;
      cp_async_piece<VEC>(
          xs + (d[u] * TB + b) * kTileStride + (j - (b << SH)) * V,
          x + ((size_t)sr[u] * B + b0) * kTileCin + j * V);
    }
  }
  cp_async_commit();

  // W, padded to 8 columns, into shared memory while the copies are in
  // flight: every load of the thread's share first, then the stores
  const uint16_t* wb = reinterpret_cast<const uint16_t*>(w);
  constexpr int WPT = kTileDepth * 8 / kTileThreads;
  uint16_t wv[WPT];
#pragma unroll
  for (int u = 0; u < WPT; ++u) {
    const int i = threadIdx.x + u * kTileThreads;
    wv[u] = (i & 7) < C_out ? __ldg(wb + (i >> 3) * C_out + (i & 7)) : 0;
  }
#pragma unroll
  for (int u = 0; u < WPT; ++u) ws[threadIdx.x + u * kTileThreads] = wv[u];
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int col = 2 * tig;
  const float bias0 = col < C_out ? __bfloat162float(bias[col]) : 0.f;
  const float bias1 = col + 1 < C_out ? __bfloat162float(bias[col + 1]) : 0.f;

  const int n_rows = nv * tb;
  const int arow = (lane & 7) + ((lane >> 3) & 1) * 8;   // ldmatrix's row
  const int koff = (lane >> 4) * 8;                      // and depth half
  cp_async_wait<0>();
  __syncthreads();
  for (int mt = threadIdx.x >> 5; mt * 16 < n_rows; mt += blockDim.x >> 5) {
    // this lane's ldmatrix row (vertex v, batch row b) and the output rows
    // of its accumulators; two accumulators halve the chain of dependent
    // mmas
    const int r = min(mt * 16 + arow, n_rows - 1);
    const int v = r / tb;
    const int b = r - v * tb;
    const int* lv = ls + v * kTileL;
    size_t o[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int rr = min(mt * 16 + gid + 8 * q, n_rows - 1);
      const int vv = rr / tb;
      o[q] = ((size_t)vs[vv] * B + b0 + rr - vv * tb) * C_out;
    }
    float acc[2][4] = {{bias0, bias1, bias0, bias1}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int l = 0; l < kTileL; ++l) {
      // position l's two k16 steps of W: rows 32l .. 32l + 31
      uint32_t wf[4];
      ldsm_x4_trans(wf, ws + (32 * l + lane) * 8);
      const uint16_t* a_row = xs + (lv[l] * TB + b) * kTileStride + koff;
#pragma unroll
      for (int cs = 0; cs < kTileCin / 16; ++cs) {
        uint32_t a[4];
        ldsm_x4(a, a_row + cs * 16);
        mma_bf16(acc[cs], a, wf[2 * cs], wf[2 * cs + 1]);
      }
    }
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int c = col + (h & 1);
      if (mt * 16 + gid + 8 * (h >> 1) >= n_rows || c >= C_out) continue;
      const float sum = acc[0][h] + acc[1][h];
      const size_t e = o[h >> 1] + c;
      if (f32out)
        static_cast<float*>(out)[e] = sum;
      else
        static_cast<__nv_bfloat16*>(out)[e] = __float2bfloat16_rn(sum);
    }
  }
}

template <bool VEC>
int launch_tile(const __nv_bfloat16* x, const int* verts, const int* starts,
                const int* src, const int* src_off, const int* local,
                const __nv_bfloat16* w, const __nv_bfloat16* b, void* out,
                int B, int C_out, int TB, int n_btiles, int blocks,
                int threads, int smem, int f32out, cudaStream_t s) {
  static int done = 0;
  const int e = set_smem(spiral_conv_bf16_tile_kernel<VEC>, smem, done);
  if (e) return e;
  spiral_conv_bf16_tile_kernel<VEC><<<blocks, threads, smem, s>>>(
      x, verts, starts, src, src_off, local, w, b, out, B, C_out, TB,
      n_btiles, f32out);
  return static_cast<int>(cudaGetLastError());
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

// K3a (f32out = 1) and K1-bf16 (f32out = 0) at the final conv's shape
// (L = 9, C_in = 32, C_out <= 8) through the op's vertex tiles
// (ops.SpiralTiles: verts [M], starts and src_off [n_tiles + 1], src,
// local [M, L]): x [N_src, B, 32], w [9, 32, C_out], b [C_out] bf16, out
// [M, B, C_out]. The plan (kernels.py, plan_spiral_conv with dtype
// bfloat16 and the tiles, path bf16_tile): rows (the most source rows a
// tile stages), tb batch rows a block in n_btiles batch tiles, threads,
// smem (>= rows·tb·80 bytes, 2,560 for the tile's local and verts and
// 4,608 for W);
// every tile owns at most 64 vertices. Returns a cudaError_t.
extern "C" int cfs_spiral_conv_bf16_tile(
    const void* x, const int* verts, const int* starts, const int* src,
    const int* src_off, const int* local, const void* w, const void* b,
    void* out, int M, int L, int B, int C_in, int C_out, int n_tiles,
    int rows, int tb, int n_btiles, int threads, int smem, int f32out,
    void* stream) {
  if (M < 1 || L != kTileL || C_in != kTileCin || B < 1 || C_out < 1 ||
      C_out > 8 || n_tiles < 1 || rows < 1 || tb < 1 ||
      n_btiles != (B + tb - 1) / tb || threads != kTileThreads ||
      smem > 232448 ||
      (long long)smem < 2LL * rows * tb * kTileStride +
                            4LL * kTileVerts * (kTileL + 1) +
                            2LL * kTileDepth * 8 ||
      reinterpret_cast<uintptr_t>(x) % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  const auto* bb = static_cast<const __nv_bfloat16*>(b);
  const int blocks = n_tiles * n_btiles;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return misaligned(x)
             ? launch_tile<false>(xb, verts, starts, src, src_off, local, wb,
                                  bb, out, B, C_out, tb, n_btiles, blocks,
                                  threads, smem, f32out, s)
             : launch_tile<true>(xb, verts, starts, src, src_off, local, wb,
                                 bb, out, B, C_out, tb, n_btiles, blocks,
                                 threads, smem, f32out, s);
}

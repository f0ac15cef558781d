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
// x[table[m, l], b, c]. mma.sync m16n8k16 in bf16 takes it 16 rows by 8
// columns by 16 deep, fp32 accumulators started from the bias; the B
// fragments (W) come from shared memory by transposing ldmatrix loads.
// What bounds it on an H100: bytes at the model's widths (C_in, C_out <=
// 64), 2·L·C_in·C_out flops for each 2·C_out bytes written and 2·C_in
// bytes of each source row; what bounds the vector path as measured
// (PERF.md, bf16_parts) is its mma.sync products and each item's fixed
// cost, which add up. Three kernels:
//
// - the vector path (C_in % 16 == 0, x on 4 bytes, the op's vertex tiles
//   given: every bf16 conv of the `mixed` model),
//   spiral_conv_bf16_vec_kernel. Persistent blocks of eight warps; a
//   block owns a column slice of C_out, stages that slice of W once, and
//   walks its share of the items, each a (vertex tile, batch tile). The
//   tiles (ops.SpiralTiles: compact patches of at most 64 vertices whose
//   distinct source rows each serve about 4 of the tile's spiral entries
//   on the decoder's levels) let a block copy each source row of its
//   batch rows into shared memory once, rather than read it from L2 once
//   per position that names it (about 9 times). Two ring stages: an
//   item's rows (cp.async of 16 bytes, 4 where x is off 16 bytes; each
//   warp copies whole rows) and its tile's rows of `local` and `verts`
//   land while the item before it is multiplied, and the items' offsets
//   and source indices are copied into shared memory a step ahead of the
//   copies that need them, so no register waits on a load across items.
//   Each (row, batch) entry sits at a stride of C_in + 8 values, an odd
//   number of 16-byte units: the 8 rows of an ldmatrix that are 8 batch
//   rows of one source row hit 8 distinct bank groups; rows of different
//   source rows (batch tiles under 8) may share a group, a conflict that
//   stays.
//   The warps walk the item's (vertex, batch) rows vertex-major, MT 16-row
//   tiles at a time: per position each lane gives ldmatrix its row's
//   staged entry local[v, l], so the gather costs no copy, the position's
//   A fragments load before its products, and each k16 step's A
//   fragments serve the slice's NT column tiles. On small levels the
//   planner takes fat items (many batch rows) and splits C_out, then the
//   batch, across blocks so that the grid covers the card;
// - the element path (any C_in: the `bfloat16` first conv's 3 channels,
//   6 bytes a row, which no wider load can take; x off 4 bytes; no
//   tiles), spiral_conv_bf16_kernel: W, small, staged once per block in
//   shared memory, [L·C_in rows, padded to 16][ldw]; each warp owns 16
//   rows and all of C_out, and each bf16 value of the A fragment is loaded
//   from device memory on its own, depth k -> (l, c) = (k / C_in,
//   k % C_in), depth beyond L·C_in reading 0;
// - the final conv's shape (L = 9, C_in = 32, C_out < 8), gather-first
//   under bf16 (K3a, the vertex tiles given):
//   spiral_conv_bf16_tile_kernel, below.
//
// The bias is added first and the L position products after it in one
// fp32 accumulator; the plain twin sums per position, so the two agree to
// fp32 rounding, within one bf16 ulp after the final rounding.
//
// K3a, at the final conv's shape. Above, its A rows would cross from L2
// to the SMs once per position (9 x 17.4 MB at B = 16) and 5/8 of each
// 8-column tile would be padding. The tiled kernel takes K1 narrow's
// vertex tiles: one block of four warps per (tile, batch tile) copies the
// tile's rows for its batch rows into shared memory once (cp.async, 16
// bytes where x lies on 16, else 4; each thread loads the source indices
// of 8 copies before it issues them), each (row, batch) entry at a
// stride of five 16-byte units, and the tile's rows of `local` and
// `verts` beside them, so the products' loop reads no table from device
// memory. W, 288 x C_out, is padded to 8 columns in shared memory. The
// warps walk 16-row tiles of the tile's (vertex, batch) rows,
// vertex-major: per spiral position each lane gives ldmatrix its row's
// staged entry, local[v, l], one transposing ldmatrix gives the
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

// The element path (see the header): NT column tiles of 8 per warp.
template <int NT>
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

template <int NT>
int launch(const __nv_bfloat16* x, const int* table, const __nv_bfloat16* w,
           const __nv_bfloat16* b, void* out, int M, int L, int B, int C_in,
           int C_out, int ksteps, int ldw, int blocks, int smem, int f32out,
           cudaStream_t s) {
  static int done = 0;
  const int e = set_smem(spiral_conv_bf16_kernel<NT>, smem, done);
  if (e) return e;
  const int w_vec = C_out == 8 * NT && !misaligned(w);
  spiral_conv_bf16_kernel<NT><<<blocks, kThreads, smem, s>>>(
      x, table, w, b, out, M, L, B, C_in, C_out, ksteps, ldw, f32out, w_vec);
  return static_cast<int>(cudaGetLastError());
}

int launch_nt(int nt, const __nv_bfloat16* x, const int* table,
              const __nv_bfloat16* w, const __nv_bfloat16* b, void* out, int M,
              int L, int B, int C_in, int C_out, int ksteps, int ldw,
              int blocks, int smem, int f32out, cudaStream_t s) {
  switch (nt) {
    case 1: return launch<1>(x, table, w, b, out, M, L, B, C_in, C_out,
                             ksteps, ldw, blocks, smem, f32out, s);
    case 2: return launch<2>(x, table, w, b, out, M, L, B, C_in, C_out,
                             ksteps, ldw, blocks, smem, f32out, s);
    case 4: return launch<4>(x, table, w, b, out, M, L, B, C_in, C_out,
                             ksteps, ldw, blocks, smem, f32out, s);
    case 8: return launch<8>(x, table, w, b, out, M, L, B, C_in, C_out,
                             ksteps, ldw, blocks, smem, f32out, s);
    case 16: return launch<16>(x, table, w, b, out, M, L, B, C_in, C_out,
                               ksteps, ldw, blocks, smem, f32out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

constexpr int kCopyBatch = 8;        // copies whose indices load together
constexpr int kVecThreads = 256;     // eight warps a block (kernels.py
//                                      _BF16_VEC_THREADS)
constexpr int kVecVerts = 64;        // most vertices a tile owns
//                                      (ops/spiral_conv.py _TILE_VERTICES)

// ints of a ring stage before its staged entries: a tile's rows of local
// and verts, padded to 16 bytes
__host__ __device__ __forceinline__ int vec_index_ints(int L) {
  return (kVecVerts * (L + 1) + 3) & ~3;
}

// bytes of one of the vector kernel's two ring stages (kernels.py
// bf16_vec_plan)
__host__ __device__ __forceinline__ long long vec_stage_bytes(int L, int C_in,
                                                              int rows,
                                                              int TB) {
  return 4LL * vec_index_ints(L) + 2LL * rows * TB * (C_in + 8);
}

// ints after the two ring stages: the offsets of the block's next four
// items (src_off[t], src_off[t + 1], starts[t], starts[t + 1] each) and
// the source rows of its next two items
__host__ __device__ __forceinline__ int vec_tail_ints(int rows) {
  return 16 + ((2 * rows + 3) & ~3);
}

// One block per column slice of 8·NT and a share of the (vertex tile,
// batch tile) items, walked through two ring stages: see the header. MT
// 16-row tiles per warp at a time; CS = C_in / 16 k16 steps a position
// (0: C_in / 16 at run time). At most 128 registers, so that two blocks
// share an SM.
template <int NT, int MT, int CS>
__global__ void __launch_bounds__(kVecThreads, 2)
spiral_conv_bf16_vec_kernel(const __nv_bfloat16* __restrict__ x,
                            const int* __restrict__ verts,
                            const int* __restrict__ starts,
                            const int* __restrict__ src,
                            const int* __restrict__ src_off,
                            const int* __restrict__ local,
                            const __nv_bfloat16* __restrict__ w,
                            const __nv_bfloat16* __restrict__ bias,
                            void* __restrict__ out, int L, int B, int C_in,
                            int C_out, int n_tiles, int rows_cap, int TB,
                            int n_btiles, int n_splits, int f32out,
                            int w_vec, int x_vec) {
  constexpr int NC = 8 * NT;                      // the slice's columns
  constexpr int LDW = NT == 1 ? 8 : NC + 8;       // odd 16-byte units
  extern __shared__ __align__(16) unsigned char vec_smem[];
  const int K = L * C_in;
  const int xst = C_in + 8;                       // a staged entry
  uint16_t* ws = reinterpret_cast<uint16_t*>(vec_smem);   // W [K][LDW]
  unsigned char* ring = vec_smem + 2 * K * LDW;
  const int stage_bytes =
      static_cast<int>(vec_stage_bytes(L, C_in, rows_cap, TB));
  const int split = blockIdx.x % n_splits;
  const int n0 = split * NC;
  const int Q = gridDim.x / n_splits;             // blocks of this slice
  const int n_items = n_tiles * n_btiles;

  // the slice of W, once a block, in the first item's group
  if (w_vec) {                                    // 16-byte pieces
    for (int i = threadIdx.x; i < K * NT; i += blockDim.x) {
      const int k = i / NT;
      const int j = i - k * NT;
      uint16_t* d = ws + k * LDW + 8 * j;
      if (n0 + 8 * j < C_out)
        cp_async16(d, w + (size_t)k * C_out + n0 + 8 * j);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
    }
  } else {
    for (int i = threadIdx.x; i < K * NC; i += blockDim.x) {
      const int k = i / NC;
      const int o = i - k * NC;
      ws[k * LDW + o] =
          n0 + o < C_out ? bf16_bits(w[(size_t)k * C_out + n0 + o]) : 0;
    }
  }
  const int pieces = C_in >> (x_vec ? 3 : 1);    // copies a (row, batch)

  // The pipeline, all through shared memory (no register waits on a load
  // across items): the group committed while item j is multiplied holds
  // item j + 1's rows, item j + 2's source indices and item j + 3's
  // offsets, each copied from what the group before it landed.
  int* meta = reinterpret_cast<int*>(ring + 2 * stage_bytes);   // [4][4]
  int* sidx = meta + 16;                                        // [2][rows]
  const int q0 = blockIdx.x / n_splits;
  auto item_q = [&](int j) { return q0 + j * Q; };
  auto copy_meta = [&](int j) {
    const int q = item_q(j);
    if (q < n_items && threadIdx.x < 4) {
      const int t = q / n_btiles;
      const int k = threadIdx.x;
      cp_async4(meta + (j & 3) * 4 + k,
                (k < 2 ? src_off : starts) + t + (k & 1));
    }
  };
  auto copy_idx = [&](int j) {
    if (item_q(j) >= n_items) return;
    const int* mt = meta + (j & 3) * 4;
    const int s0 = mt[0], rows = mt[1] - s0;
    for (int d = threadIdx.x; d < rows; d += blockDim.x)
      cp_async4(sidx + (j & 1) * rows_cap + d, src + s0 + d);
  };
  // item j's rows into its stage: the tile's rows of local and verts, and
  // its source rows' tb batch rows, which lie contiguous in x, in pieces of
  // 8 values where x lies on 16 bytes, else 2
  auto copy_rows = [&](int j) {
    const int q = item_q(j);
    if (q >= n_items) return;
    int* ls = reinterpret_cast<int*>(ring + (j & 1) * stage_bytes);
    int* vs = ls + kVecVerts * L;
    uint16_t* xs = reinterpret_cast<uint16_t*>(ls + vec_index_ints(L));
    const int* mt = meta + (j & 3) * 4;
    const int rows = mt[1] - mt[0], v0 = mt[2], nv = mt[3] - v0;
    for (int i = threadIdx.x; i < nv * (L + 1); i += blockDim.x) {
      if (i < nv * L)
        cp_async4(ls + i, local + (size_t)v0 * L + i);
      else
        cp_async4(vs + i - nv * L, verts + v0 + i - nv * L);
    }
    const int b0 = (q % n_btiles) * TB, tb = min(TB, B - b0);
    stage_rows(xs, TB * xst, xst, x + (size_t)b0 * C_in, (size_t)B * C_in,
               sidx + (j & 1) * rows_cap, rows, tb, pieces, x_vec);
  };

  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  float bias_lo[NT], bias_hi[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int c = n0 + nt * 8 + 2 * tig;
    bias_lo[nt] = c < C_out ? __bfloat162float(bias[c]) : 0.f;
    bias_hi[nt] = c + 1 < C_out ? __bfloat162float(bias[c + 1]) : 0.f;
  }
  const int arow = (lane & 7) + ((lane >> 3) & 1) * 8;   // ldmatrix's row
  const int koff = (lane >> 4) * 8;                      // and depth half
  const int cs_n = CS ? CS : C_in >> 4;
  const int pair = C_out % 2 == 0;               // two outputs a store

  copy_meta(0);
  copy_meta(1);
  copy_meta(2);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  copy_idx(0);
  copy_idx(1);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  copy_rows(0);                                   // with the slice of W
  cp_async_commit();
  for (int i = 0; item_q(i) < n_items; ++i) {
    cp_async_wait<0>();
    __syncthreads();
    copy_rows(i + 1);
    copy_idx(i + 2);
    copy_meta(i + 3);
    cp_async_commit();

    const int* ls = reinterpret_cast<const int*>(ring + (i & 1) * stage_bytes);
    const int* vs = ls + kVecVerts * L;
    const uint16_t* xs =
        reinterpret_cast<const uint16_t*>(ls + vec_index_ints(L));
    const int b0 = (item_q(i) % n_btiles) * TB, tb = min(TB, B - b0);
    const int magic = div_magic(tb);
    const int n_rows = (meta[(i & 3) * 4 + 3] - meta[(i & 3) * 4 + 2]) * tb;
    const int n_mt = (n_rows + 15) >> 4;
    for (int g = threadIdx.x >> 5; g * MT < n_mt; g += blockDim.x >> 5) {
      // each lane's ldmatrix row (vertex v, batch row b) of each 16-row tile
      const int* lrow[MT];
      const uint16_t* abase[MT];
#pragma unroll
      for (int i2 = 0; i2 < MT; ++i2) {
        const int r = min((g * MT + i2) * 16 + arow, n_rows - 1);
        const int v = div_by(r, magic);
        lrow[i2] = ls + v * L;
        abase[i2] = xs + (r - v * tb) * xst + koff;
      }
      float acc[MT][NT][4];
#pragma unroll
      for (int i2 = 0; i2 < MT; ++i2)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          acc[i2][nt][0] = acc[i2][nt][2] = bias_lo[nt];
          acc[i2][nt][1] = acc[i2][nt][3] = bias_hi[nt];
        }
      // per position: every A fragment of its k16 steps first, the next
      // position's staged entries loaded meanwhile, then the products
      int ent[MT];
#pragma unroll
      for (int i2 = 0; i2 < MT; ++i2) ent[i2] = lrow[i2][0];
      for (int l = 0; l < L; ++l) {
        const uint16_t* ap[MT];
#pragma unroll
        for (int i2 = 0; i2 < MT; ++i2) {
          ap[i2] = abase[i2] + ent[i2] * TB * xst;
          ent[i2] = lrow[i2][min(l + 1, L - 1)];
        }
        if (CS) {
          uint32_t a[MT][CS ? CS : 1][4];
#pragma unroll
          for (int i2 = 0; i2 < MT; ++i2)
#pragma unroll
            for (int cs = 0; cs < CS; ++cs)
              ldsm_x4(a[i2][cs], ap[i2] + cs * 16);
#pragma unroll
          for (int cs = 0; cs < CS; ++cs) {
            const int ks = l * CS + cs;
#pragma unroll
            for (int nt = 0; nt + 1 < NT; nt += 2) {
              uint32_t bq[4];
              w_frags(ws, LDW, ks, nt, lane, bq);
#pragma unroll
              for (int i2 = 0; i2 < MT; ++i2) {
                mma_bf16(acc[i2][nt], a[i2][cs], bq[0], bq[1]);
                mma_bf16(acc[i2][nt + 1], a[i2][cs], bq[2], bq[3]);
              }
            }
            if (NT % 2) {
              uint32_t q0b, q1b;
              w_frags1(ws, LDW, ks, NT - 1, lane, q0b, q1b);
#pragma unroll
              for (int i2 = 0; i2 < MT; ++i2)
                mma_bf16(acc[i2][NT - 1], a[i2][cs], q0b, q1b);
            }
          }
          continue;
        }
        for (int cs = 0; cs < cs_n; ++cs) {
          const int ks = l * cs_n + cs;
          uint32_t a[MT][4];
#pragma unroll
          for (int i2 = 0; i2 < MT; ++i2) ldsm_x4(a[i2], ap[i2] + cs * 16);
#pragma unroll
          for (int nt = 0; nt + 1 < NT; nt += 2) {
            uint32_t bq[4];
            w_frags(ws, LDW, ks, nt, lane, bq);
#pragma unroll
            for (int i2 = 0; i2 < MT; ++i2) {
              mma_bf16(acc[i2][nt], a[i2], bq[0], bq[1]);
              mma_bf16(acc[i2][nt + 1], a[i2], bq[2], bq[3]);
            }
          }
          if (NT % 2) {
            uint32_t q0b, q1b;
            w_frags1(ws, LDW, ks, NT - 1, lane, q0b, q1b);
#pragma unroll
            for (int i2 = 0; i2 < MT; ++i2)
              mma_bf16(acc[i2][NT - 1], a[i2], q0b, q1b);
          }
        }
      }
#pragma unroll
      for (int i2 = 0; i2 < MT; ++i2)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = (g * MT + i2) * 16 + gid + 8 * h;
          if (r >= n_rows) continue;
          const int v = div_by(r, magic);
          const size_t o =
              ((size_t)vs[v] * B + b0 + r - v * tb) * C_out + n0 + 2 * tig;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int c = n0 + nt * 8 + 2 * tig;
            if (c >= C_out) continue;
            const float lo = acc[i2][nt][2 * h], hi = acc[i2][nt][2 * h + 1];
            const size_t e = o + nt * 8;
            if (f32out) {
              float* of = static_cast<float*>(out);
              if (pair) {
                *reinterpret_cast<float2*>(of + e) = make_float2(lo, hi);
              } else {
                of[e] = lo;
                if (c + 1 < C_out) of[e + 1] = hi;
              }
            } else {
              __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(out);
              if (pair) {
                *reinterpret_cast<__nv_bfloat162*>(ob + e) =
                    __floats2bfloat162_rn(lo, hi);
              } else {
                ob[e] = __float2bfloat16_rn(lo);
                if (c + 1 < C_out) ob[e + 1] = __float2bfloat16_rn(hi);
              }
            }
          }
        }
    }
    __syncthreads();                 // before the stage is refilled
  }
}

template <int NT, int MT, int CS>
int launch_vec(const __nv_bfloat16* x, const int* verts, const int* starts,
               const int* src, const int* src_off, const int* local,
               const __nv_bfloat16* w, const __nv_bfloat16* b, void* out,
               int L, int B, int C_in, int C_out, int n_tiles, int rows,
               int TB, int n_btiles, int n_splits, int blocks, int smem,
               int f32out, cudaStream_t s) {
  static int done = 0;
  const int e =
      set_smem(spiral_conv_bf16_vec_kernel<NT, MT, CS>, smem, done);
  if (e) return e;
  const int w_vec = C_out % 8 == 0 && !misaligned(w);
  spiral_conv_bf16_vec_kernel<NT, MT, CS><<<blocks, kVecThreads, smem, s>>>(
      x, verts, starts, src, src_off, local, w, b, out, L, B, C_in, C_out,
      n_tiles, rows, TB, n_btiles, n_splits, f32out, w_vec, !misaligned(x));
  return static_cast<int>(cudaGetLastError());
}

using VecLaunch = int (*)(const __nv_bfloat16*, const int*, const int*,
                          const int*, const int*, const int*,
                          const __nv_bfloat16*, const __nv_bfloat16*, void*,
                          int, int, int, int, int, int, int, int, int, int,
                          int, int, cudaStream_t);

template <int NT, int MT>
VecLaunch vec_depth(int c_in) {
  switch (c_in) {
    case 32: return launch_vec<NT, MT, 2>;
    case 64: return launch_vec<NT, MT, 4>;
    default: return launch_vec<NT, MT, 0>;
  }
}

// the compiled (NT, MT): MT·NT <= 8 column tiles of 16 rows a warp;
// C_in 32 and 64 unrolled, other multiples of 16 walked at run time
VecLaunch vec_instance(int nt, int mt, int c_in) {
  switch (nt * 4 + mt) {
    case 1 * 4 + 1: return vec_depth<1, 1>(c_in);
    case 1 * 4 + 2: return vec_depth<1, 2>(c_in);
    case 2 * 4 + 1: return vec_depth<2, 1>(c_in);
    case 2 * 4 + 2: return vec_depth<2, 2>(c_in);
    case 4 * 4 + 1: return vec_depth<4, 1>(c_in);
    case 4 * 4 + 2: return vec_depth<4, 2>(c_in);
    case 8 * 4 + 1: return vec_depth<8, 1>(c_in);
    default: return nullptr;
  }
}

constexpr int kTileL = 9;            // the final conv's shape (kernels.py
constexpr int kTileCin = 32;         // _TILE_SHAPE)
constexpr int kTileDepth = kTileL * kTileCin;
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

// The element path of K1-bf16 (f32out = 0: bf16 out) and K3a (f32out = 1:
// fp32 out) for x [N_src, B, C_in], table [M, L], w [L, C_in, C_out], b
// [C_out], all bf16 but the table; out [M, B, C_out]. The plan (kernels.py,
// plan_spiral_conv with dtype bfloat16, path bf16_elem): nt column tiles
// of 8 (1, 2, 4, 8 or 16, 8·nt >= C_out), ksteps = ceil(L·C_in / 16), ldw
// (bf16 values, >= 8·nt, an odd number of 16-byte units), blocks and smem
// (ksteps·16·ldw·2 bytes). Returns a cudaError_t.
extern "C" int cfs_spiral_conv_bf16(const void* x, const int* table,
                                    const void* w, const void* b, void* out,
                                    int M, int L, int B, int C_in, int C_out,
                                    int nt, int ksteps, int ldw, int blocks,
                                    int smem, int f32out, void* stream) {
  if (M < 1 || L < 1 || B < 1 || C_in < 1 || C_out < 1 || C_out > 8 * nt ||
      ksteps * 16 < L * C_in || ldw < 8 * nt || ldw % 16 != 8 ||
      blocks < 1 || smem < ksteps * 16 * ldw * 2)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_nt(nt, static_cast<const __nv_bfloat16*>(x), table,
                   static_cast<const __nv_bfloat16*>(w),
                   static_cast<const __nv_bfloat16*>(b), out, M, L, B, C_in,
                   C_out, ksteps, ldw, blocks, smem, f32out,
                   static_cast<cudaStream_t>(stream));
}

// The vector path of K1-bf16 (f32out = 0) and K3a (f32out = 1) through
// the op's vertex tiles (ops.SpiralTiles: verts [M], starts and src_off
// [n_tiles + 1], src, local [M, L]): x [N_src, B, C_in] on 4 bytes with
// C_in a multiple of 16, w [L, C_in, C_out], b [C_out] bf16, out [M, B,
// C_out]. The plan (kernels.py, plan_spiral_conv with dtype bfloat16 and
// the tiles, path bf16; bf16_vec_plan): rows (the most source rows a tile
// stages), tb batch rows an item in n_btiles batch tiles, nt column tiles
// of 8 a block (1, 2, 4 or 8) in n_splits = ceil(C_out / 8·nt) slices, mt
// 16-row tiles a warp takes at once (1 or 2), blocks (a multiple of
// n_splits, at most the items of all slices), smem (>= the slice of W and
// two ring stages); every tile owns at most 64 vertices. Returns a
// cudaError_t.
extern "C" int cfs_spiral_conv_bf16_vec(
    const void* x, const int* verts, const int* starts, const int* src,
    const int* src_off, const int* local, const void* w, const void* b,
    void* out, int M, int L, int B, int C_in, int C_out, int n_tiles,
    int rows, int tb, int n_btiles, int nt, int mt, int n_splits, int blocks,
    int smem, int f32out, void* stream) {
  const VecLaunch run = vec_instance(nt, mt, C_in);
  const long long ldw = nt == 1 ? 8 : 8 * nt + 8;
  const long long need = 2LL * L * C_in * ldw +
                         2 * vec_stage_bytes(L, C_in, rows, tb) +
                         4LL * vec_tail_ints(rows);
  if (!run || M < 1 || L < 1 || B < 1 || C_in < 16 || C_in % 16 ||
      C_out < 1 || n_tiles < 1 || rows < 1 || tb < 1 ||
      n_btiles != (B + tb - 1) / tb || n_splits != (C_out + 8 * nt - 1) /
      (8 * nt) || blocks < n_splits || blocks % n_splits ||
      (long long)blocks > (long long)n_tiles * n_btiles * n_splits ||
      smem < need || smem > 232448 || reinterpret_cast<uintptr_t>(x) % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  return run(static_cast<const __nv_bfloat16*>(x), verts, starts, src,
             src_off, local, static_cast<const __nv_bfloat16*>(w),
             static_cast<const __nv_bfloat16*>(b), out, L, B, C_in, C_out,
             n_tiles, rows, tb, n_btiles, n_splits, blocks, smem, f32out,
             static_cast<cudaStream_t>(stream));
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

// K1: spiral convolution forward in fp32, vertex-major, for sm_90a.
//
// Replaces the fp32 branch of
// craniofacialsd_vae_tpu/ops/spiral_conv.py::_spiral_conv_core (:159; nine
// XLA row gathers and matmuls on the TPU).
//
//   out[m, b, :] = bias + sum_l x[S[m, l], b, :] @ W_l,  l = 0 .. L-1
//
// with x [N_src, B, C_in], S [M, L] (M < N_src for the encoder's tables
// composed with the down-selection), W [L, C_in, C_out], out [M, B, C_out].
// The host's planner (kernels.py::plan_spiral_conv) picks the path and
// the tile; this file only checks that the plan is one it can run.
//
// Tensor-core path (spiral_conv_tc_kernel; C_out >= 8, any C_in). The
// work is a GEMM whose rows are the pairs (m, b), whose depth is L·C_in
// and whose A operand is gathered. What bounds it on an H100: not the
// tensor cores (dec0 at B = 16: 3 x 5.0 GFLOP is 0.030 ms at 495 TFLOP/s)
// but moving the gathered rows, L times x's size, from L2 (315 MB at
// dec0), the latency of each gather, and the instructions around the
// products. The design:
// - a block owns TM vertices x TB batch rows (16 to 256 GEMM rows) and
//   NT of the C_out columns; each vertex's source row x[S[m,l], b0:b0+TB]
//   is one contiguous segment;
// - the gathers are cp.async copies (16 bytes where the segment is
//   16-byte aligned, 4 otherwise) into a ring of NS shared-memory
//   stages; a stage holds P spiral positions (depth P·C_in, padded with
//   zeros to a multiple of 8) of one tile and their rows of W. The block
//   walks its tiles' stages as one flat sequence with one barrier per
//   stage, so NS - 1 stages are in flight while one is multiplied, and
//   the next tile's gathers overlap this tile's last products and
//   epilogue. The tile's table rows are copied one tile ahead into a
//   double buffer. Copies walk their chunks as mixed-radix digits, with
//   no integer division per copy or per stage;
// - W streams through the ring with x: a stage of W is small beside the
//   gathered rows, comes from L2, and leaves room for more blocks per
//   SM. Keeping all of W resident (split once into TF32 hi and lo) was
//   measured slower, because it cost blocks per SM. So was splitting
//   each stage's W once into hi and lo in shared memory: every warp of
//   a block splits the B fragments it reads;
// - the products run on the tensor cores as mma.sync m16n8k8 TF32 in
//   3xTF32: each operand is split into hi = rna_tf32(a) and
//   lo = rna_tf32(a - hi), and a_lo·w_hi + a_hi·w_lo + a_hi·w_hi is
//   accumulated in fp32 (small terms first). That keeps the fp32
//   reference's accuracy: a single TF32 pass keeps 10 mantissa bits and
//   misses rtol 1e-5. The rounding is two integer operations, where
//   the compiler's cvt.rna.tf32.f32 is five;
// - row strides are padded (A: depth plus 4 floats; W: NT plus 8 where
//   needed) so the fragment loads are free of bank conflicts;
// - persistent blocks: the grid is at most the blocks that fit on the
//   132 SMs (launch bounds cap registers at 128 so that two blocks of 256
//   threads fit), and each walks row tiles with stride gridDim.x;
// - epilogue: the bias, then 16-byte stores after a lane-pair shuffle
//   (4-byte stores where C_out % 4 != 0).
// The planner sizes stages to the level: small levels (M·B <= 8192) take
// 3 positions per stage in 16-row tiles with one warp per 8 columns, so
// that the whole grid is in flight at once; the composed 3 -> 32 first
// conv puts all 9 positions in one stage of depth 27 (padded to 32).
//
// Narrow-output paths (C_out < 8, the final 32 -> 3 conv). No tensor
// cores (an n = 8 tile would waste 5/8 of its width). One warp per output
// vertex and TB batch rows; lane c owns input channel c; per position
// the warp reads the gathered TB·C_in segment coalesced (TB independent
// loads per lane), keeps TB x C_out partial sums in registers across all
// positions, and reduces them over the lanes once at the end with a
// reduce-scatter of warp shuffles (31 or 62 shuffles for 32 or 64 sums,
// one or two left per lane). The kernels are compiled for TB up to 1, 4
// and 8, so that small batches hold few registers.
// - spiral_conv_narrow_tile_kernel (the default at L = 9, C_in = 32: the
//   final conv of every configuration). Reading each position's rows from
//   L2 moves every source
//   row to the SMs about L times (314 MB at the final conv at B = 16, for
//   35 MB of x). So the host cuts the output vertices into tiles of
//   nearby vertices, each with the sorted list of its distinct source
//   rows (at most 64; ops/spiral_conv.py::build_spiral_tiles grows each
//   tile breadth-first over the mesh, and a staged row then serves about
//   4 entries of its tile's spirals on the fixture's and the octasphere's
//   level 0, against about 2 for tiles of consecutive indices), and a
//   table of each vertex's entries as indices into that list. One block
//   per (tile, batch tile) copies its rows' TB batch rows into shared
//   memory once (cp.async), each lane holds its channel's W for every
//   position in registers, and the warps take the tile's vertices in
//   turn, reading the rows from shared memory with the positions
//   unrolled. The planner (kernels.py::_plan_narrow_tile) takes the most
//   batch rows per block whose staged rows let three blocks share an
//   SM. The products, not the copies, take most of its time, and the
//   two overlap only where the blocks of an SM fall out of step.
// - spiral_conv_narrow_kernel: the same items with each row read from
//   L2 and W staged in shared memory (three positions unrolled), for an
//   op without tiles or of another shape.

// No atomics: every output is summed by one thread (or one warp) in a
// fixed order, so two launches on the same inputs are bit-equal.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

// plan layout shared with kernels.py::SpiralPlan.as_ints
enum PlanField {
  kPath, kThreads, kGridX, kGridY, kSmem, kTM, kTB, kNBTiles, kNRTiles,
  kKP, kLDA, kLDW, kNT, kStages, kVecX, kVecW, kVecOut, kMI,
  kNI, kWarpsM, kPositions, kRows, kPlanFields
};
enum Path { kPathTC = 1, kPathNarrow = 2, kPathNarrowTile = 3 };

constexpr int kMaxStages = 10;
constexpr int kNarrowAcc = 64;   // most TB x C_out sums per lane, narrow path
constexpr int kTileL = 9;        // narrow_tile's positions and input
constexpr int kTileCin = 32;     // channels (kernels.py's _TILE_SHAPE)
constexpr int kMaxSmem = 232448;

struct TcParams {
  const float* x;
  const int* table;
  const float* w;
  const float* bias;
  float* out;
  int M, L, B, Cin, Cout;
  int TM, TB, n_btiles, n_rtiles;   // tile: TM vertices x TB batch rows
  int KP, LDA, LDW, NT, NS;         // depth, strides, columns, stages
  int P, SPT;                       // positions per stage, stages per tile
  int vec_x, vec_w, vec_out;
  int a_stage, w_block;             // floats per A stage, per W block
  int warps_m;
};

struct Tile {
  int m0, b0, tm, tb;
};

__device__ __forceinline__ Tile tile_of(const TcParams& p, int rt) {
  const int mt = rt / p.n_btiles;
  const int bt = rt - mt * p.n_btiles;
  Tile t;
  t.m0 = mt * p.TM;
  t.b0 = bt * p.TB;
  t.tm = min(p.TM, p.M - t.m0);
  t.tb = min(p.TB, p.B - t.b0);
  return t;
}

// Stage s of the block's flat sequence: stage l (positions l·P ..
// l·P + P - 1) of its t-th tile, in ring slot `slot`.
struct Cursor {
  int s, t, l, slot;
  Tile tile;
};

__device__ __forceinline__ void advance(const TcParams& p, Cursor& c) {
  ++c.s;
  if (++c.slot == p.NS) c.slot = 0;
  if (++c.l == p.SPT) {
    c.l = 0;
    ++c.t;
    c.tile = tile_of(p, blockIdx.x + c.t * gridDim.x);
  }
}

// The tile's gathered rows for position l into ring slot `as` (row
// i·TB + b, columns 0..C_in-1), chunk by chunk along the walk `w`.
template <int VEC>
__device__ __forceinline__ void gather_rows(const TcParams& p, const Tile& t,
                                            Walk w, const int* trow, int l,
                                            float* as) {
  const int ch = p.Cin / VEC;
  while (w.i < t.tm) {
    const int src = trow[w.i * p.L + l];
    const float* g =
        p.x + ((size_t)src * p.B + t.b0 + w.b) * p.Cin + w.c * VEC;
    float* s = as + (w.i * p.TB + w.b) * p.LDA + w.c * VEC;
    if (VEC == 4)
      cp_async16(s, g);
    else
      cp_async4(s, g);
    step(w, ch, t.tb);
  }
}

// Rows g·P·C_in .. (g+1)·P·C_in - 1 of W [L·C_in, C_out] (the positions
// of stage g), columns n0 .. n0 + nvalid - 1, into `ws` (row k at k·LDW)
// along the walk `w` over P·C_in x 1 x nvalid / VEC chunks.
template <int VEC>
__device__ __forceinline__ void stage_weights(const TcParams& p, int g, int n0,
                                              int nvalid, Walk w, float* ws) {
  const int ch = nvalid / VEC;
  const float* src = p.w + (size_t)g * p.P * p.Cin * p.Cout + n0;
  while (w.i < p.P * p.Cin) {
    if (VEC == 4)
      cp_async16(ws + w.i * p.LDW + 4 * w.c,
                 src + (size_t)w.i * p.Cout + 4 * w.c);
    else
      cp_async4(ws + w.i * p.LDW + w.c, src + (size_t)w.i * p.Cout + w.c);
    step(w, ch, 1);
  }
}

// Copies of the stage at cursor c: at l = 0 the next tile's table rows,
// then the gathered rows of its P positions (position l·P + j into
// columns j·C_in ..) and their rows of W. `wx` and `ww` are the walks of
// a full tile's rows and of W.
__device__ __forceinline__ void issue_stage(const TcParams& p, const Cursor& c,
                                            int total, float* ring_a,
                                            float* wsm, int* ts, int n0,
                                            int nvalid, const Walk& wx,
                                            const Walk& ww) {
  if (c.s >= total) return;
  const int ts_words = p.TM * p.L;
  if (c.l == 0 && c.s + p.SPT < total) {
    const Tile nx = tile_of(p, blockIdx.x + (c.t + 1) * gridDim.x);
    int* dst = ts + ((c.t + 1) & 1) * ts_words;
    const int* src = p.table + (size_t)nx.m0 * p.L;
    for (int i = threadIdx.x; i < nx.tm * p.L; i += blockDim.x)
      cp_async4(dst + i, src + i);
  }
  const int* trow = ts + (c.t & 1) * ts_words;
  float* as = ring_a + c.slot * p.a_stage;
  for (int j = 0; j < p.P; ++j) {
    const int l = c.l * p.P + j;
    if (p.vec_x) {
      const Walk w = c.tile.tb == p.TB ? wx : walk_of(p.Cin / 4, c.tile.tb);
      gather_rows<4>(p, c.tile, w, trow, l, as + j * p.Cin);
    } else {
      const Walk w = c.tile.tb == p.TB ? wx : walk_of(p.Cin, c.tile.tb);
      gather_rows<1>(p, c.tile, w, trow, l, as + j * p.Cin);
    }
  }
  float* ws = wsm + c.slot * p.w_block;
  if (p.vec_w)
    stage_weights<4>(p, c.l, n0, nvalid, ww, ws);
  else
    stage_weights<1>(p, c.l, n0, nvalid, ww, ws);
}

// Bias and store of one tile's accumulators. With vec_out, lanes 2j and
// 2j+1 swap half their pairs so that each holds four neighbouring
// columns of one row: the even lane row gid, the odd lane row gid + 8.
template <int MI, int NI>
__device__ __forceinline__ void store_tile(const TcParams& p, const Tile& t,
                                           float (&acc)[MI][NI][4],
                                           const int (&ri)[MI][2],
                                           const int (&rb)[MI][2], int col,
                                           int tig) {
  const bool odd = tig & 1;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      float (&c)[4] = acc[mi][ni];
      const int cb = col + ni * 8;
      if (p.vec_out) {
        const float s0 = odd ? c[0] : c[2];
        const float s1 = odd ? c[1] : c[3];
        const float r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
        const float r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
        const int cc = cb + 2 * (tig & ~1);
        const int i = ri[mi][odd], b = rb[mi][odd];
        if (i < t.tm && b < t.tb && cc < p.Cout) {
          float4 v = odd ? make_float4(r0, r1, c[2], c[3])
                         : make_float4(c[0], c[1], r0, r1);
          v.x += __ldg(p.bias + cc);
          v.y += __ldg(p.bias + cc + 1);
          v.z += __ldg(p.bias + cc + 2);
          v.w += __ldg(p.bias + cc + 3);
          *reinterpret_cast<float4*>(
              p.out + ((size_t)(t.m0 + i) * p.B + t.b0 + b) * p.Cout + cc) = v;
        }
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = ri[mi][h], b = rb[mi][h];
          if (i >= t.tm || b >= t.tb) continue;
          float* o = p.out + ((size_t)(t.m0 + i) * p.B + t.b0 + b) * p.Cout;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int cc = cb + 2 * tig + j;
            if (cc < p.Cout) o[cc] = c[2 * h + j] + __ldg(p.bias + cc);
          }
        }
      }
    }
  }
}

// Warp (wm, wn) owns rows wm·16·MI .. +16·MI and columns wn·8·NI .. +8·NI
// of the block's tile; the block owns columns blockIdx.y·NT .. +NT.
template <int MI, int NI>
__global__ void __launch_bounds__(256, 2)
spiral_conv_tc_kernel(const TcParams p) {
  extern __shared__ __align__(16) float smem[];
  // gridDim.x <= n_rtiles: every block has at least one tile
  const int n_my = (p.n_rtiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
  const int n0 = blockIdx.y * p.NT;
  const int nvalid = min(p.NT, p.Cout - n0);
  float* ring_a = smem;
  float* wsm = ring_a + p.NS * p.a_stage;
  int* ts = reinterpret_cast<int*>(wsm + p.NS * p.w_block);

  // zeros in the K padding of every A stage and W block (columns and
  // rows that no copy writes); unused rows and C_out columns only feed
  // outputs that are never stored
  if (p.KP > p.P * p.Cin) {
    const int k0 = p.P * p.Cin, pad = p.KP - k0;
    const int a_rows = p.NS * (p.a_stage / p.LDA);
    for (int q = threadIdx.x; q < a_rows * pad; q += blockDim.x) {
      const int r = q / pad;
      ring_a[r * p.LDA + k0 + (q - r * pad)] = 0.f;
    }
    const int w_pad = pad * p.LDW;
    for (int q = threadIdx.x; q < p.NS * w_pad; q += blockDim.x) {
      const int blk = q / w_pad;
      wsm[blk * p.w_block + k0 * p.LDW + (q - blk * w_pad)] = 0.f;
    }
  }
  const Walk ww = walk_of(p.vec_w ? nvalid / 4 : nvalid, 1);
  const Walk wx = walk_of(p.vec_x ? p.Cin / 4 : p.Cin, p.TB);
  Cursor ic = {0, 0, 0, 0, tile_of(p, blockIdx.x)};   // next to issue
  const Cursor first = ic;
  {
    const int* src = p.table + (size_t)ic.tile.m0 * p.L;
    for (int i = threadIdx.x; i < ic.tile.tm * p.L; i += blockDim.x)
      ts[i] = __ldg(src + i);
  }
  __syncthreads();
  const int total = n_my * p.SPT;
  for (int k = 0; k < p.NS - 1; ++k) {
    issue_stage(p, ic, total, ring_a, wsm, ts, n0, nvalid, wx, ww);
    cp_async_commit();
    advance(p, ic);
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp % p.warps_m, wn = warp / p.warps_m;
  const int row0 = wm * 16 * MI, col0 = wn * 8 * NI;
  int ri[MI][2], rb[MI][2];           // (vertex, batch row) of my rows
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + mi * 16 + gid + 8 * h;
      ri[mi][h] = r / p.TB;
      rb[mi][h] = r - ri[mi][h] * p.TB;
    }
  float acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;

  for (Cursor c = first; c.s < total; advance(p, c)) {
    cp_async_wait_upto(p.NS - 2);     // stage s has landed (this thread)
    __syncthreads();                  // ... for all; slot s-1 is free
    issue_stage(p, ic, total, ring_a, wsm, ts, n0, nvalid, wx, ww);
    cp_async_commit();
    advance(p, ic);
    const float* as = ring_a + c.slot * p.a_stage + (row0 + gid) * p.LDA + tig;
    const float* ws = wsm + c.slot * p.w_block + tig * p.LDW + col0 + gid;
#pragma unroll 4
    for (int k0 = 0; k0 < p.KP; k0 += 8) {
      uint32_t ah[MI][4], al[MI][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const float* a = as + mi * 16 * p.LDA + k0;
        split_tf32(a[0], ah[mi][0], al[mi][0]);
        split_tf32(a[8 * p.LDA], ah[mi][1], al[mi][1]);
        split_tf32(a[4], ah[mi][2], al[mi][2]);
        split_tf32(a[8 * p.LDA + 4], ah[mi][3], al[mi][3]);
      }
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const float* bp = ws + k0 * p.LDW + ni * 8;
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(bp[0], bh0, bl0);
        split_tf32(bp[4 * p.LDW], bh1, bl1);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          mma_tf32(acc[mi][ni], al[mi], bh0, bh1);   // small terms first
          mma_tf32(acc[mi][ni], ah[mi], bl0, bl1);
          mma_tf32(acc[mi][ni], ah[mi], bh0, bh1);
        }
      }
    }
    if (c.l == p.SPT - 1) {
      store_tile<MI, NI>(p, c.tile, acc, ri, rb, n0 + col0, tig);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;
    }
  }
  cp_async_wait<0>();
}

// One step of the reduce-scatter over the lanes: of its 2·H sums a lane
// keeps the half picked by its bit OFF, adding the partner's copy.
template <int OFF, int H, int NV>
__device__ __forceinline__ void reduce_step(float (&v)[NV], int lane) {
  const bool up = lane & OFF;
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const float send = up ? v[j] : v[j + H];
    const float keep = up ? v[j + H] : v[j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
  }
}

// One output item of the narrow path, by one warp: vertex m, batch rows
// b0 .. b0 + tb - 1 (tb <= TBM); sum e = b·CO + o is kept in v[e], lane c
// reads input channel c (W_l staged in `ws`). NV: the sums padded to 32
// or 64, so that the reduce-scatter leaves NV / 32 of them per lane.
template <int CO, int TBM>
__device__ __forceinline__ void narrow_item(const float* __restrict__ x,
                                            const int* __restrict__ table,
                                            const float* ws,
                                            const float* __restrict__ bias,
                                            float* __restrict__ out, int m,
                                            int b0, int tb, int L, int B,
                                            int Cin) {
  constexpr int NV = TBM * CO <= 32 ? 32 : 64;
  constexpr int PER = NV / 32;
  static_assert(TBM * CO <= kNarrowAcc, "too many sums per lane");
  const int lane = threadIdx.x & 31;
  float v[NV];
#pragma unroll
  for (int e = 0; e < NV; ++e) v[e] = 0.f;
  for (int l0 = 0; l0 < L; l0 += 32) {
    const int nl = min(32, L - l0);
    const int my_src = lane < nl ? __ldg(table + (size_t)m * L + l0 + lane)
                                 : 0;
    for (int c0 = 0; c0 < Cin; c0 += 32) {
      const int c = c0 + lane;
      const bool on = c < Cin;
#pragma unroll 3
      for (int j = 0; j < nl; ++j) {
        const int src = __shfl_sync(0xffffffffu, my_src, j);
        const float* xr = x + ((size_t)src * B + b0) * Cin + c;
        float xv[TBM];
#pragma unroll
        for (int b = 0; b < TBM; ++b)
          xv[b] = (on && b < tb) ? __ldg(xr + (size_t)b * Cin) : 0.f;
        const float* wl = ws + ((size_t)(l0 + j) * Cin + (on ? c : 0)) * CO;
#pragma unroll
        for (int o = 0; o < CO; ++o) {
          const float wv = on ? wl[o] : 0.f;
#pragma unroll
          for (int b = 0; b < TBM; ++b)
            v[b * CO + o] = fmaf(xv[b], wv, v[b * CO + o]);
        }
      }
    }
  }
  reduce_step<16, 16 * PER>(v, lane);
  reduce_step<8, 8 * PER>(v, lane);
  reduce_step<4, 4 * PER>(v, lane);
  reduce_step<2, 2 * PER>(v, lane);
  reduce_step<1, PER>(v, lane);
  // the lane now holds sums e = PER·lane + j (e = b·CO + o, the e-th
  // float of the output rows)
  float* o = out + ((size_t)m * B + b0) * CO;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int e = PER * lane + j;
    if (e < tb * CO) o[e] = v[j] + __ldg(bias + e % CO);
  }
}

// Items (vertex, TB batch rows), one per warp.
template <int CO, int TBM>
__global__ void __launch_bounds__(256)
spiral_conv_narrow_kernel(const float* __restrict__ x,
                          const int* __restrict__ table,
                          const float* __restrict__ w,
                          const float* __restrict__ bias,
                          float* __restrict__ out, int M, int L, int B,
                          int Cin, int TB, int n_btiles) {
  extern __shared__ __align__(16) float smem[];
  const int nw = L * Cin * CO;
  for (int i = threadIdx.x; i < nw; i += blockDim.x) smem[i] = __ldg(w + i);
  __syncthreads();
  const int item = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (item >= M * n_btiles) return;
  const int m = item / n_btiles;
  const int b0 = (item - m * n_btiles) * TB;
  narrow_item<CO, TBM>(x, table, smem, bias, out, m, b0, min(TB, B - b0), L,
                       B, Cin);
}

// One block per (vertex tile, batch tile): the tile's distinct source
// rows (batch rows b0 .. b0 + tb - 1 of each) are copied into shared
// memory once, at a stride of TBM·kTileCin floats (cp.async, 16 bytes
// where VEC: x on 16 bytes, else 4 bytes), while each lane loads its
// channel's weights of every position and output into registers. Then
// the block's warps take the tile's vertices in turn: per position the
// lane reads its channel of the TB rows from shared memory and adds
// TB x CO products, and the sums are reduced over the lanes as on the
// untiled path. Compiled for the shape of every configuration's final
// conv, L = kTileL positions of C_in = kTileCin channels: with the
// positions unrolled, W in registers and the loads' offsets fixed at
// compile time, the loop is loads and FMAs; a first version that kept W
// in shared memory and walked L and C_in at run time spent most of its
// instructions on addresses and was barely faster than the untiled
// kernel (PERF.md). FULL: every batch tile holds TBM rows (B a
// multiple of TB = TBM), so the loads need no bound.
template <int CO, int TBM, bool VEC, bool FULL>
__global__ void __launch_bounds__(256)
spiral_conv_narrow_tile_kernel(const float* __restrict__ x,
                               const int* __restrict__ verts,
                               const int* __restrict__ starts,
                               const int* __restrict__ src,
                               const int* __restrict__ src_off,
                               const int* __restrict__ local,
                               const float* __restrict__ w,
                               const float* __restrict__ bias,
                               float* __restrict__ out, int B, int TB,
                               int n_btiles) {
  extern __shared__ __align__(16) float xs[];
  constexpr int NV = TBM * CO <= 32 ? 32 : 64;
  constexpr int PER = NV / 32;
  constexpr int C = kTileCin;
  static_assert(TBM * CO <= kNarrowAcc, "too many sums per lane");
  const int t = blockIdx.x / n_btiles;
  const int b0 = (blockIdx.x - t * n_btiles) * TB;
  const int tb = min(TB, B - b0);
  const int s0 = __ldg(src_off + t);
  const int rows = __ldg(src_off + t + 1) - s0;
  // the rows' segments: tb·C floats each, contiguous in x and in xs
  constexpr int V = VEC ? 4 : 1;
  const int per_row = tb * (C / V);
  for (int k = threadIdx.x; k < rows * per_row; k += blockDim.x) {
    const int d = k / per_row;
    const int j = k - d * per_row;
    const float* g = x + ((size_t)__ldg(src + s0 + d) * B + b0) * C + j * V;
    float* sdst = xs + d * (TBM * C) + j * V;
    if (VEC)
      cp_async16(sdst, g);
    else
      cp_async4(sdst, g);
  }
  cp_async_commit();
  const int lane = threadIdx.x & 31;
  float wr[kTileL][CO];
#pragma unroll
  for (int l = 0; l < kTileL; ++l)
#pragma unroll
    for (int o = 0; o < CO; ++o)
      wr[l][o] = __ldg(w + (l * C + lane) * CO + o);
  cp_async_wait<0>();
  __syncthreads();
  const int v1 = __ldg(starts + t + 1);
  for (int v = __ldg(starts + t) + (threadIdx.x >> 5); v < v1;
       v += blockDim.x >> 5) {
    const int my_src = lane < kTileL ? __ldg(local + v * kTileL + lane) : 0;
    float* o_rows = out + ((size_t)__ldg(verts + v) * B + b0) * CO;
    float a[NV];
#pragma unroll
    for (int e = 0; e < NV; ++e) a[e] = 0.f;
#pragma unroll
    for (int j = 0; j < kTileL; ++j) {
      const int s = __shfl_sync(0xffffffffu, my_src, j);
      const float* xr = xs + s * (TBM * C) + lane;
      float xv[TBM];
#pragma unroll
      for (int b = 0; b < TBM; ++b)
        xv[b] = (FULL || b < tb) ? xr[b * C] : 0.f;
#pragma unroll
      for (int o = 0; o < CO; ++o)
#pragma unroll
        for (int b = 0; b < TBM; ++b)
          a[b * CO + o] = fmaf(xv[b], wr[j][o], a[b * CO + o]);
    }
    reduce_step<16, 16 * PER>(a, lane);
    reduce_step<8, 8 * PER>(a, lane);
    reduce_step<4, 4 * PER>(a, lane);
    reduce_step<2, 2 * PER>(a, lane);
    reduce_step<1, PER>(a, lane);
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int e = PER * lane + j;
      if (e < tb * CO) o_rows[e] = a[j] + __ldg(bias + e % CO);
    }
  }
}

template <int MI, int NI>
int launch_tc(const TcParams& p, const int* plan, cudaStream_t st) {
  static int done = 0;
  const int rc = set_smem(spiral_conv_tc_kernel<MI, NI>, plan[kSmem], done);
  if (rc) return rc;
  spiral_conv_tc_kernel<MI, NI>
      <<<dim3(plan[kGridX], plan[kGridY]), plan[kThreads], plan[kSmem], st>>>(
          p);
  return static_cast<int>(cudaGetLastError());
}

template <int CO, int TBM>
int launch_narrow_tb(const float* x, const int* table, const float* w,
                     const float* bias, float* out, int M, int L, int B,
                     int Cin, const int* plan, cudaStream_t st) {
  static int done = 0;
  const int rc =
      set_smem(spiral_conv_narrow_kernel<CO, TBM>, plan[kSmem], done);
  if (rc) return rc;
  spiral_conv_narrow_kernel<CO, TBM>
      <<<plan[kGridX], plan[kThreads], plan[kSmem], st>>>(
          x, table, w, bias, out, M, L, B, Cin, plan[kTB], plan[kNBTiles]);
  return static_cast<int>(cudaGetLastError());
}

// The narrow kernel for C_out = CO whose register rows TBM (1, 4 or 8)
// are the fewest that hold TB batch rows.
template <int CO>
int launch_narrow(const float* x, const int* table, const float* w,
                  const float* bias, float* out, int M, int L, int B,
                  int Cin, const int* plan, cudaStream_t st) {
  const int tb = plan[kTB];
  if (tb <= 1)
    return launch_narrow_tb<CO, 1>(x, table, w, bias, out, M, L, B, Cin,
                                   plan, st);
  if (tb <= 4)
    return launch_narrow_tb<CO, 4>(x, table, w, bias, out, M, L, B, Cin,
                                   plan, st);
  return launch_narrow_tb<CO, 8>(x, table, w, bias, out, M, L, B, Cin, plan,
                                 st);
}

// The register rows (1, 4 or 8) of the narrow kernels for TB batch rows.
int tile_tbm(int TB) { return TB <= 1 ? 1 : TB <= 4 ? 4 : 8; }

struct TileArgs {
  const float* x;
  const int *verts, *starts, *src, *src_off, *local;
  const float *w, *bias;
  float* out;
  int B;
};

template <int CO, int TBM, bool VEC, bool FULL>
int launch_tile_full(const TileArgs& a, const int* plan, cudaStream_t st) {
  static int done = 0;
  const int rc = set_smem(spiral_conv_narrow_tile_kernel<CO, TBM, VEC, FULL>,
                          plan[kSmem], done);
  if (rc) return rc;
  spiral_conv_narrow_tile_kernel<CO, TBM, VEC, FULL>
      <<<plan[kGridX], plan[kThreads], plan[kSmem], st>>>(
          a.x, a.verts, a.starts, a.src, a.src_off, a.local, a.w, a.bias,
          a.out, a.B, plan[kTB], plan[kNBTiles]);
  return static_cast<int>(cudaGetLastError());
}

template <int CO, int TBM, bool VEC>
int launch_tile_tb(const TileArgs& a, const int* plan, cudaStream_t st) {
  return plan[kTB] == TBM && a.B % TBM == 0
             ? launch_tile_full<CO, TBM, VEC, true>(a, plan, st)
             : launch_tile_full<CO, TBM, VEC, false>(a, plan, st);
}

template <int CO, bool VEC>
int launch_tile_vec(const TileArgs& a, const int* plan, cudaStream_t st) {
  switch (tile_tbm(plan[kTB])) {
    case 1: return launch_tile_tb<CO, 1, VEC>(a, plan, st);
    case 4: return launch_tile_tb<CO, 4, VEC>(a, plan, st);
    default: return launch_tile_tb<CO, 8, VEC>(a, plan, st);
  }
}

template <int CO>
int launch_tile(const TileArgs& a, const int* plan, cudaStream_t st) {
  return plan[kVecX] ? launch_tile_vec<CO, true>(a, plan, st)
                     : launch_tile_vec<CO, false>(a, plan, st);
}

// The plan checks shared by both narrow paths.
bool narrow_plan_ok(const int* plan, int M, int L, int B, int Cin, int Cout) {
  const int threads = plan[kThreads], smem = plan[kSmem], TB = plan[kTB];
  return M >= 1 && L >= 1 && B >= 1 && Cin >= 1 && Cout >= 1 && Cout < 8 &&
         threads >= 32 && threads % 32 == 0 && threads <= 256 && smem >= 0 &&
         smem <= kMaxSmem && smem % 16 == 0 && plan[kGridX] >= 1 &&
         plan[kGridY] == 1 && TB >= 1 && TB <= 8 &&
         plan[kNBTiles] == (B + TB - 1) / TB;
}

}  // namespace

// plan: kPlanFields ints from kernels.py::SpiralPlan.as_ints. Returns a
// cudaError_t; a plan this file cannot run is cudaErrorInvalidValue.
extern "C" int cfs_spiral_conv_fwd(const float* x, const int* table,
                                   const float* w, const float* bias,
                                   float* out, int M, int L, int B, int Cin,
                                   int Cout, const int* plan, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = plan[kThreads], smem = plan[kSmem];
  if (M < 1 || L < 1 || B < 1 || Cin < 1 || Cout < 1 || Cout > 256 ||
      threads < 32 || threads % 32 || threads > 256 || smem < 0 ||
      smem > kMaxSmem || smem % 16 || plan[kGridX] < 1 || plan[kGridY] < 1)
    return bad;
  const int TB = plan[kTB];
  if (TB < 1 || plan[kNBTiles] != (B + TB - 1) / TB) return bad;

  if (plan[kPath] == kPathNarrow) {
    if (!narrow_plan_ok(plan, M, L, B, Cin, Cout) ||
        (size_t)smem < sizeof(float) * L * Cin * Cout ||
        (long long)plan[kGridX] * (threads / 32) <
            (long long)M * plan[kNBTiles])
      return bad;
    switch (Cout) {
      case 1: return launch_narrow<1>(x, table, w, bias, out, M, L, B, Cin, plan, st);
      case 2: return launch_narrow<2>(x, table, w, bias, out, M, L, B, Cin, plan, st);
      case 3: return launch_narrow<3>(x, table, w, bias, out, M, L, B, Cin, plan, st);
      case 4: return launch_narrow<4>(x, table, w, bias, out, M, L, B, Cin, plan, st);
      case 5: return launch_narrow<5>(x, table, w, bias, out, M, L, B, Cin, plan, st);
      case 6: return launch_narrow<6>(x, table, w, bias, out, M, L, B, Cin, plan, st);
      case 7: return launch_narrow<7>(x, table, w, bias, out, M, L, B, Cin, plan, st);
      default: return bad;
    }
  }
  if (plan[kPath] != kPathTC) return bad;

  TcParams p;
  p.x = x; p.table = table; p.w = w; p.bias = bias; p.out = out;
  p.M = M; p.L = L; p.B = B; p.Cin = Cin; p.Cout = Cout;
  p.TM = plan[kTM]; p.TB = TB; p.n_btiles = plan[kNBTiles];
  p.n_rtiles = plan[kNRTiles];
  p.KP = plan[kKP]; p.LDA = plan[kLDA]; p.LDW = plan[kLDW];
  p.NT = plan[kNT]; p.NS = plan[kStages];
  p.vec_x = plan[kVecX];
  p.vec_w = plan[kVecW]; p.vec_out = plan[kVecOut];
  p.warps_m = plan[kWarpsM];
  p.P = plan[kPositions];
  p.SPT = p.P >= 1 ? L / p.P : 0;
  const int MI = plan[kMI], NI = plan[kNI];
  const int rows = p.warps_m * 16 * MI;
  p.a_stage = rows * p.LDA;
  p.w_block = p.KP * p.LDW;
  const long long need =
      4LL * ((long long)p.NS * p.a_stage +
             (long long)p.NS * p.w_block +
             2LL * p.TM * L);
  if (Cout < 8 || p.warps_m < 1 || p.TM < 1 || p.TM * TB > rows ||
      p.P < 1 || L % p.P || p.KP < p.P * Cin || p.KP % 8 ||
      p.LDA < p.KP || p.LDA % 4 ||
      p.NT < 8 || p.NT % (8 * NI) || p.LDW < p.NT || p.LDW % 4 ||
      threads != 32 * p.warps_m * (p.NT / (8 * NI)) ||
      p.NS < 2 || p.NS > kMaxStages || p.NS > p.SPT + 1 ||
      p.n_rtiles != ((M + p.TM - 1) / p.TM) * p.n_btiles ||
      plan[kGridX] > p.n_rtiles ||
      (long long)plan[kGridY] * p.NT < Cout ||
      (long long)(plan[kGridY] - 1) * p.NT >= Cout || need > smem ||
      (p.vec_x && (Cin % 4 || misaligned(x))) ||
      (p.vec_w && (Cout % 4 || misaligned(w))) ||
      (p.vec_out && (Cout % 4 || misaligned(out))))
    return bad;
  switch (MI * 10 + NI) {
    case 11: return launch_tc<1, 1>(p, plan, st);
    case 12: return launch_tc<1, 2>(p, plan, st);
    case 14: return launch_tc<1, 4>(p, plan, st);
    case 21: return launch_tc<2, 1>(p, plan, st);
    case 22: return launch_tc<2, 2>(p, plan, st);
    case 24: return launch_tc<2, 4>(p, plan, st);
    default: return bad;
  }
}

// K1 narrow_tile: out [M, B, Cout] (Cout < 8) from x [N_src, B, Cin] through
// the op's vertex tiles (ops.SpiralTiles: verts [M], starts and src_off
// [n_tiles + 1], src, local [M, L]); plan: kPlanFields ints from
// kernels.py::SpiralPlan.as_ints with path kPathNarrowTile. Returns a
// cudaError_t; a plan this file cannot run is cudaErrorInvalidValue.
extern "C" int cfs_spiral_conv_narrow_tile(
    const float* x, const int* verts, const int* starts, const int* src,
    const int* src_off, const int* local, const float* w, const float* bias,
    float* out, int M, int L, int B, int Cin, int Cout, int n_tiles,
    const int* plan, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  const int TB = plan[kTB], rows = plan[kRows];
  if (plan[kPath] != kPathNarrowTile ||
      !narrow_plan_ok(plan, M, L, B, Cin, Cout) || L != kTileL ||
      Cin != kTileCin || n_tiles < 1 || rows < 1 ||
      (long long)plan[kGridX] != (long long)n_tiles * plan[kNBTiles] ||
      4LL * rows * tile_tbm(TB) * Cin > plan[kSmem] ||
      (plan[kVecX] && misaligned(x)))
    return bad;
  const TileArgs a{x, verts, starts, src, src_off, local, w, bias, out, B};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (Cout) {
    case 1: return launch_tile<1>(a, plan, st);
    case 2: return launch_tile<2>(a, plan, st);
    case 3: return launch_tile<3>(a, plan, st);
    case 4: return launch_tile<4>(a, plan, st);
    case 5: return launch_tile<5>(a, plan, st);
    case 6: return launch_tile<6>(a, plan, st);
    case 7: return launch_tile<7>(a, plan, st);
    default: return bad;
  }
}

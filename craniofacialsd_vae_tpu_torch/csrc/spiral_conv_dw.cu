// K2-dW: the weight gradient of the spiral conv, fp32 in 3xTF32 on the
// tensor cores, for sm_90a.
//
// Replaces the dW half of craniofacialsd_vae_tpu/ops/spiral_conv.py::
// _score_bwd (lines 208-211; XLA einsums on the TPU, one per position):
//
//   dW[l, c, o] = sum_{m, b} x[S[m, l], b, c] * dy[m, b, o]
//
// for x [N_src, B, C_in], the spiral table S [M, L] and dy [M, B, C_out].
// The gathers are recomputed: the [M, B, L*C_in] concatenation is never
// written. The host's planner (kernels.py::plan_spiral_conv_dw) fixes the
// launch; this file only checks that the plan is one it can run.
//
// What bounds it on an H100: a long reduction (M*B rows, 272,624 at the
// full-resolution decoder conv of a 16-mesh swap grid) into L small
// [C_in, C_out] matrices. At 3xTF32 the tensor cores would need under
// 0.03 ms for any conv of the model; what costs is moving the gathered
// rows (L times x's size, from L2) and the instructions around the
// products: every operand is split into two TF32 parts before an MMA. The
// design:
//
// - Vertices, not flat rows: a block owns a fixed chunk of vertex tiles
//   (TMV vertices x all B batch rows, 32 or 64 reduction rows) and a
//   group of P spiral positions (grid.y walks the groups; all nine
//   positions at the model's widths but 64). A ring stage is one tile:
//   the contiguous dy[m0 : m0 + TMV, 0:B, :] slab, staged once for all P
//   positions, and for each position the vertices' x[S[m, l], 0:B, :]
//   rows, NS - 1 tiles ahead of the one that multiplies. Rows whose width
//   is a multiple of 16 bytes go by Hopper's bulk copies, one instruction
//   a row (warp j copies position j's rows), completing on the slot's
//   mbarrier; narrower rows (3 channels) by 4-byte cp.async. With one
//   cp.async per 16 bytes the copies' own instructions took as long as
//   the products and did not overlap them (measured on an H100; PERF.md).
//   The block reads its chunk's slice of the table into shared memory
//   once, up front, so no copy waits on a global load for its address.
// - One warp per (position, output block): the warp owns the position's
//   (16·MI) x (8·NI) fragments, a 32 x 32 block at the model's widths, so
//   each operand it splits feeds MI or NI products (24 MMAs for 16 split
//   values per K step; a warp owning one 16 x 8 fragment of every position
//   spent 6 splits on 3 MMAs, and the instructions set the time). The
//   wider of C_in and C_out is the MMA's M side, the other its N side: the
//   first conv computes dWᵀ = dyᵀ·X_l (32 on M, 3 padded to 8 on N), the
//   final one X_lᵀ·dy (32 on M, 3 on N). grid.z splits outputs wider than
//   nine warps' blocks.
// - The reduction over rows is the MMA's K: mma.sync m16n8k8 TF32 in
//   3xTF32 (a_lo·b_hi + a_hi·b_lo + a_hi·b_hi, small terms first, fp32
//   accumulators; common.cuh). The big part is rounded to nearest, the
//   small part is left for the tensor core to truncate (CUTLASS's fast
//   3xTF32 split: three operations a value instead of five). Shared-memory
//   row strides are 8 or 24 mod 32 floats, so the fragment loads are free
//   of bank conflicts. Each tile's products are summed apart and added to
//   the running sums with one fp32 rounding, so the tensor cores
//   accumulate over one tile's rows, never over a chunk's thousands.
// - Deterministic, no atomics: each warp writes its chunk's partial dW for
//   its position and block to a scratch buffer the wrapper allocates, and
//   a second launch sums the chunks in a fixed order (eight interleaved
//   runs of chunks, then the eight run sums in order). Two launches give
//   the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

// plan layout shared with kernels.py::DwPlan.as_ints
enum DwField {
  kXOnM, kMI, kNI, kFGM, kFGN, kP, kStages, kTMV, kRowsP, kLdx, kLdd,
  kNVTiles, kTilesPerChunk, kChunks, kGroups, kZM, kZN, kThreads, kSmem,
  kVecX, kVecD, kDwFields
};

constexpr int kMaxWarps = 9;
constexpr int kMaxThreads = 32 * kMaxWarps;
constexpr int kSumWarps = 8;
constexpr int kSumThreads = 32 * kSumWarps;
constexpr int kBarFloats = 16;       // kMaxStages mbarriers, 8 bytes each
constexpr int kMaxStages = 8;
constexpr int kMaxSmem = 232448;

struct DwParams {
  const float* x;
  const int* table;
  const float* dy;
  float* part;
  int M, L, B, Cin, Cout;
  int x_on_m;                 // x is the MMA's A (M side), else dy is
  int P, fgm, fgn, zn;        // positions; fgm x fgn warp blocks per position
  int NS, TMV, RP, ldx, ldd;  // stages, vertices and rows per tile, strides
  int n_vtiles, tpc;          // vertex tiles, tiles per chunk
  int vec_x, vec_d;           // 16-byte copies (else 4-byte)
  int x_plane, slot;          // floats per position's rows, per ring stage
};

// a = hi + lo for the tensor cores: hi rounded to TF32, lo = a - hi left
// as it is (the MMA reads its top 19 bits)
__device__ __forceinline__ void split_big(float a, uint32_t& hi,
                                          uint32_t& lo) {
  hi = rna_tf32(a);
  lo = __float_as_uint(a - __uint_as_float(hi));
}

// x rows of a tile's vertices 0 .. tmv - 1 at one position into `xs`
// (row i·B + b at (i·B + b)·ldx) in 4-byte cp.async copies, along the
// walk `w` over (vertex, batch row, channel); vertex i's source row is
// src_of[i·stride] (the table slice in shared memory).
__device__ __forceinline__ void gather_x4(const DwParams& p, Walk w,
                                          const int* src_of, int stride,
                                          int tmv, float* xs) {
  int last = -1, src = 0;
  while (w.i < tmv) {
    if (w.i != last) {
      last = w.i;
      src = src_of[w.i * stride];
    }
    cp_async4(xs + (w.i * p.B + w.b) * p.ldx + w.c,
              p.x + ((size_t)src * p.B + w.b) * p.Cin + w.c);
    step(w, p.Cin, p.B);
  }
}

// dy rows of vertices m0 .. m0 + tmv - 1 into `ds`, 4-byte copies.
__device__ __forceinline__ void copy_dy4(const DwParams& p, Walk w, int m0,
                                         int tmv, float* ds) {
  while (w.i < tmv) {
    cp_async4(ds + (w.i * p.B + w.b) * p.ldd + w.c,
              p.dy + ((size_t)(m0 + w.i) * p.B + w.b) * p.Cout + w.c);
    step(w, p.Cout, p.B);
  }
}

// zeros in rows r0 .. r1 - 1 of a buffer with row stride ld
__device__ __forceinline__ void zero_rows(float* buf, int r0, int r1, int ld) {
  for (int e = r0 * ld + threadIdx.x; e < r1 * ld; e += blockDim.x)
    buf[e] = 0.f;
}

// Copies of the block's tile ti into its ring slot: dy after the P
// position planes of x, whose source rows come from the block's table
// slice `ts` [vertices][P]. Rows of 16-byte multiples go by bulk copies,
// one a row (warp j copies position j's rows, the last warp dy's), which
// complete on the slot's mbarrier; thread 0 arms it with their bytes.
// Other rows go by 4-byte cp.async copies in the thread's commit group.
// The last tile of the table may hold fewer than TMV vertices: its
// missing rows are zeroed, so that they add nothing.
__device__ __forceinline__ void issue(const DwParams& p, int ti, int t0,
                                      const Walk& wx, const Walk& wd,
                                      const int* ts, float* ring,
                                      uint64_t* bars) {
  const int m0 = (t0 + ti) * p.TMV;
  const int tmv = min(p.TMV, p.M - m0);
  const int rows = tmv * p.B;
  float* st = ring + (ti % p.NS) * p.slot;
  float* ds = st + p.P * p.x_plane;
  uint64_t* bar = bars + ti % p.NS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int* src_of = ts + ti * p.TMV * p.P;
  if (threadIdx.x == 0)
    mbar_arrive_expect(bar, rows * 4 * ((p.vec_x ? p.P * p.Cin : 0) +
                                        (p.vec_d ? p.Cout : 0)));
  if (p.vec_d) {
    if (warp == warps - 1)
      for (int r = lane; r < rows; r += 32)
        bulk_copy(ds + r * p.ldd, p.dy + ((size_t)m0 * p.B + r) * p.Cout,
                  4 * p.Cout, bar);
  } else {
    copy_dy4(p, wd, m0, tmv, ds);
  }
  if (p.vec_x) {
    for (int j = warp; j < p.P; j += warps)
      for (int r = lane; r < rows; r += 32) {
        const int i = r / p.B;
        bulk_copy(st + j * p.x_plane + r * p.ldx,
                  p.x + ((size_t)src_of[i * p.P + j] * p.B + r - i * p.B) *
                            p.Cin,
                  4 * p.Cin, bar);
      }
  } else {
    for (int j = 0; j < p.P; ++j)
      gather_x4(p, wx, src_of + j, p.P, tmv, st + j * p.x_plane);
  }
  if (tmv < p.TMV) {
    for (int j = 0; j < p.P; ++j)
      zero_rows(st + j * p.x_plane, rows, p.TMV * p.B, p.ldx);
    zero_rows(ds, rows, p.TMV * p.B, p.ldd);
  }
}

// acc += the fragment products of one tile over its ksteps K steps: A
// [rows][lda] holds the M side, Bm [rows][ldb] the N side, both read as
// K-major (row k of the tile is the reduction index). The tile's products
// are summed in a fresh accumulator and added to acc with one fp32
// rounding each.
template <int MI, int NI>
__device__ __forceinline__ void mma_rows(float (&acc)[MI][NI][4],
                                         const float* A, int lda,
                                         const float* Bm, int ldb,
                                         int ksteps) {
  float t[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) t[mi][ni][q] = 0.f;
  for (int k8 = 0; k8 < ksteps; ++k8) {
    const float* a = A + k8 * 8 * lda;
    const float* b = Bm + k8 * 8 * ldb;
    uint32_t ah[MI][4], al[MI][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      split_big(a[mi * 16], ah[mi][0], al[mi][0]);
      split_big(a[mi * 16 + 8], ah[mi][1], al[mi][1]);
      split_big(a[4 * lda + mi * 16], ah[mi][2], al[mi][2]);
      split_big(a[4 * lda + mi * 16 + 8], ah[mi][3], al[mi][3]);
    }
    // one B fragment at a time: its four registers, not 4·NI, are live
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      uint32_t bh0, bl0, bh1, bl1;
      split_big(b[ni * 8], bh0, bl0);
      split_big(b[4 * ldb + ni * 8], bh1, bl1);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        mma_tf32(t[mi][ni], al[mi], bh0, bh1);     // small terms first
        mma_tf32(t[mi][ni], ah[mi], bl0, bl1);
        mma_tf32(t[mi][ni], ah[mi], bh0, bh1);
      }
    }
  }
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        acc[mi][ni][q] = __fadd_rn(acc[mi][ni][q], t[mi][ni][q]);
}

// Block (chunk, position group, output block): warp w takes position
// w / (fgm·fgn) of the group and warp block fg = w % (fgm·fgn) = (fm, fn),
// which owns rows (fm·MI .. fm·MI + MI - 1)·16 of the M side and columns
// (fn·NI ..)·8 of the N side within the block's output block.
template <int MI, int NI>
__global__ void __launch_bounds__(kMaxThreads, 2)
spiral_conv_dw_kernel(const DwParams p) {
  extern __shared__ __align__(16) float smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);   // kMaxStages
  float* ring = smem + kBarFloats;
  int* ts = reinterpret_cast<int*>(ring + p.NS * p.slot);
  const int t0 = blockIdx.x * p.tpc;
  const int n_my = min(p.tpc, p.n_vtiles - t0);   // >= 1 by the plan
  // zeros in every padding row and column, which no copy writes
  for (int e = threadIdx.x; e < p.NS * p.slot; e += blockDim.x) ring[e] = 0.f;
  fence_proxy_async();            // ... before the bulk copies overwrite
  // the chunk's table slice, ts[i][j] = table[v0 + i][group·P + j]
  const int v0 = t0 * p.TMV, nv = min(n_my * p.TMV, p.M - v0);
  for (int e = threadIdx.x; e < nv * p.P; e += blockDim.x) {
    const int i = e / p.P;
    ts[e] = __ldg(p.table + (size_t)(v0 + i) * p.L + blockIdx.y * p.P +
                  (e - i * p.P));
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.NS; ++s) mbar_init(bars + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const Walk wx = walk_of(p.Cin, p.B);
  const Walk wd = walk_of(p.Cout, p.B);
  for (int k = 0; k < p.NS - 1; ++k) {
    if (k < n_my) issue(p, k, t0, wx, wd, ts, ring, bars);
    cp_async_commit();
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int per = p.fgm * p.fgn;
  const int j = warp / per, fg = warp - j * per;
  const int fm = fg % p.fgm, fn = fg / p.fgm;
  const int zm = blockIdx.z / p.zn, zn = blockIdx.z - zm * p.zn;
  const int m_first = zm * p.fgm * MI * 16 + fm * MI * 16;  // my M rows
  const int n_first = zn * p.fgn * NI * 8 + fn * NI * 8;    // my N columns
  const int lda = p.x_on_m ? p.ldx : p.ldd;
  const int ldb = p.x_on_m ? p.ldd : p.ldx;
  float acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;

  for (int ti = 0; ti < n_my; ++ti) {
    cp_async_wait_upto(p.NS - 2);   // tile ti's 4-byte copies (this thread)
    mbar_wait(bars + ti % p.NS, (ti / p.NS) & 1);   // ... and its bulk ones
    __syncthreads();                // ... for all; slot ti - 1 is free
    if (ti + p.NS - 1 < n_my)
      issue(p, ti + p.NS - 1, t0, wx, wd, ts, ring, bars);
    cp_async_commit();
    const int rows = min(p.TMV, p.M - (t0 + ti) * p.TMV) * p.B;
    const float* st = ring + (ti % p.NS) * p.slot;
    const float* xs = st + j * p.x_plane;
    const float* ds = st + p.P * p.x_plane;
    mma_rows<MI, NI>(acc, (p.x_on_m ? xs : ds) + tig * lda + m_first + gid,
                     lda, (p.x_on_m ? ds : xs) + tig * ldb + n_first + gid,
                     ldb, (rows + 7) >> 3);
  }
  cp_async_wait<0>();

  // this warp's fragments of the chunk's partial dW, position group·P + j
  float* dst = p.part + ((size_t)blockIdx.x * p.L + blockIdx.y * p.P + j) *
                            p.Cin * p.Cout;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int wide = m_first + mi * 16 + gid + 8 * (q >> 1);
        const int narrow = n_first + ni * 8 + 2 * tig + (q & 1);
        const int c = p.x_on_m ? wide : narrow, o = p.x_on_m ? narrow : wide;
        if (c < p.Cin && o < p.Cout) dst[c * p.Cout + o] = acc[mi][ni][q];
      }
}

// out[e] = the sum over chunks of part[chunk][e] in a fixed order: warp
// w of the block sums chunks w, w + 8, w + 16, .. in order for 32
// neighbouring e, then the eight warp sums are added in warp order.
__global__ void __launch_bounds__(kSumThreads)
spiral_conv_dw_sum(const float* __restrict__ part, float* __restrict__ out,
                   int n_chunks, int n) {
  __shared__ float sums[kSumWarps][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int e = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (e < n) {
#pragma unroll 4
    for (int c = w; c < n_chunks; c += kSumWarps) s += part[(size_t)c * n + e];
  }
  sums[w][lane] = s;
  __syncthreads();
  if (w == 0 && e < n) {
    float t = sums[0][lane];
    for (int k = 1; k < kSumWarps; ++k) t += sums[k][lane];
    out[e] = t;
  }
}

template <int MI, int NI>
int launch_dw(const DwParams& p, const int* plan, cudaStream_t st) {
  static int done = 0;
  const int rc = set_smem(spiral_conv_dw_kernel<MI, NI>, plan[kSmem], done);
  if (rc) return rc;
  spiral_conv_dw_kernel<MI, NI>
      <<<dim3(plan[kChunks], plan[kGroups], plan[kZM] * plan[kZN]),
         plan[kThreads], plan[kSmem], st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// the row stride of a shared-memory operand covering `width` columns
bool stride_ok(int ld, int width) {
  return ld >= width && ld % 4 == 0 && (ld % 32 == 8 || ld % 32 == 24);
}

}  // namespace

// dW [L, C_in, C_out] from x [N_src, B, C_in], table [M, L] and
// dy [M, B, C_out]; plan: kDwFields ints from kernels.py::DwPlan.as_ints;
// part holds chunks * L * C_in * C_out floats. Returns a cudaError_t; a
// plan this file cannot run is cudaErrorInvalidValue.
extern "C" int cfs_spiral_conv_dw(const float* x, const int* table,
                                  const float* dy, float* part, float* out,
                                  int M, int L, int B, int Cin, int Cout,
                                  const int* plan, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  DwParams p;
  p.x = x; p.table = table; p.dy = dy; p.part = part;
  p.M = M; p.L = L; p.B = B; p.Cin = Cin; p.Cout = Cout;
  p.x_on_m = plan[kXOnM];
  p.P = plan[kP]; p.fgm = plan[kFGM]; p.fgn = plan[kFGN]; p.zn = plan[kZN];
  p.NS = plan[kStages]; p.TMV = plan[kTMV]; p.RP = plan[kRowsP];
  p.ldx = plan[kLdx]; p.ldd = plan[kLdd];
  p.n_vtiles = plan[kNVTiles]; p.tpc = plan[kTilesPerChunk];
  p.vec_x = plan[kVecX]; p.vec_d = plan[kVecD];
  p.x_plane = p.RP * p.ldx;
  p.slot = p.P * p.x_plane + p.RP * p.ldd;
  const int MI = plan[kMI], NI = plan[kNI];
  const int threads = plan[kThreads], smem = plan[kSmem];
  const int chunks = plan[kChunks], zm = plan[kZM];
  if (M < 1 || L < 1 || B < 1 || Cin < 1 || Cout < 1 || p.P < 1 || MI < 1 ||
      NI < 1 || p.fgm < 1 || p.fgn < 1 || zm < 1 || p.zn < 1)
    return bad;
  const int wide = p.x_on_m ? Cin : Cout, narrow = p.x_on_m ? Cout : Cin;
  const long long bm = 16LL * p.fgm * MI, bn = 8LL * p.fgn * NI;
  const long long need = 4LL * (kBarFloats + (long long)p.NS * p.slot +
                                (long long)p.tpc * p.TMV * p.P);
  if (threads != 32 * p.P * p.fgm * p.fgn || threads > kMaxThreads ||
      L % p.P || plan[kGroups] != L / p.P || plan[kGroups] > 65535 ||
      zm * p.zn > 65535 ||
      zm * bm < wide || (zm - 1) * bm >= wide ||
      p.zn * bn < narrow || (p.zn - 1) * bn >= narrow ||
      !stride_ok(p.ldx, p.x_on_m ? zm * bm : p.zn * bn) ||
      !stride_ok(p.ldd, p.x_on_m ? p.zn * bn : zm * bm) ||
      p.TMV < 1 || p.RP % 8 || p.RP < p.TMV * B ||
      p.NS < 2 || p.NS > kMaxStages ||
      p.n_vtiles != (M + p.TMV - 1) / p.TMV || p.tpc < 1 || chunks < 1 ||
      (long long)chunks * p.tpc < p.n_vtiles ||
      (long long)(chunks - 1) * p.tpc >= p.n_vtiles ||
      smem < need || smem > kMaxSmem || smem % 16 ||
      (p.vec_x && (Cin % 4 || misaligned(x))) ||
      (p.vec_d && (Cout % 4 || misaligned(dy))))
    return bad;
  int rc;
  switch (MI * 10 + NI) {
    case 11: rc = launch_dw<1, 1>(p, plan, st); break;
    case 12: rc = launch_dw<1, 2>(p, plan, st); break;
    case 14: rc = launch_dw<1, 4>(p, plan, st); break;
    case 21: rc = launch_dw<2, 1>(p, plan, st); break;
    case 22: rc = launch_dw<2, 2>(p, plan, st); break;
    case 24: rc = launch_dw<2, 4>(p, plan, st); break;
    default: return bad;
  }
  if (rc) return rc;
  const int n = L * Cin * Cout;
  spiral_conv_dw_sum<<<(n + 31) / 32, kSumThreads, 0, st>>>(part, out,
                                                           chunks, n);
  return static_cast<int>(cudaGetLastError());
}

// K2-dx and K2-dx-bf16: the input gradient of the spiral conv, for
// sm_90a.
//
// Replaces the dx half of craniofacialsd_vae_tpu/ops/spiral_conv.py::
// _score_bwd (lines 181-199; on the TPU XLA writes dg = dy @ W_l^T for
// every position of a column group, [g, M, B, C_in], gathers it through
// the group's combined capped transpose and adds the groups' parts and
// dy @ W_i^T for each identity column):
//
//   dx[v, b, :] = sum over the (l, n) with S[n, l] = v of dy[n, b, :] @ W_l^T
//
// for dy [M, B, C_out], the spiral table S [M, L] over n_src source rows
// and W_l = w[l] of w [L, C_in, C_out]; dx is [n_src, B, C_in].
//
// What bounds it on an H100: its least time is set by its products (in
// fp32 three TF32 products a value, in bf16 one) and its bytes, near
// each other at the model's shapes. JAX's form writes and reads dg, L
// times C_in / C_out times dy's bytes (279 MB at the full-resolution
// decoder conv of a 16-mesh grid in fp32). The sum reassociates per
// position,
//
//   du_l[v] = sum_{n : S[n, l] = v} dy[n],   dx[v] = [du_0 | ... | du_{L-1}][v]
//                                                    @ [W_0^T; ...; W_{L-1}^T],
//
// so the gathers move C_out-wide dy rows (each read about L times, from
// L2), du lives only in shared memory, and dx is written once: the least
// traffic is dy, w and the lists read once and dx written once. The
// design:
//
// - A block of eight warps (three blocks an SM: their launch bounds keep
//   a thread to 80 registers) owns a tile of 64 product rows at a time: tv
//   consecutive source vertices times tb batch rows (tb = B up to 64;
//   grid.y walks the batch in slices of tb where B > 64) and up to 64
//   columns of dx (grid.z; narrower where a small level's tiles would not
//   fill the card). No two blocks write the same dx element and nothing
//   is added across blocks: no atomics.
// - Positions go in chunks of P (P * C_out <= 128, bf16 288, the
//   positions spread evenly, padded to a multiple of 16 with zero
//   columns; the final conv's C_out = 3 and a 32-wide bf16 conv take all
//   nine positions in one chunk).
//   Where every chunk's W_l^T fits in shared memory with the rest
//   (kernels.py: "resident"), the block stages it once and walks tiles
//   blockIdx.x, blockIdx.x + gridDim.x, ... (as many blocks as the SMs
//   hold); otherwise a block takes one tile and stages each chunk's W_l^T
//   with it.
// - Each (vertex, position) list (ops.SpiralDx: the rows n of dy in
//   ascending order, then -1 where the combined transpose pads, which
//   adds 0 * dy[0] as JAX's padded entries add 0 * dg[0]; an identity
//   position lists the vertex itself) is one segment. For each tile the
//   block reads every position's segment bounds and first rows into
//   shared memory at once (one pair of dependent loads a tile, not a
//   chunk); a segment then goes to a group of lanes, the fewest whose
//   four units a lane (bf16: two) cover its dy slice (dy[n, b0:b0+tb, :],
//   contiguous) in 16-byte units, so a warp sums several short segments
//   at once; a lane issues the loads of its units of an entry together
//   and sums the list's slices in list order from +0, one fp32 rounding
//   per add, into du in shared memory (bf16: rounded once). Then
//   the eight warps multiply, each 16 rows by half the columns. A hub
//   vertex has a long list and no tiers: its lanes walk it while the
//   others wait at the chunk's barrier.
// - fp32 (K2-dx): mma.sync m16n8k8 TF32 in 3xTF32 (a_small b_big + a_big
//   b_small + a_big b_big, small terms first, fp32 accumulators), with
//   CUTLASS's fast split (big rounded to TF32, small the exact rest,
//   truncated by the tensor core); W^T is split once when staged, du
//   when its fragment is loaded. A NaN in du stays in small; an infinite
//   du gives NaN (small is inf - inf), where an fp32 product gives +-inf.
// - bf16 (K2-dx-bf16): du is formed in fp32 from the bf16 dy and rounded
//   to bf16 once when stored (JAX rounds each dg and each of its sums to
//   bf16), then mma.sync m16n8k16 bf16 with fp32 accumulators multiplies
//   it by the bf16 W; dx is rounded to bf16 once.
// - Row strides in shared memory are 4 mod 8 words, so the lanes'
//   fragment loads (gid * stride + tig) hit 32 banks.
//
// What sets its time: a chunk is a chain of dependent round trips (the
// lists' bounds, their first rows, dy) and a barrier between the gather
// and the products, so a block's latency, not the card's bandwidth or its
// tensor cores, bounds it; the small levels, with few tiles, cost a
// block's latency each. Cut apart (k2dx_compare --parts; NVIDIA H100
// 80GB HBM3 at 700 W, the training step's eight convs at B = 16), the
// kernel takes 0.66 ms, its lists alone 0.15, lists and gathers 0.41,
// lists and products 0.39: the two phases add up. A design that streamed
// every entry's dy slice through a ring of bulk copies under the products
// (a producer warp, mbarriers) hid the gathers but was slower whole: its
// products and each tile's fixed cost grew by more. Giving each warp 32
// rows over half the depth, which cuts the products' loads from shared
// memory by a third, moved the step's convs that did not spill by 1 % at
// B = 16 (3 % at B = 1): those loads do not bound the products either
// (PERF.md).
//
// The plain twin, ops/spiral_conv.py::spiral_conv_dx_plain, sums du in
// the same order (bit-equal du, rounded where the kernel rounds it) and
// forms the product in fp32; the card holds the two within a tolerance
// (chip_smoke.py phases 5 and 8).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "bf16.cuh"
#include "common.cuh"

namespace {

// plan layout shared with kernels.py::DxPlan.as_ints
enum DxField {
  kTb, kTv, kP, kKc, kLda, kNf, kZc, kSmem, kLdw, kResident, kGridX,
  kDxFields
};

constexpr int kRows = 64;            // product rows a block
constexpr int kThreads = 256;        // eight warps
constexpr int kMaxSmem = 232448;

// a = big + small: big rounded to TF32 (common.cuh's rna_tf32), small the
// exact rest, left for the tensor core to truncate (CUTLASS's fast
// 3xTF32 split, three operations a value). A NaN stays in small (NaN -
// big is NaN), whatever rna_tf32 makes of it (the card's NaN, 0x7fffffff,
// carries into the sign bit).
__device__ __forceinline__ void split_fast(float a, uint32_t& big,
                                           uint32_t& small) {
  big = rna_tf32(a);
  small = __float_as_uint(a - __uint_as_float(big));
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

struct DxArgs {
  const void* dy;
  const void* w;
  const int* ptr;
  const int* idx;
  void* dx;
  int n_src, L, B, Cin, Cout;
  int tb, tv, P, kc, lda, ldw, resident;
};

// One unit of a dy slice (VEC consecutive values, 16 bytes where VEC >
// 1) as fp32.
template <int VEC>
__device__ __forceinline__ void load_unit(const float* src, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 q = *reinterpret_cast<const float4*>(src);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    v[0] = src[0];
  }
}

template <int VEC>
__device__ __forceinline__ void load_unit(const __nv_bfloat16* src,
                                          float (&v)[VEC]) {
  if constexpr (VEC == 8) {
    const uint4 q = *reinterpret_cast<const uint4*>(src);
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else {
    v[0] = __bfloat162float(src[0]);
  }
}

// du's VEC values at `at`, in fp32 or rounded to bf16
template <int VEC>
__device__ __forceinline__ void store_unit(float* a, int at,
                                           const float (&v)[VEC]) {
  if constexpr (VEC == 4)
    *reinterpret_cast<float4*>(a + at) = make_float4(v[0], v[1], v[2], v[3]);
  else
    a[at] = v[0];
}

template <int VEC>
__device__ __forceinline__ void store_unit(__nv_bfloat16* a, int at,
                                           const float (&v)[VEC]) {
  uint16_t h[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) h[i] = bf16_bits(__float2bfloat16_rn(v[i]));
  uint16_t* a16 = reinterpret_cast<uint16_t*>(a);
  if constexpr (VEC == 8)
    *reinterpret_cast<uint4*>(a16 + at) = make_uint4(
        pack_bf16(h[0], h[1]), pack_bf16(h[2], h[3]),
        pack_bf16(h[4], h[5]), pack_bf16(h[6], h[7]));
  else
    a16[at] = h[0];
}

// The du of one position chunk [l0, l0 + pc) into shared memory: row
// vi * tb + b, column p * Cout + o. Each (vertex, position) list is one
// segment: its entries' dy slices (tb * Cout contiguous values, B * Cout
// a row apart) summed in list order from +0, one fp32 rounding per add.
// A segment goes to a group of gs lanes (gs the least power of two whose
// U units a lane cover its units, at most 32), so a warp walks 32 / gs
// segments at once; a lane holds U units of its segment and issues their
// loads together, entry by entry, so that a warp has U * 32 units in
// flight.
// `sp` holds the tile's segments' bounds and first entries' rows,
// segment (vi, l) at vi * L + l.
template <typename T, int VEC>
__device__ __forceinline__ void gather_du(const DxArgs& p, const int* sp,
                                          int b0, int bw, int l0, int pc,
                                          T* a) {
  constexpr int U = VEC == 8 ? 2 : 4;
  const T* dy = static_cast<const T*>(p.dy);
  const int nunit = bw * p.Cout / VEC;
  int gs = 32;
  while (gs > 1 && gs / 2 * U >= nunit) gs >>= 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per_warp = 32 / gs;
  const int groups = (blockDim.x >> 5) * per_warp;
  const int gl = lane % gs;
  const size_t row = (size_t)p.B * p.Cout;
  const T* base = dy + (size_t)b0 * p.Cout;
  const int step_b = gs * VEC / p.Cout, step_o = gs * VEC - step_b * p.Cout;
  for (int s = warp * per_warp + lane / gs; s < p.tv * pc; s += groups) {
    const int vi = s / pc, pp = s - vi * pc;
    const int* seg = sp + 3 * (vi * p.L + l0 + pp);
    const int e0 = seg[0], e1 = seg[1], n0 = seg[2];
    for (int u0 = gl; u0 < nunit; u0 += gs * U) {
      // (b, o) of this lane's first unit, and one step of gs units
      int b = u0 * VEC / p.Cout, o = u0 * VEC - b * p.Cout;
      float acc[U][VEC];
#pragma unroll
      for (int k = 0; k < U; ++k)
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[k][i] = 0.f;
      for (int e = e0; e < e1; ++e) {
        const int n = e == e0 ? n0 : __ldg(p.idx + e);
        const T* src = base + (n >= 0 ? (size_t)n * row : 0);
        float v[U][VEC];
#pragma unroll
        for (int k = 0; k < U; ++k) {
          const int u = u0 + k * gs;
          if (u < nunit) load_unit<VEC>(src + u * VEC, v[k]);
        }
#pragma unroll
        for (int k = 0; k < U; ++k)
#pragma unroll
          for (int i = 0; i < VEC; ++i)
            acc[k][i] = __fadd_rn(acc[k][i],
                                  n >= 0 ? v[k][i] : __fmul_rn(0.f, v[k][i]));
      }
#pragma unroll
      for (int k = 0; k < U; ++k) {
        if (u0 + k * gs >= nunit) break;
        store_unit<VEC>(a, (vi * p.tb + b) * p.lda + pp * p.Cout + o,
                        acc[k]);
        o += step_o;
        b += step_b;
        if (o >= p.Cout) { o -= p.Cout; ++b; }
      }
    }
  }
}

// The chunk's W^T: row c (column c0 + c of dx), depth k = p * Cout + o,
// from w[l0 + p, c0 + c, o]; 0 past C_in and past the chunk's positions.
// For each position the block's rows are one contiguous slab of w
// (rows * Cout values): thread t takes slab values t, t + 256, ...,
// whose (row, o) it steps without a division, so a thread's loads of
// every position are independent. fp32: the TF32 parts big and small of
// each value (split_fast) in `wb` and `wsm`; bf16: the value in `wb`.
template <typename T>
__device__ __forceinline__ void stage_w(const DxArgs& p, int rows, int c0,
                                        int l0, int pc, int col0, T* wb,
                                        uint32_t* wsm) {
  constexpr bool F32 = std::is_same<T, float>::value;
  const T* w = static_cast<const T*>(p.w);
  const int slab = rows * p.Cout;
  const int c_first = threadIdx.x / p.Cout;
  const int o_first = threadIdx.x - c_first * p.Cout;
  const int step_c = kThreads / p.Cout, step_o = kThreads - step_c * p.Cout;
  for (int pp = 0; pp < pc; ++pp) {
    const T* src = w + ((size_t)(l0 + pp) * p.Cin + c0) * p.Cout;
    int c = c_first, o = o_first;
    for (int e = threadIdx.x; e < slab; e += kThreads) {
      const T val = c0 + c < p.Cin ? src[e] : from_float<T>(0.f);
      const int at = c * p.ldw + col0 + pp * p.Cout + o;
      if constexpr (F32) {
        uint32_t big, small;
        split_fast(val, big, small);
        reinterpret_cast<uint32_t*>(wb)[at] = big;
        wsm[at] = small;
      } else {
        wb[at] = val;
      }
      o += step_o;
      c += step_c;
      if (o >= p.Cout) { o -= p.Cout; ++c; }
    }
  }
  // the columns past the chunk's positions: a warp a row
  const int lane = threadIdx.x & 31;
  for (int c = threadIdx.x >> 5; c < rows; c += kThreads / 32) {
    for (int k = pc * p.Cout + lane; k < p.kc; k += 32) {
      wb[c * p.ldw + col0 + k] = from_float<T>(0.f);
      if constexpr (F32) wsm[c * p.ldw + col0 + k] = 0u;
    }
  }
}

// (BF is the last template argument: profilers' kernel names tell the
// bf16 instances by it)
template <int NF, int VEC, bool BF>
__global__ void __launch_bounds__(kThreads, 3)
spiral_conv_dx_kernel(DxArgs p) {
  using T = typename std::conditional<BF, __nv_bfloat16, float>::type;
  // warp w multiplies rows 16 (w % 4) to 16 (w % 4) + 15 by its share of
  // the block's 8 NF columns: half of them (warps 4-7 the second half),
  // all of them by warps 0-3 where NF = 1
  constexpr int NW = NF > 1 ? NF / 2 : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  // du [64][lda], W^T [8 NF][ldw] (fp32: its TF32 big parts), fp32:
  // W^T's small parts [8 NF][ldw], then the tile's lists' bounds and
  // first rows. A resident W^T holds every chunk, chunk ch at column
  // ch * kc.
  T* a = reinterpret_cast<T*>(smem);
  T* ws = a + kRows * p.lda;
  uint32_t* wsm = reinterpret_cast<uint32_t*>(ws + 8 * NF * p.ldw);
  int* sp = reinterpret_cast<int*>(wsm + (BF ? 0 : 8 * NF * p.ldw));
  const int b0 = blockIdx.y * p.tb;
  const int c0 = blockIdx.z * 8 * NF;
  const int bw = min(p.tb, p.B - b0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int r0 = (warp & 3) * 16;
  const int f0 = NF > 1 ? (warp >> 2) * NW : 0;
  const bool mma_warp = NF > 1 || warp < 4;
  const int n_tiles = (p.n_src + p.tv - 1) / p.tv;
  if (p.resident)
    for (int l0 = 0, ch = 0; l0 < p.L; l0 += p.P, ++ch)
      stage_w<T>(p, 8 * NF, c0, l0, min(p.P, p.L - l0), ch * p.kc, ws, wsm);

  // one vertex tile after another (a resident W^T is staged once for
  // all of the block's tiles)
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int v0 = tile * p.tv;
    float acc[NW][4];
#pragma unroll
    for (int f = 0; f < NW; ++f)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[f][k] = 0.f;
    __syncthreads();          // the last tile's gathers and products are done
    // segment s = vi * L + l is list (v0 + vi) * L + l: kS of a
    // thread's at a time, their loads issued together
    constexpr int kS = 4;
    const int n_seg = p.tv * p.L;
    for (int s0 = threadIdx.x; s0 < n_seg; s0 += kS * kThreads) {
      int e0[kS], e1[kS];
#pragma unroll
      for (int k = 0; k < kS; ++k) {
        const int s = s0 + k * kThreads;
        const bool in = s < n_seg && v0 + s / p.L < p.n_src;
        const size_t at = (size_t)v0 * p.L + s;
        e0[k] = in ? __ldg(p.ptr + at) : 0;
        e1[k] = in ? __ldg(p.ptr + at + 1) : 0;
      }
#pragma unroll
      for (int k = 0; k < kS; ++k) {
        const int s = s0 + k * kThreads;
        const int n0 = e1[k] > e0[k] ? __ldg(p.idx + e0[k]) : 0;
        if (s < n_seg) {
          sp[3 * s] = e0[k];
          sp[3 * s + 1] = e1[k];
          sp[3 * s + 2] = n0;
        }
      }
    }
    for (int l0 = 0, ch = 0; l0 < p.L; l0 += p.P, ++ch) {
      const int pc = min(p.P, p.L - l0);
      const int wcol = p.resident ? ch * p.kc : 0;
      if (ch) __syncthreads();  // the last chunk's products are done
      // the chunk's zero columns, every row: a warp a row
      for (int r = warp; r < kRows; r += kThreads / 32) {
        for (int c = pc * p.Cout + lane; c < p.kc; c += 32)
          a[r * p.lda + c] = from_float<T>(0.f);
      }
      if (!p.resident) stage_w<T>(p, 8 * NF, c0, l0, pc, 0, ws, wsm);
      __syncthreads();
      gather_du<T, VEC>(p, sp, b0, bw, l0, pc, a);
      __syncthreads();
      if (!mma_warp) continue;
      if constexpr (BF) {
        const uint32_t* aw = reinterpret_cast<const uint32_t*>(a);
        const uint32_t* wb = reinterpret_cast<const uint32_t*>(ws);
        const int ld = p.lda / 2, lw = p.ldw / 2;  // words a row
        for (int k0 = 0; k0 < p.kc / 2; k0 += 8) {
          uint32_t fa[4];
          const int i0 = (r0 + gid) * ld + k0 + tig;
          const int i1 = (r0 + gid + 8) * ld + k0 + tig;
          fa[0] = aw[i0]; fa[1] = aw[i1];
          fa[2] = aw[i0 + 4]; fa[3] = aw[i1 + 4];
#pragma unroll
          for (int f = 0; f < NW; ++f) {
            const int j = ((f0 + f) * 8 + gid) * lw + wcol / 2 + k0 + tig;
            mma_bf16(acc[f], fa, wb[j], wb[j + 4]);
          }
        }
      } else {
        const float* af = reinterpret_cast<const float*>(a);
        const uint32_t* wb = reinterpret_cast<const uint32_t*>(ws);
        for (int k0 = 0; k0 < p.kc; k0 += 8) {
          uint32_t ah[4], al[4];
          const int i0 = (r0 + gid) * p.lda + k0 + tig;
          const int i1 = (r0 + gid + 8) * p.lda + k0 + tig;
          split_fast(af[i0], ah[0], al[0]);
          split_fast(af[i1], ah[1], al[1]);
          split_fast(af[i0 + 4], ah[2], al[2]);
          split_fast(af[i1 + 4], ah[3], al[3]);
#pragma unroll
          for (int f = 0; f < NW; ++f) {
            const int j = ((f0 + f) * 8 + gid) * p.ldw + wcol + k0 + tig;
            const uint32_t bh0 = wb[j], bh1 = wb[j + 4];
            const uint32_t bl0 = wsm[j], bl1 = wsm[j + 4];
            mma_tf32(acc[f], al, bh0, bh1);
            mma_tf32(acc[f], ah, bl0, bl1);
            mma_tf32(acc[f], ah, bh0, bh1);
          }
        }
      }
    }
    if (!mma_warp) continue;

    // dx rows r0 + gid and r0 + gid + 8, columns 2 tig and 2 tig + 1 of
    // each of the warp's fragments
    T* dx = static_cast<T*>(p.dx);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + gid + 8 * h;
      const int vi = r / p.tb, b = r - vi * p.tb;
      const int v = v0 + vi;
      if (vi >= p.tv || v >= p.n_src || b >= bw) continue;
      T* out = dx + ((size_t)v * p.B + b0 + b) * p.Cin;
#pragma unroll
      for (int f = 0; f < NW; ++f) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int c = c0 + (f0 + f) * 8 + 2 * tig + q;
          if (c < p.Cin) out[c] = from_float<T>(acc[f][2 * h + q]);
        }
      }
    }
  }
}

template <int NF, bool BF, int VEC>
int launch(const DxArgs& p, dim3 grid, int smem, cudaStream_t st) {
  static int smem_done = 0;
  const int rc = set_smem(spiral_conv_dx_kernel<NF, VEC, BF>, smem,
                          smem_done);
  if (rc) return rc;
  spiral_conv_dx_kernel<NF, VEC, BF><<<grid, kThreads, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool BF, int VEC>
int launch_nf(const DxArgs& p, int nf, dim3 grid, int smem,
              cudaStream_t st) {
  switch (nf) {
    case 1: return launch<1, BF, VEC>(p, grid, smem, st);
    case 2: return launch<2, BF, VEC>(p, grid, smem, st);
    case 4: return launch<4, BF, VEC>(p, grid, smem, st);
    default: return launch<8, BF, VEC>(p, grid, smem, st);
  }
}

}  // namespace

// K2-dx (bf16 = 0: dy, w and dx float32) or K2-dx-bf16 (bf16 = 1: all
// three bfloat16): dx [n_src, B, Cin] from dy [M, B, Cout], w [L, Cin,
// Cout] and the lists ptr [n_src * L + 1], idx (rows of dy, -1 for
// 0 * dy[0]); `plan` is kernels.py::DxPlan.as_ints (a resident plan's
// blocks, grid_x of them, each walk vertex tiles with every chunk's W^T
// staged once). Returns a cudaError_t.
extern "C" int cfs_spiral_conv_dx(const void* dy, const void* w,
                                  const int* ptr, const int* idx, void* dx,
                                  int n_src, int M, int L, int B, int Cin,
                                  int Cout, int bf16, const int* plan,
                                  void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  DxArgs p;
  p.dy = dy; p.w = w; p.ptr = ptr; p.idx = idx; p.dx = dx;
  p.n_src = n_src; p.L = L; p.B = B; p.Cin = Cin; p.Cout = Cout;
  p.tb = plan[kTb]; p.tv = plan[kTv]; p.P = plan[kP]; p.kc = plan[kKc];
  p.lda = plan[kLda]; p.ldw = plan[kLdw]; p.resident = plan[kResident];
  const int nf = plan[kNf], zc = plan[kZc], smem = plan[kSmem];
  const int n_tiles = (n_src + p.tv - 1) / p.tv, grid_x = plan[kGridX];
  const int chunks = (L + p.P - 1) / p.P;
  if (n_src < 1 || M < 1 || L < 1 || B < 1 || Cin < 1 || Cout < 1 ||
      p.tb < 1 || p.tb > kRows || p.tv < 1 || p.tv * p.tb > kRows ||
      p.P < 1 || p.kc % 16 || p.kc < p.P * Cout || p.kc > 1024 ||
      p.P * (long long)Cout > p.kc ||
      (nf != 1 && nf != 2 && nf != 4 && nf != 8) ||
      (long long)zc * 8 * nf < Cin || (long long)(zc - 1) * 8 * nf >= Cin ||
      zc > 65535 || (B + p.tb - 1) / p.tb > 65535 || grid_x < 1 ||
      grid_x > n_tiles || (!p.resident && grid_x != n_tiles))
    return bad;
  // strides of 4 mod 8 words: conflict-free fragment loads
  const int w_cols = p.resident ? chunks * p.kc : p.kc;
  if ((bf16 ? p.lda % 16 != 8 || p.ldw % 16 != 8
            : p.lda % 8 != 4 || p.ldw % 8 != 4) ||
      p.lda < p.kc || p.ldw < w_cols)
    return bad;
  const long long need = (bf16 ? 2LL * (kRows * p.lda + 8 * nf * p.ldw)
                                : 4LL * (kRows * p.lda + 16 * nf * p.ldw)) +
                          12LL * p.tv * L;
  if (smem != need || smem > kMaxSmem) return bad;
  const dim3 grid(grid_x, (B + p.tb - 1) / p.tb, zc);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // 16-byte units of dy where C_out keeps them within a row
  const bool vec = !misaligned(dy) && Cout % (bf16 ? 8 : 4) == 0;
  if (bf16)
    return vec ? launch_nf<true, 8>(p, nf, grid, smem, st)
               : launch_nf<true, 1>(p, nf, grid, smem, st);
  return vec ? launch_nf<false, 4>(p, nf, grid, smem, st)
             : launch_nf<false, 1>(p, nf, grid, smem, st);
}

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
// dimension, and every position reads the same dy rows. A block owns a
// chunk of work and a group of P spiral positions (all L where the
// accumulators fit): the chunk is a run of consecutive vertex tiles
// (ops.SpiralTiles, the tiles K1-bf16 reads: compact patches of at most
// 64 vertices whose distinct source rows each serve about 4 spiral
// entries on the decoder's levels) times a run of batch tiles of TB rows
// (all of them but on small levels, where the batch is split so that the
// grid covers the card). Its work items, one (tile, batch tile) each, go
// through two ring stages in shared memory: each stages, once, the
// vertices' dy rows (row r = v·tb + b), the tile's distinct source rows of
// x (entry local·TB + b) and the tile's rows of `local`, by 16-byte
// cp.async where a row is whole 16-byte pieces on 16-byte boundaries,
// value by value otherwise (the final conv's 3-channel dy, the `bfloat16`
// policy's 3-channel x). The next item's copies are in flight while this
// one is multiplied, the source indices and vertices of the item after it
// land in shared memory meanwhile, and the offsets of the item after
// that (all by cp.async, so no register waits on a load across items:
// no chain of dependent loads stands between two items' products; dy
// copied value by value is loaded an item ahead). Every position's
// product is formed from the staged rows: A (x^T, channels x rows) by
// transposing ldmatrix loads whose 8 row addresses are each lane's staged
// entry local[v, l] (rows past the tile read a zero entry), B (dy, rows x
// C_out) by transposing ldmatrix loads, mma.sync m16n8k16 bf16 with fp32
// accumulators in registers across all of the chunk's items. A unit is
// one (position, 16 channels) row of dW fragments across all of C_out; a
// warp owns UPW units, so each k16 step's B fragments serve UPW·FN
// products and each A fragment FN. Strides are an odd number of 16-byte
// units, so 8 batch rows of one source row (or 8 dy rows) hit 8 distinct
// bank groups; batch tiles under 8 gather rows of different source rows
// into one ldmatrix, whose addresses may share a group (a conflict that
// stays). dy crosses from L2 to the SMs once per position group (once
// where P = L), x about 2 times per row on the decoder's levels.
//
// Each chunk's fp32 partial goes to a scratch buffer; a second kernel sums
// the chunks in chunk order and rounds once. No atomics: the result is the
// same every run, and the plain twin ops/spiral_conv.py::
// spiral_conv_dw_chunked_plain sums the chunks in the same order (inside a
// chunk the tensor cores' order differs from the twin's matmul: fp32
// rounding, within one bf16 ulp after the rounding).
//
// What bounds it on an H100: bytes at these widths (2·L·C_in·C_out flops
// per row of 2·(C_in + C_out) bytes); as measured (PERF.md, bf16_parts),
// its mma.sync products and each item's fixed cost, which add up.

#include "bf16.cuh"

namespace {

constexpr int kMaxWarps = 8;         // kernels.py's _DW_BF16_MAX_WARPS

// a row stride of `width` bf16 values and more, an odd number of 16-byte
// units (kernels.py's _odd_stride)
__host__ __device__ __forceinline__ int odd_stride(int width) {
  const int units = (width + 7) / 8;
  return 8 * (units % 2 ? units : units + 1);
}

__host__ __device__ __forceinline__ int round8(int n) { return (n + 7) & ~7; }

// The layout of one of the two ring stages, in bf16 values from the
// stage's start: x's entries [rows·TB + 1][xst] (the last one zero), dy's
// rows [round16(verts·TB)][dst], then the tile's local [verts][L] int32
// (kernels.py's _dw_bf16_stage).
struct Stage {
  int xst, dst, x_vals, d_vals, bytes;
};

__host__ __device__ __forceinline__ Stage stage_of(int C_in, int C_out,
                                                   int L, int rows, int verts,
                                                   int TB) {
  Stage s;
  s.xst = odd_stride(16 * ((C_in + 15) / 16));
  s.dst = odd_stride(8 * ((C_out + 7) / 8));
  s.x_vals = round8((rows * TB + 1) * s.xst);
  s.d_vals = round8(((verts * TB + 15) & ~15) * s.dst);
  s.bytes = 2 * (s.x_vals + s.d_vals) + ((4 * verts * L + 15) & ~15);
  return s;
}

struct Args {
  const __nv_bfloat16* x;
  const __nv_bfloat16* dy;
  const int* verts;
  const int* starts;
  const int* src;
  const int* src_off;
  const int* local;
  float* part;
  int L, B, C_in, C_out, TB, n_btiles, tpc, bpc, n_bgroups, n_tiles, P;
  int rows, verts_cap, vec_x, vec_d;
};

constexpr int kDyVals = 8;           // dy values a thread loads an item
//                                      ahead where they are copied one by one

// ints after the two ring stages: the offsets of the block's next four
// items (src_off[t], src_off[t + 1], starts[t], starts[t + 1] each), and
// the source rows and vertices of its next two items (kernels.py's
// _dw_bf16_tail)
__host__ __device__ __forceinline__ int tail_ints(int rows, int verts) {
  return 16 + ((2 * (rows + verts) + 3) & ~3);
}

// At most 128 registers, so that two blocks share an SM.
template <int FN, int UPW>
__global__ void __launch_bounds__(32 * kMaxWarps, 2)
spiral_conv_dw_bf16_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Stage st = stage_of(a.C_in, a.C_out, a.L, a.rows, a.verts_cap, a.TB);
  const int FM = (a.C_in + 15) >> 4;
  const int chunk = blockIdx.x;
  const int tg = chunk / a.n_bgroups, bg = chunk - tg * a.n_bgroups;
  const int t0 = tg * a.tpc, t1 = min(a.n_tiles, t0 + a.tpc);
  const int bt0 = bg * a.bpc, nb = min(a.bpc, a.n_btiles - bt0);
  const int n_items = (t1 - t0) * nb;             // batch tiles fastest
  const int l0 = blockIdx.y * a.P;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int units = min(a.P, a.L - l0) * FM;
  const int zero = a.rows * a.TB;                 // the zero entry
  // ldmatrix rows of this lane: A's matrix q = lane / 8 is (rows 8·(q/2),
  // channels 8·(q%2)) of a 16 x 16 block; B's rows 8·(q%2), columns
  // 8·(q/2) of two column tiles
  const int a_row = ((lane >> 4) << 3) + (lane & 7);
  const int a_col = (lane >> 3 & 1) << 3;
  const int b_row = ((lane >> 3 & 1) << 3) + (lane & 7);
  const int b_col = (lane >> 4) << 3;
  // this warp's units: position l0 + u / FM, channels 16·(u % FM)
  int u_l[UPW], u_c[UPW];
#pragma unroll
  for (int i = 0; i < UPW; ++i) {
    const int u = min(warp * UPW + i, units - 1);
    u_l[i] = l0 + u / FM;
    u_c[i] = (u - (u / FM) * FM) * 16 + a_col;
  }
  for (int s = 0; s < 2; ++s) {                   // the zero entries
    uint16_t* xs = reinterpret_cast<uint16_t*>(smem + s * st.bytes);
    for (int i = threadIdx.x; i < st.xst; i += blockDim.x)
      xs[zero * st.xst + i] = 0;
  }

  // The pipeline, all through shared memory (no register waits on a load
  // across items): the group committed while item j is multiplied holds
  // item j + 1's rows, item j + 2's source rows and vertices and item
  // j + 3's offsets, each copied from what the group before it landed.
  int* meta = reinterpret_cast<int*>(smem + 2 * st.bytes);      // [4][4]
  int* idx = meta + 16;                       // [2][rows + verts]
  const int slot = a.rows + a.verts_cap;
  auto tile_of = [&](int j) { return t0 + j / nb; };
  auto tb_of = [&](int j) {
    return min(a.TB, a.B - (bt0 + j - (j / nb) * nb) * a.TB);
  };
  auto b0_of = [&](int j) { return (bt0 + j - (j / nb) * nb) * a.TB; };
  auto copy_meta = [&](int j) {
    if (j < n_items && threadIdx.x < 4) {
      const int k = threadIdx.x;
      cp_async4(meta + (j & 3) * 4 + k,
                (k < 2 ? a.src_off : a.starts) + tile_of(j) + (k & 1));
    }
  };
  auto copy_idx = [&](int j) {
    if (j >= n_items) return;
    const int* mt = meta + (j & 3) * 4;
    const int s0 = mt[0], rows = mt[1] - s0, v0 = mt[2], nv = mt[3] - v0;
    int* si = idx + (j & 1) * slot;
    for (int i = threadIdx.x; i < rows + nv; i += blockDim.x) {
      if (i < rows)
        cp_async4(si + i, a.src + s0 + i);
      else
        cp_async4(si + a.rows + i - rows, a.verts + v0 + i - rows);
    }
  };
  // item j's rows into its stage: the tile's rows of local; x: the tile's
  // source rows, tb batch rows each, contiguous in x; dy: vertex v's tb
  // batch rows, contiguous in dy, at rows v·tb + b (where its rows are not
  // whole 16-byte pieces: scalar_dy); rows past nv·tb up to the next 16
  // are zero
  auto copy_rows = [&](int j) {
    if (j >= n_items) return;
    unsigned char* base = smem + (j & 1) * st.bytes;
    uint16_t* xs = reinterpret_cast<uint16_t*>(base);
    uint16_t* ds = xs + st.x_vals;
    int* ls = reinterpret_cast<int*>(ds + st.d_vals);
    const int* mt = meta + (j & 3) * 4;
    const int rows = mt[1] - mt[0], v0 = mt[2], nv = mt[3] - v0;
    const int* si = idx + (j & 1) * slot;
    const int* vi = si + a.rows;
    const int b0 = b0_of(j), tb = tb_of(j);
    for (int i = threadIdx.x; i < nv * a.L; i += blockDim.x)
      cp_async4(ls + i, a.local + (size_t)v0 * a.L + i);
    if (a.vec_x) {
      stage_rows(xs, a.TB * st.xst, st.xst, a.x + (size_t)b0 * a.C_in,
                 (size_t)a.B * a.C_in, si, rows, tb, a.C_in >> 3, true);
    } else {                          // value by value, zeros past C_in
      const int width = 16 * ((a.C_in + 15) >> 4);
      const int per_row = tb * width;
      for (int k = threadIdx.x; k < rows * per_row; k += blockDim.x) {
        const int d = k / per_row;
        const int jj = k - d * per_row;
        const int b = jj / width, c = jj - b * width;
        xs[(d * a.TB + b) * st.xst + c] =
            c < a.C_in ? bf16_bits(a.x[((size_t)si[d] * a.B + b0 + b) *
                                       a.C_in + c])
                       : 0;
      }
    }
    if (a.vec_d)
      stage_rows(ds, tb * st.dst, st.dst, a.dy + (size_t)b0 * a.C_out,
                 (size_t)a.B * a.C_out, vi, nv, tb, a.C_out >> 3, true);
    const int n_r = nv * tb;
    const int pad = ((n_r + 15) & ~15) - n_r;
    for (int i = threadIdx.x; i < pad * st.dst / 8; i += blockDim.x)
      *reinterpret_cast<uint4*>(ds + n_r * st.dst + 8 * i) =
          make_uint4(0, 0, 0, 0);
  };
  // dy value k of item j (its offsets and vertices landed): the thread's
  // first kDyVals load an item ahead, into registers
  auto dy_val = [&](int j, int k) {
    const int* vi = idx + (j & 1) * slot + a.rows;
    const int per_v = tb_of(j) * a.C_out;
    const int v = k / per_v;
    return bf16_bits(a.dy[((size_t)vi[v] * a.B + b0_of(j)) * a.C_out + k -
                          v * per_v]);
  };
  auto dy_put = [&](int j, int k, uint16_t val) {
    uint16_t* ds = reinterpret_cast<uint16_t*>(smem + (j & 1) * st.bytes) +
                   st.x_vals;
    const int per_v = tb_of(j) * a.C_out;
    const int v = k / per_v;
    const int jj = k - v * per_v;
    const int b = jj / a.C_out;
    ds[(v * tb_of(j) + b) * st.dst + jj - b * a.C_out] = val;
  };
  auto dy_total = [&](int j) {
    const int* mt = meta + (j & 3) * 4;
    return (mt[3] - mt[2]) * tb_of(j) * a.C_out;
  };
  const bool scalar_dy = !a.vec_d;

  float acc[UPW][FN][4];
#pragma unroll
  for (int i = 0; i < UPW; ++i)
#pragma unroll
    for (int n = 0; n < FN; ++n)
      acc[i][n][0] = acc[i][n][1] = acc[i][n][2] = acc[i][n][3] = 0.f;

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
  copy_rows(0);
  if (scalar_dy && n_items > 0)
    for (int k = threadIdx.x; k < dy_total(0); k += blockDim.x)
      dy_put(0, k, dy_val(0, k));
  cp_async_commit();
  for (int i = 0; i < n_items; ++i) {
    cp_async_wait<0>();
    __syncthreads();
    copy_rows(i + 1);
    uint16_t dv[kDyVals];
    const bool next_dy = scalar_dy && i + 1 < n_items;
    if (next_dy) {
      const int total = dy_total(i + 1);
#pragma unroll
      for (int u = 0; u < kDyVals; ++u) {
        const int k = threadIdx.x + u * blockDim.x;
        dv[u] = k < total ? dy_val(i + 1, k) : 0;
      }
    }
    copy_idx(i + 2);
    copy_meta(i + 3);
    cp_async_commit();

    const unsigned char* base = smem + (i & 1) * st.bytes;
    const uint16_t* xs = reinterpret_cast<const uint16_t*>(base);
    const uint16_t* ds = xs + st.x_vals;
    const int* ls = reinterpret_cast<const int*>(ds + st.d_vals);
    const int tb = tb_of(i);
    const int magic = div_magic(tb);
    const int n_r = (meta[(i & 3) * 4 + 3] - meta[(i & 3) * 4 + 2]) * tb;
    // KU k16 steps at a time: each step's B fragments and staged entries
    // first, then the A fragments and the products
    constexpr int KU = FN >= 8 ? 1 : 2;
    for (int k0 = 0; k0 < n_r; k0 += 16 * KU) {
      uint32_t bf[KU][FN][2];
      int ent[KU][UPW];
#pragma unroll
      for (int h = 0; h < KU; ++h) {
        const int kk = k0 + 16 * h;
        if (kk >= n_r) break;
#pragma unroll
        for (int n = 0; n + 1 < FN; n += 2) {
          uint32_t q[4];
          ldsm_x4_trans(q, ds + (kk + b_row) * st.dst + n * 8 + b_col);
          bf[h][n][0] = q[0];
          bf[h][n][1] = q[1];
          bf[h][n + 1][0] = q[2];
          bf[h][n + 1][1] = q[3];
        }
        if (FN % 2)
          ldsm_x2_trans(bf[h][FN - 1][0], bf[h][FN - 1][1],
                        ds + (kk + b_row) * st.dst + (FN - 1) * 8);
        // this lane's reduction row: vertex v, batch row b
        const int r = kk + a_row;
        const int v = div_by(r, magic);
        const int b = r - v * tb;
        const int* lrow = ls + v * a.L;
#pragma unroll
        for (int u = 0; u < UPW; ++u)
          ent[h][u] = r < n_r ? lrow[u_l[u]] * a.TB + b : zero;
      }
#pragma unroll
      for (int h = 0; h < KU; ++h) {
        if (k0 + 16 * h >= n_r) break;
#pragma unroll
        for (int u = 0; u < UPW; ++u) {
          uint32_t af[4];
          ldsm_x4_trans(af, xs + ent[h][u] * st.xst + u_c[u]);
#pragma unroll
          for (int n = 0; n < FN; ++n)
            mma_bf16(acc[u][n], af, bf[h][n][0], bf[h][n][1]);
        }
      }
    }
    if (next_dy) {                   // item i + 1's dy, one by one
      const int total = dy_total(i + 1);
#pragma unroll
      for (int u = 0; u < kDyVals; ++u) {
        const int k = threadIdx.x + u * blockDim.x;
        if (k < total) dy_put(i + 1, k, dv[u]);
      }
      for (int k = threadIdx.x + kDyVals * blockDim.x; k < total;
           k += blockDim.x)
        dy_put(i + 1, k, dy_val(i + 1, k));
    }
    __syncthreads();                 // before the stage is refilled
  }
  float* dst = a.part + (size_t)chunk * a.L * a.C_in * a.C_out;
#pragma unroll
  for (int u = 0; u < UPW; ++u) {
    if (warp * UPW + u >= units) break;
    const int c0 = u_c[u] - a_col + gid;
#pragma unroll
    for (int n = 0; n < FN; ++n)
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int c = c0 + (h < 2 ? 0 : 8);
        const int o = n * 8 + 2 * tig + (h & 1);
        if (c < a.C_in && o < a.C_out)
          dst[((size_t)u_l[u] * a.C_in + c) * a.C_out + o] = acc[u][n][h];
      }
  }
}

// out[i] = bf16(sum over chunks, in chunk order, of part[chunk][i]); the
// loads of 64 chunks are in flight before their adds
__global__ void __launch_bounds__(256)
spiral_conv_dw_bf16_sum(const float* __restrict__ part,
                        __nv_bfloat16* __restrict__ out, int n_chunks, int n) {
  constexpr int kAhead = 64;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = part[i];
  int c = 1;
  for (; c + kAhead <= n_chunks; c += kAhead) {
    float v[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j) v[j] = part[(size_t)(c + j) * n + i];
#pragma unroll
    for (int j = 0; j < kAhead; ++j) s = __fadd_rn(s, v[j]);
  }
  for (; c < n_chunks; ++c) s = __fadd_rn(s, part[(size_t)c * n + i]);
  out[i] = __float2bfloat16_rn(s);
}

template <int FN, int UPW>
int launch(const Args& a, int n_chunks, int groups, int warps, int smem,
           cudaStream_t s) {
  static int done = 0;
  const int e = set_smem(spiral_conv_dw_bf16_kernel<FN, UPW>, smem, done);
  if (e) return e;
  spiral_conv_dw_bf16_kernel<FN, UPW>
      <<<dim3(n_chunks, groups), 32 * warps, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

using Launch = int (*)(const Args&, int, int, int, int, cudaStream_t);

// the compiled (FN, UPW): UPW·FN <= 16 fragments a warp, UPW <= 4
Launch instance(int fn, int upw) {
  switch (fn * 8 + upw) {
    case 1 * 8 + 1: return launch<1, 1>;
    case 1 * 8 + 2: return launch<1, 2>;
    case 1 * 8 + 3: return launch<1, 3>;
    case 1 * 8 + 4: return launch<1, 4>;
    case 2 * 8 + 1: return launch<2, 1>;
    case 2 * 8 + 2: return launch<2, 2>;
    case 2 * 8 + 3: return launch<2, 3>;
    case 2 * 8 + 4: return launch<2, 4>;
    case 4 * 8 + 1: return launch<4, 1>;
    case 4 * 8 + 2: return launch<4, 2>;
    case 4 * 8 + 3: return launch<4, 3>;
    case 4 * 8 + 4: return launch<4, 4>;
    case 8 * 8 + 1: return launch<8, 1>;
    case 8 * 8 + 2: return launch<8, 2>;
    case 16 * 8 + 1: return launch<16, 1>;
    default: return nullptr;
  }
}

}  // namespace

// K2-dW-bf16 for x [N_src, B, C_in], dy [M, B, C_out] (bf16) through the
// op's vertex tiles (ops.SpiralTiles: verts [M], starts and src_off
// [n_tiles + 1], src, local [M, L]); part: n_chunks·L·C_in·C_out floats of
// scratch; out [L, C_in, C_out] bf16. The plan (kernels.py,
// plan_spiral_conv_dw_bf16): fn column fragments of 8 (8·fn >= C_out), upw
// units a warp and warps (warps·upw >= P·ceil(C_in / 16)), P positions a
// block in ceil(L / P) groups, tb batch rows an item in n_btiles batch
// tiles, tpc tiles and bpc batch tiles a chunk in n_chunks = ceil(n_tiles /
// tpc)·n_bgroups chunks (n_bgroups = ceil(n_btiles / bpc)), rows and
// verts (the most source rows and vertices a tile has), vec_x / vec_d
// (16-byte copies; rows of whole 16-byte pieces on 16 bytes), smem (two
// ring stages). Returns a cudaError_t.
extern "C" int cfs_spiral_conv_dw_bf16(
    const void* x, const int* verts, const int* starts, const int* src,
    const int* src_off, const int* local, const void* dy, float* part,
    void* out, int M, int L, int B, int C_in, int C_out, int n_tiles,
    const int* plan, void* stream) {
  enum { FN, UPW, WARPS, P, TB, NBT, TPC, BPC, NCH, ROWS, VERTS, VECX, VECD,
         SMEM };
  const Launch run = instance(plan[FN], plan[UPW]);
  const int groups = plan[P] > 0 ? (L + plan[P] - 1) / plan[P] : 0;
  const int FM = (C_in + 15) / 16;
  const int n_bgroups = plan[BPC] > 0 ? (plan[NBT] + plan[BPC] - 1) / plan[BPC]
                                      : 0;
  const Stage st = stage_of(C_in, C_out, L, plan[ROWS], plan[VERTS],
                            plan[TB]);
  if (!run || M < 1 || L < 1 || B < 1 || C_in < 1 || C_out < 1 ||
      8 * plan[FN] < C_out || plan[WARPS] < 1 || plan[WARPS] > kMaxWarps ||
      plan[P] < 1 || groups > 65535 ||
      plan[WARPS] * plan[UPW] < plan[P] * FM || plan[TB] < 1 ||
      plan[NBT] != (B + plan[TB] - 1) / plan[TB] || n_tiles < 1 ||
      plan[TPC] < 1 || plan[BPC] < 1 ||
      plan[NCH] != (n_tiles + plan[TPC] - 1) / plan[TPC] * n_bgroups ||
      plan[ROWS] < 1 || plan[VERTS] < 1 || plan[SMEM] > 232448 ||
      (long long)plan[SMEM] < 2LL * st.bytes +
                                  4LL * tail_ints(plan[ROWS], plan[VERTS]) ||
      (plan[VECX] && (C_in % 8 || misaligned(x))) ||
      (plan[VECD] && (C_out % 8 || misaligned(dy))))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const __nv_bfloat16*>(x),
         static_cast<const __nv_bfloat16*>(dy), verts, starts, src, src_off,
         local, part, L, B, C_in, C_out, plan[TB], plan[NBT], plan[TPC],
         plan[BPC], n_bgroups, n_tiles, plan[P], plan[ROWS], plan[VERTS],
         plan[VECX], plan[VECD]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int e = run(a, plan[NCH], groups, plan[WARPS], plan[SMEM], s);
  if (e) return e;
  const int n = L * C_in * C_out;
  spiral_conv_dw_bf16_sum<<<(n + 255) / 256, 256, 0, s>>>(
      part, static_cast<__nv_bfloat16*>(out), plan[NCH], n);
  return static_cast<int>(cudaGetLastError());
}

// K7: the rasterizer's z-buffer sweep, for a batch of meshes in one launch.
//
// Replaces craniofacialsd_vae_tpu/viz/raster_pallas.py::_zbuffer_sweep
// (the Pallas kernel _sweep_kernel). For every pixel of every mesh, over
// all triangles whose three normalized edge functions are >= 0 and whose
// affine depth is > 1e-6, it finds the least depth and, among the
// triangles at that depth, the lowest index. Outputs: z [B, P] (a miss
// keeps 3.4e38) and winner [B, P] (a miss keeps 2^31 - 1).
//
// Inputs, per mesh b: coef [Fp, 16], per triangle (A, B, C) of the three
// edge functions and of the depth, evaluated as (A·px + B·py) + C at the
// pixel centre, Fp a multiple of the 256-triangle block; box [Fp, 4], the
// triangle's screen box widened by a margin that rounding cannot cross
// (viz/raster.py::_triangle_boxes; empty for degenerate and padding
// triangles, the whole plane where the margin cannot be bounded);
// block_box [nb, 4], the union of each block's boxes; ymin/ymax [nb], each
// block's row range, which the plain twin culls by per 1024-pixel strip.
//
// Invariant: pixel p is evaluated against triangle t only if (a) the
// twin's strip cull keeps (p's strip, t's block) and (b) p's centre lies
// in t's box. (a) means no pair is evaluated that the twin skips; (b)
// drops only pairs that cannot be inside. So z and winner agree with the
// twin bit for bit: products and sums are rounded one by one
// (__fmul_rn, __fadd_rn) in the twin's order, and a strictly smaller depth
// in increasing triangle order keeps the lowest index on ties.
// viz/raster.py::sweep_pairs lists the pairs of this invariant.
//
// What bounds it on an H100: latency. A triangle of the serving mesh
// covers about 3 × 4 pixels, so the inside tests the pixels need are few
// (16 flops each) and the bytes are the coefficients read once and z and
// winner written once; what takes the time is finding, per pixel tile,
// the few triangles that reach it. The design: one block of 256 threads
// per 16 × 16 pixel tile and mesh (grid: tiles × meshes), one thread per
// pixel. The block keeps the 256-triangle blocks whose box union and row
// range meet the tile, compacted in shared memory; for each, every thread
// tests one triangle's box against the tile, __ballot_sync / __popc and
// an 8-warp prefix compact the survivors in increasing index order, and
// the survivors' coefficients and boxes go to shared memory (two buffers,
// so two barriers per block). Each pixel then sweeps them, skipping those
// whose box misses it. Each thread loads its triangle's box two blocks
// ahead and, if it survives, its coefficients one block ahead, so the
// loads wait behind the barriers of the block before. (zbest, ibest) stay
// in registers and nothing crosses blocks: no atomics.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;        // pixels per tile side
constexpr int kThreads = kTile * kTile;
constexpr int kWarps = kThreads / 32;
constexpr int kTriBlock = 256;   // triangles per coefficient block
constexpr float kNear = 1e-6f;
constexpr float kFar = 3.4e38f;
constexpr int kNoHit = 0x7fffffff;

__device__ __forceinline__ float affine(float a, float b, float c, float px,
                                        float py) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, px), __fmul_rn(b, py)), c);
}

struct Rect {          // pixel-centre range, inclusive
  float x0, x1, y0, y1;
};

__device__ __forceinline__ bool meets(const float4& b, const Rect& r) {
  return b.x <= r.x1 && b.y >= r.x0 && b.z <= r.y1 && b.w >= r.y0;
}

// The block-wide rank of each flagged thread in thread order, and the
// flag count. Ends with a barrier, after which `cnt` may be reused.
__device__ __forceinline__ int compact(bool flag, int* cnt, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned m = __ballot_sync(0xffffffffu, flag);
  if (lane == 0) cnt[warp] = __popc(m);
  __syncthreads();
  int base = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = cnt[w];
    base += w < warp ? c : 0;
    total += c;
  }
  return base + __popc(m & ((1u << lane) - 1u));
}

__global__ void __launch_bounds__(kThreads)
raster_sweep_kernel(const float4* __restrict__ coef,
                    const float4* __restrict__ box,
                    const float4* __restrict__ block_box,
                    const float* __restrict__ ymin,
                    const float* __restrict__ ymax, float* __restrict__ zout,
                    int* __restrict__ wout, int n_tblocks, int width,
                    int cull_tile, int tiles_x) {
  __shared__ float4 s_tri[2][kTriBlock][4];  // coef 0-11, box: 32 KB
  __shared__ int s_idx[2][kTriBlock];
  __shared__ int s_blocks[kTriBlock];
  __shared__ int s_cnt[2][kWarps];

  const int mesh = blockIdx.y;
  const size_t fp = (size_t)n_tblocks * kTriBlock;
  coef += (size_t)mesh * fp * 4;
  box += (size_t)mesh * fp;
  block_box += (size_t)mesh * n_tblocks;
  ymin += (size_t)mesh * n_tblocks;
  ymax += (size_t)mesh * n_tblocks;
  const int n_pix = width * width;

  const int tx0 = (blockIdx.x % tiles_x) * kTile;
  const int ty0 = (blockIdx.x / tiles_x) * kTile;
  const int col = tx0 + threadIdx.x % kTile;
  const int row = ty0 + threadIdx.x / kTile;
  const bool valid = col < width && row < width;
  const int gid = row * width + col;
  const float px = static_cast<float>(col) + 0.5f;
  const float py = static_cast<float>(row) + 0.5f;
  // this pixel's strip rows, as the twin compares them
  const int strip = gid / cull_tile;
  const float row_lo = static_cast<float>((strip * cull_tile) / width);
  const float row_hi =
      static_cast<float>(((strip + 1) * cull_tile - 1) / width + 1);
  // the tile's pixel centres, and the rows of the strips it meets
  const int x_last = min(tx0 + kTile, width) - 1;
  const int y_last = min(ty0 + kTile, width) - 1;
  const Rect tile = {tx0 + 0.5f, x_last + 0.5f, ty0 + 0.5f, y_last + 0.5f};
  const int s0 = (ty0 * width + tx0) / cull_tile;
  const int s1 = (y_last * width + x_last) / cull_tile;
  const float tile_lo = static_cast<float>((s0 * cull_tile) / width);
  const float tile_hi =
      static_cast<float>(((s1 + 1) * cull_tile - 1) / width + 1);
  const float4 kNever = make_float4(kFar, -kFar, kFar, -kFar);

  float zbest = kFar;
  int ibest = kNoHit;
  int buf = 0;
  for (int chunk = 0; chunk < n_tblocks; chunk += kTriBlock) {
    // the blocks of this chunk that can reach the tile, in order
    const int jt = chunk + threadIdx.x;
    bool keep = false;
    if (jt < n_tblocks)
      keep = meets(__ldg(block_box + jt), tile) &&
             __ldg(ymin + jt) <= tile_hi && __ldg(ymax + jt) >= tile_lo;
    int n_kept;
    const int rank = compact(keep, s_cnt[buf], n_kept);
    if (keep) s_blocks[rank] = jt;
    __syncthreads();
    buf ^= 1;

    // this thread's triangle of kept block q: its box (loaded two blocks
    // ahead) and, where the box meets the tile, its coefficients (one
    // block ahead)
    auto tri_of = [&](int q) {
      return (size_t)s_blocks[q] * kTriBlock + threadIdx.x;
    };
    float4 b_next = n_kept > 0 ? __ldg(box + tri_of(0)) : kNever;
    bool s_next = meets(b_next, tile);
    float4 c0 = kNever, c1 = kNever, c2 = kNever;
    if (s_next) {
      c0 = __ldg(coef + 4 * tri_of(0));
      c1 = __ldg(coef + 4 * tri_of(0) + 1);
      c2 = __ldg(coef + 4 * tri_of(0) + 2);
    }
    float4 b_after = n_kept > 1 ? __ldg(box + tri_of(1)) : kNever;
    for (int q = 0; q < n_kept; ++q) {
      const int j = s_blocks[q];
      const size_t t = tri_of(q);
      const float4 b = b_next, k0 = c0, k1 = c1, k2 = c2;
      const bool surv = s_next;
      b_next = b_after;
      s_next = meets(b_next, tile);   // false past the last kept block
      if (s_next) {
        const size_t u = tri_of(q + 1);
        c0 = __ldg(coef + 4 * u);
        c1 = __ldg(coef + 4 * u + 1);
        c2 = __ldg(coef + 4 * u + 2);
      }
      b_after = q + 2 < n_kept ? __ldg(box + tri_of(q + 2)) : kNever;
      const float bymin = __ldg(ymin + j), bymax = __ldg(ymax + j);
      int n_surv;
      const int slot = compact(surv, s_cnt[buf], n_surv);
      if (surv) {
        s_tri[buf][slot][0] = k0;
        s_tri[buf][slot][1] = k1;
        s_tri[buf][slot][2] = k2;
        s_tri[buf][slot][3] = b;
        s_idx[buf][slot] = static_cast<int>(t);
      }
      __syncthreads();
      if (valid && bymin <= row_hi && bymax >= row_lo) {
        for (int s = 0; s < n_surv; ++s) {
          const float4 bx = s_tri[buf][s][3];
          if (px < bx.x || px > bx.y || py < bx.z || py > bx.w) continue;
          // columns: a0 b0 c0 a1 | b1 c1 a2 b2 | c2 ad bd cd
          const float4 q0 = s_tri[buf][s][0];
          const float4 q1 = s_tri[buf][s][1];
          const float4 q2 = s_tri[buf][s][2];
          const float e0 = affine(q0.x, q0.y, q0.z, px, py);
          const float e1 = affine(q0.w, q1.x, q1.y, px, py);
          const float e2 = affine(q1.z, q1.w, q2.x, px, py);
          const float zv = affine(q2.y, q2.z, q2.w, px, py);
          if (e0 >= 0.f && e1 >= 0.f && e2 >= 0.f && zv > kNear &&
              zv < zbest) {
            zbest = zv;
            ibest = s_idx[buf][s];
          }
        }
      }
      buf ^= 1;
    }
    __syncthreads();                  // s_blocks is rewritten next chunk
  }
  if (valid) {
    const size_t o = (size_t)mesh * n_pix + gid;
    zout[o] = zbest;
    wout[o] = ibest;
  }
}

}  // namespace

extern "C" int cfs_raster_sweep(const float* coef, const float* box,
                                const float* block_box, const float* ymin,
                                const float* ymax, float* z, int* winner,
                                int batch, int n_tblocks, int width,
                                int cull_tile, void* stream) {
  const int n_pix = width * width;
  if (batch < 1 || batch > 65535 || n_tblocks < 1 || width < 1 ||
      cull_tile < 1 || cull_tile > n_pix)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_x = (width + kTile - 1) / kTile;
  raster_sweep_kernel<<<dim3(tiles_x * tiles_x, batch), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(coef),
      reinterpret_cast<const float4*>(box),
      reinterpret_cast<const float4*>(block_box), ymin, ymax, z, winner,
      n_tblocks, width, cull_tile, tiles_x);
  return static_cast<int>(cudaGetLastError());
}

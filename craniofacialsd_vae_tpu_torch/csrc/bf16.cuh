// Helpers shared by the bf16 tensor-core kernels K1-bf16 / K3a
// (spiral_conv_bf16.cu) and K2-dW-bf16 (spiral_conv_dw_bf16.cu): packing
// two bf16 values into a 32-bit fragment register, fragment loads from
// shared memory (ldmatrix, plain and .trans), mma.sync m16n8k16 in bf16
// with fp32 accumulators, the copies of staged rows and a division by a
// batch tile.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

__device__ __forceinline__ uint16_t bf16_bits(__nv_bfloat16 v) {
  return *reinterpret_cast<const uint16_t*>(&v);
}

// lo in the low half: the element of the lower index, as a 32-bit load of
// two neighbouring bf16 values places it
__device__ __forceinline__ uint32_t pack_bf16(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// Four 8x8 bf16 matrices from shared memory, each transposed: lanes
// 8q..8q+7 give the addresses (16 bytes each) of matrix q's 8 stored rows,
// and register q of lane (gid, tig) receives that matrix's elements
// (row 2tig, column gid) and (row 2tig + 1, column gid), the lower in the
// low half. For a matrix stored k-major (rows along the mma's depth) that
// is the A register of rows gid, depth 2tig..2tig+1, or the B register of
// column gid.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row)));
}

// Four 8x8 bf16 matrices from shared memory as stored: lanes 8q..8q+7
// give the addresses (16 bytes each) of matrix q's 8 rows, and register q
// of lane (gid, tig) receives that matrix's elements (row gid, columns
// 2tig and 2tig + 1), the lower in the low half. For a row-major 16x16 A
// whose matrices are (rows 0-7, depth 0-7), (rows 8-15, depth 0-7),
// (rows 0-7, depth 8-15), (rows 8-15, depth 8-15), that is mma_bf16's a.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row)));
}

// The same for two matrices (lanes 0-15 give the addresses).
__device__ __forceinline__ void ldsm_x2_trans(uint32_t& r0, uint32_t& r1,
                                              const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(smem_addr(row)));
}

// d += a · b for a 16x16 A (row-major) and a 16x8 B (column-major) in
// bf16, fp32 accumulators; lane (gid = lane / 4, tig = lane % 4) holds
// a = {A[gid][2tig..2tig+1], A[gid+8][2tig..], A[gid][2tig+8..],
// A[gid+8][2tig+8..]}, b = {B[2tig..2tig+1][gid], B[2tig+8..2tig+9][gid]}
// and d = D[gid][2tig], D[gid][2tig+1], D[gid+8][2tig], D[gid+8][2tig+1]
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Issues the cp.async copies of n staged rows: row d's tb·pieces pieces
// (8 bf16 values a piece where vec, else 2) lie contiguous at src +
// idx[d]·src_stride, and piece b·pieces + p lands at dst + d·dst_stride +
// b·entry + p·(8 or 2). Each warp copies whole rows, several a pass where
// a row has fewer than 32 pieces, so a lane's offsets within a row are
// worked out once and no copy needs a division.
__device__ __forceinline__ void stage_rows(uint16_t* dst, int dst_stride,
                                           int entry,
                                           const __nv_bfloat16* src,
                                           size_t src_stride, const int* idx,
                                           int n, int tb, int pieces,
                                           bool vec) {
  const int sh = vec ? 3 : 1;
  const int ppr = tb * pieces;                   // pieces a row
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  // piece jj of rows d0, d0 + step, ... below n
  auto copy = [&](int jj, int d0, int step) {
    const int b = jj / pieces;
    const int to = b * entry + ((jj - b * pieces) << sh), from = jj << sh;
    for (int d = d0; d < n; d += step) {
      uint16_t* t = dst + d * dst_stride + to;
      const __nv_bfloat16* f = src + idx[d] * src_stride + from;
      if (vec)
        cp_async16(t, f);
      else
        cp_async4(t, f);
    }
  };
  if (ppr >= 32) {
    for (int jj = lane; jj < ppr; jj += 32) copy(jj, warp, warps);
    return;
  }
  const int rpi = 32 / ppr;                      // rows a pass
  const int dr = lane / ppr;
  if (dr < rpi) copy(lane - dr * ppr, warp * rpi + dr, warps * rpi);
}

// r / tb for 0 <= r < 2^11 and 1 <= tb <= 16: (r·m) >> 20 with m =
// ceil(2^20 / tb) (div_magic), exact there
__host__ __device__ __forceinline__ int div_magic(int tb) {
  return ((1 << 20) + tb - 1) / tb;
}

__device__ __forceinline__ int div_by(int r, int magic) {
  return (r * magic) >> 20;
}

}  // namespace

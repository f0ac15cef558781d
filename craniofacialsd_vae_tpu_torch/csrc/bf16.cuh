// Helpers shared by the bf16 tensor-core kernels K1-bf16 / K3a
// (spiral_conv_bf16.cu) and K2-dW-bf16 (spiral_conv_dw_bf16.cu): packing
// two bf16 values into a 32-bit fragment register, fragment loads from
// shared memory (ldmatrix, plain and .trans) and mma.sync m16n8k16 in
// bf16 with fp32 accumulators.
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

}  // namespace

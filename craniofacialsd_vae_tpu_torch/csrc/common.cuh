// Helpers shared by the tensor-core kernels K1 (spiral_conv.cu) and K2-dW
// (spiral_conv_dw.cu): cp.async copies, bulk copies with their mbarriers,
// walks over copy chunks without integer division, and mma.sync m16n8k8
// TF32 in 3xTF32.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// wait until at most n groups are pending (n is uniform over the block)
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    case 7: cp_async_wait<7>(); break;
    default: cp_async_wait<8>(); break;
  }
}

// One bulk copy of `bytes` (a multiple of 16, both addresses on 16
// bytes) from global into shared memory, whose completion counts against
// the transaction bytes of the mbarrier `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// one arrival that also expects `bytes` more transaction bytes
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar,
                                                   int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Waits for the phase of parity `parity` of `bar` to complete. A phase
// that never completes traps (a launch error) instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  for (long long spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
    if (done) return;
    if (spins > (1LL << 24)) __trap();
  }
}

// orders this thread's shared-memory writes before later bulk copies
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// cvt.rna.tf32.f32 for finite a (round to nearest, ties away from zero,
// on the low 13 mantissa bits) in two integer operations: the compiler
// emulates the cvt with five, checking for infinities and NaNs
__device__ __forceinline__ uint32_t rna_tf32(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
}

// a = hi + lo with hi = rna_tf32(a) and lo = rna_tf32(a - hi)
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi,
                                           uint32_t& lo) {
  hi = rna_tf32(a);
  lo = rna_tf32(a - __uint_as_float(hi));
}

// d += a · b for a 16x8 A (row-major) and an 8x8 B (column-major) in TF32;
// lane (gid = lane / 4, tig = lane % 4) holds a = A[gid][tig],
// A[gid + 8][tig], A[gid][tig + 4], A[gid + 8][tig + 4], b = B[tig][gid],
// B[tig + 4][gid] and d = D[gid][2 tig], D[gid][2 tig + 1],
// D[gid + 8][2 tig], D[gid + 8][2 tig + 1]
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Digits (i, b, c) of chunk threadIdx.x in a walk over tm x tb x ch
// chunks, and the digit increments of one step of blockDim.x chunks:
// a walk then needs no division per chunk.
struct Walk {
  int i, b, c, ai, ab, ac;
};

__device__ __forceinline__ Walk walk_of(int ch, int tb) {
  Walk w;
  const int q = threadIdx.x / ch, n1 = blockDim.x / ch;
  w.c = threadIdx.x - q * ch;
  w.i = q / tb;
  w.b = q - w.i * tb;
  w.ac = blockDim.x - n1 * ch;
  w.ai = n1 / tb;
  w.ab = n1 - w.ai * tb;
  return w;
}

__device__ __forceinline__ void step(Walk& w, int ch, int tb) {
  w.c += w.ac;
  if (w.c >= ch) { w.c -= ch; ++w.b; }
  w.b += w.ab;
  if (w.b >= tb) { w.b -= tb; ++w.i; }
  w.i += w.ai;
}

// Opts `kern` in to `smem` bytes of dynamic shared memory, once per size
// and kernel (`done` is that kernel's largest size so far).
template <typename Kernel>
int set_smem(Kernel* kern, int smem, int& done) {
  if (smem <= 48 * 1024 || smem <= done) return 0;
  done = smem;
  return static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

inline bool misaligned(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 != 0;
}

}  // namespace

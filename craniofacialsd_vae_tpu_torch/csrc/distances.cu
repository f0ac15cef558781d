// K8: the chamfer's nearest-neighbour distances and their gradient.
//
// Replaces craniofacialsd_vae_tpu/ops/distances.py::nearest_dists_sq_sym
// (an XLA op: per 4,096-column chunk, ‖x‖² + ‖y‖² − 2x·y at HIGHEST
// precision, min-reduced along both axes) and the gradient JAX's autodiff
// takes through it (the reduce_min and minimum JVPs, transposed).
//
// Both clouds are centred on mu = mean(y) (passed in; the JAX function
// centres them first too, so that the expansion's cancellation error
// scales with the cloud's size, not with its frame offset). All
// arithmetic is fp32 on the CUDA cores: K = 3 gives the tensor cores
// nothing to do, and TF32 would blur nearest-neighbour ties.
//
// cfs_nearest_sq (k8_fwd): for every query point i of batch r,
//   d[r, i] = max(0, ‖ũ_i‖² + min_j (‖ṽ_j‖² − 2 ũ_i·ṽ_j)),
//   idx[r, i] = the first j reaching that minimum.
// The symmetric chamfer launches it twice with the roles swapped. A cloud
// is either per batch (stride n·3) or shared by every batch (stride 0):
// the fit's restarts share one target.
//
// What bounds it on an H100: operations. Per pair it needs three fused
// multiply-adds and a compare (the query's own norm is added once, after
// the minimum); the bytes are each point read once. The design: one
// thread per query point, 128 a block (grid: query tiles × batches); the
// other cloud streams through shared memory in tiles of 2,048 points, each
// stored once per block as (−2ṽ, ‖ṽ‖²) so that a pair is three FMAs; every
// thread of a warp reads the same entry (a broadcast). Each thread keeps
// its row's running minimum and the first index reaching it (a strict <
// in increasing j). The pair matrix is formed twice (once per direction):
// JAX reduces each chunk along both axes while it is hot, and one pass
// doing the same is left for later.
//
// cfs_nearest_sq_bwd (k8_bwd): with g_u, g_v the cotangents of d_u, d_v,
//   out[r, i] = 2·g_u[r,i]·[d_u>0]·(ũ_i − ṽ_{idx_u(i)})
//             + Σ_{j : idx_v(r,j) = i} 2·g_v[r,j]·[d_v>0]·(ũ_i − ṽ_j).
// The sum over j is a scatter; it is walked as a gather instead, through
// a per-call CSR of idx_v (perm: the j sorted stably by idx_v; offsets:
// each i's segment), in increasing j: no atomics, so the sum's order is
// fixed and the fit's choice among restarts does not depend on a race.
// JAX splits a cotangent equally among tied minima (reduce_min's JVP
// divides by the tie count, minimum gives half to each side across
// chunks); the first argmin gives the whole of it to one of them. That is
// the same total wherever the tied points are identical, as with the
// fit's target padding (copies of its first point). One thread per (r, i);
// bound by bytes (each query, cotangent and index read once, the segment's
// points gathered).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 2048;

__device__ __forceinline__ float3 centred(const float* p, const float* mu) {
  return make_float3(p[0] - mu[0], p[1] - mu[1], p[2] - mu[2]);
}

__device__ __forceinline__ float norm2(float3 a) {
  return fmaf(a.z, a.z, fmaf(a.y, a.y, a.x * a.x));
}

__global__ void __launch_bounds__(kThreads)
nearest_sq_kernel(const float* __restrict__ query, int q_stride, int nq,
                  const float* __restrict__ ref, int r_stride, int nr,
                  const float* __restrict__ mu, float* __restrict__ d,
                  int* __restrict__ idx) {
  __shared__ float4 tile[kTile];
  const int r = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const float* q_pts = query + static_cast<long>(r) * q_stride;
  const float* r_pts = ref + static_cast<long>(r) * r_stride;
  float3 u = make_float3(0.f, 0.f, 0.f);
  if (i < nq) u = centred(q_pts + 3L * i, mu);
  float best = 3.402823466e38f;
  int arg = 0;
  for (int base = 0; base < nr; base += kTile) {
    const int n = min(kTile, nr - base);
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const float3 v = centred(r_pts + 3L * (base + j), mu);
      tile[j] = make_float4(-2.f * v.x, -2.f * v.y, -2.f * v.z, norm2(v));
    }
    __syncthreads();
#pragma unroll 8
    for (int j = 0; j < n; ++j) {
      const float4 s = tile[j];
      const float e = fmaf(u.x, s.x, fmaf(u.y, s.y, fmaf(u.z, s.z, s.w)));
      if (e < best) {
        best = e;
        arg = base + j;
      }
    }
    __syncthreads();
  }
  if (i < nq) {
    const long o = static_cast<long>(r) * nq + i;
    d[o] = fmaxf(norm2(u) + best, 0.f);
    idx[o] = arg;
  }
}

__global__ void __launch_bounds__(kThreads)
nearest_sq_bwd_kernel(const float* __restrict__ query, int q_stride, int nq,
                      const float* __restrict__ ref, int r_stride, int nr,
                      const float* __restrict__ mu,
                      const float* __restrict__ g_u,
                      const float* __restrict__ d_u,
                      const int* __restrict__ idx_u,
                      const float* __restrict__ g_v,
                      const float* __restrict__ d_v,
                      const int* __restrict__ perm,
                      const int* __restrict__ offsets,
                      float* __restrict__ out) {
  const int r = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= nq) return;
  const float* q_pts = query + static_cast<long>(r) * q_stride;
  const float* r_pts = ref + static_cast<long>(r) * r_stride;
  const long o = static_cast<long>(r) * nq + i;
  const float3 u = centred(q_pts + 3L * i, mu);
  float3 acc = make_float3(0.f, 0.f, 0.f);
  if (d_u[o] > 0.f) {
    const float c = 2.f * g_u[o];
    const float3 v = centred(r_pts + 3L * idx_u[o], mu);
    acc = make_float3(c * (u.x - v.x), c * (u.y - v.y), c * (u.z - v.z));
  }
  const long row = static_cast<long>(r) * nr;
  const int* seg = offsets + static_cast<long>(r) * (nq + 1);
  for (int k = seg[i]; k < seg[i + 1]; ++k) {
    const int j = perm[row + k];
    if (d_v[row + j] > 0.f) {
      const float c = 2.f * g_v[row + j];
      const float3 v = centred(r_pts + 3L * j, mu);
      acc.x += c * (u.x - v.x);
      acc.y += c * (u.y - v.y);
      acc.z += c * (u.z - v.z);
    }
  }
  out[3 * o] = acc.x;
  out[3 * o + 1] = acc.y;
  out[3 * o + 2] = acc.z;
}

}  // namespace

extern "C" int cfs_nearest_sq(const float* query, int q_stride, int nq,
                              const float* ref, int r_stride, int nr,
                              const float* mu, int batch, float* d, int* idx,
                              void* stream) {
  if (nq < 1 || nr < 1 || batch < 1 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((nq + kThreads - 1) / kThreads, batch);
  nearest_sq_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      query, q_stride, nq, ref, r_stride, nr, mu, d, idx);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cfs_nearest_sq_bwd(const float* query, int q_stride, int nq,
                                  const float* ref, int r_stride, int nr,
                                  const float* mu, int batch,
                                  const float* g_u, const float* d_u,
                                  const int* idx_u, const float* g_v,
                                  const float* d_v, const int* perm,
                                  const int* offsets, float* out,
                                  void* stream) {
  if (nq < 1 || nr < 1 || batch < 1 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((nq + kThreads - 1) / kThreads, batch);
  nearest_sq_bwd_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      query, q_stride, nq, ref, r_stride, nr, mu, g_u, d_u, idx_u, g_v, d_v,
      perm, offsets, out);
  return static_cast<int>(cudaGetLastError());
}

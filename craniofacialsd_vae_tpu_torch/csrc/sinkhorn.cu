// K8-sinkhorn: the log-space Sinkhorn divergence of two point clouds and
// its gradient, fp32 on the CUDA cores, for sm_90a.
//
// Replaces craniofacialsd_vae_tpu/ops/distances.py::sinkhorn_divergence
// (lines 103-131; XLA on the TPU, over a materialised [P, Q] cost):
//
//   C[i, j] = max(|x_i|^2 + |y_j|^2 - 2 x_i . y_j, 0)
//   n_iters times:  f_i = -eps LSE_j((g_j - C[i, j]) / eps + log nu)
//                   g_j = -eps LSE_i((f_i - C[i, j]) / eps + log mu)
//   out = sum_ij exp((f_i + g_j - C[i, j]) / eps + log mu + log nu) C[i, j]
//
// with mu = 1/P and nu = 1/Q, f and g from zeros, and its VJP as JAX's
// autodiff forms it through the scan.
//
// What bounds it on an H100: operations. Every pass recomputes C from
// the clouds (a few FP32 instructions a pair) and takes one exponential
// (two in the backward's) a pair: P * Q * (2 n_iters + 1) pairs forward.
// The bytes are the clouds and the potentials, kilobytes. The [P, Q]
// cost (2.1 GB at 16,386 x 32,768) is never written. The design:
//
// - One pass kernel, `pair_pass`, reduces over the columns for each row:
//   a block owns 64 rows; its 256 threads are four column splits of 64
//   rows, each warp 32 rows of one split, so a warp reads each staged
//   column once, a broadcast from shared memory. The block stages 256
//   columns at a time (coordinates, |b|^2 and the columns' exponent
//   terms), and split s takes columns 64 s to 64 s + 63 of each stage in
//   order. A row's four split partials are merged in split order. Rows
//   and columns swap roles between the f pass (rows x, columns y) and the
//   g pass (rows y, columns x): C is computed the same way in both (the
//   products in coordinate order, |a|^2 + |b|^2 added first), so it is
//   the same bits in both.
// - Logs and exponentials are base 2 (exp2f), each exponent formed as a
//   row term plus a column term minus C log2(e) / eps.
// - Forward (`cfs_sinkhorn_fwd`): n_iters LSE passes of each kind, with an
//   online max and sum per row in a fixed order (the max of each run of
//   eight columns, one rescale a run), every iteration's f and g kept in
//   f_hist [n_iters + 1, P] and g_hist [n_iters + 1, Q] (row 0 zeros);
//   then the coupling pass (each row's sum of coupling * C) and one block
//   that adds the P row sums in a fixed order. 2 n_iters + 2 launches.
// - Backward (`cfs_sinkhorn_bwd`): the reverse sweep. With Q^t the
//   softmax over i of the g update and R^t the softmax over j of the f
//   update of iteration t, the cotangents are
//     Cbar = sbar pi (1 - C / eps) + sum_t (gbar^t_j Q^t + fbar^t_i R^t),
//     fbar^t = [t = T] fbar_out - sum_j gbar^t_j Q^t,
//     gbar^(t-1) = -sum_i fbar^t_i R^t,
//   and xbar_i = 2 sum_j Cbar[i, j] m[i, j] (x_i - y_j) (ybar alike), where
//   m is 1 above the clamp, 0 below and 1/2 at it (JAX's maximum splits
//   the cotangent at a tie; sinkhorn(x, x) ties on its diagonal). Each
//   term of Cbar factors into a row scalar times a column scalar times
//   an exponential, so each iteration is one row pass over x (fbar^t and
//   xbar's share) and one column pass over y (gbar^(t-1) and ybar's
//   share), after a row and a column pass of the output's own term:
//   2 n_iters + 2 launches, no atomics, no [P, Q] array; each point's
//   gradient is added by the one thread that owns it, pass after pass.
//
// The plain twin is ops/distances.py::sinkhorn_divergence_plain (torch
// over the materialised cost, autograd for the gradient); the card holds
// the two within a tolerance (chip_smoke.py phase 16).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;            // rows a block
constexpr int kSplits = 4;           // column splits of a block's rows
constexpr int kThreads = kRows * kSplits;
constexpr int kStage = 256;          // columns staged at a time
constexpr int kPerSplit = kStage / kSplits;
constexpr int kRun = 8;              // columns a rescale of the LSE
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kFar = -1e30f;       // an exponent past the last column

enum Mode { kLse, kCoupling, kOut, kBwd };

struct PassArgs {
  const float* rows;   // [R, 3]
  const float* cols;   // [N, 3]
  int R, N;
  float eps, k;        // k = log2(e) / eps
  // exponent terms (pot / eps + logw) * log2(e): rows' 1 and 2, columns'
  // 1 and 2 (a null potential is 0)
  const float* pr1; float lr1;
  const float* pr2; float lr2;
  const float* pc1; float lc1;
  const float* pc2; float lc2;
  const float* cs;     // kBwd: the columns' cotangent scalars
  const float* rs;     // kBwd: the rows' factor of E2 (null: the result)
  const float* init;   // kBwd: the rows' initial cotangent (null: 0)
  const float* gout;   // kOut: the output's cotangent [1]
  float* red;          // the rows' result
  float* grad;         // [R, 3]: kOut writes, kBwd adds
};

__device__ __forceinline__ float term(const float* pot, float lw, int i,
                                      float inv_eps) {
  const float p = pot ? pot[i] : 0.f;
  return (p * inv_eps + lw) * kLog2e;
}

__device__ __forceinline__ float norm2(float a, float b, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)),
                   __fmul_rn(c, c));
}

// C and the clamp's weight for one pair
__device__ __forceinline__ float pair_cost(float ax, float ay, float az,
                                           float aa, float bx, float by,
                                           float bz, float bb, float& m) {
  const float d = __fmaf_rn(az, bz, __fmaf_rn(ay, by, __fmul_rn(ax, bx)));
  const float raw = __fmaf_rn(-2.f, d, __fadd_rn(aa, bb));
  m = raw > 0.f ? 1.f : (raw == 0.f ? 0.5f : 0.f);
  return fmaxf(raw, 0.f);
}

template <int MODE>
__global__ void __launch_bounds__(kThreads) pair_pass(PassArgs p) {
  __shared__ float sx[kStage], sy[kStage], sz[kStage], sb[kStage];
  __shared__ float s1[kStage], s2[kStage], sc[kStage];
  __shared__ float part[kSplits][9][kRows];
  const int split = threadIdx.x / kRows, lr = threadIdx.x % kRows;
  const int i = blockIdx.x * kRows + lr;
  const bool live = i < p.R;
  const float inv_eps = 1.f / p.eps;
  float ax = 0.f, ay = 0.f, az = 0.f;
  if (live) {
    ax = p.rows[3 * i]; ay = p.rows[3 * i + 1]; az = p.rows[3 * i + 2];
  }
  const float aa = norm2(ax, ay, az);
  const float r1 = live ? term(p.pr1, p.lr1, i, inv_eps) : 0.f;
  const float r2 = live ? term(p.pr2, p.lr2, i, inv_eps) : 0.f;
  // kLse: running max and sum; else the sums the mode needs
  float mx = -INFINITY, acc[9];
#pragma unroll
  for (int q = 0; q < 9; ++q) acc[q] = 0.f;

  for (int j0 = 0; j0 < p.N; j0 += kStage) {
    __syncthreads();
    {
      const int j = j0 + threadIdx.x;
      const bool in = j < p.N;
      const float bx = in ? p.cols[3 * j] : 0.f;
      const float by = in ? p.cols[3 * j + 1] : 0.f;
      const float bz = in ? p.cols[3 * j + 2] : 0.f;
      sx[threadIdx.x] = bx; sy[threadIdx.x] = by; sz[threadIdx.x] = bz;
      sb[threadIdx.x] = norm2(bx, by, bz);
      s1[threadIdx.x] = in ? term(p.pc1, p.lc1, j, inv_eps) : kFar;
      s2[threadIdx.x] = in ? term(p.pc2, p.lc2, j, inv_eps) : kFar;
      sc[threadIdx.x] = (MODE == kBwd && in) ? p.cs[j] : 0.f;
    }
    __syncthreads();
    if (!live) continue;
    const int c0 = split * kPerSplit;
    for (int r = 0; r < kPerSplit; r += kRun) {
      if constexpr (MODE == kLse) {
        float a[kRun];
        float cm = -INFINITY;
#pragma unroll
        for (int u = 0; u < kRun; ++u) {
          const int c = c0 + r + u;
          float m;
          const float C = pair_cost(ax, ay, az, aa, sx[c], sy[c], sz[c],
                                    sb[c], m);
          a[u] = __fmaf_rn(-C, p.k, s1[c]);
          cm = fmaxf(cm, a[u]);
        }
        if (cm > mx) {
          acc[0] = acc[0] * exp2f(mx - cm);
          mx = cm;
        }
#pragma unroll
        for (int u = 0; u < kRun; ++u) acc[0] += exp2f(a[u] - mx);
      } else {
#pragma unroll
        for (int u = 0; u < kRun; ++u) {
          const int c = c0 + r + u;
          float m;
          const float C = pair_cost(ax, ay, az, aa, sx[c], sy[c], sz[c],
                                    sb[c], m);
          const float e1 = exp2f(__fmaf_rn(-C, p.k, r1 + s1[c]));
          if constexpr (MODE == kCoupling) {
            acc[0] = __fmaf_rn(e1, C, acc[0]);
          } else if constexpr (MODE == kOut) {
            acc[0] = __fmaf_rn(e1, C, acc[0]);
            const float t = e1 * (1.f - C * inv_eps) * m;
            acc[1] += t;
            acc[2] = __fmaf_rn(t, sx[c], acc[2]);
            acc[3] = __fmaf_rn(t, sy[c], acc[3]);
            acc[4] = __fmaf_rn(t, sz[c], acc[4]);
          } else {
            const float e2 = exp2f(__fmaf_rn(-C, p.k, r2 + s2[c]));
            const float w1 = sc[c] * e1;
            acc[0] += w1;
            const float t1 = w1 * m, t2 = e2 * m;
            acc[1] += t1;
            acc[2] = __fmaf_rn(t1, sx[c], acc[2]);
            acc[3] = __fmaf_rn(t1, sy[c], acc[3]);
            acc[4] = __fmaf_rn(t1, sz[c], acc[4]);
            acc[5] += t2;
            acc[6] = __fmaf_rn(t2, sx[c], acc[6]);
            acc[7] = __fmaf_rn(t2, sy[c], acc[7]);
            acc[8] = __fmaf_rn(t2, sz[c], acc[8]);
          }
        }
      }
    }
  }

  // the four splits' partials, merged in split order by split 0
  if constexpr (MODE == kLse) {
    part[split][0][lr] = mx;
    part[split][1][lr] = acc[0];
  } else {
#pragma unroll
    for (int q = 0; q < 9; ++q) part[split][q][lr] = acc[q];
  }
  __syncthreads();
  if (split != 0 || !live) return;
  float t[9];
  if constexpr (MODE == kLse) {
    float m = part[0][0][lr];
    for (int s = 1; s < kSplits; ++s) m = fmaxf(m, part[s][0][lr]);
    float sum = 0.f;
    for (int s = 0; s < kSplits; ++s)
      sum += part[s][1][lr] * exp2f(part[s][0][lr] - m);
    p.red[i] = -p.eps * kLn2 * (m + log2f(sum));
  } else {
#pragma unroll
    for (int q = 0; q < 9; ++q) {
      t[q] = part[0][q][lr];
      for (int s = 1; s < kSplits; ++s) t[q] += part[s][q][lr];
    }
  }
  if constexpr (MODE == kCoupling) {
    p.red[i] = t[0];
  } else if constexpr (MODE == kOut) {
    const float g = p.gout[0];
    p.red[i] = g * inv_eps * t[0];
    p.grad[3 * i] = 2.f * g * (t[1] * ax - t[2]);
    p.grad[3 * i + 1] = 2.f * g * (t[1] * ay - t[3]);
    p.grad[3 * i + 2] = 2.f * g * (t[1] * az - t[4]);
  } else if constexpr (MODE == kBwd) {
    const float red = (p.init ? p.init[i] : 0.f) - t[0];
    const float f2 = p.rs ? p.rs[i] : red;
    p.red[i] = red;
    const float w = t[1] + f2 * t[5];
    p.grad[3 * i] += 2.f * (w * ax - (t[2] + f2 * t[6]));
    p.grad[3 * i + 1] += 2.f * (w * ay - (t[3] + f2 * t[7]));
    p.grad[3 * i + 2] += 2.f * (w * az - (t[4] + f2 * t[8]));
  }
}

// out[0] = sum of part[0:n] in a fixed order: each thread's stride, then
// a fixed tree
__global__ void __launch_bounds__(1024)
fixed_sum(const float* part, int n, float* out) {
  __shared__ float s[1024];
  float acc = 0.f;
  for (int i = threadIdx.x; i < n; i += 1024) acc += part[i];
  s[threadIdx.x] = acc;
  __syncthreads();
  for (int w = 512; w > 0; w >>= 1) {
    if (threadIdx.x < w) s[threadIdx.x] += s[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = s[0];
}

template <int MODE>
int pass(const PassArgs& a, cudaStream_t st) {
  pair_pass<MODE><<<(a.R + kRows - 1) / kRows, kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

PassArgs base(const float* rows, const float* cols, int R, int N,
              float eps) {
  PassArgs a = {};
  a.rows = rows; a.cols = cols; a.R = R; a.N = N;
  a.eps = eps; a.k = kLog2e / eps;
  return a;
}

}  // namespace

// Forward: x [P, 3], y [Q, 3]; f_hist [n_iters + 1, P], g_hist [n_iters +
// 1, Q] (row 0 set to 0 here), part [P] scratch, out [1]. Returns a
// cudaError_t.
extern "C" int cfs_sinkhorn_fwd(const float* x, const float* y, int P,
                                int Q, float eps, int n_iters, float* f_hist,
                                float* g_hist, float* part, float* out,
                                void* stream) {
  if (P < 1 || Q < 1 || n_iters < 0 || !(eps > 0.f) ||
      (P + kRows - 1) / kRows > 2147483647 / kRows)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float log_mu = -logf(static_cast<float>(P));
  const float log_nu = -logf(static_cast<float>(Q));
  int rc = static_cast<int>(
      cudaMemsetAsync(f_hist, 0, sizeof(float) * P, st));
  if (!rc) rc = static_cast<int>(
      cudaMemsetAsync(g_hist, 0, sizeof(float) * Q, st));
  for (int t = 1; t <= n_iters && !rc; ++t) {
    PassArgs a = base(x, y, P, Q, eps);          // f: rows x, columns y
    a.pc1 = g_hist + (size_t)(t - 1) * Q; a.lc1 = log_nu;
    a.red = f_hist + (size_t)t * P;
    rc = pass<kLse>(a, st);
    if (rc) break;
    PassArgs b = base(y, x, Q, P, eps);          // g: rows y, columns x
    b.pc1 = f_hist + (size_t)t * P; b.lc1 = log_mu;
    b.red = g_hist + (size_t)t * Q;
    rc = pass<kLse>(b, st);
  }
  if (rc) return rc;
  PassArgs c = base(x, y, P, Q, eps);
  c.pr1 = f_hist + (size_t)n_iters * P; c.lr1 = log_mu;
  c.pc1 = g_hist + (size_t)n_iters * Q; c.lc1 = log_nu;
  c.red = part;
  rc = pass<kCoupling>(c, st);
  if (rc) return rc;
  fixed_sum<<<1, 1024, 0, st>>>(part, P, out);
  return static_cast<int>(cudaGetLastError());
}

// Backward: the cotangents xbar [P, 3] and ybar [Q, 3] of out for the
// cotangent gout [1], from the forward's f_hist and g_hist; fbar [P],
// gbar [2, Q] scratch. Returns a cudaError_t.
extern "C" int cfs_sinkhorn_bwd(const float* x, const float* y, int P,
                                int Q, float eps, int n_iters,
                                const float* f_hist, const float* g_hist,
                                const float* gout, float* fbar, float* gbar,
                                float* xbar, float* ybar, void* stream) {
  if (P < 1 || Q < 1 || n_iters < 0 || !(eps > 0.f))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float log_mu = -logf(static_cast<float>(P));
  const float log_nu = -logf(static_cast<float>(Q));
  const float* fT = f_hist + (size_t)n_iters * P;
  const float* gT = g_hist + (size_t)n_iters * Q;
  float* gcur = gbar;
  float* gnext = gbar + Q;
  // the output's term: fbar^T and xbar's share, gbar^T and ybar's share
  PassArgs o = base(x, y, P, Q, eps);
  o.pr1 = fT; o.lr1 = log_mu; o.pc1 = gT; o.lc1 = log_nu;
  o.gout = gout; o.red = fbar; o.grad = xbar;
  int rc = pass<kOut>(o, st);
  if (rc) return rc;
  PassArgs oc = base(y, x, Q, P, eps);
  oc.pr1 = gT; oc.lr1 = log_nu; oc.pc1 = fT; oc.lc1 = log_mu;
  oc.gout = gout; oc.red = gcur; oc.grad = ybar;
  rc = pass<kOut>(oc, st);
  for (int t = n_iters; t >= 1 && !rc; --t) {
    const float* ft = f_hist + (size_t)t * P;
    const float* gt = g_hist + (size_t)t * Q;
    const float* gp = g_hist + (size_t)(t - 1) * Q;
    // rows x: E1 = Q^t weighted by gbar^t, E2 = R^t by fbar^t
    PassArgs r = base(x, y, P, Q, eps);
    r.pr1 = ft; r.lr1 = log_mu; r.pc1 = gt; r.lc1 = 0.f;
    r.pr2 = ft; r.lr2 = 0.f; r.pc2 = gp; r.lc2 = log_nu;
    r.cs = gcur; r.rs = nullptr; r.init = t == n_iters ? fbar : nullptr;
    r.red = fbar; r.grad = xbar;
    rc = pass<kBwd>(r, st);
    if (rc) break;
    // rows y: E1 = R^t weighted by fbar^t, E2 = Q^t by gbar^t
    PassArgs c = base(y, x, Q, P, eps);
    c.pr1 = gp; c.lr1 = log_nu; c.pc1 = ft; c.lc1 = 0.f;
    c.pr2 = gt; c.lr2 = 0.f; c.pc2 = ft; c.lc2 = log_mu;
    c.cs = fbar; c.rs = gcur; c.init = nullptr;
    c.red = gnext; c.grad = ybar;
    rc = pass<kBwd>(c, st);
    float* tmp = gcur; gcur = gnext; gnext = tmp;
  }
  return rc;
}

// Wilson action of 2-D U(1) links with its analytic force and the force's
// own backward (a Hessian-vector product), for training through autograd.
//
// Replaces the TPU kernel l2hmc_tpu/ops/wilson.py:_build_pallas_kernels
// (fwd_kernel, bwd_kernel; entry wilson_action_pallas).  Links are
// (B, Lt, Lx, 2) float32 angles in the JAX layout, site i = t*Lx + s, link
// (i, mu) at index (b*d + i)*2 + mu with d = Lt*Lx.
//
//   P(t,s)     = u0 - u1 - u0(t, s+1) + u1(t+1, s)
//   forward    S[b] = sum_i (1 - cos P),  sinp = sin P
//   backward   F0 = g (sinP - sinP(t, s-1)),  F1 = g (-sinP + sinP(t-1, s))
//   double bw  for a cotangent w on F:
//              r  = w0 - w0(t, s+1) - w1 + w1(t+1, s)
//              h  = g cos P r
//              dlinks = (h - h(t, s-1), -h + h(t-1, s)),  dg[b] = sum_i r sinP
//
// What bounds it on an H100: bytes.  Each kernel does a handful of flops
// and one sincos per site against 8-16 bytes of device memory per site, so
// the memory rate (3.35 TB/s) sets the least time: ~0.12 us for the forward
// at (128, 16, 16, 2), ~7.5 us at (512, 64, 64, 2).  At the training shape
// a launch (~2-4 us) costs more than the work.
//
// Design: the TPU kernel's slice-concat shifts, its (block_b, Lx) row-sum
// output and its VMEM block sizing are not carried over.  Neighbour indices
// are computed directly; neighbour reads hit L1/L2.  The two kernels that
// reduce per chain (forward: S; double backward: dg) run one block per
// chain with threads striding over its sites and a warp-shuffle block sum,
// so the sums are deterministic and any Lt, Lx >= 2 and any B work without
// shared-memory limits.  The double backward recomputes h at the two
// neighbours a site's link gradient reads (3 sincos per site) rather than
// staging h in shared memory.  The force kernel is elementwise over B*d
// sites.  Every product and sum is formed in the plain version's order
// (no FMA pattern arises), so the force agrees with it bit for bit on the
// same sin P.

#include "chain_common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float plaquette(const float* __restrict__ u,
                                           int i, int lt, int lx) {
  return u[2 * i] - u[2 * i + 1] - u[2 * site_s_plus(i, lt, lx)] +
         u[2 * site_t_plus(i, lt, lx) + 1];
}

// h = g cos P r at site i of one chain (links u, cotangent w); also returns
// r and sin P there.
__device__ __forceinline__ float hvp_h(const float* __restrict__ u,
                                       const float* __restrict__ w, float g,
                                       int i, int lt, int lx, float* r_out,
                                       float* sin_out) {
  float sn, cs;
  sincosf(plaquette(u, i, lt, lx), &sn, &cs);
  const int sp = site_s_plus(i, lt, lx), tp = site_t_plus(i, lt, lx);
  const float r = w[2 * i] - w[2 * sp] - w[2 * i + 1] + w[2 * tp + 1];
  *r_out = r;
  *sin_out = sn;
  return (g * cs) * r;
}

__global__ void __launch_bounds__(kThreads)
wilson_fwd_kernel(const float* __restrict__ links, float* __restrict__ action,
                  float* __restrict__ sinp, int lt, int lx) {
  __shared__ float scratch[CHAIN_MAX_WARPS];
  __shared__ float total[1];
  const int d = lt * lx;
  const size_t b = blockIdx.x;
  const float* u = links + b * d * 2;
  float v[1] = {0.0f};
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    float sn, cs;
    sincosf(plaquette(u, i, lt, lx), &sn, &cs);
    sinp[b * d + i] = sn;
    v[0] += 1.0f - cs;
  }
  block_sum<1>(v, scratch, total);
  if (threadIdx.x == 0) action[b] = v[0];
}

__global__ void __launch_bounds__(kThreads)
wilson_bwd_kernel(const float* __restrict__ sinp, const float* __restrict__ g,
                  float* __restrict__ force, long long n, int lt, int lx) {
  const int d = lt * lx;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x; k < n;
       k += stride) {
    const long long b = k / d;
    const int i = (int)(k - b * d);
    const float* s = sinp + b * d;
    const float gb = g[b];
    force[2 * k] = gb * (s[i] - s[site_s_minus(i, lt, lx)]);
    force[2 * k + 1] = gb * (-s[i] + s[site_t_minus(i, lt, lx)]);
  }
}

__global__ void __launch_bounds__(kThreads)
wilson_bwd_bwd_kernel(const float* __restrict__ links,
                      const float* __restrict__ g,
                      const float* __restrict__ w,
                      float* __restrict__ dlinks, float* __restrict__ dg,
                      int lt, int lx) {
  __shared__ float scratch[CHAIN_MAX_WARPS];
  __shared__ float total[1];
  const int d = lt * lx;
  const size_t b = blockIdx.x;
  const float* u = links + b * d * 2;
  const float* wb = w + b * d * 2;
  float* out = dlinks + b * d * 2;
  const float gb = g[b];
  float v[1] = {0.0f};
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    float r, sn, r_nb, sn_nb;
    const float h = hvp_h(u, wb, gb, i, lt, lx, &r, &sn);
    const float h_sm =
        hvp_h(u, wb, gb, site_s_minus(i, lt, lx), lt, lx, &r_nb, &sn_nb);
    const float h_tm =
        hvp_h(u, wb, gb, site_t_minus(i, lt, lx), lt, lx, &r_nb, &sn_nb);
    out[2 * i] = h - h_sm;
    out[2 * i + 1] = -h + h_tm;
    v[0] += r * sn;
  }
  block_sum<1>(v, scratch, total);
  if (threadIdx.x == 0) dg[b] = v[0];
}

int chain_threads(int d) {
  const int nt = ((d + 31) / 32) * 32;
  return nt < kThreads ? nt : kThreads;
}

}  // namespace

extern "C" int wilson_fwd_launch(const float* links, float* action,
                                 float* sinp, int B, int lt, int lx,
                                 int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  if (B <= 0) return 0;
  wilson_fwd_kernel<<<B, chain_threads(lt * lx), 0, (cudaStream_t)stream>>>(
      links, action, sinp, lt, lx);
  return (int)cudaGetLastError();
}

extern "C" int wilson_bwd_launch(const float* sinp, const float* g,
                                 float* force, int B, int lt, int lx,
                                 int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  if (B <= 0) return 0;
  const long long n = (long long)B * lt * lx;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > (1 << 20)) blocks = 1 << 20;
  wilson_bwd_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      sinp, g, force, n, lt, lx);
  return (int)cudaGetLastError();
}

extern "C" int wilson_bwd_bwd_launch(const float* links, const float* g,
                                     const float* w, float* dlinks,
                                     float* dg, int B, int lt, int lx,
                                     int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  if (B <= 0) return 0;
  wilson_bwd_bwd_kernel<<<B, chain_threads(lt * lx), 0,
                          (cudaStream_t)stream>>>(links, g, w, dlinks, dg,
                                                  lt, lx);
  return (int)cudaGetLastError();
}

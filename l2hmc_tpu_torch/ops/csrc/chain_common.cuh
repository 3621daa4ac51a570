// Shared device code of the U(1) chain kernels (hmc_chain.cu, l2hmc_chain.cu,
// l2hmc_local_chain.cu).
//
// Link state is two flat fields per chain, one per direction, site index
// i = t*Lx + s.  Neighbour sites are computed directly:
//   (t, s+1), (t, s-1), (t+1, s), (t-1, s), all mod the lattice extents.
// Fields live in shared memory; every loop over sites is block-strided, so a
// block of any size covers any lattice.
#pragma once

#include <cuda_runtime.h>
#include <curand_kernel.h>
#include <math.h>
#include <stdint.h>

#define CHAIN_PI_F 3.14159265358979f
#define CHAIN_TWO_PI_F 6.28318530717959f
#define CHAIN_INV_TWO_PI_F 0.159154943091895f
#define CHAIN_MAX_WARPS 32

// x - 2 pi floor((x + pi) / 2 pi): angles into [-pi, pi), same op order as
// the plain version
__device__ __forceinline__ float wrap_angle(float x) {
  return x - CHAIN_TWO_PI_F * floorf((x + CHAIN_PI_F) / CHAIN_TWO_PI_F);
}

__device__ __forceinline__ int site_s_plus(int i, int lt, int lx) {
  int t = i / lx, s = i - t * lx;
  return t * lx + (s + 1 == lx ? 0 : s + 1);
}
__device__ __forceinline__ int site_s_minus(int i, int lt, int lx) {
  int t = i / lx, s = i - t * lx;
  return t * lx + (s == 0 ? lx - 1 : s - 1);
}
__device__ __forceinline__ int site_t_plus(int i, int lt, int lx) {
  int t = i / lx, s = i - t * lx;
  return (t + 1 == lt ? 0 : t + 1) * lx + s;
}
__device__ __forceinline__ int site_t_minus(int i, int lt, int lx) {
  int t = i / lx, s = i - t * lx;
  return (t == 0 ? lt - 1 : t - 1) * lx + s;
}

// Plaquette angle P = y0 - y1 - y0(t, s+1) + y1(t+1, s) at site i.
__device__ __forceinline__ float plaq_angle(const float* y0, const float* y1,
                                            int i, int lt, int lx) {
  return y0[i] - y1[i] - y0[site_s_plus(i, lt, lx)] +
         y1[site_t_plus(i, lt, lx)];
}

// Wilson force from the sine field: dS/du0 = sinP - sinP(t, s-1),
// dS/du1 = -sinP + sinP(t-1, s).
__device__ __forceinline__ float grad0(const float* sp, int i, int lt, int lx) {
  return sp[i] - sp[site_s_minus(i, lt, lx)];
}
__device__ __forceinline__ float grad1(const float* sp, int i, int lt, int lx) {
  return -sp[i] + sp[site_t_minus(i, lt, lx)];
}

// Winding-1 field of the instanton hop at site i: w1 = delta t;
// w0 = -delta lt s on the seam row t = lt-1, else 0 (delta = 2 pi / d).
__device__ __forceinline__ void winding(int i, int lt, int lx, float delta,
                                        float seam, float* w0, float* w1) {
  int t = i / lx, s = i - t * lx;
  *w1 = delta * (float)t;
  *w0 = (t == lt - 1) ? seam * (float)s : 0.0f;
}

// Closed-form rotation of a carried sin/cos plaquette pair by an accepted
// instanton hop: s' = s cda + c sda, c' = c cda - s sda.  Each product is
// rounded on its own (no FMA contraction), as the plain version rounds it:
// the carried fields are rotated again at every accepted hop and never
// recomputed, so a one-ulp difference per hop would accumulate.
__device__ __forceinline__ void hop_rotate(float* sp, float* cp, float cda,
                                           float sda) {
  const float s = *sp, c = *cp;
  *sp = __fadd_rn(__fmul_rn(s, cda), __fmul_rn(c, sda));
  *cp = __fsub_rn(__fmul_rn(c, cda), __fmul_rn(s, sda));
}

// a + b * c with the product and the sum each rounded (no FMA), as the plain
// version's leapfrog updates round them.  Contracted, the updates move some
// link angles an ulp away from the plain version's; at 64x64 (8192 links,
// K=8) that moved HMC's accept probability by up to ~1e-4.  Rounded like
// this, the links agree exactly.
__device__ __forceinline__ float add_mul_rn(float a, float b, float c) {
  return __fadd_rn(a, __fmul_rn(b, c));
}

// Per-site kinetic energy change (v0^2 + v1^2) - (w0^2 + w1^2), rounded term
// by term as the plain version rounds it.
__device__ __forceinline__ float kinetic_diff(float2 v, float w0, float w1) {
  return __fsub_rn(__fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y)),
                   __fadd_rn(__fmul_rn(w0, w0), __fmul_rn(w1, w1)));
}

// Sum each of v[0..NV) over the block; every thread gets the totals back in
// v.  scratch holds (blockDim.x / 32) * NV floats, out NV floats; blockDim.x
// is a multiple of 32 and at least NV.
template <int NV>
__device__ __forceinline__ void block_sum(float (&v)[NV], float* scratch,
                                          float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    float x = v[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    v[k] = x;
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < NV; ++k) scratch[warp * NV + k] = v[k];
  }
  __syncthreads();
  if (threadIdx.x < NV) {
    float s = 0.0f;
    for (int w = 0; w < nw; ++w) s += scratch[w * NV + threadIdx.x];
    out[threadIdx.x] = s;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < NV; ++k) v[k] = out[k];
}

// Counter-based randomness: the Philox stream of (chain, transition) is its
// own subsequence; `offset` (in 32-bit draws) separates the sites' draws
// (8 per site) from the per-chain scalar draws (offset 8*d).
__device__ __forceinline__ void philox_at(curandStatePhilox4_32_10_t* st,
                                          unsigned long long seed,
                                          long long chain, int n, int N,
                                          unsigned long long offset) {
  curand_init(seed, (unsigned long long)chain * (unsigned long long)N + n,
              offset, st);
}

// Initial momenta (v0, v1) of site i of `chain` in transition n: the
// injected arrays' entries (v0s non-null), else the chain's Philox draws at
// offset 8 i.  Called where the momenta are drawn and again for the energy
// change, which differences v^2 - w^2 per site before any sum, as the plain
// version does.  Differencing a thread's partial sums of v^2 and w^2 instead
// (each ~32 when a thread holds 16 sites, as at 64x64) would carry the
// rounding of those large sums into the energy change.
__device__ __forceinline__ float2 initial_momenta(
    const float* v0s, const float* v1s, unsigned long long seed,
    long long chain, int B, int n, int N, int d, int i) {
  if (v0s != nullptr) {
    const size_t o = ((size_t)n * B + chain) * d + i;
    return make_float2(v0s[o], v1s[o]);
  }
  curandStatePhilox4_32_10_t st;
  philox_at(&st, seed, chain, n, N, 8ull * i);
  return curand_normal2(&st);
}

__device__ __forceinline__ float sign_from_uniform(float u) {
  return u > 0.5f ? 1.0f : -1.0f;
}

// Host helper: makes `device` current for one launch entry and restores the
// caller's device when the entry returns, so a launch on another card never
// changes the current device of the caller's later allocations.
struct DeviceGuard {
  int prev = -1;
  cudaError_t err;
  explicit DeviceGuard(int device) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  }
  ~DeviceGuard() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

// Host helper: the largest dynamic shared memory a block may opt in to.
static inline int device_smem_optin(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return 0;
  return v;
}

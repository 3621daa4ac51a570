// Fused U(1) HMC chain: N transitions of every chain in one launch.
//
// Replaces the TPU kernel l2hmc_tpu/ops/leapfrog.py:_build_chain_kernel
// (entry hmc_chain_pallas).  Each transition: fresh momenta, K leapfrog steps
// with the analytic Wilson force and the mod-2pi wrap, the Hamiltonian and
// the MH accept with the carried potential / sine / cosine fields and charge,
// optionally one exact instanton hop computed from those carried fields (no
// extra plaquette pass).  Only the final links and three (N, B) traces
// (plaquette, unrounded charge, accept probability) reach device memory.
//
// What bounds it on an H100: per leapfrog step each site needs one
// plaquette (4 neighbour reads, sincos) and one force (2 neighbour reads), a
// few hundred operations per site; the rest is latency: the barriers
// between the phases that read a neighbour's site, and the reductions
// (energy change, hop).  The design keeps every barrier inside one chain and
// only the three fields that a neighbour reads on chip in shared memory:
//
// - Fields.  The proposal's links Y0, Y1 (read by the plaquette at (t, s+1)
//   and (t+1, s)) and its sine field SP1 (read by the force at (t, s-1) and
//   (t-1, s)) are the only fields another thread reads; they sit in shared
//   memory.  Every other per-site field is read and written only by the
//   thread that owns the site (slot k of a thread is site rank + k * size):
//   the momenta W0, W1, the initial kinetic term VV = v0^2 + v1^2 (one
//   momentum draw per site and transition serves the energy change too),
//   the proposal's cosine field CP1 and the accepted state X0, X1, SP, CP.
// - Routes, chosen per lattice by the host (ops/leapfrog.py
//   hmc_chain_plan) and compiled as template instantiations, not runtime
//   flags:
//   * warp (d <= 256): one chain per pair of warps (kChainWarps), 4 chains
//     per block, 4 sites per lane, every owned field in registers (the
//     accepted state too).  A chain's barrier is a named barrier of its 64
//     threads (bar.sync 1 + chain, 64), a reduction warp shuffles and one
//     exchange of the two warps' sums: no block-wide barrier anywhere, so
//     2048 chains at 16x16 run in one wave of 32 warps per SM.
//   * block (256 < d <= 8192): one chain per block of up to 512 threads,
//     8 or 16 sites per thread; W0, W1, VV, CP1 in registers, the accepted
//     state (read once per transition, written on accept or hop) in device
//     memory: X0, X1 in the link arrays, SP, CP in a scratch row.  The
//     block is the chain, so its barriers are the chain's; a reduction is
//     warp shuffles, one slot per warp in shared memory and one barrier.  At
//     64x64 two chains share an SM (48 KB of fields each, <= 64 registers
//     per thread), so 512 chains run in two waves.
//   * global (d > 8192): as the block route with every owned field in the
//     scratch row too; Y0, Y1, SP1 in shared memory while they fit (up to
//     ~19k sites), else in the scratch row as well.  Device memory is read
//     through L1/L2; this route is about admitting the lattice, not speed.
// - Site indices are opaque to the compiler inside the leapfrog loop
//   (opaque_index): hoisted out of it, each site's neighbour indices took 4
//   registers, which spilled the 64x64 route at 64 registers per thread.
// - Rounding as the plain version rounds: add_mul_rn, kinetic terms and
//   hop_rotate unfused (chain_common.cuh), the energy change a sum of
//   per-site differences.
//
// Randomness: injected arrays (v0s, v1s, us[, nus, uhs]), or Philox4_32_10
// keyed by (chain, transition) with the seed drawn by the caller; every
// thread draws the chain's scalars (accept and hop uniforms, hop sign) for
// itself, so none waits on another.

#include "chain_common.cuh"

namespace {

constexpr double kPiD = 3.141592653589793;
constexpr int kWarpChains = 4;       // warp route: chains per block
constexpr int kChainWarps = 2;       // warp route: warps per chain
constexpr int kWarpSites = 4;        // warp route: sites per lane
constexpr int kBlockThreads = 512;   // block / global routes: most threads
constexpr int kRedFloats = 2 * CHAIN_MAX_WARPS * 4;  // reduction slots

enum Route { kRouteWarp = 0, kRouteBlock = 1, kRouteGlobal = 2 };

struct HmcRand {
  const float *v0s, *v1s, *us, *nus, *uhs;
};

struct Geo {
  int B, lt, lx, d, K, N, hop;
  float eps, beta;
  unsigned long long seed;
  unsigned mlx;   // ceil(2^32 / lx): t = umulhi(i, mlx) for i * lx < 2^32
  int spt;        // sites per thread (the global route's runtime count)
  int fpc;        // scratch fields per chain (0, 2, 6 or 9)
  int nb_dev;     // global route: Y0, Y1, SP1 in the scratch row
};

// Per-site field owned by one thread: its R slots in registers, or (R = 0)
// slot k at p[k * stride] in device memory.
template <int R>
struct Own {
  float r[R > 0 ? R : 1];
  float* p;
  int stride;
  __device__ __forceinline__ float& operator[](int k) {
    if constexpr (R > 0)
      return r[k];
    else
      return p[k * stride];
  }
};

// The threads of one chain: GW warps (warp route) or the whole block (GW
// = 0).
template <int GW>
struct Team {
  int rank, size;
  int bar;     // GW > 1: the chain's named barrier
  float* red;  // 2 buffers x (GW or CHAIN_MAX_WARPS) x 4 partial sums

  __device__ __forceinline__ void sync() const {
    if constexpr (GW == 1)
      __syncwarp();
    else if constexpr (GW > 1)
      asm volatile("bar.sync %0, %1;" ::"r"(bar), "n"(32 * GW) : "memory");
    else
      __syncthreads();
  }

  // Sum each v[0..NV) over the chain; every thread gets the totals.  Also a
  // barrier of the chain: every access before it is ordered before every
  // access after it.  Two reductions that follow each other with no
  // barrier between them use different buffers `buf`.
  template <int NV>
  __device__ __forceinline__ void sum(float (&v)[NV], int buf) const {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      float x = v[k];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
      v[k] = x;
    }
    if constexpr (GW == 1) {
      __syncwarp();
    } else {
      const int lane = rank & 31, warp = rank >> 5, nw = size >> 5;
      float* slot = red + buf * (GW > 0 ? GW : CHAIN_MAX_WARPS) * 4;
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < NV; ++k) slot[warp * 4 + k] = v[k];
      }
      sync();
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        float s = 0.0f;
        for (int w = 0; w < nw; ++w) s += slot[w * 4 + k];
        v[k] = s;
      }
    }
  }
};

// Neighbour sites of site i = t * lx + s, with t from a multiply-high.
struct Lat {
  int lt, lx;
  unsigned mlx;
  __device__ __forceinline__ int row(int i) const {
    return (int)__umulhi((unsigned)i, mlx);
  }
  // P = y0 - y1 - y0(t, s+1) + y1(t+1, s), in plaq_angle's order
  __device__ __forceinline__ float plaq(const float* y0, const float* y1,
                                        int i) const {
    const int t = row(i), s = i - t * lx;
    const int sp = s + 1 == lx ? i - s : i + 1;
    const int tp = t + 1 == lt ? s : i + lx;
    return y0[i] - y1[i] - y0[sp] + y1[tp];
  }
  // dS/du0 = sinP - sinP(t, s-1); dS/du1 = -sinP + sinP(t-1, s)
  __device__ __forceinline__ void grad(const float* sp, int i, float* g0,
                                       float* g1) const {
    const int t = row(i), s = i - t * lx;
    const int sm = s == 0 ? i + lx - 1 : i - 1;
    const int tm = t == 0 ? (lt - 1) * lx + s : i - lx;
    const float c = sp[i];
    *g0 = c - sp[sm];
    *g1 = -c + sp[tm];
  }
};

// x, with its value hidden from the optimizer: an index passed through it
// inside a loop is not hoisted out of that loop with what derives from it.
__device__ __forceinline__ int opaque_index(int x) {
  asm volatile("" : "+r"(x));
  return x;
}

// v0^2 + v1^2 rounded as kinetic_diff rounds it
__device__ __forceinline__ float momentum_sq(float2 v) {
  return __fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y));
}

// The chain's scalar draws of transition n: accept uniform, hop sign and
// hop uniform.
__device__ __forceinline__ void chain_scalars(const HmcRand& rnd,
                                              const Geo& g, int chain, int n,
                                              float* u, float* nu,
                                              float* uh) {
  if (rnd.v0s != nullptr) {
    const size_t o = (size_t)n * g.B + chain;
    *u = rnd.us[o];
    *nu = g.hop ? rnd.nus[o] : 0.0f;
    *uh = g.hop ? rnd.uhs[o] : 0.0f;
  } else {
    curandStatePhilox4_32_10_t st;
    philox_at(&st, g.seed, chain, n, g.N, 8ull * g.d);
    *u = curand_uniform(&st);
    *nu = sign_from_uniform(curand_uniform(&st));
    *uh = curand_uniform(&st);
  }
}

// GW > 0: the warp route (GW warps per chain, SPT = kWarpSites); GW = 0:
// the block route (SPT > 0) or the global route (SPT = 0, g.spt sites per
// thread).  Registers: the warp route's 2048 chains at 16x16 fill 132 SMs
// with 4 blocks each (<= 64 per thread), the block route's 64x64 two blocks
// of 512 threads per SM (<= 64).
template <int GW, int SPT>
__global__ void __launch_bounds__(GW ? 32 * GW * kWarpChains : kBlockThreads,
                                  GW ? 4 : (SPT == 8 ? 2 : 1))
hmc_chain_kernel(float* __restrict__ x0g, float* __restrict__ x1g,
                 float* __restrict__ scratch, HmcRand rnd,
                 float* __restrict__ plaq_tr, float* __restrict__ chg_tr,
                 float* __restrict__ prob_tr, Geo g) {
  extern __shared__ __align__(16) float smem[];
  constexpr bool WARP = GW > 0;
  static_assert(!WARP || SPT == kWarpSites, "warp route: kWarpSites");
  constexpr bool kAccReg = WARP;  // accepted state in registers
  const int d = g.d;
  const Lat lat{g.lt, g.lx, g.mlx};
  const int spt = SPT > 0 ? SPT : g.spt;

  Team<GW> team;
  int chain;
  float* nb;  // Y0, Y1, SP1: d floats each
  if constexpr (WARP) {
    const int w = threadIdx.x / (32 * GW);  // the chain in the block
    chain = blockIdx.x * kWarpChains + w;
    if (chain >= g.B) return;  // no block-wide barrier follows
    team.rank = threadIdx.x - w * 32 * GW;
    team.size = 32 * GW;
    team.bar = 1 + w;
    team.red = smem + (size_t)kWarpChains * 3 * d + w * 2 * GW * 4;
    nb = smem + (size_t)w * 3 * d;
  } else {
    chain = blockIdx.x;
    team.rank = threadIdx.x;
    team.size = blockDim.x;
    team.bar = 0;
    team.red = smem;
    nb = g.nb_dev ? scratch + ((size_t)chain * g.fpc + 6) * d
                  : smem + kRedFloats;
  }
  const int rank = team.rank, size = team.size;
  float* Y0 = nb;
  float* Y1 = nb + d;
  float* SP1 = nb + 2 * d;
  // this thread's slot 0 in the chain's scratch row (block, global routes)
  float* row = WARP ? nullptr : scratch + (size_t)chain * g.fpc * d + rank;

  Own<kAccReg ? SPT : 0> X0, X1, SP, CP;
  Own<SPT> W0, W1, VV, CP1;
  float* xr0 = x0g + (size_t)chain * d;
  float* xr1 = x1g + (size_t)chain * d;
  if constexpr (kAccReg) {
#pragma unroll
    for (int k = 0; k < spt; ++k) {
      const int i = rank + k * size;
      if (i < d) {
        X0[k] = xr0[i];
        X1[k] = xr1[i];
      }
    }
  } else {
    X0.p = xr0 + rank;
    X1.p = xr1 + rank;
    SP.p = row;
    CP.p = row + d;
    X0.stride = X1.stride = SP.stride = CP.stride = size;
  }
  if constexpr (SPT == 0) {
    W0.p = row + 2 * d;
    W1.p = row + 3 * d;
    VV.p = row + 4 * d;
    CP1.p = row + 5 * d;
    W0.stride = W1.stride = VV.stride = CP1.stride = size;
  }

  const double dd = (double)d;
  const float cd = (float)cos(2.0 * kPiD / dd);
  const float sd = (float)sin(2.0 * kPiD / dd);
  const float one_minus_cd = (float)(1.0 - cos(2.0 * kPiD / dd));
  const float cd_minus_one = (float)(cos(2.0 * kPiD / dd) - 1.0);
  const float delta = (float)(2.0 * kPiD / dd);
  const float seam = (float)(-(2.0 * kPiD / dd) * g.lt);
  const float eps = g.eps, beta = g.beta;

  // plaquette fields of the initial state
#pragma unroll
  for (int k = 0; k < spt; ++k) {
    const int i = rank + k * size;
    if (i < d) {
      Y0[i] = X0[k];
      Y1[i] = X1[k];
    }
  }
  team.sync();
  float pot, chg;
  {
    float v[2] = {0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < spt; ++k) {
      const int i = rank + k * size;
      if (i < d) {
        float sn, cs;
        const float p = lat.plaq(Y0, Y1, i);
        sincosf(p, &sn, &cs);
        SP[k] = sn;
        CP[k] = cs;
        v[0] += 1.0f - cs;
        v[1] += wrap_angle(p);
      }
    }
    team.template sum<2>(v, 0);
    pot = v[0];
    chg = v[1] * CHAIN_INV_TWO_PI_F;
  }

  for (int n = 0; n < g.N; ++n) {
    float u, nu, uh;
    chain_scalars(rnd, g, chain, n, &u, &nu, &uh);
    // momenta (one draw per site), the proposal starts at the state
#pragma unroll
    for (int k = 0; k < spt; ++k) {
      const int i = rank + k * size;
      if (i < d) {
        const float2 v =
            initial_momenta(rnd.v0s, rnd.v1s, g.seed, chain, g.B, n, g.N, d,
                            i);
        VV[k] = momentum_sq(v);
        W0[k] = v.x;
        W1[k] = v.y;
        Y0[i] = X0[k];
        Y1[i] = X1[k];
        SP1[i] = SP[k];
      }
    }
    team.sync();
    // first half kick from the carried sine field
#pragma unroll
    for (int k = 0; k < spt; ++k) {
      const int i = opaque_index(rank + k * size);
      if (i < d) {
        float g0, g1;
        lat.grad(SP1, i, &g0, &g1);
        W0[k] = add_mul_rn(W0[k], -0.5f * eps * beta, g0);
        W1[k] = add_mul_rn(W1[k], -0.5f * eps * beta, g1);
      }
    }

    float pv[2] = {0.0f, 0.0f};  // potential, charge of the last step
    for (int kk = 0; kk < g.K; ++kk) {
      // drift (own sites; the last reads of Y were before the last barrier)
#pragma unroll
      for (int k = 0; k < spt; ++k) {
        const int i = opaque_index(rank + k * size);
        if (i < d) {
          Y0[i] = wrap_angle(add_mul_rn(Y0[i], eps, W0[k]));
          Y1[i] = wrap_angle(add_mul_rn(Y1[i], eps, W1[k]));
        }
      }
      team.sync();  // links moved; the last force's reads of SP1 done
      const bool last = kk == g.K - 1;
#pragma unroll
      for (int k = 0; k < spt; ++k) {
        const int i = opaque_index(rank + k * size);
        if (i < d) {
          float sn, cs;
          const float p = lat.plaq(Y0, Y1, i);
          sincosf(p, &sn, &cs);
          SP1[i] = sn;
          if (last) {
            CP1[k] = cs;
            pv[0] += 1.0f - cs;
            pv[1] += wrap_angle(p);
          }
        }
      }
      team.sync();  // SP1 complete
      const float c = last ? 0.5f * eps : eps;
#pragma unroll
      for (int k = 0; k < spt; ++k) {
        const int i = opaque_index(rank + k * size);
        if (i < d) {
          float g0, g1;
          lat.grad(SP1, i, &g0, &g1);
          W0[k] = add_mul_rn(W0[k], -c * beta, g0);
          W1[k] = add_mul_rn(W1[k], -c * beta, g1);
        }
      }
    }

    // H0 - H1 from per-site differences (no float32 cancellation of the
    // two ~1e3 Hamiltonians): beta sum(cos P1 - cos P0) + sum(v^2 - w^2)/2
    float e[4] = {0.0f, 0.0f, pv[0], pv[1]};
#pragma unroll
    for (int k = 0; k < spt; ++k) {
      const int i = rank + k * size;
      if (i < d) {
        e[0] += CP1[k] - CP[k];
        const float w0 = W0[k], w1 = W1[k];
        e[1] += __fsub_rn(VV[k], __fadd_rn(__fmul_rn(w0, w0),
                                           __fmul_rn(w1, w1)));
      }
    }
    team.template sum<4>(e, 1);
    const float dh = beta * e[0] + 0.5f * e[1];
    float prob = expf(dh > 0.0f ? 0.0f : dh);  // NaN stays NaN -> rejected
    if (!isfinite(prob)) prob = 0.0f;
    if (u < prob) {
#pragma unroll
      for (int k = 0; k < spt; ++k) {
        const int i = rank + k * size;
        if (i < d) {
          X0[k] = Y0[i];
          X1[k] = Y1[i];
          SP[k] = SP1[i];
          CP[k] = CP1[k];
        }
      }
      pot = e[2];
      chg = e[3] * CHAIN_INV_TWO_PI_F;
    }

    if (g.hop) {
      float hv[2] = {0.0f, 0.0f};
#pragma unroll
      for (int k = 0; k < spt; ++k) {
        const int i = rank + k * size;
        if (i < d) {
          const float s = SP[k];
          hv[0] += s;
          hv[1] += (CP[k] < -cd && nu * s >= 0.0f) ? 1.0f : 0.0f;
        }
      }
      team.template sum<2>(hv, 0);
      const float ds = one_minus_cd * ((float)d - pot) + nu * sd * hv[0];
      const float m = -beta * ds;
      float ph = expf(m > 0.0f ? 0.0f : m);
      if (!isfinite(ph)) ph = 0.0f;
      const float acc = (uh < ph) ? 1.0f : 0.0f;
      const float an = acc * nu;
      const float cda = 1.0f + acc * cd_minus_one;
      const float sda = an * sd;
#pragma unroll
      for (int k = 0; k < spt; ++k) {
        const int i = rank + k * size;
        if (i < d) {
          float w0, w1;
          winding(i, g.lt, g.lx, delta, seam, &w0, &w1);
          X0[k] = wrap_angle(X0[k] + an * w0);
          X1[k] = wrap_angle(X1[k] + an * w1);
          float s = SP[k], c = CP[k];
          hop_rotate(&s, &c, cda, sda);
          SP[k] = s;
          CP[k] = c;
        }
      }
      pot = pot + acc * ds;
      chg = chg + an * (1.0f - hv[1]);
    }

    if (rank == 0) {
      const size_t o = (size_t)n * g.B + chain;
      plaq_tr[o] = 1.0f - pot / (float)d;
      chg_tr[o] = chg;
      prob_tr[o] = prob;
    }
  }

  if constexpr (kAccReg) {
#pragma unroll
    for (int k = 0; k < spt; ++k) {
      const int i = rank + k * size;
      if (i < d) {
        xr0[i] = X0[k];
        xr1[i] = X1[k];
      }
    }
  }
}

template <int GW, int SPT>
int launch(int blocks, int threads, size_t smem, float* x0, float* x1,
           float* scratch, const HmcRand& rnd, float* plaq, float* chg,
           float* prob, const Geo& g, cudaStream_t stream) {
  auto kernel = hmc_chain_kernel<GW, SPT>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<blocks, threads, smem, stream>>>(x0, x1, scratch, rnd, plaq, chg,
                                            prob, g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int smem_optin_bytes(int device) {
  return device_smem_optin(device);
}

// Shared memory of one block of `route` (ops/leapfrog.py hmc_chain_plan):
// the warp route's `chains` chains of 3 d floats and 2 x kChainWarps x 4
// reduction slots; one chain's 3 d floats (unless nb_dev) and the reduction
// slots otherwise.
extern "C" size_t hmc_chain_smem_bytes(int route, int lt, int lx, int chains,
                                       int nb_dev) {
  const size_t d = (size_t)lt * lx;
  if (route == kRouteWarp)
    return sizeof(float) * (3 * d + 2 * kChainWarps * 4) * chains;
  return sizeof(float) * (kRedFloats + (nb_dev ? 0 : 3 * d));
}

// scratch: (B, fpc, d) floats, fpc = 0 (warp route), 2 (block: SP, CP), 6
// (global: SP, CP, W0, W1, VV, CP1) or 9 (global with nb_dev: then Y0, Y1,
// SP1).  route, spt, threads: the plan of ops/leapfrog.py hmc_chain_plan.
extern "C" int hmc_chain_launch(float* x0, float* x1, float* scratch,
                                const float* v0s, const float* v1s,
                                const float* us, const float* nus,
                                const float* uhs, float* plaq, float* chg,
                                float* prob, int B, int lt, int lx, int K,
                                int N, float eps, float beta, int hop,
                                unsigned long long seed, int route, int spt,
                                int threads, int nb_dev, int device,
                                void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  if (B <= 0 || N <= 0) return 0;
  const int d = lt * lx;
  if (K < 1 || lx < 2 || lt < 1 ||
      (unsigned long long)d * lx >= (1ull << 32) || threads % 32 != 0 ||
      threads < 32 || threads > kBlockThreads ||
      (long long)spt * threads < d)
    return (int)cudaErrorInvalidValue;
  const int fpc = route == kRouteWarp ? 0
                  : route == kRouteBlock ? 2
                  : nb_dev ? 9 : 6;
  if (fpc > 0 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const unsigned mlx = (unsigned)(((1ull << 32) + lx - 1) / lx);
  const HmcRand rnd{v0s, v1s, us, nus, uhs};
  const Geo g{B, lt, lx, d, K, N, hop, eps, beta, seed, mlx, spt, fpc,
              route == kRouteGlobal && nb_dev};
  const size_t smem = hmc_chain_smem_bytes(route, lt, lx, kWarpChains,
                                           g.nb_dev);
  const cudaStream_t st = (cudaStream_t)stream;
  switch (route) {
    case kRouteWarp:
      if (spt != kWarpSites || threads != 32 * kChainWarps * kWarpChains)
        return (int)cudaErrorInvalidValue;
      return launch<kChainWarps, kWarpSites>(
          (B + kWarpChains - 1) / kWarpChains,
                                      threads, smem, x0, x1, scratch, rnd,
                                      plaq, chg, prob, g, st);
    case kRouteBlock:
      if (spt == 8)
        return launch<0, 8>(B, threads, smem, x0, x1, scratch, rnd, plaq,
                                chg, prob, g, st);
      if (spt == 16)
        return launch<0, 16>(B, threads, smem, x0, x1, scratch, rnd,
                                 plaq, chg, prob, g, st);
      return (int)cudaErrorInvalidValue;
    case kRouteGlobal:
      return launch<0, 0>(B, threads, smem, x0, x1, scratch, rnd, plaq,
                              chg, prob, g, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Wilson action of 2-D U(1) links with its analytic force and the force's
// own backward (a Hessian-vector product), for training through autograd.
//
// Replaces the TPU kernel l2hmc_tpu/ops/wilson.py:_build_pallas_kernels
// (fwd_kernel, bwd_kernel; entry wilson_action_pallas).  Links are
// (B, Lt, Lx, 2) float32 angles in the JAX layout, site i = t*Lx + s, link
// (i, mu) at index (b*d + i)*2 + mu with d = Lt*Lx: one float2 per site.
//
//   P(t,s)     = u0 - u1 - u0(t, s+1) + u1(t+1, s)
//   forward    S[b] = sum_i (1 - cos P),  sinp = sin P  (or S alone)
//   backward   F0 = g (sinP - sinP(t, s-1)),  F1 = g (-sinP + sinP(t-1, s))
//   force      the backward's F from the links in one launch: sin P never
//              leaves the chip
//   double bw  for a cotangent w on F:
//              r  = w0 - w0(t, s+1) - w1 + w1(t+1, s)
//              h  = g cos P r
//              dlinks = (h - h(t, s-1), -h + h(t-1, s)),  dg[b] = sum_i r sinP
//
// What bounds it on an H100: bytes.  Each kernel does a handful of flops
// and one sincos per site against 8-24 bytes of device memory per site, so
// the memory rate (3.35 TB/s) sets the least time: ~0.12 us for the forward
// at (128, 16, 16, 2), ~7.5 us at (512, 64, 64, 2).  At the training shape a
// launch costs more than the work.
//
// Design.  The TPU kernel's slice-concat shifts, its (block_b, Lx) row-sum
// output and its VMEM block sizing are not carried over.  One block per
// chain, a thread per site up to 512 threads.  The route is the host's
// (ops/wilson.py wilson_plan); it concerns the backward, the force and
// the double backward, one template instantiation each:
//
//   block   chains whose tiles fit shared memory (up to 128x128): the
//           chain's 2 d contiguous links (the backward: its d sin P) arrive
//           by one TMA bulk copy that completes on an mbarrier (float2 or
//           float loads instead where the bytes are not a multiple of 16 or
//           the address not 16-byte aligned); sin P (force) or h (double
//           backward) is formed once per site into a field tile and read
//           at the neighbours after a barrier: one sincos per site.
//   global  beyond: the links are read from device memory (L1 and L2 serve
//           the neighbours) and sin P and h are recomputed at the
//           neighbours (3 sincos per site).
//
// The plan sends the backward by the block route from 64x64 up; below, it
// reads sin P from device memory (the copy measured slower there).  The
// forward and the action-only forward read device memory on either route,
// one instantiation each: staging their links measured slower on the H100
// at 16x16 and 64x64 (benchmarks/wilson_routes.py).
// (Forming the double backward's r into the field while the links' copy is
// in flight measured 7% slower at 64x64 and was left out.)
// Results go out as one float2 per site.  Per-chain sums are deterministic
// (each thread sums its sites in order, then a fixed-order reduction).
// Every product and difference is formed in the plain version's order (no
// FMA pattern arises), so the backward agrees with it bit for bit on the
// same sin P.

#include "chain_common.cuh"

namespace {

enum Kind { kFwd = 0, kFwdAction = 1, kForce = 2, kBwd = 3, kDbl = 4 };
enum Route { kRouteBlock = 0, kRouteGlobal = 1 };
constexpr int kBlockThreads = 512;
constexpr int kStaticSmem = 1024;  // bytes kept for the static shared memory

struct Args {
  const float* links;    // (B, d, 2)
  const float* sinp_in;  // (B, d): the backward's input
  const float* g;        // (B,)
  const float* w;        // (B, d, 2): the double backward's cotangent
  float* action;         // (B,)
  float* sinp;           // (B, d): the forward's second output
  float* out;            // (B, d, 2): force or dlinks
  float* dg;             // (B,)
  int B, lt, lx;
};

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// What a kernel stages on the block route: the links (2 d floats; force
// and double backward) and one field of d floats (sin P or h; the
// backward's field is its input sin P).  The forward kinds stage nothing.
__host__ __device__ constexpr bool stages_links(int kind, int route) {
  return route == kRouteBlock && (kind == kForce || kind == kDbl);
}
__host__ __device__ constexpr bool stages_field(int kind, int route) {
  return route == kRouteBlock &&
         (kind == kForce || kind == kBwd || kind == kDbl);
}

size_t smem_bytes(int kind, int route, int d) {
  return sizeof(float) * ((stages_links(kind, route) ? round4(2 * d) : 0) +
                          (stages_field(kind, route) ? round4(d) : 0));
}

// One thread per site up to kBlockThreads (a whole number of warps).
int block_threads(int d) {
  const int nt = 32 * ((d + 31) / 32);
  return nt < kBlockThreads ? nt : kBlockThreads;
}

// The neighbours of site i = t*lx + s.
struct Nb {
  int sp, sm, tp, tm;
};

// Calls f(i, nb) for the block's sites i = threadIdx.x, + blockDim.x, ...
// < d, tracking (t, s) without a division per site.
template <class F>
__device__ __forceinline__ void for_sites(int lt, int lx, F f) {
  const int d = lt * lx, rank = threadIdx.x, size = blockDim.x;
  int t = rank / lx, s = rank - t * lx;
  const int dt = size / lx, ds = size - dt * lx;
#pragma unroll 4
  for (int i = rank; i < d; i += size) {
    const Nb nb{s + 1 == lx ? i + 1 - lx : i + 1,
                s == 0 ? i + lx - 1 : i - 1,
                t + 1 == lt ? i + lx - d : i + lx,
                t == 0 ? i + d - lx : i - lx};
    f(i, nb);
    s += ds;
    t += dt;
    if (s >= lx) {
      s -= lx;
      ++t;
    }
  }
}

__device__ __forceinline__ float plaq(const float2* u, int i, int sp,
                                      int tp) {
  const float2 a = u[i];
  return a.x - a.y - u[sp].x + u[tp].y;
}

// The plaquette at any site j (the global route's neighbours).
__device__ __forceinline__ float plaq_at(const float2* u, int j, int lt,
                                         int lx) {
  return plaq(u, j, site_s_plus(j, lt, lx), site_t_plus(j, lt, lx));
}

// r = w0 - w0(t, s+1) - w1 + w1(t+1, s) at site i.
__device__ __forceinline__ float cot_r(const float2* w, int i, int sp,
                                       int tp) {
  const float2 a = __ldg(w + i);
  return a.x - __ldg(w + sp).x - a.y + __ldg(w + tp).y;
}

// h = g cos P r at any site j (the global route's neighbours); r and sin P
// there too.
__device__ __forceinline__ float hvp_h_at(const float2* u, const float2* w,
                                          float g, int j, int lt, int lx,
                                          float* r_out, float* sin_out) {
  const int sp = site_s_plus(j, lt, lx), tp = site_t_plus(j, lt, lx);
  float sn, cs;
  sincosf(plaq(u, j, sp, tp), &sn, &cs);
  const float r = cot_r(w, j, sp, tp);
  *r_out = r;
  *sin_out = sn;
  return (g * cs) * r;
}

// Bring n floats of one chain into its tile and sync the block: one TMA
// bulk copy on the mbarrier `bar` (used once, parity 0) where the copy's
// rules allow it, else float2 (or float) loads.
__device__ __forceinline__ void stage(float* dst, const float* src, int n,
                                      unsigned long long* bar) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(src);
  const unsigned bytes = (unsigned)n * sizeof(float);
  if ((addr & 15) == 0 && (bytes & 15) == 0) {
    if (threadIdx.x == 0) {
      mbar_init(bar, 1);
      mbar_init_fence();
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar, bytes);
      bulk_load(dst, src, bytes, bar);
    }
    mbar_wait(bar, 0);
    return;
  }
  if ((addr & 7) == 0 && (n & 1) == 0) {
    const float2* s2 = reinterpret_cast<const float2*>(src);
    float2* d2 = reinterpret_cast<float2*>(dst);
    for (int k = threadIdx.x; k < n / 2; k += blockDim.x)
      d2[k] = __ldg(s2 + k);
  } else {
    for (int k = threadIdx.x; k < n; k += blockDim.x)
      dst[k] = __ldg(src + k);
  }
  __syncthreads();
}

// Sum over the block, returned to thread 0: a fixed-order xor shuffle in
// each warp, then thread 0 adds the warps' sums in order; one barrier.
__device__ __forceinline__ float block_total(float v, float* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    v = 0.0f;
    for (int k = 0; k < (int)(blockDim.x >> 5); ++k) v += scratch[k];
  }
  return v;
}

// The pointers are separate __restrict__ parameters, not fields of an Args
// parameter: that measured 6% faster for the forward at (128, 16, 16, 2) on
// the H100 (benchmarks/wilson_variants.py).
template <int KIND, int ROUTE>
__global__ void __launch_bounds__(kBlockThreads)
    wilson_kernel(const float* __restrict__ links,
                  const float* __restrict__ sinp_in,
                  const float* __restrict__ g, const float* __restrict__ wp,
                  float* __restrict__ action, float* __restrict__ sinp,
                  float* __restrict__ outp, float* __restrict__ dg, int lt,
                  int lx) {
  extern __shared__ __align__(16) float tile[];
  __shared__ float scratch[CHAIN_MAX_WARPS];
  __shared__ __align__(8) unsigned long long bar;

  const int d = lt * lx;
  const long long b = blockIdx.x;
  const size_t site0 = (size_t)b * d;
  const float* src = links + 2 * site0;
  // the chain's links: its staged tile, or device memory where not staged
  const float2* __restrict__ u = reinterpret_cast<const float2*>(src);
  float* field = tile + (stages_links(KIND, ROUTE) ? round4(2 * d) : 0);
  if constexpr (stages_links(KIND, ROUTE)) {
    stage(tile, src, 2 * d, &bar);
    u = reinterpret_cast<const float2*>(tile);
  }

  if constexpr (KIND == kFwd || KIND == kFwdAction) {
    float acc = 0.0f;
    for_sites(lt, lx, [&](int i, const Nb& nb) {
      const float p = plaq(u, i, nb.sp, nb.tp);
      if constexpr (KIND == kFwd) {
        float sn, cs;
        sincosf(p, &sn, &cs);
        sinp[site0 + i] = sn;
        acc += 1.0f - cs;
      } else {
        acc += 1.0f - cosf(p);
      }
    });
    acc = block_total(acc, scratch);
    if (threadIdx.x == 0) action[b] = acc;
  } else if constexpr (KIND == kBwd) {
    const float gb = g[b];
    const float* sp = sinp_in + site0;
    if constexpr (stages_field(KIND, ROUTE)) {
      stage(field, sp, d, &bar);
      sp = field;
    }
    float2* out = reinterpret_cast<float2*>(outp) + site0;
    for_sites(lt, lx, [&](int i, const Nb& nb) {
      const float s0 = sp[i];
      out[i] = make_float2(gb * (s0 - sp[nb.sm]), gb * (-s0 + sp[nb.tm]));
    });
  } else if constexpr (KIND == kForce) {
    const float gb = g[b];
    float2* out = reinterpret_cast<float2*>(outp) + site0;
    if constexpr (ROUTE == kRouteGlobal) {  // sin P recomputed at neighbours
      for_sites(lt, lx, [&](int i, const Nb& nb) {
        const float s0 = sinf(plaq(u, i, nb.sp, nb.tp));
        out[i] = make_float2(gb * (s0 - sinf(plaq_at(u, nb.sm, lt, lx))),
                             gb * (-s0 + sinf(plaq_at(u, nb.tm, lt, lx))));
      });
    } else {
      for_sites(lt, lx, [&](int i, const Nb& nb) {
        field[i] = sinf(plaq(u, i, nb.sp, nb.tp));
      });
      __syncthreads();
      for_sites(lt, lx, [&](int i, const Nb& nb) {
        const float s0 = field[i];
        out[i] = make_float2(gb * (s0 - field[nb.sm]),
                             gb * (-s0 + field[nb.tm]));
      });
    }
  } else {  // kDbl
    const float gb = g[b];
    const float2* w = reinterpret_cast<const float2*>(wp) + site0;
    float2* out = reinterpret_cast<float2*>(outp) + site0;
    float acc = 0.0f;
    if constexpr (ROUTE == kRouteGlobal) {
      // no room for an h field: h recomputed at the two neighbours
      for_sites(lt, lx, [&](int i, const Nb& nb) {
        float r, sn, r_nb, sn_nb;
        const float h = hvp_h_at(u, w, gb, i, lt, lx, &r, &sn);
        const float h_sm = hvp_h_at(u, w, gb, nb.sm, lt, lx, &r_nb, &sn_nb);
        const float h_tm = hvp_h_at(u, w, gb, nb.tm, lt, lx, &r_nb, &sn_nb);
        out[i] = make_float2(h - h_sm, -h + h_tm);
        acc += r * sn;
      });
    } else {
      for_sites(lt, lx, [&](int i, const Nb& nb) {
        float sn, cs;
        sincosf(plaq(u, i, nb.sp, nb.tp), &sn, &cs);
        const float r = cot_r(w, i, nb.sp, nb.tp);
        field[i] = (gb * cs) * r;
        acc += r * sn;
      });
      __syncthreads();
      for_sites(lt, lx, [&](int i, const Nb& nb) {
        const float h = field[i];
        out[i] = make_float2(h - field[nb.sm], -h + field[nb.tm]);
      });
    }
    acc = block_total(acc, scratch);
    if (threadIdx.x == 0) dg[b] = acc;
  }
}

template <int KIND, int ROUTE>
int launch(const Args& a, cudaStream_t stream) {
  auto kernel = wilson_kernel<KIND, ROUTE>;
  const int d = a.lt * a.lx;
  const size_t smem = smem_bytes(KIND, ROUTE, d);
  if (smem + kStaticSmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<(unsigned)a.B, block_threads(d), smem, stream>>>(
      a.links, a.sinp_in, a.g, a.w, a.action, a.sinp, a.out, a.dg, a.lt,
      a.lx);
  return (int)cudaGetLastError();
}

// route: the plan of ops/wilson.py wilson_plan; it selects the backward's,
// the force's and the double backward's instantiation, the forward kinds
// have one.
template <int KIND>
int dispatch(const Args& a, int route, int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  if (a.B <= 0) return 0;
  if (a.lt < 1 || a.lx < 1 || (long long)a.lt * a.lx > (1ll << 29) ||
      (route != kRouteBlock && route != kRouteGlobal))
    return (int)cudaErrorInvalidValue;
  const int d = a.lt * a.lx;
  if (smem_bytes(KIND, route, d) + kStaticSmem >
      (size_t)device_smem_optin(device))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if constexpr (KIND != kFwd && KIND != kFwdAction) {
    if (route == kRouteBlock) return launch<KIND, kRouteBlock>(a, st);
  }
  return launch<KIND, kRouteGlobal>(a, st);
}

// ---------------------------------------------------------------------------
// The slab route: one 'space' rank's rows of a lattice split over its time
// axis (l2hmc_tpu_torch/parallel/spatial.py).  The input is the slab
// extended by one halo row on each side, (B, E, lx, 2) with E = rows + 2:
// row 0 is the previous slab's last row, row E-1 the next slab's first
// (only its u1 is read).  The time axis is open, never wrapped.
//
//   forward    S[b] = sum over the owned plaquette rows t = 1..E-2 of
//              (1 - cos P); sinp (B, E, lx): sin P there, 0 on rows 0, E-1
//   backward   the open-t backward of a sinp field (B, E, lx):
//              F0 = g (sinP - sinP(t, s-1)), F1 = g (-sinP + sinP(t-1, s)),
//              sinP(-1, .) = 0; on every row of the extended slab
//   force      the complete force on the owned links (B, E-2, lx, 2): the
//              backward of the plaquette rows 0..E-2, so P(t0-1) (row 0)
//              enters and no exchange is needed afterwards
//   double bw  for a cotangent w on rows [w_off, w_off + w_rows) of the
//              extended slab (0 elsewhere) and the plaquette rows p_lo..E-2:
//              r and h as above, h = 0 outside those rows; dlinks on every
//              row of the extended slab, dg[b] = sum r sin P.  The force's
//              backward is (p_lo, w_off, w_rows) = (0, 1, E-2), the action
//              backward's (1, 0, E).
//
// A simple design, read from device memory like the global route: one block
// per chain, sin P and h recomputed at the neighbours.  The products and
// differences keep the plain versions' order (ops/wilson.py
// wilson_slab_*_reference).
// ---------------------------------------------------------------------------

__device__ __forceinline__ float slab_plaq(const float2* u, int t, int s,
                                           int lx) {
  const int i = t * lx + s;
  const int sp = s + 1 == lx ? i + 1 - lx : i + 1;
  return u[i].x - u[i].y - u[sp].x + u[i + lx].y;
}

// The cotangent at row t (0 outside [w_off, w_off + w_rows)).
__device__ __forceinline__ float2 slab_w(const float2* w, int t, int s,
                                         int lx, int w_off, int w_rows) {
  const int k = t - w_off;
  return (k >= 0 && k < w_rows) ? __ldg(w + k * lx + s)
                                : make_float2(0.0f, 0.0f);
}

// h = g cos P r at plaquette (t, s), 0 outside rows [p_lo, e-1); r and
// sin P there too.
__device__ __forceinline__ float slab_h(const float2* u, const float2* w,
                                        float g, int t, int s, int e, int lx,
                                        int p_lo, int w_off, int w_rows,
                                        float* r_out, float* sin_out) {
  if (t < p_lo || t >= e - 1) {
    *r_out = 0.0f;
    *sin_out = 0.0f;
    return 0.0f;
  }
  const int s1 = s + 1 == lx ? 0 : s + 1;
  const float2 a = slab_w(w, t, s, lx, w_off, w_rows);
  const float r = a.x - slab_w(w, t, s1, lx, w_off, w_rows).x - a.y +
                  slab_w(w, t + 1, s, lx, w_off, w_rows).y;
  float sn, cs;
  sincosf(slab_plaq(u, t, s, lx), &sn, &cs);
  *r_out = r;
  *sin_out = sn;
  return (g * cs) * r;
}

template <int KIND>
__global__ void __launch_bounds__(kBlockThreads)
    wilson_slab_kernel(const float* __restrict__ links,
                       const float* __restrict__ sinp_in,
                       const float* __restrict__ g,
                       const float* __restrict__ wp,
                       float* __restrict__ action, float* __restrict__ sinp,
                       float* __restrict__ outp, float* __restrict__ dg,
                       int e, int lx, int p_lo, int w_off, int w_rows) {
  __shared__ float scratch[CHAIN_MAX_WARPS];
  const int d = e * lx;
  const long long b = blockIdx.x;
  const size_t site0 = (size_t)b * d;
  const float2* __restrict__ u =
      reinterpret_cast<const float2*>(links) + site0;

  if constexpr (KIND == kFwd || KIND == kFwdAction) {
    float acc = 0.0f;
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      const int t = i / lx, s = i - t * lx;
      const bool owned = t >= 1 && t < e - 1;
      if constexpr (KIND == kFwd) {
        float sn = 0.0f, cs = 1.0f;
        if (owned) sincosf(slab_plaq(u, t, s, lx), &sn, &cs);
        sinp[site0 + i] = sn;
        acc += 1.0f - cs;
      } else if (owned) {
        acc += 1.0f - cosf(slab_plaq(u, t, s, lx));
      }
    }
    acc = block_total(acc, scratch);
    if (threadIdx.x == 0) action[b] = acc;
  } else if constexpr (KIND == kBwd) {
    const float gb = g[b];
    const float* sp = sinp_in + site0;
    float2* out = reinterpret_cast<float2*>(outp) + site0;
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      const int t = i / lx, s = i - t * lx;
      const float s0 = sp[i];
      const float left = sp[s == 0 ? i + lx - 1 : i - 1];
      const float up = t > 0 ? sp[i - lx] : 0.0f;
      out[i] = make_float2(gb * (s0 - left), gb * (-s0 + up));
    }
  } else if constexpr (KIND == kForce) {
    const float gb = g[b];
    const int n_out = (e - 2) * lx;
    float2* out = reinterpret_cast<float2*>(outp) + (size_t)b * n_out;
    for (int k = threadIdx.x; k < n_out; k += blockDim.x) {
      const int t = k / lx + 1, s = k - (t - 1) * lx;
      const float s0 = sinf(slab_plaq(u, t, s, lx));
      const float left = sinf(slab_plaq(u, t, s == 0 ? lx - 1 : s - 1, lx));
      const float up = sinf(slab_plaq(u, t - 1, s, lx));
      out[k] = make_float2(gb * (s0 - left), gb * (-s0 + up));
    }
  } else {  // kDbl
    const float gb = g[b];
    const float2* w = reinterpret_cast<const float2*>(wp) +
                      (size_t)b * w_rows * lx;
    float2* out = reinterpret_cast<float2*>(outp) + site0;
    float acc = 0.0f;
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      const int t = i / lx, s = i - t * lx;
      float r, sn, r_nb, sn_nb;
      const float h = slab_h(u, w, gb, t, s, e, lx, p_lo, w_off, w_rows, &r,
                             &sn);
      const float h_sm = slab_h(u, w, gb, t, s == 0 ? lx - 1 : s - 1, e, lx,
                                p_lo, w_off, w_rows, &r_nb, &sn_nb);
      const float h_tm = t > 0 ? slab_h(u, w, gb, t - 1, s, e, lx, p_lo,
                                        w_off, w_rows, &r_nb, &sn_nb)
                               : 0.0f;
      out[i] = make_float2(h - h_sm, -h + h_tm);
      acc += r * sn;
    }
    acc = block_total(acc, scratch);
    if (threadIdx.x == 0) dg[b] = acc;
  }
}

template <int KIND>
int slab_dispatch(const Args& a, int p_lo, int w_off, int w_rows,
                  int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  if (a.B <= 0) return 0;
  // a.lt is E, the extended slab's rows: at least one owned row
  if (a.lt < 3 || a.lx < 2 || (long long)a.lt * a.lx > (1ll << 29) ||
      p_lo < 0 || p_lo > 1 || w_rows < 0 || w_off < 0 ||
      w_off + w_rows > a.lt)
    return (int)cudaErrorInvalidValue;
  wilson_slab_kernel<KIND>
      <<<(unsigned)a.B, block_threads(a.lt * a.lx), 0,
         (cudaStream_t)stream>>>(a.links, a.sinp_in, a.g, a.w, a.action,
                                 a.sinp, a.out, a.dg, a.lt, a.lx, p_lo,
                                 w_off, w_rows);
  return (int)cudaGetLastError();
}

__global__ void empty_kernel() {}

}  // namespace

// Dynamic shared memory of one block of `kind` (0 forward, 1 action only,
// 2 force, 3 backward, 4 double backward) on `route` (0 block, 1 global).
extern "C" size_t wilson_smem_bytes(int kind, int route, int lt, int lx) {
  return smem_bytes(kind, route, lt * lx);
}

// sinp == nullptr: the action alone.
extern "C" int wilson_fwd_launch(const float* links, float* action,
                                 float* sinp, int B, int lt, int lx,
                                 int route, int device, void* stream) {
  const Args a{links, nullptr, nullptr, nullptr, action, sinp,
               nullptr, nullptr, B, lt, lx};
  return sinp == nullptr ? dispatch<kFwdAction>(a, route, device, stream)
                         : dispatch<kFwd>(a, route, device, stream);
}

extern "C" int wilson_force_launch(const float* links, const float* g,
                                   float* force, int B, int lt, int lx,
                                   int route, int device, void* stream) {
  const Args a{links, nullptr, g, nullptr, nullptr, nullptr,
               force, nullptr, B, lt, lx};
  return dispatch<kForce>(a, route, device, stream);
}

extern "C" int wilson_bwd_launch(const float* sinp, const float* g,
                                 float* force, int B, int lt, int lx,
                                 int route, int device, void* stream) {
  const Args a{nullptr, sinp, g, nullptr, nullptr, nullptr,
               force, nullptr, B, lt, lx};
  return dispatch<kBwd>(a, route, device, stream);
}

extern "C" int wilson_bwd_bwd_launch(const float* links, const float* g,
                                     const float* w, float* dlinks,
                                     float* dg, int B, int lt, int lx,
                                     int route, int device, void* stream) {
  const Args a{links, nullptr, g, w, nullptr, nullptr,
               dlinks, dg, B, lt, lx};
  return dispatch<kDbl>(a, route, device, stream);
}

// The slab route (e = the extended slab's rows, owned rows + 2).
// sinp == nullptr: the action alone.
extern "C" int wilson_slab_fwd_launch(const float* links, float* action,
                                      float* sinp, int B, int e, int lx,
                                      int device, void* stream) {
  const Args a{links, nullptr, nullptr, nullptr, action, sinp,
               nullptr, nullptr, B, e, lx};
  return sinp == nullptr
             ? slab_dispatch<kFwdAction>(a, 0, 0, 0, device, stream)
             : slab_dispatch<kFwd>(a, 0, 0, 0, device, stream);
}

extern "C" int wilson_slab_force_launch(const float* links, const float* g,
                                        float* force, int B, int e, int lx,
                                        int device, void* stream) {
  const Args a{links, nullptr, g, nullptr, nullptr, nullptr,
               force, nullptr, B, e, lx};
  return slab_dispatch<kForce>(a, 0, 0, 0, device, stream);
}

extern "C" int wilson_slab_bwd_launch(const float* sinp, const float* g,
                                      float* force, int B, int e, int lx,
                                      int device, void* stream) {
  const Args a{nullptr, sinp, g, nullptr, nullptr, nullptr,
               force, nullptr, B, e, lx};
  return slab_dispatch<kBwd>(a, 0, 0, 0, device, stream);
}

extern "C" int wilson_slab_bwd_bwd_launch(const float* links, const float* g,
                                          const float* w, float* dlinks,
                                          float* dg, int B, int e, int lx,
                                          int p_lo, int w_off, int w_rows,
                                          int device, void* stream) {
  const Args a{links, nullptr, g, w, nullptr, nullptr,
               dlinks, dg, B, e, lx};
  return slab_dispatch<kDbl>(a, p_lo, w_off, w_rows, device, stream);
}

// An empty kernel: the launch floor that the Wilson kernels at the training
// shape are read against (chip_smoke.py phase 6).
extern "C" int empty_launch(int blocks, int threads, int device,
                            void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  empty_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

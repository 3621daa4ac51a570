// Variants of the Wilson forward and backward (benchmarks/wilson_variants.py
// times them in turns).  Not part of the port's library: each variant is a
// form that csrc/wilson.cu took or could take, kept so that the choice can
// be measured again.
//
//   forward  0  one block per chain, 256 threads, scalar loads, block_sum,
//               __restrict__ pointer parameters (the form before the routes)
//            1  an Args parameter, 512 threads, float2 loads, the site loop
//               unrolled 4 times, one-barrier block sum
//            2  1 without the unroll
//            3  1 at 256 threads
//            4  1 with block_sum
//            5  1 with __restrict__ pointer parameters instead of Args
//            6  1 without the unroll, at 256 threads, with block_sum
//   backward 0  elementwise over B d sites (the form before the routes)
//            1  one block per chain reading sin P from device memory
//            2  one block per chain, sin P by one TMA bulk copy
//            3  0 with float2 stores
#include "../ops/csrc/chain_common.cuh"

namespace {
constexpr int kThreads = 256;

struct Args {
  const float* links; const float* sinp_in; const float* g; const float* w;
  float* action; float* sinp; float* out; float* dg; int B, lt, lx;
};
struct Nb { int sp, sm, tp, tm; };

template <int UNROLL, class F>
__device__ __forceinline__ void for_sites(int rank, int size, int lt, int lx, F f) {
  const int d = lt * lx;
  int t = rank / lx, s = rank - t * lx;
  const int dt = size / lx, ds = size - dt * lx;
#pragma unroll (UNROLL)
  for (int i = rank; i < d; i += size) {
    const Nb nb{s + 1 == lx ? i + 1 - lx : i + 1, s == 0 ? i + lx - 1 : i - 1,
                t + 1 == lt ? i + lx - d : i + lx, t == 0 ? i + d - lx : i - lx};
    f(i, nb);
    s += ds; t += dt;
    if (s >= lx) { s -= lx; ++t; }
  }
}

__device__ __forceinline__ float team_sum(float v, float* scratch) {
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

// forward 0
__device__ __forceinline__ float plaquette(const float* __restrict__ u, int i, int lt, int lx) {
  return u[2 * i] - u[2 * i + 1] - u[2 * site_s_plus(i, lt, lx)] + u[2 * site_t_plus(i, lt, lx) + 1];
}
__global__ void __launch_bounds__(kThreads)
f0(const float* __restrict__ links, float* __restrict__ action, float* __restrict__ sinp, int lt, int lx) {
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

// forward 1-4 and 6: the site loop unrolled UNROLL times, launch bound LB,
// REDUCE 0 the one-barrier sum, 1 block_sum
template <int UNROLL, int LB, int REDUCE>
__global__ void __launch_bounds__(LB) fnew(const Args a) {
  __shared__ float scratch[CHAIN_MAX_WARPS];
  __shared__ float total[1];
  const int lt = a.lt, lx = a.lx, d = lt * lx;
  const int rank = threadIdx.x, size = blockDim.x;
  const long long b = blockIdx.x;
  const size_t site0 = (size_t)b * d;
  const float2* u = reinterpret_cast<const float2*>(a.links + 2 * site0);
  float acc = 0.0f;
  for_sites<UNROLL>(rank, size, lt, lx, [&](int i, const Nb& nb) {
    const float2 x = u[i];
    const float p = x.x - x.y - u[nb.sp].x + u[nb.tp].y;
    float sn, cs;
    sincosf(p, &sn, &cs);
    a.sinp[site0 + i] = sn;
    acc += 1.0f - cs;
  });
  if constexpr (REDUCE == 0) {
    acc = team_sum(acc, scratch);
  } else {
    float v[1] = {acc};
    block_sum<1>(v, scratch, total);
    acc = v[0];
  }
  if (rank == 0) a.action[b] = acc;
}

// forward 5
__global__ void __launch_bounds__(512)
f5(const float* __restrict__ links, float* __restrict__ action, float* __restrict__ sinp, int lt, int lx) {
  __shared__ float scratch[CHAIN_MAX_WARPS];
  const int d = lt * lx;
  const int rank = threadIdx.x, size = blockDim.x;
  const long long b = blockIdx.x;
  const size_t site0 = (size_t)b * d;
  const float2* __restrict__ u = reinterpret_cast<const float2*>(links + 2 * site0);
  float acc = 0.0f;
  for_sites<4>(rank, size, lt, lx, [&](int i, const Nb& nb) {
    const float2 x = u[i];
    const float p = x.x - x.y - u[nb.sp].x + u[nb.tp].y;
    float sn, cs;
    sincosf(p, &sn, &cs);
    sinp[site0 + i] = sn;
    acc += 1.0f - cs;
  });
  acc = team_sum(acc, scratch);
  if (rank == 0) action[b] = acc;
}

// backward 0
__global__ void __launch_bounds__(kThreads)
b0(const float* __restrict__ sinp, const float* __restrict__ g, float* __restrict__ force, long long n, int lt, int lx) {
  const int d = lt * lx;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x; k < n; k += stride) {
    const long long b = k / d;
    const int i = (int)(k - b * d);
    const float* s = sinp + b * d;
    const float gb = g[b];
    force[2 * k] = gb * (s[i] - s[site_s_minus(i, lt, lx)]);
    force[2 * k + 1] = gb * (-s[i] + s[site_t_minus(i, lt, lx)]);
  }
}
// backward 3
__global__ void __launch_bounds__(kThreads)
b3(const float* __restrict__ sinp, const float* __restrict__ g, float2* __restrict__ force, long long n, int lt, int lx) {
  const int d = lt * lx;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x; k < n; k += stride) {
    const long long b = k / d;
    const int i = (int)(k - b * d);
    const float* s = sinp + b * d;
    const float gb = g[b];
    const float s0 = s[i];
    force[k] = make_float2(gb * (s0 - s[site_s_minus(i, lt, lx)]), gb * (-s0 + s[site_t_minus(i, lt, lx)]));
  }
}
// backward 1
__global__ void __launch_bounds__(512) b1(const Args a) {
  const int lt = a.lt, lx = a.lx, d = lt * lx;
  const long long b = blockIdx.x;
  const size_t site0 = (size_t)b * d;
  const float gb = a.g[b];
  const float* sp = a.sinp_in + site0;
  float2* out = reinterpret_cast<float2*>(a.out) + site0;
  for_sites<4>(threadIdx.x, blockDim.x, lt, lx, [&](int i, const Nb& nb) {
    const float s0 = sp[i];
    out[i] = make_float2(gb * (s0 - sp[nb.sm]), gb * (-s0 + sp[nb.tm]));
  });
}
// backward 2
__global__ void __launch_bounds__(512) b2(const Args a) {
  extern __shared__ __align__(16) float field[];
  __shared__ __align__(8) unsigned long long bar;
  const int lt = a.lt, lx = a.lx, d = lt * lx;
  const long long b = blockIdx.x;
  const size_t site0 = (size_t)b * d;
  const float gb = a.g[b];
  float2* out = reinterpret_cast<float2*>(a.out) + site0;
  if (threadIdx.x == 0) { mbar_init(&bar, 1); mbar_init_fence(); }
  __syncthreads();
  if (threadIdx.x == 0) { mbar_expect_tx(&bar, 4u * d); bulk_load(field, a.sinp_in + site0, 4u * d, &bar); }
  mbar_wait(&bar, 0);
  for_sites<4>(threadIdx.x, blockDim.x, lt, lx, [&](int i, const Nb& nb) {
    const float s0 = field[i];
    out[i] = make_float2(gb * (s0 - field[nb.sm]), gb * (-s0 + field[nb.tm]));
  });
}

int threads_of(int d, int cap) { int nt = 32 * ((d + 31) / 32); return nt < cap ? nt : cap; }
}  // namespace

extern "C" int fwd_variant(int v, const float* links, float* action, float* sinp, int B, int lt, int lx, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int d = lt * lx;
  const Args a{links, nullptr, nullptr, nullptr, action, sinp, nullptr, nullptr, B, lt, lx};
  switch (v) {
    case 0: f0<<<B, threads_of(d, 256), 0, st>>>(links, action, sinp, lt, lx); break;
    case 1: fnew<4, 512, 0><<<B, threads_of(d, 512), 0, st>>>(a); break;
    case 2: fnew<1, 512, 0><<<B, threads_of(d, 512), 0, st>>>(a); break;
    case 3: fnew<4, 256, 0><<<B, threads_of(d, 256), 0, st>>>(a); break;
    case 4: fnew<4, 512, 1><<<B, threads_of(d, 512), 0, st>>>(a); break;
    case 5: f5<<<B, threads_of(d, 512), 0, st>>>(links, action, sinp, lt, lx); break;
    case 6: fnew<1, 256, 1><<<B, threads_of(d, 256), 0, st>>>(a); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}

extern "C" int bwd_variant(int v, const float* sinp, const float* g, float* force, int B, int lt, int lx, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int d = lt * lx;
  const long long n = (long long)B * d;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > (1 << 20)) blocks = 1 << 20;
  const Args a{nullptr, sinp, g, nullptr, nullptr, nullptr, force, nullptr, B, lt, lx};
  switch (v) {
    case 0: b0<<<(unsigned)blocks, kThreads, 0, st>>>(sinp, g, force, n, lt, lx); break;
    case 1: b1<<<B, threads_of(d, 512), 0, st>>>(a); break;
    case 2: {
      const int smem = 4 * d;
      if (smem > 48 * 1024) cudaFuncSetAttribute(b2, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      b2<<<B, threads_of(d, 512), smem, st>>>(a); break;
    }
    case 3: b3<<<(unsigned)blocks, kThreads, 0, st>>>(sinp, g, reinterpret_cast<float2*>(force), n, lt, lx); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}

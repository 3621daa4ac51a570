// Shared device code of the trained MLP chain kernel's two routes:
// l2hmc_chain.cu (a block of C chains over the whole lattice) and
// l2hmc_chain_cluster.cu (a thread-block cluster whose CTAs each own a slab
// of rows of the same chains).  The block's warp roles and constants, the
// weight arrays, the tensor-core arithmetic (3xTF32 or bf16 mma.sync) and
// the TMA weight ring's chunk stream.  Each route keeps its own product walk.
#pragma once

#include <cuda_bf16.h>

#include "chain_common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;  // the elementwise phases use all
constexpr int kMmaWarps = 8;           // warps 0-7 run the products
constexpr int kProducer = kMmaWarps;   // lane 0 of warp 8 streams the weights
constexpr int kChunkFloats = 4096;     // 16 KB: 32 tiles of 512 B
constexpr int kChunkBytes = 4 * kChunkFloats;
constexpr int kMaxStages = 8;
constexpr double kPiD = 3.141592653589793;

// One net: the packed matmul chunks [in | trunk | head] and the float32
// vectors, padded to the kernel's hidden width hp.
template <class WT>
struct NetW {
  const WT* mm;
  const float *t, *b, *hb, *headb0, *headb1, *cs0, *cs1, *ct0, *ct1;
};

template <class WT>
struct Weights {
  NetW<WT> x, v;
  const float *mask0, *mask1;  // (K, d) each
};

// An activation as the matmul sees it: itself, or rounded to bf16.
template <class WT>
__device__ __forceinline__ float act(float x) {
  return x;
}
template <>
__device__ __forceinline__ float act<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

struct L2Rand {
  const float *v0s, *v1s, *ds, *us, *nus, *uhs;
};

// ---------------------------------------------------------------------------
// Tensor-core products
// ---------------------------------------------------------------------------

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (nearest, ties away from
// zero), with integer operations: the conversion instruction runs on a
// narrow pipe and cost the kernel 17% (PERF.md).
__device__ __forceinline__ unsigned tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo, each rounded to TF32
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// k-step width of one tile: 8 (tf32) or 16 (bf16)
template <class WT>
constexpr int kKstep = sizeof(WT) == 4 ? 8 : 16;

// One warp's accumulators, two independent mma chains: for 3xTF32 the big
// (hi*hi) and the small (lo*hi + hi*lo) part, for bf16 the even and the odd
// tiles.
template <class WT>
struct Acc {
  static constexpr int kChains = sizeof(WT) == 4 ? 1 : 2;
  float big[kChains][4], small[4];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      small[e] = 0.0f;
#pragma unroll
      for (int h = 0; h < kChains; ++h) big[h][e] = 0.0f;
    }
  }
  __device__ __forceinline__ float sum(int e) const {
    float b = big[0][e];
#pragma unroll
    for (int h = 1; h < kChains; ++h) b += big[h][e];
    return b + small[e];
  }
};

// Accumulate one tile product into chain h: a (this lane's A fragment, 16
// bytes) times the B operand feat^T[k0 .. k0 + kstep) of the chains, rows
// of `bsrc` (stride `bst`); columns of chains beyond C are zero.
template <class WT, int C>
__device__ __forceinline__ void tile_mma(const float4& a, const float* bsrc,
                                         int bst, int k0, Acc<WT>& acc,
                                         int q) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const bool live = gq < C;
  const float* brow = bsrc + (live ? gq : 0) * bst + k0;
  if constexpr (sizeof(WT) == 4) {
    unsigned ah[4], al[4], bh0, bl0, bh1, bl1;
    split_tf32(a.x, ah[0], al[0]);
    split_tf32(a.y, ah[1], al[1]);
    split_tf32(a.z, ah[2], al[2]);
    split_tf32(a.w, ah[3], al[3]);
    split_tf32(live ? brow[tq] : 0.0f, bh0, bl0);
    split_tf32(live ? brow[tq + 4] : 0.0f, bh1, bl1);
    mma_tf32(acc.small, al, bh0, bh1);
    mma_tf32(acc.small, ah, bl0, bl1);
    mma_tf32(acc.big[0], ah, bh0, bh1);
  } else {
    const unsigned av[4] = {__float_as_uint(a.x), __float_as_uint(a.y),
                            __float_as_uint(a.z), __float_as_uint(a.w)};
    const unsigned b0 =
        live ? pack_bf16(brow[2 * tq], brow[2 * tq + 1]) : 0u;
    const unsigned b1 =
        live ? pack_bf16(brow[2 * tq + 8], brow[2 * tq + 9]) : 0u;
    mma_bf16(acc.big[q % Acc<WT>::kChains], av, b0, b1);
  }
}

// ---------------------------------------------------------------------------
// The weight ring: TMA bulk copies into `stages` slots, a full and an empty
// mbarrier per slot.  One producer thread (warp kProducer, lane 0) fills a
// slot once the 8 product warps have released it; the product warps wait
// on `full` only, so they run ahead of
// each other and of the copies by up to `stages` chunks, with no block-wide
// barrier per chunk.  The mbarrier and bulk-copy helpers are in
// chain_common.cuh.
// ---------------------------------------------------------------------------

// The 8 product warps only (named barrier 1).
__device__ __forceinline__ void mma_warps_sync() {
  asm volatile("barrier.sync 1, %0;" ::"n"(kMmaWarps * 32) : "memory");
}

// The chunk stream of one MLP call; `pos` (the ring position of its chunk
// 0) is uniform.  Position p fills slot p % stages for the (p / stages)-th
// time.
struct Stream {
  const void* src;
  int nch;
  unsigned pos;

  // Producer: request chunks [j0, j1), each once its slot is released.
  template <class S, class G>
  __device__ __forceinline__ void produce(const S& s, const G& g, int j0,
                                          int j1) const {
    for (int j = j0; j < j1; ++j) {
      const unsigned p = pos + j;
      const int st = p % g.stages;
      if (p >= (unsigned)g.stages)
        mbar_wait(s.empty + st, ((p / g.stages) - 1u) & 1u);
      mbar_expect_tx(s.full + st, kChunkBytes);
      const char* gsrc =
          static_cast<const char*>(src) + (size_t)j * kChunkBytes;
      bulk_load(s.ring + (size_t)st * kChunkFloats, gsrc, kChunkBytes,
                s.full + st);
    }
  }
  // Product warps: wait for chunk j, then release it.
  template <class S, class G>
  __device__ __forceinline__ const float* next(const S& s, const G& g,
                                               int j) const {
    const unsigned p = pos + j;
    mbar_wait(s.full + p % g.stages, (p / g.stages) & 1u);
    return s.ring + (size_t)(p % g.stages) * kChunkFloats;
  }
  template <class S, class G>
  __device__ __forceinline__ void release(const S& s, const G& g,
                                          int j) const {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(s.empty + (pos + j) % g.stages);
  }
};

// Ring slots the producer requests before the call's features are built.
template <class G>
__device__ __forceinline__ int prefetch_chunks(const G& g, int nch) {
  return nch < g.stages ? nch : g.stages;
}

__device__ __forceinline__ void time_enc(float idx, int K, float* tau) {
  const float ang = CHAIN_TWO_PI_F * idx / (float)K;
  tau[0] = cosf(ang);
  tau[1] = sinf(ang);
}

}  // namespace

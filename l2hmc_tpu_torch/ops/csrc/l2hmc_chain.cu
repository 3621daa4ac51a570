// Fused TRAINED L2HMC chain (MLP conditioners, U(1), merge_v_halves):
// N transitions of C chains per block in one launch.
//
// Replaces the TPU kernel l2hmc_tpu/ops/l2hmc_kernel.py:_build_kernel
// (entry l2hmc_chain_pallas).  Each transition, per chain: fresh momenta and
// direction, K+1 merged VNet momentum kicks and 2K masked XNet circle-scaling
// position half-updates with the exact log-Jacobian, the Wilson force after
// every step, the MH accept with non-finite rejection, and optionally one
// exact instanton hop from the carried plaquette fields.  Only the final
// links and three (N, B) traces reach device memory.
//
// What bounds it on an H100: the conditioner, 83% of the transition at
// 16x16 (PERF.md).  Per transition a chain runs 3K+1 MLP calls of (6d x h)
// + (h x h) + (h x 6d) multiply-adds (about 0.4 MFLOP each at 16x16,
// h=64).  One net's weights (0.78 MB in f32) do not fit in shared memory
// beside the chains' fields, so every call streams them from L2 (2.06 GB
// per transition at 2048 chains), and with one block per SM the latency of
// that stream and of the product warps' mma chains is not hidden: builds
// without the products, or without the stream, each still took 68-83% of
// the time (PERF.md).  The design:
// - C chains per block, a template parameter in {2, 4, 8}: the wrapper
//   picks the largest whose fields and features (12 d floats per chain) and
//   a ring of at least two weight chunks fit the block's shared memory
//   (16x16: C = 8, a quarter of the bytes per chain of the former C = 2).
// - The products on tensor cores, chains as N: out^T = W^T feat^T with the
//   weights as the M operand of mma.sync m16n8k8 (N = 8 chains; a block of
//   C < 8 leaves columns idle).  mma.sync rather than wgmma: N = 8 is
//   mma.sync's native width, and its fragments come straight from shared
//   memory in the order the wrapper packs them, with no descriptor or
//   swizzle; wgmma's 64-row warpgroup tiles would need all 4 warps of a
//   group on one weight tile per step.
// - The hidden width hp in {32, 64, 128, 256} (padded with zero units) sets
//   mt = hp / 16 tile rows.  Up to hp = 128 the 8 product warps share a tile
//   row in 8 / mt k-groups; at hp = 256 each warp covers two tile rows over
//   all k-steps (template RPW = 2: two accumulator sets), so a chunk holds 2
//   k-steps of the warp's two rows instead of 4 of one.
//   * float32 (WT = float): 3xTF32.  Each operand x is split into
//     hi = rna_tf32(x) and lo = rna_tf32(x - hi) (cvt.rna.tf32.f32's
//     rounding, done with integer operations) and
//     the product is hi*hi + (lo*hi + hi*lo), accumulated in float32: as
//     accurate as a float32 FMA loop (ops/l2hmc_kernel.py tf32x3_matmul is
//     the plain form; a single TF32 pass would be ~1e-3 off).
//   * bfloat16 weights (WT = __nv_bfloat16): m16n8k16 bf16 in one pass,
//     float32 accumulation; features and hidden activations are rounded to
//     bf16 where written, as the plain version rounds them.
//   * ablated (ABLATE): no features, no products, no heads; S, T and Q are
//     read from a kernel argument that the wrapper sets to 0.
// - The weights in fragment order: the wrapper packs each net's three
//   matrices into 16 KB chunks of 32 tiles (8 warps x 4), each tile the 32
//   lanes' A fragments in a row, so a lane reads its fragment with one
//   16-byte shared load, free of bank conflicts.
// - The accepted state (links and their plaquette sin/cos), read once per
//   transition and written on accept or hop, lives in device memory (the
//   links in the output arrays, sin/cos P in a (2, B, d) scratch the
//   wrapper allocates), which leaves 7 ring slots instead of 5 at C = 8.
// - The chunks reach shared memory by TMA bulk copies (cp.async.bulk) into
//   a ring of S >= 2 slots with a full and an empty mbarrier each.  One
//   producer thread requests a call's first S chunks before its features
//   are built and each later chunk as soon as its slot is released; the 8
//   product warps wait only on `full` and release slots themselves, so no
//   block-wide barrier falls between chunks (one per chunk cost the kernel
//   ~250 us per transition, PERF.md).  Thread-block clusters of 2 and 4
//   that multicast each chunk to all their blocks (one L2 read for 2 or 4
//   SMs) ran 2.2x and 4.8x slower on an H100 (PERF.md), so there are none.
// - 16 warps per block: warps 0-7 run the products (two accumulator chains
//   each), warp 8 streams the weights, all 16 run the elementwise phases
//   (libdevice exp, tanh, atan2, log, sincos per site), whose latency one
//   block per SM hides only with that many.  The in-projection and the
//   trunk (M = h rows) give each hidden-unit tile 8 / (h/16) warps, each
//   over a quarter of every chunk's k-steps; their partial sums meet once
//   per call (h x 8 floats per warp).  The head (M = 6d rows) gives each
//   product warp its own output tiles.
//
// The elementwise machinery (kick, position update, force, energy, accept,
// hop) is as it was for C = 2, looped over (chain, site) pairs so that all
// warps work on all chains at once: the momentum kick's
// `a` and the position update are rounded op by op as the plain version
// rounds them, the energy change is summed per site.
//
// Randomness: injected arrays (v0s, v1s, ds, us[, nus, uhs]), or
// Philox4_32_10 keyed by (chain, transition) with the seed drawn by the
// caller.

#include <cuda_bf16.h>

#include "chain_common.cuh"

// Most chains per block (the committed value; a smaller cap builds for a
// sweep, see l2hmc_tpu_torch/sweep_chains.py).
#ifndef L2HMC_CHAIN_MAX_C
#define L2HMC_CHAIN_MAX_C 8
#endif

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

// Geometry of one launch; the product layout is ops/l2hmc_kernel.py
// mma_geometry's.
struct Geo {
  int B, lt, lx, d, K, N, h, bounded_q, hop;
  float eps, beta;
  float ablated_stq;  // S = T = Q of the ablated kernel: 0, not a constant
  unsigned long long seed;
  int hp, mt, n_in, n_tr, n_hd, kq, bs, hs, stages;
};

// Per-chain scalars in shared memory: SC[c * 4 + {0: direction, 1: accept
// uniform, 2: hop winding sign, 3: hop uniform}], TAU[c * 2 + {cos, sin}].
struct Smem {
  float* ring;                       // stages x 16 KB weight chunks (first)
  unsigned long long *full, *empty;  // one mbarrier pair per stage
  float *Y0, *Y1, *W0, *W1, *SP1, *CP1;  // (C, d) each: proposal, momenta
  float* BUF;            // (C, bs): features in, head outputs out
  float *HID1, *HID2;    // (C, hs)
  float* RED;            // (max(8, mt), 128): the narrow products' partials
  float *scratch, *red;  // block reductions
  float *SC, *TAU;
};

// Partial-sum slots of a narrow product: one per warp up to mt = 8, one per
// tile row at mt = 16.
__host__ __device__ __forceinline__ int red_rows(int mt) {
  return mt > kMmaWarps ? mt : kMmaWarps;
}

template <int C, int RPW>
__device__ __forceinline__ Smem carve(float* smem, const Geo& g) {
  Smem s;
  s.ring = smem;
  s.full = reinterpret_cast<unsigned long long*>(
      smem + (size_t)g.stages * kChunkFloats);
  s.empty = s.full + kMaxStages;
  float* p = smem + (size_t)g.stages * kChunkFloats + 4 * kMaxStages;
  const size_t cd = (size_t)C * g.d;
  s.Y0 = p;
  s.Y1 = s.Y0 + cd;
  s.W0 = s.Y1 + cd;
  s.W1 = s.W0 + cd;
  s.SP1 = s.W1 + cd;
  s.CP1 = s.SP1 + cd;
  s.BUF = s.CP1 + cd;
  s.HID1 = s.BUF + (size_t)C * g.bs;
  s.HID2 = s.HID1 + C * g.hs;
  s.RED = s.HID2 + C * g.hs;
  s.scratch = s.RED + kMmaWarps * RPW * 128;
  s.red = s.scratch + kWarps * 4 * C;
  s.SC = s.red + 4 * C;
  s.TAU = s.SC + 4 * C;
  return s;
}

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
  __device__ __forceinline__ void produce(const Smem& s, const Geo& g, int j0,
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
  __device__ __forceinline__ const float* next(const Smem& s, const Geo& g,
                                               int j) const {
    const unsigned p = pos + j;
    mbar_wait(s.full + p % g.stages, (p / g.stages) & 1u);
    return s.ring + (size_t)(p % g.stages) * kChunkFloats;
  }
  __device__ __forceinline__ void release(const Smem& s, const Geo& g,
                                          int j) const {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(s.empty + (pos + j) % g.stages);
  }
};

// A narrow product out^T (hp x 8) = A (hp x kp) * B^T over `nch` chunks
// starting at chunk `j0` of the stream; B rows in `bsrc` (stride `bst`).
// Product warps only.  Warp w's four tiles of a chunk lie in tile row
// w % g.mt and k-group w / g.mt (ops/l2hmc_kernel.py mma_pack); leaves the
// per-warp partials in RED (8 warps x 16 rows x 8 chains).  hp <= 128.
template <class WT, int C>
__device__ __forceinline__ void narrow(const Stream& str, const Smem& s,
                                       const Geo& g, int j0, int nch,
                                       const float* bsrc, int bst) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kg = warp / g.mt, wp = kMmaWarps / g.mt;
  Acc<WT> acc;
  acc.zero();
  for (int j = 0; j < nch; ++j) {
    const float* chunk = str.next(s, g, j0 + j);
    const float4* tiles =
        reinterpret_cast<const float4*>(chunk) + (warp * 4) * 32 + lane;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int ks = (j * wp + kg) * 4 + q;
      tile_mma<WT, C>(tiles[q * 32], bsrc, bst, ks * kKstep<WT>, acc, q);
    }
    str.release(s, g, j0 + j);
  }
  const int gq = lane >> 2, tq = lane & 3;
  float* r = s.RED + (size_t)warp * 128;
  r[gq * 8 + 2 * tq] = acc.sum(0);
  r[gq * 8 + 2 * tq + 1] = acc.sum(1);
  r[(gq + 8) * 8 + 2 * tq] = acc.sum(2);
  r[(gq + 8) * 8 + 2 * tq + 1] = acc.sum(3);
  mma_warps_sync();
}

// narrow() at hp = 256 (mt = 16): warp w covers tile rows w and w + 8 over
// all k-steps, tiles q = 0, 1 of a chunk in row w and 2, 3 in row w + 8,
// k-steps 2 j + q % 2; the partials of tile row m in RED slot m.  A second
// function: one narrow() for both widths ran the hp <= 128 kernel 1.9%
// slower (PERF.md).
template <class WT, int C>
__device__ __forceinline__ void narrow_wide(const Stream& str, const Smem& s,
                                            const Geo& g, int j0, int nch,
                                            const float* bsrc, int bst) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  Acc<WT> acc[2];
  acc[0].zero();
  acc[1].zero();
  for (int j = 0; j < nch; ++j) {
    const float* chunk = str.next(s, g, j0 + j);
    const float4* tiles =
        reinterpret_cast<const float4*>(chunk) + (warp * 4) * 32 + lane;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      tile_mma<WT, C>(tiles[q * 32], bsrc, bst,
                      (2 * j + (q & 1)) * kKstep<WT>, acc[q >> 1], q & 1);
    str.release(s, g, j0 + j);
  }
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float* r = s.RED + (size_t)(warp + kMmaWarps * h) * 128;
    r[gq * 8 + 2 * tq] = acc[h].sum(0);
    r[gq * 8 + 2 * tq + 1] = acc[h].sum(1);
    r[(gq + 8) * 8 + 2 * tq] = acc[h].sum(2);
    r[(gq + 8) * 8 + 2 * tq + 1] = acc[h].sum(3);
  }
  mma_warps_sync();
}

// Sum of the narrow product's partials for hidden unit j, chain c.
template <int RPW>
__device__ __forceinline__ float narrow_sum(const Smem& s, const Geo& g,
                                            int j, int c) {
  const int mtile = j >> 4, row = j & 15;
  const int wp = RPW == 1 ? kMmaWarps / g.mt : 1;  // k-groups
  float acc = 0.0f;
  for (int kg = 0; kg < wp; ++kg)
    acc += s.RED[(size_t)(kg * g.mt + mtile) * 128 + row * 8 + c];
  return acc;
}

// Ring slots the producer requests before the call's features are built.
__device__ __forceinline__ int prefetch_chunks(const Geo& g, int nch) {
  return nch < g.stages ? nch : g.stages;
}

// One MLP conditioner call on the C feature rows in BUF; the head outputs
// [S0 | T0 | Q0 | S1 | T1 | Q1] (bias added) overwrite BUF's first 6d
// columns.  The producer streams the chunks the caller did not prefetch;
// the 8 product warps run the products and their epilogues; every thread
// meets at the end.
template <class WT, int C, int RPW>
__device__ void mlp(const NetW<WT>& w, const Stream& str, const Smem& s,
                    const Geo& g) {
  const int tid = threadIdx.x, D6 = 6 * g.d, D3 = 3 * g.d;
  const int warp = tid >> 5, lane = tid & 31, nt = kMmaWarps * 32;
  if (warp == kProducer) {
    if (lane == 0) str.produce(s, g, prefetch_chunks(g, str.nch), str.nch);
    __syncwarp();
  } else if (warp < kMmaWarps) {
    // in-projection (hp x 6d) . feat^T
    if constexpr (RPW == 1)
      narrow<WT, C>(str, s, g, 0, g.n_in, s.BUF, g.bs);
    else
      narrow_wide<WT, C>(str, s, g, 0, g.n_in, s.BUF, g.bs);
    for (int o = tid; o < C * g.hp; o += nt) {
      const int c = o / g.hp, j = o - c * g.hp;
      const float tt =
          s.TAU[2 * c] * w.t[j] + s.TAU[2 * c + 1] * w.t[g.hp + j];
      s.HID1[c * g.hs + j] =
          act<WT>(fmaxf(narrow_sum<RPW>(s, g, j, c) + tt + w.b[j], 0.0f));
    }
    mma_warps_sync();
    // trunk (hp x hp) . hid1^T
    if constexpr (RPW == 1)
      narrow<WT, C>(str, s, g, g.n_in, g.n_tr, s.HID1, g.hs);
    else
      narrow_wide<WT, C>(str, s, g, g.n_in, g.n_tr, s.HID1, g.hs);
    for (int o = tid; o < C * g.hp; o += nt) {
      const int c = o / g.hp, j = o - c * g.hp;
      s.HID2[c * g.hs + j] =
          act<WT>(fmaxf(narrow_sum<RPW>(s, g, j, c) + w.hb[j], 0.0f));
    }
    mma_warps_sync();
    // merged heads of both directions (6d x hp) . hid2^T: each warp owns
    // one 16-row output tile per group of 8 tiles, over g.kq chunks
    const int gq = lane >> 2, tq = lane & 3;
    const int j0 = g.n_in + g.n_tr;
    Acc<WT> acc;
    for (int j = 0; j < g.n_hd; ++j) {
      const int grp = j / g.kq, kq = j - grp * g.kq;
      if (kq == 0) acc.zero();
      const float* chunk = str.next(s, g, j0 + j);
      const float4* tiles =
          reinterpret_cast<const float4*>(chunk) + (warp * 4) * 32 + lane;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        tile_mma<WT, C>(tiles[q * 32], s.HID2, g.hs,
                        (kq * 4 + q) * kKstep<WT>, acc, q);
      str.release(s, g, j0 + j);
      if (kq == g.kq - 1) {
        const int m0 = (grp * kMmaWarps + warp) * 16 + gq;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = m0 + (e >> 1) * 8, c = 2 * tq + (e & 1);
          if (n < D6 && c < C) {
            const float hb = n < D3 ? w.headb0[n] : w.headb1[n - D3];
            s.BUF[c * g.bs + n] = acc.sum(e) + hb;
          }
        }
      }
    }
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// The transition
// ---------------------------------------------------------------------------

// v[c] += x for a runtime c, with static register indices
template <int C>
__device__ __forceinline__ void add_at(float (&v)[C], int c, float x) {
#pragma unroll
  for (int k = 0; k < C; ++k)
    if (k == c) v[k] += x;
}

// v[c] for a runtime c, with static register indices
template <int C>
__device__ __forceinline__ float pick(const float (&v)[C], int c) {
  float x = 0.0f;
#pragma unroll
  for (int k = 0; k < C; ++k)
    if (k == c) x = v[k];
  return x;
}

__device__ __forceinline__ void time_enc(float idx, int K, float* tau) {
  const float ang = CHAIN_TWO_PI_F * idx / (float)K;
  tau[0] = cosf(ang);
  tau[1] = sinf(ang);
}

// Merged momentum kick (update_v), direction-fused.  The force is
// beta * grad(SP1), SP1 being the sine field of the current proposal.
// Every elementwise loop runs over (chain, site) pairs, so all warps work
// on all chains at once.
template <class WT, bool ABLATE, int C, int RPW>
__device__ void kick(const Weights<WT>& W, const Smem& s, const Geo& g,
                     int nc, unsigned& pos, float factor, float t_fwd,
                     float t_bwd, float (&ldp)[C]) {
  const int tid = threadIdx.x, nt = blockDim.x, d = g.d;
  if constexpr (!ABLATE) {
    const Stream str{W.v.mm, g.n_in + g.n_tr + g.n_hd, pos};
    if (tid == kProducer * 32) str.produce(s, g, 0, prefetch_chunks(g, str.nch));
    for (int o = tid; o < nc * d; o += nt) {
      const int c = o / d, i = o - c * d;
      const float* sp = s.SP1 + c * d;
      float* f = s.BUF + c * g.bs;
      float s0, c0, s1, c1;
      sincosf(s.Y0[o], &s0, &c0);
      sincosf(s.Y1[o], &s1, &c1);
      f[i] = act<WT>(c0);
      f[d + i] = act<WT>(c1);
      f[2 * d + i] = act<WT>(s0);
      f[3 * d + i] = act<WT>(s1);
      f[4 * d + i] = act<WT>(g.beta * grad0(sp, i, g.lt, g.lx));
      f[5 * d + i] = act<WT>(g.beta * grad1(sp, i, g.lt, g.lx));
    }
    if (tid < nc)
      time_enc(s.SC[tid * 4] > 0.0f ? t_fwd : t_bwd, g.K, s.TAU + 2 * tid);
    __syncthreads();
    mlp<WT, C, RPW>(W.v, str, s, g);
    pos += str.nch;
  }

  const float fe = factor * g.eps;
  for (int o = tid; o < nc * d; o += nt) {
    const int c = o / d, i = o - c * d;
    const float dsg = s.SC[c * 4];
    const float* sp = s.SP1 + c * d;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sv = g.ablated_stq, tv = g.ablated_stq, qv = g.ablated_stq;
      if constexpr (!ABLATE) {
        const float* hd = s.BUF + c * g.bs + r * 3 * d;
        const float* cs = r ? W.v.cs1 : W.v.cs0;
        const float* ct = r ? W.v.ct1 : W.v.ct0;
        sv = tanhf(hd[i]) * expf(cs[i]);
        tv = hd[d + i];
        const float qr = hd[2 * d + i];
        qv = (g.bounded_q ? tanhf(qr) : qr) * expf(ct[i]);
      }
      const float gg = g.beta * (r ? grad1(sp, i, g.lt, g.lx)
                                   : grad0(sp, i, g.lt, g.lx));
      // a rounded op by op, as the plain version rounds it: left to nvcc,
      // the full and the ablated instantiations contract it into FMAs
      // differently and part by an ulp on the same S, T, Q.  The rest is
      // exact at S = 0 (e = 1) either way; rounding it too cost the full
      // kernel 4.5% (PERF.md).
      const float hs = fe * sv;
      const float a = __fmul_rn(
          fe, __fsub_rn(__fmul_rn(expf(__fmul_rn(g.eps, qv)), gg), tv));
      const float e = expf(dsg * hs);
      float* w = (r ? s.W1 : s.W0) + o;
      *w = dsg > 0.0f ? *w * e - a : (*w + a) * e;
      add_at<C>(ldp, c, dsg * hs);
    }
  }
  __syncthreads();
}

// One masked position half-update on the torus (update_x, u1 branch).
// hold = (fwd ? mask[step] : 1 - mask[K-1-step]), inverted for the second
// half-update of the step.
template <class WT, bool ABLATE, int C, int RPW>
__device__ void xhalf(const Weights<WT>& W, const Smem& s, const Geo& g,
                      int nc, unsigned& pos, int step, bool second,
                      float (&ldp)[C]) {
  const int tid = threadIdx.x, nt = blockDim.x, d = g.d, K = g.K;
  const float* mf0 = W.mask0 + (size_t)step * d;
  const float* mf1 = W.mask1 + (size_t)step * d;
  const float* mb0 = W.mask0 + (size_t)(K - 1 - step) * d;
  const float* mb1 = W.mask1 + (size_t)(K - 1 - step) * d;
  if constexpr (!ABLATE) {
    const Stream str{W.x.mm, g.n_in + g.n_tr + g.n_hd, pos};
    if (tid == kProducer * 32) str.produce(s, g, 0, prefetch_chunks(g, str.nch));
    for (int o = tid; o < nc * d; o += nt) {
      const int c = o / d, i = o - c * d;
      const bool fwd = s.SC[c * 4] > 0.0f;
      float* f = s.BUF + c * g.bs;
      float h0 = fwd ? mf0[i] : 1.0f - mb0[i];
      float h1 = fwd ? mf1[i] : 1.0f - mb1[i];
      if (second) {
        h0 = 1.0f - h0;
        h1 = 1.0f - h1;
      }
      float s0, c0, s1, c1;
      sincosf(s.Y0[o], &s0, &c0);
      sincosf(s.Y1[o], &s1, &c1);
      f[i] = act<WT>(s.W0[o]);
      f[d + i] = act<WT>(s.W1[o]);
      f[2 * d + i] = act<WT>(h0 * c0);
      f[3 * d + i] = act<WT>(h1 * c1);
      f[4 * d + i] = act<WT>(h0 * s0);
      f[5 * d + i] = act<WT>(h1 * s1);
    }
    if (tid < nc)
      time_enc(s.SC[tid * 4] > 0.0f ? (float)step : (float)(K - 1 - step), K,
               s.TAU + 2 * tid);
    __syncthreads();
    mlp<WT, C, RPW>(W.x, str, s, g);
    pos += str.nch;
  }

  for (int o = tid; o < nc * d; o += nt) {
    const int c = o / d, i = o - c * d;
    const float dsg = s.SC[c * 4];
    const bool fwd = dsg > 0.0f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float* mf = r ? mf1 : mf0;
      const float* mb = r ? mb1 : mb0;
      float hold = fwd ? mf[i] : 1.0f - mb[i];
      if (second) hold = 1.0f - hold;
      float sv = g.ablated_stq, tv = g.ablated_stq, qv = g.ablated_stq;
      if constexpr (!ABLATE) {
        const float* hd = s.BUF + c * g.bs + r * 3 * d;
        const float* cs = r ? W.x.cs1 : W.x.cs0;
        const float* ct = r ? W.x.ct1 : W.x.ct0;
        sv = tanhf(hd[i]) * expf(cs[i]);
        tv = hd[d + i];
        const float qr = hd[2 * d + i];
        qv = (g.bounded_q ? tanhf(qr) : qr) * expf(ct[i]);
      }
      float* yp = (r ? s.Y1 : s.Y0) + o;
      const float w = (r ? s.W1 : s.W0)[o];
      const float y = *yp;
      // rounded op by op, as the plain version rounds it (see kick())
      const float es = __fmul_rn(g.eps, sv);
      const float bb = __fmul_rn(
          g.eps, __fadd_rn(__fmul_rn(expf(__fmul_rn(g.eps, qv)), w), tv));
      const float u_in = fwd ? y : wrap_angle(__fsub_rn(y, bb));
      // circle_scale(u_in, dsg * es): 2 atan2(e^a sin(x/2), cos(x/2))
      const float a = dsg * es;
      float s2, c2;
      sincosf(0.5f * u_in, &s2, &c2);
      const float ea = expf(a);
      const float y2 = 2.0f * atan2f(__fmul_rn(ea, s2), c2);
      const float lde = __fsub_rn(
          a, logf(__fadd_rn(__fmul_rn(c2, c2),
                            __fmul_rn(__fmul_rn(__fmul_rn(ea, ea), s2),
                                      s2))));
      const float upd = fwd ? wrap_angle(__fadd_rn(y2, bb)) : y2;
      *yp = __fadd_rn(__fmul_rn(hold, y), __fmul_rn(1.0f - hold, upd));
      add_at<C>(ldp, c, (1.0f - hold) * lde);
    }
  }
  __syncthreads();
}

// Plaquette sine/cosine fields of the links (y0, y1) of the nc chains into
// (sp, cp); returns the potentials and unrounded charges.
template <int C>
__device__ void plaq_fields(const float* y0, const float* y1, float* sp,
                            float* cp, const Smem& s, const Geo& g, int nc,
                            float (&pot)[C], float (&chg)[C]) {
  const int tid = threadIdx.x, nt = blockDim.x, d = g.d;
  float v[2 * C];
#pragma unroll
  for (int k = 0; k < 2 * C; ++k) v[k] = 0.0f;
  for (int o = tid; o < nc * d; o += nt) {
    const int c = o / d, i = o - c * d;
    float sn, cs;
    const float p = plaq_angle(y0 + c * d, y1 + c * d, i, g.lt, g.lx);
    sincosf(p, &sn, &cs);
    sp[o] = sn;
    cp[o] = cs;
    add_at<2 * C>(v, c, 1.0f - cs);
    add_at<2 * C>(v, C + c, wrap_angle(p));
  }
  block_sum<2 * C>(v, s.scratch, s.red);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    pot[c] = v[c];
    chg[c] = v[C + c] * CHAIN_INV_TWO_PI_F;
  }
}

template <class WT, bool ABLATE, int C, int RPW>
__global__ void __launch_bounds__(kThreads, 1)  // one block per SM
l2hmc_chain_kernel(float* __restrict__ x0g, float* __restrict__ x1g,
                   float* __restrict__ spcp, Weights<WT> W, L2Rand rnd, float* __restrict__ plaq_tr,
                   float* __restrict__ chg_tr, float* __restrict__ prob_tr,
                   Geo g) {
  extern __shared__ __align__(128) float smem[];
  const int d = g.d, K = g.K, B = g.B;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int b0 = blockIdx.x * C;
  const int nc = min(C, B - b0);
  const Smem s = carve<C, RPW>(smem, g);
  const bool injected = rnd.v0s != nullptr;
  unsigned pos = 0;  // ring position of the next chunk

  const double dd = (double)d;
  const float cd = (float)cos(2.0 * kPiD / dd);
  const float sd = (float)sin(2.0 * kPiD / dd);
  const float one_minus_cd = (float)(1.0 - cos(2.0 * kPiD / dd));
  const float cd_minus_one = (float)(cos(2.0 * kPiD / dd) - 1.0);
  const float delta = (float)(2.0 * kPiD / dd);
  const float seam = (float)(-(2.0 * kPiD / dd) * g.lt);

  if (tid == 0) {
    for (int st = 0; st < g.stages; ++st) {
      mbar_init(s.full + st, 1);
      mbar_init(s.empty + st, kMmaWarps);
    }
    mbar_init_fence();
  }
  // zero the product operands (pads and idle chain columns stay finite)
  for (int k = tid; k < C * g.bs; k += nt) s.BUF[k] = 0.0f;
  for (int k = tid; k < 2 * C * g.hs; k += nt) s.HID1[k] = 0.0f;
  for (int k = tid; k < 2 * C; k += nt) s.TAU[k] = 0.0f;
  // the accepted state, in device memory: each thread reads and writes
  // only its own (chain, site) pairs o = tid (mod nt) of it
  const size_t base = (size_t)b0 * d;
  float* X0 = x0g + base;
  float* X1 = x1g + base;
  float* SP = spcp + base;
  float* CP = spcp + (size_t)B * d + base;
  __syncthreads();

  float pot[C], chg[C];
  plaq_fields<C>(X0, X1, SP, CP, s, g, nc, pot, chg);

  for (int n = 0; n < g.N; ++n) {
    float ldp[C];
#pragma unroll
    for (int c = 0; c < C; ++c) ldp[c] = 0.0f;
    for (int o = tid; o < nc * d; o += nt) {
      const int c = o / d, i = o - c * d;
      const float2 v = initial_momenta(rnd.v0s, rnd.v1s, g.seed, b0 + c, B,
                                       n, g.N, d, i);
      s.W0[o] = v.x;
      s.W1[o] = v.y;
      s.Y0[o] = X0[o];
      s.Y1[o] = X1[o];
      s.SP1[o] = SP[o];
      s.CP1[o] = CP[o];
    }
    if (tid < nc) {
      const long long chain = b0 + tid;
      const size_t o = (size_t)n * B + chain;
      float* sc = s.SC + 4 * tid;
      if (injected) {
        sc[0] = rnd.ds[o];
        sc[1] = rnd.us[o];
        if (g.hop) {
          sc[2] = rnd.nus[o];
          sc[3] = rnd.uhs[o];
        }
      } else {
        curandStatePhilox4_32_10_t st;
        philox_at(&st, g.seed, chain, n, g.N, 8ull * d);
        sc[0] = sign_from_uniform(curand_uniform(&st));
        sc[1] = curand_uniform(&st);
        sc[2] = sign_from_uniform(curand_uniform(&st));
        sc[3] = curand_uniform(&st);
      }
    }
    __syncthreads();

    float pot1[C], chg1[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      pot1[c] = pot[c];
      chg1[c] = chg[c];
    }
#pragma unroll 1
    for (int step = 0; step < K; ++step) {
      const bool first = step == 0;
      kick<WT, ABLATE, C, RPW>(W, s, g, nc, pos, first ? 0.5f : 1.0f,
                               first ? 0.0f : step - 0.5f,
                               first ? (float)(K - 1) : K - 0.5f - step, ldp);
#pragma unroll 1
      for (int half = 0; half < 2; ++half)
        xhalf<WT, ABLATE, C, RPW>(W, s, g, nc, pos, step, half == 1,
                                  ldp);
      plaq_fields<C>(s.Y0, s.Y1, s.SP1, s.CP1, s, g, nc, pot1, chg1);
    }
    // closing half kick at trajectory time K-1 (fwd) / 0 (bwd)
    kick<WT, ABLATE, C, RPW>(W, s, g, nc, pos, 0.5f, (float)(K - 1), 0.0f,
                             ldp);

    // energy change from per-site differences (no float32 cancellation of
    // the two ~1e3 Hamiltonians), log-det and finiteness, one reduction
    float e[4 * C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      e[c] = 0.0f;
      e[C + c] = 0.0f;
      e[2 * C + c] = ldp[c];
      e[3 * C + c] = 0.0f;
    }
    for (int o = tid; o < nc * d; o += nt) {
      const int c = o / d, i = o - c * d;
      const float2 v = initial_momenta(rnd.v0s, rnd.v1s, g.seed, b0 + c, B,
                                       n, g.N, d, i);
      add_at<4 * C>(e, c, kinetic_diff(v, s.W0[o], s.W1[o]));
      add_at<4 * C>(e, C + c, s.CP1[o] - CP[o]);
      add_at<4 * C>(e, 3 * C + c, fabsf(s.Y0[o]) + fabsf(s.Y1[o]) +
                                      fabsf(s.W0[o]) + fabsf(s.W1[o]));
    }
    block_sum<4 * C>(e, s.scratch, s.red);

    float prob[C], accf[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float dh = g.beta * e[C + c] + 0.5f * e[c] + e[2 * C + c];
      float p = expf(dh > 0.0f ? 0.0f : dh);  // NaN stays NaN -> rejected
      if (!isfinite(p) || !isfinite(e[3 * C + c])) p = 0.0f;
      prob[c] = p;
      const bool acc = c < nc && s.SC[c * 4 + 1] < p;
      accf[c] = acc ? 1.0f : 0.0f;
      if (acc) {
        pot[c] = pot1[c];
        chg[c] = chg1[c];
      }
    }
    for (int o = tid; o < nc * d; o += nt) {
      if (pick<C>(accf, o / d) == 0.0f) continue;
      X0[o] = s.Y0[o];
      X1[o] = s.Y1[o];
      SP[o] = s.SP1[o];
      CP[o] = s.CP1[o];
    }

    if (g.hop) {
      // each thread reads only its own sites of the accepted fields here
      float hv[2 * C];
#pragma unroll
      for (int k = 0; k < 2 * C; ++k) hv[k] = 0.0f;
      for (int o = tid; o < nc * d; o += nt) {
        const int c = o / d;
        const float nu = s.SC[c * 4 + 2];
        add_at<2 * C>(hv, c, SP[o]);
        add_at<2 * C>(hv, C + c,
                      (CP[o] < -cd && nu * SP[o] >= 0.0f) ? 1.0f : 0.0f);
      }
      block_sum<2 * C>(hv, s.scratch, s.red);
      float ahs[C], ans[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float nu = s.SC[c * 4 + 2], uh = s.SC[c * 4 + 3];
        const float ds = one_minus_cd * ((float)d - pot[c]) + nu * sd * hv[c];
        const float m = -g.beta * ds;
        float ph = expf(m > 0.0f ? 0.0f : m);
        if (!isfinite(ph)) ph = 0.0f;
        ahs[c] = (uh < ph) ? 1.0f : 0.0f;
        ans[c] = ahs[c] * nu;
        if (c < nc) {
          pot[c] = pot[c] + ahs[c] * ds;
          chg[c] = chg[c] + ans[c] * (1.0f - hv[C + c]);
        }
      }
      for (int o = tid; o < nc * d; o += nt) {
        const int c = o / d, i = o - c * d;
        const float ah = pick<C>(ahs, c), an = pick<C>(ans, c);
        const float cda = 1.0f + ah * cd_minus_one;
        const float sda = an * sd;
        float w0, w1;
        winding(i, g.lt, g.lx, delta, seam, &w0, &w1);
        X0[o] = wrap_angle(X0[o] + an * w0);
        X1[o] = wrap_angle(X1[o] + an * w1);
        hop_rotate(SP + o, CP + o, cda, sda);
      }
    }

    if (tid == 0) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (c >= nc) break;
        const size_t o = (size_t)n * B + b0 + c;
        plaq_tr[o] = 1.0f - pot[c] / (float)d;
        chg_tr[o] = chg[c];
        prob_tr[o] = prob[c];
      }
    }
    __syncthreads();  // fields and scalars settled before the next transition
  }

}

}  // namespace

// Shared memory of one block (the carve above).
extern "C" size_t l2hmc_chain_smem_bytes(int c, int d, int bs, int hs,
                                         int stages, int mt) {
  return sizeof(float) *
         ((size_t)stages * kChunkFloats + 4 * kMaxStages +
          6 * (size_t)c * d + (size_t)c * bs + 2 * (size_t)c * hs +
          red_rows(mt) * 128 + kWarps * 4 * (size_t)c + 4 * c + 4 * c +
          2 * c);
}

// The chains-per-block cap of this build.
extern "C" int l2hmc_chain_max_chains() { return L2HMC_CHAIN_MAX_C; }

namespace {

template <class WT, bool ABLATE, int C, int RPW>
int launch(const void* const* p, float* x0, float* x1, float* spcp,
           const L2Rand& rnd, float* plaq, float* chg, float* prob,
           const Geo& g, cudaStream_t stream) {
  auto net = [&](int o) {
    return NetW<WT>{static_cast<const WT*>(p[o]),
                    static_cast<const float*>(p[o + 1]),
                    static_cast<const float*>(p[o + 2]),
                    static_cast<const float*>(p[o + 3]),
                    static_cast<const float*>(p[o + 4]),
                    static_cast<const float*>(p[o + 5]),
                    static_cast<const float*>(p[o + 6]),
                    static_cast<const float*>(p[o + 7]),
                    static_cast<const float*>(p[o + 8]),
                    static_cast<const float*>(p[o + 9])};
  };
  const Weights<WT> W{net(0), net(10), static_cast<const float*>(p[20]),
                      static_cast<const float*>(p[21])};
  const size_t smem =
      l2hmc_chain_smem_bytes(C, g.d, g.bs, g.hs, g.stages, g.mt);
  auto kernel = l2hmc_chain_kernel<WT, ABLATE, C, RPW>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(g.B + C - 1) / C, kThreads, smem, stream>>>(x0, x1, spcp, W, rnd,
                                                       plaq, chg, prob, g);
  return (int)cudaGetLastError();
}

template <int C>
int launch_c(const void* const* p, float* x0, float* x1, float* spcp,
             const L2Rand& rnd,
             float* plaq, float* chg, float* prob, const Geo& g, int bf16,
             int ablate, cudaStream_t st) {
  // the ablated kernel runs no products: one instantiation for every hp
  if (ablate)
    return launch<float, true, C, 1>(p, x0, x1, spcp, rnd, plaq, chg, prob,
                                     g, st);
  if (g.mt > kMmaWarps)
    return bf16 ? launch<__nv_bfloat16, false, C, 2>(p, x0, x1, spcp, rnd,
                                                     plaq, chg, prob, g, st)
                : launch<float, false, C, 2>(p, x0, x1, spcp, rnd, plaq, chg,
                                             prob, g, st);
  return bf16 ? launch<__nv_bfloat16, false, C, 1>(p, x0, x1, spcp, rnd, plaq,
                                                   chg, prob, g, st)
              : launch<float, false, C, 1>(p, x0, x1, spcp, rnd, plaq, chg,
                                           prob, g, st);
}

}  // namespace

// wptrs: 22 device pointers in the order of ops/l2hmc_kernel.py
// MMA_WEIGHT_NAMES: per net the packed matmul chunks (bfloat16 when
// bf16 != 0, else float32) and nine float32 vectors, then the two masks.
// ablate != 0 runs the ablated kernel, which reads only the masks.  c is
// the chains per block (2, 4 or 8); hp ... stages the product layout of
// ops/l2hmc_kernel.py mma_geometry.
extern "C" int l2hmc_chain_launch(
    float* x0, float* x1, float* spcp, const void* wptrs, const float* v0s,
    const float* v1s, const float* ds, const float* us, const float* nus,
    const float* uhs, float* plaq, float* chg, float* prob, int B, int lt,
    int lx, int K, int N, int h, float eps, float beta, int bounded_q,
    int hop, int bf16, int ablate, unsigned long long seed, int c, int hp,
    int mt, int n_in, int n_tr, int n_hd, int kq, int bs, int hs, int stages,
    int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  if (B <= 0 || N <= 0) return 0;
  if (stages < 2 || stages > kMaxStages || mt < 2 || mt > 2 * kMmaWarps ||
      kWarps % mt != 0 || c > L2HMC_CHAIN_MAX_C)
    return (int)cudaErrorInvalidValue;
  const void* const* p = static_cast<const void* const*>(wptrs);
  const L2Rand rnd{v0s, v1s, ds, us, nus, uhs};
  const Geo g{B,    lt,   lx,   lt * lx, K,  N,  h,  bounded_q, hop,
              eps,  beta, 0.0f, seed,    hp, mt, n_in, n_tr,   n_hd,
              kq,   bs,   hs,   stages};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (c) {
    case 2:
      return launch_c<2>(p, x0, x1, spcp, rnd, plaq, chg, prob, g, bf16, ablate,
                         st);
    case 4:
      return launch_c<4>(p, x0, x1, spcp, rnd, plaq, chg, prob, g, bf16, ablate,
                         st);
    case 8:
      return launch_c<8>(p, x0, x1, spcp, rnd, plaq, chg, prob, g, bf16, ablate,
                         st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

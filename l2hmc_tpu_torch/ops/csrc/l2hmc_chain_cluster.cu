// Fused TRAINED L2HMC chain, cluster route: the kernel of l2hmc_chain.cu
// with each chain's lattice split over a thread-block cluster.
//
// What it changes.  l2hmc_chain.cu runs C <= 8 chains per block over the
// whole lattice, and each block streams its net's whole packed weights
// (49 chunks of 16 KB per MLP call at 16x16, h=64) for those 8 chains.
// Here a cluster of CL CTAs (CL = 2 or 4, one CTA per SM) runs CC chains
// (8, 16 or 32), and CTA r of the cluster owns the slab of rows
// [r lt/CL, (r+1) lt/CL) of all CC chains: the (chain, site) work and the
// shared bytes of a block of the other route (16x16: 4 CTAs of 32 chains x
// 64 sites, or 2 of 16 x 128).  The slab's features are only its own
// columns of the in-projection, and its outputs only its own rows of the
// heads, so each CTA streams its slab's 1/CL of those two products (the
// wrapper packs them per slab, ops/l2hmc_kernel.py mma_weights) plus the
// trunk: 13 or 25 chunks per call instead of 49, each A fragment split
// once and fed to CC / 8 mma n-tiles with independent accumulators.  An
// H100 runs 30 clusters of 4 at once, so ops/l2hmc_kernel.py
// chain_route_plan runs 2048 chains of 16x16 as 128 clusters of 2 (two
// waves, as the other route's 256 blocks).  Per CTA the time follows the
// (chain, site) pairs it holds more than the chunks it walks (PERF.md):
// builds without the products were 21% faster, with fewer ring stages no
// slower; weights packed already split into TF32 hi and lo (twice the
// chunks) were 14% slower, and products on all 16 warps (half the n-tiles
// each) 6% slower at 16 chains per CTA.
//
// Where the CTAs meet, through distributed shared memory (DSMEM) and
// cluster barriers:
// - the in-projection's (hp x CC) partial sums: CTA r owns hidden units
//   [r hp / CL, (r + 1) hp / CL); the product warps store their partials
//   into the owners' shared memory, each owner sums its units over the CTAs
//   in rank order and stores the activations into every CTA's HID1, two
//   cluster barriers apart (slab_mlp), so every CTA holds the same hidden
//   activations and runs the trunk alike.  Only stores cross the cluster
//   there: every CTA reading every partial cost 9% of the kernel (PERF.md);
// - the stencil's halos: the force's t-1 row (grad1) from the previous CTA's
//   sine field SP1 and the plaquette's t+1 row from the next CTA's Y1, read
//   in place after a cluster barrier;
// - the per-chain sums (potential, charge, energy change, log-det,
//   finiteness, the hop's): each CTA sums its slab per chain in a fixed
//   order, then all CTAs' partials in rank order.
// Every decision per chain (direction, accept, hop) is therefore the same in
// each CTA of the cluster.  A thread-block cluster that multicast each
// chunk to 2 or 4 blocks of 8 whole-lattice chains ran 2.2x and 4.8x slower
// (PERF.md): it tied every chunk's slot to all blocks; here no chunk is
// shared, each CTA streams its own at its own pace.
//
// Randomness and arithmetic are l2hmc_chain.cu's: Philox keyed by (seed,
// chain x N + n), momenta at offset 8 i of the site's global index, the
// per-chain scalars at offset 8 d (drawn alike in every CTA); 3xTF32 for
// float32, one m16n8k16 pass for bf16.  The per-site log-det is kept per
// site over the transition and summed with the energy change.  Only hidden
// widths up to 128 (one tile row per product warp) and the full conditioner
// run here; the ablated mode, wider nets and lattices whose rows do not
// split run l2hmc_chain.cu.  The kernel keeps that kernel's name, since
// both are routes of one kernel: l2hmc_chain_kernel.

#include "l2hmc_mma.cuh"

namespace {

constexpr int kMaxCluster = 4;
// Threads that sum the in-projection's partials: all but the producer warp.
constexpr int kSumThreads = kThreads - 32;

// Geometry of one launch: the lattice, and the product layout of one slab
// (ops/l2hmc_kernel.py mma_geometry at dl sites).
struct SlabGeo {
  int B, lt, lx, d, K, N, bounded_q, hop;
  float eps, beta;
  unsigned long long seed;
  int cl, dl;  // CTAs per cluster; sites of a slab (d / cl, whole rows)
  int hp, mt, n_in, n_tr, n_hd, kq, bs, hs, stages;
};

// Per-chain scalars of the cluster, the same in each CTA: CH[k * CC + c]
// with k = 0 potential, 1 charge (accepted state), 2, 3 the proposal's, 4
// accept probability, 5 accepted, 6 hop accepted, 7 its winding sign.
enum { kPot, kChg, kPot1, kChg1, kProb, kAcc, kHopAcc, kHopNu, kChainVals };

struct SlabSmem {
  float* ring;                       // stages x 16 KB weight chunks (first)
  unsigned long long *full, *empty;  // one mbarrier pair per stage
  float *Y0, *Y1, *W0, *W1, *SP1, *CP1;  // (CC, dl): proposal, momenta
  float* LD;             // (CC, dl): log-det per site over the transition
  float* BUF;            // (CC, bs): features in, head outputs out, sums
  float *HID1, *HID2;    // (CC, hs)
  float* XCH;            // (cl, wp, hp / cl, CC + 4): pushed partials
  float* LOC;            // 8 slots of (16, CC + 4): the trunk's partials
  float* PART;           // 2 x (4, CC): this CTA's per-chain sums
  float* TOT;            // (4, CC): the cluster's per-chain sums
  float* CH;             // (kChainVals, CC)
  float *SC, *TAU;       // (CC, 4) as l2hmc_chain.cu's, (CC, 2)
  float* EC;             // (2 nets, 4, dl): exp of the slab's cs0 cs1 ct0 ct1
};

// A row of the products' partials: CC chains and 4 more words against bank
// conflicts; a buffer: 16 rows per product warp (its tile row's partials,
// or those of hp / cl hidden units from each CTA and k-group).
template <int CC>
__host__ __device__ constexpr int xch_stride() {
  return CC + 4;
}
template <int CC>
__host__ __device__ constexpr int xch_floats() {
  return kMmaWarps * 16 * xch_stride<CC>();
}

template <int CC>
__device__ __forceinline__ SlabSmem carve(float* smem, const SlabGeo& g) {
  SlabSmem s;
  s.ring = smem;
  s.full = reinterpret_cast<unsigned long long*>(
      smem + (size_t)g.stages * kChunkFloats);
  s.empty = s.full + kMaxStages;
  float* p = smem + (size_t)g.stages * kChunkFloats + 4 * kMaxStages;
  const size_t cd = (size_t)CC * g.dl;
  s.Y0 = p;
  s.Y1 = s.Y0 + cd;
  s.W0 = s.Y1 + cd;
  s.W1 = s.W0 + cd;
  s.SP1 = s.W1 + cd;
  s.CP1 = s.SP1 + cd;
  s.LD = s.CP1 + cd;
  s.BUF = s.LD + cd;
  s.HID1 = s.BUF + (size_t)CC * g.bs;
  s.HID2 = s.HID1 + CC * g.hs;
  s.XCH = s.HID2 + CC * g.hs;
  s.LOC = s.XCH + xch_floats<CC>();
  s.PART = s.LOC + xch_floats<CC>();
  s.TOT = s.PART + 8 * CC;
  s.CH = s.TOT + 4 * CC;
  s.SC = s.CH + kChainVals * CC;
  s.TAU = s.SC + 4 * CC;
  s.EC = s.TAU + 2 * CC;
  return s;
}

// ---------------------------------------------------------------------------
// The cluster: ranks, DSMEM and barriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// The shared::cluster address of `p` (this CTA's shared memory) in the CTA
// of the cluster with rank `rank`.
__device__ __forceinline__ unsigned cluster_addr(const void* p,
                                                 unsigned rank) {
  unsigned a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(a)
               : "r"(smem_addr(p)), "r"(rank));
  return a;
}

__device__ __forceinline__ float ld_cluster(unsigned a) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(v) : "r"(a)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_cluster(unsigned a, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(a), "f"(v)
               : "memory");
}

// Every thread of every CTA of the cluster arrives (release) and waits
// (acquire): the writes before the barrier, shared or DSMEM, are visible
// to every CTA after it.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// The warps that sum the in-projection's partials (named barrier 2).
__device__ __forceinline__ void sum_warps_sync() {
  asm volatile("barrier.sync 2, %0;" ::"n"(kSumThreads) : "memory");
}

// A CTA's place in its cluster, and the neighbours' fields its stencil reads.
struct Slab {
  int rank, site0;    // rank in the cluster; the slab's first global site
  unsigned sp1_prev;  // the previous CTA's SP1 (its last row: our t-1 halo)
  unsigned y1_next;   // the next CTA's Y1 (its first row: our t+1 halo)
};

// Wilson force component 1 at slab site i: -sinP + sinP(t-1, s), the row
// before the slab read from the previous CTA.  grad0 stays in the row.
__device__ __forceinline__ float grad1_slab(const float* sp, unsigned prev,
                                            int i, int dl, int lx) {
  const int t = i / lx;
  const float below =
      t > 0 ? sp[i - lx] : ld_cluster(prev + 4u * (unsigned)(dl - lx + i));
  return -sp[i] + below;
}

// Plaquette angle at slab site i, the row after the slab read from the next
// CTA (plaq_angle's order of operations).
__device__ __forceinline__ float plaq_slab(const float* y0, const float* y1,
                                           unsigned next, int i, int dl,
                                           int lx) {
  const int t = i / lx, s = i - t * lx;
  const float up =
      i + lx < dl ? y1[i + lx] : ld_cluster(next + 4u * (unsigned)s);
  return y0[i] - y1[i] - y0[t * lx + (s + 1 == lx ? 0 : s + 1)] + up;
}

// Per-chain sums over the cluster of NV (CC, dl) arrays staged in BUF (array
// v of chain c at BUF[c * bs + v * dl], inside the feature columns that
// every MLP call rewrites) into TOT[v * CC + c], for the nc chains.  Each
// warp sums whole (v, c) rows in a fixed order; then every CTA adds the
// CTAs' partials in rank order.  Consecutive sums alternate PART buffers: a
// buffer is rewritten only after a later cluster barrier, which each CTA
// passes after its reads.
template <int CC, int NV>
__device__ void chain_sums(const SlabSmem& s, const SlabGeo& g, int nc,
                           unsigned& sums) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* part = s.PART + (sums & 1u) * 4 * CC;
  __syncthreads();
  for (int p = warp; p < NV * nc; p += kWarps) {
    const int v = p / nc, c = p - v * nc;
    const float* x = s.BUF + (size_t)c * g.bs + v * g.dl;
    float a = 0.0f;
    for (int i = lane; i < g.dl; i += 32) a += x[i];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
    if (lane == 0) part[v * CC + c] = a;
  }
  cluster_sync();
  if (tid < NV * nc) {
    const int v = tid / nc, c = tid - v * nc;
    float x[kMaxCluster];
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      if (q < g.cl) x[q] = ld_cluster(cluster_addr(part + v * CC + c, q));
    float a = 0.0f;
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      if (q < g.cl) a += x[q];
    s.TOT[v * CC + c] = a;
  }
  __syncthreads();
  ++sums;
}

// ---------------------------------------------------------------------------
// Products: each A fragment split once, fed to CC / 8 n-tiles
// ---------------------------------------------------------------------------

// Accumulate one tile product into acc[nt] for each n-tile nt: a (this
// lane's A fragment) times feat^T[k0 .. k0 + kstep) of chains nt * 8 ..
// nt * 8 + 7, rows of `bsrc` (stride `bst`, = 4 mod 32 words).
template <class WT, int NT>
__device__ __forceinline__ void tile_mma_n(const float4& a, const float* bsrc,
                                           int bst, int k0,
                                           Acc<WT> (&acc)[NT], int q) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const float* brow = bsrc + gq * bst + k0;
  if constexpr (sizeof(WT) == 4) {
    unsigned ah[4], al[4];
    split_tf32(a.x, ah[0], al[0]);
    split_tf32(a.y, ah[1], al[1]);
    split_tf32(a.z, ah[2], al[2]);
    split_tf32(a.w, ah[3], al[3]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float* b = brow + nt * 8 * bst;
      unsigned bh0, bl0, bh1, bl1;
      split_tf32(b[tq], bh0, bl0);
      split_tf32(b[tq + 4], bh1, bl1);
      mma_tf32(acc[nt].small, al, bh0, bh1);
      mma_tf32(acc[nt].small, ah, bl0, bl1);
      mma_tf32(acc[nt].big[0], ah, bh0, bh1);
    }
  } else {
    const unsigned av[4] = {__float_as_uint(a.x), __float_as_uint(a.y),
                            __float_as_uint(a.z), __float_as_uint(a.w)};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float* b = brow + nt * 8 * bst;
      mma_bf16(acc[nt].big[q % Acc<WT>::kChains], av,
               pack_bf16(b[2 * tq], b[2 * tq + 1]),
               pack_bf16(b[2 * tq + 8], b[2 * tq + 9]));
    }
  }
}

// A narrow product out^T (hp x CC) = A (hp x kp) * B^T over `nch` chunks
// from chunk `j0` of the stream, B rows in `bsrc` (stride `bst`), into
// `acc`; product warps only, hp <= 128.  Warp w's tiles lie in tile row
// w % mt and k-group w / mt, as in l2hmc_chain.cu: lane (gq, tq) holds
// acc[nt].sum(e) of row 16 (w % mt) + gq + 8 (e / 2), chain nt 8 + 2 tq +
// e % 2.
template <class WT, int NT>
__device__ __forceinline__ void narrow_n(const Stream& str,
                                         const SlabSmem& s, const SlabGeo& g,
                                         int j0, int nch, const float* bsrc,
                                         int bst, Acc<WT> (&acc)[NT]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kg = warp / g.mt, wp = kMmaWarps / g.mt;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) acc[nt].zero();
  for (int j = 0; j < nch; ++j) {
    const float* chunk = str.next(s, g, j0 + j);
    const float4* tiles =
        reinterpret_cast<const float4*>(chunk) + (warp * 4) * 32 + lane;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int ks = (j * wp + kg) * 4 + q;
      tile_mma_n<WT, NT>(tiles[q * 32], bsrc, bst, ks * kKstep<WT>, acc, q);
    }
    str.release(s, g, j0 + j);
  }
}

// One MLP conditioner call on the CC feature rows of the slab in BUF; the
// slab's head outputs [S0 | T0 | Q0 | S1 | T1 | Q1] (dl columns each, bias
// added) overwrite BUF's first 6 dl columns.
//
// The in-projection's partials meet over the cluster: CTA r owns hidden
// units [r hp / cl, (r + 1) hp / cl).  Each product warp stores its
// partials into the owners' XCH (slot of its rank and k-group); after a
// cluster barrier each CTA sums its own units' partials in rank order,
// applies the time rows, bias and ReLU, and stores the results into every
// CTA's HID1; after a second barrier every CTA holds the same HID1 and
// runs the trunk alike (its partials in LOC), then its slab's heads.  Only
// stores cross the cluster.  A CTA stores into another's XCH only after
// the second barrier of the previous call, which the owner passes after
// summing it, and into another's HID1 only after the first barrier, which
// the owner passes after its trunk read it.  The producer requests the
// in-projection's chunks and as many more as the ring holds, meets the
// first barrier, arrives at the second, then streams the rest.
template <class WT, int CC>
__device__ void slab_mlp(const NetW<WT>& w, const Stream& str,
                         const SlabSmem& s, const SlabGeo& g,
                         const Slab& sl) {
  constexpr int NT = CC / 8, RS = xch_stride<CC>();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int mt = g.mt, wp = kMmaWarps / mt, hp = g.hp;
  const int own = hp / g.cl;  // hidden units per CTA
  if (warp == kProducer) {
    const int pre = prefetch_chunks(g, str.nch);
    const int a = max(pre, g.n_in);
    const int b = max(a, min(g.n_in + g.stages, str.nch));
    if (lane == 0) {
      str.produce(s, g, pre, g.n_in);
      str.produce(s, g, a, b);
    }
    __syncwarp();
    cluster_sync();
    cluster_arrive();
    if (lane == 0) str.produce(s, g, b, str.nch);
    __syncwarp();
    cluster_wait();
  } else {
    if (warp < kMmaWarps) {
      // in-projection (hp x 6 dl) . feat^T of the slab, to the owners
      Acc<WT> acc[NT];
      narrow_n<WT, NT>(str, s, g, 0, g.n_in, s.BUF, g.bs, acc);
      const int kg = warp / mt;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = (warp % mt) * 16 + gq + (e >> 1) * 8;
        const int owner = j / own;
        const float* slot =
            s.XCH + ((sl.rank * wp + kg) * own + j - owner * own) * RS;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          st_cluster(cluster_addr(slot + nt * 8 + 2 * tq + (e & 1), owner),
                     acc[nt].sum(e));
      }
    }
    cluster_sync();
    // this CTA's hidden units, from every CTA's partials in rank order
    const int u = warp < kProducer ? tid : tid - 32;
    for (int o = u; o < own * CC; o += kSumThreads) {
      const int jl = o / CC, c = o - jl * CC, j = sl.rank * own + jl;
      float acc = 0.0f;
      for (int q = 0; q < g.cl; ++q)
        for (int kg = 0; kg < wp; ++kg)
          acc += s.XCH[((q * wp + kg) * own + jl) * RS + c];
      const float tt =
          s.TAU[2 * c] * w.t[j] + s.TAU[2 * c + 1] * w.t[hp + j];
      const float v = act<WT>(fmaxf(acc + tt + w.b[j], 0.0f));
      for (int q = 0; q < g.cl; ++q)
        st_cluster(cluster_addr(s.HID1 + c * g.hs + j, q), v);
    }
    cluster_sync();
    if (warp < kMmaWarps) {
      // trunk (hp x hp) . hid1^T, the same in every CTA
      {
        Acc<WT> acc[NT];
        narrow_n<WT, NT>(str, s, g, g.n_in, g.n_tr, s.HID1, g.hs, acc);
        float* r = s.LOC + warp * 16 * RS;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int c = nt * 8 + 2 * tq;
          r[gq * RS + c] = acc[nt].sum(0);
          r[gq * RS + c + 1] = acc[nt].sum(1);
          r[(gq + 8) * RS + c] = acc[nt].sum(2);
          r[(gq + 8) * RS + c + 1] = acc[nt].sum(3);
        }
      }
      mma_warps_sync();
      for (int o = tid; o < CC * hp; o += kMmaWarps * 32) {
        const int j = o / CC, c = o - j * CC;
        const float* r = s.LOC + j * RS + c;
        float acc = 0.0f;
        for (int kg = 0; kg < wp; ++kg) acc += r[kg * mt * 16 * RS];
        s.HID2[c * g.hs + j] = act<WT>(fmaxf(acc + w.hb[j], 0.0f));
      }
      mma_warps_sync();
      // the slab's rows of the merged heads (6 dl x hp) . hid2^T: each warp
      // owns one 16-row output tile per group of 8, over g.kq chunks
      const int dl = g.dl;
      const int j0 = g.n_in + g.n_tr;
      Acc<WT> acc[NT];
      float hb[2];
      for (int j = 0; j < g.n_hd; ++j) {
        const int grp = j / g.kq, kq = j - grp * g.kq;
        const int m0 = (grp * kMmaWarps + warp) * 16 + gq;
        if (kq == 0) {
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) acc[nt].zero();
          // the group's head biases, read while its products run: row n
          // of the slab is site n % dl of block n / dl of [S T Q] x 2
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int n = m0 + h * 8, blk = n / dl;
            hb[h] = n < 6 * dl ? (blk < 3 ? w.headb0 : w.headb1)
                                     [(blk % 3) * g.d + sl.site0 + n -
                                      blk * dl]
                               : 0.0f;
          }
        }
        const float* chunk = str.next(s, g, j0 + j);
        const float4* tiles =
            reinterpret_cast<const float4*>(chunk) + (warp * 4) * 32 + lane;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          tile_mma_n<WT, NT>(tiles[q * 32], s.HID2, g.hs,
                             (kq * 4 + q) * kKstep<WT>, acc, q);
        str.release(s, g, j0 + j);
        if (kq == g.kq - 1) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int n = m0 + (e >> 1) * 8;
            if (n >= 6 * dl) continue;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              const int c = nt * 8 + 2 * tq + (e & 1);
              s.BUF[c * g.bs + n] = acc[nt].sum(e) + hb[e >> 1];
            }
          }
        }
      }
    }
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// The transition on a slab (l2hmc_chain.cu's, over the slab's sites)
// ---------------------------------------------------------------------------

// The chunk stream of one MLP call of `net`: this CTA's slab's chunks.
template <class WT>
__device__ __forceinline__ Stream slab_stream(const NetW<WT>& net,
                                              const SlabGeo& g, const Slab& sl,
                                              unsigned pos) {
  const int nch = g.n_in + g.n_tr + g.n_hd;
  return Stream{reinterpret_cast<const char*>(net.mm) +
                    (size_t)sl.rank * nch * kChunkBytes,
                nch, pos};
}

// Merged momentum kick (update_v), direction-fused.
template <class WT, int CC>
__device__ void slab_kick(const Weights<WT>& W, const SlabSmem& s,
                          const SlabGeo& g, const Slab& sl, int nc,
                          unsigned& pos, float factor,
                          float t_fwd, float t_bwd) {
  const int tid = threadIdx.x, nt = blockDim.x, dl = g.dl, lx = g.lx;
  const Stream str = slab_stream(W.v, g, sl, pos);
  if (tid == kProducer * 32) str.produce(s, g, 0, prefetch_chunks(g, str.nch));
  for (int o = tid; o < nc * dl; o += nt) {
    const int c = o / dl, i = o - c * dl;
    const float* sp = s.SP1 + c * dl;
    float* f = s.BUF + c * g.bs;
    float s0, c0, s1, c1;
    sincosf(s.Y0[o], &s0, &c0);
    sincosf(s.Y1[o], &s1, &c1);
    f[i] = act<WT>(c0);
    f[dl + i] = act<WT>(c1);
    f[2 * dl + i] = act<WT>(s0);
    f[3 * dl + i] = act<WT>(s1);
    f[4 * dl + i] = act<WT>(g.beta * grad0(sp, i, g.lt, lx));
    f[5 * dl + i] = act<WT>(
        g.beta * grad1_slab(sp, sl.sp1_prev + 4u * (unsigned)(c * dl), i, dl,
                            lx));
  }
  if (tid < nc)
    time_enc(s.SC[tid * 4] > 0.0f ? t_fwd : t_bwd, g.K, s.TAU + 2 * tid);
  __syncthreads();
  slab_mlp<WT, CC>(W.v, str, s, g, sl);
  pos += str.nch;

  const float fe = factor * g.eps;
  for (int o = tid; o < nc * dl; o += nt) {
    const int c = o / dl, i = o - c * dl, gi = sl.site0 + i;
    const float dsg = s.SC[c * 4];
    const float* sp = s.SP1 + c * dl;
    float ld = 0.0f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float* hd = s.BUF + c * g.bs + r * 3 * dl;
      const float* ec = s.EC + (0 * 4 + r) * dl;  // exp(cs_r), exp(ct_r)
      const float sv = tanhf(hd[i]) * ec[i];
      const float tv = hd[dl + i];
      const float qr = hd[2 * dl + i];
      const float qv = (g.bounded_q ? tanhf(qr) : qr) * ec[2 * dl + i];
      const float gg =
          g.beta * (r ? grad1_slab(sp, sl.sp1_prev + 4u * (unsigned)(c * dl),
                                   i, dl, lx)
                      : grad0(sp, i, g.lt, lx));
      // rounded op by op as l2hmc_chain.cu's kick()
      const float hs = fe * sv;
      const float a = __fmul_rn(
          fe, __fsub_rn(__fmul_rn(expf(__fmul_rn(g.eps, qv)), gg), tv));
      const float e = expf(dsg * hs);
      float* w = (r ? s.W1 : s.W0) + o;
      *w = dsg > 0.0f ? *w * e - a : (*w + a) * e;
      ld += dsg * hs;
    }
    s.LD[o] += ld;
  }
  __syncthreads();
}

// One masked position half-update on the torus (update_x, u1 branch).
template <class WT, int CC>
__device__ void slab_xhalf(const Weights<WT>& W, const SlabSmem& s,
                           const SlabGeo& g, const Slab& sl, int nc,
                           unsigned& pos, int step,
                           bool second) {
  const int tid = threadIdx.x, nt = blockDim.x, d = g.d, dl = g.dl, K = g.K;
  const float* mf0 = W.mask0 + (size_t)step * d + sl.site0;
  const float* mf1 = W.mask1 + (size_t)step * d + sl.site0;
  const float* mb0 = W.mask0 + (size_t)(K - 1 - step) * d + sl.site0;
  const float* mb1 = W.mask1 + (size_t)(K - 1 - step) * d + sl.site0;
  const Stream str = slab_stream(W.x, g, sl, pos);
  if (tid == kProducer * 32) str.produce(s, g, 0, prefetch_chunks(g, str.nch));
  for (int o = tid; o < nc * dl; o += nt) {
    const int c = o / dl, i = o - c * dl;
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
    f[dl + i] = act<WT>(s.W1[o]);
    f[2 * dl + i] = act<WT>(h0 * c0);
    f[3 * dl + i] = act<WT>(h1 * c1);
    f[4 * dl + i] = act<WT>(h0 * s0);
    f[5 * dl + i] = act<WT>(h1 * s1);
  }
  if (tid < nc)
    time_enc(s.SC[tid * 4] > 0.0f ? (float)step : (float)(K - 1 - step), K,
             s.TAU + 2 * tid);
  __syncthreads();
  slab_mlp<WT, CC>(W.x, str, s, g, sl);
  pos += str.nch;

  for (int o = tid; o < nc * dl; o += nt) {
    const int c = o / dl, i = o - c * dl, gi = sl.site0 + i;
    const float dsg = s.SC[c * 4];
    const bool fwd = dsg > 0.0f;
    float ld = 0.0f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float* mf = r ? mf1 : mf0;
      const float* mb = r ? mb1 : mb0;
      float hold = fwd ? mf[i] : 1.0f - mb[i];
      if (second) hold = 1.0f - hold;
      const float* hd = s.BUF + c * g.bs + r * 3 * dl;
      const float* ec = s.EC + (1 * 4 + r) * dl;  // exp(cs_r), exp(ct_r)
      const float sv = tanhf(hd[i]) * ec[i];
      const float tv = hd[dl + i];
      const float qr = hd[2 * dl + i];
      const float qv = (g.bounded_q ? tanhf(qr) : qr) * ec[2 * dl + i];
      float* yp = (r ? s.Y1 : s.Y0) + o;
      const float w = (r ? s.W1 : s.W0)[o];
      const float y = *yp;
      // rounded op by op as l2hmc_chain.cu's xhalf()
      const float es = __fmul_rn(g.eps, sv);
      const float bb = __fmul_rn(
          g.eps, __fadd_rn(__fmul_rn(expf(__fmul_rn(g.eps, qv)), w), tv));
      const float u_in = fwd ? y : wrap_angle(__fsub_rn(y, bb));
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
      ld += (1.0f - hold) * lde;
    }
    s.LD[o] += ld;
  }
  __syncthreads();
}

// The proposal's plaquette sin/cos fields (SP1, CP1) and its per-chain
// potential and charge (CH kPot1, kChg1), after every CTA's last position
// update.
template <int CC>
__device__ void slab_plaq(const SlabSmem& s, const SlabGeo& g, const Slab& sl,
                          int nc, unsigned& sums) {
  const int tid = threadIdx.x, nt = blockDim.x, dl = g.dl;
  cluster_sync();  // the next CTA's Y1 is written
  for (int o = tid; o < nc * dl; o += nt) {
    const int c = o / dl, i = o - c * dl;
    const float p = plaq_slab(s.Y0 + c * dl, s.Y1 + c * dl,
                              sl.y1_next + 4u * (unsigned)(c * dl), i, dl,
                              g.lx);
    float sn, cs;
    sincosf(p, &sn, &cs);
    s.SP1[o] = sn;
    s.CP1[o] = cs;
    float* st = s.BUF + c * g.bs + i;
    st[0] = 1.0f - cs;
    st[dl] = wrap_angle(p);
  }
  chain_sums<CC, 2>(s, g, nc, sums);
  if (tid < nc) {
    s.CH[kPot1 * CC + tid] = s.TOT[tid];
    s.CH[kChg1 * CC + tid] = s.TOT[CC + tid] * CHAIN_INV_TWO_PI_F;
  }
  __syncthreads();
}

template <class WT, int CC>
__global__ void __launch_bounds__(kThreads, 1)  // one CTA per SM
l2hmc_chain_kernel(float* __restrict__ x0g, float* __restrict__ x1g,
                   float* __restrict__ spcp, Weights<WT> W, L2Rand rnd,
                   float* __restrict__ plaq_tr, float* __restrict__ chg_tr,
                   float* __restrict__ prob_tr, SlabGeo g) {
  extern __shared__ __align__(128) float smem[];
  const int d = g.d, dl = g.dl, K = g.K, B = g.B;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int b0 = (blockIdx.x / g.cl) * CC;
  const int nc = min(CC, B - b0);
  const SlabSmem s = carve<CC>(smem, g);
  Slab sl;
  sl.rank = (int)cluster_rank();
  sl.site0 = sl.rank * dl;
  sl.sp1_prev = cluster_addr(s.SP1, (sl.rank + g.cl - 1) % g.cl);
  sl.y1_next = cluster_addr(s.Y1, (sl.rank + 1) % g.cl);
  const bool injected = rnd.v0s != nullptr;
  unsigned pos = 0;    // ring position of the next chunk
  unsigned sums = 0;   // cluster sums so far (PART buffer)

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
  // the coefficients' exponentials at the slab's sites, once (expf as the
  // updates would take it at every use)
  for (int k = tid; k < 8 * dl; k += nt) {
    const int a = k / dl, i = k - a * dl;
    const NetW<WT>& net = a < 4 ? W.v : W.x;
    const float* src[4] = {net.cs0, net.cs1, net.ct0, net.ct1};
    s.EC[k] = expf(src[a % 4][sl.site0 + i]);
  }
  // zero the product operands (pads and idle chain columns stay finite)
  for (int k = tid; k < CC * g.bs; k += nt) s.BUF[k] = 0.0f;
  for (int k = tid; k < 2 * CC * g.hs; k += nt) s.HID1[k] = 0.0f;
  for (int k = tid; k < 2 * CC; k += nt) s.TAU[k] = 0.0f;
  // the accepted state, in device memory; each thread reads and writes only
  // its own (chain, site) pairs o = tid (mod nt) of the slab
  float* X0 = x0g + (size_t)b0 * d + sl.site0;
  float* X1 = x1g + (size_t)b0 * d + sl.site0;
  float* SP = spcp + (size_t)b0 * d + sl.site0;
  float* CP = spcp + (size_t)B * d + (size_t)b0 * d + sl.site0;
  __syncthreads();  // BUF zeroed before the sums below are staged in it

  // the plaquette fields of the input links (the next rows from device
  // memory) and their per-chain potential and charge
  for (int o = tid; o < nc * dl; o += nt) {
    const int c = o / dl, i = o - c * dl;
    const size_t chain = (size_t)(b0 + c) * d;
    const float p = plaq_angle(x0g + chain, x1g + chain, sl.site0 + i, g.lt,
                               g.lx);
    float sn, cs;
    sincosf(p, &sn, &cs);
    SP[(size_t)c * d + i] = sn;
    CP[(size_t)c * d + i] = cs;
    float* st = s.BUF + c * g.bs + i;
    st[0] = 1.0f - cs;
    st[dl] = wrap_angle(p);
  }
  chain_sums<CC, 2>(s, g, nc, sums);
  if (tid < nc) {
    s.CH[kPot * CC + tid] = s.TOT[tid];
    s.CH[kChg * CC + tid] = s.TOT[CC + tid] * CHAIN_INV_TWO_PI_F;
  }

  for (int n = 0; n < g.N; ++n) {
    for (int o = tid; o < nc * dl; o += nt) {
      const int c = o / dl, i = o - c * dl;
      const size_t go = (size_t)c * d + i;
      const float2 v = initial_momenta(rnd.v0s, rnd.v1s, g.seed, b0 + c, B,
                                       n, g.N, d, sl.site0 + i);
      s.W0[o] = v.x;
      s.W1[o] = v.y;
      s.Y0[o] = X0[go];
      s.Y1[o] = X1[go];
      s.SP1[o] = SP[go];
      s.CP1[o] = CP[go];
      s.LD[o] = 0.0f;
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
      s.CH[kPot1 * CC + tid] = s.CH[kPot * CC + tid];
      s.CH[kChg1 * CC + tid] = s.CH[kChg * CC + tid];
    }
    cluster_sync();  // every CTA's SP1 (the force's halo) is loaded

#pragma unroll 1
    for (int step = 0; step < K; ++step) {
      const bool first = step == 0;
      slab_kick<WT, CC>(W, s, g, sl, nc, pos, first ? 0.5f : 1.0f,
                        first ? 0.0f : step - 0.5f,
                        first ? (float)(K - 1) : K - 0.5f - step);
#pragma unroll 1
      for (int half = 0; half < 2; ++half)
        slab_xhalf<WT, CC>(W, s, g, sl, nc, pos, step, half == 1);
      slab_plaq<CC>(s, g, sl, nc, sums);
    }
    // closing half kick at trajectory time K-1 (fwd) / 0 (bwd)
    slab_kick<WT, CC>(W, s, g, sl, nc, pos, 0.5f, (float)(K - 1), 0.0f);

    // energy change from per-site differences, log-det and finiteness
    for (int o = tid; o < nc * dl; o += nt) {
      const int c = o / dl, i = o - c * dl;
      const float2 v = initial_momenta(rnd.v0s, rnd.v1s, g.seed, b0 + c, B,
                                       n, g.N, d, sl.site0 + i);
      float* st = s.BUF + c * g.bs + i;
      st[0] = kinetic_diff(v, s.W0[o], s.W1[o]);
      st[dl] = s.CP1[o] - CP[(size_t)c * d + i];
      st[2 * dl] = s.LD[o];
      st[3 * dl] = fabsf(s.Y0[o]) + fabsf(s.Y1[o]) + fabsf(s.W0[o]) +
                   fabsf(s.W1[o]);
    }
    chain_sums<CC, 4>(s, g, nc, sums);
    if (tid < nc) {
      const int c = tid;
      const float dh = g.beta * s.TOT[CC + c] + 0.5f * s.TOT[c] +
                       s.TOT[2 * CC + c];
      float p = expf(dh > 0.0f ? 0.0f : dh);  // NaN stays NaN -> rejected
      if (!isfinite(p) || !isfinite(s.TOT[3 * CC + c])) p = 0.0f;
      const bool acc = s.SC[c * 4 + 1] < p;
      s.CH[kProb * CC + c] = p;
      s.CH[kAcc * CC + c] = acc ? 1.0f : 0.0f;
      if (acc) {
        s.CH[kPot * CC + c] = s.CH[kPot1 * CC + c];
        s.CH[kChg * CC + c] = s.CH[kChg1 * CC + c];
      }
    }
    __syncthreads();
    for (int o = tid; o < nc * dl; o += nt) {
      const int c = o / dl;
      if (s.CH[kAcc * CC + c] == 0.0f) continue;
      const size_t go = (size_t)c * d + (o - c * dl);
      X0[go] = s.Y0[o];
      X1[go] = s.Y1[o];
      SP[go] = s.SP1[o];
      CP[go] = s.CP1[o];
    }

    if (g.hop) {
      // each thread reads only its own sites of the accepted fields here
      for (int o = tid; o < nc * dl; o += nt) {
        const int c = o / dl, i = o - c * dl;
        const size_t go = (size_t)c * d + i;
        const float nu = s.SC[c * 4 + 2];
        float* st = s.BUF + c * g.bs + i;
        st[0] = SP[go];
        st[dl] = (CP[go] < -cd && nu * SP[go] >= 0.0f) ? 1.0f : 0.0f;
      }
      chain_sums<CC, 2>(s, g, nc, sums);
      if (tid < nc) {
        const int c = tid;
        const float nu = s.SC[c * 4 + 2], uh = s.SC[c * 4 + 3];
        const float pot = s.CH[kPot * CC + c];
        const float ds =
            one_minus_cd * ((float)d - pot) + nu * sd * s.TOT[c];
        const float m = -g.beta * ds;
        float ph = expf(m > 0.0f ? 0.0f : m);
        if (!isfinite(ph)) ph = 0.0f;
        const float ah = (uh < ph) ? 1.0f : 0.0f;
        const float an = ah * nu;
        s.CH[kHopAcc * CC + c] = ah;
        s.CH[kHopNu * CC + c] = an;
        s.CH[kPot * CC + c] = pot + ah * ds;
        s.CH[kChg * CC + c] =
            s.CH[kChg * CC + c] + an * (1.0f - s.TOT[CC + c]);
      }
      __syncthreads();
      for (int o = tid; o < nc * dl; o += nt) {
        const int c = o / dl, i = o - c * dl;
        const size_t go = (size_t)c * d + i;
        const float ah = s.CH[kHopAcc * CC + c], an = s.CH[kHopNu * CC + c];
        const float cda = 1.0f + ah * cd_minus_one;
        const float sda = an * sd;
        float w0, w1;
        winding(sl.site0 + i, g.lt, g.lx, delta, seam, &w0, &w1);
        X0[go] = wrap_angle(X0[go] + an * w0);
        X1[go] = wrap_angle(X1[go] + an * w1);
        hop_rotate(SP + go, CP + go, cda, sda);
      }
    }

    if (sl.rank == 0 && tid < nc) {
      const size_t o = (size_t)n * B + b0 + tid;
      plaq_tr[o] = 1.0f - s.CH[kPot * CC + tid] / (float)d;
      chg_tr[o] = s.CH[kChg * CC + tid];
      prob_tr[o] = s.CH[kProb * CC + tid];
    }
    __syncthreads();  // fields and scalars settled before the next transition
  }
  cluster_sync();  // no CTA leaves while another may read its shared memory
}

}  // namespace

// Shared memory of one CTA (the carve above).
extern "C" size_t l2hmc_chain_cluster_smem_bytes(int cc, int dl, int bs,
                                                 int hs, int stages) {
  return sizeof(float) *
         ((size_t)stages * kChunkFloats + 4 * kMaxStages +
          7 * (size_t)cc * dl + (size_t)cc * bs + 2 * (size_t)cc * hs +
          2 * (size_t)kMmaWarps * 16 * (cc + 4) + 8 * (size_t)cc +
          4 * (size_t)cc + kChainVals * (size_t)cc + 4 * (size_t)cc +
          2 * (size_t)cc + 8 * (size_t)dl);
}

namespace {

template <class WT, int CC>
void* cluster_kernel() {
  return reinterpret_cast<void*>(l2hmc_chain_kernel<WT, CC>);
}

void* cluster_kernel_for(int bf16, int cc) {
  switch (cc) {
    case 8:
      return bf16 ? cluster_kernel<__nv_bfloat16, 8>()
                  : cluster_kernel<float, 8>();
    case 16:
      return bf16 ? cluster_kernel<__nv_bfloat16, 16>()
                  : cluster_kernel<float, 16>();
    case 32:
      return bf16 ? cluster_kernel<__nv_bfloat16, 32>()
                  : cluster_kernel<float, 32>();
    default:
      return nullptr;
  }
}

// The launch configuration of `clusters` clusters of `cl` CTAs.
struct ClusterLaunch {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  ClusterLaunch(int clusters, int cl, size_t smem, cudaStream_t stream) {
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = cl;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg = cudaLaunchConfig_t{};
    cfg.gridDim = dim3(clusters * cl);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
};

template <class WT, int CC>
int launch(const void* const* p, float* x0, float* x1, float* spcp,
           const L2Rand& rnd, float* plaq, float* chg, float* prob,
           const SlabGeo& g, cudaStream_t stream) {
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
      l2hmc_chain_cluster_smem_bytes(CC, g.dl, g.bs, g.hs, g.stages);
  auto kernel = l2hmc_chain_kernel<WT, CC>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  ClusterLaunch l((g.B + CC - 1) / CC, g.cl, smem, stream);
  const cudaError_t le = cudaLaunchKernelEx(&l.cfg, kernel, x0, x1, spcp, W,
                                            rnd, plaq, chg, prob, g);
  if (le != cudaSuccess) return (int)le;
  return (int)cudaGetLastError();
}

template <class WT>
int launch_cc(int cc, const void* const* p, float* x0, float* x1,
              float* spcp, const L2Rand& rnd, float* plaq, float* chg,
              float* prob, const SlabGeo& g, cudaStream_t st) {
  switch (cc) {
    case 8:
      return launch<WT, 8>(p, x0, x1, spcp, rnd, plaq, chg, prob, g, st);
    case 16:
      return launch<WT, 16>(p, x0, x1, spcp, rnd, plaq, chg, prob, g, st);
    case 32:
      return launch<WT, 32>(p, x0, x1, spcp, rnd, plaq, chg, prob, g, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Clusters of `cl` CTAs of the cluster route (cc chains per CTA, `smem`
// bytes each) that the card runs at once; a negative CUDA error code when
// it cannot tell.
extern "C" int l2hmc_chain_cluster_max_active(int cl, int cc, int bf16,
                                              int smem, int device) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return -(int)guard.err;
  void* kernel = cluster_kernel_for(bf16, cc);
  if (kernel == nullptr || cl < 1 || cl > kMaxCluster)
    return -(int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return -(int)e;
  ClusterLaunch l(1, cl, (size_t)smem, nullptr);
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, kernel, &l.cfg);
  if (e != cudaSuccess) return -(int)e;
  return n;
}

// The cluster route of l2hmc_chain_launch: wptrs as there, the in-projection
// and head chunks packed per slab (ops/l2hmc_kernel.py mma_weights with cl
// slabs); cl CTAs per cluster, cc chains per CTA; hp ... stages the product
// layout of one slab (mma_geometry at d / cl sites).
extern "C" int l2hmc_chain_cluster_launch(
    float* x0, float* x1, float* spcp, const void* wptrs, const float* v0s,
    const float* v1s, const float* ds, const float* us, const float* nus,
    const float* uhs, float* plaq, float* chg, float* prob, int B, int lt,
    int lx, int K, int N, float eps, float beta, int bounded_q, int hop,
    int bf16, unsigned long long seed, int cl, int cc, int hp, int mt,
    int n_in, int n_tr, int n_hd, int kq, int bs, int hs, int stages,
    int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  if (B <= 0 || N <= 0) return 0;
  if (stages < 2 || stages > kMaxStages || mt < 2 || mt > kMmaWarps ||
      kMmaWarps % mt != 0 || cl < 2 || cl > kMaxCluster || lt % cl != 0)
    return (int)cudaErrorInvalidValue;
  const void* const* p = static_cast<const void* const*>(wptrs);
  const L2Rand rnd{v0s, v1s, ds, us, nus, uhs};
  const SlabGeo g{B,    lt,   lx,   lt * lx, K,    N,     bounded_q, hop,
                  eps,  beta, seed, cl,      lt * lx / cl, hp, mt,
                  n_in, n_tr, n_hd, kq,      bs,   hs,    stages};
  const cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? launch_cc<__nv_bfloat16>(cc, p, x0, x1, spcp, rnd, plaq, chg,
                                         prob, g, st)
              : launch_cc<float>(cc, p, x0, x1, spcp, rnd, plaq, chg, prob,
                                 g, st);
}

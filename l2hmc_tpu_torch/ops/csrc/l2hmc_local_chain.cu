// Fused TRAINED L2HMC chain with the LOCAL 5-point-stencil conditioner
// (make_local_flat_net family, U(1), merge_v_halves): N transitions of one
// chain per block in one launch.
//
// Replaces the TPU kernel l2hmc_tpu/ops/l2hmc_kernel.py:_build_local_kernel
// (entry l2hmc_local_chain_pallas).  Each transition: fresh momenta and
// direction, K+1 merged VNet momentum kicks and 2K masked XNet circle-scaling
// position half-updates with the exact log-Jacobian, the Wilson force after
// every step, the MH accept with non-finite rejection, and optionally one
// exact instanton hop from the carried plaquette fields.  Only the final
// links and three (N, B) traces reach device memory.
//
// The conditioner: L >= 1 periodic 5-point stencil layers (ReLU) of C
// channels over 6 per-direction input channels, the time encoding as a
// per-chain bias of layer 0, and a 1x1 head to [S0 S1 T0 T1 Q0 Q1].  It is
// weight-shared, so its few hundred weights sit in shared memory and every
// read of one is a broadcast.  Layers 1 .. L-1 have the same (5, C, C)
// weights, so one loop over them serves every depth.
//
// What bounds it on an H100: instruction issue inside one block per SM
// (512 threads, d / 512 sites each; at 64x64 the ten 16 KB fields per chain
// leave no room for a second block).  The design spends the issue slots on
// the stencil's FMAs and keeps the rest off that path:
// - Staged inputs.  Before a conditioner call the four trigonometric input
//   channels are written once per site into shared memory: [cos y0, cos y1,
//   sin y0, sin y1] for the VNet, the same times the hold masks for the
//   XNet (links read only where held).  The stencil then reads five
//   neighbours' staged values instead of calling sincosf ten times per
//   site; the other two channels (the force from sin P, or the momenta) are
//   read from the fields.  The first position half-update of a step reuses
//   the kick's staged values (the links have not moved), so a step costs 2
//   (kick) + 0 + 1 (held half of the links) sincosf per site for the
//   conditioner, against 10 + 5 + 5 when each use rebuilt them.
// - Room for them: whole staged fields, not row bands.  At 64x64 the L = 2,
//   C = 4 net already uses 224 of the 227 KB with ten fields and the layer-0
//   outputs, which leaves no room for a band of even three rows.  So the
//   accepted state (links X0, X1 and their plaquette sin/cos SP, CP), which
//   a transition reads once at its start and writes once on accept or hop,
//   lives in device memory (the links in the output arrays, SP and CP in a
//   (B, 2, d) scratch the wrapper allocates: 32 MB at 512 chains, held in
//   L2), and its 64 KB of shared memory hold the four staged channels.
// - The channel count C in {4, 8} is a template parameter; the wrapper pads
//   a net of fewer channels with zero weights, biases, time rows and head
//   rows, whose outputs are exactly 0 after ReLU and add exact zeros to the
//   head.  Every channel loop unrolls without predicates, and each weight
//   row is read as float4: one shared load per 4 FMAs.
// The staging is safe in place: a position half-update writes links only
// at sites its mask moves and stages (and the stencil reads) them only at
// sites it holds; the kick writes only momenta, which the VNet does not read.
// Each phase (kick, position half-update, force) has one call site in the
// transition loop, so one inlined copy.  Depth routes, template parameter L:
// - L = 1, 2: the layer-0 outputs of a two-layer net (C fields) in shared
//   memory, beside the ten fields, where they fit (not c8L2 at 64x64);
// - L = kDeep (the wrapper's "deep" route, any depth >= 2, runtime g.L): the
//   hidden layers' outputs go to device memory, two (C, d) buffers per
//   chain in turn (a (B, 2, C, d) scratch the wrapper allocates), written
//   once per site and layer and read by the next layer's stencil through L1;
//   the last hidden layer is computed per site with the head, as for L = 2.
//
// The carried sin/cos plaquette fields are rotated, not recomputed, after
// an accepted hop (hop_rotate in chain_common.cuh rounds as the plain
// version does), and block sums are float32 as in the plain version: kernel
// and plain version agree to ~4e-5 on accept probabilities at 64x64.
//
// The cost-decomposition mode (template ABLATE, as in l2hmc_chain.cu)
// compiles out the staging, the stencil layers and the head, and reads
// S = T = Q from a kernel argument that the wrapper sets to 0, so nvcc
// cannot fold them into the exp factors and the circle map; the rest of the
// transition runs as in the full kernel, for L = 1 and L = 2.
//
// Randomness: injected arrays (v0s, v1s, ds, us[, nus, uhs]), or
// Philox4_32_10 keyed by (chain, transition) with the seed drawn by the
// caller, as in l2hmc_chain.cu.

#include "chain_common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kCin = 6;    // layer-0 input channels (u1)
constexpr int kOff = 5;    // stencil points
constexpr int kDeep = 0;   // depth route: hidden outputs in device memory
constexpr double kPiD = 3.141592653589793;

// Floats of one hidden layer l >= 1: w (5, c, c), b (c).
__host__ __device__ inline int mid_stride(int c) { return kOff * c * c + c; }

// Floats of one net's weights in the kernel's order (ops/l2hmc_kernel.py
// local_kernel_weights): s0w (5, 6, c), s0t (2, c), s0b (c), L - 1 times
// [s{l}w (5, c, c), s{l}b (c)], hw (6, c) (the head transposed), hb (6), cs
// (2), ct (2); each net padded to a multiple of 4 floats, so every (c)-row
// is 16-byte aligned for c in {4, 8}.
__host__ __device__ inline int net_stride(int c, int L) {
  const int n = kOff * kCin * c + 2 * c + c + (L - 1) * mid_stride(c) +
                6 * c + 6 + 2 + 2;
  return (n + 3) & ~3;
}

// s1w: the first hidden layer's weights; layer l's at s1w + (l - 1)
// mid_stride(C), its bias kOff C C floats after them.
struct NetW {
  const float *s0w, *s0t, *s0b, *s1w, *hw, *hb, *cs, *ct;
};

template <int C>
__device__ __forceinline__ NetW net_at(const float* p, int L) {
  NetW w;
  w.s0w = p;
  p += kOff * kCin * C;
  w.s0t = p;
  p += 2 * C;
  w.s0b = p;
  p += C;
  w.s1w = p;
  p += (L - 1) * mid_stride(C);
  w.hw = p;
  p += 6 * C;
  w.hb = p;
  p += 6;
  w.cs = p;
  w.ct = p + 2;
  return w;
}

struct LRand {
  const float *v0s, *v1s, *ds, *us, *nus, *uhs;
};

struct Geo {
  int B, lt, lx, d, K, N, L, bounded_q, hop;
  float eps, beta;
  float ablated_stq;  // S = T = Q of the ablated kernel: 0, not a constant
  unsigned long long seed;
};

// SC = {direction, accept uniform, hop winding sign, hop uniform}
struct Smem {
  float *WX, *WV;             // net weights (first: 16-byte aligned)
  float *scratch, *red, *SC;  // block sums, per-chain scalars
  float *Y0, *Y1, *W0, *W1, *SP1, *CP1;  // proposal, momenta, its sin/cos P
  float *T0, *T1, *T2, *T3;   // staged trigonometric input channels
  float* H;                   // (C, d) layer-0 outputs, L = 2 only
};

// ns: net_stride of the net's depth
__device__ __forceinline__ Smem carve(float* smem, int d, int ns) {
  Smem s;
  s.WX = smem;
  s.WV = s.WX + ns;
  s.scratch = s.WV + ns;
  s.red = s.scratch + kWarps * 4;
  s.SC = s.red + 4;
  s.Y0 = s.SC + 4;
  s.Y1 = s.Y0 + d;
  s.W0 = s.Y1 + d;
  s.W1 = s.W0 + d;
  s.SP1 = s.W1 + d;
  s.CP1 = s.SP1 + d;
  s.T0 = s.CP1 + d;
  s.T1 = s.T0 + d;
  s.T2 = s.T1 + d;
  s.T3 = s.T2 + d;
  s.H = s.T3 + d;
  return s;
}

// (t, s) of stencil point o around (t, s), in the reference's roll order:
// o = 0 the site, 1 (t-1, s), 2 (t+1, s), 3 (t, s-1), 4 (t, s+1).
__device__ __forceinline__ void stencil_point(int t, int s, int o, int lt,
                                              int lx, int* to, int* so) {
  *to = t;
  *so = s;
  if (o == 1) *to = t == 0 ? lt - 1 : t - 1;
  if (o == 2) *to = t + 1 == lt ? 0 : t + 1;
  if (o == 3) *so = s == 0 ? lx - 1 : s - 1;
  if (o == 4) *so = s + 1 == lx ? 0 : s + 1;
}

// VNet layer-0 inputs at (t, s): [cos y0, cos y1, sin y0, sin y1] staged,
// [g0, g1] the force beta * dS/du from the proposal's sine field.
struct VnetIn {
  const float *T0, *T1, *T2, *T3, *SP1;
  int lt, lx;
  float beta;
  __device__ __forceinline__ void operator()(int t, int s,
                                             float (&x)[kCin]) const {
    const int j = t * lx + s;
    x[0] = T0[j];
    x[1] = T1[j];
    x[2] = T2[j];
    x[3] = T3[j];
    const float sp = SP1[j];
    x[4] = beta * (sp - SP1[t * lx + (s == 0 ? lx - 1 : s - 1)]);
    x[5] = beta * (-sp + SP1[(t == 0 ? lt - 1 : t - 1) * lx + s]);
  }
};

// Hold mask of one direction for one position half-update: row
// mask[step] (forward) or mask[K-1-step] (backward), complemented when
// `flip` (forward second half, backward first half).
struct Hold {
  const float* row;
  bool flip;
  __device__ __forceinline__ float operator()(int j) const {
    return flip ? 1.0f - row[j] : row[j];
  }
};

// XNet layer-0 inputs at (t, s): [w0, w1] from the momenta, [m0 cos y0,
// m1 cos y1, m0 sin y0, m1 sin y1] staged.
struct XnetIn {
  const float *W0, *W1, *T0, *T1, *T2, *T3;
  int lx;
  __device__ __forceinline__ void operator()(int t, int s,
                                             float (&x)[kCin]) const {
    const int j = t * lx + s;
    x[0] = W0[j];
    x[1] = W1[j];
    x[2] = T0[j];
    x[3] = T1[j];
    x[4] = T2[j];
    x[5] = T3[j];
  }
};

// Stage the VNet's trigonometric channels of every site, then a barrier.
__device__ __forceinline__ void stage_v(const Smem& s, int d) {
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    float s0, c0, s1, c1;
    sincosf(s.Y0[i], &s0, &c0);
    sincosf(s.Y1[i], &s1, &c1);
    s.T0[i] = c0;
    s.T1[i] = c1;
    s.T2[i] = s0;
    s.T3[i] = s1;
  }
  __syncthreads();
}

// Stage the XNet's masked trigonometric channels, then a barrier.  Links are
// read only where held (the half-update rewrites the others).  With `reuse`
// (the first half-update of a step: the links are the kick's) the staged
// VNet values are masked in place instead of recomputed.
__device__ __forceinline__ void stage_x(const Smem& s, int d, const Hold& h0,
                                        const Hold& h1, bool reuse) {
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const float m0 = h0(i), m1 = h1(i);
    float s0 = 0.0f, c0 = 0.0f, s1 = 0.0f, c1 = 0.0f;
    if (reuse) {
      if (m0 != 0.0f) {
        c0 = s.T0[i];
        s0 = s.T2[i];
      }
      if (m1 != 0.0f) {
        c1 = s.T1[i];
        s1 = s.T3[i];
      }
    } else {
      if (m0 != 0.0f) sincosf(s.Y0[i], &s0, &c0);
      if (m1 != 0.0f) sincosf(s.Y1[i], &s1, &c1);
    }
    s.T0[i] = m0 * c0;
    s.T1[i] = m1 * c1;
    s.T2[i] = m0 * s0;
    s.T3[i] = m1 * s1;
  }
  __syncthreads();
}

// acc[j] += sum_q w4[q] (the C weights of one input) * x, as float4 reads.
template <int C>
__device__ __forceinline__ void fma_row(const float* wrow, float x,
                                        float (&acc)[C]) {
  const float4* w4 = reinterpret_cast<const float4*>(wrow);
#pragma unroll
  for (int q = 0; q < C / 4; ++q) {
    const float4 v = w4[q];
    acc[4 * q] = fmaf(v.x, x, acc[4 * q]);
    acc[4 * q + 1] = fmaf(v.y, x, acc[4 * q + 1]);
    acc[4 * q + 2] = fmaf(v.z, x, acc[4 * q + 2]);
    acc[4 * q + 3] = fmaf(v.w, x, acc[4 * q + 3]);
  }
}

// Layer-0 bias of one call: b + tau . wt per channel.
template <int C>
__device__ __forceinline__ void layer0_bias(const NetW& w, float tau0,
                                            float tau1, float (&bias)[C]) {
#pragma unroll
  for (int j = 0; j < C; ++j)
    bias[j] = w.s0b[j] + (tau0 * w.s0t[j] + tau1 * w.s0t[C + j]);
}

// Layer 0 at (t, s): relu(bias + sum_{o, ci} w[o, ci, :] in_ci(o)).
template <int C, class In>
__device__ __forceinline__ void layer0(const NetW& w, const float (&bias)[C],
                                       int t, int s, int lt, int lx,
                                       const In& in, float (&acc)[C]) {
#pragma unroll
  for (int j = 0; j < C; ++j) acc[j] = bias[j];
#pragma unroll
  for (int o = 0; o < kOff; ++o) {
    int to, so;
    stencil_point(t, s, o, lt, lx, &to, &so);
    float x[kCin];
    in(to, so, x);
#pragma unroll
    for (int ci = 0; ci < kCin; ++ci)
      fma_row<C>(w.s0w + (o * kCin + ci) * C, x[ci], acc);
  }
#pragma unroll
  for (int j = 0; j < C; ++j) acc[j] = fmaxf(acc[j], 0.0f);
}

// Hidden layer l >= 1 at (t, s), weights lw (its bias after them), from
// the previous layer's output fields H (C, d).
template <int C>
__device__ __forceinline__ void layer_mid(const float* lw, int t, int s,
                                          int lt, int lx, const float* H,
                                          int d, float (&acc)[C]) {
  const float* lb = lw + kOff * C * C;
#pragma unroll
  for (int j = 0; j < C; ++j) acc[j] = lb[j];
#pragma unroll
  for (int o = 0; o < kOff; ++o) {
    int to, so;
    stencil_point(t, s, o, lt, lx, &to, &so);
    const int jn = to * lx + so;
#pragma unroll
    for (int ci = 0; ci < C; ++ci)
      fma_row<C>(lw + (o * C + ci) * C, H[ci * d + jn], acc);
  }
#pragma unroll
  for (int j = 0; j < C; ++j) acc[j] = fmaxf(acc[j], 0.0f);
}

// 1x1 head and combines: per direction r, (S, T, Q).
template <int C>
__device__ __forceinline__ void head(const NetW& w, bool bounded_q,
                                     const float (&y)[C], float (&S)[2],
                                     float (&T)[2], float (&Q)[2]) {
  float hd[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const float4* w4 = reinterpret_cast<const float4*>(w.hw + k * C);
    float a = w.hb[k];
#pragma unroll
    for (int q = 0; q < C / 4; ++q) {
      const float4 v = w4[q];
      a = fmaf(v.x, y[4 * q], a);
      a = fmaf(v.y, y[4 * q + 1], a);
      a = fmaf(v.z, y[4 * q + 2], a);
      a = fmaf(v.w, y[4 * q + 3], a);
    }
    hd[k] = a;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    S[r] = tanhf(hd[r]) * expf(w.cs[r]);
    T[r] = hd[2 + r];
    const float qr = hd[4 + r];
    Q[r] = (bounded_q ? tanhf(qr) : qr) * expf(w.ct[r]);
  }
}

__device__ __forceinline__ void time_enc(float idx, int K, float* t0,
                                         float* t1) {
  const float ang = CHAIN_TWO_PI_F * idx / (float)K;
  *t0 = cosf(ang);
  *t1 = sinf(ang);
}

// Layer-0 outputs of every site into H (C, d) (nets of two layers or
// more, first phase).
template <int C, class In>
__device__ __forceinline__ void fill_h(const NetW& w, float* H, const Geo& g,
                                       const float (&bias)[C], const In& in) {
  for (int i = threadIdx.x; i < g.d; i += blockDim.x) {
    const int t = i / g.lx, sx = i - t * g.lx;
    float acc[C];
    layer0<C>(w, bias, t, sx, g.lt, g.lx, in, acc);
#pragma unroll
    for (int j = 0; j < C; ++j) H[j * g.d + i] = acc[j];
  }
  __syncthreads();
}

// The deep route's hidden layers but the last: layer 0 into hbuf's first
// (C, d) buffer, then layers 1 .. L-2, each from one buffer into the other.
// Returns the buffer the last hidden layer reads.
template <int C, class In>
__device__ __forceinline__ const float* deep_hidden(const NetW& w,
                                                    float* hbuf,
                                                    const Geo& g,
                                                    const float (&bias)[C],
                                                    const In& in) {
  float* src = hbuf;
  float* dst = hbuf + (size_t)C * g.d;
  fill_h<C>(w, src, g, bias, in);
  for (int l = 1; l + 1 < g.L; ++l) {
    const float* lw = w.s1w + (size_t)(l - 1) * mid_stride(C);
    for (int i = threadIdx.x; i < g.d; i += blockDim.x) {
      const int t = i / g.lx, sx = i - t * g.lx;
      float acc[C];
      layer_mid<C>(lw, t, sx, g.lt, g.lx, src, g.d, acc);
#pragma unroll
      for (int j = 0; j < C; ++j) dst[j * g.d + i] = acc[j];
    }
    __syncthreads();
    float* tmp = src;
    src = dst;
    dst = tmp;
  }
  return src;
}

// S, T, Q at site i = (t, sx): the last hidden layer (from hl, the output
// of the layer before it, for L >= 2), then the head.
template <int L, int C, class In>
__device__ __forceinline__ void conditioner_at(
    const NetW& w, const Geo& g, int i, const float (&bias)[C], const In& in,
    const float* hl, float (&S)[2], float (&T)[2], float (&Q)[2]) {
  const int t = i / g.lx, sx = i - t * g.lx;
  float y[C];
  if constexpr (L == 1)
    layer0<C>(w, bias, t, sx, g.lt, g.lx, in, y);
  else if constexpr (L == 2)
    layer_mid<C>(w.s1w, t, sx, g.lt, g.lx, hl, g.d, y);
  else
    layer_mid<C>(w.s1w + (size_t)(g.L - 2) * mid_stride(C), t, sx, g.lt,
                 g.lx, hl, g.d, y);
  head<C>(w, g.bounded_q, y, S, T, Q);
}

// The hidden layers of one call before the per-site pass: none (L = 1),
// layer 0 into shared memory (L = 2) or all but the last into hbuf (deep).
template <int L, int C, class In>
__device__ __forceinline__ const float* hidden(const NetW& w, const Smem& s,
                                               float* hbuf, const Geo& g,
                                               const float (&bias)[C],
                                               const In& in) {
  if constexpr (L == 2) {
    fill_h<C>(w, s.H, g, bias, in);
    return s.H;
  } else if constexpr (L == kDeep) {
    return deep_hidden<C>(w, hbuf, g, bias, in);
  }
  return nullptr;
}

// Merged momentum kick (update_v), direction-fused, from the proposal's
// links and force.  Writes only the momenta, which the VNet does not read.
// Returns this thread's log-det terms.
template <int L, int C, bool ABLATE>
__device__ __forceinline__ float kick(const NetW& w, const Smem& s,
                                      float* hbuf, const Geo& g, float factor,
                                      float t_fwd, float t_bwd) {
  float ld = 0.0f;
  const float dsg = s.SC[0];
  float bias[C];
  const VnetIn in{s.T0, s.T1, s.T2, s.T3, s.SP1, g.lt, g.lx, g.beta};
  const float* hl = nullptr;
  if constexpr (!ABLATE) {
    float tau0, tau1;
    time_enc(dsg > 0.0f ? t_fwd : t_bwd, g.K, &tau0, &tau1);
    layer0_bias<C>(w, tau0, tau1, bias);
    stage_v(s, g.d);
    hl = hidden<L, C>(w, s, hbuf, g, bias, in);
  }
  const float fe = factor * g.eps;
  for (int i = threadIdx.x; i < g.d; i += blockDim.x) {
    const float z = g.ablated_stq;
    float S[2] = {z, z}, T[2] = {z, z}, Q[2] = {z, z};
    if constexpr (!ABLATE) conditioner_at<L, C>(w, g, i, bias, in, hl, S, T, Q);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float gg = g.beta * (r ? grad1(s.SP1, i, g.lt, g.lx)
                                   : grad0(s.SP1, i, g.lt, g.lx));
      const float hs = fe * S[r];
      const float a = fe * (expf(g.eps * Q[r]) * gg - T[r]);
      const float e = expf(dsg * hs);
      float* wp = (r ? s.W1 : s.W0) + i;
      *wp = dsg > 0.0f ? *wp * e - a : (*wp + a) * e;
      ld += dsg * hs;
    }
  }
  __syncthreads();
  return ld;
}

// One masked position half-update on the torus (update_x, u1 branch).
// Sites the mask holds keep their link; a non-finite update there would make
// the plain version's link non-finite, so it is carried into `poison`,
// which rejects the proposal.  Returns this thread's log-det terms.
template <int L, int C, bool ABLATE>
__device__ __forceinline__ float xhalf(const float* mask0, const float* mask1,
                                       const NetW& w, const Smem& s,
                                       float* hbuf, const Geo& g, int step,
                                       bool second, float& poison) {
  float ld = 0.0f;
  const float dsg = s.SC[0];
  const bool fwd = dsg > 0.0f;
  const int row = fwd ? step : g.K - 1 - step;
  const bool flip = fwd == second;
  const Hold h0{mask0 + (size_t)row * g.d, flip};
  const Hold h1{mask1 + (size_t)row * g.d, flip};
  float bias[C];
  const XnetIn in{s.W0, s.W1, s.T0, s.T1, s.T2, s.T3, g.lx};
  const float* hl = nullptr;
  if constexpr (!ABLATE) {
    float tau0, tau1;
    time_enc(fwd ? (float)step : (float)(g.K - 1 - step), g.K, &tau0, &tau1);
    layer0_bias<C>(w, tau0, tau1, bias);
    stage_x(s, g.d, h0, h1, !second);
    hl = hidden<L, C>(w, s, hbuf, g, bias, in);
  }
  for (int i = threadIdx.x; i < g.d; i += blockDim.x) {
    const float z = g.ablated_stq;
    float S[2] = {z, z}, T[2] = {z, z}, Q[2] = {z, z};
    if constexpr (!ABLATE) conditioner_at<L, C>(w, g, i, bias, in, hl, S, T, Q);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float hold = r ? h1(i) : h0(i);
      float* yp = (r ? s.Y1 : s.Y0) + i;
      const float wv = (r ? s.W1 : s.W0)[i];
      const float yv = *yp;
      const float es = g.eps * S[r];
      const float bb = g.eps * (expf(g.eps * Q[r]) * wv + T[r]);
      const float u_in = fwd ? yv : wrap_angle(yv - bb);
      // circle_scale(u_in, dsg * es): 2 atan2(e^a sin(x/2), cos(x/2))
      const float a = dsg * es;
      float s2, c2;
      sincosf(0.5f * u_in, &s2, &c2);
      const float ea = expf(a);
      const float y2 = 2.0f * atan2f(ea * s2, c2);
      const float lde = a - logf(c2 * c2 + ea * ea * s2 * s2);
      const float upd = fwd ? wrap_angle(y2 + bb) : y2;
      ld += (1.0f - hold) * lde;
      if (hold == 0.0f)
        *yp = hold * yv + (1.0f - hold) * upd;
      else
        poison += 0.0f * upd;
    }
  }
  __syncthreads();
  return ld;
}

// Plaquette sine/cosine of the links (y0, y1) into (sp, cp); returns the
// potential and the unrounded charge.
__device__ __forceinline__ void plaq_fields(const float* y0, const float* y1,
                                            float* sp, float* cp,
                                            const Smem& s, const Geo& g,
                                            float* pot, float* chg) {
  float v[2] = {0.0f, 0.0f};
  for (int i = threadIdx.x; i < g.d; i += blockDim.x) {
    float sn, cs;
    const float p = plaq_angle(y0, y1, i, g.lt, g.lx);
    sincosf(p, &sn, &cs);
    sp[i] = sn;
    cp[i] = cs;
    v[0] += 1.0f - cs;
    v[1] += wrap_angle(p);
  }
  block_sum<2>(v, s.scratch, s.red);
  *pot = v[0];
  *chg = v[1] * CHAIN_INV_TWO_PI_F;
}

// x0g/x1g (B, d): the chain's links in, its accepted links throughout and
// out; spcp (B, 2, d): the accepted state's sin P and cos P; hbufg (B, 2, C,
// d): the deep route's hidden outputs (unused otherwise).
template <int L, int C, bool ABLATE>
__global__ void __launch_bounds__(kThreads, 1)  // one block per SM
l2hmc_local_chain_kernel(float* __restrict__ x0g, float* __restrict__ x1g,
                         float* __restrict__ spcp, float* __restrict__ hbufg,
                         const float* __restrict__ wflat,
                         const float* __restrict__ mask0,
                         const float* __restrict__ mask1, LRand rnd,
                         float* __restrict__ plaq_tr,
                         float* __restrict__ chg_tr,
                         float* __restrict__ prob_tr, Geo g) {
  extern __shared__ __align__(16) float smem[];
  const int d = g.d;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int b = blockIdx.x;
  const int ns = net_stride(C, L == kDeep ? g.L : L);
  const Smem s = carve(smem, d, ns);
  float* hbuf = L == kDeep ? hbufg + (size_t)b * 2 * C * d : nullptr;
  const bool injected = rnd.v0s != nullptr;
  // the accepted state, in device memory: each thread reads and writes only
  // its own sites i = tid (mod nt) of it
  float* X0 = x0g + (size_t)b * d;
  float* X1 = x1g + (size_t)b * d;
  float* SP = spcp + (size_t)b * 2 * d;
  float* CP = SP + d;

  const double dd = (double)d;
  const float cd = (float)cos(2.0 * kPiD / dd);
  const float sd = (float)sin(2.0 * kPiD / dd);
  const float one_minus_cd = (float)(1.0 - cos(2.0 * kPiD / dd));
  const float cd_minus_one = (float)(cos(2.0 * kPiD / dd) - 1.0);
  const float delta = (float)(2.0 * kPiD / dd);
  const float seam = (float)(-(2.0 * kPiD / dd) * g.lt);

  if constexpr (!ABLATE) {
    const int nwf = 2 * ns;
    for (int k = tid; k < nwf; k += nt) s.WX[k] = wflat[k];
  }
  for (int i = tid; i < d; i += nt) {
    s.Y0[i] = X0[i];
    s.Y1[i] = X1[i];
  }
  __syncthreads();
  const NetW wx = net_at<C>(s.WX, L == kDeep ? g.L : L);
  const NetW wv = net_at<C>(s.WV, L == kDeep ? g.L : L);

  float pot, chg;
  plaq_fields(s.Y0, s.Y1, SP, CP, s, g, &pot, &chg);

  for (int n = 0; n < g.N; ++n) {
    float ld = 0.0f, poison = 0.0f;
    for (int i = tid; i < d; i += nt) {
      const float2 v =
          initial_momenta(rnd.v0s, rnd.v1s, g.seed, b, g.B, n, g.N, d, i);
      s.W0[i] = v.x;
      s.W1[i] = v.y;
      s.Y0[i] = X0[i];
      s.Y1[i] = X1[i];
      s.SP1[i] = SP[i];
      s.CP1[i] = CP[i];
    }
    if (tid == 0) {
      const size_t o = (size_t)n * g.B + b;
      if (injected) {
        s.SC[0] = rnd.ds[o];
        s.SC[1] = rnd.us[o];
        if (g.hop) {
          s.SC[2] = rnd.nus[o];
          s.SC[3] = rnd.uhs[o];
        }
      } else {
        curandStatePhilox4_32_10_t st;
        philox_at(&st, g.seed, b, n, g.N, 8ull * d);
        s.SC[0] = sign_from_uniform(curand_uniform(&st));
        s.SC[1] = curand_uniform(&st);
        s.SC[2] = sign_from_uniform(curand_uniform(&st));
        s.SC[3] = curand_uniform(&st);
      }
    }
    __syncthreads();

    // K steps of (kick, two position half-updates, force), then the
    // closing half kick at trajectory time K-1 (fwd) / 0 (bwd) as step K;
    // each phase has one call site, so one inlined copy
    float pot1 = pot, chg1 = chg;
#pragma unroll 1
    for (int step = 0; step <= g.K; ++step) {
      const bool edge = step == 0 || step == g.K;
      const float t_fwd = step == 0 ? 0.0f
                          : step == g.K ? (float)(g.K - 1) : step - 0.5f;
      const float t_bwd = step == 0 ? (float)(g.K - 1)
                          : step == g.K ? 0.0f : g.K - 0.5f - step;
      ld += kick<L, C, ABLATE>(wv, s, hbuf, g, edge ? 0.5f : 1.0f, t_fwd,
                               t_bwd);
      if (step == g.K) break;
#pragma unroll 1
      for (int half = 0; half < 2; ++half)
        ld += xhalf<L, C, ABLATE>(mask0, mask1, wx, s, hbuf, g, step,
                                  half == 1, poison);
      plaq_fields(s.Y0, s.Y1, s.SP1, s.CP1, s, g, &pot1, &chg1);
    }

    // energy change from per-site differences, log-det and finiteness
    float e[4] = {0.0f, 0.0f, ld, poison};
    for (int i = tid; i < d; i += nt) {
      const float2 v =
          initial_momenta(rnd.v0s, rnd.v1s, g.seed, b, g.B, n, g.N, d, i);
      e[0] += kinetic_diff(v, s.W0[i], s.W1[i]);
      e[1] += s.CP1[i] - CP[i];
      e[3] += fabsf(s.Y0[i]) + fabsf(s.Y1[i]) + fabsf(s.W0[i]) +
              fabsf(s.W1[i]);
    }
    block_sum<4>(e, s.scratch, s.red);
    const float dh = g.beta * e[1] + 0.5f * e[0] + e[2];
    float prob = expf(dh > 0.0f ? 0.0f : dh);  // NaN stays NaN -> rejected
    if (!isfinite(prob) || !isfinite(e[3])) prob = 0.0f;
    if (s.SC[1] < prob) {
      for (int i = tid; i < d; i += nt) {
        X0[i] = s.Y0[i];
        X1[i] = s.Y1[i];
        SP[i] = s.SP1[i];
        CP[i] = s.CP1[i];
      }
      pot = pot1;
      chg = chg1;
    }

    if (g.hop) {
      // each thread reads only its own sites of the accepted fields here
      const float nu = s.SC[2], uh = s.SC[3];
      float hv[2] = {0.0f, 0.0f};
      for (int i = tid; i < d; i += nt) {
        hv[0] += SP[i];
        hv[1] += (CP[i] < -cd && nu * SP[i] >= 0.0f) ? 1.0f : 0.0f;
      }
      block_sum<2>(hv, s.scratch, s.red);
      const float dsh = one_minus_cd * ((float)d - pot) + nu * sd * hv[0];
      const float m = -g.beta * dsh;
      float ph = expf(m > 0.0f ? 0.0f : m);
      if (!isfinite(ph)) ph = 0.0f;
      const float ah = (uh < ph) ? 1.0f : 0.0f;
      const float an = ah * nu;
      const float cda = 1.0f + ah * cd_minus_one;
      const float sda = an * sd;
      for (int i = tid; i < d; i += nt) {
        float w0, w1;
        winding(i, g.lt, g.lx, delta, seam, &w0, &w1);
        X0[i] = wrap_angle(X0[i] + an * w0);
        X1[i] = wrap_angle(X1[i] + an * w1);
        hop_rotate(SP + i, CP + i, cda, sda);
      }
      pot = pot + ah * dsh;
      chg = chg + an * (1.0f - hv[1]);
    }

    if (tid == 0) {
      const size_t o = (size_t)n * g.B + b;
      plaq_tr[o] = 1.0f - pot / (float)d;
      chg_tr[o] = chg;
      prob_tr[o] = prob;
    }
    __syncthreads();  // fields and scalars settled before the next transition
  }
}

template <int L, int C, bool ABLATE>
int launch(float* x0, float* x1, float* spcp, float* hbuf, const float* wflat,
           const float* mask0, const float* mask1, const LRand& rnd,
           float* plaq, float* chg, float* prob, const Geo& g, size_t smem,
           cudaStream_t stream) {
  auto kernel = l2hmc_local_chain_kernel<L, C, ABLATE>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int nt = ((g.d + 31) / 32) * 32;
  if (nt > kThreads) nt = kThreads;
  kernel<<<g.B, nt, smem, stream>>>(x0, x1, spcp, hbuf, wflat, mask0, mask1,
                                    rnd, plaq, chg, prob, g);
  return (int)cudaGetLastError();
}

// The instantiation of a launch: L = 1, 2 in shared memory, or the deep
// route (the ablated kernel computes no layer, so it runs as L = 1 there).
template <int C>
int launch_c(int L, bool ablate, bool deep, float* x0, float* x1,
             float* spcp, float* hbuf, const float* wflat, const float* mask0,
             const float* mask1, const LRand& rnd, float* plaq, float* chg,
             float* prob, const Geo& g, size_t smem, cudaStream_t st) {
  if (ablate)
    return L == 2 && !deep
               ? launch<2, C, true>(x0, x1, spcp, hbuf, wflat, mask0, mask1,
                                    rnd, plaq, chg, prob, g, smem, st)
               : launch<1, C, true>(x0, x1, spcp, hbuf, wflat, mask0, mask1,
                                    rnd, plaq, chg, prob, g, smem, st);
  if (deep)
    return launch<kDeep, C, false>(x0, x1, spcp, hbuf, wflat, mask0, mask1,
                                   rnd, plaq, chg, prob, g, smem, st);
  return L == 1 ? launch<1, C, false>(x0, x1, spcp, hbuf, wflat, mask0, mask1,
                                      rnd, plaq, chg, prob, g, smem, st)
                : launch<2, C, false>(x0, x1, spcp, hbuf, wflat, mask0, mask1,
                                      rnd, plaq, chg, prob, g, smem, st);
}

}  // namespace

// c: the kernel's channel count (4 or 8, the net padded to it).  deep: the
// deep route (hidden outputs in device memory, no H field); the ablated
// kernel runs its L = 1 instantiation there, within these bytes.
extern "C" size_t l2hmc_local_chain_smem_bytes(int lt, int lx, int c, int L,
                                               int deep) {
  const size_t d = (size_t)lt * lx;
  const size_t fields = 10 * d + (L == 2 && !deep ? (size_t)c * d : 0);
  return sizeof(float) *
         (2 * (size_t)net_stride(c, L) + kWarps * 4 + 4 + 4 + fields);
}

// wflat: both nets' weights (x then v), each in the kernel order of
// ops/l2hmc_kernel.py local_kernel_weights, padded to c channels and to a
// multiple of 4 floats; mask0/mask1 (K, d) binary; spcp (B, 2, d) scratch.
extern "C" int l2hmc_local_chain_launch(
    float* x0, float* x1, float* spcp, float* hbuf, const float* wflat,
    const float* mask0,
    const float* mask1, const float* v0s, const float* v1s, const float* ds,
    const float* us, const float* nus, const float* uhs, float* plaq,
    float* chg, float* prob, int B, int lt, int lx, int K, int N, int c,
    int L, float eps, float beta, int bounded_q, int hop, int ablate,
    int deep, unsigned long long seed, int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  if (B <= 0 || N <= 0) return 0;
  if ((c != 4 && c != 8) || L < 1 || K < 1 || (L > 2 && !deep) ||
      (deep && (L < 2 || (!ablate && hbuf == nullptr))))
    return (int)cudaErrorInvalidValue;
  const LRand rnd{v0s, v1s, ds, us, nus, uhs};
  const Geo g{B, lt, lx, lt * lx, K, N, L, bounded_q, hop, eps, beta, 0.0f,
              seed};
  const size_t smem = l2hmc_local_chain_smem_bytes(lt, lx, c, L, deep);
  const cudaStream_t st = (cudaStream_t)stream;
  if (c == 4)
    return launch_c<4>(L, ablate, deep, x0, x1, spcp, hbuf, wflat, mask0,
                       mask1, rnd, plaq, chg, prob, g, smem, st);
  return launch_c<8>(L, ablate, deep, x0, x1, spcp, hbuf, wflat, mask0, mask1,
                     rnd, plaq, chg, prob, g, smem, st);
}

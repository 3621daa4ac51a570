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
// The conditioner: 1 or 2 periodic 5-point stencil layers (ReLU) of c <= 8
// channels over 6 per-direction input channels, the time encoding as a
// per-chain bias of layer 0, and a 1x1 head to [S0 S1 T0 T1 Q0 Q1].  It is
// weight-shared, so its few hundred weights sit in shared memory and every
// read of one is a broadcast.
//
// What bounds it on an H100: shared memory.  The TPU kernel keeps ~28 + 2c
// live (chains, d) rows per chain tile in VMEM; an SM has 227 KB, and at
// 64x64 one field is 16 KB.  This design keeps one chain per block with ten
// fields (state, proposal, momenta, sin/cos P of state and proposal: 160 KB
// at 64x64) and stores no conditioner input: a site's layer-0 output is
// computed from its five neighbours' inputs, which are rebuilt from the
// proposal, momenta and sin P fields (cos/sin of the neighbours' links, the
// force from sin P) at each use.  Two layers add the c layer-0 output
// fields (c = 4: 224 KB in all).  A position half-update writes only sites
// its mask moves, and reads the links only at sites the mask holds, so it
// runs in place.  One block per SM is resident; 512 threads each own
// d / 512 sites, so instruction throughput bounds it: per site and
// conditioner call about 10 sincos, 150 FMA and as many broadcast weight
// reads, 3K+1 calls per transition, a barrier after each.  Each phase
// (kick, position half-update, force) has one call site in the transition
// loop, so one inlined copy; the depth L is a template parameter.
//
// The carried sin/cos plaquette fields are rotated, not recomputed, after
// an accepted hop (hop_rotate in chain_common.cuh rounds as the plain
// version does), and block sums are float32 as in the plain version: kernel
// and plain version agree to ~4e-5 on accept probabilities at 64x64.
//
// The cost-decomposition mode (template ABLATE, as in l2hmc_chain.cu)
// compiles out the stencil layers, the head and the neighbours' sincosf of
// the conditioner inputs, and reads S = T = Q from a kernel argument that
// the wrapper sets to 0, so nvcc cannot fold them into the exp factors and
// the circle map; the rest of the transition runs as in the full kernel, for
// L = 1 and L = 2.
//
// Randomness: injected arrays (v0s, v1s, ds, us[, nus, uhs]), or
// Philox4_32_10 keyed by (chain, transition) with the seed drawn by the
// caller, as in l2hmc_chain.cu.

#include "chain_common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxC = 8;   // most stencil channels
constexpr int kCin = 6;    // layer-0 input channels (u1)
constexpr int kOff = 5;    // stencil points
constexpr double kPiD = 3.141592653589793;

// Floats of one net's weights, flattened in the order of
// ops/l2hmc_kernel.py local_weight_names: s0w (5, 6, c), s0t (2, c),
// s0b (c), [s1w (5, c, c), s1b (c)], hw (c, 6), hb (6), cs (2), ct (2).
__host__ __device__ inline int net_floats(int c, int L) {
  return kOff * kCin * c + 2 * c + c + (L >= 2 ? kOff * c * c + c : 0) +
         6 * c + 6 + 2 + 2;
}

struct NetW {
  const float *s0w, *s0t, *s0b, *s1w, *s1b, *hw, *hb, *cs, *ct;
};

__device__ __forceinline__ NetW net_at(const float* p, int c, int L) {
  NetW w;
  w.s0w = p;
  p += kOff * kCin * c;
  w.s0t = p;
  p += 2 * c;
  w.s0b = p;
  p += c;
  w.s1w = p;
  w.s1b = p + kOff * c * c;
  if (L >= 2) p += kOff * c * c + c;
  w.hw = p;
  p += 6 * c;
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
  int B, lt, lx, d, K, N, c, bounded_q, hop;
  float eps, beta;
  float ablated_stq;  // S = T = Q of the ablated kernel: 0, not a constant
  unsigned long long seed;
};

// SC = {direction, accept uniform, hop winding sign, hop uniform}
struct Smem {
  float *scratch, *red, *SC;  // block sums, per-chain scalars
  float *X0, *X1, *Y0, *Y1, *W0, *W1, *SP, *CP, *SP1, *CP1;  // d each
  float* H;                   // (c, d) layer-0 outputs, two layers only
  float *WX, *WV;             // net weights
};

__device__ __forceinline__ Smem carve(float* smem, int d, int c, int L) {
  Smem s;
  s.scratch = smem;
  s.red = s.scratch + kWarps * 4;
  s.SC = s.red + 4;
  s.X0 = s.SC + 4;
  s.X1 = s.X0 + d;
  s.Y0 = s.X1 + d;
  s.Y1 = s.Y0 + d;
  s.W0 = s.Y1 + d;
  s.W1 = s.W0 + d;
  s.SP = s.W1 + d;
  s.CP = s.SP + d;
  s.SP1 = s.CP + d;
  s.CP1 = s.SP1 + d;
  s.H = s.CP1 + d;
  s.WX = s.H + (L >= 2 ? (size_t)c * d : 0);
  s.WV = s.WX + net_floats(c, L);
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

// VNet layer-0 inputs at (t, s): [cos y0, cos y1, sin y0, sin y1, g0, g1]
// with g the force beta * dS/du from the proposal's sine field.
struct VnetIn {
  const float *Y0, *Y1, *SP1;
  int lt, lx;
  float beta;
  __device__ __forceinline__ void operator()(int t, int s,
                                             float (&x)[kCin]) const {
    const int j = t * lx + s;
    float s0, c0, s1, c1;
    sincosf(Y0[j], &s0, &c0);
    sincosf(Y1[j], &s1, &c1);
    const float sp = SP1[j];
    x[0] = c0;
    x[1] = c1;
    x[2] = s0;
    x[3] = s1;
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

// XNet layer-0 inputs at (t, s): [w0, w1, m0 cos y0, m1 cos y1, m0 sin y0,
// m1 sin y1].  Links are read only where held (m = 1): the half-update
// rewrites the others concurrently.
struct XnetIn {
  const float *Y0, *Y1, *W0, *W1;
  Hold h0, h1;
  int lx;
  __device__ __forceinline__ void operator()(int t, int s,
                                             float (&x)[kCin]) const {
    const int j = t * lx + s;
    const float m0 = h0(j), m1 = h1(j);
    float s0 = 0.0f, c0 = 0.0f, s1 = 0.0f, c1 = 0.0f;
    if (m0 != 0.0f) sincosf(Y0[j], &s0, &c0);
    if (m1 != 0.0f) sincosf(Y1[j], &s1, &c1);
    x[0] = W0[j];
    x[1] = W1[j];
    x[2] = m0 * c0;
    x[3] = m1 * c1;
    x[4] = m0 * s0;
    x[5] = m1 * s1;
  }
};

// Layer 0 at (t, s): relu(b + tau . wt + sum_{o, ci} w[o, ci, :] in_ci(o)).
template <class In>
__device__ __forceinline__ void layer0(const NetW& w, int c, int t, int s,
                                       int lt, int lx, float tau0,
                                       float tau1, const In& in,
                                       float (&acc)[kMaxC]) {
#pragma unroll
  for (int j = 0; j < kMaxC; ++j)
    if (j < c) acc[j] = w.s0b[j] + (tau0 * w.s0t[j] + tau1 * w.s0t[c + j]);
#pragma unroll
  for (int o = 0; o < kOff; ++o) {
    int to, so;
    stencil_point(t, s, o, lt, lx, &to, &so);
    float x[kCin];
    in(to, so, x);
#pragma unroll
    for (int ci = 0; ci < kCin; ++ci) {
      const float* wr = w.s0w + (o * kCin + ci) * c;
#pragma unroll
      for (int j = 0; j < kMaxC; ++j)
        if (j < c) acc[j] = fmaf(wr[j], x[ci], acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < kMaxC; ++j)
    if (j < c) acc[j] = fmaxf(acc[j], 0.0f);
}

// Layer 1 at (t, s) from the layer-0 output fields H (c, d).
__device__ __forceinline__ void layer1(const NetW& w, int c, int t, int s,
                                       int lt, int lx, const float* H,
                                       int d, float (&acc)[kMaxC]) {
#pragma unroll
  for (int j = 0; j < kMaxC; ++j)
    if (j < c) acc[j] = w.s1b[j];
#pragma unroll
  for (int o = 0; o < kOff; ++o) {
    int to, so;
    stencil_point(t, s, o, lt, lx, &to, &so);
    const int jn = to * lx + so;
#pragma unroll
    for (int ci = 0; ci < kMaxC; ++ci) {
      if (ci >= c) break;
      const float hv = H[ci * d + jn];
      const float* wr = w.s1w + (o * c + ci) * c;
#pragma unroll
      for (int j = 0; j < kMaxC; ++j)
        if (j < c) acc[j] = fmaf(wr[j], hv, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < kMaxC; ++j)
    if (j < c) acc[j] = fmaxf(acc[j], 0.0f);
}

// 1x1 head and combines: per direction r, (S, T, Q).
__device__ __forceinline__ void head(const NetW& w, int c, bool bounded_q,
                                     const float (&y)[kMaxC], float (&S)[2],
                                     float (&T)[2], float (&Q)[2]) {
  float hd[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    float a = w.hb[k];
#pragma unroll
    for (int ci = 0; ci < kMaxC; ++ci)
      if (ci < c) a = fmaf(w.hw[ci * 6 + k], y[ci], a);
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

// Layer-0 outputs of every site into H (two-layer nets, first phase).
template <class In>
__device__ __forceinline__ void fill_h(const NetW& w, const Smem& s,
                                       const Geo& g, float tau0, float tau1,
                                       const In& in) {
  for (int i = threadIdx.x; i < g.d; i += blockDim.x) {
    const int t = i / g.lx, sx = i - t * g.lx;
    float acc[kMaxC];
    layer0(w, g.c, t, sx, g.lt, g.lx, tau0, tau1, in, acc);
#pragma unroll
    for (int j = 0; j < kMaxC; ++j)
      if (j < g.c) s.H[j * g.d + i] = acc[j];
  }
  __syncthreads();
}

// Last hidden layer's output at site i = (t, sx).
template <int L, class In>
__device__ __forceinline__ void hidden_at(const NetW& w, const Smem& s,
                                          const Geo& g, int t, int sx,
                                          float tau0, float tau1,
                                          const In& in, float (&y)[kMaxC]) {
  if constexpr (L >= 2)
    layer1(w, g.c, t, sx, g.lt, g.lx, s.H, g.d, y);
  else
    layer0(w, g.c, t, sx, g.lt, g.lx, tau0, tau1, in, y);
}

// Merged momentum kick (update_v), direction-fused, from the proposal's
// links and force.  Writes only the momenta, which the VNet does not read.
// Returns this thread's log-det terms.
template <int L, bool ABLATE>
__device__ __forceinline__ float kick(const NetW& w, const Smem& s,
                                      const Geo& g, float factor, float t_fwd,
                                      float t_bwd) {
  float ld = 0.0f;
  const float dsg = s.SC[0];
  float tau0, tau1;
  time_enc(dsg > 0.0f ? t_fwd : t_bwd, g.K, &tau0, &tau1);
  const VnetIn in{s.Y0, s.Y1, s.SP1, g.lt, g.lx, g.beta};
  if constexpr (L >= 2 && !ABLATE) fill_h(w, s, g, tau0, tau1, in);
  const float fe = factor * g.eps;
  for (int i = threadIdx.x; i < g.d; i += blockDim.x) {
    const float z = g.ablated_stq;
    float S[2] = {z, z}, T[2] = {z, z}, Q[2] = {z, z};
    if constexpr (!ABLATE) {
      const int t = i / g.lx, sx = i - t * g.lx;
      float y[kMaxC];
      hidden_at<L>(w, s, g, t, sx, tau0, tau1, in, y);
      head(w, g.c, g.bounded_q, y, S, T, Q);
    }
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
template <int L, bool ABLATE>
__device__ __forceinline__ float xhalf(const float* mask0, const float* mask1,
                                       const NetW& w, const Smem& s,
                                       const Geo& g, int step, bool second,
                                       float& poison) {
  float ld = 0.0f;
  const float dsg = s.SC[0];
  const bool fwd = dsg > 0.0f;
  const int row = fwd ? step : g.K - 1 - step;
  const bool flip = fwd == second;
  const Hold h0{mask0 + (size_t)row * g.d, flip};
  const Hold h1{mask1 + (size_t)row * g.d, flip};
  float tau0, tau1;
  time_enc(fwd ? (float)step : (float)(g.K - 1 - step), g.K, &tau0, &tau1);
  const XnetIn in{s.Y0, s.Y1, s.W0, s.W1, h0, h1, g.lx};
  if constexpr (L >= 2 && !ABLATE) fill_h(w, s, g, tau0, tau1, in);
  for (int i = threadIdx.x; i < g.d; i += blockDim.x) {
    const float z = g.ablated_stq;
    float S[2] = {z, z}, T[2] = {z, z}, Q[2] = {z, z};
    if constexpr (!ABLATE) {
      const int t = i / g.lx, sx = i - t * g.lx;
      float y[kMaxC];
      hidden_at<L>(w, s, g, t, sx, tau0, tau1, in, y);
      head(w, g.c, g.bounded_q, y, S, T, Q);
    }
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

// Plaquette sine/cosine of the proposal into SP1/CP1; returns the potential
// and the unrounded charge.
__device__ __forceinline__ void proposal_fields(const Smem& s,
                                                const Geo& g, float* pot1,
                                                float* chg1) {
  float v[2] = {0.0f, 0.0f};
  for (int i = threadIdx.x; i < g.d; i += blockDim.x) {
    float sn, cs;
    const float p = plaq_angle(s.Y0, s.Y1, i, g.lt, g.lx);
    sincosf(p, &sn, &cs);
    s.SP1[i] = sn;
    s.CP1[i] = cs;
    v[0] += 1.0f - cs;
    v[1] += wrap_angle(p);
  }
  block_sum<2>(v, s.scratch, s.red);
  *pot1 = v[0];
  *chg1 = v[1] * CHAIN_INV_TWO_PI_F;
}

template <int L, bool ABLATE>
__global__ void __launch_bounds__(kThreads)
l2hmc_local_chain_kernel(float* __restrict__ x0g, float* __restrict__ x1g,
                         const float* __restrict__ wflat,
                         const float* __restrict__ mask0,
                         const float* __restrict__ mask1, LRand rnd,
                         float* __restrict__ plaq_tr,
                         float* __restrict__ chg_tr,
                         float* __restrict__ prob_tr, Geo g) {
  extern __shared__ float smem[];
  const int d = g.d;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int b = blockIdx.x;
  const Smem s = carve(smem, d, g.c, L);
  const bool injected = rnd.v0s != nullptr;

  const double dd = (double)d;
  const float cd = (float)cos(2.0 * kPiD / dd);
  const float sd = (float)sin(2.0 * kPiD / dd);
  const float one_minus_cd = (float)(1.0 - cos(2.0 * kPiD / dd));
  const float cd_minus_one = (float)(cos(2.0 * kPiD / dd) - 1.0);
  const float delta = (float)(2.0 * kPiD / dd);
  const float seam = (float)(-(2.0 * kPiD / dd) * g.lt);

  const int nwf = 2 * net_floats(g.c, L);
  for (int k = tid; k < nwf; k += nt) s.WX[k] = wflat[k];
  const size_t base = (size_t)b * d;
  for (int i = tid; i < d; i += nt) {
    s.X0[i] = x0g[base + i];
    s.X1[i] = x1g[base + i];
  }
  __syncthreads();
  const NetW wx = net_at(s.WX, g.c, L);
  const NetW wv = net_at(s.WV, g.c, L);

  float pot, chg;
  {
    float v[2] = {0.0f, 0.0f};
    for (int i = tid; i < d; i += nt) {
      float sn, cs;
      const float p = plaq_angle(s.X0, s.X1, i, g.lt, g.lx);
      sincosf(p, &sn, &cs);
      s.SP[i] = sn;
      s.CP[i] = cs;
      v[0] += 1.0f - cs;
      v[1] += wrap_angle(p);
    }
    block_sum<2>(v, s.scratch, s.red);
    pot = v[0];
    chg = v[1] * CHAIN_INV_TWO_PI_F;
  }

  for (int n = 0; n < g.N; ++n) {
    float ld = 0.0f, poison = 0.0f;
    for (int i = tid; i < d; i += nt) {
      const float2 v =
          initial_momenta(rnd.v0s, rnd.v1s, g.seed, b, g.B, n, g.N, d, i);
      s.W0[i] = v.x;
      s.W1[i] = v.y;
      s.Y0[i] = s.X0[i];
      s.Y1[i] = s.X1[i];
      s.SP1[i] = s.SP[i];
      s.CP1[i] = s.CP[i];
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
      ld += kick<L, ABLATE>(wv, s, g, edge ? 0.5f : 1.0f, t_fwd, t_bwd);
      if (step == g.K) break;
#pragma unroll 1
      for (int half = 0; half < 2; ++half)
        ld += xhalf<L, ABLATE>(mask0, mask1, wx, s, g, step, half == 1,
                               poison);
      proposal_fields(s, g, &pot1, &chg1);
    }

    // energy change from per-site differences, log-det and finiteness
    float e[4] = {0.0f, 0.0f, ld, poison};
    for (int i = tid; i < d; i += nt) {
      const float2 v =
          initial_momenta(rnd.v0s, rnd.v1s, g.seed, b, g.B, n, g.N, d, i);
      e[0] += kinetic_diff(v, s.W0[i], s.W1[i]);
      e[1] += s.CP1[i] - s.CP[i];
      e[3] += fabsf(s.Y0[i]) + fabsf(s.Y1[i]) + fabsf(s.W0[i]) +
              fabsf(s.W1[i]);
    }
    block_sum<4>(e, s.scratch, s.red);
    const float dh = g.beta * e[1] + 0.5f * e[0] + e[2];
    float prob = expf(dh > 0.0f ? 0.0f : dh);  // NaN stays NaN -> rejected
    if (!isfinite(prob) || !isfinite(e[3])) prob = 0.0f;
    if (s.SC[1] < prob) {
      for (int i = tid; i < d; i += nt) {
        s.X0[i] = s.Y0[i];
        s.X1[i] = s.Y1[i];
        s.SP[i] = s.SP1[i];
        s.CP[i] = s.CP1[i];
      }
      pot = pot1;
      chg = chg1;
    }

    if (g.hop) {
      // each thread reads only its own sites of the accepted fields here
      const float nu = s.SC[2], uh = s.SC[3];
      float hv[2] = {0.0f, 0.0f};
      for (int i = tid; i < d; i += nt) {
        hv[0] += s.SP[i];
        hv[1] += (s.CP[i] < -cd && nu * s.SP[i] >= 0.0f) ? 1.0f : 0.0f;
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
        s.X0[i] = wrap_angle(s.X0[i] + an * w0);
        s.X1[i] = wrap_angle(s.X1[i] + an * w1);
        hop_rotate(s.SP + i, s.CP + i, cda, sda);
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

  for (int i = tid; i < d; i += nt) {
    x0g[base + i] = s.X0[i];
    x1g[base + i] = s.X1[i];
  }
}

}  // namespace

extern "C" size_t l2hmc_local_chain_smem_bytes(int lt, int lx, int c, int L) {
  const size_t d = (size_t)lt * lx;
  const size_t fields = 10 * d + (L >= 2 ? (size_t)c * d : 0);
  return sizeof(float) *
         (kWarps * 4 + 4 + 4 + fields + 2 * (size_t)net_floats(c, L));
}

// wflat: both nets' weights (x then v), each flattened in the order of
// ops/l2hmc_kernel.py local_weight_names; mask0/mask1 (K, d) binary.
extern "C" int l2hmc_local_chain_launch(
    float* x0, float* x1, const float* wflat, const float* mask0,
    const float* mask1, const float* v0s, const float* v1s, const float* ds,
    const float* us, const float* nus, const float* uhs, float* plaq,
    float* chg, float* prob, int B, int lt, int lx, int K, int N, int c,
    int L, float eps, float beta, int bounded_q, int hop, int ablate,
    unsigned long long seed, int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  if (B <= 0 || N <= 0) return 0;
  if (c < 1 || c > kMaxC || L < 1 || L > 2 || K < 1)
    return (int)cudaErrorInvalidValue;
  const LRand rnd{v0s, v1s, ds, us, nus, uhs};
  const Geo g{B, lt, lx, lt * lx, K, N, c, bounded_q, hop, eps, beta, 0.0f,
              seed};
  const size_t smem = l2hmc_local_chain_smem_bytes(lt, lx, c, L);
  auto kernel = L == 1 ? (ablate ? l2hmc_local_chain_kernel<1, true>
                                 : l2hmc_local_chain_kernel<1, false>)
                       : (ablate ? l2hmc_local_chain_kernel<2, true>
                                 : l2hmc_local_chain_kernel<2, false>);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int d = lt * lx;
  int nt = ((d + 31) / 32) * 32;
  if (nt > kThreads) nt = kThreads;
  kernel<<<B, nt, smem, (cudaStream_t)stream>>>(x0, x1, wflat, mask0, mask1,
                                                rnd, plaq, chg, prob, g);
  return (int)cudaGetLastError();
}

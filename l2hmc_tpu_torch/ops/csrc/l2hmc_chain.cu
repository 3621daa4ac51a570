// Fused TRAINED L2HMC chain (MLP conditioners, U(1), merge_v_halves):
// N transitions of C = 2 chains per block in one launch.
//
// Replaces the TPU kernel l2hmc_tpu/ops/l2hmc_kernel.py:_build_kernel
// (entry l2hmc_chain_pallas).  Each transition, per chain: fresh momenta and
// direction, K+1 merged VNet momentum kicks and 2K masked XNet circle-scaling
// position half-updates with the exact log-Jacobian, the Wilson force after
// every step, the MH accept with non-finite rejection, and optionally one
// exact instanton hop from the carried plaquette fields.  Only the final
// links and three (N, B) traces reach device memory.
//
// What bounds it on an H100: the conditioner products.  Per transition a
// chain runs 3K+1 MLP calls of (6d x h) + (h x h) + (h x 6d) multiply-adds
// (about 0.4 MFLOP each at 16x16, h=64), all in f32 FMA loops written here.
// The weights (about 1.6 MB for both nets) do not fit in shared memory, so
// every call streams them from L2; the design has C chains share one block
// so that each weight read feeds C chains (C FMAs per load), keeps the
// features / head outputs (C x 6d) and all chain fields in dynamic shared
// memory, and splits the deep input product over thread groups (split-K)
// so all 256 threads work on an h=64 wide output.  A larger C cuts L2
// traffic but needs 16 d floats of shared memory per chain and more
// registers, so fewer blocks stay resident per SM to hide the barriers; at
// 16x16 h64, C = 2 is faster than 1, 4 and 8 on an H100 (PERF.md).  Tensor
// cores (wgmma, bf16) and TMA weight staging are later work.
//
// Randomness: injected arrays (v0s, v1s, ds, us[, nus, uhs]), or
// Philox4_32_10 keyed by (chain, transition) with the seed drawn by the
// caller.

#include "chain_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int C = 2;  // chains per block
constexpr double kPiD = 3.141592653589793;

struct NetW {
  const float *in, *t, *b, *hw, *hb, *head, *headb0, *headb1;
  const float *cs0, *cs1, *ct0, *ct1;
};

struct Weights {
  NetW x, v;
  const float *mask0, *mask1;  // (K, d) each
};

struct L2Rand {
  const float *v0s, *v1s, *ds, *us, *nus, *uhs;
};

struct Geo {
  int B, lt, lx, d, K, N, h, bounded_q, hop;
  float eps, beta;
  unsigned long long seed;
};

// Per-chain scalars in shared memory: SC[c * 4 + {0: direction, 1: accept
// uniform, 2: hop winding sign, 3: hop uniform}], TAU[c * 2 + {cos, sin}].
struct Smem {
  float *X0, *X1, *Y0, *Y1, *W0, *W1, *SP, *CP, *SP1, *CP1;  // (C, d) each
  float *BUF;            // (C, 6d): features in, head outputs out
  float *HID1, *HID2;    // (C, h)
  float *RED;            // (C * max(threads, h)) split-K partials
  float *scratch, *red;  // block reductions
  float *SC, *TAU;
};

__device__ __forceinline__ Smem carve(float* smem, int d, int h) {
  Smem s;
  const size_t cd = (size_t)C * d;
  s.X0 = smem;
  s.X1 = s.X0 + cd;
  s.Y0 = s.X1 + cd;
  s.Y1 = s.Y0 + cd;
  s.W0 = s.Y1 + cd;
  s.W1 = s.W0 + cd;
  s.SP = s.W1 + cd;
  s.CP = s.SP + cd;
  s.SP1 = s.CP + cd;
  s.CP1 = s.SP1 + cd;
  s.BUF = s.CP1 + cd;
  s.HID1 = s.BUF + 6 * cd;
  s.HID2 = s.HID1 + C * h;
  s.RED = s.HID2 + C * h;
  s.scratch = s.RED + C * (h > kThreads ? h : kThreads);
  s.red = s.scratch + CHAIN_MAX_WARPS * 4 * C;
  s.SC = s.red + 4 * C;
  s.TAU = s.SC + 4 * C;
  return s;
}

// One MLP conditioner call on the C feature rows in BUF; the head outputs
// [S0 | T0 | Q0 | S1 | T1 | Q1] (bias added) overwrite BUF.
__device__ void mlp(const NetW& w, const Smem& s, int d, int h) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int D6 = 6 * d, D3 = 3 * d;
  const int P = nt / h > 0 ? nt / h : 1;
  const int kpart = (D6 + P - 1) / P;

  // (C, 6d) @ (6d, h), split-K over P thread groups: each weight load
  // feeds C chains
  for (int col = tid; col < P * h; col += nt) {
    const int j = col % h, p = col / h;
    const int k0 = p * kpart, k1 = min(D6, k0 + kpart);
    float acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.0f;
    for (int k = k0; k < k1; ++k) {
      const float wv = __ldg(w.in + (size_t)k * h + j);
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] = fmaf(s.BUF[c * D6 + k], wv, acc[c]);
    }
#pragma unroll
    for (int c = 0; c < C; ++c) s.RED[(p * C + c) * h + j] = acc[c];
  }
  __syncthreads();
  for (int o = tid; o < C * h; o += nt) {
    const int c = o / h, j = o - c * h;
    float acc = 0.0f;
    for (int p = 0; p < P; ++p) acc += s.RED[(p * C + c) * h + j];
    const float tt = s.TAU[2 * c] * w.t[j] + s.TAU[2 * c + 1] * w.t[h + j];
    s.HID1[o] = fmaxf(acc + tt + w.b[j], 0.0f);
  }
  __syncthreads();
  // (C, h) @ (h, h) trunk
  for (int o = tid; o < C * h; o += nt) {
    const int c = o / h, j = o - c * h;
    float acc = 0.0f;
    for (int k = 0; k < h; ++k)
      acc = fmaf(s.HID1[c * h + k], __ldg(w.hw + (size_t)k * h + j), acc);
    s.HID2[o] = fmaxf(acc + w.hb[j], 0.0f);
  }
  __syncthreads();
  // (C, h) @ (h, 6d) merged heads of both directions
  for (int n = tid; n < D6; n += nt) {
    float acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.0f;
    for (int k = 0; k < h; ++k) {
      const float wv = __ldg(w.head + (size_t)k * D6 + n);
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] = fmaf(s.HID2[c * h + k], wv, acc[c]);
    }
    const float hb = n < D3 ? w.headb0[n] : w.headb1[n - D3];
#pragma unroll
    for (int c = 0; c < C; ++c) s.BUF[c * D6 + n] = acc[c] + hb;
  }
  __syncthreads();
}

__device__ __forceinline__ void time_enc(float idx, int K, float* tau) {
  const float ang = CHAIN_TWO_PI_F * idx / (float)K;
  tau[0] = cosf(ang);
  tau[1] = sinf(ang);
}

// Merged momentum kick (update_v), direction-fused.  The force is
// beta * grad(SP1), SP1 being the sine field of the current proposal.
__device__ void kick(const Weights& W, const Smem& s, const Geo& g, int nc,
                     float factor, float t_fwd, float t_bwd, float (&ldp)[C]) {
  const int tid = threadIdx.x, nt = blockDim.x, d = g.d, D6 = 6 * d;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (c >= nc) break;
    const float* y0 = s.Y0 + c * d;
    const float* y1 = s.Y1 + c * d;
    const float* sp = s.SP1 + c * d;
    float* f = s.BUF + c * D6;
    for (int i = tid; i < d; i += nt) {
      float s0, c0, s1, c1;
      sincosf(y0[i], &s0, &c0);
      sincosf(y1[i], &s1, &c1);
      f[i] = c0;
      f[d + i] = c1;
      f[2 * d + i] = s0;
      f[3 * d + i] = s1;
      f[4 * d + i] = g.beta * grad0(sp, i, g.lt, g.lx);
      f[5 * d + i] = g.beta * grad1(sp, i, g.lt, g.lx);
    }
  }
  if (tid < nc)
    time_enc(s.SC[tid * 4] > 0.0f ? t_fwd : t_bwd, g.K, s.TAU + 2 * tid);
  __syncthreads();
  mlp(W.v, s, d, g.h);

  const float fe = factor * g.eps;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (c >= nc) break;
    const float dsg = s.SC[c * 4];
    const float* sp = s.SP1 + c * d;
    for (int i = tid; i < d; i += nt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float* hd = s.BUF + c * D6 + r * 3 * d;
        const float* cs = r ? W.v.cs1 : W.v.cs0;
        const float* ct = r ? W.v.ct1 : W.v.ct0;
        const float sv = tanhf(hd[i]) * expf(cs[i]);
        const float tv = hd[d + i];
        const float qr = hd[2 * d + i];
        const float qv = (g.bounded_q ? tanhf(qr) : qr) * expf(ct[i]);
        const float gg = g.beta * (r ? grad1(sp, i, g.lt, g.lx)
                                     : grad0(sp, i, g.lt, g.lx));
        const float hs = fe * sv;
        const float a = fe * (expf(g.eps * qv) * gg - tv);
        const float e = expf(dsg * hs);
        float* w = (r ? s.W1 : s.W0) + c * d + i;
        *w = dsg > 0.0f ? *w * e - a : (*w + a) * e;
        ldp[c] += dsg * hs;
      }
    }
  }
  __syncthreads();
}

// One masked position half-update on the torus (update_x, u1 branch).
// hold = (fwd ? mask[step] : 1 - mask[K-1-step]), inverted for the second
// half-update of the step.
__device__ void xhalf(const Weights& W, const Smem& s, const Geo& g, int nc,
                      int step, bool second, float (&ldp)[C]) {
  const int tid = threadIdx.x, nt = blockDim.x, d = g.d, D6 = 6 * d, K = g.K;
  const float* mf0 = W.mask0 + (size_t)step * d;
  const float* mf1 = W.mask1 + (size_t)step * d;
  const float* mb0 = W.mask0 + (size_t)(K - 1 - step) * d;
  const float* mb1 = W.mask1 + (size_t)(K - 1 - step) * d;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (c >= nc) break;
    const bool fwd = s.SC[c * 4] > 0.0f;
    float* f = s.BUF + c * D6;
    for (int i = tid; i < d; i += nt) {
      float h0 = fwd ? mf0[i] : 1.0f - mb0[i];
      float h1 = fwd ? mf1[i] : 1.0f - mb1[i];
      if (second) {
        h0 = 1.0f - h0;
        h1 = 1.0f - h1;
      }
      float s0, c0, s1, c1;
      sincosf(s.Y0[c * d + i], &s0, &c0);
      sincosf(s.Y1[c * d + i], &s1, &c1);
      f[i] = s.W0[c * d + i];
      f[d + i] = s.W1[c * d + i];
      f[2 * d + i] = h0 * c0;
      f[3 * d + i] = h1 * c1;
      f[4 * d + i] = h0 * s0;
      f[5 * d + i] = h1 * s1;
    }
  }
  if (tid < nc)
    time_enc(s.SC[tid * 4] > 0.0f ? (float)step : (float)(K - 1 - step), K,
             s.TAU + 2 * tid);
  __syncthreads();
  mlp(W.x, s, d, g.h);

#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (c >= nc) break;
    const float dsg = s.SC[c * 4];
    const bool fwd = dsg > 0.0f;
    for (int i = tid; i < d; i += nt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float* mf = r ? mf1 : mf0;
        const float* mb = r ? mb1 : mb0;
        float hold = fwd ? mf[i] : 1.0f - mb[i];
        if (second) hold = 1.0f - hold;
        const float* hd = s.BUF + c * D6 + r * 3 * d;
        const float* cs = r ? W.x.cs1 : W.x.cs0;
        const float* ct = r ? W.x.ct1 : W.x.ct0;
        const float sv = tanhf(hd[i]) * expf(cs[i]);
        const float tv = hd[d + i];
        const float qr = hd[2 * d + i];
        const float qv = (g.bounded_q ? tanhf(qr) : qr) * expf(ct[i]);
        float* yp = (r ? s.Y1 : s.Y0) + c * d + i;
        const float w = (r ? s.W1 : s.W0)[c * d + i];
        const float y = *yp;
        const float es = g.eps * sv;
        const float bb = g.eps * (expf(g.eps * qv) * w + tv);
        const float u_in = fwd ? y : wrap_angle(y - bb);
        // circle_scale(u_in, dsg * es): 2 atan2(e^a sin(x/2), cos(x/2))
        const float a = dsg * es;
        float s2, c2;
        sincosf(0.5f * u_in, &s2, &c2);
        const float ea = expf(a);
        const float y2 = 2.0f * atan2f(ea * s2, c2);
        const float lde = a - logf(c2 * c2 + ea * ea * s2 * s2);
        const float upd = fwd ? wrap_angle(y2 + bb) : y2;
        *yp = hold * y + (1.0f - hold) * upd;
        ldp[c] += (1.0f - hold) * lde;
      }
    }
  }
  __syncthreads();
}

// Plaquette sine/cosine fields of the C proposals into SP1/CP1; returns the
// potentials and unrounded charges.
__device__ void proposal_fields(const Smem& s, const Geo& g, int nc,
                                float (&pot1)[C], float (&chg1)[C]) {
  const int tid = threadIdx.x, nt = blockDim.x, d = g.d;
  float v[2 * C];
#pragma unroll
  for (int k = 0; k < 2 * C; ++k) v[k] = 0.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (c >= nc) break;
    for (int i = tid; i < d; i += nt) {
      float sn, cs;
      const float p = plaq_angle(s.Y0 + c * d, s.Y1 + c * d, i, g.lt, g.lx);
      sincosf(p, &sn, &cs);
      s.SP1[c * d + i] = sn;
      s.CP1[c * d + i] = cs;
      v[c] += 1.0f - cs;
      v[C + c] += wrap_angle(p);
    }
  }
  block_sum<2 * C>(v, s.scratch, s.red);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    pot1[c] = v[c];
    chg1[c] = v[C + c] * CHAIN_INV_TWO_PI_F;
  }
}

__global__ void __launch_bounds__(kThreads)
l2hmc_chain_kernel(float* __restrict__ x0g, float* __restrict__ x1g,
                   Weights W, L2Rand rnd, float* __restrict__ plaq_tr,
                   float* __restrict__ chg_tr, float* __restrict__ prob_tr,
                   Geo g) {
  extern __shared__ float smem[];
  const int d = g.d, K = g.K, B = g.B;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int b0 = blockIdx.x * C;
  const int nc = min(C, B - b0);
  const Smem s = carve(smem, d, g.h);
  const bool injected = rnd.v0s != nullptr;

  const double dd = (double)d;
  const float cd = (float)cos(2.0 * kPiD / dd);
  const float sd = (float)sin(2.0 * kPiD / dd);
  const float one_minus_cd = (float)(1.0 - cos(2.0 * kPiD / dd));
  const float cd_minus_one = (float)(cos(2.0 * kPiD / dd) - 1.0);
  const float delta = (float)(2.0 * kPiD / dd);
  const float seam = (float)(-(2.0 * kPiD / dd) * g.lt);

  for (int c = 0; c < nc; ++c) {
    for (int i = tid; i < d; i += nt) {
      s.X0[c * d + i] = x0g[(size_t)(b0 + c) * d + i];
      s.X1[c * d + i] = x1g[(size_t)(b0 + c) * d + i];
    }
  }
  __syncthreads();

  float pot[C], chg[C];
  {
    float v[2 * C];
#pragma unroll
    for (int k = 0; k < 2 * C; ++k) v[k] = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (c >= nc) break;
      for (int i = tid; i < d; i += nt) {
        float sn, cs;
        const float p = plaq_angle(s.X0 + c * d, s.X1 + c * d, i, g.lt, g.lx);
        sincosf(p, &sn, &cs);
        s.SP[c * d + i] = sn;
        s.CP[c * d + i] = cs;
        v[c] += 1.0f - cs;
        v[C + c] += wrap_angle(p);
      }
    }
    block_sum<2 * C>(v, s.scratch, s.red);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      pot[c] = v[c];
      chg[c] = v[C + c] * CHAIN_INV_TWO_PI_F;
    }
  }

  for (int n = 0; n < g.N; ++n) {
    float ldp[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      ldp[c] = 0.0f;
      if (c >= nc) continue;
      for (int i = tid; i < d; i += nt) {
        const float2 v = initial_momenta(rnd.v0s, rnd.v1s, g.seed, b0 + c,
                                         B, n, g.N, d, i);
        const int o = c * d + i;
        s.W0[o] = v.x;
        s.W1[o] = v.y;
        s.Y0[o] = s.X0[o];
        s.Y1[o] = s.X1[o];
        s.SP1[o] = s.SP[o];
        s.CP1[o] = s.CP[o];
      }
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
    for (int step = 0; step < K; ++step) {
      const bool first = step == 0;
      kick(W, s, g, nc, first ? 0.5f : 1.0f, first ? 0.0f : step - 0.5f,
           first ? (float)(K - 1) : K - 0.5f - step, ldp);
      xhalf(W, s, g, nc, step, false, ldp);
      xhalf(W, s, g, nc, step, true, ldp);
      proposal_fields(s, g, nc, pot1, chg1);
    }
    // closing half kick at trajectory time K-1 (fwd) / 0 (bwd)
    kick(W, s, g, nc, 0.5f, (float)(K - 1), 0.0f, ldp);

    // energy change from per-site differences (no float32 cancellation of
    // the two ~1e3 Hamiltonians), log-det and finiteness, one reduction
    float e[4 * C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      e[c] = 0.0f;
      e[C + c] = 0.0f;
      e[2 * C + c] = ldp[c];
      e[3 * C + c] = 0.0f;
      if (c >= nc) continue;
      for (int i = tid; i < d; i += nt) {
        const int o = c * d + i;
        const float2 v = initial_momenta(rnd.v0s, rnd.v1s, g.seed, b0 + c,
                                         B, n, g.N, d, i);
        e[c] += kinetic_diff(v, s.W0[o], s.W1[o]);
        e[C + c] += s.CP1[o] - s.CP[o];
        e[3 * C + c] += fabsf(s.Y0[o]) + fabsf(s.Y1[o]) + fabsf(s.W0[o]) +
                        fabsf(s.W1[o]);
      }
    }
    block_sum<4 * C>(e, s.scratch, s.red);

    float prob[C];
    bool acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float dh = g.beta * e[C + c] + 0.5f * e[c] + e[2 * C + c];
      float p = expf(dh > 0.0f ? 0.0f : dh);  // NaN stays NaN -> rejected
      if (!isfinite(p) || !isfinite(e[3 * C + c])) p = 0.0f;
      prob[c] = p;
      acc[c] = c < nc && s.SC[c * 4 + 1] < p;
      if (acc[c]) {
        pot[c] = pot1[c];
        chg[c] = chg1[c];
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (!acc[c]) continue;
      for (int i = tid; i < d; i += nt) {
        const int o = c * d + i;
        s.X0[o] = s.Y0[o];
        s.X1[o] = s.Y1[o];
        s.SP[o] = s.SP1[o];
        s.CP[o] = s.CP1[o];
      }
    }

    if (g.hop) {
      // each thread reads only its own sites of the accepted fields here
      float hv[2 * C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        hv[c] = 0.0f;
        hv[C + c] = 0.0f;
        if (c >= nc) continue;
        const float nu = s.SC[c * 4 + 2];
        for (int i = tid; i < d; i += nt) {
          const int o = c * d + i;
          hv[c] += s.SP[o];
          hv[C + c] += (s.CP[o] < -cd && nu * s.SP[o] >= 0.0f) ? 1.0f : 0.0f;
        }
      }
      block_sum<2 * C>(hv, s.scratch, s.red);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (c >= nc) break;
        const float nu = s.SC[c * 4 + 2], uh = s.SC[c * 4 + 3];
        const float ds = one_minus_cd * ((float)d - pot[c]) + nu * sd * hv[c];
        const float m = -g.beta * ds;
        float ph = expf(m > 0.0f ? 0.0f : m);
        if (!isfinite(ph)) ph = 0.0f;
        const float ah = (uh < ph) ? 1.0f : 0.0f;
        const float an = ah * nu;
        const float cda = 1.0f + ah * cd_minus_one;
        const float sda = an * sd;
        for (int i = tid; i < d; i += nt) {
          const int o = c * d + i;
          float w0, w1;
          winding(i, g.lt, g.lx, delta, seam, &w0, &w1);
          s.X0[o] = wrap_angle(s.X0[o] + an * w0);
          s.X1[o] = wrap_angle(s.X1[o] + an * w1);
          hop_rotate(s.SP + o, s.CP + o, cda, sda);
        }
        pot[c] = pot[c] + ah * ds;
        chg[c] = chg[c] + an * (1.0f - hv[C + c]);
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

  for (int c = 0; c < nc; ++c) {
    for (int i = tid; i < d; i += nt) {
      x0g[(size_t)(b0 + c) * d + i] = s.X0[c * d + i];
      x1g[(size_t)(b0 + c) * d + i] = s.X1[c * d + i];
    }
  }
}

}  // namespace

extern "C" size_t l2hmc_chain_smem_bytes(int lt, int lx, int h) {
  const size_t d = (size_t)lt * lx;
  const size_t red = (size_t)(h > kThreads ? h : kThreads);
  return sizeof(float) * (16 * C * d + 2 * (size_t)C * h + C * red +
                          (size_t)CHAIN_MAX_WARPS * 4 * C + 4 * C + 4 * C +
                          2 * C);
}

// wptrs: 26 device pointers in the order of ops/l2hmc_kernel.py WEIGHT_NAMES.
extern "C" int l2hmc_chain_launch(
    float* x0, float* x1, const void* wptrs, const float* v0s,
    const float* v1s, const float* ds, const float* us, const float* nus,
    const float* uhs, float* plaq, float* chg, float* prob, int B, int lt,
    int lx, int K, int N, int h, float eps, float beta, int bounded_q,
    int hop, unsigned long long seed, int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  if (B <= 0 || N <= 0) return 0;
  const float* const* p = static_cast<const float* const*>(wptrs);
  auto net = [&](int o) {
    return NetW{p[o],     p[o + 1], p[o + 2],  p[o + 3],
                p[o + 4], p[o + 5], p[o + 6],  p[o + 7],
                p[o + 8], p[o + 9], p[o + 10], p[o + 11]};
  };
  const Weights W{net(0), net(12), p[24], p[25]};
  const L2Rand rnd{v0s, v1s, ds, us, nus, uhs};
  const Geo g{B, lt, lx, lt * lx, K, N, h, bounded_q, hop, eps, beta, seed};
  const size_t smem = l2hmc_chain_smem_bytes(lt, lx, h);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        l2hmc_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (B + C - 1) / C;
  l2hmc_chain_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      x0, x1, W, rnd, plaq, chg, prob, g);
  return (int)cudaGetLastError();
}

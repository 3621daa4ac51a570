// Fused U(1) HMC chain: N transitions of one chain per block in one launch.
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
// plaquette (4 neighbour reads, sincos) and one force (2 neighbour reads),
// so the work is a few hundred flops per site; the chain state (10 fields of
// d floats, 10 KB at 16x16) stays in shared memory for all N transitions and
// device memory sees 2*d floats in and out per chain.  The limits are
// __syncthreads() between the neighbour-reading phases and the block
// reductions (potential, charge, kinetic energy), i.e. latency: the design
// runs one chain per block and many blocks per SM (B = 2048 chains fill the
// card's 132 SMs) so other blocks' work hides each block's barriers.
//
// Randomness: injected arrays (v0s, v1s, us[, nus, uhs]), or Philox4_32_10
// keyed by (chain, transition) with the seed drawn by the caller.

#include "chain_common.cuh"

namespace {

constexpr double kPiD = 3.141592653589793;

struct HmcRand {
  const float *v0s, *v1s, *us, *nus, *uhs;
};

__global__ void __launch_bounds__(256)
hmc_chain_kernel(float* __restrict__ x0g, float* __restrict__ x1g,
                 HmcRand rnd, float* __restrict__ plaq_tr,
                 float* __restrict__ chg_tr, float* __restrict__ prob_tr,
                 int B, int lt, int lx, int K, int N, float eps, float beta,
                 int hop, unsigned long long seed) {
  extern __shared__ float smem[];
  const int d = lt * lx;
  const int b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  float* X0 = smem;        // current state
  float* X1 = X0 + d;
  float* Y0 = X1 + d;      // proposal
  float* Y1 = Y0 + d;
  float* W0 = Y1 + d;      // momenta
  float* W1 = W0 + d;
  float* SP = W1 + d;      // sin / cos plaquette fields of the state
  float* CP = SP + d;
  float* SP1 = CP + d;     // ... of the proposal
  float* CP1 = SP1 + d;
  float* scratch = CP1 + d;                      // CHAIN_MAX_WARPS * 2
  float* red = scratch + CHAIN_MAX_WARPS * 2;    // 2
  float* sc = red + 2;                           // u, nu, uh
  const bool injected = rnd.v0s != nullptr;

  const double dd = (double)d;
  const float cd = (float)cos(2.0 * kPiD / dd);
  const float sd = (float)sin(2.0 * kPiD / dd);
  const float one_minus_cd = (float)(1.0 - cos(2.0 * kPiD / dd));
  const float cd_minus_one = (float)(cos(2.0 * kPiD / dd) - 1.0);
  const float delta = (float)(2.0 * kPiD / dd);
  const float seam = (float)(-(2.0 * kPiD / dd) * lt);

  const size_t base = (size_t)b * d;
  for (int i = tid; i < d; i += nt) {
    X0[i] = x0g[base + i];
    X1[i] = x1g[base + i];
  }
  __syncthreads();

  float pot, chg;
  {
    float v[2] = {0.0f, 0.0f};
    for (int i = tid; i < d; i += nt) {
      float sn, cs;
      const float p = plaq_angle(X0, X1, i, lt, lx);
      sincosf(p, &sn, &cs);
      SP[i] = sn;
      CP[i] = cs;
      v[0] += 1.0f - cs;
      v[1] += wrap_angle(p);
    }
    block_sum<2>(v, scratch, red);
    pot = v[0];
    chg = v[1] * CHAIN_INV_TWO_PI_F;
  }

  for (int n = 0; n < N; ++n) {
    // momenta, first half kick from the carried sine field
    for (int i = tid; i < d; i += nt) {
      const float2 v =
          initial_momenta(rnd.v0s, rnd.v1s, seed, b, B, n, N, d, i);
      W0[i] = add_mul_rn(v.x, -0.5f * eps * beta, grad0(SP, i, lt, lx));
      W1[i] = add_mul_rn(v.y, -0.5f * eps * beta, grad1(SP, i, lt, lx));
      Y0[i] = X0[i];
      Y1[i] = X1[i];
    }
    if (tid == 0) {
      const size_t o = (size_t)n * B + b;
      if (injected) {
        sc[0] = rnd.us[o];
        if (hop) {
          sc[1] = rnd.nus[o];
          sc[2] = rnd.uhs[o];
        }
      } else {
        curandStatePhilox4_32_10_t st;
        philox_at(&st, seed, b, n, N, 8ull * d);
        sc[0] = curand_uniform(&st);
        sc[1] = sign_from_uniform(curand_uniform(&st));
        sc[2] = curand_uniform(&st);
      }
    }

    float pot1 = pot, chg1 = chg;
    for (int k = 0; k < K; ++k) {
      __syncthreads();  // previous force phase done reading SP1
      for (int i = tid; i < d; i += nt) {
        Y0[i] = wrap_angle(add_mul_rn(Y0[i], eps, W0[i]));
        Y1[i] = wrap_angle(add_mul_rn(Y1[i], eps, W1[i]));
      }
      __syncthreads();
      float v[2] = {0.0f, 0.0f};
      for (int i = tid; i < d; i += nt) {
        float sn, cs;
        const float p = plaq_angle(Y0, Y1, i, lt, lx);
        sincosf(p, &sn, &cs);
        SP1[i] = sn;
        CP1[i] = cs;
        v[0] += 1.0f - cs;
        v[1] += wrap_angle(p);
      }
      block_sum<2>(v, scratch, red);
      pot1 = v[0];
      chg1 = v[1] * CHAIN_INV_TWO_PI_F;
      const float c = (k < K - 1) ? eps : 0.5f * eps;
      for (int i = tid; i < d; i += nt) {
        W0[i] = add_mul_rn(W0[i], -c * beta, grad0(SP1, i, lt, lx));
        W1[i] = add_mul_rn(W1[i], -c * beta, grad1(SP1, i, lt, lx));
      }
    }

    // H0 - H1 from per-site differences (no float32 cancellation of the
    // two ~1e3 Hamiltonians): beta sum(cos P1 - cos P0) + sum(v^2 - w^2)/2
    float e[2] = {0.0f, 0.0f};
    for (int i = tid; i < d; i += nt) {
      const float2 v =
          initial_momenta(rnd.v0s, rnd.v1s, seed, b, B, n, N, d, i);
      e[0] += CP1[i] - CP[i];
      e[1] += kinetic_diff(v, W0[i], W1[i]);
    }
    block_sum<2>(e, scratch, red);
    const float dh = beta * e[0] + 0.5f * e[1];
    float prob = expf(dh > 0.0f ? 0.0f : dh);  // NaN stays NaN -> rejected
    if (!isfinite(prob)) prob = 0.0f;
    if (sc[0] < prob) {
      for (int i = tid; i < d; i += nt) {
        X0[i] = Y0[i];
        X1[i] = Y1[i];
        SP[i] = SP1[i];
        CP[i] = CP1[i];
      }
      pot = pot1;
      chg = chg1;
    }

    if (hop) {
      // each thread reads only its own sites of the accepted fields here
      const float nu = sc[1], uh = sc[2];
      float hv[2] = {0.0f, 0.0f};
      for (int i = tid; i < d; i += nt) {
        hv[0] += SP[i];
        hv[1] += (CP[i] < -cd && nu * SP[i] >= 0.0f) ? 1.0f : 0.0f;
      }
      block_sum<2>(hv, scratch, red);
      const float ds = one_minus_cd * ((float)d - pot) + nu * sd * hv[0];
      const float m = -beta * ds;
      float ph = expf(m > 0.0f ? 0.0f : m);
      if (!isfinite(ph)) ph = 0.0f;
      const float acc = (uh < ph) ? 1.0f : 0.0f;
      const float an = acc * nu;
      const float cda = 1.0f + acc * cd_minus_one;
      const float sda = an * sd;
      for (int i = tid; i < d; i += nt) {
        float w0, w1;
        winding(i, lt, lx, delta, seam, &w0, &w1);
        X0[i] = wrap_angle(X0[i] + an * w0);
        X1[i] = wrap_angle(X1[i] + an * w1);
        hop_rotate(SP + i, CP + i, cda, sda);
      }
      pot = pot + acc * ds;
      chg = chg + an * (1.0f - hv[1]);
    }

    if (tid == 0) {
      const size_t o = (size_t)n * B + b;
      plaq_tr[o] = 1.0f - pot / (float)d;
      chg_tr[o] = chg;
      prob_tr[o] = prob;
    }
    __syncthreads();  // fields and scalars settled before the next transition
  }

  for (int i = tid; i < d; i += nt) {
    x0g[base + i] = X0[i];
    x1g[base + i] = X1[i];
  }
}

}  // namespace

extern "C" int smem_optin_bytes(int device) {
  return device_smem_optin(device);
}

extern "C" size_t hmc_chain_smem_bytes(int lt, int lx) {
  return sizeof(float) *
         ((size_t)10 * lt * lx + CHAIN_MAX_WARPS * 2 + 2 + 3);
}

extern "C" int hmc_chain_launch(float* x0, float* x1, const float* v0s,
                                const float* v1s, const float* us,
                                const float* nus, const float* uhs,
                                float* plaq, float* chg, float* prob, int B,
                                int lt, int lx, int K, int N, float eps,
                                float beta, int hop, unsigned long long seed,
                                int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  if (B <= 0 || N <= 0) return 0;
  const size_t smem = hmc_chain_smem_bytes(lt, lx);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        hmc_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int d = lt * lx;
  int nt = ((d + 31) / 32) * 32;
  if (nt > 256) nt = 256;
  HmcRand rnd{v0s, v1s, us, nus, uhs};
  hmc_chain_kernel<<<B, nt, smem, (cudaStream_t)stream>>>(
      x0, x1, rnd, plaq, chg, prob, B, lt, lx, K, N, eps, beta, hop, seed);
  return (int)cudaGetLastError();
}

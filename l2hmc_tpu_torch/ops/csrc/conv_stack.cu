// The periodic conv stacks of the conv conditioner (networks/nets.py
// ConvNet) on the no-grad path: for each of its two input slots,
//
//   y1 = relu(conv_{3x3, periodic}(image, w1) + b1)        8 filters
//   y2 = relu(conv_{2x2, stride 2}(y1, w2) + b2)           16 filters
//
// flattened in NCHW order, (B, 16 (lt/2)(lx/2)): the layout the trunk's
// x_layer / v_layer rows expect.
//
// Replaces no TPU kernel: the JAX package left this network to XLA.  On the
// card the eager path is a permute copy (to_image), two circular pads, two
// cuDNN implicit-GEMM convs on 2-8 input channels, two bias adds, two
// ReLUs and a reshape per slot: each a pass over 34-67 MB of activations at
// 8192 chains of 16x16, or a kernel too small to fill the card.
//
// What bounds it on an H100.  Per chain and conditioner call the two
// stacks are 176,128 multiply-adds (the 4-channel slot 106,496, the
// 2-channel one 69,632) against 4 (4 d + 2 d + 2 x 4 d) bytes in and out
// at d = 256 sites: ~25 FLOP per byte, just above the card's balance point
// (67 TFLOP/s float32 FMA over 3.35 TB/s is 20).  At 8192 chains of 16x16:
// 2.886 GFLOP, 43.1 us, against 117.4 MB, 35.1 us.  Every byte past the
// input and the output is a loss, so nothing else touches device memory.
//
// Design.  A CTA holds max(1, 128 / P) chains of one slot (P = (lt/2)(lx/2)
// up to 256, the stride-2 conv's positions; grid.y is the slot, so both
// slots run in one launch).  It stages its chains' inputs, read
// straight from the flat (B, cin d) layout with coalesced 16-byte loads, in
// shared memory as 2x2 blocks per channel (one float4 per block), and the
// slot's weights reordered so that one tap's filters are contiguous.  One
// thread per stride-2 position (T, X): it takes the 4x4 neighbourhood of
// its 2x2 block from 9 blocks (the periodic wrap is index arithmetic on T
// and X; no pad is ever written), computes the 3x3 conv for its 4 sites and
// 8 filters in registers (32 sums), their ReLU, then the 2x2 conv of its
// position for 16 filters (each y1 value is read by exactly one stride-2
// position), and stores those 16 outputs: for each filter the CTA's
// threads store consecutive floats.  Weights are read from shared memory
// as float4 at addresses uniform over the warp (broadcasts).  to_image's
// channel order is the staging's: element ((n d + site) 2 + dir) of a
// chain is channel 2 n + dir (cos0, cos1, sin0, sin1 for the position's
// features; the two directions otherwise).
//
// A CTA's input arrives before any of its work can start, so the SM hides
// that wait behind other CTAs: 128 positions a CTA and at most 80
// registers a thread (6 CTAs of 128 threads an SM) took 104.6 us a call at
// 8192 chains of 16x16 on an H100, against 124.7 us with 256 positions and
// 96 registers and 109.6-112.3 us with 64 positions; 64 registers spill.
//
// Arithmetic: float32 FMA throughout (no TF32, no reduced precision); only
// the order of the sums differs from cuDNN's.

#include <cuda_runtime.h>

#include "chain_common.cuh"

namespace {

constexpr int kF1 = 8;           // conv 1 filters
constexpr int kF2 = 2 * kF1;     // conv 2 filters
constexpr int kMaxThreads = 256;  // most positions of a chain, one thread each
constexpr int kCtaPositions = 128;  // positions a CTA aims at, whole chains

struct Slot {
  const float* in;   // (B, cin d): cin / 2 blocks of (lt, lx, 2)
  const float* w1;   // (F1, cin, 3, 3)
  const float* b1;   // (F1,)
  const float* w2;   // (F2, F1, 2, 2)
  const float* b2;   // (F2,)
  float* out;        // (B, F2 P)
  int cin;           // 2 or 4
};

struct Args {
  Slot slot[2];
  int B, lt, lx, chains;   // chains per CTA
};

__host__ __device__ constexpr int w1_floats(int cin) { return cin * 9 * kF1; }
constexpr int kW2Floats = kF1 * 4 * kF2;

// Shared memory of a CTA: the weights (a multiple of 4 floats), then the
// chains' input blocks.
__host__ __device__ constexpr int weight_floats(int cin) {
  return w1_floats(cin) + kW2Floats + kF1 + kF2;
}
size_t smem_bytes(int cin, int chains, int d) {
  return sizeof(float) * (weight_floats(cin) + (size_t)chains * cin * d);
}

template <int CIN>
__device__ __forceinline__ void stack(const Slot& s, const Args& a,
                                      float* smem) {
  const int lt = a.lt, lx = a.lx, d = lt * lx;
  const int lt2 = lt / 2, lx2 = lx / 2, P = lt2 * lx2;
  float* w1s = smem;                        // [c][i][j][f]
  float* w2s = w1s + w1_floats(CIN);        // [f][i][j][g]
  float* b1s = w2s + kW2Floats;
  float* b2s = b1s + kF1;
  float4* img = reinterpret_cast<float4*>(smem + weight_floats(CIN));
  const int tid = threadIdx.x, nt = blockDim.x;

  for (int k = tid; k < w1_floats(CIN); k += nt) {
    const int f = k % kF1, tap = k / kF1;   // tap = (c 3 + i) 3 + j
    w1s[k] = s.w1[f * CIN * 9 + tap];
  }
  for (int k = tid; k < kW2Floats; k += nt) {
    const int g = k % kF2, tap = k / kF2;   // tap = (f 2 + i) 2 + j
    w2s[k] = s.w2[g * kF1 * 4 + tap];
  }
  if (tid < kF1) b1s[tid] = s.b1[tid];
  if (tid < kF2) b2s[tid] = s.b2[tid];

  // Inputs: element 4 q of the CTA's span holds (t, x) and (t, x + 1), both
  // directions, of block n (x even, as lx is); block component 2 (t & 1) +
  // (x & 1) of 2x2 block (t / 2, x / 2) of channel 2 n + dir.
  const int b0 = blockIdx.x * a.chains;
  const int nch = min(a.chains, a.B - b0);
  const float4* src =
      reinterpret_cast<const float4*>(s.in + (size_t)b0 * CIN * d);
  const int n4 = nch * CIN * d / 4;
  for (int q = tid; q < n4; q += nt) {
    const float4 v = __ldg(src + q);
    const int e = 4 * q;
    const int k = e / (CIN * d), r = e - k * CIN * d;
    const int n = r / (2 * d), site = (r - n * 2 * d) / 2;
    const int t = site / lx, x = site - t * lx;
    float* blk = reinterpret_cast<float*>(
                     img + (k * CIN + 2 * n) * P + (t >> 1) * lx2 + (x >> 1)) +
                 2 * (t & 1);
    *reinterpret_cast<float2*>(blk) = make_float2(v.x, v.z);
    *reinterpret_cast<float2*>(blk + 4 * P) = make_float2(v.y, v.w);
  }
  __syncthreads();

  const int k = tid / P, pos = tid - k * P;
  if (k >= nch) return;   // the ragged last CTA; no barrier follows
  const int T = pos / lx2, X = pos - T * lx2;
  const int rm = (T == 0 ? lt2 - 1 : T - 1) * lx2, r0 = T * lx2,
            rp = (T + 1 == lt2 ? 0 : T + 1) * lx2;
  const int cm = X == 0 ? lx2 - 1 : X - 1, cp = X + 1 == lx2 ? 0 : X + 1;

  // conv 1 at sites (2T + sr, 2X + sc), sum a1[2 sr + sc][f]
  float a1[4][kF1];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int f = 0; f < kF1; ++f) a1[q][f] = b1s[f];
#pragma unroll
  for (int c = 0; c < CIN; ++c) {
    // v[r][u]: row 2T - 1 + r, column 2X - 1 + u, wrapped
    const float4* ch = img + (k * CIN + c) * P;
    float v[4][4];
    float4 q = ch[rm + cm];
    v[0][0] = q.w;
    q = ch[rm + X];
    v[0][1] = q.z;
    v[0][2] = q.w;
    q = ch[rm + cp];
    v[0][3] = q.z;
    q = ch[r0 + cm];
    v[1][0] = q.y;
    v[2][0] = q.w;
    q = ch[r0 + X];
    v[1][1] = q.x;
    v[1][2] = q.y;
    v[2][1] = q.z;
    v[2][2] = q.w;
    q = ch[r0 + cp];
    v[1][3] = q.x;
    v[2][3] = q.z;
    q = ch[rp + cm];
    v[3][0] = q.y;
    q = ch[rp + X];
    v[3][1] = q.x;
    v[3][2] = q.y;
    q = ch[rp + cp];
    v[3][3] = q.x;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float4* w =
            reinterpret_cast<const float4*>(w1s + ((c * 3 + i) * 3 + j) * kF1);
        const float4 wa = w[0], wb = w[1];
        const float wf[kF1] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
        for (int sr = 0; sr < 2; ++sr)
#pragma unroll
          for (int sc = 0; sc < 2; ++sc) {
            const float xin = v[sr + i][sc + j];
#pragma unroll
            for (int f = 0; f < kF1; ++f)
              a1[2 * sr + sc][f] = fmaf(wf[f], xin, a1[2 * sr + sc][f]);
          }
      }
  }

  // conv 2 at (T, X): tap (i, j) reads site (2T + i, 2X + j)
  float a2[kF2];
#pragma unroll
  for (int g = 0; g < kF2; ++g) a2[g] = b2s[g];
#pragma unroll
  for (int f = 0; f < kF1; ++f)
#pragma unroll
    for (int tap = 0; tap < 4; ++tap) {
      const float y = fmaxf(a1[tap][f], 0.0f);
      const float4* w =
          reinterpret_cast<const float4*>(w2s + (f * 4 + tap) * kF2);
#pragma unroll
      for (int g4 = 0; g4 < kF2 / 4; ++g4) {
        const float4 ww = w[g4];
        a2[4 * g4 + 0] = fmaf(ww.x, y, a2[4 * g4 + 0]);
        a2[4 * g4 + 1] = fmaf(ww.y, y, a2[4 * g4 + 1]);
        a2[4 * g4 + 2] = fmaf(ww.z, y, a2[4 * g4 + 2]);
        a2[4 * g4 + 3] = fmaf(ww.w, y, a2[4 * g4 + 3]);
      }
    }
  float* out = s.out + (size_t)(b0 + k) * kF2 * P + pos;
#pragma unroll
  for (int g = 0; g < kF2; ++g) out[g * P] = fmaxf(a2[g], 0.0f);
}

__global__ void __launch_bounds__(kMaxThreads, 3)
    conv_stack_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  // a select, not an index, so the parameter space is not copied to local
  // memory
  const Slot s = blockIdx.y == 0 ? a.slot[0] : a.slot[1];
  if (s.cin == 4)
    stack<4>(s, a, smem);
  else
    stack<2>(s, a, smem);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Chains per CTA at a lt x lx lattice: max(1, 128 / P) (P = (lt/2)(lx/2)),
// 0 where the kernel does not take the lattice (an odd side, P > 256;
// ops/conv_stack.py takes() is the host's copy of this rule).
int chains_per_cta(int lt, int lx) {
  if (lt < 2 || lx < 2 || (lt & 1) || (lx & 1)) return 0;
  const int p = (lt / 2) * (lx / 2);
  if (p > kMaxThreads) return 0;
  return p >= kCtaPositions ? 1 : kCtaPositions / p;
}

}  // namespace

// Both slots' stacks for B chains in one launch (grid.y is the slot).
// Inputs 16-byte aligned.
extern "C" int conv_stack_launch(
    const float* in0, const float* w10, const float* b10, const float* w20,
    const float* b20, float* out0, int cin0, const float* in1,
    const float* w11, const float* b11, const float* w21, const float* b21,
    float* out1, int cin1, int B, int lt, int lx, int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  const int chains = chains_per_cta(lt, lx);
  if (chains == 0 || B < 0 || (cin0 != 2 && cin0 != 4) ||
      (cin1 != 2 && cin1 != 4) || !aligned16(in0) || !aligned16(in1))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const Args a{{{in0, w10, b10, w20, b20, out0, cin0},
                {in1, w11, b11, w21, b21, out1, cin1}},
               B, lt, lx, chains};
  const int p = (lt / 2) * (lx / 2);
  const dim3 grid((unsigned)((B + chains - 1) / chains), 2u);
  conv_stack_kernel<<<grid, chains * p,
                      smem_bytes(cin0 > cin1 ? cin0 : cin1, chains, lt * lx),
                      (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Issue-rate probes: a dependency chain of m applications of one probe body
// on every element of a float32 array, in registers.
//
// Replaces the TPU kernel benchmarks/vpu_roofline.py:measure_rates_pallas,
// which runs the same chain on a (b, d) block resident in the TPU's vector
// memory to measure what each op class costs inside a kernel.  The time of
// a chain of m steps at two lengths gives the time per step (the slope,
// free of launch overhead); benchmarks/vpu_roofline.py in the port turns it
// into elements per second per op class.
//
// Probes (the six bodies of vpu_roofline.py:256-263, and atan2, which the
// port's chain kernels call where the TPU kernels build an arctangent from
// divisions and cheap ops):
//   0 cheap  x * 0.9995 + 2e-4          2 cheap ops; nvcc contracts them
//                                       into one FFMA, so the cheap rate
//                                       reads in ops/s at most the card's
//                                       67e12 FLOP/s (2 per FFMA)
//   1 exp    expf(-x)                   1 exp, 1 cheap
//   2 trig   sinf(x + 0.7)              1 trig, 1 cheap
//   3 log    logf(x + 1.5)              1 log, 1 cheap
//   4 div    1.7 / (x + 1.2)            1 div, 1 cheap
//   5 floor  (x - floorf(x * 0.73)) * 0.9 + 0.05     1 floor, 4 cheap
//   6 atan2  atan2f(x + 0.3, x + 1.1)   1 atan2, 2 cheap (both operands
//                                       vary, as in the chain kernels'
//                                       circle map)
//
// The file is built with the chain kernels' flags (no fast-math), so each
// probe runs the same libdevice routine (expf, sinf, logf, IEEE division,
// atan2f) as the chain kernels.  m and the probe are runtime arguments of the
// C entry and each result is stored, so the chain is neither unrolled away
// nor folded.
//
// What bounds it on an H100: instruction issue, by design.  One thread per
// element and 256-thread blocks keep up to 64 warps resident per SM, 16 per
// scheduler, which hides the latency of each thread's dependent chain, so
// the time per step is the issue time of one body for every element.

#include <cuda_runtime.h>
#include <math.h>

#include "chain_common.cuh"

namespace {

constexpr int kThreads = 256;

template <int P>
__device__ __forceinline__ float body(float x);
template <>
__device__ __forceinline__ float body<0>(float x) {
  return x * 0.9995f + 2e-4f;
}
template <>
__device__ __forceinline__ float body<1>(float x) {
  return expf(-x);
}
template <>
__device__ __forceinline__ float body<2>(float x) {
  return sinf(x + 0.7f);
}
template <>
__device__ __forceinline__ float body<3>(float x) {
  return logf(x + 1.5f);
}
template <>
__device__ __forceinline__ float body<4>(float x) {
  return 1.7f / (x + 1.2f);
}
template <>
__device__ __forceinline__ float body<5>(float x) {
  return (x - floorf(x * 0.73f)) * 0.9f + 0.05f;
}
template <>
__device__ __forceinline__ float body<6>(float x) {
  return atan2f(x + 0.3f, x + 1.1f);
}

template <int P>
__global__ void __launch_bounds__(kThreads)
issue_rates_kernel(float* __restrict__ x, int n, int m) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = x[i];
  for (int k = 0; k < m; ++k) v = body<P>(v);
  x[i] = v;
}

}  // namespace

// x: n float32 elements, replaced by the probe's chain of m steps.
extern "C" int issue_rates_launch(float* x, int n, int probe, int m,
                                  int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (probe) {
    case 0: issue_rates_kernel<0><<<blocks, kThreads, 0, st>>>(x, n, m); break;
    case 1: issue_rates_kernel<1><<<blocks, kThreads, 0, st>>>(x, n, m); break;
    case 2: issue_rates_kernel<2><<<blocks, kThreads, 0, st>>>(x, n, m); break;
    case 3: issue_rates_kernel<3><<<blocks, kThreads, 0, st>>>(x, n, m); break;
    case 4: issue_rates_kernel<4><<<blocks, kThreads, 0, st>>>(x, n, m); break;
    case 5: issue_rates_kernel<5><<<blocks, kThreads, 0, st>>>(x, n, m); break;
    case 6: issue_rates_kernel<6><<<blocks, kThreads, 0, st>>>(x, n, m); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

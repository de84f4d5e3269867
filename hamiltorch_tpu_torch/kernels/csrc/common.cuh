// Pieces shared by the port's hand-written Hopper kernels: the counter-based
// random numbers (Philox4x32-10, Box-Muller) that replace the TPU's on-core
// PRNG, and fixed-order float64 reductions over a warp or a block (a fixed
// order makes every run deterministic).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint4 philox(uint4 ctr, uint2 key) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t lo0 = 0xD2511F53u * ctr.x, hi0 = __umulhi(0xD2511F53u, ctr.x);
    const uint32_t lo1 = 0xCD9E8D57u * ctr.z, hi1 = __umulhi(0xCD9E8D57u, ctr.z);
    ctr = make_uint4(hi1 ^ ctr.y ^ key.x, lo1, hi0 ^ ctr.w ^ key.y, lo0);
    key.x += 0x9E3779B9u;
    key.y += 0xBB67AE85u;
  }
  return ctr;
}

// uniform in (0, 1), never 0 or 1
__device__ __forceinline__ float uniform01(uint32_t bits) {
  return ((float)(bits >> 8) + 0.5f) * (1.0f / 16777216.0f);
}

// two standard normals from the first two words of a Philox draw
__device__ __forceinline__ float2 box_muller(uint4 r) {
  const float rad = sqrtf(-2.0f * logf(uniform01(r.x)));
  float s, co;
  sincospif(2.0f * uniform01(r.y), &s, &co);
  return make_float2(rad * co, rad * s);
}

// the Philox key of a 64-bit seed
inline uint2 seed_key(unsigned long long seed) {
  return make_uint2((uint32_t)seed, (uint32_t)(seed >> 32));
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum over a block of blockDim.x (a multiple of 32, at most 1024) threads;
// the result is valid in thread 0.  Safe to call more than once per kernel.
__device__ double block_sum(double v) {
  __shared__ double part[32];
  __syncthreads();
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) part[warp] = v;
  __syncthreads();
  v = (threadIdx.x < (blockDim.x >> 5)) ? part[threadIdx.x] : 0.0;
  if (warp == 0) v = warp_sum(v);
  return v;
}

}  // namespace

#define LAUNCH_CHECK()                        \
  do {                                        \
    const cudaError_t e_ = cudaGetLastError(); \
    if (e_ != cudaSuccess) return (int)e_;    \
  } while (0)

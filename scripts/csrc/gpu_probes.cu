// Two probe kernels for the bounds that chip_smoke.py prints beside
// gaussian_hmc's times: the card's latency of a dependent float32 FMA, and
// the rate that mma.sync.m16n8k8 tf32 sustains.  Built by chip_smoke.py; no
// part of the package.

#include "../../hamiltorch_tpu_torch/kernels/csrc/common.cuh"

namespace {

// cycles of `iters` dependent float32 FMAs in one thread
__global__ void fma_latency_kernel(int iters, float x, float* sink, long long* cycles) {
  float v = x;
  unsigned long long ns0, ns1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns0));
  const long long t0 = clock64();
#pragma unroll 16
  for (int i = 0; i < iters; ++i) v = fmaf(v, x, x);
  const long long t1 = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns1));
  *sink = v;
  cycles[0] = t1 - t0;
  cycles[1] = (long long)(ns1 - ns0);  // nanoseconds, for the clock the SM ran at
}

// cycles of `iters` rounds of 6 independent mma.sync.m16n8k8 tf32 per warp in
// a block of 8 warps (the shape of gaussian_hmc's tensor-core variant: two
// warps on each of the SM's four sub-cores, three accumulators for each of
// two tiles)
__global__ void mma_rate_kernel(int iters, float* sink, long long* cycles) {
  float acc[6][4] = {};
  const uint32_t a[4] = {threadIdx.x, 3u * threadIdx.x, 5u, 7u};
  const uint32_t b0 = 11u * threadIdx.x, b1 = 13u;
  __syncthreads();
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < 6; ++c) mma_tf32(acc[c], a, b0, b1);
  }
  const long long t1 = clock64();
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < 6; ++c) s += acc[c][0] + acc[c][1] + acc[c][2] + acc[c][3];
  sink[threadIdx.x] = s;
  if (threadIdx.x == 0) cycles[0] = t1 - t0;
}

}  // namespace

extern "C" {

// Time `iters` dependent FMAs in one thread: cycles (2,) receives the SM
// clock cycles and the nanoseconds they took, sink (1,) the value (so that
// the chain is kept).
int probe_fma_latency(int iters, float* sink, long long* cycles, void* stream_ptr) {
  fma_latency_kernel<<<1, 1, 0, (cudaStream_t)stream_ptr>>>(iters, 0.999f, sink, cycles);
  LAUNCH_CHECK();
  return 0;
}

// Time `iters` rounds of 6 mma.sync.m16n8k8 tf32 per warp in one block of 8
// warps: cycles (1,) receives warp 0's SM clock cycles, sink (256,) the sums.
int probe_mma_rate(int iters, float* sink, long long* cycles, void* stream_ptr) {
  mma_rate_kernel<<<1, 256, 0, (cudaStream_t)stream_ptr>>>(iters, sink, cycles);
  LAUNCH_CHECK();
  return 0;
}

}  // extern "C"

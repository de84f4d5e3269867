// Fused multi-chain HMC on a Gaussian N(mean, P^-1) with identity mass,
// written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel hamiltorch_tpu/kernels/gaussian_hmc.py::
// gaussian_hmc (its body _kernel, lines 55-107).  Same sampler: per draw
// standard-normal momenta, a half kick, L drift+kick steps, half a kick
// pulled back, and the Metropolis test (h0 - h1) >= log u, with the gradient
//     g = -(theta - mean) * P         (P diagonal, elementwise), or
//     g = -(theta - mean) @ P         (P dense, one matvec),
// the potential -1/2 sum (theta - mean) g and the kinetic energy 1/2 |p|^2.
// It writes every draw (C, N, D) and each chain's acceptance rate.  The
// momenta and the uniform come from Philox + Box-Muller keyed on
// (seed, chain, draw) (or are given).  Unlike the TPU kernel it computes
// over the real D only (no lane padding).
//
// What bounds it.  Per chain and leapfrog step the work is one gradient:
// 2 D^2 flops for dense P (1024 chains x 200 draws x 10 steps at D=128 is
// 67 GFLOP, ~1.0 ms at the 67 TFLOP/s float32 FMA peak of an H100 SXM at
// 700 W), a few flops per element for diagonal P; the bytes are the draws
// written out (C N D floats).  At small D neither bounds it: each chain's
// L steps per draw are a chain of dependent operations, so the time is the
// latency of that chain times the draws.
//
// What the design does about it.  One warp per chain keeps the chain's
// state in registers for the whole run (lane l holds elements l + 32 j,
// j < D/32 rounded up, D <= 256), so the only device-memory traffic is the
// draws written out; reductions (the energies) are warp shuffles in
// float64 in a fixed order, so a run is deterministic.  The gradient at the
// current state rides along between draws (recomputing it, as the TPU kernel
// does, gives the same numbers), so a draw costs L gradients.  Dense P
// lives in shared memory, loaded once per block of chain_tile warps; each
// warp broadcasts theta - mean through its own shared row.

#include "common.cuh"

namespace {

constexpr int MAX_D = 256;
constexpr int MAX_SHARED = 232448;  // bytes of shared memory a block may use

// g = -(th - mu) P for this lane's elements (dense P in shared memory, with
// the warp's row dl for the broadcast), or -(th - mu) * pr (diagonal)
template <int DPL, bool DENSE>
__device__ __forceinline__ void gradient(const float (&th)[DPL], const float (&mu)[DPL],
                                         const float (&pr)[DPL], float (&g)[DPL],
                                         const float* __restrict__ P, float* dl, int d,
                                         int lane) {
  if (DENSE) {
    __syncwarp();
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int k = lane + 32 * j;
      if (k < d) dl[k] = th[j] - mu[j];
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int k = lane + 32 * j;
      float s = 0.f;
      if (k < d)
        for (int i = 0; i < d; ++i) s = fmaf(dl[i], P[i * d + k], s);
      g[j] = -s;
    }
  } else {
#pragma unroll
    for (int j = 0; j < DPL; ++j) g[j] = -(th[j] - mu[j]) * pr[j];
  }
}

// -1/2 sum (th - mu) g + 1/2 |p|^2 over the chain, in float64 (every lane)
template <int DPL>
__device__ __forceinline__ double energy(const float (&th)[DPL], const float (&mu)[DPL],
                                         const float (&g)[DPL], const float (&p)[DPL]) {
  double pot = 0.0, kin = 0.0;
#pragma unroll
  for (int j = 0; j < DPL; ++j) {
    pot += (double)(th[j] - mu[j]) * (double)g[j];
    kin += (double)p[j] * (double)p[j];
  }
  return -0.5 * warp_sum(pot) + 0.5 * warp_sum(kin);
}

template <int DPL, bool DENSE>
__global__ void gaussian_hmc_kernel(const float* __restrict__ theta0,
                                    const float* __restrict__ prec,
                                    const float* __restrict__ mean, float* __restrict__ out,
                                    float* __restrict__ acc, int chains, int d, int num_samples,
                                    int num_steps, float eps, uint2 key,
                                    const float* __restrict__ momenta,
                                    const float* __restrict__ uniforms) {
  extern __shared__ float smem[];  // dense: P (d x d), then one row of d per warp
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * (blockDim.x >> 5) + warp;
  float* dl = smem + (DENSE ? d * d + warp * d : 0);
  if (DENSE) {
    for (int i = threadIdx.x; i < d * d; i += blockDim.x) smem[i] = prec[i];
    __syncthreads();
  }
  if (c >= chains) return;

  float theta[DPL], gc[DPL], th[DPL], g[DPL], p[DPL], mu[DPL], pr[DPL];
#pragma unroll
  for (int j = 0; j < DPL; ++j) {
    const int k = lane + 32 * j;
    const bool in = k < d;
    theta[j] = in ? theta0[(long long)c * d + k] : 0.f;
    mu[j] = (in && mean) ? mean[k] : 0.f;
    pr[j] = (in && !DENSE) ? prec[k] : 0.f;
  }
  gradient<DPL, DENSE>(theta, mu, pr, gc, smem, dl, d, lane);

  int accepted = 0;
  for (int n = 0; n < num_samples; ++n) {
    const float* mom = momenta ? momenta + ((long long)n * chains + c) * d : nullptr;
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int k = lane + 32 * j;
      float z = 0.f;
      if (k < d)
        z = mom ? mom[k]
                : box_muller(philox(make_uint4((uint32_t)k, (uint32_t)n, (uint32_t)c, 0u), key)).x;
      p[j] = z;
    }
    const double h0 = energy<DPL>(theta, mu, gc, p);
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      p[j] = fmaf(0.5f * eps, gc[j], p[j]);
      th[j] = theta[j];
      g[j] = gc[j];
    }
    for (int s = 0; s < num_steps; ++s) {
#pragma unroll
      for (int j = 0; j < DPL; ++j) th[j] = fmaf(eps, p[j], th[j]);
      gradient<DPL, DENSE>(th, mu, pr, g, smem, dl, d, lane);
#pragma unroll
      for (int j = 0; j < DPL; ++j) p[j] = fmaf(eps, g[j], p[j]);
    }
#pragma unroll
    for (int j = 0; j < DPL; ++j) p[j] = fmaf(-0.5f * eps, g[j], p[j]);
    const double h1 = energy<DPL>(th, mu, g, p);
    const float u = uniforms
        ? uniforms[(long long)n * chains + c]
        : uniform01(philox(make_uint4(0u, (uint32_t)n, (uint32_t)c, 1u), key).x);
    if ((h0 - h1) >= log((double)u)) {  // the same decision in every lane
      ++accepted;
#pragma unroll
      for (int j = 0; j < DPL; ++j) {
        theta[j] = th[j];
        gc[j] = g[j];
      }
    }
    float* row = out + ((long long)c * num_samples + n) * d;
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int k = lane + 32 * j;
      if (k < d) row[k] = theta[j];
    }
  }
  if (lane == 0) acc[c] = (float)accepted / (float)num_samples;
}

template <int DPL, bool DENSE>
int launch(const float* theta0, const float* prec, const float* mean, float* out, float* acc,
           int chains, int d, int num_samples, int num_steps, float eps, uint2 key,
           const float* momenta, const float* uniforms, int chain_tile, size_t shared,
           cudaStream_t stream) {
  auto kernel = gaussian_hmc_kernel<DPL, DENSE>;
  if (shared > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (chains + chain_tile - 1) / chain_tile;
  kernel<<<blocks, 32 * chain_tile, shared, stream>>>(theta0, prec, mean, out, acc, chains, d,
                                                      num_samples, num_steps, eps, key, momenta,
                                                      uniforms);
  LAUNCH_CHECK();
  return 0;
}

template <bool DENSE>
int dispatch(int dpl, const float* theta0, const float* prec, const float* mean, float* out,
             float* acc, int chains, int d, int num_samples, int num_steps, float eps, uint2 key,
             const float* momenta, const float* uniforms, int chain_tile, size_t shared,
             cudaStream_t stream) {
#define GAUSSIAN_HMC_CASE(N)                                                                    \
  case N:                                                                                       \
    return launch<N, DENSE>(theta0, prec, mean, out, acc, chains, d, num_samples, num_steps, \
                            eps, key, momenta, uniforms, chain_tile, shared, stream);
  switch (dpl) {
    GAUSSIAN_HMC_CASE(1)
    GAUSSIAN_HMC_CASE(2)
    GAUSSIAN_HMC_CASE(4)
    GAUSSIAN_HMC_CASE(8)
  }
#undef GAUSSIAN_HMC_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* gaussian_hmc_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Run num_samples HMC draws of num_steps leapfrog steps on every chain.
// theta0 (C, D); prec (D,) with dense == 0 or (D, D) with dense == 1; mean
// (D,) or null for zero; out (C, S, D); acc (C,).  momenta (S, C, D) and
// uniforms (S, C) may be null.  Takes 1 <= D <= 256, 1 <= chain_tile <= 32
// and, for dense P, (D + chain_tile) D floats of shared memory at most
// 232,448 bytes (D <= 220 at chain_tile 8); returns cudaErrorInvalidValue
// for other shapes.  The caller checks num_samples, num_steps >= 1.
// Launches on the stream without synchronising and returns the first
// launch error as a cudaError_t (0 on success).
int gaussian_hmc_run(const float* theta0, const float* prec, const float* mean, float* out,
                     float* acc, int chains, int d, int dense, int num_samples, int num_steps,
                     float step_size, unsigned long long seed, int chain_tile,
                     const float* momenta, const float* uniforms, void* stream_ptr) {
  if (d < 1 || d > MAX_D || chains < 1 || chain_tile < 1 || chain_tile > 32)
    return (int)cudaErrorInvalidValue;
  const size_t shared = dense ? sizeof(float) * (size_t)(d + chain_tile) * d : 0;
  if (shared > MAX_SHARED) return (int)cudaErrorInvalidValue;
  const int dpl = d <= 32 ? 1 : d <= 64 ? 2 : d <= 128 ? 4 : 8;
  const uint2 key = seed_key(seed);
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  return dense ? dispatch<true>(dpl, theta0, prec, mean, out, acc, chains, d, num_samples,
                                num_steps, step_size, key, momenta, uniforms, chain_tile, shared,
                                stream)
               : dispatch<false>(dpl, theta0, prec, mean, out, acc, chains, d, num_samples,
                                 num_steps, step_size, key, momenta, uniforms, chain_tile,
                                 shared, stream);
}

}  // extern "C"

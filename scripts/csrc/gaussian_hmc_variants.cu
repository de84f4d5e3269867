// Designs of gaussian_hmc that were tried or replaced, for
// scripts/gaussian_hmc_variants_torch.py to time beside the package's
// kernel.  No part of the package.
//   - instantiations of the package's kernel templates that its plan never
//     chooses: a thread per chain (1 lane of 4 elements), with the noise
//     ring or with Philox, Box-Muller and log inline (diagonal P, D <= 4);
//     the former design, a warp per chain with the noise inline: 32 lanes
//     of one element (diagonal P, D <= 32) and 32 lanes of 4 elements with
//     P multiplied by float32 FMAs from shared memory (dense P, D <= 128);
//     the any-D dense kernel with P^T held split once a run (and Delta held
//     split by whoever writes it) in 2 or 3 stages, and as built in 2;
//   - the former any-D variant 5 (wide_kernel, below): 1-8 chains a block
//     of 8 warps with the state in shared memory, dense P read from L2 or
//     device memory by float32 FMAs, at any D up to 11,612 diagonal and
//     9,676 dense.

#include "../../hamiltorch_tpu_torch/kernels/csrc/gaussian_hmc.cuh"

namespace {

// ---- the former any-D variant (wide_kernel): CB chains per block ----

constexpr int WIDE_WARPS = 8;
constexpr int WIDE_THREADS = 32 * WIDE_WARPS;

// Shared memory of a block of CB chains at Dq = D rounded up to 4, in this
// order:
//   double part[2][WIDE_WARPS][CB]  the warps' partial energy sums (of this
//                                   draw and the next: no barrier between
//                                   two draws' sums for diagonal P)
//   double log_u[2][CB]             the chains' log-uniforms, likewise
//   float theta[CB][Dq], gc[CB][Dq] the chain state and its gradient
//   float th[CB][Dq], p[CB][Dq], g[CB][Dq]  the trajectory
//   float delta[Dq][CB]             dense P only: th - mean, element-major, so
//                                   that one element of P meets all CB chains
// Thread t owns elements 4 q .. 4 q + 3 for q = t, t + WIDE_THREADS, ... of
// every chain of its block: it alone touches them in theta, gc, th, p and g.
template <int CB>
struct WideShape {
  const int dq;
  double* part;
  double* log_u;
  float *theta, *gc, *th, *p, *g, *delta;
  __device__ WideShape(double* smem, int d) : dq((d + 3) & ~3) {
    part = smem;
    log_u = part + 2 * WIDE_WARPS * CB;
    theta = reinterpret_cast<float*>(log_u + 2 * CB);
    gc = theta + CB * dq;
    th = gc + CB * dq;
    p = th + CB * dq;
    g = p + CB * dq;
    delta = g + CB * dq;
  }
};

// Rows of P summed into one partial before it is added to the total.  One
// float32 sum over all D rows drifts from float64 about 3x further than
// torch.matmul's product does at D in the thousands; blocks of 64 rows drift
// less than it (scripts/gaussian_sum_order_torch.py emulates the orders).
constexpr int WIDE_ROW_BLOCK = 64;

// acc[c][e] = sum over i of delta[i][c] P[i][4 q + e]: columns 4 q .. 4 q + 3
// of P for the block's CB chains, each WIDE_ROW_BLOCK rows summed ascending
// into a partial, the partials added in order.  VEC: 16-byte loads of P's
// rows (D a multiple of 4, P 16-byte aligned).  Four rows a turn, so that
// their loads are in flight together (the SM holds one block of 8 warps).
template <int CB, bool VEC>
__device__ __forceinline__ void wide_columns(const float* __restrict__ P, const float* delta,
                                             int d, int q, float (&acc)[CB][4]) {
#pragma unroll
  for (int c = 0; c < CB; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
  const float* col = P + 4 * q;
  for (int i0 = 0; i0 < d; i0 += WIDE_ROW_BLOCK) {
    float part[CB][4];
#pragma unroll
    for (int c = 0; c < CB; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[c][e] = 0.f;
    const int i1 = min(i0 + WIDE_ROW_BLOCK, d);
#pragma unroll 4
    for (int i = i0; i < i1; ++i, col += d) {
      float pv[4];
      if (VEC) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(col));
        pv[0] = v.x, pv[1] = v.y, pv[2] = v.z, pv[3] = v.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) pv[e] = 4 * q + e < d ? __ldg(col + e) : 0.f;
      }
      const float* dv = delta + i * CB;
#pragma unroll
      for (int c = 0; c < CB; ++c) {
        const float di = dv[c];
#pragma unroll
        for (int e = 0; e < 4; ++e) part[c][e] = fmaf(di, pv[e], part[c][e]);
      }
    }
#pragma unroll
    for (int c = 0; c < CB; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][e] += part[c][e];
  }
}

// out = -(x - mean) P (dense) or -(x - mean) * P (diagonal) for the block's
// CB chains; x and out are [CB][Dq] arrays of shared memory.  Dense P is read
// from device memory, each thread taking 4 columns (16-byte loads where rows
// are aligned) for all CB chains, so every element of P read serves CB
// chains.  Every thread of the block must call it.
template <int CB, bool DENSE>
__device__ __forceinline__ void wide_gradient(const Args& a, const WideShape<CB>& sh,
                                              const float* x, float* out) {
  const int d = a.d, dq = sh.dq, nq = dq / 4;
  if (!DENSE) {
    for (int q = threadIdx.x; q < nq; q += WIDE_THREADS)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = 4 * q + e;
        const float mu = k < d ? mean_at(a, k) : 0.f, pr = k < d ? a.prec[k] : 0.f;
#pragma unroll
        for (int c = 0; c < CB; ++c) out[c * dq + k] = k < d ? -(x[c * dq + k] - mu) * pr : 0.f;
      }
    return;
  }
  for (int q = threadIdx.x; q < nq; q += WIDE_THREADS)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = 4 * q + e;
      const float mu = k < d ? mean_at(a, k) : 0.f;
#pragma unroll
      for (int c = 0; c < CB; ++c) sh.delta[k * CB + c] = k < d ? x[c * dq + k] - mu : 0.f;
    }
  __syncthreads();
  const bool vec = (d & 3) == 0 && (reinterpret_cast<uintptr_t>(a.prec) & 15) == 0;
  for (int q = threadIdx.x; q < nq; q += WIDE_THREADS) {
    float acc[CB][4];
    if (vec)
      wide_columns<CB, true>(a.prec, sh.delta, d, q, acc);
    else
      wide_columns<CB, false>(a.prec, sh.delta, d, q, acc);
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int c = 0; c < CB; ++c) out[c * dq + 4 * q + e] = -acc[c][e];
  }
  __syncthreads();  // delta is written again by the next call
}

// One block of WIDE_THREADS threads per CB chains; the state lives in shared
// memory (the layout above WideShape).
template <int CB, bool DENSE>
__global__ void __launch_bounds__(WIDE_THREADS) wide_kernel(Args a) {
  extern __shared__ double smem[];
  const WideShape<CB> sh(smem, a.d);
  const int d = a.d, dq = sh.dq, nq = dq / 4, S = a.num_samples;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = blockIdx.x * CB;
  const float eps = a.eps;

  for (int q = threadIdx.x; q < nq; q += WIDE_THREADS)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = 4 * q + e;
#pragma unroll
      for (int c = 0; c < CB; ++c)
        sh.theta[c * dq + k] =
            (k < d && c0 + c < a.chains) ? a.theta0[(long long)(c0 + c) * d + k] : 0.f;
    }
  __syncthreads();
  wide_gradient<CB, DENSE>(a, sh, sh.theta, sh.gc);
  int accepted[CB];
#pragma unroll
  for (int c = 0; c < CB; ++c) accepted[c] = 0;

  for (int n = 0; n < S; ++n) {
    double e[CB];  // this thread's part of each chain's h0 - h1
#pragma unroll
    for (int c = 0; c < CB; ++c) e[c] = 0.0;
    for (int q = threadIdx.x; q < nq; q += WIDE_THREADS) {
#pragma unroll
      for (int c = 0; c < CB; ++c) {
        float z[4] = {0.f, 0.f, 0.f, 0.f};
        if (c0 + c < a.chains) normals4(a, q, n, c0 + c, z);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = 4 * q + j, i = c * dq + k;
          const float theta = sh.theta[i], gc = sh.gc[i], zj = k < d ? z[j] : 0.f;  // 0 beyond d
          if (k < d) e[c] += half_energy(theta - mean_at(a, k), gc, zj);
          sh.p[i] = fmaf(0.5f * eps, gc, zj);
          sh.th[i] = theta;
          sh.g[i] = gc;
        }
      }
    }
    for (int s = 0; s < a.num_steps; ++s) {
      for (int q = threadIdx.x; q < nq; q += WIDE_THREADS)
#pragma unroll
        for (int c = 0; c < CB; ++c)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int i = c * dq + 4 * q + j;
            sh.th[i] = fmaf(eps, sh.p[i], sh.th[i]);
          }
      wide_gradient<CB, DENSE>(a, sh, sh.th, sh.g);
      for (int q = threadIdx.x; q < nq; q += WIDE_THREADS)
#pragma unroll
        for (int c = 0; c < CB; ++c)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int i = c * dq + 4 * q + j;
            sh.p[i] = fmaf(eps, sh.g[i], sh.p[i]);
          }
    }
    for (int q = threadIdx.x; q < nq; q += WIDE_THREADS)
#pragma unroll
      for (int c = 0; c < CB; ++c)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = 4 * q + j, i = c * dq + k;
          if (k >= d) continue;
          const float pe = fmaf(-0.5f * eps, sh.g[i], sh.p[i]);
          sh.p[i] = pe;
          e[c] -= half_energy(sh.th[i] - mean_at(a, k), sh.g[i], pe);
        }
    // each chain's sum: over the warp by shuffles, then over the warps
    double* part = sh.part + (n & 1) * WIDE_WARPS * CB;
    double* log_u = sh.log_u + (n & 1) * CB;
#pragma unroll
    for (int c = 0; c < CB; ++c) {
      const double v = warp_sum(e[c]);
      if (lane == 0) part[warp * CB + c] = v;
    }
    if (threadIdx.x < CB)
      log_u[threadIdx.x] = c0 + threadIdx.x < a.chains ? log_uniform_at(a, n, c0 + threadIdx.x) : 0.0;
    __syncthreads();
    bool ok[CB];
#pragma unroll
    for (int c = 0; c < CB; ++c) {
      double dh = 0.0;
#pragma unroll
      for (int w = 0; w < WIDE_WARPS; ++w) dh += part[w * CB + c];
      ok[c] = dh >= log_u[c];
      accepted[c] += ok[c];
    }
    for (int q = threadIdx.x; q < nq; q += WIDE_THREADS)
#pragma unroll
      for (int c = 0; c < CB; ++c) {
        if (c0 + c >= a.chains) continue;
        float* o = a.out + ((long long)(c0 + c) * S + n) * d;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = 4 * q + j, i = c * dq + k;
          if (k >= d) continue;
          if (ok[c]) {
            sh.theta[i] = sh.th[i];
            sh.gc[i] = sh.g[i];
          }
          o[k] = sh.theta[i];
        }
      }
  }
  if (threadIdx.x < CB && c0 + threadIdx.x < a.chains)
    a.acc[c0 + threadIdx.x] = (float)accepted[threadIdx.x] / (float)S;
}

// one block of WIDE_THREADS threads per CB chains; `shared` must hold the
// layout above WideShape
template <int CB, bool DENSE>
int launch_wide(const Args& a, size_t shared, cudaStream_t stream) {
  auto kernel = wide_kernel<CB, DENSE>;
  if (const int e = allow_shared(kernel, shared)) return e;
  kernel<<<(a.chains + CB - 1) / CB, WIDE_THREADS, shared, stream>>>(a);
  LAUNCH_CHECK();
  return 0;
}

}  // namespace

extern "C" {

// As gaussian_hmc_run of the package (Philox noise only), with the design
// given: `group` lanes per chain of `epl` elements; blocks of `warps` warps
// of which the first `consumers` run `cpw` chains each and the others, if
// any, fill the noise ring; `shared` bytes (the ring: 2 x 16 draws x the
// block's chains x (8 + 4 D); a dense P: 4 D^2 + 4 D per warp).
int gaussian_hmc_variant_run(const float* theta0, const float* prec, float* out, float* acc,
                             int chains, int d, int dense, int num_samples, int num_steps,
                             float step_size, unsigned long long seed, int group, int epl,
                             int warps, int consumers, int cpw, int shared, void* stream_ptr) {
  const int invalid = (int)cudaErrorInvalidValue;
  if (d < 1 || chains < 1 || group * epl < d || shared < 0 || shared > MAX_SHARED) return invalid;
  const Args a = {theta0, prec, nullptr, out, acc, chains, d, num_samples, num_steps, step_size,
                  seed_key(seed), nullptr, nullptr};
  cudaStream_t s = (cudaStream_t)stream_ptr;
  const bool ring = consumers < warps;
  if (group == 1 && epl == 4 && !dense)
    return ring ? launch_chain<1, 4, false, true>(a, warps, consumers, cpw, shared, s)
                : launch_chain<1, 4, false, false>(a, warps, consumers, cpw, shared, s);
  if (group == 32 && epl == 1 && !dense && !ring)
    return launch_chain<32, 1, false, false>(a, warps, consumers, cpw, shared, s);
  if (group == 32 && epl == 4 && dense && !ring)
    return launch_chain<32, 4, true, false>(a, warps, consumers, cpw, shared, s);
  return invalid;
}

// The former any-D variant: `chains_per_block` = 1, 2, 4 or 8 chains a
// block of 8 warps, `shared` the layout above WideShape (the script's
// wide_shared).
int gaussian_hmc_wide_run(const float* theta0, const float* prec, float* out, float* acc,
                          int chains, int d, int dense, int num_samples, int num_steps,
                          float step_size, unsigned long long seed, int chains_per_block,
                          int shared, void* stream_ptr) {
  if (d < 1 || chains < 1 || shared < 0 || shared > MAX_SHARED) return (int)cudaErrorInvalidValue;
  const Args a = {theta0, prec, nullptr, out, acc, chains, d, num_samples, num_steps, step_size,
                  seed_key(seed), nullptr, nullptr};
  cudaStream_t s = (cudaStream_t)stream_ptr;
  switch (chains_per_block) {
    case 1: return dense ? launch_wide<1, true>(a, shared, s) : launch_wide<1, false>(a, shared, s);
    case 2: return dense ? launch_wide<2, true>(a, shared, s) : launch_wide<2, false>(a, shared, s);
    case 4: return dense ? launch_wide<4, true>(a, shared, s) : launch_wide<4, false>(a, shared, s);
    case 8: return dense ? launch_wide<8, true>(a, shared, s) : launch_wide<8, false>(a, shared, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The any-D dense kernel in one of the forms DENSE_FORMS names: `form` 0
// as built but in 2 stages (64-chain tiles), 1 P^T held split in 2 stages
// (64), 2 P^T and Delta held split in 2 stages (64), 3 P^T held split in 3
// stages (32-chain tiles).  With out null it returns the scratch bytes the
// form needs (chain_tile: its tile's chains, shared: its shared bytes);
// else it runs on `scratch` and returns a cudaError_t.
int gaussian_hmc_dense_form_run(const float* theta0, const float* prec, float* out, float* acc,
                                int chains, int d, int num_samples, int num_steps,
                                float step_size, unsigned long long seed, int form,
                                void* scratch, long long* bytes, void* stream_ptr) {
  static const int tile[] = {64, 64, 64, 32}, wn[] = {2, 2, 2, 1}, st[] = {2, 2, 2, 3};
  static const bool pa[] = {false, true, true, true}, pb[] = {false, false, true, false};
  if (form < 0 || form > 3 || d < 1 || chains < 1) return (int)cudaErrorInvalidValue;
  const size_t shared = dense_shared_bytes(tile[form], wn[form], st[form], pa[form], pb[form]);
  if (!out) {
    bytes[0] = (long long)dense_scratch(nullptr, nullptr, chains, d, tile[form], pa[form], pb[form]);
    bytes[1] = tile[form];
    bytes[2] = (long long)shared;
    return 0;
  }
  const Args a = {theta0, prec, nullptr, out, acc, chains, d, num_samples, num_steps, step_size,
                  seed_key(seed), nullptr, nullptr};
  cudaStream_t s = (cudaStream_t)stream_ptr;
  switch (form) {
    case 0: return launch_dense<2, 4, 2, 2, false, false>(a, scratch, shared, s);
    case 1: return launch_dense<2, 4, 2, 2, true, false>(a, scratch, shared, s);
    case 2: return launch_dense<2, 4, 2, 2, true, true>(a, scratch, shared, s);
    case 3: return launch_dense<1, 4, 1, 3, true, false>(a, scratch, shared, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

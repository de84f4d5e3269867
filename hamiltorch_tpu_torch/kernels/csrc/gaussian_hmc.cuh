// The kernels of gaussian_hmc.cu (its head note says what bounds them and
// what the design does): chain_kernel, G lanes per chain of EPL elements
// each, with or without a shared-memory ring of noise that producer warps
// fill, mma_kernel, 16 chains per block on the tensor cores in 3xTF32, and
// for any D: dense_grid_kernel, one persistent cooperative grid whose every
// leapfrog step is one (C, D) x (D, D) product on the tensor cores in
// 3xTF32, and diag_kernel, the state of a chain in the registers of 32-1024
// threads.  They are templates; a source that includes this header instantiates the
// ones it launches (gaussian_hmc.cu: those the wrapper's plan can choose).
#pragma once

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int MAX_D = 256;  // largest D of variants 1-4
constexpr int MAX_SHARED = 232448;  // bytes of shared memory a block may use
constexpr int RING_DRAWS = 16;      // draws per buffer of the noise ring
constexpr int MAX_WARPS = 8;        // warps per block of variants 1-3
constexpr int MMA_ROWS = 16;        // chains per block of variant 4

struct Args {
  const float* theta0;
  const float* prec;
  const float* mean;
  float* out;
  float* acc;
  int chains, d, num_samples, num_steps;
  float eps;
  uint2 key;
  const float* momenta;   // (S, C, D) or null
  const float* uniforms;  // (S, C) or null
};

// The standard normals of elements 4q .. 4q+3 of chain c's momentum in draw
// n: one Philox draw keyed on (q, n, c), both outputs of two Box-Muller
// transforms.  A function of the logical (element, draw, chain) only.
__device__ __forceinline__ void normals4(const Args& a, int q, int n, int c, float (&z)[4]) {
  if (a.momenta) {
    const float* m = a.momenta + ((long long)n * a.chains + c) * a.d;
#pragma unroll
    for (int e = 0; e < 4; ++e) z[e] = 4 * q + e < a.d ? m[4 * q + e] : 0.f;
    return;
  }
  const uint4 r = philox(make_uint4((uint32_t)q, (uint32_t)n, (uint32_t)c, 0u), a.key);
  const float2 lo = box_muller(r), hi = box_muller(make_uint4(r.z, r.w, 0u, 0u));
  z[0] = lo.x, z[1] = lo.y, z[2] = hi.x, z[3] = hi.y;
}

// elements k and k + 1 of the same (k even): half of the Philox draw's words
__device__ __forceinline__ float2 normals2(const Args& a, int k, int n, int c) {
  if (a.momenta) {
    const float* m = a.momenta + ((long long)n * a.chains + c) * a.d;
    return make_float2(k < a.d ? m[k] : 0.f, k + 1 < a.d ? m[k + 1] : 0.f);
  }
  const uint4 r = philox(make_uint4((uint32_t)(k >> 2), (uint32_t)n, (uint32_t)c, 0u), a.key);
  return box_muller((k & 2) ? make_uint4(r.z, r.w, 0u, 0u) : r);
}

// element k alone
__device__ __forceinline__ float normal_at(const Args& a, int k, int n, int c) {
  if (a.momenta) return a.momenta[((long long)n * a.chains + c) * a.d + k];
  const float2 z = normals2(a, k & ~1, n, c);
  return (k & 1) ? z.y : z.x;
}

// log of the Metropolis uniform of chain c in draw n, in float64
__device__ __forceinline__ double log_uniform_at(const Args& a, int n, int c) {
  const float u = a.uniforms
      ? a.uniforms[(long long)n * a.chains + c]
      : uniform01(philox(make_uint4(0u, (uint32_t)n, (uint32_t)c, 1u), a.key).x);
  return log((double)u);
}

// one element's part of 1/2 |p|^2 - 1/2 (theta - mean) g, in float64
__device__ __forceinline__ double half_energy(float delta, float g, float p) {
  return 0.5 * ((double)p * (double)p - (double)delta * (double)g);
}

// ---- variants 1-3: G lanes per chain, EPL elements per lane ----

// g = -(th - mu) P for this lane's elements (dense P in shared memory), or
// -(th - mu) * pr (diagonal).  row: the warp's shared row (G = 32, EPL > 1).
template <int G, int EPL, bool DENSE>
__device__ __forceinline__ void gradient(const float (&th)[EPL], const float (&mu)[EPL],
                                         const float (&pr)[EPL], float (&g)[EPL],
                                         const float* __restrict__ P, float* row, int d,
                                         int sub) {
  static_assert(!DENSE || EPL == 1 || G == 32, "dense P: one element a lane, or a warp per chain");
  if (!DENSE) {
#pragma unroll
    for (int j = 0; j < EPL; ++j) g[j] = -(th[j] - mu[j]) * pr[j];
  } else if (EPL == 1) {  // theta - mean goes round the lane group by shuffles
    const float dl = th[0] - mu[0];
    float s = 0.f;
    for (int i = 0; i < d; ++i) {
      const float di = __shfl_sync(0xffffffffu, dl, i, G);
      if (sub < d) s = fmaf(di, P[i * d + sub], s);
    }
    g[0] = -s;
  } else {  // a warp per chain: theta - mean through the warp's shared row
    __syncwarp();
#pragma unroll
    for (int j = 0; j < EPL; ++j) {
      const int k = sub + G * j;
      if (k < d) row[k] = th[j] - mu[j];
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < EPL; ++j) {
      const int k = sub + G * j;
      float s = 0.f;
      if (k < d)
        for (int i = 0; i < d; ++i) s = fmaf(row[i], P[i * d + k], s);
      g[j] = -s;
    }
  }
}

// One draw from momenta z and log-uniform logu: updates theta and the
// gradient gc at theta, returns the accept decision (the same in every lane
// of the chain's group).  Every lane of the warp must call it.
template <int G, int EPL, bool DENSE>
__device__ __forceinline__ bool one_draw(float (&theta)[EPL], float (&gc)[EPL],
                                         const float (&mu)[EPL], const float (&pr)[EPL],
                                         const float (&z)[EPL], double logu,
                                         const float* __restrict__ P, float* row, int d, int sub,
                                         int num_steps, float eps) {
  float p[EPL], th[EPL], g[EPL];
  double e = 0.0;  // this lane's part of h0 - h1
#pragma unroll
  for (int j = 0; j < EPL; ++j) {
    e += half_energy(theta[j] - mu[j], gc[j], z[j]);
    p[j] = fmaf(0.5f * eps, gc[j], z[j]);
    th[j] = theta[j];
    g[j] = gc[j];
  }
  for (int s = 0; s < num_steps; ++s) {
#pragma unroll
    for (int j = 0; j < EPL; ++j) th[j] = fmaf(eps, p[j], th[j]);
    gradient<G, EPL, DENSE>(th, mu, pr, g, P, row, d, sub);
#pragma unroll
    for (int j = 0; j < EPL; ++j) p[j] = fmaf(eps, g[j], p[j]);
  }
#pragma unroll
  for (int j = 0; j < EPL; ++j) {
    p[j] = fmaf(-0.5f * eps, g[j], p[j]);
    e -= half_energy(th[j] - mu[j], g[j], p[j]);
  }
  const bool accept = group_sum<G>(e) >= logu;
  if (accept) {
#pragma unroll
    for (int j = 0; j < EPL; ++j) {
      theta[j] = th[j];
      gc[j] = g[j];
    }
  }
  return accept;
}

// Fill one ring buffer with the noise of draws n0 .. n0 + nt - 1 of the
// block's cb chains (first chain c0), by threads tid of nthreads: zb holds
// the normals [t][slot][d], lb the log-uniforms [t][slot].
__device__ __forceinline__ void produce(const Args& a, float* zb, double* lb, int n0, int nt,
                                        int c0, int cb, int tid, int nthreads) {
  const int d = a.d, nq = (d + 3) / 4;
  for (int idx = tid; idx < nt * cb * nq; idx += nthreads) {
    const int q = idx % nq, slot = (idx / nq) % cb, t = idx / (nq * cb);
    float z[4] = {0.f, 0.f, 0.f, 0.f};
    if (c0 + slot < a.chains) normals4(a, q, n0 + t, c0 + slot, z);
    float* o = zb + (t * cb + slot) * d + 4 * q;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (4 * q + e < d) o[e] = z[e];
  }
  for (int idx = tid; idx < nt * cb; idx += nthreads) {
    const int slot = idx % cb, t = idx / cb;
    lb[idx] = c0 + slot < a.chains ? log_uniform_at(a, n0 + t, c0 + slot) : 0.0;
  }
}

// this lane's normals of one draw from the ring (p: the lane's first word)
template <int G, int EPL>
__device__ __forceinline__ void ring_load(const float* p, int sub, int d, float (&z)[EPL]) {
#pragma unroll
  for (int j = 0; j < EPL; ++j) z[j] = sub + G * j < d ? p[G * j] : 0.f;
}

// The first `consumers` warps of a block run cpw <= 32 / G chains each (fewer
// than a warp holds where that spreads few chains over more SMs: a chain's
// time is its latency, whatever the lanes beside it do); with RING the
// other warps produce their noise.  Shared memory: RING: log-uniforms
// [2][RING_DRAWS][cb] (float64), normals [2][RING_DRAWS][cb][d]; DENSE:
// P (d x d), then, for G = 32 with EPL > 1, one row of d per warp.
template <int G, int EPL, bool DENSE, bool RING>
__global__ void __launch_bounds__(32 * MAX_WARPS) chain_kernel(Args a, int consumers, int cpw) {
  extern __shared__ double smem[];
  constexpr int T = RING_DRAWS;
  const int d = a.d, S = a.num_samples;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane % G;
  const int cb = consumers * cpw;  // chains per block
  double* ring_lu = smem;
  float* ring_z = reinterpret_cast<float*>(smem + (RING ? 2 * T * cb : 0));
  float* P = ring_z + (RING ? 2 * T * cb * d : 0);
  float* row = P + d * d + warp * d;
  if (DENSE) {
    for (int i = threadIdx.x; i < d * d; i += blockDim.x) P[i] = a.prec[i];
    __syncthreads();
  }
  const int c0 = blockIdx.x * cb;
  const int slot = min(warp * cpw + lane / G, cb - 1);  // lanes beyond cpw chains: no chain
  const int c = c0 + slot;
  // lanes of no chain run on zeros
  const bool active = warp < consumers && lane / G < cpw && c < a.chains;

  float theta[EPL], gc[EPL], mu[EPL], pr[EPL], z[EPL];
#pragma unroll
  for (int j = 0; j < EPL; ++j) {
    const int k = sub + G * j;
    const bool in = active && k < d;
    theta[j] = in ? a.theta0[(long long)c * d + k] : 0.f;
    mu[j] = (in && a.mean) ? a.mean[k] : 0.f;
    pr[j] = (in && !DENSE) ? a.prec[k] : 0.f;
  }
  int accepted = 0;

  if (RING) {
    const int nchunks = (S + T - 1) / T;
    produce(a, ring_z, ring_lu, 0, min(T, S), c0, cb, threadIdx.x, blockDim.x);
    __syncthreads();
    if (warp < consumers) gradient<G, EPL, DENSE>(theta, mu, pr, gc, P, row, d, sub);
    for (int chunk = 0; chunk < nchunks; ++chunk) {
      const int n0 = chunk * T, nt = min(T, S - n0);
      if (warp < consumers) {
        const int stride = cb * d;  // floats per draw of the buffer
        const float* zp = ring_z + (chunk & 1) * T * stride + slot * d + sub;
        const double* lp = ring_lu + (chunk & 1) * T * cb + slot;
        float* o = a.out + ((long long)c * S + n0) * d;
        // the next draw's noise is loaded before this draw's leapfrog
        float zn[EPL];
        double lun = *lp;
        ring_load<G, EPL>(zp, sub, d, zn);
        for (int t = 0; t < nt; ++t) {
          const double logu = lun;
#pragma unroll
          for (int j = 0; j < EPL; ++j) z[j] = zn[j];
          if (t + 1 < nt) {
            zp += stride;
            lp += cb;
            lun = *lp;
            ring_load<G, EPL>(zp, sub, d, zn);
          }
          accepted += one_draw<G, EPL, DENSE>(theta, gc, mu, pr, z, logu, P, row, d, sub,
                                              a.num_steps, a.eps);
          if (active) {
#pragma unroll
            for (int j = 0; j < EPL; ++j) {
              const int k = sub + G * j;
              if (k < d) o[k] = theta[j];
            }
          }
          o += d;
        }
      } else if (chunk + 1 < nchunks) {
        const int b = (chunk + 1) & 1;
        produce(a, ring_z + b * T * cb * d, ring_lu + b * T * cb, n0 + T,
                        min(T, S - n0 - T), c0, cb, threadIdx.x - 32 * consumers,
                        blockDim.x - 32 * consumers);
      }
      __syncthreads();
    }
  } else {
    gradient<G, EPL, DENSE>(theta, mu, pr, gc, P, row, d, sub);
    for (int n = 0; n < S; ++n) {
#pragma unroll
      for (int j = 0; j < EPL; ++j) {
        const int k = sub + G * j;
        z[j] = (active && k < d) ? normal_at(a, k, n, c) : 0.f;
      }
      const double logu = active ? log_uniform_at(a, n, c) : 0.0;
      accepted += one_draw<G, EPL, DENSE>(theta, gc, mu, pr, z, logu, P, row, d, sub,
                                          a.num_steps, a.eps);
      if (active) {
        float* o = a.out + ((long long)c * S + n) * d;
#pragma unroll
        for (int j = 0; j < EPL; ++j) {
          const int k = sub + G * j;
          if (k < d) o[k] = theta[j];
        }
      }
    }
  }
  if (active && sub == 0) a.acc[c] = (float)accepted / (float)S;
}

// ---- variant 4: 16 chains per block on the tensor cores ----

// Shared memory of a block of W consumer warps (and PW > 0 producer warps)
// at Dp = 8 NT W columns, in this order:
//   double part[W][16]       the warps' partial energy sums of a draw
//   double log_u[2][16]      the chains' log-uniforms of this draw and the next
//   float2 Pf[2][Dp/8][Dp/8][32]  P's big, then small parts, in mma fragment order
//   float4 delta[2][2][Dp/8][32]  theta - mean of this step and the last: big,
//                            then small parts, in mma fragment order
//   float  z[2][16][Dp + 8]  the momenta of this draw and the next
template <int NT, int W>
struct MmaShape {
  static constexpr int DP = 8 * NT * W, KT = DP / 8, NTG = DP / 8, LDZ = DP + 8;
};

// out = -(x - mu) P for the block's 16 chains, through the shared tile buf
// (2 KT 32 float4); every consumer thread must call it.  Each thread splits
// its own elements of x - mu once and stores them where the lanes that need
// them as A fragments read 16 bytes at a time: fragment (kt, lane g' 4 + t')
// holds A[g'][8 kt + t'], A[g' + 8][8 kt + t'], A[g'][8 kt + t' + 4],
// A[g' + 8][8 kt + t' + 4].  b_big: the thread's fragments of P's big part.
template <int NT, int W>
__device__ __forceinline__ void mma_gradient(
    const float (&x)[4 * NT], const float (&mu)[4 * NT], float (&out)[4 * NT], float4* buf,
    const float2* __restrict__ Pf, const uint32_t (&b_big)[NT * W][NT][2], int w, int lane) {
  using S = MmaShape<NT, W>;
  constexpr int KT = S::KT, NTG = S::NTG;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int jn = 0; jn < NT; ++jn) {
    // columns 2t, 2t + 1 of k-tile w NT + jn, rows g and g + 8: lanes
    // g 4 + (2t) % 4 and the next, the (x, y) or (z, w) half of their fragment
    float2* o = reinterpret_cast<float2*>(buf + (w * NT + jn) * 32 + g * 4 + (2 * t) % 4) +
                (t >> 1);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      uint32_t b_lo, s_lo, b_hi, s_hi;
      tf32_split_alu(x[4 * jn + e] - mu[4 * jn + e], b_lo, s_lo);
      tf32_split_alu(x[4 * jn + 2 + e] - mu[4 * jn + 2 + e], b_hi, s_hi);
      o[2 * e] = make_float2(__uint_as_float(b_lo), __uint_as_float(b_hi));
      o[2 * e + 2 * KT * 32] = make_float2(__uint_as_float(s_lo), __uint_as_float(s_hi));
    }
  }
  named_barrier(1, 32 * W);  // the consumer warps: each one's columns are every one's K
  // big*big, big*small and small*big each in registers of their own: the
  // small products do not ride on the big sum's rounding, and three chains
  // of dependent mma per tile run side by side
  float acc[NT][4], acc_bs[NT][4], acc_sb[NT][4];
#pragma unroll
  for (int jn = 0; jn < NT; ++jn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[jn][e] = acc_bs[jn][e] = acc_sb[jn][e] = 0.f;
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    const float4 fb = buf[kt * 32 + lane], fs = buf[(KT + kt) * 32 + lane];
    const uint32_t a_big[4] = {__float_as_uint(fb.x), __float_as_uint(fb.y),
                               __float_as_uint(fb.z), __float_as_uint(fb.w)};
    const uint32_t a_small[4] = {__float_as_uint(fs.x), __float_as_uint(fs.y),
                                 __float_as_uint(fs.z), __float_as_uint(fs.w)};
#pragma unroll
    for (int jn = 0; jn < NT; ++jn) {
      const float2 s = Pf[((KT + kt) * NTG + w * NT + jn) * 32 + lane];
      const uint32_t bb0 = b_big[kt][jn][0], bb1 = b_big[kt][jn][1];
      const uint32_t bs0 = __float_as_uint(s.x), bs1 = __float_as_uint(s.y);
      mma_tf32(acc[jn], a_big, bb0, bb1);
      mma_tf32(acc_bs[jn], a_big, bs0, bs1);
      mma_tf32(acc_sb[jn], a_small, bb0, bb1);
    }
  }
#pragma unroll
  for (int r = 0; r < 4 * NT; ++r)
    out[r] = -(acc[r / 4][r & 3] + (acc_bs[r / 4][r & 3] + acc_sb[r / 4][r & 3]));
}

// Blocks of W consumer warps and PW > 0 producer warps.  Consumer thread (warp w,
// g = lane / 4, t = lane % 4) holds, for each of its warp's NT column tiles
// jn, the accumulator elements e = 0..3 of mma.sync.m16n8k8: chain row
// g + 8 (e / 2), column (w NT + jn) 8 + 2 t + e % 2.  The producers fill the
// next draw's momenta and log-uniforms while the consumers run this draw's
// steps.  P's big fragments of the thread's columns stay in registers.
template <int NT, int W, int PW>
__global__ void __launch_bounds__(32 * (W + PW)) mma_kernel(Args a) {
  using Sh = MmaShape<NT, W>;
  constexpr int DP = Sh::DP, KT = Sh::KT, NTG = Sh::NTG, LDZ = Sh::LDZ, R = 4 * NT;
  extern __shared__ double smem[];
  double* part = smem;
  double* log_u = part + W * MMA_ROWS;
  float2* Pf = reinterpret_cast<float2*>(log_u + 2 * MMA_ROWS);
  float4* delta = reinterpret_cast<float4*>(Pf + 2 * KT * NTG * 32);
  float* zring = reinterpret_cast<float*>(delta + 2 * 2 * KT * 32);
  const int d = a.d, S = a.num_samples;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int c0 = blockIdx.x * MMA_ROWS;

  // P, split once, in fragment order: lane's (b0, b1) of the big parts, and
  // KT NTG 32 pairs further on those of the small parts
  for (int idx = threadIdx.x; idx < KT * NTG * 32; idx += blockDim.x) {
    const int l = idx & 31, n = (idx >> 5) % NTG, kt = (idx >> 5) / NTG;
    const int col = n * 8 + (l >> 2), k0 = kt * 8 + (l & 3), k1 = k0 + 4;
    const float v0 = (k0 < d && col < d) ? a.prec[k0 * d + col] : 0.f;
    const float v1 = (k1 < d && col < d) ? a.prec[k1 * d + col] : 0.f;
    float2 big, small;
    tf32_split(v0, big.x, small.x);
    tf32_split(v1, big.y, small.y);
    Pf[idx] = big;
    Pf[idx + KT * NTG * 32] = small;
  }

  // producers: draw n's momenta [16][LDZ] and log-uniforms into buffer n % 2
  auto produce = [&](int n) {
    const int tid = threadIdx.x - 32 * W;
    float* zb = zring + (n & 1) * MMA_ROWS * LDZ;
    for (int idx = tid; idx < MMA_ROWS * (DP / 4); idx += 32 * PW) {
      const int row = idx / (DP / 4), q = idx % (DP / 4);
      float z[4] = {0.f, 0.f, 0.f, 0.f};
      if (c0 + row < a.chains && 4 * q < d) normals4(a, q, n, c0 + row, z);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (4 * q + e >= d) z[e] = 0.f;
      *reinterpret_cast<float4*>(zb + row * LDZ + 4 * q) = make_float4(z[0], z[1], z[2], z[3]);
    }
    if (tid < MMA_ROWS)
      log_u[(n & 1) * MMA_ROWS + tid] = c0 + tid < a.chains ? log_uniform_at(a, n, c0 + tid) : 0.0;
  };

  if (w >= W) {
    produce(0);
    __syncthreads();  // P and draw 0's noise are in place
    for (int n = 0; n < S; ++n) {
      if (n + 1 < S) produce(n + 1);
      __syncthreads();  // the consumers' energy barrier of draw n
    }
    return;
  }

  const int c_lo = c0 + g, c_hi = c_lo + 8;
  const bool in_lo = c_lo < a.chains, in_hi = c_hi < a.chains;
  float theta[R], gc[R], th[R], gr[R], p[R], mu[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int col = (w * NT + r / 4) * 8 + 2 * t + (r & 1);
    const int c = (r & 2) ? c_hi : c_lo;
    const bool in = col < d && c < a.chains;
    theta[r] = in ? a.theta0[(long long)c * d + col] : 0.f;
    mu[r] = (col < d && a.mean) ? a.mean[col] : 0.f;
  }
  __syncthreads();  // P (and draw 0's noise) are in place
  uint32_t b_big[KT][NT][2];
#pragma unroll
  for (int kt = 0; kt < KT; ++kt)
#pragma unroll
    for (int jn = 0; jn < NT; ++jn) {
      const float2 b = Pf[(kt * NTG + w * NT + jn) * 32 + lane];
      b_big[kt][jn][0] = __float_as_uint(b.x);
      b_big[kt][jn][1] = __float_as_uint(b.y);
    }
  int it = 0;  // gradients done: picks the buffer of theta - mean
  mma_gradient<NT, W>(theta, mu, gc, delta + (it++ & 1) * 2 * KT * 32, Pf, b_big, w, lane);
  int acc_lo = 0, acc_hi = 0;
  for (int n = 0; n < S; ++n) {
    const float* zb = zring + (n & 1) * MMA_ROWS * LDZ;
#pragma unroll
    for (int r = 0; r < R; r += 2) {
      const int col = (w * NT + r / 4) * 8 + 2 * t;
      const float2 z = *reinterpret_cast<const float2*>(zb + (g + ((r & 2) ? 8 : 0)) * LDZ + col);
      p[r] = z.x, p[r + 1] = z.y;
    }
    const double logu_lo = log_u[(n & 1) * MMA_ROWS + g];
    const double logu_hi = log_u[(n & 1) * MMA_ROWS + g + 8];
    double e_lo = 0.0, e_hi = 0.0;  // this thread's part of h0 - h1, per chain row
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float z = p[r];
      const double e = half_energy(theta[r] - mu[r], gc[r], z);
      if (r & 2) e_hi += e; else e_lo += e;
      p[r] = fmaf(0.5f * a.eps, gc[r], z);
      th[r] = theta[r];
      gr[r] = gc[r];
    }
    for (int s = 0; s < a.num_steps; ++s) {
#pragma unroll
      for (int r = 0; r < R; ++r) th[r] = fmaf(a.eps, p[r], th[r]);
      mma_gradient<NT, W>(th, mu, gr, delta + (it++ & 1) * 2 * KT * 32, Pf, b_big, w, lane);
#pragma unroll
      for (int r = 0; r < R; ++r) p[r] = fmaf(a.eps, gr[r], p[r]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      p[r] = fmaf(-0.5f * a.eps, gr[r], p[r]);
      const double e = half_energy(th[r] - mu[r], gr[r], p[r]);
      if (r & 2) e_hi -= e; else e_lo -= e;
    }
    // a chain's sum: over the 4 lanes of its quad, then over the warps
    e_lo = group_sum<4>(e_lo);
    e_hi = group_sum<4>(e_hi);
    if (t == 0) {
      part[w * MMA_ROWS + g] = e_lo;
      part[w * MMA_ROWS + g + 8] = e_hi;
    }
    // the whole block: the producers have the next draw's noise in place;
    // part is next written after the next draw's step barriers
    __syncthreads();
    double dh_lo = 0.0, dh_hi = 0.0;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      dh_lo += part[i * MMA_ROWS + g];
      dh_hi += part[i * MMA_ROWS + g + 8];
    }
    const bool ok_lo = dh_lo >= logu_lo, ok_hi = dh_hi >= logu_hi;
    acc_lo += ok_lo;
    acc_hi += ok_hi;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if ((r & 2) ? ok_hi : ok_lo) {
        theta[r] = th[r];
        gc[r] = gr[r];
      }
      const int col = (w * NT + r / 4) * 8 + 2 * t + (r & 1);
      const int c = (r & 2) ? c_hi : c_lo;
      if (col < d && c < a.chains) a.out[((long long)c * S + n) * d + col] = theta[r];
    }
  }
  if (w == 0 && t == 0) {
    if (in_lo) a.acc[c_lo] = (float)acc_lo / (float)S;
    if (in_hi) a.acc[c_hi] = (float)acc_hi / (float)S;
  }
}

// ---- variant 5: any D ----

__device__ __forceinline__ float mean_at(const Args& a, int k) { return a.mean ? a.mean[k] : 0.f; }

// ---- variant 5, diagonal P: the state in registers ----
//
// A chain's elements are spread over a team of tpc threads; thread t of the
// team holds the GPT groups of 4 neighbouring elements q = t + tpc j (the
// four normals of one Philox draw) and keeps theta and the trajectory's
// theta and p of each in registers; the gradient -(theta - mean) P is
// recomputed where it is needed (the same bits as storing it).
//   THREADS = 256 (D <= DIAG_MAX_D): 256 / tpc chains a block of tpc = 32-256
//   threads each, the mean and P of each element in registers too; no shared
//   memory but the team warps' float64 energy partials and the log-uniforms
//   of two draws (so one block barrier a draw), so many blocks share an SM.
//   THREADS = 1024 (DIAG_MAX_D < D <= DIAG_WIDE_MAX_D): one chain a block of
//   tpc = 1024 threads, 2 or 3 groups a thread; the mean and P (the same for
//   every chain) in the block's shared memory, read again at each use (a
//   thread's 64 registers hold only the state: 12 floats a group).
constexpr int DIAG_THREADS = 256;
constexpr int DIAG_MAX_D = 4096;  // 4 GPT tpc at GPT = 4, tpc = 256
constexpr int DIAG_WIDE_THREADS = 1024;
constexpr int DIAG_WIDE_MAX_D = 12288;  // 4 GPT tpc at GPT = 3, tpc = 1024

// bytes of the THREADS = 1024 form's shared memory: the mean and P of the
// GPT x 1024 groups of 4 elements, zero beyond D
constexpr size_t diag_wide_shared(int gpt) { return 2 * 16 * (size_t)gpt * DIAG_WIDE_THREADS; }

// a float4 of shared memory, loaded where it is used (never hoisted into
// registers that the state needs)
__device__ __forceinline__ float4 lds4(const float4* p) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(smem_addr(p)));
  return v;
}

template <int GPT, int THREADS>
__global__ void __launch_bounds__(THREADS) diag_kernel(Args a, int tpc) {
  constexpr int WARPS = THREADS / 32;
  constexpr bool REGS = THREADS == DIAG_THREADS;  // the mean and P in registers
  __shared__ double part[2][WARPS];
  __shared__ double log_u[2][WARPS];  // one a team (at most WARPS teams)
  extern __shared__ float4 cst[];  // THREADS = 1024: mean [GPT THREADS], then P [GPT THREADS]
  const int d = a.d, S = a.num_samples, L = a.num_steps;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int team = threadIdx.x / tpc, t = threadIdx.x % tpc, wpt = tpc / 32;
  const int c = blockIdx.x * (THREADS / tpc) + team;
  const bool active = c < a.chains;
  const float eps = a.eps;

  float theta[GPT][4], mu[REGS ? GPT : 1][4], pr[REGS ? GPT : 1][4];
#pragma unroll
  for (int j = 0; j < GPT; ++j) {
    const int q = t + tpc * j;
    float m[4], r[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = 4 * q + e;
      const bool in = active && k < d;
      theta[j][e] = in ? a.theta0[(long long)c * d + k] : 0.f;
      m[e] = (k < d && a.mean) ? a.mean[k] : 0.f;
      r[e] = k < d ? a.prec[k] : 0.f;
      if (REGS) mu[j][e] = active ? m[e] : 0.f, pr[j][e] = active ? r[e] : 0.f;
    }
    if (!REGS) {
      cst[q] = make_float4(m[0], m[1], m[2], m[3]);
      cst[GPT * THREADS + q] = make_float4(r[0], r[1], r[2], r[3]);
    }
  }
  if (!REGS) __syncthreads();
  // the mean and P of group j of this thread
  auto consts = [&](int j, float (&m)[4], float (&r)[4]) {
    if (REGS) {
#pragma unroll
      for (int e = 0; e < 4; ++e) m[e] = mu[REGS ? j : 0][e], r[e] = pr[REGS ? j : 0][e];
    } else {
      const float4 mv = lds4(cst + t + tpc * j), rv = lds4(cst + GPT * THREADS + t + tpc * j);
      m[0] = mv.x, m[1] = mv.y, m[2] = mv.z, m[3] = mv.w;
      r[0] = rv.x, r[1] = rv.y, r[2] = rv.z, r[3] = rv.w;
    }
  };
  int accepted = 0;
  for (int n = 0; n < S; ++n) {
    float th[GPT][4], p[GPT][4];
    double e_sum = 0.0;  // this thread's part of h0 - h1
#pragma unroll
    for (int j = 0; j < GPT; ++j) {
      const int q = t + tpc * j;
      float z[4] = {0.f, 0.f, 0.f, 0.f}, m[4], r[4];
      if (active && 4 * q < d) normals4(a, q, n, c, z);
      consts(j, m, r);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = 4 * q + e;
        const float zj = k < d ? z[e] : 0.f;
        const float gc = -(theta[j][e] - m[e]) * r[e];
        if (k < d) e_sum += half_energy(theta[j][e] - m[e], gc, zj);
        p[j][e] = fmaf(0.5f * eps, gc, zj);
        th[j][e] = theta[j][e];
      }
    }
    for (int s = 0; s < L; ++s)
#pragma unroll
      for (int j = 0; j < GPT; ++j) {
        float m[4], r[4];
        consts(j, m, r);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          th[j][e] = fmaf(eps, p[j][e], th[j][e]);
          const float g = -(th[j][e] - m[e]) * r[e];
          p[j][e] = fmaf(eps, g, p[j][e]);
        }
      }
#pragma unroll
    for (int j = 0; j < GPT; ++j) {
      float m[4], r[4];
      consts(j, m, r);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = 4 * (t + tpc * j) + e;
        const float g = -(th[j][e] - m[e]) * r[e];
        const float pe = fmaf(-0.5f * eps, g, p[j][e]);
        if (k < d) e_sum -= half_energy(th[j][e] - m[e], g, pe);
      }
    }
    // the chain's sum: over each warp by shuffles, then over the team's warps in order
    const double v = warp_sum(e_sum);
    if (lane == 0) part[n & 1][warp] = v;
    if (t == 0) log_u[n & 1][team] = active ? log_uniform_at(a, n, c) : 0.0;
    __syncthreads();  // part[n & 1] is next written after the next draw's barrier
    double dh = 0.0;
    for (int w = 0; w < wpt; ++w) dh += part[n & 1][team * wpt + w];
    const bool ok = dh >= log_u[n & 1][team];
    accepted += ok;
    float* o = a.out + ((long long)c * S + n) * d;
#pragma unroll
    for (int j = 0; j < GPT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = 4 * (t + tpc * j) + e;
        if (ok) theta[j][e] = th[j][e];
        if (active && k < d) o[k] = theta[j][e];
      }
  }
  if (active && t == 0) a.acc[c] = (float)accepted / (float)S;
}

// ---- variant 5, dense P: one product a step across the grid, on the tensor cores ----
//
// Each leapfrog step's gradients of all C chains are one product,
// G^T = -P^T Delta^T with Delta = theta - mean (C, D): P^T's rows are the
// M operand of mma.sync.m16n8k8 (tf32), the chains its N.  A tile is
// DT_ROWS = 128 rows (elements of the gradient) by BN = 8, 16, 32 or 64
// chains; one persistent block of DT_THREADS walks the tiles item =
// blockIdx.x + k gridDim.x (the same ones every step), the grid no larger
// than the card holds at once (a cooperative launch refuses a larger one),
// and a grid barrier follows each step's product.  K is walked in chunks of
// DT_CHUNK = 64 rows of P, DT_STAGES chunks in flight (cp.async into a ring
// of shared memory): each chunk's big*big and big*small + small*big products
// (3xTF32, each operand split by tf32_split_alu as it is read) go into
// accumulators of their own, added in order into the tile's float32 total
// at the chunk's end (the tensor cores' accumulation truncates, and one
// float32 sum over all D rows drifts from float64 about 3x further than
// torch.matmul's product does at D in the thousands; sums of 64 rows drift
// less than it: scripts/gaussian_sum_order_torch.py emulates the orders).  The tile's epilogue kicks and drifts its own
// (chain, element) entries and writes the next step's Delta, in B-fragment
// order, into the other half of a double buffer, so no tile overwrites a
// Delta that another still reads before the barrier.  The state (theta, its
// gradient, the trajectory's theta, p and gradient) lives in device memory
// (L2 at D = 1024 and 1024 chains: 4 MiB an array); the trajectory's theta
// and p, which every step reads and writes, in the epilogue's own order.
// Per draw the energy is one float64 partial per (tile row, chain), summed
// in a fixed order after the draw's barrier (h0's partials in two buffers
// by the draw's parity: a tile sums draw n's while the others write draw
// n + 1's): no atomics, so a run is deterministic.  Scratch
// (dense_scratch): P^T zero-padded to Dp x Dp (Dp = D rounded up to 128) in
// A-fragment order, the two Delta buffers (Dp x Cp, Cp = C rounded up to
// BN), the five state arrays, the energy partials, the accept counts and
// the barrier's counter.

constexpr int DT_ROWS = 128;
constexpr int DT_CHUNK = 64;
constexpr int DT_STAGES = 4;
constexpr int DT_THREADS = 256;

// bytes of dense_grid_kernel's shared memory: DT_STAGES chunks of a tile's
// two operands and the float64 energy partials of its 8 / WN rows of warps
constexpr size_t dense_shared_bytes(int bn, int wn) {
  return (size_t)DT_STAGES * (DT_ROWS + bn) * DT_CHUNK * 4 + (size_t)(8 / wn) * bn * 8;
}

struct DenseArgs {
  Args a;
  float* pt;     // [Dp/64][Dp/16][8][32][4]: P^T, A fragments by (chunk, m16 tile, k8 slice)
  float* delta;  // [2][Dp/64][Cp/8][8][32][2]: Delta, B fragments by (chunk, n8 tile, k8 slice)
  float *theta, *gc, *gt;  // (C, D): the state, its gradient, the trajectory's gradient
  float *th, *p;  // the trajectory's theta and p, in accumulator order (frag_pos), Dp x Cp
  double* e0;  // [2][n_mt][Cp]: each tile row's part of h0 per chain, of even and odd draws
  double* e1;  // [n_mt][Cp]: each tile row's part of h1 per chain
  int* count;       // [Cp] accepted draws (kept by the blocks of tile row 0)
  unsigned int* bar;
  long long* phases;  // device, DENSE_PHASES counters; null: not counted
  int dp, cp, n_mt, n_nt;
};

// where Delta[c][k] lies in one buffer: B[k][n = c] of mma.sync's B fragment
// (lane (c % 8) 4 + k % 4, register (k / 4) % 2)
__device__ __forceinline__ size_t b_pos(int c, int k, int cp) {
  return ((((size_t)(k >> 6) * (cp >> 3) + (c >> 3)) * 8 + ((k >> 3) & 7)) * 32 + (c & 7) * 4 +
          (k & 3)) * 2 + ((k >> 2) & 1);
}

// Carves the scratch of a dense run with BN chains a tile out of `base`
// (null: only counts); returns its bytes.  Each array starts 256-byte aligned.
inline size_t dense_scratch(DenseArgs* s, char* base, int chains, int d, int bn) {
  const int dp = (d + DT_ROWS - 1) / DT_ROWS * DT_ROWS, cp = (chains + bn - 1) / bn * bn;
  const int n_mt = dp / DT_ROWS;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* at = base ? base + off : nullptr;
    off += (bytes + 255) / 256 * 256;
    return at;
  };
  const size_t cd = (size_t)chains * d * sizeof(float), tiles = (size_t)dp * cp * sizeof(float);
  float* pt = (float*)take((size_t)dp * dp * sizeof(float));
  float* delta = (float*)take(2 * tiles);
  float* state[5];
  for (int i = 0; i < 5; ++i) state[i] = (float*)take(i < 3 ? cd : tiles);
  double* e0 = (double*)take(2 * (size_t)n_mt * cp * sizeof(double));
  double* e1 = (double*)take((size_t)n_mt * cp * sizeof(double));
  int* count = (int*)take((size_t)cp * sizeof(int));
  unsigned int* bar = (unsigned int*)take(sizeof(unsigned int));
  if (s) {
    s->pt = pt, s->delta = delta;
    s->theta = state[0], s->gc = state[1], s->gt = state[2], s->th = state[3], s->p = state[4];
    s->e0 = e0, s->e1 = e1, s->count = count, s->bar = bar;
    s->dp = dp, s->cp = cp, s->n_mt = n_mt, s->n_nt = cp / bn;
  }
  return off;
}

// tot[mi][ni] = -(G^T) of tile (mt, nt): P^T's rows mt 128 .. + 127 times the
// Delta of `src` for chains nt BN .. + BN - 1, in the accumulator layout of
// warp (wm, wn)'s m16 tiles wm MI + mi and n8 tiles wn NI + ni.  Every
// thread of the block must call it.
template <int MI, int NI, int WN>
__device__ __forceinline__ void dense_product(const DenseArgs& s, const float* src, int mt, int nt,
                                              float* stages, float (&tot)[MI][NI][4]) {
  constexpr int BN = 8 * NI * WN, A_ST = DT_ROWS * DT_CHUNK, B_ST = BN * DT_CHUNK;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int nkc = s.dp / DT_CHUNK;
  float* as = stages;
  float* bs = stages + DT_STAGES * A_ST;
  const float* a_src = s.pt + (size_t)mt * (DT_ROWS / 16) * 1024;
  const size_t a_step = (size_t)(s.dp / 16) * 1024;  // floats from one chunk to the next
  const float* b_src = src + (size_t)nt * (BN / 8) * 512;
  const size_t b_step = (size_t)(s.cp / 8) * 512;
  auto load = [&](int kc) {
    float* ad = as + (kc % DT_STAGES) * A_ST;
    const float* ag = a_src + kc * a_step;
    for (int i = threadIdx.x; i < A_ST / 4; i += DT_THREADS) cp_async16(ad + 4 * i, ag + 4 * i);
    float* bd = bs + (kc % DT_STAGES) * B_ST;
    const float* bg = b_src + kc * b_step;
    for (int i = threadIdx.x; i < B_ST / 4; i += DT_THREADS) cp_async16(bd + 4 * i, bg + 4 * i);
  };
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) tot[mi][ni][e] = 0.f;
#pragma unroll
  for (int kc = 0; kc < DT_STAGES - 1; ++kc) {
    if (kc < nkc) load(kc);
    cp_async_commit();
  }
  for (int kc = 0; kc < nkc; ++kc) {
    cp_async_wait<DT_STAGES - 2>();
    __syncthreads();  // chunk kc is in; every warp is done with chunk kc - 1's stage
    if (kc + DT_STAGES - 1 < nkc) load(kc + DT_STAGES - 1);
    cp_async_commit();
    const float4* at = reinterpret_cast<const float4*>(as + (kc % DT_STAGES) * A_ST);
    const float2* bt = reinterpret_cast<const float2*>(bs + (kc % DT_STAGES) * B_ST);
    float acc_b[MI][NI][4], acc_s[MI][NI][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc_b[mi][ni][e] = acc_s[mi][ni][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DT_CHUNK / 8; ++ks) {
      uint32_t a_big[MI][4], a_small[MI][4], b_big[NI][2], b_small[NI][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const int i = ((wm * MI + mi) * 8 + ks) * 32 + lane;
        const float4 v = at[i];
        tf32_split_alu(v.x, a_big[mi][0], a_small[mi][0]);
        tf32_split_alu(v.y, a_big[mi][1], a_small[mi][1]);
        tf32_split_alu(v.z, a_big[mi][2], a_small[mi][2]);
        tf32_split_alu(v.w, a_big[mi][3], a_small[mi][3]);
      }
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int i = ((wn * NI + ni) * 8 + ks) * 32 + lane;
        const float2 v = bt[i];
        tf32_split_alu(v.x, b_big[ni][0], b_small[ni][0]);
        tf32_split_alu(v.y, b_big[ni][1], b_small[ni][1]);
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
          mma_tf32(acc_b[mi][ni], a_big[mi], b_big[ni][0], b_big[ni][1]);
          mma_tf32(acc_s[mi][ni], a_big[mi], b_small[ni][0], b_small[ni][1]);
          mma_tf32(acc_s[mi][ni], a_small[mi], b_big[ni][0], b_big[ni][1]);
        }
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) tot[mi][ni][e] += acc_b[mi][ni][e] + acc_s[mi][ni][e];
  }
  __syncthreads();  // the stages are refilled by the next product
}

enum DenseMode { DENSE_INIT, DENSE_STEP, DENSE_LAST };

// Where entry (chain c, element k) of p and the trajectory's theta lies: in
// the accumulator order of the tile that owns it (tile, warp, m16 tile mi,
// n8 tile ni, lane, register), so that each epilogue thread reads and
// writes its entries 16 bytes at a time.
template <int MI, int NI, int WN>
__device__ __forceinline__ size_t frag_pos(const DenseArgs& s, int c, int k) {
  constexpr int BN = 8 * NI * WN;
  const int r = k % DT_ROWS, cc = c % BN, m16 = r >> 4, n8 = cc >> 3;
  const int warp = (m16 / MI) * WN + n8 / NI;
  const int lane = (r & 7) * 4 + ((cc & 7) >> 1), e = ((r >> 3) & 1) * 2 + (cc & 1);
  const size_t tile = (size_t)(c / BN) * s.n_mt + k / DT_ROWS;
  return (((tile * 8 + warp) * MI + m16 % MI) * NI + n8 % NI) * 128 + lane * 4 + e;
}

// The epilogue of tile (mt, nt) with g = -tot: INIT stores the gradient at
// theta; STEP kicks, drifts and writes the next Delta into dst; LAST kicks,
// pulls half a kick back, keeps the gradient for the accept and sums the
// tile row's part of h1 per chain into e1 (red: [8 / WN][BN] doubles of
// shared memory).  p and theta are loaded, all of them, before any store
// (a store may alias a later load, which would otherwise wait for it).
// Every thread of the block must call it.
template <int MI, int NI, int WN>
__device__ __forceinline__ void dense_epilogue(const DenseArgs& s, DenseMode mode, int mt, int nt,
                                               const float (&tot)[MI][NI][4], float* dst,
                                               double* red) {
  constexpr int BN = 8 * NI * WN, WM = 8 / WN;
  const Args& a = s.a;
  const int d = a.d, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / WN, wn = warp % WN, g = lane >> 2, t = lane & 3;
  const float eps = a.eps;
  if (mode == DENSE_INIT) {
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = mt * DT_ROWS + (wm * MI + mi) * 16 + g + 8 * (e >> 1);
          const int c = nt * BN + (wn * NI + ni) * 8 + 2 * t + (e & 1);
          if (i < d && c < a.chains) s.gc[(size_t)c * d + i] = -tot[mi][ni][e];
        }
    return;
  }
  const size_t base = (((size_t)nt * s.n_mt + mt) * 8 + warp) * MI * NI * 128 + lane * 4;
  float4 p4[MI][NI], th4[MI][NI];
  float mu[MI][2];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      p4[mi][ni] = *reinterpret_cast<const float4*>(s.p + base + (mi * NI + ni) * 128);
      th4[mi][ni] = *reinterpret_cast<const float4*>(s.th + base + (mi * NI + ni) * 128);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = mt * DT_ROWS + (wm * MI + mi) * 16 + g + 8 * h;
      mu[mi][h] = i < d ? mean_at(a, i) : 0.f;
    }
  }
  double e1[NI][2];
#pragma unroll
  for (int ni = 0; ni < NI; ++ni) e1[ni][0] = e1[ni][1] = 0.0;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      float pv[4] = {p4[mi][ni].x, p4[mi][ni].y, p4[mi][ni].z, p4[mi][ni].w};
      float thv[4] = {th4[mi][ni].x, th4[mi][ni].y, th4[mi][ni].z, th4[mi][ni].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = mt * DT_ROWS + (wm * MI + mi) * 16 + g + 8 * (e >> 1);
        const int c = nt * BN + (wn * NI + ni) * 8 + 2 * t + (e & 1);
        const bool in = i < d && c < a.chains;
        const float gr = -tot[mi][ni][e];
        pv[e] = fmaf(eps, gr, pv[e]);
        if (mode == DENSE_STEP) {
          thv[e] = fmaf(eps, pv[e], thv[e]);
          if (in) dst[b_pos(c, i, s.cp)] = thv[e] - mu[mi][e >> 1];
        } else if (in) {
          const float pe = fmaf(-0.5f * eps, gr, pv[e]);
          e1[ni][e & 1] += half_energy(thv[e] - mu[mi][e >> 1], gr, pe);
          s.gt[(size_t)c * d + i] = gr;
        }
      }
      if (mode == DENSE_STEP) {
        *reinterpret_cast<float4*>(s.p + base + (mi * NI + ni) * 128) =
            make_float4(pv[0], pv[1], pv[2], pv[3]);
        *reinterpret_cast<float4*>(s.th + base + (mi * NI + ni) * 128) =
            make_float4(thv[0], thv[1], thv[2], thv[3]);
      }
    }
  if (mode != DENSE_LAST) return;
  // a chain's sum: over the lanes of its column (g) by shuffles, over the warps in order
#pragma unroll
  for (int ni = 0; ni < NI; ++ni)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      double v = e1[ni][j];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (g == 0) red[wm * BN + (wn * NI + ni) * 8 + 2 * t + j] = v;
    }
  __syncthreads();
  if (threadIdx.x < BN) {
    const int c = nt * BN + threadIdx.x;
    double v = 0.0;
#pragma unroll
    for (int w = 0; w < WM; ++w) v += red[w * BN + threadIdx.x];
    if (c < a.chains) s.e1[(size_t)mt * s.cp + c] = v;
  }
  // red is next written after the next product's first block barrier
}

// Between two draws, for tile (mt, nt)'s entries: the accept of draw `prev`
// (none if < 0; its draws and, after the last, the acceptance rate written
// out), then the start of draw `next` (none if == S): momenta, the half
// kick, the first drift, the tile row's part of h0 per chain and the first
// Delta into dst.  Warp w takes the tile's chains w, w + 8, ..., lane l the
// group of 4 elements mt 32 + l.
template <int MI, int NI, int WN>
__device__ __forceinline__ void dense_between_draws(const DenseArgs& s, int mt, int nt, int prev,
                                                    int next, float* dst) {
  constexpr int BN = 8 * NI * WN;
  const Args& a = s.a;
  const int d = a.d, S = a.num_samples, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float eps = a.eps;
  const int q = mt * (DT_ROWS / 4) + lane;
  for (int cl = warp; cl < BN; cl += DT_THREADS / 32) {
    const int c = nt * BN + cl;
    if (c >= a.chains) break;
    bool ok = false;
    if (prev >= 0) {
      // every lane sums the same partials in the same order; h0's are those of
      // draw prev's parity (the other tiles write draw next's meanwhile)
      const double* h0 = s.e0 + (size_t)(prev & 1) * s.n_mt * s.cp;
      double dh = 0.0;
      for (int m = 0; m < s.n_mt; ++m)
        dh += __ldcg(h0 + (size_t)m * s.cp + c) - __ldcg(s.e1 + (size_t)m * s.cp + c);
      ok = dh >= log_uniform_at(a, prev, c);
      if (mt == 0 && lane == 0) {
        const int n_acc = s.count[c] + ok;
        s.count[c] = n_acc;
        if (prev == S - 1) a.acc[c] = (float)n_acc / (float)S;
      }
    }
    float z[4] = {0.f, 0.f, 0.f, 0.f};
    if (next < S && 4 * q < d) normals4(a, q, next, c, z);
    // the four elements' state, all loaded before any store
    float theta[4], gc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = 4 * q + j;
      const size_t ck = (size_t)c * d + k;
      theta[j] = gc[j] = 0.f;
      if (k < d) {
        theta[j] = ok ? s.th[frag_pos<MI, NI, WN>(s, c, k)] : s.theta[ck];
        gc[j] = ok ? s.gt[ck] : s.gc[ck];
      }
    }
    double e0 = 0.0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = 4 * q + j;
      if (k >= d) continue;
      const size_t ck = (size_t)c * d + k;
      if (ok) {
        s.theta[ck] = theta[j];
        s.gc[ck] = gc[j];
      }
      if (prev >= 0) a.out[((size_t)c * S + prev) * d + k] = theta[j];
      if (next < S) {
        const float mu = mean_at(a, k);
        e0 += half_energy(theta[j] - mu, gc[j], z[j]);
        const float pv = fmaf(0.5f * eps, gc[j], z[j]);
        const float thv = fmaf(eps, pv, theta[j]);
        const size_t f = frag_pos<MI, NI, WN>(s, c, k);
        s.p[f] = pv;
        s.th[f] = thv;
        dst[b_pos(c, k, s.cp)] = thv - mu;
      }
    }
    if (next < S) {
      e0 = warp_sum(e0);
      if (lane == 0) s.e0[((size_t)(next & 1) * s.n_mt + mt) * s.cp + c] = e0;
    }
  }
}

// The whole run in one cooperative launch: warps of MI x NI m16 x n8 tiles
// each, WN of them across a tile's chains and 8 / WN across its rows.
// PHASES: thread 0 of each block adds the cycles of the draws' phases (the
// steps' products, their epilogues, the grid barriers, the work between
// draws) into s.phases (DensePhase order); the set-up before the first
// draw is in none.  Every draw is timed: on an H100 the counting kernel
// takes ~1.1% longer at 1,024 chains of D = 250 and 0.5-0.75% at 4, and
// timing one draw in 4 or 8 took no less (the laps' code in the step loop
// costs, not the clock reads it makes).
enum DensePhase { kDenseProduct, kDenseEpilogue, kDenseBarrier, kDenseBetweenDraws, DENSE_PHASES };
template <int MI, int NI, int WN, bool PHASES = false>
__global__ void __launch_bounds__(DT_THREADS, 1) dense_grid_kernel(DenseArgs s) {
  constexpr int BN = 8 * NI * WN;
  static_assert(MI * (8 / WN) * 16 == DT_ROWS, "the warps' rows make up a tile's");
  extern __shared__ double smem[];
  float* stages = reinterpret_cast<float*>(smem);
  double* red = reinterpret_cast<double*>(stages + DT_STAGES * (DT_ROWS + BN) * DT_CHUNK);
  const Args& a = s.a;
  const int d = a.d, S = a.num_samples, L = a.num_steps;
  const int n_items = s.n_mt * s.n_nt;
  const size_t buf = (size_t)s.dp * s.cp;  // floats of one Delta buffer
  const size_t nthreads = (size_t)gridDim.x * DT_THREADS;
  const size_t tid = (size_t)blockIdx.x * DT_THREADS + threadIdx.x;
  unsigned int target = 0;

  // P^T in A-fragment order, Delta at theta0 (buffer 0; zero padding), the state
  for (size_t idx = tid; idx < (size_t)s.dp * s.dp; idx += nthreads) {
    const int e = idx & 3, l = (idx >> 2) & 31, ks = (idx >> 7) & 7;
    const size_t rest = idx >> 10;
    const int mi = rest % (s.dp / 16), kc = rest / (s.dp / 16);
    const int i = mi * 16 + (l >> 2) + 8 * (e & 1);
    const int k = kc * DT_CHUNK + ks * 8 + (l & 3) + 4 * (e >> 1);
    s.pt[idx] = (i < d && k < d) ? a.prec[(size_t)k * d + i] : 0.f;
  }
  for (size_t idx = tid; idx < buf; idx += nthreads) {
    const int e = idx & 1, l = (idx >> 1) & 31, ks = (idx >> 6) & 7;
    const size_t rest = idx >> 9;
    const int n8 = rest % (s.cp / 8), kc = rest / (s.cp / 8);
    const int c = n8 * 8 + (l >> 2), k = kc * DT_CHUNK + ks * 8 + (l & 3) + 4 * e;
    s.delta[idx] = (c < a.chains && k < d) ? a.theta0[(size_t)c * d + k] - mean_at(a, k) : 0.f;
  }
  for (size_t idx = tid; idx < buf; idx += nthreads) s.delta[buf + idx] = 0.f;
  for (size_t idx = tid; idx < (size_t)a.chains * d; idx += nthreads) s.theta[idx] = a.theta0[idx];
  for (size_t idx = tid; idx < (size_t)s.cp; idx += nthreads) s.count[idx] = 0;
  grid_barrier(s.bar, target);

  float tot[MI][NI][4];
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {  // the gradient at theta0
    const int mt = item % s.n_mt, nt = item / s.n_mt;
    dense_product<MI, NI, WN>(s, s.delta, mt, nt, stages, tot);
    dense_epilogue<MI, NI, WN>(s, DENSE_INIT, mt, nt, tot, nullptr, red);
  }
  grid_barrier(s.bar, target);
  PhaseClock<PHASES, DENSE_PHASES> phase_clock(threadIdx.x == 0 && blockIdx.x < n_items,
                                               s.phases);
  phase_clock.start();
  int cur = 0;  // the Delta buffer the next product reads
  for (int n = 0; n < S; ++n) {
    for (int item = blockIdx.x; item < n_items; item += gridDim.x)
      dense_between_draws<MI, NI, WN>(s, item % s.n_mt, item / s.n_mt, n - 1, n,
                                      s.delta + cur * buf);
    phase_clock.lap(kDenseBetweenDraws);
    grid_barrier(s.bar, target);
    phase_clock.lap(kDenseBarrier);
    for (int step = 0; step < L; ++step) {
      const DenseMode mode = step + 1 < L ? DENSE_STEP : DENSE_LAST;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        const int mt = item % s.n_mt, nt = item / s.n_mt;
        dense_product<MI, NI, WN>(s, s.delta + cur * buf, mt, nt, stages, tot);
        phase_clock.lap(kDenseProduct);
        dense_epilogue<MI, NI, WN>(s, mode, mt, nt, tot, s.delta + (cur ^ 1) * buf, red);
        phase_clock.lap(kDenseEpilogue);
      }
      if (mode == DENSE_STEP) cur ^= 1;
      grid_barrier(s.bar, target);
      phase_clock.lap(kDenseBarrier);
    }
  }
  for (int item = blockIdx.x; item < n_items; item += gridDim.x)
    dense_between_draws<MI, NI, WN>(s, item % s.n_mt, item / s.n_mt, S - 1, S, nullptr);
  phase_clock.lap(kDenseBetweenDraws);
  phase_clock.flush();
}

// ---- launches ----

template <typename Kernel>
int allow_shared(Kernel kernel, size_t shared) {
  if (shared <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)shared);
}

template <int G, int EPL, bool DENSE, bool RING>
int launch_chain(const Args& a, int warps, int consumers, int cpw, size_t shared,
                 cudaStream_t stream) {
  // with the ring the warps beyond `consumers` produce; without it every warp runs chains
  if (cpw < 1 || cpw > 32 / G || consumers < 1 || warps > MAX_WARPS ||
      (RING ? consumers >= warps : consumers != warps))
    return (int)cudaErrorInvalidValue;
  auto kernel = chain_kernel<G, EPL, DENSE, RING>;
  if (const int e = allow_shared(kernel, shared)) return e;
  const int cb = consumers * cpw;
  LAUNCH(kernel<<<(a.chains + cb - 1) / cb, 32 * warps, shared, stream>>>(a, consumers, cpw));
  return 0;
}

// one block of W consumer and PW producer warps per 16 chains; `shared` must
// hold the layout above MmaShape
template <int NT, int W, int PW>
int launch_mma(const Args& a, size_t shared, cudaStream_t stream) {
  auto kernel = mma_kernel<NT, W, PW>;
  if (const int e = allow_shared(kernel, shared)) return e;
  LAUNCH(kernel<<<(a.chains + MMA_ROWS - 1) / MMA_ROWS, 32 * (W + PW), shared, stream>>>(a));
  return 0;
}

// blocks of THREADS threads, `chains_per_block` teams of THREADS /
// chains_per_block threads, each thread GPT groups of 4 elements; THREADS =
// 1024 takes one chain a block and diag_wide_shared(GPT) bytes of shared memory
template <int GPT, int THREADS>
int launch_diag(const Args& a, int chains_per_block, cudaStream_t stream) {
  const int tpc = THREADS / chains_per_block;
  if (chains_per_block < 1 || THREADS % chains_per_block || tpc % 32 || 4 * GPT * tpc < a.d ||
      (THREADS == DIAG_WIDE_THREADS && chains_per_block != 1))
    return (int)cudaErrorInvalidValue;
  auto kernel = diag_kernel<GPT, THREADS>;
  const size_t shared = THREADS == DIAG_THREADS ? 0 : diag_wide_shared(GPT);
  if (const int e = allow_shared(kernel, shared)) return e;
  LAUNCH(kernel<<<(a.chains + chains_per_block - 1) / chains_per_block, THREADS, shared,
                  stream>>>(a, tpc));
  return 0;
}

// One cooperative launch of as many blocks as there are tiles, at most as
// many as the card holds at once; `scratch` holds dense_scratch's arrays
// (its bytes: gaussian_hmc_scratch_bytes) and `shared` the stages and the
// energy reduction.  With phases (device, DENSE_PHASES counters) the
// kernel that counts its phases runs.
template <int MI, int NI, int WN>
int launch_dense(const Args& a, void* scratch, size_t shared, cudaStream_t stream,
                 long long* phases = nullptr) {
  constexpr int BN = 8 * NI * WN;
  if (!scratch || shared != dense_shared_bytes(BN, WN))
    return (int)cudaErrorInvalidValue;
  auto kernel = phases ? dense_grid_kernel<MI, NI, WN, true> : dense_grid_kernel<MI, NI, WN>;
  if (const int e = allow_shared(kernel, shared)) return e;
  DenseArgs s;
  s.a = a;
  s.phases = phases;
  dense_scratch(&s, static_cast<char*>(scratch), a.chains, a.d, BN);
  int dev = 0, sms = 0, per_sm = 0;
  if (const cudaError_t e = cudaGetDevice(&dev)) return (int)e;
  if (const cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))
    return (int)e;
  if (const cudaError_t e =
          cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, DT_THREADS, shared))
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int grid = std::min(s.n_mt * s.n_nt, per_sm * sms);
  if (const int e = queued([&] { return cudaMemsetAsync(s.bar, 0, sizeof(unsigned int), stream); }))
    return e;
  void* args[] = {&s};
  if (const int e = queued([&] {
        return cudaLaunchCooperativeKernel((const void*)kernel, grid, DT_THREADS, args, shared,
                                           stream);
      }))
    return e;
  LAUNCH_CHECK();
  return 0;
}

}  // namespace

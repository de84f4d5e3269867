// The kernels of gaussian_hmc.cu (its head note says what bounds them and
// what the design does): chain_kernel, G lanes per chain of EPL elements
// each, with or without a shared-memory ring of noise that producer warps
// fill, mma_kernel, 16 chains per block on the tensor cores in 3xTF32, and
// wide_kernel, 1-8 chains per block of 8 warps with the state in shared
// memory, for any D.
// They are templates; a source that includes this header instantiates the
// ones it launches (gaussian_hmc.cu: those the wrapper's plan can choose).
#pragma once

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

// ---- variant 5: any D, CB chains per block ----

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

__device__ __forceinline__ float mean_at(const Args& a, int k) { return a.mean ? a.mean[k] : 0.f; }

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
  kernel<<<(a.chains + cb - 1) / cb, 32 * warps, shared, stream>>>(a, consumers, cpw);
  LAUNCH_CHECK();
  return 0;
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

// one block of W consumer and PW producer warps per 16 chains; `shared` must
// hold the layout above MmaShape
template <int NT, int W, int PW>
int launch_mma(const Args& a, size_t shared, cudaStream_t stream) {
  auto kernel = mma_kernel<NT, W, PW>;
  if (const int e = allow_shared(kernel, shared)) return e;
  kernel<<<(a.chains + MMA_ROWS - 1) / MMA_ROWS, 32 * (W + PW), shared, stream>>>(a);
  LAUNCH_CHECK();
  return 0;
}

}  // namespace

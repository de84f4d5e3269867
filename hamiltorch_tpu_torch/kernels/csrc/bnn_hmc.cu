// Fused multi-chain HMC for the one-hidden-layer tanh regression BNN,
//     o = tanh(x W1 + b1) w2 + b2,
//     logp = -tau/2 sum (o - y)^2 - 1/2 |theta|^2,
// written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel hamiltorch_tpu/kernels/bnn_hmc.py::bnn_hmc
// (its body _kernel, lines 41-136).  Same sampler: per draw Box-Muller
// momenta, a half kick, L drift+kick steps with a hand-written backward
// pass, half a kick pulled back, and the Metropolis test (h0 - h1) >= log u.
// Unlike the TPU kernel it works over the REAL input rows only: no padded
// W1 rows get momenta, prior mass or gradient (see the Python module).
//
// What bounds it.  Each leapfrog step is two GEMMs per chain: the forward
// x W1 and the backward x^T da, each 2*N*I*H flops.  At the flagship
// (N=1024, I=784, H=128) that is 2 x 205.5 MFLOP per chain, 26.3 GFLOP per
// step for 64 chains, against about 0.2 GB of state traffic per step: the
// step is bound by float32 FMA throughput (67 TFLOP/s on an H100 SXM at
// 700 W, about 0.39 ms per step at best), not by memory.
//
// What the design does about it.  The TPU kernel keeps one chain's whole
// state on chip for the whole run; one chain's f32 state is 402 KB, more
// than the 227 KB of shared memory a block can have.  So the state of all
// chains (theta, momentum, gradient, proposal) lives in device memory, and
// the host loops over draws and steps, launching on the caller's stream:
//   forward_kernel   GEMM x W1_c tiled 64 x 128 x 16 in shared memory,
//                    4 x 8 outputs per thread; its epilogue fuses +b1, tanh,
//                    the w2 row reduction into o (a block covers all H
//                    columns of its rows, so o needs no atomics), the
//                    residual, da = d w2 (1 - h^2), and per-tile partial
//                    sums for the b1, w2, b2 gradients and the likelihood;
//   backward_kernel  GEMM x^T da_c with the same tiling; its epilogue fuses
//                    -W1, the momentum kick and the next drift, and partial
//                    sums of the prior and the kinetic energy;
//   small_kernel     reduces the partials per chain: b1/w2/b2 gradients,
//                    their kick and drift, logp and the kinetic energy;
//   init_draw_kernel Philox + Box-Muller momenta (or given ones), kinetic
//                    energy, the half kick and the first drift;
//   mh_kernel / select_kernel  the Metropolis test and the state copy.
// Both GEMMs are plain FMA tiles; wgmma, TMA and 3xTF32 are later work.
// Energies are reduced in float64 (sums near 5e4 compared against log u).
// Every reduction has a fixed order, so a run is deterministic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;    // GEMM tile rows
constexpr int BN = 128;   // GEMM tile columns (a chunk of H)
constexpr int BK = 16;    // GEMM tile depth
constexpr int NT = 256;   // threads of a GEMM block: 16 x 16, 4 x 8 outputs each
constexpr int EW = 256;   // threads of an elementwise block
constexpr int EW_MAX_BLOCKS = 64;  // elementwise blocks per chain

struct Layout {
  long long d, dp;                  // parameters per chain, padded stride
  int n_tiles, bwd_blocks, ew_blocks;
  size_t theta, grad, th, gr, p, da, pgw2, pgb1, pgb2;   // float regions
  size_t pll, pprior, pkin, pk0, logp_cur, logp_prop, kin_prop, flag, count;  // double regions
  size_t bytes;
};

long long round_up(long long a, long long m) { return (a + m - 1) / m * m; }

Layout make_layout(int n, int in_dim, int hidden, int chains) {
  Layout L;
  L.d = (long long)in_dim * hidden + 2LL * hidden + 1;
  L.dp = round_up(L.d, 4);
  L.n_tiles = (n + BM - 1) / BM;
  L.bwd_blocks = ((in_dim + BM - 1) / BM) * (hidden / BN);
  long long pairs = (L.d + 1) / 2;
  long long blocks = (pairs + EW - 1) / EW;
  L.ew_blocks = (int)(blocks < EW_MAX_BLOCKS ? blocks : EW_MAX_BLOCKS);
  size_t off = 0;
  auto take = [&](size_t count, size_t elem) {
    size_t at = off;
    off = (size_t)round_up((long long)(off + count * elem), 256);
    return at;
  };
  const size_t C = chains;
  L.theta = take(C * L.dp, 4);
  L.grad = take(C * L.dp, 4);
  L.th = take(C * L.dp, 4);
  L.gr = take(C * L.dp, 4);
  L.p = take(C * L.dp, 4);
  L.da = take(C * (size_t)n * hidden, 4);
  L.pgw2 = take(C * L.n_tiles * (size_t)hidden, 4);
  L.pgb1 = take(C * L.n_tiles * (size_t)hidden, 4);
  L.pgb2 = take(C * L.n_tiles, 4);
  L.pll = take(C * L.n_tiles, 8);
  L.pprior = take(C * L.bwd_blocks, 8);
  L.pkin = take(C * L.bwd_blocks, 8);
  L.pk0 = take(C * L.ew_blocks, 8);
  L.logp_cur = take(C, 8);
  L.logp_prop = take(C, 8);
  L.kin_prop = take(C, 8);
  L.flag = take(C, 8);
  L.count = take(C, 8);
  L.bytes = off;
  return L;
}

// ---- random numbers: Philox4x32-10, Box-Muller ------------------------------

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

// ---- reductions ---------------------------------------------------------------

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

// column of output j (0..7) of thread tx in a 128-wide tile: two runs of 4,
// so that a warp's shared-memory reads of B fall in distinct banks
__device__ __forceinline__ int tile_col(int tx, int j) {
  return (j < 4) ? tx * 4 + j : 64 + tx * 4 + (j - 4);
}

// acc[4][8] += As[k][ty*4 .. +4] (x) Bs[k][cols of tx], for k < BK
template <int LDA>
__device__ __forceinline__ void mma_tile(float (*As)[LDA], float (*Bs)[BN],
                                         int ty, int tx, float acc[4][8]) {
#pragma unroll
  for (int k = 0; k < BK; ++k) {
    const float4 a4 = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
    const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
    const float4 b1 = *reinterpret_cast<const float4*>(&Bs[k][64 + tx * 4]);
    const float a[4] = {a4.x, a4.y, a4.z, a4.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// ---- kernels ------------------------------------------------------------------

// theta, th <- the packed (w1, b1, w2, b2) of each chain
__global__ void pack_kernel(const float* __restrict__ w1, const float* __restrict__ b1,
                            const float* __restrict__ w2, const float* __restrict__ b2,
                            float* __restrict__ theta, float* __restrict__ th,
                            int in_dim, int hidden, long long d, long long dp) {
  const int c = blockIdx.y;
  const long long ih = (long long)in_dim * hidden;
  for (long long k = blockIdx.x * (long long)blockDim.x + threadIdx.x; k < d;
       k += (long long)gridDim.x * blockDim.x) {
    float v;
    if (k < ih) v = w1[c * ih + k];
    else if (k < ih + hidden) v = b1[(long long)c * hidden + (k - ih)];
    else if (k < ih + 2 * hidden) v = w2[(long long)c * hidden + (k - ih - hidden)];
    else v = b2[c];
    theta[c * dp + k] = v;
    th[c * dp + k] = v;
  }
}

// (w1, b1, w2, b2) <- theta; acc <- count / num_samples
__global__ void unpack_kernel(const float* __restrict__ theta, const double* __restrict__ count,
                              float* __restrict__ w1, float* __restrict__ b1,
                              float* __restrict__ w2, float* __restrict__ b2,
                              float* __restrict__ acc, int in_dim, int hidden, long long d,
                              long long dp, int num_samples) {
  const int c = blockIdx.y;
  const long long ih = (long long)in_dim * hidden;
  for (long long k = blockIdx.x * (long long)blockDim.x + threadIdx.x; k < d;
       k += (long long)gridDim.x * blockDim.x) {
    const float v = theta[c * dp + k];
    if (k < ih) w1[c * ih + k] = v;
    else if (k < ih + hidden) b1[(long long)c * hidden + (k - ih)] = v;
    else if (k < ih + 2 * hidden) w2[(long long)c * hidden + (k - ih - hidden)] = v;
    else b2[c] = v;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) acc[c] = (float)(count[c] / num_samples);
}

// Start of a draw: p = z (Philox or given), partial sums of |z|^2,
// p += eps/2 grad, th = theta + eps p.
__global__ void __launch_bounds__(EW) init_draw_kernel(
    const float* __restrict__ theta, const float* __restrict__ grad, float* __restrict__ th,
    float* __restrict__ p, double* __restrict__ pk0, long long d, long long dp, int chains,
    int draw, float eps, uint2 key, const float* __restrict__ momenta) {
  const int c = blockIdx.y;
  const long long base = c * dp;
  const float* mom = momenta ? momenta + ((long long)draw * chains + c) * d : nullptr;
  double k0 = 0.0;
  const long long pairs = (d + 1) / 2;
  for (long long q = blockIdx.x * (long long)blockDim.x + threadIdx.x; q < pairs;
       q += (long long)gridDim.x * blockDim.x) {
    float z[2];
    if (mom) {
      z[0] = mom[2 * q];
      z[1] = (2 * q + 1 < d) ? mom[2 * q + 1] : 0.0f;
    } else {
      const uint4 r = philox(make_uint4((uint32_t)q, (uint32_t)draw, (uint32_t)c, 0u), key);
      const float rad = sqrtf(-2.0f * logf(uniform01(r.x)));
      float s, co;
      sincospif(2.0f * uniform01(r.y), &s, &co);
      z[0] = rad * co;
      z[1] = rad * s;
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const long long k = 2 * q + e;
      if (k < d) {
        float pv = z[e];
        k0 += (double)pv * pv;
        pv = fmaf(0.5f * eps, grad[base + k], pv);
        p[base + k] = pv;
        th[base + k] = fmaf(eps, pv, theta[base + k]);
      }
    }
  }
  k0 = block_sum(k0);
  if (threadIdx.x == 0) pk0[(long long)c * gridDim.x + blockIdx.x] = k0;
}

// Forward pass of chain blockIdx.y on rows [BM*blockIdx.x, +BM):
// a = x W1 + b1, h = tanh(a), o = h w2 + b2, resid = o - y, d = -tau resid,
// da = d w2 (1 - h^2) into da; per-tile partial sums of h d and da over the
// rows (w2 and b1 gradients), of d (b2 gradient) and of resid^2.
__global__ void __launch_bounds__(NT) forward_kernel(
    const float* __restrict__ x, const float* __restrict__ y, const float* __restrict__ th,
    float* __restrict__ da, float* __restrict__ pgw2, float* __restrict__ pgb1,
    float* __restrict__ pgb2, double* __restrict__ pll, int n, int in_dim, int hidden,
    long long dp, float tau) {
  __shared__ __align__(16) float As[BK][BM + 4];  // x tile, transposed; padded rows
  __shared__ __align__(16) float Bs[BK][BN];      // W1 tile
  __shared__ float red_w2[16][BN];
  __shared__ float red_b1[16][BN];
  __shared__ float red_rows[16];
  __shared__ double red_ll[16];

  const int c = blockIdx.y, tile = blockIdx.x, n0 = tile * BM;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float* W1 = th + c * dp;
  const float* b1 = W1 + (long long)in_dim * hidden;
  const float* w2 = b1 + hidden;
  const float b2 = w2[hidden];
  float* dac = da + (long long)c * n * hidden;
  const int nchunks = hidden / BN;

  // pass 1: h into da, and each thread's share of o for its 4 rows
  float o_part[4] = {0.f, 0.f, 0.f, 0.f};
  for (int ch = 0; ch < nchunks; ++ch) {
    const int j0 = ch * BN;
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < in_dim; k0 += BK) {
#pragma unroll
      for (int e = 0; e < (BM * BK) / NT; ++e) {
        const int idx = tid + e * NT, r = idx >> 4, kk = idx & 15;
        const int row = n0 + r, k = k0 + kk;
        As[kk][r] = (row < n && k < in_dim) ? x[(long long)row * in_dim + k] : 0.f;
      }
#pragma unroll
      for (int e = 0; e < (BK * BN) / NT; ++e) {
        const int idx = tid + e * NT, kk = idx >> 7, col = idx & 127;
        const int k = k0 + kk;
        Bs[kk][col] = (k < in_dim) ? W1[(long long)k * hidden + j0 + col] : 0.f;
      }
      __syncthreads();
      mma_tile<BM + 4>(As, Bs, ty, tx, acc);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = n0 + ty * 4 + i;
      if (row < n) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = j0 + tile_col(tx, j);
          const float hv = tanhf(acc[i][j] + b1[col]);
          o_part[i] = fmaf(hv, w2[col], o_part[i]);
          dac[(long long)row * hidden + col] = hv;
        }
      }
    }
  }

  // o per row: the 16 threads of a row group are 16 lanes of one warp
  float dvals[4];
  float d_sum = 0.f;
  double r2_sum = 0.0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float o = o_part[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) o += __shfl_xor_sync(0xffffffffu, o, off);
    const int row = n0 + ty * 4 + i;
    const float resid = (row < n) ? (o + b2 - y[row]) : 0.f;
    dvals[i] = -tau * resid;
    d_sum += dvals[i];
    r2_sum += (double)resid * resid;
  }

  // pass 2: da = d w2 (1 - h^2), and column partials of h d and da
  for (int ch = 0; ch < nchunks; ++ch) {
    const int j0 = ch * BN;
    float cw[8], cb[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) cw[j] = cb[j] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = n0 + ty * 4 + i;
      if (row < n) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = j0 + tile_col(tx, j);
          float* slot = dac + (long long)row * hidden + col;
          const float hv = *slot;  // written by this thread in pass 1
          const float dav = dvals[i] * w2[col] * (1.f - hv * hv);
          *slot = dav;
          cw[j] = fmaf(hv, dvals[i], cw[j]);
          cb[j] += dav;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      red_w2[ty][tile_col(tx, j)] = cw[j];
      red_b1[ty][tile_col(tx, j)] = cb[j];
    }
    __syncthreads();
    if (tid < BN) {
      float sw = 0.f, sb = 0.f;
#pragma unroll
      for (int g = 0; g < 16; ++g) {
        sw += red_w2[g][tid];
        sb += red_b1[g][tid];
      }
      const long long at = ((long long)c * gridDim.x + tile) * hidden + j0 + tid;
      pgw2[at] = sw;
      pgb1[at] = sb;
    }
    __syncthreads();
  }

  if (tx == 0) {
    red_rows[ty] = d_sum;
    red_ll[ty] = r2_sum;
  }
  __syncthreads();
  if (tid == 0) {
    float ds = 0.f;
    double ls = 0.0;
    for (int g = 0; g < 16; ++g) {
      ds += red_rows[g];
      ls += red_ll[g];
    }
    pgb2[(long long)c * gridDim.x + tile] = ds;
    pll[(long long)c * gridDim.x + tile] = ls;
  }
}

// Backward pass of chain blockIdx.z on W1 rows [BM*blockIdx.x, +BM) and
// columns [BN*blockIdx.y, +BN): g = x^T da - W1 into gr, p += kappa g, and
// with drift th += eps p; partial sums of W1^2 (prior) and p^2 (kinetic).
__global__ void __launch_bounds__(NT) backward_kernel(
    const float* __restrict__ x, const float* __restrict__ da, float* __restrict__ th,
    float* __restrict__ gr, float* __restrict__ p, double* __restrict__ pprior,
    double* __restrict__ pkin, int n, int in_dim, int hidden, long long dp, float kappa,
    float eps, int drift) {
  __shared__ __align__(16) float As[BK][BM];  // x tile: As[k][i] = x[k0+k][i0+i]
  __shared__ __align__(16) float Bs[BK][BN];  // da tile

  const int c = blockIdx.z, i0 = blockIdx.x * BM, j0 = blockIdx.y * BN;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float* dac = da + (long long)c * n * hidden;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < n; k0 += BK) {
#pragma unroll
    for (int e = 0; e < (BM * BK) / NT; ++e) {
      const int idx = tid + e * NT, kk = idx >> 6, r = idx & 63;
      const int row = k0 + kk, i = i0 + r;
      As[kk][r] = (row < n && i < in_dim) ? x[(long long)row * in_dim + i] : 0.f;
    }
#pragma unroll
    for (int e = 0; e < (BK * BN) / NT; ++e) {
      const int idx = tid + e * NT, kk = idx >> 7, col = idx & 127;
      const int row = k0 + kk;
      Bs[kk][col] = (row < n) ? dac[(long long)row * hidden + j0 + col] : 0.f;
    }
    __syncthreads();
    mma_tile<BM>(As, Bs, ty, tx, acc);
    __syncthreads();
  }

  float* W1 = th + c * dp;
  float* G1 = gr + c * dp;
  float* P1 = p + c * dp;
  double prior = 0.0, kin = 0.0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = i0 + ty * 4 + i;
    if (row < in_dim) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const long long k = (long long)row * hidden + j0 + tile_col(tx, j);
        const float w = W1[k];
        const float g = acc[i][j] - w;
        const float pv = fmaf(kappa, g, P1[k]);
        G1[k] = g;
        P1[k] = pv;
        prior += (double)w * w;
        kin += (double)pv * pv;
        if (drift) W1[k] = fmaf(eps, pv, w);
      }
    }
  }
  prior = block_sum(prior);
  kin = block_sum(kin);
  if (tid == 0) {
    const long long at = (long long)c * gridDim.x * gridDim.y + blockIdx.y * gridDim.x + blockIdx.x;
    pprior[at] = prior;
    pkin[at] = kin;
  }
}

// Per chain (one block each): the b1, w2, b2 gradients from the forward's
// partials, their kick (and drift), logp at th and the kinetic energy of p.
__global__ void small_kernel(float* __restrict__ th, float* __restrict__ gr, float* __restrict__ p,
                             const float* __restrict__ pgw2, const float* __restrict__ pgb1,
                             const float* __restrict__ pgb2, const double* __restrict__ pll,
                             const double* __restrict__ pprior, const double* __restrict__ pkin,
                             double* __restrict__ logp_prop, double* __restrict__ kin_prop,
                             int in_dim, int hidden, long long dp, int n_tiles, int bwd_blocks,
                             float tau, float kappa, float eps, int drift) {
  const int c = blockIdx.x;
  const long long base = c * dp + (long long)in_dim * hidden;  // b1, then w2, then b2
  double prior = 0.0, kin = 0.0, ll = 0.0;

  auto update = [&](long long k, float partial) {
    const float v = th[k];
    const float g = partial - v;
    const float pv = fmaf(kappa, g, p[k]);
    gr[k] = g;
    p[k] = pv;
    prior += (double)v * v;
    kin += (double)pv * pv;
    if (drift) th[k] = fmaf(eps, pv, v);
  };

  for (int j = threadIdx.x; j < hidden; j += blockDim.x) {
    float sb = 0.f, sw = 0.f;
    for (int t = 0; t < n_tiles; ++t) {
      const long long at = ((long long)c * n_tiles + t) * hidden + j;
      sb += pgb1[at];
      sw += pgw2[at];
    }
    update(base + j, sb);
    update(base + hidden + j, sw);
  }
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int t = 0; t < n_tiles; ++t) {
      s += pgb2[(long long)c * n_tiles + t];
      ll += pll[(long long)c * n_tiles + t];
    }
    update(base + 2 * hidden, s);
    for (int b = 0; b < bwd_blocks; ++b) {
      prior += pprior[(long long)c * bwd_blocks + b];
      kin += pkin[(long long)c * bwd_blocks + b];
    }
  }
  prior = block_sum(prior);
  kin = block_sum(kin);
  if (threadIdx.x == 0) {
    logp_prop[c] = -0.5 * (double)tau * ll - 0.5 * prior;
    kin_prop[c] = 0.5 * kin;
  }
}

// Metropolis test per chain; with force, accept unconditionally and count
// nothing (the initial evaluation).
__global__ void mh_kernel(const double* __restrict__ pk0, int ew_blocks,
                          double* __restrict__ logp_cur, const double* __restrict__ logp_prop,
                          const double* __restrict__ kin_prop, double* __restrict__ flag,
                          double* __restrict__ count, int chains, int draw, uint2 key,
                          const float* __restrict__ uniforms, int force) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= chains) return;
  if (force) {
    flag[c] = 1.0;
    logp_cur[c] = logp_prop[c];
    return;
  }
  double k0 = 0.0;
  for (int b = 0; b < ew_blocks; ++b) k0 += pk0[(long long)c * ew_blocks + b];
  const double h0 = -logp_cur[c] + 0.5 * k0;
  const double h1 = -logp_prop[c] + kin_prop[c];
  const float u = uniforms
      ? uniforms[(long long)draw * chains + c]
      : uniform01(philox(make_uint4(0u, (uint32_t)draw, (uint32_t)c, 1u), key).x);
  const bool accept = (h0 - h1) >= log((double)u);
  flag[c] = accept ? 1.0 : 0.0;
  if (accept) {
    logp_cur[c] = logp_prop[c];
    count[c] += 1.0;
  }
}

// Accepted chains: theta <- th, grad <- gr.
__global__ void __launch_bounds__(EW) select_kernel(
    float* __restrict__ theta, float* __restrict__ grad, const float* __restrict__ th,
    const float* __restrict__ gr, const double* __restrict__ flag, long long d, long long dp) {
  const int c = blockIdx.y;
  if (flag[c] == 0.0) return;
  for (long long k = blockIdx.x * (long long)blockDim.x + threadIdx.x; k < d;
       k += (long long)gridDim.x * blockDim.x) {
    theta[c * dp + k] = th[c * dp + k];
    grad[c * dp + k] = gr[c * dp + k];
  }
}

}  // namespace

#define LAUNCH_CHECK()                        \
  do {                                        \
    const cudaError_t e_ = cudaGetLastError(); \
    if (e_ != cudaSuccess) return (int)e_;    \
  } while (0)

extern "C" {

// Bytes of device workspace bnn_hmc_run needs for these shapes.
size_t bnn_hmc_workspace_bytes(int n, int in_dim, int hidden, int chains) {
  return make_layout(n, in_dim, hidden, chains).bytes;
}

const char* bnn_hmc_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Run num_samples HMC draws of num_steps leapfrog steps on every chain.
// All pointers are device pointers (stream is a cudaStream_t); hidden must
// be a multiple of 128 and chains at most 65535 (a grid dimension);
// momenta (S, C, D) and uniforms (S, C) may be null.
// Launches on the stream without synchronising and returns the first
// launch error as a cudaError_t (0 on success).
int bnn_hmc_run(const float* x, const float* y, const float* w1, const float* b1,
                const float* w2, const float* b2, float* w1_out, float* b1_out, float* w2_out,
                float* b2_out, float* acc_out, void* workspace, int n, int in_dim, int hidden,
                int chains, int num_samples, int num_steps, float step_size, float tau,
                unsigned long long seed, const float* momenta, const float* uniforms,
                void* stream_ptr) {
  if (hidden % BN != 0 || n < 1 || in_dim < 1 || chains < 1 || chains > 65535 ||
      num_samples < 1 || num_steps < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const Layout L = make_layout(n, in_dim, hidden, chains);
  char* ws = (char*)workspace;
  float* theta = (float*)(ws + L.theta);
  float* grad = (float*)(ws + L.grad);
  float* th = (float*)(ws + L.th);
  float* gr = (float*)(ws + L.gr);
  float* p = (float*)(ws + L.p);
  float* da = (float*)(ws + L.da);
  float* pgw2 = (float*)(ws + L.pgw2);
  float* pgb1 = (float*)(ws + L.pgb1);
  float* pgb2 = (float*)(ws + L.pgb2);
  double* pll = (double*)(ws + L.pll);
  double* pprior = (double*)(ws + L.pprior);
  double* pkin = (double*)(ws + L.pkin);
  double* pk0 = (double*)(ws + L.pk0);
  double* logp_cur = (double*)(ws + L.logp_cur);
  double* logp_prop = (double*)(ws + L.logp_prop);
  double* kin_prop = (double*)(ws + L.kin_prop);
  double* flag = (double*)(ws + L.flag);
  double* count = (double*)(ws + L.count);
  const uint2 key = make_uint2((uint32_t)seed, (uint32_t)(seed >> 32));

  const dim3 ew_grid(L.ew_blocks, chains);
  const dim3 fwd_grid(L.n_tiles, chains);
  const dim3 bwd_grid((in_dim + BM - 1) / BM, hidden / BN, chains);
  const int mh_blocks = (chains + 127) / 128;

  auto gradient = [&](float kappa, int drift) -> int {
    forward_kernel<<<fwd_grid, NT, 0, stream>>>(x, y, th, da, pgw2, pgb1, pgb2, pll, n, in_dim,
                                                 hidden, L.dp, tau);
    LAUNCH_CHECK();
    backward_kernel<<<bwd_grid, NT, 0, stream>>>(x, da, th, gr, p, pprior, pkin, n, in_dim,
                                                  hidden, L.dp, kappa, step_size, drift);
    LAUNCH_CHECK();
    small_kernel<<<chains, 128, 0, stream>>>(th, gr, p, pgw2, pgb1, pgb2, pll, pprior, pkin,
                                             logp_prop, kin_prop, in_dim, hidden, L.dp,
                                             L.n_tiles, L.bwd_blocks, tau, kappa, step_size,
                                             drift);
    LAUNCH_CHECK();
    return 0;
  };
  auto metropolis = [&](int draw, int force) -> int {
    mh_kernel<<<mh_blocks, 128, 0, stream>>>(pk0, L.ew_blocks, logp_cur, logp_prop, kin_prop,
                                             flag, count, chains, draw, key, uniforms, force);
    LAUNCH_CHECK();
    select_kernel<<<ew_grid, EW, 0, stream>>>(theta, grad, th, gr, flag, L.d, L.dp);
    LAUNCH_CHECK();
    return 0;
  };

  pack_kernel<<<ew_grid, EW, 0, stream>>>(w1, b1, w2, b2, theta, th, in_dim, hidden, L.d, L.dp);
  LAUNCH_CHECK();
  int err;
  if ((err = (int)cudaMemsetAsync(p, 0, sizeof(float) * chains * L.dp, stream)) != 0) return err;
  if ((err = (int)cudaMemsetAsync(count, 0, sizeof(double) * chains, stream)) != 0) return err;

  // gradient and logp at the initial point; "accept" it as the current state
  if ((err = gradient(0.0f, 0)) != 0) return err;
  if ((err = metropolis(0, 1)) != 0) return err;

  for (int draw = 0; draw < num_samples; ++draw) {
    init_draw_kernel<<<ew_grid, EW, 0, stream>>>(theta, grad, th, p, pk0, L.d, L.dp, chains,
                                                 draw, step_size, key, momenta);
    LAUNCH_CHECK();
    for (int s = 1; s <= num_steps; ++s) {
      const bool last = (s == num_steps);
      // the last kick is a full one minus the half pulled back
      if ((err = gradient(last ? 0.5f * step_size : step_size, last ? 0 : 1)) != 0) return err;
    }
    if ((err = metropolis(draw, 0)) != 0) return err;
  }

  unpack_kernel<<<ew_grid, EW, 0, stream>>>(theta, count, w1_out, b1_out, w2_out, b2_out,
                                            acc_out, in_dim, hidden, L.d, L.dp, num_samples);
  LAUNCH_CHECK();
  return 0;
}

}  // extern "C"

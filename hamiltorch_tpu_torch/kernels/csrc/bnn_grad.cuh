// The gradient of the one-hidden-layer tanh regression BNN,
//     o = tanh(x W1 + b1) w2 + b2,
//     logp = -tau/2 sum (o - y)^2 - 1/2 |theta|^2,
// for every chain at once, shared by the fused HMC (bnn_hmc.cu) and MCLMC
// (bnn_mclmc.cu) samplers.  Each chain's parameters are packed flat as
// (W1 row-major, b1, w2, b2) at a stride of dp floats.
//
// One evaluation is three launches (launch_gradient):
//   forward_kernel   GEMM x W1_c tiled 64 x 128 x 16 in shared memory,
//                    4 x 8 outputs per thread; its epilogue fuses +b1, tanh,
//                    the w2 row reduction into o (a block covers all H
//                    columns of its rows, so o needs no atomics), the
//                    residual, da = d w2 (1 - h^2), and per-tile partial
//                    sums for the b1, w2, b2 gradients and the likelihood;
//   backward_kernel  GEMM x^T da_c with the same tiling; its epilogue writes
//                    the W1 gradient (x^T da - W1) and partial sums of the
//                    prior, and, for HMC, fuses the momentum kick, the next
//                    drift and partial sums of the kinetic energy;
//   small_kernel     reduces the partials per chain: the b1/w2/b2 gradients
//                    (with HMC's kick and drift), logp and the kinetic energy.
// Both GEMMs are plain FMA tiles; wgmma, TMA and 3xTF32 are later work.
// logp and the kinetic energy are reduced in float64 (at the flagship each
// is a sum near 5e4, and the samplers use differences of such sums).
#pragma once

#include "common.cuh"

namespace {

constexpr int BM = 64;    // GEMM tile rows
constexpr int BN = 128;   // GEMM tile columns (a chunk of H)
constexpr int BK = 16;    // GEMM tile depth
constexpr int NT = 256;   // threads of a GEMM block: 16 x 16, 4 x 8 outputs each
constexpr int EW = 256;   // threads of an elementwise block
constexpr int EW_MAX_BLOCKS = 64;  // elementwise blocks per chain

long long round_up(long long a, long long m) { return (a + m - 1) / m * m; }

// Sizes of the packed state and of the per-chain partial-sum grids.
struct BnnDims {
  int n, in_dim, hidden, chains;
  long long d, dp;  // parameters per chain, padded stride
  int n_tiles, bwd_blocks, ew_blocks;
};

BnnDims make_dims(int n, int in_dim, int hidden, int chains) {
  BnnDims s;
  s.n = n;
  s.in_dim = in_dim;
  s.hidden = hidden;
  s.chains = chains;
  s.d = (long long)in_dim * hidden + 2LL * hidden + 1;
  s.dp = round_up(s.d, 4);
  s.n_tiles = (n + BM - 1) / BM;
  s.bwd_blocks = ((in_dim + BM - 1) / BM) * (hidden / BN);
  long long pairs = (s.d + 1) / 2;
  long long blocks = (pairs + EW - 1) / EW;
  s.ew_blocks = (int)(blocks < EW_MAX_BLOCKS ? blocks : EW_MAX_BLOCKS);
  return s;
}

// Bump allocator over the caller's workspace (offsets 256-byte aligned).
struct Arena {
  size_t off = 0;
  size_t take(size_t count, size_t elem) {
    size_t at = off;
    off = (size_t)round_up((long long)(off + count * elem), 256);
    return at;
  }
};

// Device scratch of one gradient evaluation.
struct GradScratch {
  float *da, *pgw2, *pgb1, *pgb2;
  double *pll, *pprior, *pkin;
};

struct GradOffsets {
  size_t da, pgw2, pgb1, pgb2, pll, pprior, pkin;
};

GradOffsets take_grad_scratch(Arena& a, const BnnDims& s) {
  const size_t C = s.chains;
  GradOffsets o;
  o.da = a.take(C * (size_t)s.n * s.hidden, 4);
  o.pgw2 = a.take(C * s.n_tiles * (size_t)s.hidden, 4);
  o.pgb1 = a.take(C * s.n_tiles * (size_t)s.hidden, 4);
  o.pgb2 = a.take(C * s.n_tiles, 4);
  o.pll = a.take(C * s.n_tiles, 8);
  o.pprior = a.take(C * s.bwd_blocks, 8);
  o.pkin = a.take(C * s.bwd_blocks, 8);
  return o;
}

GradScratch grad_scratch(char* ws, const GradOffsets& o) {
  return GradScratch{(float*)(ws + o.da), (float*)(ws + o.pgw2), (float*)(ws + o.pgb1),
                     (float*)(ws + o.pgb2), (double*)(ws + o.pll), (double*)(ws + o.pprior),
                     (double*)(ws + o.pkin)};
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

// dst, dst2 (if not null) <- the packed (w1, b1, w2, b2) of each chain
__global__ void pack_kernel(const float* __restrict__ w1, const float* __restrict__ b1,
                            const float* __restrict__ w2, const float* __restrict__ b2,
                            float* __restrict__ dst, float* __restrict__ dst2,
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
    dst[c * dp + k] = v;
    if (dst2) dst2[c * dp + k] = v;
  }
}

// (w1, b1, w2, b2) <- theta; out[c] <- per_chain[c] / denom
__global__ void unpack_kernel(const float* __restrict__ theta, const double* __restrict__ per_chain,
                              double denom, float* __restrict__ w1, float* __restrict__ b1,
                              float* __restrict__ w2, float* __restrict__ b2,
                              float* __restrict__ out, int in_dim, int hidden, long long d,
                              long long dp) {
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
  if (blockIdx.x == 0 && threadIdx.x == 0) out[c] = (float)(per_chain[c] / denom);
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
// columns [BN*blockIdx.y, +BN): g = x^T da - W1 into gr and partial sums of
// W1^2 (prior).  With p (HMC): p += kappa g, with drift th += eps p, and
// partial sums of p^2 (kinetic).
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
  float* P1 = p ? p + c * dp : nullptr;
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
        G1[k] = g;
        prior += (double)w * w;
        if (P1) {
          const float pv = fmaf(kappa, g, P1[k]);
          P1[k] = pv;
          kin += (double)pv * pv;
          if (drift) W1[k] = fmaf(eps, pv, w);
        }
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
// partials, logp at th and, with p (HMC), their kick (and drift) and the
// kinetic energy of p.
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
    gr[k] = g;
    prior += (double)v * v;
    if (p) {
      const float pv = fmaf(kappa, g, p[k]);
      p[k] = pv;
      kin += (double)pv * pv;
      if (drift) th[k] = fmaf(eps, pv, v);
    }
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
      if (p) kin += pkin[(long long)c * bwd_blocks + b];
    }
  }
  prior = block_sum(prior);
  kin = block_sum(kin);
  if (threadIdx.x == 0) {
    logp_prop[c] = -0.5 * (double)tau * ll - 0.5 * prior;
    if (kin_prop) kin_prop[c] = 0.5 * kin;
  }
}

// One gradient evaluation at th for every chain: the gradient into gr and
// logp into logp_prop.  With p (HMC) the evaluation also kicks p by kappa g,
// drifts th by eps p when drift is set, and writes 0.5 |p|^2 to kin_prop.
// Returns the first launch error as a cudaError_t (0 on success).
int launch_gradient(const BnnDims& s, const float* x, const float* y, float* th, float* gr,
                    float* p, const GradScratch& w, double* logp_prop, double* kin_prop,
                    float tau, float kappa, float eps, int drift, cudaStream_t stream) {
  const dim3 fwd_grid(s.n_tiles, s.chains);
  const dim3 bwd_grid((s.in_dim + BM - 1) / BM, s.hidden / BN, s.chains);
  forward_kernel<<<fwd_grid, NT, 0, stream>>>(x, y, th, w.da, w.pgw2, w.pgb1, w.pgb2, w.pll, s.n,
                                               s.in_dim, s.hidden, s.dp, tau);
  LAUNCH_CHECK();
  backward_kernel<<<bwd_grid, NT, 0, stream>>>(x, w.da, th, gr, p, w.pprior, w.pkin, s.n,
                                                s.in_dim, s.hidden, s.dp, kappa, eps, drift);
  LAUNCH_CHECK();
  small_kernel<<<s.chains, 128, 0, stream>>>(th, gr, p, w.pgw2, w.pgb1, w.pgb2, w.pll, w.pprior,
                                             w.pkin, logp_prop, kin_prop, s.in_dim, s.hidden,
                                             s.dp, s.n_tiles, s.bwd_blocks, tau, kappa, eps,
                                             drift);
  LAUNCH_CHECK();
  return 0;
}

}  // namespace

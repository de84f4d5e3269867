// Filter response normalisation with its thresholded linear unit (FRN with
// TLU; Singh and Krishnan, arXiv:1911.09737) over the (image, channel)
// planes of an NCHW tensor, forward and backward, for ResNet-20-FRN
// (models/resnet_frn.py).  Per plane of n = H*W elements:
//
//   r = (sum x^2 / n + eps)^-1/2,  y = gamma x r + beta,  z = max(y, tau)
//
// It replaces no TPU kernel: the JAX package has no FRN.  It was added
// because the eager chain of that formula (7 operations forward, about 20
// backward, with per-channel reductions) moved ~8x the layer's bytes in
// ~2,500 launches a full-batch gradient.  The work is bound by bytes: 2
// elements moved an element forward (x read, z written) and 3 backward (dz
// and x read, dx written); the sums are a few operations an element.
//
// The design keeps everything between those reads and writes in registers:
//  - frn_tlu_fwd_kernel: a group of L lanes takes a plane, starts all its
//    16-byte loads, reduces sum x^2 by shuffles and writes z;
//  - frn_tlu_bwd_kernel: the same, over dz and x; it recomputes r, y and
//    the TLU's mask from x, takes the plane sums sum dy and sum dy x,
//    writes dx = gamma r dy - gamma r^3 x (sum dy x) / n, and the plane's
//    three partials to an (N, C, 3) scratch: sum dy (for beta),
//    r sum dy x (gamma) and sum (dz - dy) (tau);
//  - frn_tlu_sum_kernel sums the scratch over N, a block a channel, in a
//    fixed order: no atomics, so the same inputs give the same bits.
// At a tie y == tau the gradient splits in halves, as torch.maximum's
// backward does.  Float32 planes of 64, 256 and 1024 elements (ResNet-20's
// 8x8, 16x16 and 32x32) take the register path, templated on the plane
// size; any other plane, an unaligned pointer or float64 takes the generic
// variant: a warp a plane in two passes forward and three backward.  Both
// variants compute x^2's sum and y with explicit fused multiply-adds, so
// the backward recomputes the forward's y bit for bit, and the mask with it.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;  // 8 warps a block in every kernel
constexpr int WARPS = THREADS / 32;

// sum over each aligned group of G lanes, the same bits in every lane of
// the group (a + b == b + a); every lane of the warp must call it
template <int G, typename T>
__device__ __forceinline__ T lanes_sum(T v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float mul_add(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double mul_add(double a, double b, double c) { return fma(a, b, c); }
__device__ __forceinline__ float inv_sqrt(float a) { return rsqrtf(a); }
__device__ __forceinline__ double inv_sqrt(double a) { return rsqrt(a); }

// max(y, tau), NaN in either giving NaN as torch.maximum does
template <typename T>
__device__ __forceinline__ T tlu(T y, T t) {
  return (y < t || t != t) ? t : y;
}

// the share of dz that reaches y: all above tau, half at a tie, none below
template <typename T>
__device__ __forceinline__ T tlu_grad(T y, T t, T g) {
  return y > t ? g : (y == t ? T(0.5) * g : T(0));
}

// ---- the register path: float32, a plane of HW elements to L lanes ----

// lane l of a group holds the plane's float4s l, l + L, l + 2L, ...: P each
template <int HW, int L>
struct Plane {
  static constexpr int P = HW / (4 * L);
  static constexpr int GROUPS = 32 / L;  // planes a warp
  static constexpr int PER_BLOCK = WARPS * GROUPS;
  static_assert(HW % (4 * L) == 0 && 32 % L == 0 && P >= 1, "a plane must fill its lanes");
  long long plane;
  int lane;  // within the group
  bool live;

  __device__ __forceinline__ Plane(long long planes) {
    const long long warp = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
    plane = warp * GROUPS + (threadIdx.x & 31) / L;
    lane = threadIdx.x % L;
    live = plane < planes;
  }

  __device__ __forceinline__ void load(const float* base, float4 (&v)[P]) const {
    const float4* src = reinterpret_cast<const float4*>(base + plane * HW) + lane;
#pragma unroll
    for (int p = 0; p < P; ++p) v[p] = live ? __ldg(src + p * L) : make_float4(0.f, 0.f, 0.f, 0.f);
  }

  __device__ __forceinline__ void store(float* base, const float4 (&v)[P]) const {
    if (!live) return;
    float4* dst = reinterpret_cast<float4*>(base + plane * HW) + lane;
#pragma unroll
    for (int p = 0; p < P; ++p) dst[p * L] = v[p];
  }

  // r of the plane, the same bits in the forward and the backward
  __device__ __forceinline__ float rnorm(const float4 (&v)[P], float eps) const {
    float ss = 0.f;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      ss = fmaf(v[p].x, v[p].x, ss);
      ss = fmaf(v[p].y, v[p].y, ss);
      ss = fmaf(v[p].z, v[p].z, ss);
      ss = fmaf(v[p].w, v[p].w, ss);
    }
    ss = lanes_sum<L>(ss);
    return rsqrtf(ss / (float)HW + eps);
  }
};

template <int HW, int L>
__global__ void __launch_bounds__(THREADS)
    frn_tlu_fwd_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
                       const float* __restrict__ beta, const float* __restrict__ tau,
                       float* __restrict__ z, long long planes, int channels, float eps) {
  const Plane<HW, L> pl(planes);
  float4 v[Plane<HW, L>::P];
  pl.load(x, v);
  const int c = (int)(pl.plane % channels);
  const float r = pl.rnorm(v, eps);
  if (!pl.live) return;
  const float s = __ldg(gamma + c) * r, b = __ldg(beta + c), t = __ldg(tau + c);
#pragma unroll
  for (int p = 0; p < Plane<HW, L>::P; ++p) {
    v[p].x = tlu(fmaf(s, v[p].x, b), t);
    v[p].y = tlu(fmaf(s, v[p].y, b), t);
    v[p].z = tlu(fmaf(s, v[p].z, b), t);
    v[p].w = tlu(fmaf(s, v[p].w, b), t);
  }
  pl.store(z, v);
}

template <int HW, int L>
__global__ void __launch_bounds__(THREADS)
    frn_tlu_bwd_kernel(const float* __restrict__ dz, const float* __restrict__ x,
                       const float* __restrict__ gamma, const float* __restrict__ beta,
                       const float* __restrict__ tau, float* __restrict__ dx,
                       float* __restrict__ part, long long planes, int channels, float eps) {
  constexpr int P = Plane<HW, L>::P;
  const Plane<HW, L> pl(planes);
  float4 v[P], g[P];
  pl.load(x, v);
  pl.load(dz, g);
  const int c = (int)(pl.plane % channels);
  const float r = pl.rnorm(v, eps);
  const float gm = pl.live ? __ldg(gamma + c) : 0.f;
  const float b = pl.live ? __ldg(beta + c) : 0.f, t = pl.live ? __ldg(tau + c) : 0.f;
  const float s = gm * r;
  float sdy = 0.f, sdyx = 0.f, sdt = 0.f;
  // dz's element becomes dy's, and the plane's sums take it in
  auto mask = [&](float& gk, float xk) {
    const float d = tlu_grad(fmaf(s, xk, b), t, gk);
    sdt += gk - d;
    sdy += d;
    sdyx = fmaf(d, xk, sdyx);
    gk = d;
  };
#pragma unroll
  for (int p = 0; p < P; ++p) {
    mask(g[p].x, v[p].x);
    mask(g[p].y, v[p].y);
    mask(g[p].z, v[p].z);
    mask(g[p].w, v[p].w);
  }
  sdy = lanes_sum<L>(sdy);
  sdyx = lanes_sum<L>(sdyx);
  sdt = lanes_sum<L>(sdt);
  if (!pl.live) return;
  const float k = s * r * r * sdyx / (float)HW;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    g[p].x = s * g[p].x - k * v[p].x;
    g[p].y = s * g[p].y - k * v[p].y;
    g[p].z = s * g[p].z - k * v[p].z;
    g[p].w = s * g[p].w - k * v[p].w;
  }
  pl.store(dx, g);
  if (pl.lane == 0) {
    float* out = part + pl.plane * 3;
    out[0] = sdy;
    out[1] = r * sdyx;
    out[2] = sdt;
  }
}

// ---- the generic variant: a warp a plane, any H*W, float32 or float64 ----

template <typename T>
__device__ __forceinline__ T warp_rnorm(const T* xp, int hw, T eps) {
  T ss = 0;
  for (int e = threadIdx.x & 31; e < hw; e += 32) ss = mul_add(xp[e], xp[e], ss);
  return inv_sqrt(lanes_sum<32>(ss) / (T)hw + eps);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    frn_tlu_fwd_any_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                       const T* __restrict__ beta, const T* __restrict__ tau, T* __restrict__ z,
                       long long planes, int channels, int hw, T eps) {
  const long long plane = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (plane >= planes) return;  // the whole warp
  const int c = (int)(plane % channels);
  const T* xp = x + plane * hw;
  T* zp = z + plane * hw;
  const T s = gamma[c] * warp_rnorm(xp, hw, eps), b = beta[c], t = tau[c];
  for (int e = threadIdx.x & 31; e < hw; e += 32) zp[e] = tlu(mul_add(s, xp[e], b), t);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    frn_tlu_bwd_any_kernel(const T* __restrict__ dz, const T* __restrict__ x,
                       const T* __restrict__ gamma, const T* __restrict__ beta,
                       const T* __restrict__ tau, T* __restrict__ dx, T* __restrict__ part,
                       long long planes, int channels, int hw, T eps) {
  const long long plane = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (plane >= planes) return;  // the whole warp
  const int c = (int)(plane % channels);
  const T* xp = x + plane * hw;
  const T* gp = dz + plane * hw;
  T* dp = dx + plane * hw;
  const T r = warp_rnorm(xp, hw, eps);
  const T s = gamma[c] * r, b = beta[c], t = tau[c];
  T sdy = 0, sdyx = 0, sdt = 0;
  for (int e = threadIdx.x & 31; e < hw; e += 32) {
    const T d = tlu_grad(mul_add(s, xp[e], b), t, gp[e]);
    sdt += gp[e] - d;
    sdy += d;
    sdyx = mul_add(d, xp[e], sdyx);
  }
  sdy = lanes_sum<32>(sdy);
  sdyx = lanes_sum<32>(sdyx);
  sdt = lanes_sum<32>(sdt);
  const T k = s * r * r * sdyx / (T)hw;
  for (int e = threadIdx.x & 31; e < hw; e += 32)
    dp[e] = s * tlu_grad(mul_add(s, xp[e], b), t, gp[e]) - k * xp[e];
  if ((threadIdx.x & 31) == 0) {
    T* out = part + plane * 3;
    out[0] = sdy;
    out[1] = r * sdyx;
    out[2] = sdt;
  }
}

// out (3, C) = the (N, C, 3) partials summed over N: a block a channel, in
// float64, every thread over rows t, t + THREADS, ..., then a fixed tree
template <typename T>
__global__ void __launch_bounds__(THREADS)
    frn_tlu_sum_kernel(const T* __restrict__ part, T* __restrict__ out, long long rows,
                       int channels) {
  __shared__ double sum[3][THREADS];
  const int c = blockIdx.x, t = threadIdx.x;
  double a0 = 0, a1 = 0, a2 = 0;
#pragma unroll 4
  for (long long n = t; n < rows; n += THREADS) {
    const T* p = part + (n * channels + c) * 3;
    a0 += (double)p[0];
    a1 += (double)p[1];
    a2 += (double)p[2];
  }
  sum[0][t] = a0;
  sum[1][t] = a1;
  sum[2][t] = a2;
  __syncthreads();
#pragma unroll
  for (int half = THREADS / 2; half > 0; half >>= 1) {
    if (t < half)
      for (int k = 0; k < 3; ++k) sum[k][t] += sum[k][t + half];
    __syncthreads();
  }
  if (t < 3) out[t * channels + c] = (T)sum[t][0];
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

inline unsigned int blocks(long long planes, long long per_block) {
  return (unsigned int)((planes + per_block - 1) / per_block);
}

template <int HW, int L>
int forward_planes(const float* x, const float* gamma, const float* beta, const float* tau,
                   float* z, long long planes, int channels, float eps, cudaStream_t stream) {
  LAUNCH(frn_tlu_fwd_kernel<HW, L><<<blocks(planes, Plane<HW, L>::PER_BLOCK), THREADS, 0,
                                      stream>>>(x, gamma, beta, tau, z, planes, channels, eps));
  return 0;
}

template <int HW, int L>
int backward_planes(const float* dz, const float* x, const float* gamma, const float* beta,
                    const float* tau, float* dx, float* part, long long planes, int channels,
                    float eps, cudaStream_t stream) {
  LAUNCH(frn_tlu_bwd_kernel<HW, L><<<blocks(planes, Plane<HW, L>::PER_BLOCK), THREADS, 0,
                                      stream>>>(dz, x, gamma, beta, tau, dx, part, planes,
                                                channels, eps));
  return 0;
}

template <typename T>
int forward(const T* x, const T* gamma, const T* beta, const T* tau, T* z, long long planes,
            int channels, int hw, double eps, cudaStream_t stream) {
  if constexpr (sizeof(T) == 4) {
    if (aligned16(x) && aligned16(z)) {
      const float e = (float)eps;
      // L lanes a plane: 4 float4s a lane, 8 where a plane outgrows a warp
      switch (hw) {
        case 64:
          return forward_planes<64, 4>(x, gamma, beta, tau, z, planes, channels, e, stream);
        case 256:
          return forward_planes<256, 16>(x, gamma, beta, tau, z, planes, channels, e, stream);
        case 1024:
          return forward_planes<1024, 32>(x, gamma, beta, tau, z, planes, channels, e, stream);
        default: break;
      }
    }
  }
  LAUNCH(frn_tlu_fwd_any_kernel<T><<<blocks(planes, WARPS), THREADS, 0, stream>>>(
      x, gamma, beta, tau, z, planes, channels, hw, (T)eps));
  return 0;
}

template <typename T>
int backward(const T* dz, const T* x, const T* gamma, const T* beta, const T* tau, T* dx,
             T* part, T* grads, long long rows, int channels, int hw, double eps,
             cudaStream_t stream) {
  const long long planes = rows * channels;
  int err = -1;  // -1: the register path does not take these planes
  if constexpr (sizeof(T) == 4) {
    if (aligned16(dz) && aligned16(x) && aligned16(dx)) {
      const float e = (float)eps;
      switch (hw) {
        case 64:
          err = backward_planes<64, 4>(dz, x, gamma, beta, tau, dx, part, planes, channels, e,
                                       stream);
          break;
        case 256:
          err = backward_planes<256, 16>(dz, x, gamma, beta, tau, dx, part, planes, channels, e,
                                         stream);
          break;
        case 1024:
          err = backward_planes<1024, 32>(dz, x, gamma, beta, tau, dx, part, planes, channels, e,
                                          stream);
          break;
        default: break;
      }
    }
  }
  if (err < 0) {
    LAUNCH(frn_tlu_bwd_any_kernel<T><<<blocks(planes, WARPS), THREADS, 0, stream>>>(
        dz, x, gamma, beta, tau, dx, part, planes, channels, hw, (T)eps));
  } else if (err != 0) {
    return err;
  }
  LAUNCH(frn_tlu_sum_kernel<T><<<channels, THREADS, 0, stream>>>(part, grads, rows, channels));
  return 0;
}

bool valid(long long rows, int channels, int hw, int dtype) {
  return rows >= 1 && channels >= 1 && hw >= 1 && (dtype == 0 || dtype == 1);
}

}  // namespace

extern "C" {

const char* frn_tlu_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// z = max(gamma x r + beta, tau) over the rows x channels planes of hw
// elements of x (NCHW, contiguous), r = (mean of the plane's x^2 + eps)^-1/2;
// gamma, beta and tau hold one value a channel.  dtype 0 is float32, 1
// float64.  Device pointers; stream is a cudaStream_t.  One kernel, queued
// without synchronising; returns its launch error as a cudaError_t (0 on
// success).
int frn_tlu_forward(const void* x, const void* gamma, const void* beta, const void* tau, void* z,
                    long long rows, int channels, int hw, double eps, int dtype,
                    void* stream_ptr) {
  if (!valid(rows, channels, hw, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const long long planes = rows * channels;
  if (dtype == 0)
    return forward((const float*)x, (const float*)gamma, (const float*)beta, (const float*)tau,
                   (float*)z, planes, channels, hw, eps, stream);
  return forward((const double*)x, (const double*)gamma, (const double*)beta,
                 (const double*)tau, (double*)z, planes, channels, hw, eps, stream);
}

// The gradients of sum(dz * z) for frn_tlu_forward's z: dx (as x), and
// grads (3, C) = the gradients of beta, gamma and tau in that order, through
// part, a (rows, C, 3) scratch.  Two kernels, queued without synchronising;
// returns the first launch error (0 on success).
int frn_tlu_backward(const void* dz, const void* x, const void* gamma, const void* beta,
                     const void* tau, void* dx, void* part, void* grads, long long rows,
                     int channels, int hw, double eps, int dtype, void* stream_ptr) {
  if (!valid(rows, channels, hw, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (dtype == 0)
    return backward((const float*)dz, (const float*)x, (const float*)gamma, (const float*)beta,
                    (const float*)tau, (float*)dx, (float*)part, (float*)grads, rows, channels,
                    hw, eps, stream);
  return backward((const double*)dz, (const double*)x, (const double*)gamma,
                  (const double*)beta, (const double*)tau, (double*)dx, (double*)part,
                  (double*)grads, rows, channels, hw, eps, stream);
}

}  // extern "C"

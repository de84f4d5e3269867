// Fused multi-chain MCLMC at a frozen (eps, L) for the one-hidden-layer tanh
// regression BNN (the model of bnn_grad.cuh), written by hand for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel hamiltorch_tpu/kernels/bnn_mclmc.py::
// bnn_mclmc (its body _kernel, lines 50-160).  Same sampler: per draw the
// minimal-norm step V(b1 eps) X(eps/2) V((1-2 b1) eps) X(eps/2) V(b1 eps),
// each V an exact isokinetic rotation of the unit velocity u toward the
// gradient g,
//     u <- unit(g ce + 2 zeta u),  ce = (1-zeta)(1+zeta+ue(1-zeta))/|g|,
//     zeta = exp(-coef |g| / (d-1)),  ue = clip(u.g/|g|, -1, 1),
// with its kinetic-energy change dk = (d-1)(delta - ln 2 + ln max(1 + ue +
// (1-ue) zeta^2, 1e-12)); then dE = dk1 + dk2 + dk3 + logp - logp2 is
// accumulated as sum dE^2, and the OU refresh u <- unit(u + nu z) draws z
// from Philox + Box-Muller keyed on (seed, chain, draw, element pair) (or
// takes given normals).  It returns the final parameters and
// var_e = sum dE^2 / num_samples / d per chain.  Like the TPU kernel it has
// no guard against non-finite steps (run_mclmc* has one); unlike it, no
// padded W1 rows exist here.
//
// What bounds it.  Each draw is two gradient evaluations, four GEMMs of
// 2*N*I*H flops per chain: at the flagship (N=1024, I=784, H=128) 52.6
// GFLOP per draw for 64 chains.  The GEMMs run on the tensor cores in
// 3xTF32 (bnn_grad.cuh): 3 x 52.6 GFLOP at the 495 TFLOP/s dense tf32 peak
// of an H100 SXM (700 W) is 0.32 ms per draw (0.79 ms at the 67 TFLOP/s
// float32 FMA peak).  The vector algebra between the gradients reads and
// writes the 100,609-float state a few times per rotation (about 0.2 GB per
// draw at 64 chains, ~0.06 ms at 3.35 TB/s).
//
// What the design does about it.  As in bnn_hmc.cu, the state of all chains
// lives in device memory (one chain's state is larger than a block's shared
// memory), packed with W1 transposed (bnn_grad.cuh; the rotations below are
// elementwise and do not care about the order, the refresh normals are
// keyed on the logical element), and the host loops over draws, launching
// on the caller's stream: the gradient (launch_gradient: forward and
// backward wgmma GEMMs, per-chain kernel; no kick), and for each rotation
//   dots_kernel    per-block partial sums of |g|^2 and u.g in float64;
//   rotate_kernel  every block reduces its chain's partials in a fixed order
//                  to the rotation's scalars (float64), writes
//                  w = ce g + 2 zeta u and partial sums of |w|^2; block 0
//                  accumulates dk (and after the third rotation closes the
//                  draw: dE, sum dE^2, logp <- logp2);
//   scale_kernel   u = w / |w|, with the drift th += (eps/2) u, or with the
//                  refresh u + nu z and its partial sums of squares.
// logp and every norm and dot are reduced in float64 in a fixed order, so a
// run is deterministic; parameters, velocities and gradients stay float32.

#include "bnn_grad.cuh"

namespace {

constexpr double B1 = 0.1931833275037836;  // minimal-norm velocity coefficient

struct Layout {
  BnnDims s;
  GradOffsets grad_ws;
  size_t th, u, g;                                              // float regions
  size_t pdot, pnorm, logp_cur, logp_prop, dk, sum_de2, bytes;  // double regions
};

Layout make_layout(int n, int in_dim, int hidden, int chains) {
  Layout L;
  L.s = make_dims(n, in_dim, hidden, chains);
  Arena a;
  const size_t C = chains;
  L.th = a.take(C * L.s.dp, 4);
  L.u = a.take(C * L.s.dp, 4);
  L.g = a.take(C * L.s.dp, 4);
  L.grad_ws = take_grad_scratch(a, L.s);
  L.pdot = a.take(C * L.s.ew_blocks * 2, 8);
  L.pnorm = a.take(C * L.s.ew_blocks * 2, 8);
  L.logp_cur = a.take(C, 8);
  L.logp_prop = a.take(C, 8);
  L.dk = a.take(C, 8);
  L.sum_de2 = a.take(C, 8);
  L.bytes = a.off;
  return L;
}

// sum over a chain's ew_blocks partials (component comp of 2), fixed order
__device__ __forceinline__ double chain_sum(const double* part, int c, int ew_blocks, int comp) {
  double s = 0.0;
  for (int b = 0; b < ew_blocks; ++b) s += part[((long long)c * ew_blocks + b) * 2 + comp];
  return s;
}

// part[c][block] = (sum a^2, sum a.b) over the packed slots of chain
// blockIdx.y (padding slots are zero)
__global__ void __launch_bounds__(EW) dots_kernel(const float* __restrict__ a,
                                                  const float* __restrict__ b,
                                                  double* __restrict__ part, long long dp) {
  const int c = blockIdx.y;
  const float* ac = a + c * dp;
  const float* bc = b + c * dp;
  double aa = 0.0, ab = 0.0;
  for (long long k = blockIdx.x * (long long)blockDim.x + threadIdx.x; k < dp;
       k += (long long)gridDim.x * blockDim.x) {
    const double av = ac[k];
    aa += av * av;
    ab += av * bc[k];
  }
  aa = block_sum(aa);
  ab = block_sum(ab);
  if (threadIdx.x == 0) {
    const long long at = ((long long)c * gridDim.x + blockIdx.x) * 2;
    part[at] = aa;
    part[at + 1] = ab;
  }
}

// One isokinetic rotation toward g (see the top of the file) over every
// packed slot (padding stays zero); pdot holds the partials of |g|^2 and
// u.g, pnorm receives those of |w|^2; d is the logical dimension.
__global__ void __launch_bounds__(EW) rotate_kernel(
    const float* __restrict__ g, float* __restrict__ u, const double* __restrict__ pdot,
    double* __restrict__ pnorm, double* __restrict__ dk, double* __restrict__ logp_cur,
    const double* __restrict__ logp_prop, double* __restrict__ sum_de2, long long d,
    long long dp, double coef, int finish) {
  __shared__ float coefs[2];
  const int c = blockIdx.y;
  if (threadIdx.x == 0) {
    const double dims = (double)d;
    const double gn = sqrt(chain_sum(pdot, c, gridDim.x, 0));
    const double inv_g = 1.0 / fmax(gn, 1e-30);
    const double delta = coef * gn / (dims - 1.0);
    const double ue = fmin(fmax(chain_sum(pdot, c, gridDim.x, 1) * inv_g, -1.0), 1.0);
    const double zeta = exp(-delta);
    coefs[0] = (float)((1.0 - zeta) * (1.0 + zeta + ue * (1.0 - zeta)) * inv_g);
    coefs[1] = (float)(2.0 * zeta);
    if (blockIdx.x == 0) {
      const double dkc = (dims - 1.0) * (delta - 0.6931471805599453 +
                                        log(fmax(1.0 + ue + (1.0 - ue) * zeta * zeta, 1e-12)));
      double acc = dk[c] + dkc;
      if (finish) {
        const double de = acc + (logp_cur[c] - logp_prop[c]);
        sum_de2[c] += de * de;
        logp_cur[c] = logp_prop[c];
        acc = 0.0;
      }
      dk[c] = acc;
    }
  }
  __syncthreads();
  const float ce = coefs[0], s = coefs[1];
  const float* gc = g + c * dp;
  float* uc = u + c * dp;
  double nn = 0.0;
  for (long long k = blockIdx.x * (long long)blockDim.x + threadIdx.x; k < dp;
       k += (long long)gridDim.x * blockDim.x) {
    const float w = fmaf(ce, gc[k], s * uc[k]);
    uc[k] = w;
    nn += (double)w * w;
  }
  nn = block_sum(nn);
  if (threadIdx.x == 0) pnorm[((long long)c * gridDim.x + blockIdx.x) * 2] = nn;
}

// u <- u / |u| (|u|^2 from the partials in pnorm); then with th the drift
// th += h u, or with part_out the refresh u += nu z (z from Philox, or the
// given normals, both keyed on the logical element) and partial sums of
// |u|^2 into part_out.  Padding slots are not touched.
__global__ void __launch_bounds__(EW) scale_kernel(
    float* __restrict__ u, float* __restrict__ th, const double* __restrict__ pnorm,
    double* __restrict__ part_out, const BnnDims s, float h, float nu, int draw, uint2 key,
    const float* __restrict__ normals) {
  __shared__ float inv_s;
  const int c = blockIdx.y;
  if (threadIdx.x == 0) inv_s = (float)(1.0 / sqrt(chain_sum(pnorm, c, gridDim.x, 0)));
  __syncthreads();
  const float inv = inv_s;
  float* uc = u + c * s.dp;
  float* thc = th ? th + c * s.dp : nullptr;
  const float* z_in = normals ? normals + ((long long)draw * s.chains + c) * s.d : nullptr;
  double nn = 0.0;
  const long long pairs = (s.d + 1) / 2;
  for (long long q = blockIdx.x * (long long)blockDim.x + threadIdx.x; q < pairs;
       q += (long long)gridDim.x * blockDim.x) {
    const Pair pr = pair_at(q, s);
    float z[2] = {0.f, 0.f};
    if (part_out) {
      if (z_in) {
        z[0] = z_in[pr.k0];
        z[1] = (pr.m1 >= 0) ? z_in[pr.k0 + 1] : 0.0f;
      } else {
        const float2 r = box_muller(
            philox(make_uint4((uint32_t)(pr.k0 / 2), (uint32_t)draw, (uint32_t)c, 2u), key));
        z[0] = r.x;
        z[1] = r.y;
      }
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const long long k = e ? pr.m1 : pr.m0;
      if (k >= 0) {
        float v = uc[k] * inv;
        if (thc) thc[k] = fmaf(h, v, thc[k]);
        if (part_out) {
          v = fmaf(nu, z[e], v);
          nn += (double)v * v;
        }
        uc[k] = v;
      }
    }
  }
  if (part_out) {
    nn = block_sum(nn);
    if (threadIdx.x == 0) part_out[((long long)c * gridDim.x + blockIdx.x) * 2] = nn;
  }
}

}  // namespace

extern "C" {

// Bytes of device workspace bnn_mclmc_run needs for these shapes.
size_t bnn_mclmc_workspace_bytes(int n, int in_dim, int hidden, int chains) {
  return make_layout(n, in_dim, hidden, chains).bytes;
}

const char* bnn_mclmc_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Run num_samples frozen-(eps, L) MCLMC draws on every chain from the
// packed initial parameters and velocity u (C, D), which need not be unit.
// nu = sqrt(expm1(2 eps / L) / D) comes from the caller.  All pointers are
// device pointers (stream is a cudaStream_t); hidden must be a multiple of
// 128 and chains at most 65535 (a grid dimension), and the caller checks
// num_samples >= 1; normals (S, C, D) may be null.  N and I are free.  Launches on the stream
// without synchronising and returns the first launch error as a
// cudaError_t (0 on success).
int bnn_mclmc_run(const float* x, const float* y, const float* w1, const float* b1,
                  const float* w2, const float* b2, const float* u_in, float* w1_out,
                  float* b1_out, float* w2_out, float* b2_out, float* var_e_out,
                  void* workspace, int n, int in_dim, int hidden, int chains, int num_samples,
                  float step_size, float nu, float tau, unsigned long long seed,
                  const float* normals, void* stream_ptr) {
  if (hidden % BN != 0 || n < 1 || in_dim < 1 || chains < 1 || chains > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const Layout L = make_layout(n, in_dim, hidden, chains);
  const BnnDims& S = L.s;
  char* ws = (char*)workspace;
  float* th = (float*)(ws + L.th);
  float* u = (float*)(ws + L.u);
  float* g = (float*)(ws + L.g);
  const GradScratch scratch = grad_scratch(ws, L.grad_ws);
  GradMaps maps;
  double* pdot = (double*)(ws + L.pdot);
  double* pnorm = (double*)(ws + L.pnorm);
  double* logp_cur = (double*)(ws + L.logp_cur);
  double* logp_prop = (double*)(ws + L.logp_prop);
  double* dk = (double*)(ws + L.dk);
  double* sum_de2 = (double*)(ws + L.sum_de2);
  const uint2 key = seed_key(seed);
  const dim3 ew_grid(S.ew_blocks, chains);
  const float half = 0.5f * step_size;
  int err;

  auto gradient = [&]() -> int {
    return launch_gradient(S, maps, y, th, g, nullptr, scratch, logp_prop, nullptr, tau, 0.f,
                           0.f, 0, stream);
  };
  // V(coef) and, unless last, the drift X(eps/2) that follows it
  auto rotate = [&](double coef, int last) -> int {
    dots_kernel<<<ew_grid, EW, 0, stream>>>(g, u, pdot, S.dp);
    LAUNCH_CHECK();
    rotate_kernel<<<ew_grid, EW, 0, stream>>>(g, u, pdot, pnorm, dk, logp_cur, logp_prop, sum_de2,
                                              S.d, S.dp, coef, last);
    LAUNCH_CHECK();
    if (!last) {
      scale_kernel<<<ew_grid, EW, 0, stream>>>(u, th, pnorm, nullptr, S, half, 0.f, 0, key,
                                               nullptr);
      LAUNCH_CHECK();
    }
    return 0;
  };

  // zeros everywhere first: the padding slots of the packed state stay zero
  if ((err = (int)cudaMemsetAsync(ws, 0, L.bytes, stream)) != 0) return err;
  pack_kernel<<<ew_grid, EW, 0, stream>>>(w1, b1, w2, b2, th, nullptr, S);
  LAUNCH_CHECK();
  pack_flat_kernel<<<ew_grid, EW, 0, stream>>>(u_in, u, S);
  LAUNCH_CHECK();
  if ((err = prepare_gradient(S, x, th, scratch, &maps, stream)) != 0) return err;
  // u <- unit(u); gradient and logp at the initial point
  dots_kernel<<<ew_grid, EW, 0, stream>>>(u, u, pnorm, S.dp);
  LAUNCH_CHECK();
  scale_kernel<<<ew_grid, EW, 0, stream>>>(u, nullptr, pnorm, nullptr, S, 0.f, 0.f, 0, key,
                                           nullptr);
  LAUNCH_CHECK();
  if ((err = gradient()) != 0) return err;
  if ((err = (int)cudaMemcpyAsync(logp_cur, logp_prop, sizeof(double) * chains,
                                  cudaMemcpyDeviceToDevice, stream)) != 0)
    return err;

  for (int draw = 0; draw < num_samples; ++draw) {
    if ((err = rotate(B1 * step_size, 0)) != 0) return err;
    if ((err = gradient()) != 0) return err;
    if ((err = rotate((1.0 - 2.0 * B1) * step_size, 0)) != 0) return err;
    if ((err = gradient()) != 0) return err;
    if ((err = rotate(B1 * step_size, 1)) != 0) return err;
    // refresh: u <- unit(unit(w) + nu z)
    scale_kernel<<<ew_grid, EW, 0, stream>>>(u, nullptr, pnorm, pdot, S, 0.f, nu, draw, key,
                                             normals);
    LAUNCH_CHECK();
    scale_kernel<<<ew_grid, EW, 0, stream>>>(u, nullptr, pdot, nullptr, S, 0.f, 0.f, draw, key,
                                             nullptr);
    LAUNCH_CHECK();
  }

  unpack_kernel<<<ew_grid, EW, 0, stream>>>(th, sum_de2, (double)num_samples * (double)S.d, w1_out,
                                            b1_out, w2_out, b2_out, var_e_out, S);
  LAUNCH_CHECK();
  return 0;
}

}  // extern "C"

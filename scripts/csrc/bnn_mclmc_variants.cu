// Designs of bnn_mclmc that were replaced, and the package's design with the
// options it does not take, for scripts/bnn_mclmc_variants_torch.py to time
// beside the package's kernel.  No part of the package.
//   - bnn_mclmc_options_run: the package's mclmc_run (its source is included
//     whole) with any sum of its Option values: chains walked in reverse,
//     programmatic dependent launches, a CUDA graph a draw;
//   - bnn_mclmc_former_run: the former design, as the package ran it before
//     the velocity algebra was redesigned: per rotation a dots pass
//     (|g|^2, u.g), a rotate pass (w = ce g + 2 zeta u and partial sums of
//     |w|^2) and a scale pass (u = w / |w| with the drift), the refresh as
//     two more scale passes, every block summing its chain's 64 partials
//     in thread 0: 27 passes over the state in 16 launches a draw.  Same
//     arguments as bnn_mclmc_run, on the same gradient kernels.

#include "../../hamiltorch_tpu_torch/kernels/csrc/bnn_mclmc.cu"

namespace {

struct FormerLayout {
  BnnDims s;
  GradOffsets grad_ws;
  size_t th, u, g;                                              // float regions
  size_t pdot, pnorm, logp_cur, logp_prop, dk, sum_de2, bytes;  // double regions
};

FormerLayout make_former_layout(int n, int in_dim, int hidden, int chains) {
  FormerLayout L;
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

// bnn_mclmc_run with options, a sum of mclmc_run's Option values (1: chains
// in reverse, 2: dependent launches, 4: a graph a draw); the workspace is
// bnn_mclmc_workspace_bytes'.
int bnn_mclmc_options_run(const float* x, const float* y, const float* w1, const float* b1,
                          const float* w2, const float* b2, const float* u_in, float* w1_out,
                          float* b1_out, float* w2_out, float* b2_out, float* var_e_out,
                          void* workspace, int n, int in_dim, int hidden, int chains,
                          int num_samples, float step_size, float nu, float tau,
                          unsigned long long seed, const float* normals, int fwd_grid,
                          int bwd_grid, void* stream_ptr, int options) {
  return mclmc_run(x, y, w1, b1, w2, b2, u_in, w1_out, b1_out, w2_out, b2_out, var_e_out,
                   workspace, n, in_dim, hidden, chains, num_samples, step_size, nu, tau, seed,
                   normals, fwd_grid, bwd_grid, stream_ptr, options);
}

// Bytes of device workspace bnn_mclmc_former_run needs for these shapes.
size_t bnn_mclmc_former_workspace_bytes(int n, int in_dim, int hidden, int chains) {
  return make_former_layout(n, in_dim, hidden, chains).bytes;
}

// The former design; arguments as bnn_mclmc_run's.
int bnn_mclmc_former_run(const float* x, const float* y, const float* w1, const float* b1,
                  const float* w2, const float* b2, const float* u_in, float* w1_out,
                  float* b1_out, float* w2_out, float* b2_out, float* var_e_out,
                  void* workspace, int n, int in_dim, int hidden, int chains, int num_samples,
                  float step_size, float nu, float tau, unsigned long long seed,
                  const float* normals, int fwd_grid, int bwd_grid, void* stream_ptr) {
  if (hidden % HC != 0 || n < 1 || in_dim < 1 || chains < 1 || chains > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const FormerLayout L = make_former_layout(n, in_dim, hidden, chains);
  BnnDims S = L.s;
  if (!set_grids(S, fwd_grid, bwd_grid)) return (int)cudaErrorInvalidValue;
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

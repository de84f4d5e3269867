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
// step is bound by the tensor cores, which run the products in 3xTF32
// (3 x 26.3 GFLOP at the 495 TFLOP/s dense tf32 peak of an H100 SXM at
// 700 W: 0.16 ms per step at best; in float32 FMA it would be 0.39 ms),
// not by memory.
//
// What the design does about it.  The TPU kernel keeps one chain's whole
// state on chip for the whole run; one chain's f32 state is 402 KB, more
// than the 227 KB of shared memory a block can have.  So the state of all
// chains (theta, momentum, gradient, proposal, packed with W1 transposed:
// see bnn_grad.cuh) lives in device memory, x is split into tf32 parts and
// staged once per run, and the host loops over draws and steps, launching
// on the caller's stream three kernels per leapfrog step (launch_gradient,
// bnn_grad.cuh: the forward and backward GEMMs as persistent,
// warp-specialised wgmma tiles in 3xTF32, the backward's epilogue fusing
// the kick and the next drift while the block's other consumer warpgroup
// multiplies, and a per-chain kernel for the small parameters and the
// energies) plus, per draw,
//   init_draw_kernel Philox + Box-Muller momenta (or given ones), kinetic
//                    energy, the half kick and the first drift;
//   mh_kernel / select_kernel  the Metropolis test and the state copy.
// Energies are reduced in float64 (sums near 5e4 compared against log u).
// Every reduction has a fixed order, so a run is deterministic.

#include "bnn_grad.cuh"

namespace {

struct Layout {
  BnnDims s;
  GradOffsets grad_ws;
  size_t theta, grad, th, gr, p;                                   // float regions
  size_t pk0, logp_cur, logp_prop, kin_prop, flag, count, bytes;  // double regions
};

Layout make_layout(int n, int in_dim, int hidden, int chains) {
  Layout L;
  L.s = make_dims(n, in_dim, hidden, chains);
  Arena a;
  const size_t C = chains;
  L.theta = a.take(C * L.s.dp, 4);
  L.grad = a.take(C * L.s.dp, 4);
  L.th = a.take(C * L.s.dp, 4);
  L.gr = a.take(C * L.s.dp, 4);
  L.p = a.take(C * L.s.dp, 4);
  L.grad_ws = take_grad_scratch(a, L.s);
  L.pk0 = a.take(C * L.s.ew_blocks, 8);
  L.logp_cur = a.take(C, 8);
  L.logp_prop = a.take(C, 8);
  L.kin_prop = a.take(C, 8);
  L.flag = a.take(C, 8);
  L.count = a.take(C, 8);
  L.bytes = a.off;
  return L;
}

// Start of a draw: p = z (Philox or given, both keyed on the logical
// element), partial sums of |z|^2, p += eps/2 grad, th = theta + eps p.
__global__ void __launch_bounds__(EW) init_draw_kernel(
    const float* __restrict__ theta, const float* __restrict__ grad, float* __restrict__ th,
    float* __restrict__ p, double* __restrict__ pk0, const BnnDims s, int draw, float eps,
    uint2 key, const float* __restrict__ momenta) {
  const int c = blockIdx.y;
  const long long base = c * s.dp;
  const float* mom = momenta ? momenta + ((long long)draw * s.chains + c) * s.d : nullptr;
  double k0 = 0.0;
  const long long pairs = (s.d + 1) / 2;
  for (long long q = blockIdx.x * (long long)blockDim.x + threadIdx.x; q < pairs;
       q += (long long)gridDim.x * blockDim.x) {
    const Pair pr = pair_at(q, s);
    float z[2];
    if (mom) {
      z[0] = mom[pr.k0];
      z[1] = (pr.m1 >= 0) ? mom[pr.k0 + 1] : 0.0f;
    } else {
      const float2 r = box_muller(
          philox(make_uint4((uint32_t)(pr.k0 / 2), (uint32_t)draw, (uint32_t)c, 0u), key));
      z[0] = r.x;
      z[1] = r.y;
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const long long m = e ? pr.m1 : pr.m0;
      if (m >= 0) {
        float pv = z[e];
        k0 += (double)pv * pv;
        pv = fmaf(0.5f * eps, grad[base + m], pv);
        p[base + m] = pv;
        th[base + m] = fmaf(eps, pv, theta[base + m]);
      }
    }
  }
  k0 = block_sum(k0);
  if (threadIdx.x == 0) pk0[(long long)c * gridDim.x + blockIdx.x] = k0;
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

// Accepted chains: theta <- th, grad <- gr (every packed slot; padding
// slots are zero on both sides).
__global__ void __launch_bounds__(EW) select_kernel(
    float* __restrict__ theta, float* __restrict__ grad, const float* __restrict__ th,
    const float* __restrict__ gr, const double* __restrict__ flag, long long dp) {
  const int c = blockIdx.y;
  if (flag[c] == 0.0) return;
  for (long long k = blockIdx.x * (long long)blockDim.x + threadIdx.x; k < dp;
       k += (long long)gridDim.x * blockDim.x) {
    theta[c * dp + k] = th[c * dp + k];
    grad[c * dp + k] = gr[c * dp + k];
  }
}

}  // namespace

extern "C" {

// Bytes of device workspace bnn_hmc_run needs for these shapes.
size_t bnn_hmc_workspace_bytes(int n, int in_dim, int hidden, int chains) {
  return make_layout(n, in_dim, hidden, chains).bytes;
}

const char* bnn_hmc_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Run num_samples HMC draws of num_steps leapfrog steps on every chain.
// All pointers are device pointers (stream is a cudaStream_t); hidden must
// be a multiple of 128 and chains at most 65535 (a grid dimension), and the
// caller checks num_samples, num_steps >= 1; momenta (S, C, D) and uniforms
// (S, C) may be null; fwd_grid and bwd_grid are the GEMMs' blocks, from the
// plan (kernels/bnn_grad.py::_plan).  N and I are free (TMA zero-fills
// ragged tiles).  stats (host, kHostStats long longs) and phases (device,
// BWD_PHASES long longs) may be null; else the run's launch accounting is
// written to stats and the backward's phase cycles added into phases.
// Launches on the stream without synchronising and returns the first
// launch error as a cudaError_t (0 on success).
int bnn_hmc_run(const float* x, const float* y, const float* w1, const float* b1,
                const float* w2, const float* b2, float* w1_out, float* b1_out, float* w2_out,
                float* b2_out, float* acc_out, void* workspace, int n, int in_dim, int hidden,
                int chains, int num_samples, int num_steps, float step_size, float tau,
                unsigned long long seed, const float* momenta, const float* uniforms,
                int fwd_grid, int bwd_grid, void* stream_ptr, long long* stats,
                long long* phases) {
  const HostStatsScope accounted(stats);
  if (hidden % HC != 0 || n < 1 || in_dim < 1 || chains < 1 || chains > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const Layout L = make_layout(n, in_dim, hidden, chains);
  BnnDims S = L.s;
  if (!set_grids(S, fwd_grid, bwd_grid)) return (int)cudaErrorInvalidValue;
  char* ws = (char*)workspace;
  float* theta = (float*)(ws + L.theta);
  float* grad = (float*)(ws + L.grad);
  float* th = (float*)(ws + L.th);
  float* gr = (float*)(ws + L.gr);
  float* p = (float*)(ws + L.p);
  const GradScratch scratch = grad_scratch(ws, L.grad_ws);
  GradMaps maps;
  double* pk0 = (double*)(ws + L.pk0);
  double* logp_cur = (double*)(ws + L.logp_cur);
  double* logp_prop = (double*)(ws + L.logp_prop);
  double* kin_prop = (double*)(ws + L.kin_prop);
  double* flag = (double*)(ws + L.flag);
  double* count = (double*)(ws + L.count);
  const uint2 key = seed_key(seed);

  const dim3 ew_grid(S.ew_blocks, chains);
  const int mh_blocks = (chains + 127) / 128;

  auto gradient = [&](float kappa, int drift) -> int {
    return launch_gradient(S, maps, y, th, gr, p, scratch, logp_prop, kin_prop, tau, kappa,
                           step_size, drift, stream, phases);
  };
  auto metropolis = [&](int draw, int force) -> int {
    LAUNCH(mh_kernel<<<mh_blocks, 128, 0, stream>>>(pk0, S.ew_blocks, logp_cur, logp_prop,
                                                    kin_prop, flag, count, chains, draw, key,
                                                    uniforms, force));
    LAUNCH(select_kernel<<<ew_grid, EW, 0, stream>>>(theta, grad, th, gr, flag, S.dp));
    return 0;
  };

  int err;
  if ((err = prepare_gradient_maps(S, th, scratch, &maps, phases != nullptr)) != 0) return err;
  // zeros everywhere first: the padding slots of the packed state stay zero
  if ((err = queued([&] { return cudaMemsetAsync(ws, 0, L.bytes, stream); })) != 0) return err;
  LAUNCH(pack_kernel<<<ew_grid, EW, 0, stream>>>(w1, b1, w2, b2, theta, th, S));
  if ((err = stage_x(S, x, scratch, stream)) != 0) return err;

  // gradient and logp at the initial point; "accept" it as the current state
  if ((err = gradient(0.0f, 0)) != 0) return err;
  if ((err = metropolis(0, 1)) != 0) return err;

  for (int draw = 0; draw < num_samples; ++draw) {
    LAUNCH(init_draw_kernel<<<ew_grid, EW, 0, stream>>>(theta, grad, th, p, pk0, S, draw,
                                                        step_size, key, momenta));
    for (int s = 1; s <= num_steps; ++s) {
      const bool last = (s == num_steps);
      // the last kick is a full one minus the half pulled back
      if ((err = gradient(last ? 0.5f * step_size : step_size, last ? 0 : 1)) != 0) return err;
    }
    if ((err = metropolis(draw, 0)) != 0) return err;
  }

  LAUNCH(unpack_kernel<<<ew_grid, EW, 0, stream>>>(theta, count, (double)num_samples, w1_out,
                                                   b1_out, w2_out, b2_out, acc_out, S));
  return 0;
}

}  // extern "C"

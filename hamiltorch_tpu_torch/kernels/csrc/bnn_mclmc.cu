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
// float32 FMA peak).  The velocity algebra between the gradients is bound
// by bytes: call a pass one read or write of one 64-chain state array (64 x
// 100,612 floats, 25.76 MB at the flagship; g and u together overflow the
// 50 MB L2).  This design moves 15 passes a draw (386 MB, 0.115 ms at 3.35
// TB/s) in 9 launches: two rotations with their drift at 5 passes each
// (read g, u, theta; write u, theta), the third rotation with the refresh
// at 3 (read g, u; write u), and 2 reads of u in the gradients' epilogues.
// The former design, replaced in commit 1efd31b, moved 27 passes
// (695 MB, 0.208 ms) in 16 launches: each rotation read g and u for its
// dots, again to rotate, and u once more to normalise and drift, and the
// refresh took two passes of its own.
//
// What the design does about it.  As in bnn_hmc.cu, the state of all chains
// lives in device memory (one chain's state is larger than a block's shared
// memory), packed with W1 transposed (bnn_grad.cuh; the passes below are
// elementwise and do not care about the order, the refresh normals are
// keyed on the logical element), and the host loops over draws, launching
// on the caller's stream:
//   - the gradient (launch_gradient_dots: forward and backward wgmma GEMMs,
//     per-chain kernel) also reduces |g|^2, u.g and |u|^2 against the
//     velocity where g is produced, to three float64 scalars a chain;
//   - rotate_drift_kernel, rotations 1 and 2: every block turns the
//     chain's dots into the rotation's scalars (float64) and, since
//     |w|^2 = ce^2 |g|^2 + 2 ce s u.g + s^2 |u|^2 follows from them, writes
//     u <- w / |w| and theta += (eps/2) u in one pass, without a norm pass
//     of its own; block 0 accumulates dk;
//   - rotate_refresh_kernel, rotation 3 and the refresh in one pass:
//     v = unit(w) + nu z, with per-block partial sums of |v|^2 and v.g;
//     block 0 closes the draw (dE, sum dE^2, logp <- logp2).  v is not
//     normalised here: the next draw's first pass reduces the partials (one
//     warp, a fixed order) and applies 1/|v| as it reads u, its u.g being
//     (v.g)/|v| against the same g.  The first draw normalises the given u
//     the same way, from the dots of the gradient at the start.
// A rotation with u nearly anti-parallel to g and small zeta (ce g nearly
// cancelling s u) keeps |w|^2 = 4 zeta^4 from float64 terms of size
// 4 zeta^2.  logp and every norm and dot are reduced in float64 in a fixed
// order, so a run is deterministic; parameters, velocities and gradients
// stay float32.
//
// Launches: the passes walk the chains from the last, whose g and u the
// backward kernel wrote last (still in L2); the passes and the gradients'
// backward and per-chain kernels are programmatic dependents of the kernel
// before them (launch_ex); every draw after the first replays one CUDA graph,
// the draw index read from device memory.  Each of the three gained alone,
// and together they took ~2% off a flagship run (commit 1efd31b).

#include "bnn_grad.cuh"

namespace {

constexpr double B1 = 0.1931833275037836;  // minimal-norm velocity coefficient

// Where a pass finds the velocity it rotates and its dots against g:
// kUnit: u is the unit vector a pass wrote, the dots those of the gradient;
// kGiven: u is the given velocity (not unit), the dots those of the gradient;
// kRefreshed: u is the refresh's v (not unit), |g|^2 that of the gradient and
// |v|^2, v.g the refresh's per-block partials.
enum Source { kUnit = 0, kGiven = 1, kRefreshed = 2 };

struct Layout {
  BnnDims s;
  GradOffsets grad_ws;
  size_t th, u, g;                                                     // float regions
  size_t dots, pv, logp_cur, logp_prop, dk, sum_de2, draw_ctr, bytes;  // double and int regions
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
  L.dots = a.take(C * 3, 8);
  L.pv = a.take(C * L.s.ew_blocks * 2, 8);
  L.logp_cur = a.take(C, 8);
  L.logp_prop = a.take(C, 8);
  L.dk = a.take(C, 8);
  L.sum_de2 = a.take(C, 8);
  L.draw_ctr = a.take(1, 4);
  L.bytes = a.off;
  return L;
}

// A rotation's float32 coefficients: w = ce g + s (scale u), u_new = inv w.
struct Rotation {
  float ce, s, inv, scale;
};

// The scalars of one rotation of chain c by coef (see the top of the file)
// into *r, computed by the block's first warp, and, in block 0, its dk added
// to dk[c]; with finish, block 0 also closes the draw.  The caller syncs.
__device__ void rotation(Rotation* r, int c, int src, const double* __restrict__ dots,
                         const double* __restrict__ pv, double* __restrict__ dk,
                         double* __restrict__ logp_cur, const double* __restrict__ logp_prop,
                         double* __restrict__ sum_de2, double dims, double coef, int finish) {
  if (threadIdx.x >= 32) return;
  double vv = 0.0, vg = 0.0;
  if (src == kRefreshed) {  // the refresh's partials, in a fixed order
    for (int b = threadIdx.x; b < gridDim.x; b += 32) {
      vv += pv[((long long)c * gridDim.x + b) * 2];
      vg += pv[((long long)c * gridDim.x + b) * 2 + 1];
    }
    vv = warp_sum(vv);
    vg = warp_sum(vg);
  }
  if (threadIdx.x != 0) return;
  const double gg = dots[3 * c];
  double ug = dots[3 * c + 1], uu = dots[3 * c + 2];
  float scale = 1.0f;
  if (src != kUnit) {  // u = v / |v|, as the pass reads it
    if (src == kGiven) {
      vv = uu;
      vg = ug;
    }
    scale = (float)(1.0 / sqrt(vv));
    ug = vg * scale;
    uu = vv * scale * scale;
  }
  const double gn = sqrt(gg);
  const double inv_g = 1.0 / fmax(gn, 1e-30);
  const double delta = coef * gn / (dims - 1.0);
  const double ue = fmin(fmax(ug * inv_g, -1.0), 1.0);
  const double zeta = exp(-delta);
  const float ce = (float)((1.0 - zeta) * (1.0 + zeta + ue * (1.0 - zeta)) * inv_g);
  const float s = (float)(2.0 * zeta);
  const double ww = (double)ce * ce * gg + 2.0 * (double)ce * s * ug + (double)s * s * uu;
  *r = Rotation{ce, s, (float)(1.0 / sqrt(ww)), scale};
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

// Rotation 1 or 2 with the drift that follows it, over every packed slot of
// the chain (padding slots hold zeros in g, u and th and keep them):
// u <- inv (ce g + s scale u), th += h u.  With draw_ctr (the graph) block 0
// also counts the draw.  Block row y takes chain C - 1 - y.
__global__ void __launch_bounds__(EW) rotate_drift_kernel(
    const float* __restrict__ g, float* __restrict__ u, float* __restrict__ th,
    const double* __restrict__ dots, const double* __restrict__ pv, double* __restrict__ dk,
    int src, double dims, long long dp, double coef, float h, int* __restrict__ draw_ctr) {
  grid_dependency_wait();
  __shared__ Rotation rot;
  const int c = gridDim.y - 1 - blockIdx.y;
  rotation(&rot, c, src, dots, pv, dk, nullptr, nullptr, nullptr, dims, coef, 0);
  if (draw_ctr && blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) ++*draw_ctr;
  __syncthreads();
  const Rotation r = rot;
  const float4* g4 = reinterpret_cast<const float4*>(g + c * dp);
  float4* u4 = reinterpret_cast<float4*>(u + c * dp);
  float4* t4 = reinterpret_cast<float4*>(th + c * dp);
  auto turn = [&](float gv, float uv, float& tv) {
    const float un = r.inv * fmaf(r.ce, gv, r.s * (uv * r.scale));
    tv = fmaf(h, un, tv);
    return un;
  };
  for (long long k = blockIdx.x * (long long)blockDim.x + threadIdx.x; k < dp / 4;
       k += (long long)gridDim.x * blockDim.x) {
    const float4 gv = g4[k];
    float4 uv = u4[k], tv = t4[k];
    uv.x = turn(gv.x, uv.x, tv.x);
    uv.y = turn(gv.y, uv.y, tv.y);
    uv.z = turn(gv.z, uv.z, tv.z);
    uv.w = turn(gv.w, uv.w, tv.w);
    u4[k] = uv;
    t4[k] = tv;
  }
}

// Rotation 3 and the refresh, closing the draw: v = inv (ce g + s u) + nu z
// (z from Philox, or the given normals, both keyed on the logical element;
// the draw index from *draw_ctr where that is given, else 0) into u, and per-block
// partial sums of |v|^2 and v.g into pv.  Padding slots are not touched.
// Block row y takes chain C - 1 - y.
__global__ void __launch_bounds__(EW) rotate_refresh_kernel(
    const float* __restrict__ g, float* __restrict__ u, const double* __restrict__ dots,
    double* __restrict__ pv, double* __restrict__ dk, double* __restrict__ logp_cur,
    const double* __restrict__ logp_prop, double* __restrict__ sum_de2, const BnnDims s,
    double coef, float nu, const int* __restrict__ draw_ctr, uint2 key,
    const float* __restrict__ normals) {
  grid_dependency_wait();
  __shared__ Rotation rot;
  const int c = gridDim.y - 1 - blockIdx.y;
  rotation(&rot, c, kUnit, dots, nullptr, dk, logp_cur, logp_prop, sum_de2, (double)s.d, coef, 1);
  const int draw = draw_ctr ? *draw_ctr : 0;
  __syncthreads();
  const Rotation r = rot;
  const float* gc = g + c * s.dp;
  float* uc = u + c * s.dp;
  const float* z_in = normals ? normals + ((long long)draw * s.chains + c) * s.d : nullptr;
  double vv = 0.0, vg = 0.0;
  const unsigned pairs = (unsigned)((s.d + 1) / 2);  // d < 2^31 (bnn_mclmc_run checks)
  for (unsigned q = blockIdx.x * blockDim.x + threadIdx.x; q < pairs; q += gridDim.x * blockDim.x) {
    const Pair pr = pair_at(q, s);
    const bool two = pr.m1 >= 0;
    // the loads first, so that they are in flight while Philox runs
    const float g2[2] = {gc[pr.m0], two ? gc[pr.m1] : 0.f};
    const float u2[2] = {uc[pr.m0], two ? uc[pr.m1] : 0.f};
    float z[2];
    if (z_in) {
      z[0] = z_in[pr.k0];
      z[1] = two ? z_in[pr.k0 + 1] : 0.0f;
    } else {
      const float2 rz = box_muller(
          philox(make_uint4((uint32_t)(pr.k0 / 2), (uint32_t)draw, (uint32_t)c, 2u), key));
      z[0] = rz.x;
      z[1] = rz.y;
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (e == 0 || two) {
        const float v = fmaf(nu, z[e], r.inv * fmaf(r.ce, g2[e], r.s * u2[e]));
        uc[e ? pr.m1 : pr.m0] = v;
        vv += (double)v * v;
        vg += (double)v * g2[e];
      }
    }
  }
  vv = block_sum(vv);
  vg = block_sum(vg);
  if (threadIdx.x == 0) {
    pv[((long long)c * gridDim.x + blockIdx.x) * 2] = vv;
    pv[((long long)c * gridDim.x + blockIdx.x) * 2 + 1] = vg;
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
// num_samples >= 1; normals (S, C, D) may be null; fwd_grid and bwd_grid are
// the GEMMs' blocks, from the plan (kernels/bnn_grad.py::_plan).  N and I
// are free (D below 2^31).  stats and phases as bnn_hmc_run's.  Launches on
// the stream without synchronising and returns the first launch error as a
// cudaError_t (0 on success).
int bnn_mclmc_run(const float* x, const float* y, const float* w1, const float* b1,
                  const float* w2, const float* b2, const float* u_in, float* w1_out,
                  float* b1_out, float* w2_out, float* b2_out, float* var_e_out,
                  void* workspace, int n, int in_dim, int hidden, int chains, int num_samples,
                  float step_size, float nu, float tau, unsigned long long seed,
                  const float* normals, int fwd_grid, int bwd_grid, void* stream_ptr,
                  long long* stats, long long* phases) {
  const HostStatsScope accounted(stats);
  if (hidden % HC != 0 || n < 1 || in_dim < 1 || chains < 1 || chains > 65535 ||
      (long long)in_dim * hidden + 2LL * hidden + 1 >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const Layout L = make_layout(n, in_dim, hidden, chains);
  BnnDims S = L.s;
  if (!set_grids(S, fwd_grid, bwd_grid)) return (int)cudaErrorInvalidValue;
  char* ws = (char*)workspace;
  float* th = (float*)(ws + L.th);
  float* u = (float*)(ws + L.u);
  float* g = (float*)(ws + L.g);
  const GradScratch scratch = grad_scratch(ws, L.grad_ws);
  GradMaps maps;
  double* dots = (double*)(ws + L.dots);
  double* pv = (double*)(ws + L.pv);
  double* logp_cur = (double*)(ws + L.logp_cur);
  double* logp_prop = (double*)(ws + L.logp_prop);
  double* dk = (double*)(ws + L.dk);
  double* sum_de2 = (double*)(ws + L.sum_de2);
  int* draw_ctr = (int*)(ws + L.draw_ctr);
  const uint2 key = seed_key(seed);
  const dim3 ew_grid(S.ew_blocks, chains);
  const float half = 0.5f * step_size;
  const double dims = (double)S.d;
  int err;

  auto gradient = [&](cudaStream_t st) -> int {
    return launch_gradient_dots(S, maps, y, th, g, u, scratch, logp_prop, dots, tau, st, phases);
  };
  // V(coef) then X(eps/2)
  auto rotate_drift = [&](cudaStream_t st, int src, double coef, int* ctr) -> int {
    return launch_ex(rotate_drift_kernel, ew_grid, EW, 0, st, g, u, th, dots, pv, dk, src, dims,
                     S.dp, coef, half, ctr);
  };
  // one draw; with ctr (the graph) the draw is counted in and its index read from *ctr
  auto one_draw = [&](cudaStream_t st, int src, int* ctr) -> int {
    if ((err = rotate_drift(st, src, B1 * step_size, ctr)) != 0) return err;
    if ((err = gradient(st)) != 0) return err;
    if ((err = rotate_drift(st, kUnit, (1.0 - 2.0 * B1) * step_size, nullptr)) != 0) return err;
    if ((err = gradient(st)) != 0) return err;
    return launch_ex(rotate_refresh_kernel, ew_grid, EW, 0, st, g, u, dots, pv, dk, logp_cur,
                     logp_prop, sum_de2, S, B1 * step_size, nu, (const int*)ctr, key, normals);
  };

  if ((err = prepare_gradient_maps(S, th, scratch, &maps, phases != nullptr)) != 0) return err;
  // zeros everywhere first: the padding slots of the packed state stay zero
  if ((err = queued([&] { return cudaMemsetAsync(ws, 0, L.bytes, stream); })) != 0) return err;
  LAUNCH(pack_kernel<<<ew_grid, EW, 0, stream>>>(w1, b1, w2, b2, th, nullptr, S));
  LAUNCH(pack_flat_kernel<<<ew_grid, EW, 0, stream>>>(u_in, u, S));
  if ((err = stage_x(S, x, scratch, stream)) != 0) return err;
  // gradient, logp and the dots of the given u at the initial point
  if ((err = gradient(stream)) != 0) return err;
  if ((err = queued([&] {
         return cudaMemcpyAsync(logp_cur, logp_prop, sizeof(double) * chains,
                                cudaMemcpyDeviceToDevice, stream);
       })) != 0)
    return err;

  // the first draw, then every later one as a replay of one captured graph
  if ((err = one_draw(stream, kGiven, nullptr)) != 0) return err;
  if (num_samples > 1) {
    cudaStream_t cs;
    cudaGraph_t graph = nullptr;
    cudaGraphExec_t exec = nullptr;
    long long captured[kHostStats] = {};  // the graph's kernels, each queued per replay
    if ((err = (int)cudaStreamCreateWithFlags(&cs, cudaStreamNonBlocking)) != 0) return err;
    err = (int)cudaStreamBeginCapture(cs, cudaStreamCaptureModeThreadLocal);
    if (err == 0) {
      const CaptureStats capture(captured);
      err = one_draw(cs, kRefreshed, draw_ctr);
      const int end = (int)cudaStreamEndCapture(cs, &graph);
      if (err == 0) err = end;
    }
    if (err == 0) err = (int)cudaGraphInstantiate(&exec, graph, 0);
    for (int draw = 1; err == 0 && draw < num_samples; ++draw)
      err = queued([&] { return cudaGraphLaunch(exec, stream); }, captured[kLaunches]);
    if (exec) cudaGraphExecDestroy(exec);  // freed once its launches are done
    if (graph) cudaGraphDestroy(graph);
    cudaStreamDestroy(cs);
    if (err != 0) return err;
  }

  LAUNCH(unpack_kernel<<<ew_grid, EW, 0, stream>>>(
      th, sum_de2, (double)num_samples * (double)S.d, w1_out, b1_out, w2_out, b2_out, var_e_out,
      S));
  return 0;
}

}  // extern "C"

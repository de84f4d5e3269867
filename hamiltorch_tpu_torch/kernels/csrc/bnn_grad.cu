// One gradient evaluation of the one-hidden-layer tanh regression BNN for
// every chain, written by hand for Hopper (sm_90a): the GEMM pair of
// bnn_grad.cuh (forward W1^T x^T and backward da^T x as persistent,
// warp-specialised wgmma tiles in 3xTF32) and its per-chain reduction,
// alone, behind a plain C interface.
//
// It is not a sampler and replaces no TPU kernel: it is the gradient that
// bnn_hmc.cu and bnn_mclmc.cu evaluate at every step (the Pallas kernels'
// grads_and_logp, hamiltorch_tpu/kernels/bnn_hmc.py:61 and bnn_mclmc.py:79),
// exposed so that tests can hold it against the plain PyTorch gradient at
// any shape and so that the GEMM pair can be timed against cuBLAS.  What
// bounds it and what the design does: see bnn_grad.cuh.

#include "bnn_grad.cuh"

namespace {

struct Layout {
  BnnDims s;
  GradOffsets grad_ws;
  size_t th, g, logp, bytes;
};

Layout make_layout(int n, int in_dim, int hidden, int chains) {
  Layout L;
  L.s = make_dims(n, in_dim, hidden, chains);
  Arena a;
  const size_t C = chains;
  L.th = a.take(C * L.s.dp, 4);
  L.g = a.take(C * L.s.dp, 4);
  L.grad_ws = take_grad_scratch(a, L.s);
  L.logp = a.take(C, 8);
  L.bytes = a.off;
  return L;
}

}  // namespace

extern "C" {

// Bytes of device workspace bnn_grad_run needs for these shapes.
size_t bnn_grad_workspace_bytes(int n, int in_dim, int hidden, int chains) {
  return make_layout(n, in_dim, hidden, chains).bytes;
}

const char* bnn_grad_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// The gradient of logp (grad_out, (C, D) in the flat layout w1 row-major,
// b1, w2, b2) and logp in float64 (logp_out, (C,)) at theta (C, D, the same
// layout) for every chain.  The gradient is evaluated `repeats` times at the
// same theta (each evaluation gives the same result; more than one serves
// timing).  fwd_grid and bwd_grid are the GEMMs' blocks, from the plan
// (kernels/bnn_grad.py::_plan).  All pointers are device pointers (stream
// is a cudaStream_t); hidden must be a multiple of 128, chains at most
// 65535 and repeats at least 1.  Launches on the stream without
// synchronising and returns the first launch error as a cudaError_t (0 on
// success).
int bnn_grad_run(const float* x, const float* y, const float* theta, float* grad_out,
                 double* logp_out, void* workspace, int n, int in_dim, int hidden, int chains,
                 int repeats, float tau, int fwd_grid, int bwd_grid, void* stream_ptr) {
  if (hidden % HC != 0 || n < 1 || in_dim < 1 || chains < 1 || chains > 65535 || repeats < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const Layout L = make_layout(n, in_dim, hidden, chains);
  BnnDims S = L.s;
  if (!set_grids(S, fwd_grid, bwd_grid)) return (int)cudaErrorInvalidValue;
  char* ws = (char*)workspace;
  float* th = (float*)(ws + L.th);
  float* g = (float*)(ws + L.g);
  double* logp = (double*)(ws + L.logp);
  const GradScratch scratch = grad_scratch(ws, L.grad_ws);
  GradMaps maps;
  const dim3 ew_grid(S.ew_blocks, chains);
  int err;

  if ((err = (int)cudaMemsetAsync(ws, 0, L.bytes, stream)) != 0) return err;
  LAUNCH(pack_flat_kernel<<<ew_grid, EW, 0, stream>>>(theta, th, S));
  if ((err = prepare_gradient(S, x, th, scratch, &maps, stream)) != 0) return err;
  for (int r = 0; r < repeats; ++r)
    if ((err = launch_gradient(S, maps, y, th, g, nullptr, scratch, logp, nullptr, tau, 0.f, 0.f,
                               0, stream)) != 0)
      return err;
  LAUNCH(unpack_flat_kernel<<<ew_grid, EW, 0, stream>>>(g, grad_out, S));
  if ((err = (int)cudaMemcpyAsync(logp_out, logp, sizeof(double) * chains,
                                  cudaMemcpyDeviceToDevice, stream)) != 0)
    return err;
  return 0;
}

}  // extern "C"

// The package's csrc/bnn_mclmc.cu on the former gradient
// (bnn_grad_former.cuh, the design of commit 1efd31b), for
// scripts/bnn_gemm_variants_torch.py to time beside the package.  No part
// of the package.
#include "bnn_grad_former.cuh"
#include "../../hamiltorch_tpu_torch/kernels/csrc/bnn_mclmc.cu"

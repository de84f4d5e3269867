// Designs of gaussian_hmc that were tried or replaced, for
// scripts/gaussian_hmc_variants_torch.py to time beside the package's
// kernel: instantiations of the package's kernel templates that its plan
// never chooses.  No part of the package.
//   - a thread per chain (1 lane of 4 elements), with the noise ring or with
//     Philox, Box-Muller and log inline (diagonal P, D <= 4);
//   - the former design, a warp per chain with the noise inline: 32 lanes of
//     one element (diagonal P, D <= 32) and 32 lanes of 4 elements with P
//     multiplied by float32 FMAs from shared memory (dense P, D <= 128).

#include "../../hamiltorch_tpu_torch/kernels/csrc/gaussian_hmc.cuh"

extern "C" {

// As gaussian_hmc_run of the package (Philox noise only), with the design
// given: `group` lanes per chain of `epl` elements; blocks of `warps` warps
// of which the first `consumers` run `cpw` chains each and the others, if
// any, fill the noise ring; `shared` bytes (the ring: 2 x 16 draws x the
// block's chains x (8 + 4 D); a dense P: 4 D^2 + 4 D per warp).
int gaussian_hmc_variant_run(const float* theta0, const float* prec, float* out, float* acc,
                             int chains, int d, int dense, int num_samples, int num_steps,
                             float step_size, unsigned long long seed, int group, int epl,
                             int warps, int consumers, int cpw, int shared, void* stream_ptr) {
  const int invalid = (int)cudaErrorInvalidValue;
  if (d < 1 || chains < 1 || group * epl < d || shared < 0 || shared > MAX_SHARED) return invalid;
  const Args a = {theta0, prec, nullptr, out, acc, chains, d, num_samples, num_steps, step_size,
                  seed_key(seed), nullptr, nullptr};
  cudaStream_t s = (cudaStream_t)stream_ptr;
  const bool ring = consumers < warps;
  if (group == 1 && epl == 4 && !dense)
    return ring ? launch_chain<1, 4, false, true>(a, warps, consumers, cpw, shared, s)
                : launch_chain<1, 4, false, false>(a, warps, consumers, cpw, shared, s);
  if (group == 32 && epl == 1 && !dense && !ring)
    return launch_chain<32, 1, false, false>(a, warps, consumers, cpw, shared, s);
  if (group == 32 && epl == 4 && dense && !ring)
    return launch_chain<32, 4, true, false>(a, warps, consumers, cpw, shared, s);
  return invalid;
}

}  // extern "C"

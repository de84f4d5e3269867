// Fused multi-chain HMC on a Gaussian N(mean, P^-1) with identity mass,
// written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel hamiltorch_tpu/kernels/gaussian_hmc.py::
// gaussian_hmc (its body _kernel, lines 55-107).  Same sampler: per draw
// standard-normal momenta, a half kick, L drift+kick steps, half a kick
// pulled back, and the Metropolis test (h0 - h1) >= log u, with the gradient
//     g = -(theta - mean) * P         (P diagonal, elementwise), or
//     g = -(theta - mean) @ P         (P dense, one matvec),
// the potential -1/2 sum (theta - mean) g and the kinetic energy 1/2 |p|^2.
// It writes every draw (C, N, D) and each chain's acceptance rate.  The
// momenta and the uniform come from Philox + Box-Muller keyed on the logical
// (element, draw, chain) (or are given), so the draws do not depend on which
// variant below runs or on its block shape.  Unlike the TPU kernel it
// computes over the real D only (no lane padding).
//
// What bounds it.  Dense P: per leapfrog step the chains' matvecs are one
// (C, D) x (D, D) product, 2 C D^2 flops (1024 chains x 200 draws x 10 steps
// at D=128 is 67 GFLOP, ~1.0 ms at the 67 TFLOP/s float32 FMA peak of an H100
// SXM at 700 W); a warp that does its own chain's matvec from shared memory
// issues more loads than FMAs and runs at the shared-memory rate.  Small D:
// neither flops nor bytes (the draws written out) bound it; each chain's
// draws x L steps are one chain of dependent operations, so the time is the
// latency of one draw times the draws, whatever the number of chains the
// card can hold at once.
//
// What the design does about it.  The chain state stays in registers for the
// whole run; only the draws go to device memory.  The gradient at the current
// state rides along between draws, so a draw costs L gradients.  Per draw the
// energy difference h0 - h1 is one float64 sum over the chain's elements of
// 1/2 (p^2 - (theta - mean) g) before less after, reduced once in a fixed
// order, so a run is deterministic.  One Philox draw gives the normals of
// four neighbouring elements (both outputs of two Box-Muller transforms).
// Five variants (templates of gaussian_hmc.cuh), chosen by the wrapper's
// plan from D (kernels/gaussian_hmc.py::_plan); only what the plan can choose
// is instantiated here:
//   1. D <= 8: 2, 4 or 8 lanes per chain, one element each, as in 2.  (One
//      thread per chain with the whole state in its registers needs no
//      shuffle at all but measured slower at 1024 and at 65,536 chains: every
//      float32 -> float64 conversion of the energy then issues on one thread,
//      at the conversion unit's quarter rate; commit 715bb33 replaced it.)
//   2. 8 < D <= 32: 16 or 32 lanes per chain, one element each, reductions
//      and the dense matvec by shuffles within the lane group.
//      In 1 and 2 the noise is taken off the chain of dependent operations:
//      producer warps of the block fill a two-buffer shared-memory ring with
//      the normals and the float64 log-uniforms of the next RING_DRAWS draws
//      (Philox, Box-Muller and log, or the given numbers) while the consumer
//      warp runs the leapfrog of the current ones; one block barrier per
//      RING_DRAWS draws.  Few chains are spread thinly (a consumer warp may
//      hold fewer chains than it has room for) so that every SM works.
//   3. One warp per chain (lane l holds elements l + 32 j), float32 FMA: any
//      diagonal P with D > 32, and dense P beyond the tensor-core variant's
//      range (P and one row per warp for theta - mean in shared memory).
//   4. Dense P, 32 < D <= 128: blocks of 16 chains on the tensor cores.  A
//      step of the block is a (16, D) x (D, D) product done with
//      mma.sync.m16n8k8 in 3xTF32 by 4 or 8 consumer warps that split the
//      output columns (16-row tiles, not wgmma's 64: 1024 chains are 64 such
//      blocks but only 16 wgmma tiles).  P is split once into tf32 big and
//      small parts in mma fragment order; each thread keeps the big
//      fragments of its columns in registers for the whole run and reads the
//      small ones from shared memory.  Each step every thread splits its own
//      elements of theta - mean (integer arithmetic: cvt.rna.tf32 issues at
//      a fraction of the ALU's rate and bound the first version) and stores
//      them in fragment order into a double-buffered shared tile, so that
//      after one barrier (each warp's output columns are every warp's K)
//      every lane reads its A fragments 16 bytes at a time.  big*big,
//      big*small and small*big each have their own accumulator.  The state
//      lives in the accumulator's register layout, so kick and drift are
//      elementwise.  Two producer warps fill the next draw's momenta and
//      log-uniforms into shared memory meanwhile.  Beyond D=128 the split P
//      (8 Dp^2 bytes, Dp = D rounded up to 32), the tiles and the noise no
//      longer fit a block's 232,448 bytes together.
//   5. Any other D (diagonal D > 256, dense D > 240; `_variant=5` forces it
//      at any D), three forms:
//      - Dense P, at any D the card's memory holds: one persistent
//        cooperative grid for the whole run (dense_grid_kernel).
//        What bounds it: a step is one (C, D) x (D, D) product, 2 C D^2
//        flops (at D = 1024 and 1024 chains x 100 draws x L=10 that is 2.1
//        TFLOP, 13.0 ms in 3xTF32 at the 495 TFLOP/s tf32 peak, ~18 ms at
//        the rate mma.sync.m16n8k8 sustains), and the bytes its tiles read
//        from L2: P^T's 128-row tiles each C / BN times and Delta's each
//        D / 128 times (modelled from the shapes: 100 MB a step at that
//        shape, where the former blocks of 8 chains read all of P 128
//        times: 512 MiB), plus the
//        state each epilogue reads and writes.  At few chains P alone is
//        the traffic, read once a step across the whole grid (the former
//        design read it once a block).  The design: the chains are the N of
//        a tensor-core product (P^T's rows the M), tiles of 128 rows x 8-64
//        chains walked by one block of 8 warps each on every SM, a grid
//        barrier after each step's product, the operands in float32 split
//        into tf32 parts as they are read (half the bytes of split copies;
//        P^T, or P^T and Delta, held split instead ran no faster),
//        64-row partials added in order.
//      - Diagonal P, D <= 4096: the state of a chain in the registers of a
//        team of 32-256 threads (diag_kernel).  What bounds it: issue, four
//        dependent float32 operations an element and step with the noise
//        and the float64 energies beside them, and the draws written out
//        (0.1265 ms at D = 1024, 1024 chains x 100 draws); the former
//        design kept 8 chains' state in one block's shared memory, so an SM
//        ran 8 warps and each step made three passes over shared memory.
//      - Diagonal P, 4096 < D <= 12,288: a chain a block of 1024 threads
//        (diag_kernel), 2 or 3 groups of 4 elements a thread, the state in
//        registers and the mean and P, the same for every chain, in shared
//        memory: 256 threads' registers no longer hold them all.  The
//        former design's shared-memory form (1-8 chains a block, up to D =
//        11,612) was replaced in commit 1bb3e2d.

#include "gaussian_hmc.cuh"

namespace {

// variants 1 and 2: G lanes per chain, one element each, with the noise ring
template <int G>
int launch_ring(const Args& a, bool dense, int warps, int consumers, int cpw, size_t shared,
                cudaStream_t stream) {
  return dense ? launch_chain<G, 1, true, true>(a, warps, consumers, cpw, shared, stream)
               : launch_chain<G, 1, false, true>(a, warps, consumers, cpw, shared, stream);
}

}  // namespace

extern "C" {

const char* gaussian_hmc_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Bytes of device scratch that gaussian_hmc_run needs for this plan (0:
// none; only variant 5 with dense P takes any, `group` chains a tile).
size_t gaussian_hmc_scratch_bytes(int chains, int d, int dense, int variant, int group) {
  if (variant != 5 || !dense || chains < 1 || d < 1 || group < 8) return 0;
  return dense_scratch(nullptr, nullptr, chains, d, group);
}

// Run num_samples HMC draws of num_steps leapfrog steps on every chain.
// theta0 (C, D); prec (D,) with dense == 0 or (D, D) with dense == 1; mean
// (D,) or null for zero; out (C, S, D); acc (C,).  momenta (S, C, D) and
// uniforms (S, C) may be null.  The caller checks num_samples, num_steps >= 1
// and plans the launch (kernels/gaussian_hmc.py::_plan, which alone holds
// the choice of variant and the shared-memory formulas):
//   variant 1 (D <= 8; `group` 2, 4 or 8 >= D) and 2 (8 < D <= 32; `group` 16
//     or 32 >= D): blocks of 4 (variant 1) or 8 warps, of which the first
//     `consumers` run `cpw` <= 32 / group chains each and the others produce
//     their noise; `shared` holds the ring and, after it, a dense P;
//   variant 3 (D > 32; diagonal P, or dense P with D > 128): `consumers`
//     <= 8 warps a block, one chain each; `shared` holds a dense P and one
//     row of D per warp;
//   variant 4 (dense P, 32 < D <= 128): 4 or 8 consumer warps by D rounded
//     up to 32 (64: 8, 96: 4, 128: 8) and 2 producer warps; `shared` holds
//     the layout above MmaShape;
//   variant 5 (any D), `consumers` = 8 warps a block unless said otherwise:
//     dense: `group` = 8, 16, 32 or 64 chains a tile, `cpw` 0, `shared` the
//       stages and the energy reduction of dense_grid_kernel, `scratch` of
//       gaussian_hmc_scratch_bytes;
//     diagonal, D <= 4096: `group` = 1, 2, 4 or 8 chains a block, `cpw` =
//       1, 2 or 4 groups of 4 elements a thread, `shared` 0;
//     diagonal, 4096 < D <= 12,288: `consumers` = 32 warps, `group` = 1
//       chain a block, `cpw` = 2 or 3 groups of 4 elements a thread,
//       `shared` = diag_wide_shared(cpw).
// Returns cudaErrorInvalidValue for any other plan (variant 0: the wrapper
// found none, which is how a D beyond the any-D variant's range and a
// chain_tile below 1 are refused).  stats (host, kHostStats long longs) may
// be null; else the run's launch accounting is written to it.  phases
// (device, DENSE_PHASES long longs) may be null; else variant 5 with dense P
// adds its phases' cycles into it (the other variants ignore it).  Launches
// on the stream without synchronising and returns the first launch error as
// a cudaError_t (0 on success).
int gaussian_hmc_run(const float* theta0, const float* prec, const float* mean, float* out,
                     float* acc, int chains, int d, int dense, int num_samples, int num_steps,
                     float step_size, unsigned long long seed, int variant, int group,
                     int consumers, int cpw, int shared, const float* momenta,
                     const float* uniforms, void* scratch, void* stream_ptr, long long* stats,
                     long long* phases) {
  const HostStatsScope accounted(stats);
  const int invalid = (int)cudaErrorInvalidValue;
  if (d < 1 || (variant < 5 && d > MAX_D) || chains < 1 || (variant < 3 && group < d))
    return invalid;
  if (shared < 0 || shared > MAX_SHARED) return invalid;
  const Args a = {theta0, prec, mean, out, acc, chains, d, num_samples, num_steps, step_size,
                  seed_key(seed), momenta, uniforms};
  cudaStream_t s = (cudaStream_t)stream_ptr;
  if (variant == 1 && d <= 8) {
    switch (group) {
      case 2: return launch_ring<2>(a, dense, 4, consumers, cpw, shared, s);
      case 4: return launch_ring<4>(a, dense, 4, consumers, cpw, shared, s);
      case 8: return launch_ring<8>(a, dense, 4, consumers, cpw, shared, s);
    }
  } else if (variant == 2 && d > 8 && d <= 32) {
    switch (group) {
      case 16: return launch_ring<16>(a, dense, 8, consumers, cpw, shared, s);
      case 32: return launch_ring<32>(a, dense, 8, consumers, cpw, shared, s);
    }
  } else if (variant == 3 && d > 32 && cpw == 1) {
    if (dense)
      return d > 128 ? launch_chain<32, 8, true, false>(a, consumers, consumers, 1, shared, s)
                     : invalid;
    if (d <= 64) return launch_chain<32, 2, false, false>(a, consumers, consumers, 1, shared, s);
    if (d <= 128) return launch_chain<32, 4, false, false>(a, consumers, consumers, 1, shared, s);
    return launch_chain<32, 8, false, false>(a, consumers, consumers, 1, shared, s);
  } else if (variant == 4 && dense && d > 32 && d <= 128) {
    if (d <= 64) return consumers == 8 ? launch_mma<1, 8, 2>(a, shared, s) : invalid;
    if (d <= 96) return consumers == 4 ? launch_mma<3, 4, 2>(a, shared, s) : invalid;
    return consumers == 8 ? launch_mma<2, 8, 2>(a, shared, s) : invalid;
  } else if (variant == 5 && consumers == 8 && dense && cpw == 0) {
    switch (group) {
      case 8: return launch_dense<1, 1, 1>(a, scratch, shared, s, phases);
      case 16: return launch_dense<1, 2, 1>(a, scratch, shared, s, phases);
      case 32: return launch_dense<1, 4, 1>(a, scratch, shared, s, phases);
      case 64: return launch_dense<2, 4, 2>(a, scratch, shared, s, phases);
    }
  } else if (variant == 5 && consumers == 8 && !dense && d <= DIAG_MAX_D && shared == 0) {
    switch (cpw) {
      case 1: return launch_diag<1, DIAG_THREADS>(a, group, s);
      case 2: return launch_diag<2, DIAG_THREADS>(a, group, s);
      case 4: return launch_diag<4, DIAG_THREADS>(a, group, s);
    }
  } else if (variant == 5 && consumers == DIAG_WIDE_THREADS / 32 && !dense && group == 1 &&
             d <= DIAG_WIDE_MAX_D && (cpw == 2 || cpw == 3) &&
             (size_t)shared == diag_wide_shared(cpw)) {
    return cpw == 2 ? launch_diag<2, DIAG_WIDE_THREADS>(a, 1, s)
                    : launch_diag<3, DIAG_WIDE_THREADS>(a, 1, s);
  }
  return invalid;
}

}  // extern "C"

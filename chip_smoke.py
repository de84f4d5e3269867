#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (hamiltorch_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card (Hopper:
the kernels are built for sm_90a).  It

1. prints the card (``nvidia-smi`` name and power limit, and torch's name);
2. builds every CUDA kernel of the port from the sources in the checkout
   (one ``nvcc`` per source, all started together) and prints the time,
   each kernel's registers and shared memory (``-Xptxas -v``), and the
   count of ``HGMMA`` instructions (the SASS of ``wgmma``) in the
   ``bnn_hmc`` and ``bnn_mclmc`` libraries (``cuobjdump -sass``); it fails
   if either has none;
3. holds each kernel against its plain PyTorch version on the same inputs
   and the same injected noise, and fails above the stated tolerance, on
   any differing accept decision, or where the gradient's part of the move
   is too small beside the tolerance for the comparison to see a wrong
   gradient: one BNN gradient alone (``kernels/bnn_grad._bnn_gradient``,
   the GEMM pair of both BNN kernels) at the flagship and two ragged
   shapes, ``bnn_hmc`` and ``bnn_mclmc`` at the flagship and at a small
   ragged shape, ``bnn_mclmc`` also from a velocity anti-parallel to the
   gradient at the step where its first rotation's zeta is 0.04 (the
   rotation's w = ce g + 2 zeta u nearly cancels there, and the kernel takes
   |w| from dots reduced where g is produced),
   ``gaussian_hmc`` once per variant of its kernel: 4 lanes
   per chain (D=3 diagonal, also at a ragged chain count), 32 lanes (D=20
   diagonal and dense), a warp per chain (D=200 diagonal), the tensor
   cores (dense D=128 and D=64) and dense P beyond their range (D=192),
   the any-D variant (diagonal D=257, 300, 512, 1000, 4096 with the state
   in the registers of up to 256 threads a chain, 4099 of 1024; dense
   D=241, 256, 512, 513, 1000, 2048, 4096, 4099 on the tensor cores across
   one grid, at chain counts that give tiles of 8, 16, 32 and 64 chains,
   the last one partial), and at
   every shape its main path launches (D=2 dense and
   diagonal at 256 chains, D=3 at 16 chains, dense D=64 at 256 chains,
   diagonal D=1000 at 64 chains, dense D=512 at 64 chains); and the any-D
   variant forced on shapes
   that a warp per chain runs (diagonal D=200, dense D=192) must give the
   same draws and accepts, the noise being a function of (element, draw,
   chain) alone;
4. times each kernel and its plain version (CUDA events, median of 3, in
   turns), the GEMM pair of one flagship gradient beside cuBLAS's pair
   (``torch.matmul``) on the same shapes, that gradient's forward, backward
   and per-chain kernels (device time a launch, ``torch.profiler``), and
   the cuBLAS GEMMs of the
   products each kernel computes in its body, and computes each kernel's
   bound: the larger of its FLOPs at the float32 FMA peak and its bytes at
   the memory rate, and for the BNN kernels, whose products run on the
   tensor cores in 3xTF32, also three times their FLOPs at the dense tf32
   peak (``bound_3xtf32_ms``); for ``gaussian_hmc`` also its latency bound:
   a chain's draws x the 7 dependent operations a draw needs at least (the
   L leapfrog steps of a Gaussian are one linear map) at the card's
   dependent-FMA latency (a probe kernel, ``scripts/csrc/gpu_probes.cu``,
   measures it) over the SM clock ``nvidia-smi --query-gpu=clocks.max.sm``
   reports, beside the chains of a step-by-step leapfrog (2 L + 6) and of
   this kernel (4 L + 6), and beside the dense shape's tensor-core bound the
   time its ``mma.sync`` instructions take at the rate a second probe kernel
   measures; the any-D variant at diagonal and dense D=1024 (1024 chains x
   100 draws x L=10) beside cuBLAS's (C, D) x (D, D) matvec of every step,
   the dense one beside its 3xTF32 bound, the time of its ``mma.sync`` at
   the probed rate and a model (from the shapes, not a measurement) of the
   bytes a step moves through L2.  A kernel
   whose products run on the tensor cores in 3xTF32 (the BNN kernels,
   ``gaussian_hmc`` at dense P) takes the 3xTF32 time of its operations as
   its ``bound_ms`` where that is below the float32 FMA time
   (``bound_ops_peak`` names the peak taken); for ``bnn_mclmc`` also its
   CUDA launches a draw (counted by the recorder, ``utils/profiling.py``)
   and a model, from the shapes and not measured, of the bytes its velocity
   algebra moves a draw;
5. drives the main paths, each with the launch counts set to 0 just before
   it and read just after, and fails if its kernel was not launched:
   - HMC: the fused flagship sampler ``kernels.bnn_hmc`` and
     ``run_hmc_chains`` on the flagship BNN (64 chains, 10 draws x 50
     steps, step 2e-4), plus ``sample()`` on the 3-D Gaussian;
   - MCLMC: ``run_mclmc_chains`` tunes 64 flagship chains (1000 steps, as
     ``bench.py`` does), frozen chunks resume with ``resume_from`` (timed),
     and ``kernels.bnn_mclmc`` runs from the tuned state and velocity at the
     median tuned (eps, L); its mean var_e must lie within 2x of the
     mean(dE^2)/d of a frozen chunk resumed at that same (eps, L) on the
     potential in float64 (at that step dE is below the float32 rounding
     of the flagship's logp);
   - Gaussian: ``kernels.gaussian_hmc`` recovers the moments of the 3-D
     diagonal (4000 draws), 2-D dense and shifted-mean Gaussians of
     ``tests/test_kernels.py`` (256 chains x 600 draws, L=6, eps=0.2), the
     covariance of a dense 64-D one (the tensor-core variant), the stds
     of a diagonal 1000-D one and the marginal variances of a dense 512-D
     one, each within 5 of its own standard errors (the any-D variant), the
     same seed gives the
     same trace, and chains differ; ``diagnostics.summary`` of the 3-D
     draws on the card equals the CPU's (float64) within 1e-4 relative,
     with R-hat < 1.01;
   - MAMS: ``run_mams_chains`` on the flagship tree (64 chains, mclachlan,
     10 steps a draw, burn 50, 100 draws): post-burn acceptance within
     0.15 of the target 0.9, no chain divergent on every draw;
   - windowed mass warmup: ``run_hmc_chains`` with ``adapt_mass="diag"`` on
     the flagship tree (64 chains, L=10, burn 300: three slow windows, 50
     draws after), a finite, positive metric; with ``adapt_mass="dense"``
     on a correlated 64-D Gaussian (64 chains, burn 1000) at three seeds,
     the chains' mean adapted inverse mass within 0.1 of the true
     covariance entrywise;
   then the paths without a kernel of their own, each printing the kernels'
   launch counts (0): the ``bnn_model`` phase (the flagship as an
   ``nn.Module`` through ``sample_model`` / ``predict_model``), the
   ``cnn_lstm`` phase (``cnn_lstm_path``: the IMDB CNN-LSTM's blocked
   potential gradient at the published widths, float32 against float64 on
   the card, the whole potential refused, one gradient of 25,000 reviews
   timed with its peak memory), the ``nuts``
   phase (``nuts_path``: ``run_nuts_chains`` on the flagship in float64,
   card against CPU on the same injected noise, identical trees and
   positions within 1e-8 of max |theta|; 16 float32 chains with step-size
   adaptation, timed in used and computed grad-steps/s, ms a leaf, the
   sync's share, peak memory, gated on finite draws, no chain divergent on
   every post-burn draw and a post-burn accept_prob in [0.5, 1]; the 2-D
   correlated Gaussian's moments; ``run_nuts_ensemble``'s pooled dense
   metric on the 64-D Gaussian within 0.1; ``store_on_GPU=False`` equal to
   the on-card trace) and the ``checkpoint`` phase (``checkpoint_path``:
   ``run_hmc_chains_checkpointed`` on the flagship at 64 chains, and the
   NUTS, NUTS-ensemble, MCLMC and MAMS runners on a small Gaussian, each
   stopped part-way and resumed, bit for bit their straight runs), the
   ``rmhmc`` phase (``rmhmc_path``: ``bench.py``'s batch-scale RMHMC, a D=64
   quartic Gaussian at 64 chains x L=5, SOFTABS, IMPLICIT, timed in
   grad-steps/s with its fixed-point iteration counts, ms a fixed-point
   iteration and peak memory; BASELINE config 3's banana with the implicit
   and explicit integrators against the gates of ``tests/test_rmhmc.py``;
   float64 card against CPU on injected noise for the IMPLICIT, EXPLICIT,
   MIDPOINT and S3 integrators and the HESSIAN and JACOBIAN_DIAG metrics,
   identical accepts and fixed-point counts, positions within 1e-8 of max
   |theta|; the softabs backward at repeated eigenvalues against a central
   difference; a non-SPD metric rejected; ``sample(store_on_GPU=False)``
   identical) and the ``split`` phase (``split_path``: BASELINE config 5,
   a 784-256-10 tanh ``nn.Sequential`` on 6,000 MNIST-shaped rows in 6
   splits, the terms' sum and gradient against ``define_model_log_prob`` on
   all rows within 1e-5, timed in draws/s and term-gradients/s;
   SPLITTING_RAND and SPLITTING_KMID on the regression BNN of
   ``examples/split_hmc_bnn_example.py`` in float64, card against CPU; the
   offloaded and checkpointed runners identical to the straight run), the
   ``chees`` phase (``chees_path``: ``bench.py``'s ChEES configuration on
   the flagship at 64 chains, step 2e-4, T0 0.01, diagonal warmup, a
   warmup chunk thinned to one row and a sampling chunk resumed from its
   carry, cut to 150 + 20 draws, timed in grad-steps/s with the per-draw
   sync's share, the final eps and T, the post-burn acceptance and
   ``chees_min_ess_per_sec``, gated on finite draws, L within its cap and a
   finite positive eps and T; the correlated 2-D Gaussian of
   ``tests/test_chees.py``, its moments and acceptance gate; float64 card
   against CPU on injected noise, identical leapfrog counts and accepts,
   positions within 1e-8 of max |theta|; ``run_chees_checkpointed`` stopped
   and resumed, bit for bit) and the ``sgmcmc`` phase (``sgmcmc_path``:
   SGLD, pSGLD, SGHMC and cSGLD on BASELINE config 5 at one chain and
   ``run_sgld_chains`` at 8, timed in steps/s and term-gradients/s, gated on
   finite draws and no rejected step; the noisy-gradient Gaussian of
   ``tests/test_sgmcmc.py`` at its tolerance; SGLD and SGHMC on the
   regression BNN of ``examples/sgld_bnn_example.py`` in float64, card
   against CPU, identical terms, positions within 1e-8; checkpointed SGLD
   and SGHMC identical to their straight runs), the ``tempering`` phase
   (``tempering_path``: ``run_pt_chains`` on the flagship, 8 ladders of 8
   replicas = the main path's 64 chains, L=10, step 2e-4, max_temp 30, ladder
   and step-size adaptation, 60 draws with burn 40, timed in grad-steps/s,
   gated on finite results, pinned and monotone ladders; the bimodal mixture
   and the 2-D cross-ensemble R-hat of ``tests/test_tempering.py`` at their
   gates; float64 card against CPU on injected noise, identical accepts and
   swaps, positions within 1e-8 at an acceptance target of 0.95 and 1e-5
   at the default 0.8, beside the drift of a reversed summation order on
   the CPU alone; ``run_pt_checkpointed`` on the flagship,
   one ladder and ensembles, identical) and the ``evidence`` phase
   (``evidence_path``: TI on both models of
   ``examples/model_comparison_example.py`` within 1.25 of the analytic log
   Z (the estimator's spread over seeds there: ``EXAMPLE_TOL``), ``waic`` /
   ``psis_loo`` of the beta=1 rung, the median of 4 SMC runs on the
   quadratic model within 0.2 of it and 1.25 of TI, the quadratic model
   winning; ``tests/test_ti.py:309-325``'s regression through
   ``define_model_prior_and_lik``, TI within 0.15 and SMC within 0.2 of the
   analytic log Z; TI and SMC
   on a 784-128-1 ``nn.Sequential`` at the flagship's data shapes, timed,
   gated on finite evidence, acceptance in [0, 1] and ESS fractions in (0,
   1]; float64 card against CPU; ``run_ti_checkpointed`` identical), the
   ``gradient_free`` phase (``gradient_free_path``: ``run_barker_chains``
   on the flagship at 64 chains with step-size adaptation over a burn,
   timed in grad-steps/s with its peak memory, gated on finite states and
   acceptance in (0, 1]; ``run_elliptical_chains`` on a 784-128-1
   ``nn.Sequential`` through ``define_model_prior_and_lik`` at 64 chains,
   timed in likelihood evaluations/s with its mean shrinks and cap hits,
   gated on a finite log-likelihood and shrinks within the cap; the stretch
   move on a D=64 Gaussian at 256 walkers, timed in log-density
   evaluations/s; the statistical gates of ``tests/test_barker.py:38,59``,
   ``tests/test_stretch.py:29,43``, the staircase of
   ``examples/gradient_free_example.py`` and ``tests/test_elliptical.py:24``;
   float64 card against CPU on injected noise for the three samplers,
   identical accepts and shrink counts, positions within 1e-10 of max
   |theta|; ``run_barker_checkpointed`` and ``run_stretch_checkpointed``
   stopped and resumed, identical) and the ``optim`` phase (``optim_path``:
   ``map_estimate`` and mean-field ``advi`` on the flagship, timed in
   steps/s; ``laplace_approx``'s evidence on ``tests/test_ti.py:309-325``'s
   regression within 1e-3 of the exact log Z; full-rank ``advi`` within
   0.15 of a correlated D=6 Gaussian's covariance; ADVI's stds as Barker's
   ``scale=``, ``examples/barker_robustness_example.py``'s third part);
   the ``svgd`` phase (``svgd_path``: ``run_svgd`` on the flagship at the
   JAX default's 100 particles, 30 steps, timed in steps/s with its peak
   memory and gated on no rejected step; ``examples/svgd_example.py``'s
   correlated Gaussian, 200 particles x 500 steps, at
   ``tests/test_svgd.py``'s tolerances; float64 card against CPU from the
   same cloud, within 1e-5 of max |x| since the update runs in float32)
   and the ``parallel`` phase (``parallel_path``: a one-rank NCCL mesh,
   failing unless the backend is ``nccl`` and the trace on ``cuda``;
   ``run_hmc_chains_sharded`` at the main path's 64 chains x 10 x 50,
   step 2e-4, bit for bit ``run_hmc_chains``, grad-steps/s of both;
   ``sample_chains_sharded`` with the flagship likelihood within 1e-6 of
   max |theta| of the full-batch run, both timed, and one batched
   evaluation with and without the all-reduce; ``run_chees_sharded`` at
   64 chains and ``run_svgd_sharded`` identical to their local runs);
   every phase of this list fails if it launched a fused kernel;
6. checks the tiny flagship on the card against the CPU;
7. prints one JSON line with every kernel's summary and, last, the device
   line.

There is no CPU path: without a CUDA device it exits non-zero and prints
no result.  TF32 is off for every float32 matmul (cuBLAS and cuDNN).

Two kernels of ResNet-20-FRN also run alone, each held against the formula
in float64 and timed beside its bound, its plain version and the library
path it replaced: ``python3 chip_smoke.py --frn-tlu`` (FRN with TLU) and
``python3 chip_smoke.py --conv3x3`` (the same-width 3x3 convolution,
direction by direction, beside cuDNN's float32 convolution).  The full run
includes both phases.  ``python3 chip_smoke.py --cnn-lstm`` runs the
``cnn_lstm`` phase alone.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# (name, route, source, the TPU kernel it replaces)
KERNELS = [
    ("bnn_hmc", "cuda", "hamiltorch_tpu_torch/kernels/csrc/bnn_hmc.cu",
     "hamiltorch_tpu/kernels/bnn_hmc.py:143"),
    ("bnn_mclmc", "cuda", "hamiltorch_tpu_torch/kernels/csrc/bnn_mclmc.cu",
     "hamiltorch_tpu/kernels/bnn_mclmc.py:168"),
    ("gaussian_hmc", "cuda", "hamiltorch_tpu_torch/kernels/csrc/gaussian_hmc.cu",
     "hamiltorch_tpu/kernels/gaussian_hmc.py:114"),
]
# Kernel vs plain: parameters after a few draws differ only by float32
# rounding of differently ordered sums (expected ~1e-7); 1e-5 leaves 100x.
ATOL = 1e-5
# MCLMC's var_e is a float64 sum of dE^2 on both sides; dE is a difference
# of float64 logp sums at states that differ by float32 rounding.
VAR_E_RTOL = 1e-3
# The comparison must see the gradient: the part of the move that the
# gradient makes must reach SIGNAL in every parameter block and in every
# 64-row tile of W1 (the backward kernel's I-tiles, the ragged last one
# included), so that a gradient wrong by more than ATOL / SIGNAL = 1% fails.
SIGNAL = 100 * ATOL
W1_ROW_TILE = 64
FLAGSHIP = dict(n=1024, i=784, h=128, c=64)
# the card's float32 FMA peak, dense tf32 tensor-core peak and memory rate
# (H100 SXM data sheet, 700 W)
PEAK_FLOPS = 67e12
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12
# one gradient alone against its plain version: float32 products summed over
# N or I terms in another order; relative to the largest gradient entry
GRAD_RTOL = 1e-5
LOGP_RTOL = 1e-6
MCLMC_TUNE_STEPS = 1000  # bench.py:446
MCLMC_CHUNK = 200  # frozen steps per chunk (every 10th kept)
# gaussian_hmc's any-D variant against its plain version: (seed, D, dense,
# chains, the plan's group: chains a tile of dense P, a block of diagonal P).
# Dense tiles of 8, 16, 32 and 64 chains, each with a partial last tile (and
# a partial last tile of 128 rows at D = 241, 513, 1000, 4099); diagonal P in
# registers, 1 or 2 chains a block of 256 threads, and beyond D = 4096 one
# chain a block of 1024 (4099).  Dense D = 4096 and the ragged 4099 stream P
# from device memory.
# Every seed leaves the closest Metropolis decision at least 1.7e-4 from the
# other outcome in the plain version on the CPU (float32 rounding moves it
# by ~1e-6).
WIDE_SHAPES = ((20, 257, False, 37, 2), (21, 512, False, 64, 2), (22, 1000, False, 16, 1),
               (23, 4096, False, 8, 1), (28, 4099, False, 5, 1), (29, 300, False, 201, 2),
               (30, 257, False, 270, 2), (42, 1000, False, 1061, 1),
               (24, 241, True, 37, 8), (25, 256, True, 16, 8), (26, 512, True, 16, 8),
               (27, 1000, True, 8, 8), (32, 4096, True, 5, 8), (33, 4099, True, 3, 8),
               (34, 2048, True, 201, 32), (35, 512, True, 270, 16), (44, 513, True, 530, 32),
               (47, 1000, True, 600, 64))
# the same draws whichever variant runs: diagonal and dense shapes of variant 3
FORCED_SHAPES = ((200, False), (192, True))
# The chains' mean adapted dense inverse mass against the true covariance of
# the 64-D Gaussian: a 500-draw last window per chain, shrunk by 500/505
# toward a small identity; the entries of the covariance reach 0.75
DENSE_WARMUP_ATOL = 0.1
DIAG_RTOL = 1e-4  # summary() on the card against the CPU, both float64
# the BNN layer on an nn.Module against the flagship potential at the same
# weights: logp within 1e-6 of the module's own float32 value (which holds
# the prior's constant, ~9.2e4, so its rounding is ~4e-3), the gradient
# within 1e-5 of its largest entry; the module's potential and predictions
# on the card against the CPU 1e-5; WAIC / PSIS-LOO (float64) card vs CPU 1e-6
MODEL_LOGP_RTOL = 1e-6
MODEL_CARD_RTOL = 1e-5
COMPARISON_RTOL = 1e-6
# RMHMC (bench.py:377-401): D=64, 64 chains, L=5; the draws of a timed run are
# cut from bench.py's 20 to 1 (a metric evaluation costs ~70 ms on the card,
# most of it the batched 64x64 eigh: PERF.md section 5).  The banana of
# BASELINE config 3 at 64 chains, its 150 draws cut to 4 + 6 (its gates are
# loose beside 384 pooled draws); card vs CPU in float64 at L=2 over 2 draws
# (the CPU computes the D=64 Hessians itself); sample()'s offload 4 draws.
# With 2 timed draws and 8 offloaded the phase took 69.7 s on a fast host,
# and 109.9 s at 4, 6 + 18, 3 and 8 draws (PERF.md section 5).
RMHMC_DIM, RMHMC_CHAINS, RMHMC_STEPS, RMHMC_DRAWS = 64, 64, 5, 1
BANANA_BURN, BANANA_DRAWS = 4, 6
RMHMC_CPU_STEPS, RMHMC_CPU_DRAWS = 2, 2
# split HMC (BASELINE config 5): the example's 100 draws cut to 10 a timed
# run; the sum of the 6 terms against the full-data potential: float32 sums
# over 1,000 and 6,000 rows in another order
SPLIT_DRAWS = 10
SPLIT_RTOL = 1e-5
# ChEES (bench.py:244-340): the flagship at 64 chains, step 2e-4, T0 0.01,
# diagonal windowed warmup, a warmup chunk thinned to one row and a
# sampling chunk resumed from its carry.  bench's 600 + 300 draws are cut to
# 150 (the shortest burn with a slow window: [75, 100)) + 20: a draw at the
# initial L ~ 50 costs ~0.15 s at the unfused path's ~20,000 grad-steps/s.
CHEES_WARMUP, CHEES_SAMPLING = 150, 20
CHEES_CHAINS = 64
# SG-MCMC on BASELINE config 5 (one chain, and 8 chains for the batched
# runner): steps a timed run; the Gaussian recovery of
# tests/test_sgmcmc.py::test_noisy_gradients_still_target_posterior at its
# length (8000 steps) and tolerance (pooled means within 0.15) on 32 chains
# where the test has 8: at 8 the means' standard error (~0.065 for the
# std-1.41 coordinate) puts the 0.15 gate near 2.3 sigma
SG_STEPS = 60
SG_CHAINS = 8
SG_RECOVERY_STEPS, SG_RECOVERY_CHAINS = 8000, 32
# Parallel tempering on the flagship: the main path's 64 chains as 8 ladders
# of 8 replicas, 60 draws with burn 40.  The bimodal mixture of
# tests/test_tempering.py:12-37 is cut from 4000 draws to 1500 (the same
# first 500 skipped, 1000 kept) and the cross-ensemble R-hat of :272-285
# from 1200 draws (burn 200) to 600 (burn 100): a leapfrog step of these
# tiny targets costs ~1 ms of host time, and both gates still see many mode
# switches.
PT_ENSEMBLES, PT_TEMPS, PT_DRAWS, PT_BURN = 8, 8, 60, 40
PT_BIMODAL_DRAWS = 1500
PT_RHAT_DRAWS, PT_RHAT_BURN = 600, 100
# The evidence phase.  TI on examples/model_comparison_example.py's
# configuration (12 rungs, L=8, step 0.3) runs 350 draws (burn 90) where
# the example runs 2000 (burn 500): a draw is 9 vmapped evaluations of host
# time, ~16 ms, and more draws shrink the spread little.  Over 24 seeds on
# the card at 500 draws (``python3 chip_smoke.py --evidence-spread
# ti_quadratic``) the stepping-stone estimate spreads with a standard
# deviation of 0.33 nats (linear model 0.21), with tails to 1.08, and over
# 16 seeds at 350 (``--evidence-spread ti_quadratic --draws 350 90``) 0.31
# (tail 0.57) and 0.22 (tail 0.41): its bridge from the prior is
# heavy-tailed at this ladder, so a gate of 0.15 on one run would fail
# often; each model is held within EXAMPLE_TOL of the analytic log Z, and
# SMC within EXAMPLE_TOL of TI where the example reads ~0.5.  The strict
# gates run on tests/test_ti.py:309-325's regression at its own settings:
# TI within 0.15 (spread 0.066 over 24 seeds, tail 0.17) and SMC within 0.2
# (0.070, tail 0.12).  The example's SMC starts at step 0.05 where the
# example starts at 0.3 (from 0.3 the adaptation needs most of the 20
# stages to reach the posterior's scale) and the gate holds the median of
# SMC_RUNS runs, as the pooled test of tests/test_smc.py does: 0.2 against
# medians that spread 0.055, tail 0.087.  The full-width module: TI 16
# rungs x 30 draws (burn 20).  The example's 350 draws were cut from 500
# (burn 125) to pay for the svgd and parallel phases.  The regression's
# 1800 draws stay: over 16 seeds at 1200 (``--evidence-spread ti_linreg
# --draws 1200 400``) its TI spread 0.11, tail 0.19, past its own 0.15
# gate (on an NVIDIA H100 80GB HBM3 at 700 W).
EVIDENCE_DRAWS, EVIDENCE_BURN = 350, 90
EXAMPLE_TOL = 1.25
LINREG_TI_DRAWS, LINREG_TI_BURN = 1800, 600
SMC_STEP, SMC_RUNS = 0.05, 4
WIDE_TI_DRAWS, WIDE_TI_BURN = 30, 20
# The gradient_free phase.  Barker on the flagship at the main path's 64
# chains, step-size adaptation over BARKER_BURN of BARKER_DRAWS draws (one
# gradient a draw); elliptical slice on the 784-128-1 module at 64 chains,
# ESS_WIDE_DRAWS draws (its shrink loop runs to the cap where the likelihood
# is sharp).  The statistical gates of tests/test_barker.py:38,59 at 32
# chains where the test has 8 and 2500 draws (burn 1000) where it has
# 4000-6000; tests/test_stretch.py:29,43 and the staircase of
# examples/gradient_free_example.py at 2000 / 1500 iterations where they run
# 3000-4000; tests/test_elliptical.py:24 at 16 chains x 1000 draws where it
# has 4 x 3000.  Stretch at D=64 is timed with K=256 walkers.
BARKER_CHAINS, BARKER_DRAWS, BARKER_BURN = 64, 300, 150
ESS_WIDE_DRAWS = 20
GATE_DRAWS, GATE_BURN = 2500, 1000
STRETCH_GATE_ITERS, STRETCH_AFFINE_ITERS = 2000, 1500
ESS_GATE_CHAINS, ESS_GATE_DRAWS = 16, 1000
STRETCH_DIM, STRETCH_WALKERS, STRETCH_ITERS = 64, 256, 200
# The optim phase: Adam on the flagship (MAP_STEPS steps; mean-field ADVI
# ADVI_WIDE_STEPS steps at 4 Monte Carlo draws), full-rank ADVI on a D=6
# Gaussian (tests/test_optim.py:228's 4000 steps at D=2, its 0.15 gate)
MAP_STEPS, ADVI_WIDE_STEPS, FULLRANK_STEPS = 200, 100, 3000
# The svgd phase: SVGD_STEPS steps of the JAX default's 100 particles on the
# flagship; examples/svgd_example.py's correlated Gaussian at its own 200
# particles, step 0.2 and 500 steps (0.5 s on the card), held to
# tests/test_svgd.py:28's gates; float64 card against CPU within
# SVGD_CARD_TOL of max |x|.  The update runs in float32 whatever the
# particles' dtype (as the JAX package's), so the card's and the CPU's
# float32 products differ in their last bits and AdaGrad's division grows
# the difference: 7.49e-07 after 20 steps on the H100, so the float32 class
# of ATOL, not the float64 paths' 1e-8.
SVGD_PARTICLES, SVGD_STEPS, SVGD_GAUSS_STEPS = 100, 30, 500
SVGD_CARD_TOL = ATOL
# The parallel phase: the sharded runs beside the local ones, PARALLEL_DRAWS
# draws (SVGD steps) each but the main path's HMC (10 x 50)
PARALLEL_DRAWS = 4
PARALLEL_HMC = (10, 50, 2e-4)  # the main path's draws, steps a draw and step size
# FRN with TLU (kernels/frn_tlu.py; no TPU kernel: the JAX package has no
# FRN) at the planes of the resnet20_frn cell's blocks of 10,000 rows:
# (rows, channels, side) of its three stages.  Kernel against the formula
# in float64 on the same float32 inputs: float32 sums of up to 1,024
# squares and products a plane, and of 10,000 planes a channel (in float64),
# relative to the largest entry of each output.
FRN_SHAPES = ((10_000, 16, 32), (10_000, 32, 16), (10_000, 64, 8))
FRN_RTOL = 1e-5
FRN_REPS = 10  # calls a timed run
# The same-width 3x3 convolution (kernels/conv3x3.py; no TPU kernel: the JAX
# package leaves convolutions to XLA) at the resnet20_frn cell's blocks of
# 10,000 rows, (rows, channels, side) of its three stages, and at a ragged
# batch of each.  Kernels against the formula in float64 (cuDNN in float64)
# on the same float32 inputs, relative to the largest entry of each output:
# 3xTF32 products (each operand's tf32 part and remainder, the remainder
# read to tf32 precision and the small-by-small term dropped: ~2^-21 of a
# product) summed in float32 over 9 C taps and channels (forward, input
# gradient) or up to 10,000 x 1,024 / 264 pixels a partial (weight
# gradient), the partials in float64.  cuDNN's own float32 error is printed
# beside.
CONV_SHAPES = ((10_000, 16, 32), (10_000, 32, 16), (10_000, 64, 8))
CONV_RAGGED = ((37, 16, 32), (29, 32, 16), (41, 64, 8))
CONV_RTOL = 2e-5
CONV_REPS = 5  # calls a timed run
# The IMDB CNN-LSTM (models/cnn_lstm.py; no kernel of its own: cuDNN's
# convolution and fused LSTM, which runs in training mode with dropout 0
# inside the potential) at its published widths: the blocked potential's
# gradient on CNN_LSTM_ROWS reviews of seeded ids (a quarter of them padded
# at the front) in float32 against the same module in float64 on the card,
# each parameter leaf's largest gap relative to its largest entry: cuDNN's
# float32 sums of 480,000 products an entry of the convolution's weight
# gradient (5,000 reviews x 96 positions) read 6.8e-4 on the H100, the
# embedding's 1.5e-4, every other leaf under 1e-5; so 5e-3 a leaf, where a
# wrong gate, offset or layout reads O(1); then one gradient of the
# benchmark cell's 25,000 reviews in one block, timed.
CNN_LSTM_ROWS = 5_000
CNN_LSTM_RTOL = 5e-3
CNN_LSTM_CELL_ROWS = 25_000


class SmokeError(RuntimeError):
    pass


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def bnn_inputs(torch, n, i, h, c, seed, device):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(n, i, generator=gen)
    y = torch.tanh(x @ (torch.randn(i, generator=gen) / i**0.5))[:, None]
    w1 = 0.01 * torch.randn(c, i, h, generator=gen)
    b1 = torch.zeros(c, h)
    w2 = 0.01 * torch.randn(c, h, generator=gen)
    b2 = torch.zeros(c)
    return [t.to(device).contiguous() for t in (x, y, w1, b1, w2, b2)]


def flat(torch, parts):
    """(C, D) from per-chain (w1, b1, w2, b2)."""
    return torch.cat([t.reshape(t.shape[0], -1) for t in parts], dim=1)


def block_min(move, i_dim, h):
    """Smallest max |move| over W1's 64-row tiles and b1, w2, b2 ((K, D) flat)."""
    s0, s1 = i_dim * h, i_dim * h + h
    w1_part = move[:, :s0].reshape(-1, i_dim, h)
    blocks = [w1_part[:, r:r + W1_ROW_TILE] for r in range(0, i_dim, W1_ROW_TILE)]
    blocks += [move[:, s0:s1], move[:, s1:s1 + h], move[:, s1 + h:]]
    return min(float(b.abs().max()) for b in blocks)


def hmc_gradient_signal(torch, args, want, momenta, steps, eps):
    """The gradient's part of bnn_hmc's move, on chains that accepted every
    draw: their drift-only position is theta0 + eps * L * sum(momenta)."""
    _, i_dim, h = args[2].shape
    full = want[4] == 1.0
    if not bool(full.any()):
        raise SmokeError("no chain accepted every draw: the gradient check sees nothing")
    move = flat(torch, want[:4]) - flat(torch, args[2:]) - eps * steps * momenta.sum(dim=0)
    return block_min(move[full], i_dim, h)


def check_close(name, err, signal):
    if not err <= ATOL:
        raise SmokeError(f"{name} disagrees with its plain version: {err:.3e} > {ATOL}")
    if not signal >= SIGNAL:
        raise SmokeError(f"{name}: the gradient moves the result by {signal:.3e} < {SIGNAL}; "
                         "the comparison could not see a wrong gradient")


def max_err(a, b):
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def compare_bnn_hmc(torch, shape, draws, steps, eps, seed, device):
    """Max abs error of kernel vs plain on injected noise; accepts must match,
    and the move the gradient makes must be large beside the tolerance."""
    from hamiltorch_tpu_torch.kernels.bnn_hmc import bnn_hmc, bnn_hmc_reference

    args = bnn_inputs(torch, shape["n"], shape["i"], shape["h"], shape["c"], seed, device)
    dim = shape["i"] * shape["h"] + 2 * shape["h"] + 1
    gen = torch.Generator().manual_seed(seed + 1)
    noise = (torch.randn(draws, shape["c"], dim, generator=gen).to(device),
             torch.rand(draws, shape["c"], generator=gen).to(device))
    kw = dict(num_samples=draws, num_steps=steps, step_size=eps, tau=10.0, _noise=noise)
    got = bnn_hmc(seed, *args, **kw)
    want = bnn_hmc_reference(seed, *args, **kw)
    torch.cuda.synchronize()
    for t in got:
        if not bool(torch.all(torch.isfinite(t))):
            raise SmokeError("bnn_hmc returned non-finite values")
    if not torch.equal(got[4], want[4]):
        raise SmokeError(f"accept rates differ: kernel {got[4].tolist()} plain {want[4].tolist()}")
    err = max_err(got[:4], want[:4])
    scale = max(float(b.abs().max()) for b in want[:4])
    signal = hmc_gradient_signal(torch, args, want, noise[0], steps, eps)
    print(f"bnn_hmc vs plain {shape} {draws}x{steps} eps={eps}: max_abs_err={err:.3e} "
          f"max_rel_err={err / scale:.3e} acc_mean={float(want[4].mean()):.4f} "
          f"min_gradient_move={signal:.3e}")
    check_close("bnn_hmc", err, signal)
    return err, float(want[4].mean())


def compare_bnn_mclmc(torch, shape, draws, eps, length, seed, device, anti_parallel=False):
    """Kernel vs plain on injected refresh normals: parameters within ATOL,
    var_e within VAR_E_RTOL; the gradient's part of the move (the result
    less the plain run at tau = 0) must be large beside ATOL.  With
    anti_parallel, u = -g/|g| and eps is the step at which every chain's
    first rotation has zeta = exp(-b1 eps |g| / (d - 1)) = 0.04 (there
    ce g nearly cancels 2 zeta u; the kernel takes |w| from the dots), L is
    5 eps, and the targets sit 10 above the network's output with w2 of
    O(1), so that |g| is large and the step stays near 1."""
    from hamiltorch_tpu_torch.kernels.bnn_grad import _bnn_gradient_reference
    from hamiltorch_tpu_torch.kernels.bnn_mclmc import _B1, bnn_mclmc, bnn_mclmc_reference

    args = bnn_inputs(torch, shape["n"], shape["i"], shape["h"], shape["c"], seed, device)
    dim = shape["i"] * shape["h"] + 2 * shape["h"] + 1
    gen = torch.Generator().manual_seed(seed + 1)
    u = torch.randn(shape["c"], dim, generator=gen).to(device)
    noise = torch.randn(draws, shape["c"], dim, generator=gen).to(device)
    if anti_parallel:
        args[1], args[4] = args[1] + 10.0, 100.0 * args[4]
        g, _ = _bnn_gradient_reference(args[0], args[1], flat(torch, args[2:]), tau=10.0)
        g_norm = g.double().norm(dim=1)
        u = (-g.double() / g_norm[:, None]).float()
        eps = float((-math.log(0.04) * (dim - 1) / (_B1 * g_norm)).max())
        length = 5.0 * eps
        zeta = float(torch.exp(-_B1 * eps * g_norm / (dim - 1)).max())
        print(f"bnn_mclmc anti-parallel start: first rotation's zeta <= {zeta:.4f} at eps={eps:.4f}")
        if not zeta <= 0.05:
            raise SmokeError(f"the anti-parallel start's zeta is {zeta}, not <= 0.05")
    kw = dict(num_samples=draws, step_size=eps, length=length, _noise=noise)
    got = bnn_mclmc(seed, *args, u, tau=10.0, **kw)
    want = bnn_mclmc_reference(seed, *args, u, tau=10.0, **kw)
    drift_only = bnn_mclmc_reference(seed, *args, u, tau=0.0, **kw)
    torch.cuda.synchronize()
    if not all(bool(torch.all(torch.isfinite(t))) for t in got):
        raise SmokeError("bnn_mclmc returned non-finite values")
    err = max_err(got[:4], want[:4])
    var_rel = float(((got[4] - want[4]) / want[4]).abs().max())
    signal = block_min(flat(torch, want[:4]) - flat(torch, drift_only[:4]), shape["i"], shape["h"])
    print(f"bnn_mclmc vs plain {shape} {draws} draws eps={eps} L={length}: max_abs_err={err:.3e} "
          f"var_e max_rel_err={var_rel:.3e} var_e median={float(want[4].median()):.4e} "
          f"min_gradient_move={signal:.3e}")
    check_close("bnn_mclmc", err, signal)
    if not var_rel <= VAR_E_RTOL:
        raise SmokeError(f"bnn_mclmc var_e disagrees with its plain version: {var_rel:.3e}")
    return err


def dense_precision(torch, d, seed):
    gen = torch.Generator().manual_seed(seed)
    a = torch.randn(d, d, generator=gen)
    return a @ a.T / d + torch.eye(d)


def compare_gaussian_hmc(torch, d, dense, chains, draws, steps, eps, seed, device):
    """Kernel vs plain on injected noise, draw for draw: identical accept
    counts, draws within ATOL, and a 1%-wrong precision must move the draws
    by at least SIGNAL."""
    from hamiltorch_tpu_torch.kernels.gaussian_hmc import gaussian_hmc, gaussian_hmc_reference

    gen = torch.Generator().manual_seed(seed)
    prec = dense_precision(torch, d, seed) if dense else 0.25 + 3.75 * torch.rand(d, generator=gen)
    theta0 = torch.randn(chains, d, generator=gen)
    mean = torch.randn(d, generator=gen)
    noise = (torch.randn(draws, chains, d, generator=gen).to(device),
             torch.rand(draws, chains, generator=gen).to(device))
    prec, theta0, mean = prec.to(device), theta0.to(device), mean.to(device)
    kw = dict(mean=mean, _noise=noise)
    got, got_acc = gaussian_hmc(seed, theta0, prec, draws, steps, eps, **kw)
    want, want_acc = gaussian_hmc_reference(seed, theta0, prec, draws, steps, eps, **kw)
    wrong, _ = gaussian_hmc_reference(seed, theta0, 1.01 * prec, draws, steps, eps, **kw)
    torch.cuda.synchronize()
    # accept counts must be identical (the rates may differ in the last bit:
    # PyTorch divides by a scalar on the card through its reciprocal)
    if not torch.equal(torch.round(got_acc * draws), torch.round(want_acc * draws)):
        raise SmokeError("gaussian_hmc accept counts differ from its plain version")
    err = float((got - want).abs().max())
    signal = float((wrong - want).abs().max())
    print(f"gaussian_hmc vs plain D={d} {'dense' if dense else 'diagonal'} {chains} chains "
          f"{draws}x{steps} eps={eps}: max_abs_err={err:.3e} acc_mean={float(want_acc.mean()):.4f} "
          f"move of a 1%-wrong precision={signal:.3e}")
    check_close("gaussian_hmc", err, signal)
    return err


def compare_forced_wide(torch, d, dense, device):
    """gaussian_hmc's any-D variant forced on a shape that a warp per chain
    runs, both on Philox: the draws are a function of (element, draw,
    chain) alone, so samples agree within ATOL and accepts are identical."""
    from hamiltorch_tpu_torch.kernels.gaussian_hmc import gaussian_hmc

    prec = (dense_precision(torch, d, 1) if dense else torch.linspace(0.25, 4.0, d)).to(device)
    theta0 = torch.randn(64, d, generator=torch.Generator().manual_seed(3)).to(device)
    wide, wide_acc = gaussian_hmc(5, theta0, prec, 30, 6, 0.2, _variant=5)
    warp, warp_acc = gaussian_hmc(5, theta0, prec, 30, 6, 0.2)
    torch.cuda.synchronize()
    err = float((wide - warp).abs().max())
    print(f"gaussian_hmc any-D variant forced at D={d} {'dense' if dense else 'diagonal'} "
          f"against a warp per chain (Philox): max_abs_err={err:.3e} "
          f"acc_mean={float(warp_acc.mean()):.4f}")
    if not (torch.equal(wide_acc, warp_acc) and err <= ATOL):
        raise SmokeError(f"gaussian_hmc variants draw differently at D={d}: {err:.3e}")
    return err


def cuda_ms(torch, fn) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def time_in_turns(torch, fns: dict) -> dict:
    """{name: (median ms, [3 runs])}: one warm-up each, then 3 runs each in
    turns (a b, b a, a b); each fn takes the run's seed."""
    for fn in fns.values():
        fn(0)
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    for rep in range(3):
        order = list(fns) if rep % 2 == 0 else list(fns)[::-1]
        for name in order:
            times[name].append(cuda_ms(torch, lambda: fns[name](rep + 1)))
    return {name: (statistics.median(t), t) for name, t in times.items()}


def ops_ms(flops, tf32_flops=0):
    """(least time of the operations, the peak it takes): flops at the
    float32 FMA peak, or, where it is less, the tf32_flops of them that the
    kernel runs on the tensor cores in 3xTF32 at that rate and the rest at
    the FMA peak."""
    fma = flops / PEAK_FLOPS * 1e3
    tc = (flops - tf32_flops) / PEAK_FLOPS * 1e3 + tf32_bound_ms(tf32_flops)
    return (tc, "tf32_3x") if tf32_flops and tc < fma else (fma, "fp32_fma")


def bound(flops, nbytes, latency_ms=0.0, tf32_flops=0):
    """(bound ms, what bounds it) at the card's peaks (operations: ops_ms);
    latency_ms is the least time of the longest chain of dependent
    operations, where that is known."""
    return max((ops_ms(flops, tf32_flops)[0], "operations"), (nbytes / PEAK_BYTES * 1e3, "bytes"),
               (latency_ms, "latency"))


def max_sm_clock_hz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


PROBES = REPO / "scripts" / "csrc" / "gpu_probes.cu"


def probe(torch, device, name, iters, sink_size, n_out):
    """Run a probe kernel of scripts/csrc/gpu_probes.cu; returns what it wrote."""
    import ctypes

    from hamiltorch_tpu_torch.kernels import _build

    fn = getattr(_build.load(PROBES), name)
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    sink = torch.empty(sink_size, dtype=torch.float32, device=device)
    out = torch.empty(n_out, dtype=torch.int64, device=device)
    err = fn(iters, sink.data_ptr(), out.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise SmokeError(f"{name} failed: cudaError_t {err}")
    return out.tolist()


def fma_latency_cycles(torch, device, iters):
    """(SM clock cycles per dependent float32 FMA, the SM clock in Hz during
    the probe): one thread, ``iters`` FMAs each waiting for the last, between
    two readings of the nanosecond timer."""
    cycles, ns = probe(torch, device, "probe_fma_latency", iters, 1, 2)
    return cycles / iters, cycles / ns * 1e9


def mma_cycles(torch, device, iters=1 << 16):
    """SM clock cycles per ``mma.sync.m16n8k8`` tf32 instruction and SM sub-core
    with the tensor-core variant's 8 warps issuing 6 independent ones a round:
    what that instruction sustains on this card."""
    (cycles,) = probe(torch, device, "probe_mma_rate", iters, 256, 1)
    return cycles / (iters * 6 * 2)  # 2 warps share a sub-core


def bnn_gemm_ms(torch, device):
    """(kernel, cuBLAS) time (ms) of the GEMM pair of one flagship gradient
    over 64 chains.  Kernel: ``_bnn_gradient`` (forward and backward GEMM
    with their epilogues and the per-chain reduction), (21 evaluations - 1)
    / 20 in one call each.  cuBLAS: one forward GEMM x W1 and one backward
    GEMM x^T da (the same products), 20 pairs.  Medians of 3, in turns."""
    from hamiltorch_tpu_torch.kernels.bnn_grad import _bnn_gradient

    x, y, w1, *rest = bnn_inputs(torch, **FLAGSHIP, seed=7, device=device)
    theta = flat(torch, (w1, *rest)).contiguous()
    da = torch.randn(FLAGSHIP["c"], FLAGSHIP["n"], FLAGSHIP["h"], device=device)
    xt = x.T

    def pairs(_seed):
        for _ in range(20):
            torch.matmul(x, w1)
            torch.matmul(xt, da)

    t = time_in_turns(torch, {"one": lambda s: _bnn_gradient(x, y, theta, repeats=1),
                              "many": lambda s: _bnn_gradient(x, y, theta, repeats=21),
                              "gemm": pairs})
    return (t["many"][0] - t["one"][0]) / 20, t["gemm"][0] / 20


def gradient_anatomy(torch, device, card):
    """Device us a launch of the flagship gradient's forward, backward and
    per-chain kernels (torch.profiler over 10 evaluations in one call)."""
    from torch.profiler import ProfilerActivity, profile

    from hamiltorch_tpu_torch.kernels.bnn_grad import _bnn_gradient

    x, y, *parts = bnn_inputs(torch, **FLAGSHIP, seed=7, device=device)
    theta = flat(torch, parts).contiguous()
    _bnn_gradient(x, y, theta)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _bnn_gradient(x, y, theta, repeats=10)
        torch.cuda.synchronize()
    us = {}
    for e in prof.key_averages():
        for kernel in ("forward_kernel", "backward_kernel", "small_kernel"):
            dev = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
            if kernel in e.key and e.count and dev:
                us[kernel] = dev / e.count
    if len(us) < 3:
        print(f"BNN gradient kernels: torch.profiler recorded no device time: not measured [{card}]")
        return
    print(f"BNN gradient (flagship, 64 chains), device time a launch: forward "
          f"{us['forward_kernel']:.1f} us, backward {us['backward_kernel']:.1f} us, per-chain "
          f"{us['small_kernel']:.1f} us (torch.profiler) [{card}]")


def compare_bnn_gradient(torch, shape, seed, device):
    """One gradient of every chain, kernel vs plain: max abs error over the
    largest gradient entry, and logp's relative error."""
    from hamiltorch_tpu_torch.kernels.bnn_grad import _bnn_gradient, _bnn_gradient_reference

    x, y, *parts = bnn_inputs(torch, shape["n"], shape["i"], shape["h"], shape["c"], seed, device)
    parts[1] = 0.1 * torch.randn(parts[1].shape, generator=torch.Generator().manual_seed(seed)).to(
        device)  # nonzero b1, so that a wrong bias column would show
    theta = flat(torch, parts).contiguous()
    g, logp = _bnn_gradient(x, y, theta, tau=10.0)
    want_g, want_logp = _bnn_gradient_reference(x, y, theta, tau=10.0)
    torch.cuda.synchronize()
    if not bool(torch.all(torch.isfinite(g))):
        raise SmokeError("_bnn_gradient returned non-finite values")
    err = float((g - want_g).abs().max()) / float(want_g.abs().max())
    lerr = float(((logp - want_logp) / want_logp).abs().max())
    print(f"one BNN gradient vs plain {shape}: max_abs_err / max|g| = {err:.3e}, "
          f"logp max_rel_err = {lerr:.3e}")
    if not (err <= GRAD_RTOL and lerr <= LOGP_RTOL):
        raise SmokeError(f"_bnn_gradient disagrees with its plain version: {err:.3e}, {lerr:.3e}")


def frn_tlu_inputs(torch, n, c, side, seed, device):
    """x, gamma, beta, tau and an upstream gradient dz, float32: scales near 1,
    thresholds near -0.5, so the TLU clamps about a third of the responses."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    return (randn(n, c, side, side), 1 + 0.1 * randn(1, c, 1, 1), 0.1 * randn(1, c, 1, 1),
            -0.5 + 0.1 * randn(1, c, 1, 1), randn(n, c, side, side))


def frn_tlu_phase(torch, device, card) -> dict:
    """FRN with TLU's kernel pair at the main path's planes (``FRN_SHAPES``):
    held against the formula in float64, then timed in turns (median of 3
    runs of ``FRN_REPS`` calls) beside the plain version (the formula
    forward, ``_backward_reference`` backward) and the eager module's path
    (the formula under autograd, as ``FilterResponseNorm`` ran before the
    kernels), and beside its bound: 5 elements moved an element (x read and
    z written forward; dz and x read and dx written backward) at the memory
    rate.  Returns the summary of the largest shape."""
    from hamiltorch_tpu_torch.kernels import frn_tlu as ft

    eps, out, worst = 1e-6, {}, 0.0
    for n, c, side in FRN_SHAPES:
        x, gamma, beta, tau, dz = frn_tlu_inputs(torch, n, c, side, 7, device)
        before = ft.frn_tlu.launches
        z = ft._forward_cuda(x, gamma, beta, tau, eps)
        got = (z, *ft._backward_cuda(dz, x, gamma, beta, tau, eps))
        torch.cuda.synchronize()
        if ft.frn_tlu.launches != before + 3:
            raise SmokeError(f"frn_tlu queued {ft.frn_tlu.launches - before} kernels, not 3")
        args64 = [t.double().requires_grad_(True) for t in (x, gamma, beta, tau)]
        want_z = ft.frn_tlu_reference(*args64, eps)
        # a response within float32's rounding of its threshold may fall on
        # either side of it in float32: no upstream gradient there
        with torch.no_grad():
            x64, g64, b64, t64 = args64
            r64 = torch.rsqrt(torch.mean(x64 * x64, dim=(2, 3), keepdim=True) + eps)
            gap = (g64 * x64 * r64 + b64 - t64).abs()
            del r64
        near = (gap < 1e-5) & (gap > 0)
        n_near = int(near.sum())
        if n_near:
            dz = dz.masked_fill(near, 0.0)
            got = (z, *ft._backward_cuda(dz, x, gamma, beta, tau, eps))
        want = (want_z.detach(), *torch.autograd.grad(want_z, args64, dz.double()))
        errs = [float((a.double() - b).abs().max() / b.abs().max()) for a, b in zip(got, want)]
        del args64, x64, g64, b64, t64, want_z, want, got, z, gap, near
        worst = max(worst, max(errs))
        print(f"frn_tlu {n}x{c}x{side}x{side} float32 against the formula in float64: z, dx, "
              f"dgamma, dbeta, dtau within {', '.join(f'{e:.2e}' for e in errs)} of their "
              f"largest entries ({n_near} responses within 1e-5 of tau left out of "
              f"the gradients)")
        if not max(errs) <= FRN_RTOL:
            raise SmokeError(f"frn_tlu disagrees with the formula at {n}x{c}x{side}: {errs}")

        def kernel(_seed, fwd=True, bwd=True):
            for _ in range(FRN_REPS):
                if fwd:
                    ft._forward_cuda(x, gamma, beta, tau, eps)
                if bwd:
                    ft._backward_cuda(dz, x, gamma, beta, tau, eps)

        def plain(_seed):
            for _ in range(FRN_REPS):
                ft.frn_tlu_reference(x, gamma, beta, tau, eps)
                ft._backward_reference(dz, x, gamma, beta, tau, eps)

        leaves = [t.detach().requires_grad_(True) for t in (x, gamma, beta, tau)]

        def eager(_seed):
            for _ in range(FRN_REPS):
                torch.autograd.grad(ft.frn_tlu_reference(*leaves, eps), leaves, dz)

        t = time_in_turns(torch, {"kernel": kernel, "forward": lambda s: kernel(s, bwd=False),
                                  "backward": lambda s: kernel(s, fwd=False), "plain": plain,
                                  "eager": eager})
        ms = {name: v[0] / FRN_REPS for name, v in t.items()}
        nbytes = 5 * x.numel() * x.element_size()
        bound_ms = nbytes / PEAK_BYTES * 1e3
        print(f"frn_tlu {n}x{c}x{side}x{side}: kernel pair {ms['kernel']:.4f} ms (forward "
              f"{ms['forward']:.4f}, backward with the sum over images {ms['backward']:.4f}), "
              f"plain {ms['plain']:.4f} ms, eager module {ms['eager']:.4f} ms; bound "
              f"{bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB at {PEAK_BYTES / 1e12:.2f} TB/s), "
              f"{100 * bound_ms / ms['kernel']:.1f}% of it [{card}]")
        out = {"shape": [n, c, side, side], "ms": ms["kernel"], "forward_ms": ms["forward"],
               "backward_ms": ms["backward"], "plain_ms": ms["plain"], "library_ms": ms["eager"],
               "bound_ms": bound_ms, "bound_by": "bytes"}
        del x, gamma, beta, tau, dz, leaves
    out["max_rel_err"] = worst
    return out


def conv3x3_inputs(torch, n, c, side, seed, device):
    """x, a He-normal weight, a bias and an upstream gradient dy, float32."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    return (randn(n, c, side, side), (2.0 / (9 * c)) ** 0.5 * randn(c, c, 3, 3), 0.1 * randn(c),
            randn(n, c, side, side))


def conv3x3_library(torch, x, w, b, dy):
    """{direction: fn}: cuDNN's forward, input and weight-and-bias gradients
    of the same convolution (aten.convolution, aten.convolution_backward)."""
    args = ([1, 1], [1, 1], [1, 1], False, [0, 0], 1)
    bwd = torch.ops.aten.convolution_backward
    return {"forward": lambda: torch.ops.aten.convolution(x, w, b, *args),
            "input_grad": lambda: bwd(dy, x, w, [w.shape[0]], *args, [True, False, False])[0],
            "weight_grad": lambda: bwd(dy, x, w, [w.shape[0]], *args, [False, True, True])[1:]}


def conv3x3_phase(torch, device, card) -> dict:
    """The conv3x3 kernels at the main path's shapes (``CONV_SHAPES``) and
    ragged batches (``CONV_RAGGED``): held against the formula in float64,
    twice the same bits, then timed in turns (median of 3 runs of
    ``CONV_REPS`` calls) direction by direction beside the plain version
    (``conv3x3_reference`` and ``_backward_reference``), cuDNN's float32
    convolution with TF32 off (``library_ms``: cudnn.benchmark off, as the
    model ran it, and on) and the bound: 2 * 9 C^2 S^2 operations an image
    and direction at the 3xTF32 rate, or 2 C S^2 floats an image and
    direction at the memory rate.  Returns the summary of every shape."""
    from hamiltorch_tpu_torch.kernels import conv3x3 as cv
    from hamiltorch_tpu_torch.utils.precision import full_float32

    out, worst, failed = [], 0.0, []
    for n, c, side in CONV_RAGGED + CONV_SHAPES:
        x, w, b, dy = conv3x3_inputs(torch, n, c, side, 11, device)
        before = cv.conv3x3.launches
        got = (cv._forward_cuda(x, w, b), cv._dgrad_cuda(dy, w), *cv._wgrad_cuda(dy, x))
        again = (cv._forward_cuda(x, w, b), cv._dgrad_cuda(dy, w), *cv._wgrad_cuda(dy, x))
        torch.cuda.synchronize()
        if cv.conv3x3.launches != before + 8:
            raise SmokeError(f"conv3x3 queued {cv.conv3x3.launches - before} kernels, not 8")
        if not all(torch.equal(a, a2) for a, a2 in zip(got, again)):
            raise SmokeError(f"conv3x3 gave other bits on the same inputs at {n}x{c}x{side}")
        lib = conv3x3_library(torch, *(t.double() for t in (x, w, b, dy)))
        want = (lib["forward"](), lib["input_grad"](), *lib["weight_grad"]())
        with full_float32():
            ref32 = conv3x3_library(torch, x, w, b, dy)
            cudnn = (ref32["forward"](), ref32["input_grad"](), *ref32["weight_grad"]())

        def errs(outs):
            return [float((a.double() - v).abs().max() / v.abs().max()) for a, v in zip(outs, want)]

        e, e_lib = errs(got), errs(cudnn)
        del want, cudnn, again
        worst = max(worst, max(e))
        print(f"conv3x3 {n}x{c}x{side}x{side} float32 against float64: out, dx, dw, db within "
              f"{', '.join(f'{v:.2e}' for v in e)} of their largest entries (cuDNN float32, "
              f"TF32 off: {', '.join(f'{v:.2e}' for v in e_lib)})")
        if not max(e) <= CONV_RTOL:
            failed.append(f"{n}x{c}x{side}: {e}")
        if n < 1000:
            continue

        def reps(fn):
            return lambda _seed: [fn() for _ in range(CONV_REPS)]

        fns = {"forward": reps(lambda: cv._forward_cuda(x, w, b)),
               "input_grad": reps(lambda: cv._dgrad_cuda(dy, w)),
               "weight_grad": reps(lambda: cv._wgrad_cuda(dy, x)),
               "plain": reps(lambda: (cv.conv3x3_reference(x, w, b),
                                      cv._backward_reference(dy, x, w)))}
        for bench in (False, True):
            for name, fn in conv3x3_library(torch, x, w, b, dy).items():
                def run(_seed, fn=fn, bench=bench):
                    torch.backends.cudnn.benchmark = bench
                    with full_float32():
                        for _ in range(CONV_REPS):
                            fn()
                fns[f"cudnn{'_benchmark' if bench else ''}_{name}"] = run
        t = time_in_turns(torch, fns)
        torch.backends.cudnn.benchmark = False
        ms = {name: v[0] / CONV_REPS for name, v in t.items()}
        flops, nbytes = 2 * 9 * c * c * side * side * n, 2 * n * c * side * side * 4
        bound_ms, bound_by = bound(flops, nbytes, tf32_flops=flops)
        dirs = ("forward", "input_grad", "weight_grad")
        row = {"shape": [n, c, side, side], "ms": sum(ms[d] for d in dirs),
               **{f"{d}_ms": ms[d] for d in dirs}, "plain_ms": ms["plain"],
               "library_ms": sum(ms[f"cudnn_{d}"] for d in dirs),
               "library_benchmark_ms": sum(ms[f"cudnn_benchmark_{d}"] for d in dirs),
               **{f"library_{d}_ms": ms[f"cudnn_{d}"] for d in dirs},
               "bound_ms": 3 * bound_ms, "bound_by": bound_by, "max_rel_err": max(e)}
        print(f"conv3x3 {n}x{c}x{side}x{side}: forward {ms['forward']:.4f}, input gradient "
              f"{ms['input_grad']:.4f}, weight gradient {ms['weight_grad']:.4f} ms (all three "
              f"{row['ms']:.4f}); plain {ms['plain']:.4f} ms; cuDNN float32 "
              + ", ".join(f"{ms[f'cudnn_{d}']:.4f}" for d in dirs)
              + f" ({row['library_ms']:.4f}), cudnn.benchmark on "
              + ", ".join(f"{ms[f'cudnn_benchmark_{d}']:.4f}" for d in dirs)
              + f" ({row['library_benchmark_ms']:.4f}); bound {bound_ms:.4f} ms a direction "
              f"({bound_by}: {flops / 1e9:.1f} GFLOP at {PEAK_TF32 / 3e12:.0f} TFLOP/s, "
              f"{nbytes / 1e6:.1f} MB at {PEAK_BYTES / 1e12:.2f} TB/s), "
              f"{100 * row['bound_ms'] / row['ms']:.1f}% of it [{card}]")
        out.append(row)
        del x, w, b, dy, fns
    if failed:
        raise SmokeError(f"conv3x3 disagrees with the formula at {'; '.join(failed)}")
    return {"shapes": out, "max_rel_err": worst}


def cnn_lstm_path(torch, device, card):
    """The IMDB CNN-LSTM's potential gradient through ``define_model_log_prob``
    with ``block_rows`` at the published widths: float32 against float64 on
    the card (``CNN_LSTM_RTOL``), then timed at the benchmark cell's size
    with its peak memory; the whole potential (no ``block_rows``) is refused
    on the card."""
    import copy

    from hamiltorch_tpu_torch.models import cnn_lstm_imdb
    from hamiltorch_tpu_torch.models.bnn import define_model_log_prob

    torch.manual_seed(43)
    net = cnn_lstm_imdb()
    gen = torch.Generator(device=device).manual_seed(43)
    theta = torch.cat([torch.randn(p.numel(), generator=gen, device=device)
                       * (math.sqrt(2.0 / p[0].numel() + 0.01) if p.dim() >= 2 else 0.1)
                       for p in net.parameters()])

    def data(n):
        ids = torch.randint(3, 20_000, (n, 100), generator=gen, device=device)
        ids[: n // 4, :60] = 0
        ids[: n // 4, 60] = 1
        return ids, torch.randint(0, 2, (n,), generator=gen, device=device)

    def gradient(module, x, y, rows):
        lp, _, _ = define_model_log_prob(module, "multi_class_linear_output", x, y, tau_list=5.0,
                                         device=device, block_rows=rows)
        return torch.func.grad_and_value(lp)

    x, y = data(CNN_LSTM_ROWS)
    vg32 = gradient(net, x, y, CNN_LSTM_ROWS)
    vg64 = gradient(copy.deepcopy(net).double(), x, y, CNN_LSTM_ROWS)
    (g32, v32), (g64, v64) = vg32(theta), vg64(theta.double())
    sizes = [p.numel() for p in net.parameters()]
    errs = {name: float((a.double() - b).abs().max() / b.abs().max()) for name, a, b in zip(
        [n for n, _ in net.named_parameters()], g32.split(sizes), g64.split(sizes))}
    verr = abs(float(v32) - float(v64)) / abs(float(v64))
    print(f"cnn_lstm gradient at {CNN_LSTM_ROWS} reviews, float32 against float64 on the card, "
          f"each leaf's largest gap over its largest entry: "
          + ", ".join(f"{n} {e:.3e}" for n, e in errs.items()) + f"; value {verr:.3e} relative")
    if not (max(errs.values()) <= CNN_LSTM_RTOL and verr <= 1e-6):
        raise SmokeError(f"cnn_lstm gradient differs from float64: {errs}, value {verr:.3e}")
    try:
        define_model_log_prob(net, "multi_class_linear_output", x, y, device=device)
    except ValueError as e:
        print(f"cnn_lstm whole potential refused on the card: {e}")
    else:
        raise SmokeError("the whole potential of a recurrent module was not refused on the card")
    del vg32, vg64, g64
    x, y = data(CNN_LSTM_CELL_ROWS)
    vg = gradient(net, x, y, CNN_LSTM_CELL_ROWS)
    vg(theta)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = statistics.median(cuda_ms(torch, lambda: vg(theta)) for _ in range(3))
    print(f"cnn_lstm gradient of {CNN_LSTM_CELL_ROWS} reviews x 100 tokens in one block: "
          f"{ms:.2f} ms (median of 3), peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
          f"[{card}]")


def cnn_lstm_only() -> int:
    """``python3 chip_smoke.py --cnn-lstm``: the card and ``cnn_lstm_path`` alone."""
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs only on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    cnn_lstm_path(torch, torch.device("cuda:0"), card)
    return 0


def conv3x3_only() -> int:
    """``python3 chip_smoke.py --conv3x3``: the card, the build of
    ``csrc/conv3x3.cu`` and ``conv3x3_phase`` alone."""
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs only on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from hamiltorch_tpu_torch.kernels import _build

    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    for line in _build.build_all(["conv3x3"]).get("conv3x3", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  [conv3x3] {line.strip()}")
    print(f"build: {time.perf_counter() - t0:.1f} s")
    summary = conv3x3_phase(torch, torch.device("cuda:0"), card)
    print(json.dumps({"conv3x3": summary}))
    return 0


def frn_tlu_only() -> int:
    """``python3 chip_smoke.py --frn-tlu``: the card, the build of
    ``csrc/frn_tlu.cu`` and ``frn_tlu_phase`` alone."""
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs only on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from hamiltorch_tpu_torch.kernels import _build

    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    for line in _build.build_all(["frn_tlu"]).get("frn_tlu", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  [frn_tlu] {line.strip()}")
    print(f"build: {time.perf_counter() - t0:.1f} s")
    summary = frn_tlu_phase(torch, torch.device("cuda:0"), card)
    print(json.dumps({"frn_tlu": summary}))
    return 0


def tensor_core_check():
    """Count HGMMA (wgmma) instructions in the BNN libraries."""
    from hamiltorch_tpu_torch.kernels import _build

    tool = shutil.which("cuobjdump") or str(
        Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump")
    counts = {}
    for name in ("bnn_hmc", "bnn_mclmc", "bnn_grad"):
        sass = subprocess.run([tool, "-sass", str(_build.library_path(name))], capture_output=True,
                              text=True, timeout=120, check=True).stdout
        counts[name] = sum("HGMMA" in line for line in sass.splitlines())
    print(f"tensor cores: HGMMA instructions per library {counts}")
    if not (counts["bnn_hmc"] > 0 and counts["bnn_mclmc"] > 0):
        raise SmokeError(f"no wgmma in the BNN kernels' SASS: {counts}")


def bnn_bytes(shape, extra_per_chain=0):
    """Bytes a BNN sampler must move: x and y read, each chain's parameters
    (plus extra_per_chain floats) read and written once."""
    d = shape["i"] * shape["h"] + 2 * shape["h"] + 1
    return 4 * (shape["n"] * shape["i"] + shape["n"] + shape["c"] * (2 * d + extra_per_chain))


def gradient_flops(shape):
    """FLOPs of one BNN gradient over all chains: two GEMMs of 2 N I H each."""
    return 2 * 2 * shape["n"] * shape["i"] * shape["h"] * shape["c"]


def tf32_bound_ms(flops):
    """The least time of flops float32 products done in 3xTF32: three tf32
    products each, at the dense tf32 tensor-core peak."""
    return 3 * flops / PEAK_TF32 * 1e3


def time_bnn_hmc(torch, device, gemm_ms, draws, steps, eps, card):
    """Kernel and plain times (ms) on Philox / torch noise, in turns."""
    from hamiltorch_tpu_torch.kernels.bnn_hmc import bnn_hmc, bnn_hmc_reference

    args = bnn_inputs(torch, **FLAGSHIP, seed=7, device=device)
    kw = dict(num_samples=draws, num_steps=steps, step_size=eps, tau=10.0)
    t = time_in_turns(torch, {"kernel": lambda s: bnn_hmc(s, *args, **kw),
                              "plain": lambda s: bnn_hmc_reference(s, *args, **kw)})
    (k_ms, k_all), (p_ms, p_all) = t["kernel"], t["plain"]
    grad_steps = FLAGSHIP["c"] * draws * steps
    gradients = draws * steps + 1  # one per leapfrog step, one at the start
    flops = gradient_flops(FLAGSHIP) * gradients
    fma_ms, _ = bound(flops, bnn_bytes(FLAGSHIP))
    b_ms, b_by = bound(flops, bnn_bytes(FLAGSHIP), tf32_flops=flops)
    tc_ms = tf32_bound_ms(flops)
    lib_ms = gemm_ms * gradients
    print(f"bnn_hmc {FLAGSHIP} {draws}x{steps}: kernel {k_ms:.3f} ms "
          f"({grad_steps / k_ms * 1e3:.1f} grad-steps/s), plain {p_ms:.3f} ms "
          f"({grad_steps / p_ms * 1e3:.1f} grad-steps/s); runs kernel {k_all} plain {p_all}; "
          f"bound {b_ms:.3f} ms ({b_by}; float32 FMA {fma_ms:.3f} ms, 3xTF32 tensor cores "
          f"{tc_ms:.3f} ms); cuBLAS GEMMs {lib_ms:.3f} ms [{card}]")
    return dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                bound_ops_peak=ops_ms(flops, flops)[1], bound_3xtf32_ms=tc_ms,
                bound_latency_ms=None)


def packed_floats(shape):
    """Floats of one chain's packed state in the BNN kernels (bnn_grad.cuh's
    dp: W1^T rows of I rounded up to 4, then b1, w2, b2, rounded up to 4)."""
    ip = -(-shape["i"] // 4) * 4
    return -(-(shape["h"] * ip + 2 * shape["h"] + 1) // 4) * 4


# reads and writes of one all-chain state array (g, u or theta) that a draw
# of bnn_mclmc makes (csrc/bnn_mclmc.cu's head note)
MCLMC_PASSES = 15


def velocity_bytes(shape):
    """A model, from the shapes alone, of the bytes a draw's velocity algebra
    moves: MCLMC_PASSES x the chains' packed state in float32."""
    return MCLMC_PASSES * 4 * shape["c"] * packed_floats(shape)


def launches_per_draw(fn, entry):
    """Operations a draw of fn(num_samples) queues, as the recorder counts
    them in the C entry (``<entry>.kernel_launches``), over runs of 4 and 2
    draws (the start and the end cancel)."""
    from hamiltorch_tpu_torch.utils import profiling

    counts = []
    for draws in (2, 4):
        profiling.reset()
        with profiling.recording():
            fn(draws)
        counts.append(profiling.counters()[f"{entry}.kernel_launches"])
    profiling.reset()
    return (counts[1] - counts[0]) / 2


def time_bnn_mclmc(torch, device, gemm_ms, draws, eps, length, card):
    from hamiltorch_tpu_torch.kernels.bnn_mclmc import bnn_mclmc, bnn_mclmc_reference

    args = bnn_inputs(torch, **FLAGSHIP, seed=7, device=device)
    dim = FLAGSHIP["i"] * FLAGSHIP["h"] + 2 * FLAGSHIP["h"] + 1
    u = torch.randn(FLAGSHIP["c"], dim, generator=torch.Generator().manual_seed(8)).to(device)
    kw = dict(num_samples=draws, step_size=eps, length=length, tau=10.0)
    t = time_in_turns(torch, {"kernel": lambda s: bnn_mclmc(s, *args, u, **kw),
                              "plain": lambda s: bnn_mclmc_reference(s, *args, u, **kw)})
    per_draw = launches_per_draw(lambda k: bnn_mclmc(0, *args, u, **{**kw, "num_samples": k}),
                                 "bnn_mclmc")
    print(f"bnn_mclmc: {per_draw:g} CUDA launches a draw (the recorder); velocity algebra "
          f"{velocity_bytes(FLAGSHIP) / 1e6:.1f} MB a draw modelled from the shapes "
          f"({MCLMC_PASSES} passes over the state), not measured [{card}]")
    (k_ms, k_all), (p_ms, p_all) = t["kernel"], t["plain"]
    grad_steps = FLAGSHIP["c"] * draws * 2
    gradients = 2 * draws + 1  # two per draw, one at the start
    flops = gradient_flops(FLAGSHIP) * gradients
    fma_ms, _ = bound(flops, bnn_bytes(FLAGSHIP, dim))
    b_ms, b_by = bound(flops, bnn_bytes(FLAGSHIP, dim), tf32_flops=flops)
    tc_ms = tf32_bound_ms(flops)
    lib_ms = gemm_ms * gradients
    print(f"bnn_mclmc {FLAGSHIP} {draws} draws eps={eps} L={length}: kernel {k_ms:.3f} ms "
          f"({grad_steps / k_ms * 1e3:.1f} grad-steps/s), plain {p_ms:.3f} ms "
          f"({grad_steps / p_ms * 1e3:.1f} grad-steps/s); runs kernel {k_all} plain {p_all}; "
          f"bound {b_ms:.3f} ms ({b_by}; float32 FMA {fma_ms:.3f} ms, 3xTF32 tensor cores "
          f"{tc_ms:.3f} ms); cuBLAS GEMMs {lib_ms:.3f} ms [{card}]")
    return dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                bound_ops_peak=ops_ms(flops, flops)[1], bound_3xtf32_ms=tc_ms,
                bound_latency_ms=None, launches_per_draw=per_draw)


def dense_l2_bytes(d, chains):
    """A model, from the shapes alone, of the bytes that one leapfrog step
    of gaussian_hmc's any-D variant moves through L2 at dense P: each tile
    reads its 128 rows of P^T and its chains' theta - mean over Dp (D
    rounded up to 128), 4 bytes an element, and its epilogue reads p and the
    trajectory's theta and writes them and the next theta - mean (5 x 4
    bytes an entry of the padded tiles)."""
    from hamiltorch_tpu_torch.kernels.gaussian_hmc import DENSE_ROWS, _plan

    chain_tile = _plan(d, True, 8, chains).group
    dp = -(-d // DENSE_ROWS) * DENSE_ROWS
    cp = -(-chains // chain_tile) * chain_tile
    tiles = dp // DENSE_ROWS * (cp // chain_tile)
    return tiles * (DENSE_ROWS + chain_tile) * dp * 4 + 5 * 4 * dp * cp


def time_gaussian_hmc(torch, device, d, dense, chains, draws, steps, eps, card, fma_ns, mma_ns):
    from hamiltorch_tpu_torch.kernels.gaussian_hmc import gaussian_hmc, gaussian_hmc_reference

    prec = (dense_precision(torch, d, 1) if dense else torch.linspace(0.25, 4.0, d)).to(device)
    theta0 = torch.zeros(chains, d, device=device)
    t = time_in_turns(torch, {
        "kernel": lambda s: gaussian_hmc(s, theta0, prec, draws, steps, eps),
        "plain": lambda s: gaussian_hmc_reference(s, theta0, prec, draws, steps, eps),
    })
    (k_ms, k_all), (p_ms, p_all) = t["kernel"], t["plain"]
    # per chain and leapfrog step: the gradient (2 D^2 dense, 2 D diagonal)
    # and the drift and kick (4 D); bytes: theta0 and P read, draws written
    flops = chains * draws * steps * ((2 * d * d if dense else 2 * d) + 4 * d)
    nbytes = 4 * (chains * d + prec.numel() + chains * draws * d + chains)
    # latency: a chain's draws follow one another (the accept decides where
    # the next draw starts).  The least chain of dependent operations in a
    # draw: on a Gaussian the L leapfrog steps are one fixed linear map of
    # (theta - mean, p), so the proposal is a product and an FMA deep
    # whatever L (2); then the energy's convert to float64, product, sum and
    # difference with h0 (4; h0 and log u do not wait for the proposal) and
    # the compare-and-select (1): 7.  A design that keeps the leapfrog step
    # by step, as the plain version rounds it, needs 2 L + 6 (drift and kick
    # an FMA each with eps P folded in, the first half kick 1); this
    # kernel's own chain is 4 L + 6 (drift, theta - mean, times P, kick).
    latency_ms = draws * 7 * fma_ns * 1e-6
    stepwise_ms = draws * (2 * steps + 6) * fma_ns * 1e-6
    as_built_ms = draws * (4 * steps + 6) * fma_ns * 1e-6
    from hamiltorch_tpu_torch.kernels.gaussian_hmc import MMA_MAX_D, _plan

    plan = _plan(d, dense, 8, chains)
    # variants 4 and 5 run the dense product on the tensor cores in 3xTF32
    mma = dense and (plan.variant == 5 or d <= MMA_MAX_D)
    tf32_flops = chains * draws * steps * 2 * d * d if mma else 0
    b_ms, b_by = bound(flops, nbytes, latency_ms, tf32_flops)
    lib_ms = tc_ms = None
    if dense:  # cuBLAS: the (C, D) x (D, D) gradient product of every step
        x = torch.randn(chains, d, device=device)
        ms, _ = time_in_turns(torch, {"mm": lambda s: [torch.matmul(x, prec) for _ in range(100)]})["mm"]
        lib_ms = ms / 100 * draws * steps
        tc_ms = tf32_bound_ms(chains * draws * steps * 2 * d * d)
    kind = "dense" if dense else "diagonal"
    lib = "n/a" if lib_ms is None else f"{lib_ms:.3f} ms"
    # the tensor-core bound assumes all 132 SMs busy: these chains are
    # chains / 16 blocks of 16-row mma tiles (64 at 1024 chains)
    tc = ""
    if dense and d <= MMA_MAX_D:
        # the tensor-core variant as built: a block of 16 chains issues 3 mma.sync per
        # 16 x 8 x 8 product, a quarter of them on each of its SM's four sub-cores
        dp = 32 * -(-d // 32)
        sync_ms = draws * steps * 3 * (dp // 8) ** 2 / 4 * mma_ns * 1e-6
        tc = (f", {tc_ms:.4g} ms (3xTF32 tensor cores, were the card full: {-(-chains // 16)} "
              f"blocks of 16 chains for 132 SMs), {sync_ms:.4g} ms (a block's mma.sync at the "
              f"probed rate)")
    if dense and plan.variant == 5:  # one (C, D) x (D, D) product a step across the grid
        from hamiltorch_tpu_torch.kernels.gaussian_hmc import DENSE_ROWS

        dp = -(-d // DENSE_ROWS) * DENSE_ROWS
        cp = -(-chains // plan.group) * plan.group
        tiles = dp // DENSE_ROWS * (cp // plan.group)
        # 3 mma.sync per 16 x 8 x 8 product, spread over the sub-cores of the SMs the tiles fill
        sync_ms = (draws * steps * 3 * (dp // 16) * (cp // 8) * (dp // 8)
                   / (4 * min(tiles, 132)) * mma_ns * 1e-6)
        tc = (f", {tc_ms:.4g} ms (3xTF32 tensor cores), {sync_ms:.4g} ms (its mma.sync at the "
              f"probed rate over the SMs its {tiles} tiles fill); L2 bytes a step, modelled "
              f"from the shapes (not measured): {dense_l2_bytes(d, chains) / 2**20:.1f} MiB")
    mma_ops = f", {ops_ms(flops, tf32_flops)[0]:.4g} with the product in 3xTF32" if mma else ""
    print(f"gaussian_hmc D={d} {kind} {chains} chains {draws}x{steps} (variant {plan.variant}): "
          f"kernel {k_ms:.3f} ms "
          f"({chains * draws / k_ms * 1e3:.4g} chain-draws/s), plain {p_ms:.3f} ms "
          f"({chains * draws / p_ms * 1e3:.4g} chain-draws/s); runs kernel {k_all} plain {p_all}; "
          f"bound {b_ms:.4g} ms ({b_by}; operations {flops / PEAK_FLOPS * 1e3:.4g} at the "
          f"float32 FMA peak{mma_ops}, bytes "
          f"{nbytes / PEAK_BYTES * 1e3:.4g}, latency {latency_ms:.4g}; the dependent chain of a "
          f"step-by-step leapfrog {stepwise_ms:.4g} ms, of this design {as_built_ms:.4g} ms){tc}; "
          f"cuBLAS matmuls {lib} "
          f"[{card}]")
    return dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                bound_ops_peak=ops_ms(flops, tf32_flops)[1], bound_3xtf32_ms=tc_ms,
                bound_latency_ms=latency_ms)


def hmc_main_path(torch, device, draws, steps, eps, card):
    """The HMC path, counted: the fused sampler, run_hmc_chains, sample()."""
    from hamiltorch_tpu_torch import MCMCConfig, Sampler, run_hmc_chains, sample
    from hamiltorch_tpu_torch.kernels.bnn_hmc import bnn_hmc
    from hamiltorch_tpu_torch.models.flagship import make_flagship_potential_tree

    bnn_hmc.launches = 0
    torch.cuda.reset_peak_memory_stats()
    fused = bnn_hmc(11, *bnn_inputs(torch, **FLAGSHIP, seed=11, device=device),
                    num_samples=draws, num_steps=steps, step_size=eps, tau=10.0)
    torch.cuda.synchronize()
    if not all(bool(torch.all(torch.isfinite(t))) for t in fused):
        raise SmokeError("fused sampler returned non-finite values")
    print(f"fused sampler: acc mean {float(fused[4].mean()):.4f}")

    log_prob_fn, params0 = make_flagship_potential_tree(device=device)
    config = MCMCConfig(num_samples=draws, num_steps_per_sample=steps, step_size=eps)
    run_hmc_chains(0, log_prob_fn, params0, config, num_chains=FLAGSHIP["c"])  # warm up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_hmc_chains(1, log_prob_fn, params0, config, num_chains=FLAGSHIP["c"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    for name, leaf in res.samples.items():
        want = (FLAGSHIP["c"], draws) + tuple(params0[name].shape)
        if tuple(leaf.shape) != want or not bool(torch.all(torch.isfinite(leaf))):
            raise SmokeError(f"run_hmc_chains sample {name}: shape {tuple(leaf.shape)}, want {want}")
    print(f"run_hmc_chains flagship tree 64 chains {draws}x{steps}: {dt:.3f} s, "
          f"{FLAGSHIP['c'] * draws * steps / dt:.1f} grad-steps/s, acceptance "
          f"{float(res.acc_rate.mean()):.4f}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB [{card}]")

    stds = torch.tensor([0.5, 1.0, 2.0], device=device)
    draws_g = sample(lambda t: -0.5 * torch.sum((t / stds) ** 2), torch.zeros(3, device=device),
                     num_samples=400, num_steps_per_sample=5, step_size=0.3,
                     sampler=Sampler.HMC, key=0, verbose=False)
    emp = draws_g[1:].std(dim=0)
    print(f"sample() 3-D Gaussian 400 draws: std {emp.tolist()} (target [0.5, 1, 2])")
    # the std-0.5 dim is not checked: a trajectory of 5 x 0.3 sits on its
    # t ~ pi * sigma resonance, where each draw nearly negates it and its
    # spread grows slowly from the start at 0 (the JAX package reads
    # 0.15-0.45 there too); the other two dims mix
    if draws_g.shape != (400, 3) or not bool(torch.all((emp / stds - 1)[1:].abs() < 0.35)):
        raise SmokeError(f"sample(): shape {tuple(draws_g.shape)}, std {emp.tolist()}")
    return bnn_hmc.launches


def mclmc_main_path(torch, device, card):
    """The MCLMC path, counted: tune 64 flagship chains with run_mclmc_chains,
    resume frozen chunks (timed), then bnn_mclmc from the tuned state and
    velocity at the median tuned (eps, L), checked against the chunk."""
    from hamiltorch_tpu_torch import MCLMCConfig, run_mclmc_chains
    from hamiltorch_tpu_torch.kernels.bnn_mclmc import bnn_mclmc
    from hamiltorch_tpu_torch.models.flagship import make_flagship_potential

    n, i_dim, h, c = FLAGSHIP["n"], FLAGSHIP["i"], FLAGSHIP["h"], FLAGSHIP["c"]
    x, y, *_ = bnn_inputs(torch, n, i_dim, h, 1, seed=13, device=device)
    log_prob_fn, theta0 = make_flagship_potential(i_dim, h, n, x=x, y=y, device=device)
    dims = theta0.numel()

    bnn_mclmc.launches = 0
    t0 = time.perf_counter()
    tuned = run_mclmc_chains(20260819, log_prob_fn, theta0,
                             MCLMCConfig(num_samples=10, tune_steps=MCLMC_TUNE_STEPS, thin=10),
                             num_chains=c)
    torch.cuda.synchronize()
    t_tune = time.perf_counter() - t0
    eps = float(tuned.step_size.median())
    length = float(tuned.trajectory_length.median())
    print(f"run_mclmc_chains flagship 64 chains, {MCLMC_TUNE_STEPS} tuning steps: {t_tune:.3f} s; "
          f"tuned eps median {eps:.5g} (range {float(tuned.step_size.min()):.5g}-"
          f"{float(tuned.step_size.max()):.5g}), L median {length:.5g}, divergent "
          f"{int(tuned.stats.divergent.sum())} [{card}]")

    frozen = MCLMCConfig(num_samples=MCLMC_CHUNK, tune_steps=0, thin=10)
    chunk_ms = []
    for rep in range(3):  # each chain at its own tuned (eps, L), as bench.py times it
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chunk = run_mclmc_chains(20260819 + rep, log_prob_fn, None, frozen, c, resume_from=tuned)
        torch.cuda.synchronize()
        chunk_ms.append((time.perf_counter() - t0) * 1e3)
        if chunk.samples.shape != (c, MCLMC_CHUNK // 10, dims) or not bool(
                torch.all(torch.isfinite(chunk.samples))):
            raise SmokeError(f"frozen chunk: shape {tuple(chunk.samples.shape)} or non-finite")
    ms = statistics.median(chunk_ms)
    print(f"run_mclmc_chains frozen chunk 64 chains x {MCLMC_CHUNK} steps at the tuned (eps, L): "
          f"{ms:.3f} ms ({c * MCLMC_CHUNK * 2 / ms * 1e3:.1f} grad-steps/s; runs {chunk_ms}), "
          f"mean(dE^2)/d {float(torch.mean(chunk.stats.energy_change.double() ** 2)) / dims:.4e}, "
          f"divergent {int(chunk.stats.divergent.sum())} [{card}]")

    # the check of tests/test_mclmc_kernel.py:165-198: from the tuned state,
    # every chain of a frozen chunk and of the kernel at one (eps, L), the
    # tuned chains' median (the tuner leaves the chains' eps far apart).
    # At that step the true dE is ~1e-3 or less, below the float32 rounding
    # of the flagship's logp (a sum near -5e4 once the chains spread over
    # the prior), so the chunk runs on the same potential in float64, as the
    # kernel reduces logp in float64
    log_prob_64, _ = make_flagship_potential(i_dim, h, n, x=x.double(), y=y.double(),
                                             theta0=theta0.double(), dtype=torch.float64,
                                             device=device)
    at_median = tuned._replace(
        final_theta=tuned.final_theta.double(), final_u=tuned.final_u.double(),
        step_size=torch.full_like(tuned.step_size, eps),
        trajectory_length=torch.full_like(tuned.trajectory_length, length))
    check = run_mclmc_chains(20260819, log_prob_64, None, frozen, c, resume_from=at_median)
    chunk_var = float(torch.mean(check.stats.energy_change.double() ** 2)) / dims
    th = tuned.final_theta
    s0, s1 = i_dim * h, i_dim * h + h
    out = bnn_mclmc(7, x, y, th[:, :s0].reshape(c, i_dim, h).contiguous(),
                    th[:, s0:s1].contiguous(), th[:, s1:s1 + h].contiguous(),
                    th[:, -1].contiguous(), tuned.final_u.contiguous(),
                    num_samples=MCLMC_CHUNK, step_size=eps, length=length, tau=10.0)
    torch.cuda.synchronize()
    launches = bnn_mclmc.launches
    if not all(bool(torch.all(torch.isfinite(t))) for t in out):
        raise SmokeError("bnn_mclmc from the tuned state returned non-finite values")
    kern_var = float(out[4].mean())
    ratio = kern_var / chunk_var
    print(f"at the median (eps, L) = ({eps:.5g}, {length:.5g}) from the tuned state, "
          f"{MCLMC_CHUNK} steps: bnn_mclmc var_e median {float(out[4].median()):.4e} mean "
          f"{kern_var:.4e} vs run_mclmc_chains (float64 potential) mean(dE^2)/d {chunk_var:.4e}: "
          f"ratio of means "
          f"{ratio:.3f}")
    if not 0.5 < ratio < 2.0:
        raise SmokeError(f"bnn_mclmc var_e / run_mclmc_chains var_e = {ratio:.3f}, not in 0.5-2")
    return launches


def gaussian_main_path(torch, device):
    """gaussian_hmc's statistics on Philox, counted (tests/test_kernels.py:46-101,
    at 256 chains x 600 draws, L=6, eps=0.2)."""
    from hamiltorch_tpu_torch.kernels.gaussian_hmc import gaussian_hmc

    gaussian_hmc.launches = 0
    kw = dict(num_samples=600, num_steps=6, step_size=0.2)

    def zeros(d):
        return torch.zeros(256, d, device=device)

    # 4000 draws, not 600: the summary below wants R-hat < 1.01, and the std-2
    # dim decorrelates over ~10 draws, so 600 draws leave its split-R-hat ~1.02
    samples, acc = gaussian_hmc(0, zeros(3), torch.tensor([4.0, 1.0, 0.25], device=device),
                                **dict(kw, num_samples=4000))
    draws_3d = samples[:, 150:]
    s = draws_3d.reshape(-1, 3)
    mean, std = s.mean(0).cpu(), s.std(0).cpu()
    print(f"gaussian_hmc diagonal: mean {mean.tolist()} std {std.tolist()} (target [0.5, 1, 2]) "
          f"acceptance {float(acc.mean()):.4f}")
    if not (bool((mean.abs() < 0.1).all())
            and bool(((std / torch.tensor([0.5, 1.0, 2.0]) - 1).abs() < 0.1).all())
            and float(acc.mean()) > 0.8):
        raise SmokeError("gaussian_hmc: diagonal moments or acceptance off")

    cov = torch.tensor([[1.0, 0.6], [0.6, 1.0]])
    samples, _ = gaussian_hmc(3, zeros(2), torch.linalg.inv(cov).contiguous().to(device), **kw)
    emp = torch.cov(samples[:, 100:].reshape(-1, 2).T.double()).float().cpu()
    print(f"gaussian_hmc dense: covariance {emp.tolist()} (target {cov.tolist()})")
    if not bool(((emp - cov).abs() < 0.12).all()):
        raise SmokeError("gaussian_hmc: dense covariance off")

    target = torch.tensor([3.0, -2.0], device=device)
    samples, _ = gaussian_hmc(0, zeros(2) + target, torch.tensor([1.0, 4.0], device=device),
                              mean=target, **kw)
    mean = samples[:, 100:].reshape(-1, 2).mean(0)
    print(f"gaussian_hmc shifted mean: {mean.tolist()} (target [3, -2])")
    if not bool(((mean - target).abs() < 0.1).all()):
        raise SmokeError("gaussian_hmc: mean off")

    # dense 64-D: the tensor-core variant
    prec = dense_precision(torch, 64, 2)
    cov = torch.linalg.inv(prec.double()).float()
    samples, acc = gaussian_hmc(5, zeros(64), prec.to(device), **kw)
    emp = torch.cov(samples[:, 150:].reshape(-1, 64).T.double()).float().cpu()
    print(f"gaussian_hmc dense 64-D: covariance max_abs_err {float((emp - cov).abs().max()):.4f} "
          f"(entries up to {float(cov.abs().max()):.3f}) acceptance {float(acc.mean()):.4f}")
    if not (bool(((emp - cov).abs() < 0.05).all()) and float(acc.mean()) > 0.8):
        raise SmokeError("gaussian_hmc: dense 64-D covariance or acceptance off")

    # diagonal 1000-D: the any-D variant.  Its stds over 64 x 450 draws: the
    # slowest dims (std 2, a 1.2 trajectory) decorrelate in tens of draws,
    # so each std carries ~1% of noise and the largest of 1000 ~3%
    stds = torch.linspace(0.5, 2.0, 1000, device=device)
    samples, acc = gaussian_hmc(9, torch.zeros(64, 1000, device=device), 1 / stds**2, **kw)
    rel = (samples[:, 150:].reshape(-1, 1000).std(0) / stds - 1).abs()
    print(f"gaussian_hmc diagonal 1000-D (stds 0.5-2): max relative std error {float(rel.max()):.4f} "
          f"(median {float(rel.median()):.4f}), acceptance {float(acc.mean()):.4f}")
    if not (float(rel.max()) < 0.1 and float(acc.mean()) > 0.6):
        raise SmokeError("gaussian_hmc: the 1000-D stds or acceptance are off")

    # dense 512-D: the any-D variant's grid-wide product.  Its marginal
    # variances against the diagonal of P^-1: each chain's mean of theta^2
    # (the mean is 0) over the last 300 draws, their mean over the chains,
    # and its standard error from the chains' spread, which carries the
    # draws' autocorrelation; 5 standard errors at each of the 512 dims.
    # From theta = 0 the variances take ~250 draws to settle (the plain
    # version on the CPU: 0.85 of the target at draw 150, 0.99 at 250)
    prec = dense_precision(torch, 512, 1)
    var = torch.linalg.inv(prec.double()).diagonal().float()
    samples, acc = gaussian_hmc(4, torch.zeros(64, 512, device=device), prec.to(device), **kw)
    per_chain = (samples[:, 300:].double() ** 2).mean(1).cpu()  # (chains, D)
    se = per_chain.std(0) / per_chain.shape[0] ** 0.5
    z = ((per_chain.mean(0) - var) / se).abs()
    print(f"gaussian_hmc dense 512-D: marginal variances {float(var.min()):.3f}-"
          f"{float(var.max()):.3f}, largest |error| / standard error {float(z.max()):.3f} "
          f"(median {float(z.median()):.3f}), "
          f"relative error up to {float(((per_chain.mean(0) - var) / var).abs().max()):.4f}, "
          f"acceptance {float(acc.mean()):.4f}")
    if not (float(z.max()) < 5.0 and float(acc.mean()) > 0.6):
        raise SmokeError("gaussian_hmc: the dense 512-D variances or acceptance are off")

    prec = torch.ones(3, device=device)
    s1, _ = gaussian_hmc(7, torch.zeros(16, 3, device=device), prec, 50, 5, 0.3)
    s2, _ = gaussian_hmc(7, torch.zeros(16, 3, device=device), prec, 50, 5, 0.3)
    if not torch.equal(s1, s2) or torch.allclose(s1[0], s1[1]):
        raise SmokeError("gaussian_hmc: the same seed must give the same trace, chains must differ")
    return gaussian_hmc.launches, draws_3d


def diagnostics_on_card(torch, draws):
    """diagnostics.summary of the 3-D Gaussian's draws on the card against
    the same call on the CPU (both float64), and R-hat below 1.01."""
    from hamiltorch_tpu_torch.diagnostics import summary

    on_card = summary(draws)
    on_host = summary(draws.cpu())
    worst = max(float(((on_card[k].cpu() - v) / v).abs().max()) for k, v in on_host.items())
    r_hat = max(float(on_card["r_hat"].max()), float(on_card["r_hat_rank"].max()))
    print(f"diagnostics.summary of the 3-D draws {tuple(draws.shape)} on the card: "
          f"ess_bulk {on_card['ess_bulk'].tolist()}, ess_tail {on_card['ess_tail'].tolist()}, "
          f"mcse_mean {on_card['mcse_mean'].tolist()}, max R-hat {r_hat:.5f}; "
          f"card vs CPU max relative difference {worst:.3e}")
    if not (worst <= DIAG_RTOL and r_hat < 1.01):
        raise SmokeError(f"diagnostics on the card: card vs CPU {worst:.3e}, R-hat {r_hat}")


def mams_main_path(torch, device, card):
    """run_mams_chains on the flagship tree: 64 chains, mclachlan, 10 steps a
    draw (2 gradients a step), burn 50, 100 draws."""
    from hamiltorch_tpu_torch import MAMSConfig, run_mams_chains
    from hamiltorch_tpu_torch.models.flagship import make_flagship_potential_tree

    log_prob_fn, params0 = make_flagship_potential_tree(device=device)
    config = MAMSConfig(num_samples=100, num_steps_per_sample=10, burn=50)
    c = FLAGSHIP["c"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_mams_chains(21, log_prob_fn, params0, config, c)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    acc = float(res.acc_rate.mean())
    stuck = int(res.stats.divergent.all(dim=1).sum())
    print(f"run_mams_chains flagship tree {c} chains x 100 draws x 10 steps (burn 50): {dt:.3f} s, "
          f"{c * 100 * 10 * 2 / dt:.1f} grad-steps/s; post-burn acceptance {acc:.4f} (target "
          f"{config.desired_accept_rate}), adapted eps median {float(res.step_size.median()):.5g} "
          f"(range {float(res.step_size.min()):.5g}-{float(res.step_size.max()):.5g}), divergent "
          f"draws {int(res.stats.divergent.sum())}, chains divergent on every draw {stuck} [{card}]")
    finite = all(bool(torch.all(torch.isfinite(leaf))) for leaf in res.samples.values())
    if not (finite and abs(acc - config.desired_accept_rate) <= 0.15 and stuck == 0):
        raise SmokeError(f"MAMS: acceptance {acc:.4f}, {stuck} stuck chains, finite {finite}")


def warmup_main_path(torch, device, card):
    """Windowed mass warmup: diagonal on the flagship tree, dense on a
    correlated 64-D Gaussian (three seeds)."""
    from hamiltorch_tpu_torch import MCMCConfig, run_hmc_chains
    from hamiltorch_tpu_torch.models.flagship import make_flagship_potential_tree

    log_prob_fn, params0 = make_flagship_potential_tree(device=device)
    c = FLAGSHIP["c"]
    config = MCMCConfig(num_samples=350, num_steps_per_sample=10, step_size=2e-4, burn=300,
                        adapt_step_size=True, adapt_mass="diag")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_hmc_chains(22, log_prob_fn, params0, config, c)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    metric = res.final_warm[1]
    print(f"run_hmc_chains flagship tree {c} chains, adapt_mass='diag', burn 300 (windows [75, 100), "
          f"[100, 150), [150, 250)) + 50 draws x L=10: {dt:.3f} s, {c * 350 * 10 / dt:.1f} "
          f"grad-steps/s; adapted inverse mass min {float(metric.min()):.4g} median "
          f"{float(metric.median()):.4g} max {float(metric.max()):.4g}, step size median "
          f"{float(res.final_step_size.median()):.4g}, post-burn acceptance "
          f"{float(res.stats.accepted[:, 300:].float().mean()):.4f} [{card}]")
    if not (bool(torch.all(torch.isfinite(metric))) and bool(torch.all(metric > 0))):
        raise SmokeError("windowed warmup: the adapted inverse mass is not finite and positive")

    prec = dense_precision(torch, 64, 2).to(device)
    cov = torch.linalg.inv(prec.double()).float()
    dense = MCMCConfig(num_samples=1050, num_steps_per_sample=10, step_size=0.1, burn=1000,
                       adapt_step_size=True, adapt_mass="dense")
    for seed in (0, 1, 2):
        t0 = time.perf_counter()
        res = run_hmc_chains(seed, lambda t: -0.5 * t @ prec @ t, torch.zeros(64, device=device),
                             dense, c)
        torch.cuda.synchronize()
        err = float((res.final_warm[1][0].mean(0) - cov).abs().max())
        print(f"run_hmc_chains 64-D Gaussian {c} chains, adapt_mass='dense', burn 1000, seed {seed}: "
              f"{time.perf_counter() - t0:.3f} s; chains' mean adapted inverse mass vs the "
              f"covariance: max_abs_err {err:.4f} (entries up to {float(cov.abs().max()):.3f}, "
              f"tolerance {DENSE_WARMUP_ATOL}) [{card}]")
        if not err <= DENSE_WARMUP_ATOL:
            raise SmokeError(f"dense warmup: adapted inverse mass off by {err:.4f}")


def bnn_model_path(torch, device, card):
    """The BNN layer on a torch.nn.Module (``sample_model``, ``predict_model``,
    ``define_model_log_prob``, ``waic`` / ``psis_loo``) at the flagship's
    width: the 784-128-1 tanh MLP as a user writes it, N = 1024 rows made
    from a seed, regression with tau_out 10, an N(0, 1) prior on every leaf."""
    import math

    from torch import nn

    from hamiltorch_tpu_torch import (
        MCMCConfig,
        predict_model,
        psis_loo,
        run_hmc,
        run_hmc_host_offload,
        sample_model,
        waic,
    )
    from hamiltorch_tpu_torch.model_comparison import pointwise_log_lik_from_predictions
    from hamiltorch_tpu_torch.models.bnn import define_model_log_prob
    from hamiltorch_tpu_torch.models.flagship import make_flagship_potential

    n, i_dim, h = FLAGSHIP["n"], FLAGSHIP["i"], FLAGSHIP["h"]
    x, y, *_ = bnn_inputs(torch, n, i_dim, h, 1, seed=31, device=device)
    torch.manual_seed(31)
    net = nn.Sequential(nn.Linear(i_dim, h), nn.Tanh(), nn.Linear(h, 1))
    kw = dict(model_loss="regression", tau_out=10.0, tau_list=1.0)

    # 1. the module's potential against the flagship's at the same weights:
    # the flagship keeps W1 as (in, hidden) and W2 as (hidden, 1), nn.Linear
    # as (out, in), and the flagship's prior drops -D/2 log(2 pi)
    lp_mod, theta, _ = define_model_log_prob(net, kw["model_loss"], x, y, tau_out=10.0,
                                             tau_list=1.0, device=device)
    dims = theta.numel()
    s0, s1 = i_dim * h, i_dim * h + h

    def to_flagship(v):
        return torch.cat([v[:s0].reshape(h, i_dim).T.reshape(-1), v[s0:s1],
                          v[s1:s1 + h], v[s1 + h:]])

    lp_flag, _ = make_flagship_potential(i_dim, h, n, tau_out=10.0, x=x, y=y,
                                         theta0=to_flagship(theta), device=device)
    g_mod, v_mod = torch.func.grad_and_value(lp_mod)(theta)
    g_flag, v_flag = torch.func.grad_and_value(lp_flag)(to_flagship(theta))
    const = -0.5 * dims * math.log(2 * math.pi)
    lp_err = abs(float(v_mod) - const - float(v_flag))
    g_err = float((to_flagship(g_mod) - g_flag).abs().max())
    g_scale = float(g_flag.abs().max())
    print(f"bnn_model: nn.Sequential {i_dim}-{h}-1 tanh ({dims} parameters) through "
          f"define_model_log_prob vs the flagship potential: logp {float(v_mod):.6f} - "
          f"({const:.6f}) vs {float(v_flag):.6f}, diff {lp_err:.3e} ({lp_err / abs(float(v_mod)):.3e} "
          f"of the module's logp, {lp_err / abs(float(v_flag)):.3e} of the flagship's); gradient "
          f"max_abs_err {g_err:.3e} (max |g| {g_scale:.4g})")
    if not (lp_err <= MODEL_LOGP_RTOL * abs(float(v_mod)) and g_err <= GRAD_RTOL * g_scale):
        raise SmokeError(f"bnn_model: the module's potential is not the flagship's: logp "
                         f"{lp_err:.3e}, gradient {g_err:.3e}")

    # 2. sample_model, the trace on the card and offloaded to the host
    draws, steps, eps = 10, 50, 2e-4
    run = dict(num_samples=draws, num_steps_per_sample=steps, step_size=eps, key=41,
               verbose=False, device=device, **kw)
    config = MCMCConfig(num_samples=draws, num_steps_per_sample=steps, step_size=eps)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # one chain, host-bound: each run once, in this order, and run_hmc on the
    # module's potential first and last, to show the host's drift in the call
    direct, dt_mod = timed(lambda: run_hmc(41, lp_mod, theta, config))
    (on_card, acc), dt = timed(lambda: sample_model(net, x, y, debug=2, **run))
    offloaded, dt_off = timed(lambda: sample_model(net, x, y, store_on_GPU=False, **run))
    chunked, dt_chunk = timed(lambda: run_hmc_host_offload(41, lp_mod, theta, config,
                                                           chunk_size=4))
    _, dt_flag = timed(lambda: run_hmc(41, lp_flag, to_flagship(theta), config))
    _, dt_mod2 = timed(lambda: run_hmc(41, lp_mod, theta, config))
    rate = draws * steps
    print(f"sample_model {draws} draws x {steps} steps at {eps}, one chain: acceptance {acc:.4f}; "
          f"grad-steps/s: sample_model {rate / dt:.1f}, with store_on_GPU=False {rate / dt_off:.1f}, "
          f"run_hmc_host_offload chunks of 4 {rate / dt_chunk:.1f}; run_hmc on the module's "
          f"potential {rate / dt_mod:.1f} then {rate / dt_mod2:.1f}, on the flagship potential "
          f"{rate / dt_flag:.1f} [{card}]")
    same = (torch.equal(offloaded, on_card.cpu())
            and torch.equal(chunked.samples, direct.samples.cpu())
            and torch.equal(on_card[1:], direct.samples[1:]))
    if not (same and offloaded.device.type == "cpu" and tuple(on_card.shape) == (draws, dims)
            and bool(torch.all(torch.isfinite(on_card)))):
        raise SmokeError("bnn_model: store_on_GPU=False (one chunk, chunks of 4) does not "
                         "return the trace of store_on_GPU=True")

    # 3. predict_model over the kept draws: on x, through a loader of ragged
    # batches (300, 300, 300, 124), and streamed two batches at a time
    predict_model(net, on_card, x=x, y=y, device=device, **kw)  # first use loads kernels
    (preds, lps), dt_pred = timed(lambda: predict_model(net, on_card, x=x, y=y, device=device,
                                                        **kw))
    loader = torch.utils.data.DataLoader(
        torch.utils.data.TensorDataset(x.cpu(), y.cpu()), batch_size=300)
    via_loader = predict_model(net, on_card, test_loader=loader, device=device, **kw)
    streamed = predict_model(net, on_card, test_loader=loader, stream_batches=2,
                             device=device, **kw)
    pred_err = max(float((got[0].to(device) - preds).abs().max()) for got in (via_loader, streamed))
    lp_rel = max(float(((got[1].to(device) - lps) / lps).abs().max())
                 for got in (via_loader, streamed))
    print(f"predict_model over {on_card.shape[0]} draws x {n} rows: {1e3 * dt_pred:.3f} ms on x; "
          f"a loader of ragged batches and its stream (2 batches at a time, on the host: "
          f"{streamed[0].device.type}) against x: predictions max_abs_err {pred_err:.3e}, "
          f"log-probs max relative difference {lp_rel:.3e} [{card}]")
    if not (pred_err <= MODEL_CARD_RTOL and lp_rel <= MODEL_CARD_RTOL
            and streamed[0].device.type == "cpu" and tuple(preds.shape) == (draws, n, 1)
            and bool(torch.all(torch.isfinite(preds)))):
        raise SmokeError(f"bnn_model: predict_model paths disagree: {pred_err:.3e}, {lp_rel:.3e}")

    # 4. a classifier with BatchNorm (batch statistics) on the card vs the CPU
    torch.manual_seed(32)
    clf = nn.Sequential(nn.Linear(i_dim, h), nn.BatchNorm1d(h), nn.Tanh(), nn.Linear(h, 10))
    labels = torch.randint(0, 10, (n,), generator=torch.Generator().manual_seed(33)).float()

    def clf_grad(dev):
        lp, flat0, _ = define_model_log_prob(clf, "multi_class_linear_output", x.to(dev),
                                             labels.to(dev), device=dev)
        return torch.func.grad_and_value(lp)(flat0)

    (g_card, v_card), (g_host, v_host) = clf_grad(device), clf_grad("cpu")
    v_rel = abs(float(v_card) - float(v_host)) / abs(float(v_host))
    g_rel = float((g_card.cpu() - g_host).abs().max()) / float(g_host.abs().max())
    print(f"{i_dim}-{h}-10 classifier with BatchNorm1d: define_model_log_prob card vs CPU, logp "
          f"relative difference {v_rel:.3e}, gradient {g_rel:.3e} of max |g|")
    if not (v_rel <= MODEL_CARD_RTOL and g_rel <= MODEL_CARD_RTOL):
        raise SmokeError(f"bnn_model: BatchNorm classifier card vs CPU {v_rel:.3e}, {g_rel:.3e}")

    # 5. WAIC and PSIS-LOO on predict_model's log-likelihoods, card vs CPU:
    # the kept draws, then 1000 draws around the last (PSIS smooths a tail
    # of min(0.2 S, 3 sqrt(S)) >= 5 draws only from S = 25)
    ll = pointwise_log_lik_from_predictions(preds, y, "regression", 10.0)
    cloud = on_card[-1] + 1e-3 * torch.randn(1000, dims, generator=torch.Generator(
        device=device).manual_seed(34), device=device)
    predict_model(net, cloud, x=x, y=y, device=device, **kw)
    (big_preds, _), dt_big = timed(lambda: predict_model(net, cloud, x=x, y=y, device=device, **kw))
    ll_big = pointwise_log_lik_from_predictions(big_preds, y, "regression", 10.0)
    def rel_max(a, b):
        return float((a - b).abs().max()) / float(b.abs().max())

    worst = 0.0
    for name, mat in (("kept draws", ll), ("1000 draws", ll_big)):
        for fn in (waic, psis_loo):
            fn(mat)  # first use loads the float64 kernels
            (got, dt_fn), want = timed(lambda: fn(mat)), fn(mat.cpu())
            rel = max(abs(getattr(got, f) - getattr(want, f)) / abs(getattr(want, f))
                      for f in ("elpd", "p_eff", "se"))
            # per-point values (and Pareto k) relative to their largest
            rel = max(rel, rel_max(got.pointwise.cpu(), want.pointwise))
            if fn is psis_loo:
                k_card, k_host = got.pareto_k.cpu(), want.pareto_k
                if not torch.equal(torch.isinf(k_card), torch.isinf(k_host)):
                    raise SmokeError("bnn_model: PSIS smooths other columns on the card")
                fin = torch.isfinite(k_host)
                if bool(fin.any()):
                    rel = max(rel, rel_max(k_card[fin], k_host[fin]))
            worst = max(worst, rel)
            print(f"{fn.__name__} on {name} {tuple(mat.shape)}: elpd {got.elpd:.6f}, p_eff "
                  f"{got.p_eff:.6f}, se {got.se:.6f}; card vs CPU max relative difference "
                  f"{rel:.3e}; {1e3 * dt_fn:.3f} ms on the card"
                  + (f"; pareto_k > 0.7 at {int((got.pareto_k > 0.7).sum())} of {mat.shape[1]} "
                     f"(inf where S < 25 leaves no tail to smooth)" if fn is psis_loo else "")
                  + f" [{card}]")
    print(f"predict_model over 1000 draws x {n} rows: {1e3 * dt_big:.3f} ms [{card}]")
    if not worst <= COMPARISON_RTOL:
        raise SmokeError(f"bnn_model: WAIC / PSIS-LOO card vs CPU {worst:.3e}")


def same_tensors(torch, a, b) -> bool:
    """True when two results hold equal tensors everywhere (named tuples,
    dataclasses, dicts, sequences), bit for bit."""
    import dataclasses

    if isinstance(b, torch.Tensor):
        return isinstance(a, torch.Tensor) and a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())
    if dataclasses.is_dataclass(b):
        return all(same_tensors(torch, getattr(a, f.name), getattr(b, f.name))
                   for f in dataclasses.fields(b))
    if isinstance(b, dict):
        return a.keys() == b.keys() and all(same_tensors(torch, a[k], b[k]) for k in b)
    if isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(same_tensors(torch, x, y) for x, y in zip(a, b))
    return a == b


def nuts_path(torch, device, card):
    """Tree-doubling NUTS (no kernel of its own: it evaluates the generic
    potential, as the JAX package's does) at the flagship's full width: card
    against CPU in float64 on the same injected noise, float32 chains with
    step-size adaptation (timed), moment checks on two Gaussians, and the
    host offload."""
    from hamiltorch_tpu_torch import (
        NUTSConfig,
        Sampler,
        run_nuts,
        run_nuts_chains,
        run_nuts_ensemble,
        sample,
    )
    from hamiltorch_tpu_torch.models.flagship import flagship_dims, make_flagship_potential
    from hamiltorch_tpu_torch.ops.potential import value_and_grad
    from hamiltorch_tpu_torch.samplers import nuts
    from hamiltorch_tpu_torch.samplers.offload import run_nuts_host_offload

    dims = flagship_dims()
    # 1. card against CPU: float64, 4 chains x 3 draws, depth 6, step 2e-4
    chains, draws, depth = 4, 3, 6
    gen = torch.Generator().manual_seed(41)
    f64 = dict(generator=gen, dtype=torch.float64)
    noise = {"z": torch.randn(draws, chains, dims, **f64),
             "u_dir": torch.rand(draws, chains, depth, **f64),
             "u_merge": torch.rand(draws, chains, depth, **f64),
             "u_leaf": torch.rand(draws, chains, depth, 1 << (depth - 1), **f64)}
    cfg = NUTSConfig(num_samples=draws, step_size=2e-4, max_tree_depth=depth)

    def run64(dev):
        lp, theta0 = make_flagship_potential(dtype=torch.float64, device=dev)
        return run_nuts_chains(0, lp, theta0, cfg, chains,
                               _noise={k: v.to(dev) for k, v in noise.items()})

    t0 = time.perf_counter()
    (card_res, card_info), (host_res, host_info) = run64(device), run64("cpu")
    same_trees = all(torch.equal(getattr(card_info, f).cpu(), getattr(host_info, f))
                     for f in ("tree_depth", "num_leapfrogs", "divergent"))
    err = float((card_res.samples.cpu() - host_res.samples).abs().max())
    scale = float(host_res.samples.abs().max())
    print(f"run_nuts_chains flagship float64, {chains} chains x {draws} draws, depth <= {depth}, "
          f"step 2e-4, card vs CPU on the same noise: tree depths {card_info.tree_depth.tolist()}, "
          f"leapfrogs {card_info.num_leapfrogs.tolist()}, identical trees {same_trees}; positions "
          f"max_abs_err {err:.3e} ({err / scale:.3e} of max |theta| {scale:.4g}); "
          f"{time.perf_counter() - t0:.1f} s")
    if not (same_trees and err <= 1e-8 * scale):
        raise SmokeError(f"NUTS card vs CPU: identical trees {same_trees}, error {err / scale:.3e}")

    # 2. float32 on the card: 16 chains, burn 30 + 20 kept, adapting the step size
    lp, theta0 = make_flagship_potential(device=device)
    c, burn = 16, 30
    cfg = NUTSConfig(num_samples=burn + 20, step_size=2e-4, burn=burn, max_tree_depth=depth)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    nuts.leaf_steps = 0
    t0 = time.perf_counter()
    res, info = run_nuts_chains(23, lp, theta0, cfg, c)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    leaves, peak = nuts.leaf_steps, torch.cuda.max_memory_allocated()
    used = int(info.num_leapfrogs.sum())
    # the batched gradient alone, and one device-to-host sync on an idle card
    vg = torch.func.vmap(value_and_grad(lp))
    batch = res.final_state.theta.contiguous()
    vg(batch)
    grad_ms = statistics.median(cuda_ms(torch, lambda: vg(batch)) for _ in range(10))
    flag = torch.zeros(1, dtype=torch.bool, device=device)
    bool(flag.any())
    sync_us = []
    for _ in range(200):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        bool(flag.any())
        sync_us.append(1e6 * (time.perf_counter() - t1))
    sync_us = statistics.median(sync_us)
    post_acc = float(info.accept_prob[:, burn:].mean())
    stuck = int(info.divergent[:, burn:].all(dim=1).sum())
    print(f"run_nuts_chains flagship float32, {c} chains, burn {burn} + 20 kept, depth <= {depth}, "
          f"step 2e-4 adapting: {dt:.3f} s, {leaves} leaf iterations ({1e3 * dt / leaves:.3f} ms a "
          f"leaf; the {c}-chain gradient alone {grad_ms:.3f} ms); grad-steps/s used "
          f"{used / dt:.1f}, computed {leaves * c / dt:.1f}; mean tree depth "
          f"{float(info.tree_depth.float().mean()):.3f} (post-burn "
          f"{float(info.tree_depth[:, burn:].float().mean()):.3f}); adapted step median "
          f"{float(res.final_step_size.median()):.4g}; post-burn mean accept_prob {post_acc:.4f}, "
          f"divergent draws {int(info.divergent.sum())}, chains divergent on every post-burn "
          f"draw {stuck}; one sync {sync_us:.1f} us on an idle card, x {leaves} leaves = "
          f"{1e-6 * sync_us * leaves / dt:.2%} of the wall; peak memory {peak / 2**30:.3f} GiB "
          f"[{card}]")
    finite = bool(torch.all(torch.isfinite(res.samples)))
    if not (finite and stuck == 0 and 0.5 <= post_acc <= 1.0):
        raise SmokeError(f"NUTS flagship: finite {finite}, {stuck} stuck chains, "
                         f"post-burn accept_prob {post_acc:.4f}")

    # 3. statistics: the correlated 2-D Gaussian of tests/test_nuts.py (64
    # chains x 200 kept: with fewer the means' error comes near the 0.1
    # gate), and the pooled dense warmup on a 64-D Gaussian
    cov2 = torch.tensor([[1.0, 0.9], [0.9, 1.0]], device=device)
    prec2 = torch.linalg.inv(cov2)
    cfg = NUTSConfig(num_samples=250, step_size=0.5, burn=50)
    t0 = time.perf_counter()
    res, _ = run_nuts_chains(24, lambda t: -0.5 * t @ prec2 @ t, torch.zeros(2, device=device),
                             cfg, 64)
    pooled = res.samples[:, 50:].reshape(-1, 2)
    mean_err = float(pooled.mean(0).abs().max())
    cov_err = float((torch.cov(pooled.T) - cov2).abs().max())
    print(f"run_nuts_chains correlated 2-D Gaussian, 64 chains x 250 draws (burn 50): mean "
          f"max_abs_err {mean_err:.4f} (tolerance 0.1), covariance {cov_err:.4f} (tolerance 0.12); "
          f"{time.perf_counter() - t0:.1f} s")
    prec = dense_precision(torch, 64, 2).to(device)
    cov = torch.linalg.inv(prec.double()).float()
    cfg = NUTSConfig(num_samples=310, step_size=0.1, burn=300, max_tree_depth=5,
                     adapt_mass="dense")
    t0 = time.perf_counter()
    res, info = run_nuts_ensemble(25, lambda t: -0.5 * t @ prec @ t,
                                  torch.zeros(64, device=device), cfg, 64)
    dense_err = float((res.final_warm[1][0] - cov).abs().max())
    print(f"run_nuts_ensemble 64-D Gaussian, 64 chains, adapt_mass='dense', burn 300 (pooled "
          f"windows [75, 100), [100, 150), [150, 250)): adapted inverse mass vs the covariance "
          f"max_abs_err {dense_err:.4f} (tolerance {DENSE_WARMUP_ATOL}); mean tree depth after "
          f"burn {float(info.tree_depth[300:].float().mean()):.3f}; "
          f"{time.perf_counter() - t0:.1f} s [{card}]")
    if not (mean_err <= 0.1 and cov_err <= 0.12 and dense_err <= DENSE_WARMUP_ATOL):
        raise SmokeError(f"NUTS statistics: mean {mean_err:.4f}, covariance {cov_err:.4f}, "
                         f"dense metric {dense_err:.4f}")

    # 4. the host offload: sample(store_on_GPU=False) and chunks of 7
    def lp3(t):
        return -0.5 * torch.sum((t / torch.tensor([0.5, 1.0, 2.0], device=t.device)) ** 2)

    kw = dict(num_samples=40, step_size=0.3, burn=10, sampler=Sampler.NUTS, key=26,
              verbose=False, debug=2)
    on_card, eps = sample(lp3, torch.zeros(3, device=device), **kw)
    offloaded, eps_off = sample(lp3, torch.zeros(3, device=device), store_on_GPU=False, **kw)
    cfg = NUTSConfig(num_samples=40, step_size=0.3, burn=10)
    chunked = run_nuts_host_offload(26, lp3, torch.zeros(3, device=device), cfg, chunk_size=7)
    direct, _ = run_nuts(26, lp3, torch.zeros(3, device=device), cfg)
    same = (torch.equal(offloaded, on_card.cpu()) and eps == eps_off
            and same_tensors(torch, chunked.samples, direct.samples)
            and same_tensors(torch, tuple(chunked.stats), tuple(direct.stats)))
    print(f"sample(sampler=NUTS, store_on_GPU=False) and run_nuts_host_offload in chunks of 7 "
          f"against the on-card run: identical {same}, offloaded samples on "
          f"{offloaded.device.type}")
    if not (same and offloaded.device.type == "cpu"):
        raise SmokeError("NUTS offload: the host trace is not the on-card trace")


def checkpoint_path(torch, device, card):
    """checkpoint.py on the card: each runner stopped part-way and resumed
    equals its straight run bit for bit (files in a temporary directory
    under the git-ignored build/)."""
    import dataclasses
    import tempfile

    from hamiltorch_tpu_torch import (
        MAMSConfig,
        MCLMCConfig,
        MCMCConfig,
        NUTSConfig,
        run_hmc_chains,
        run_mams,
        run_mclmc,
        run_nuts,
        run_nuts_ensemble,
    )
    from hamiltorch_tpu_torch import checkpoint as ck
    from hamiltorch_tpu_torch.models.flagship import make_flagship_potential

    (REPO / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        # the flagship: 64 chains x 10 draws x 50 steps at 2e-4, chunks of 4
        lp, theta0 = make_flagship_potential(device=device)
        cfg = MCMCConfig(num_samples=10, num_steps_per_sample=50, step_size=2e-4)
        want = run_hmc_chains(27, lp, theta0, cfg, FLAGSHIP["c"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ck.run_hmc_chains_checkpointed(27, lp, theta0, dataclasses.replace(cfg, num_samples=4),
                                       f"{tmp}/hmc", FLAGSHIP["c"], chunk_size=4)
        got = ck.run_hmc_chains_checkpointed(27, lp, theta0, cfg, f"{tmp}/hmc", FLAGSHIP["c"],
                                             chunk_size=4)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        size = sum(os.path.getsize(f"{tmp}/hmc/{f}") for f in os.listdir(f"{tmp}/hmc"))
        same = {"hmc_chains flagship": same_tensors(torch, got.samples, want.samples)
                and same_tensors(torch, tuple(got.stats), tuple(want.stats))
                and same_tensors(torch, tuple(got.final_state), tuple(want.final_state))}
        print(f"run_hmc_chains_checkpointed flagship {FLAGSHIP['c']} chains x 10 draws x 50 steps, "
              f"chunks of 4, stopped at 4 and resumed: {dt:.2f} s for both calls ({size / 2**20:.1f} "
              f"MiB of files) against run_hmc_chains; identical {same['hmc_chains flagship']} "
              f"[{card}]")

        # a small Gaussian with windowed diagonal warmup where the sampler has it
        scales = torch.tensor([1.0, 2.0, 0.5, 1.5], device=device)

        def lp4(t):
            return -0.5 * torch.sum((t / scales) ** 2) + 0.1 * torch.sum(torch.sin(t))

        x0 = torch.tensor([0.5, -0.3, 0.2, 0.8], device=device)
        # burn 160: slow windows end at draws 99 and 109, inside the chunks
        nuts_cfg = NUTSConfig(num_samples=120, step_size=0.4, burn=160, max_tree_depth=2,
                              adapt_mass="diag")
        cases = {
            "nuts": (lambda c: run_nuts(28, lp4, x0, c)[0],
                     lambda c, d: ck.run_nuts_checkpointed(28, lp4, x0, c, d, chunk_size=16),
                     nuts_cfg),
            "nuts_ensemble": (lambda c: run_nuts_ensemble(28, lp4, x0, c, 8),
                              lambda c, d: ck.run_nuts_ensemble_checkpointed(
                                  28, lp4, x0, c, d, 8, chunk_size=16), nuts_cfg),
            "mclmc": (lambda c: run_mclmc(28, lp4, x0, c),
                      lambda c, d: ck.run_mclmc_checkpointed(28, lp4, x0, c, d, chunk_size=16),
                      MCLMCConfig(num_samples=60, tune_steps=50)),
            "mams": (lambda c: run_mams(28, lp4, x0, c),
                     lambda c, d: ck.run_mams_checkpointed(28, lp4, x0, c, d, chunk_size=16),
                     MAMSConfig(num_samples=40, num_steps_per_sample=5, burn=20)),
        }
        for name, (straight, resumable, cfg) in cases.items():
            t0 = time.perf_counter()
            want = straight(cfg)
            resumable(dataclasses.replace(cfg, num_samples=cfg.num_samples // 2 + 3),
                      f"{tmp}/{name}")
            same[name] = same_tensors(torch, resumable(cfg, f"{tmp}/{name}"), want)
            print(f"{name}: checkpointed (stopped at {cfg.num_samples // 2 + 3} of "
                  f"{cfg.num_samples}, chunks of 16) against the straight run: identical "
                  f"{same[name]}; {time.perf_counter() - t0:.1f} s")
    if not all(same.values()):
        raise SmokeError(f"checkpoint: a resumed run differs from its straight run: {same}")


def quartic_gaussian(torch, d, seed, device, dtype):
    """bench.py's RMHMC target: a D-dim Gaussian whose precision has the
    eigenvalues logspace(-1, 1, D) under a random rotation (QR of a numpy
    normal matrix from ``seed``), minus 0.025 sum(theta^4), which keeps the
    metric position-dependent."""
    import numpy as np

    rng = np.random.RandomState(seed)
    q, _ = np.linalg.qr(rng.randn(d, d))
    prec = torch.as_tensor((q * np.logspace(-1.0, 1.0, d)) @ q.T, dtype=dtype, device=device)

    def lp(t):
        return -0.5 * t @ prec @ t - 0.025 * torch.sum(t ** 4)
    return lp


def banana_lp(t):
    """BASELINE config 3's banana: a curved ridge y ~ 0.1 (x^2 - 4)."""
    x, y = t[0], t[1]
    return -0.5 * (x ** 2 / 4.0) - 0.5 * ((y - 0.1 * (x ** 2 - 4.0)) ** 2) / 0.5


def rmhmc_path(torch, device, card):
    """Riemannian-manifold HMC (no kernel of its own: third-order AD through
    the Hessian, softabs and Cholesky, as in the JAX package): bench.py's
    batch-scale configuration timed, BASELINE config 3's banana with both
    integrators, card against CPU in float64 on injected noise for every
    integrator and metric, the softabs backward at repeated eigenvalues
    against a finite difference, a non-SPD metric rejected, and the host
    offload of ``sample``."""
    from hamiltorch_tpu_torch import Integrator, MCMCConfig, Metric, Sampler, run_rmhmc_chains
    from hamiltorch_tpu_torch import run_rmhmc, sample
    from hamiltorch_tpu_torch.ops import metrics

    d, chains, steps = RMHMC_DIM, RMHMC_CHAINS, RMHMC_STEPS
    lp = quartic_gaussian(torch, d, 3, device, torch.float32)
    rm_kw = dict(metric=Metric.SOFTABS, softabs_const=1e3, fixed_point_max_iterations=50)
    zeros = torch.zeros(d, device=device)

    def run(seed, draws):
        res = run_rmhmc_chains(seed, lp, zeros, MCMCConfig(num_samples=draws,
                                                           num_steps_per_sample=steps,
                                                           step_size=0.1), chains, **rm_kw)
        torch.cuda.synchronize()
        return res

    # 1. bench.py:377-401 (64 chains, L=5, step 0.1, SOFTABS 1e3, IMPLICIT, cap 50,
    # float32), RMHMC_DRAWS draws a run: a warm call, then the median of 3
    run(40, 1)
    torch.cuda.reset_peak_memory_stats()
    walls, results = [], []
    for rep in range(3):
        t0 = time.perf_counter()
        results.append(run(41 + rep, RMHMC_DRAWS))
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    wall = statistics.median(walls)
    iters = torch.cat([r.stats.fp_iters.reshape(-1).cpu() for r in results])
    acc = float(torch.stack([r.stats.accepted.float().mean() for r in results]).mean())
    # one iteration of each fixed point, at 64 chains: dH/dtheta (momentum
    # solve) and dH/dp (position solve)
    rm = metrics.batched(metrics.make_rm_hamiltonian(
        lp, metrics.RMOptions(metric=Metric.SOFTABS, softabs_const=1e3)), False)
    theta, p = results[-1].final_state.theta, torch.randn(chains, d, device=device)
    it_ms = {}
    for name in ("grad_theta", "grad_p"):
        fn = getattr(rm, name)
        fn(theta, p, None)
        ts = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(theta, p, None)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        it_ms[name] = statistics.median(ts)
    finite = all(bool(torch.isfinite(r.samples).all()) for r in results)
    print(f"rmhmc: run_rmhmc_chains D={d} quartic Gaussian, {chains} chains x {RMHMC_DRAWS} "
          f"draws x L={steps}, step 0.1, SOFTABS 1e3, IMPLICIT, float32: "
          f"{', '.join(f'{w:.2f}' for w in walls)} s (median {wall:.2f} s), "
          f"{chains * RMHMC_DRAWS * steps / wall:,.1f} grad-steps/s; fp_iters (max over a "
          f"draw's steps and solves) min {int(iters.min())} median {float(iters.median()):.0f} "
          f"max {int(iters.max())}, histogram {torch.bincount(iters).tolist()}; acceptance "
          f"{acc:.4f}; one fixed-point iteration at {chains} chains: {it_ms['grad_theta']:.2f} ms "
          f"(dH/dtheta, the momentum solve), {it_ms['grad_p']:.2f} ms (dH/dp, the position "
          f"solve); peak {peak / 2**30:.3f} GiB [{card}]")
    if not (finite and 0.0 < acc <= 1.0):
        raise SmokeError(f"rmhmc: finite {finite}, acceptance {acc}")

    # 2. BASELINE config 3: the banana, SOFTABS 1e2, L=6, step 0.15, 8 fixed-point
    # iterations at 1e-8, 64 chains, BANANA_DRAWS draws after BANANA_BURN
    for integrator in (Integrator.IMPLICIT, Integrator.EXPLICIT):
        t0 = time.perf_counter()
        res = run_rmhmc_chains(
            50, banana_lp, torch.zeros(2, device=device),
            MCMCConfig(num_samples=BANANA_BURN + BANANA_DRAWS, num_steps_per_sample=6,
                       step_size=0.15), 64, integrator=integrator, metric=Metric.SOFTABS,
            softabs_const=1e2, fixed_point_max_iterations=8, fixed_point_threshold=1e-8)
        kept = res.samples[:, BANANA_BURN:].reshape(-1, 2).cpu().double()
        resid = kept[:, 1] - 0.1 * (kept[:, 0] ** 2 - 4.0)
        acc = float(res.acc_rate.mean())
        finite = bool(torch.isfinite(res.samples).all())
        mean_x, std_r = float(kept[:, 0].mean()), float(resid.std())
        print(f"rmhmc banana {integrator.name}: 64 chains x {BANANA_BURN} + {BANANA_DRAWS} draws "
              f"x L=6: acceptance {acc:.4f}, mean x {mean_x:.4f}, ridge residual std {std_r:.4f}, "
              f"fp_iters max {int(res.stats.fp_iters.max())}; "
              f"{time.perf_counter() - t0:.1f} s [{card}]")
        if not (finite and acc > 0.5 and abs(mean_x) < 1.0 and std_r < 1.5):
            raise SmokeError(f"rmhmc banana {integrator.name}: finite {finite}, acceptance {acc}, "
                             f"mean x {mean_x}, residual std {std_r}")

    # 3. card against CPU, float64, injected noise, on the D=64 target
    c64, draws64 = 4, RMHMC_CPU_DRAWS
    gen = torch.Generator().manual_seed(43)
    noise = (torch.randn(draws64, c64, d, generator=gen, dtype=torch.float64),
             torch.rand(draws64, c64, generator=gen, dtype=torch.float64).log(),
             torch.rand(draws64, c64, d, generator=gen, dtype=torch.float64))
    cases = [(Integrator.IMPLICIT, Metric.SOFTABS), (Integrator.EXPLICIT, Metric.SOFTABS),
             (Integrator.MIDPOINT, Metric.SOFTABS), (Integrator.S3, Metric.SOFTABS),
             (Integrator.IMPLICIT, Metric.HESSIAN), (Integrator.IMPLICIT, Metric.JACOBIAN_DIAG)]
    t0 = time.perf_counter()
    worst = 0.0
    for integrator, metric in cases:
        # the Jacobian-diagonal metric diag(g^2) is near-singular where a
        # gradient entry is near 0: its momentum solve contracts only at a
        # small step (at 0.1 some lanes run to the cap, chaotic, and the card
        # and the CPU part by their rounding)
        jac = metric == Metric.JACOBIAN_DIAG
        cfg = MCMCConfig(num_samples=draws64, num_steps_per_sample=RMHMC_CPU_STEPS,
                         step_size=0.005 if jac else 0.1)
        jitter = 1.0 if jac else None

        def go(dev):
            return run_rmhmc_chains(
                44, quartic_gaussian(torch, d, 3, dev, torch.float64),
                torch.full((d,), 0.2, dtype=torch.float64, device=dev), cfg, c64,
                integrator=integrator, metric=metric, softabs_const=1e3, jitter=jitter,
                _noise=tuple(t.to(dev) for t in (noise if jitter else noise[:2])))

        on_card, on_host = go(device), go("cpu")
        same = (torch.equal(on_card.stats.accepted.cpu(), on_host.stats.accepted)
                and torch.equal(on_card.stats.fp_iters.cpu(), on_host.stats.fp_iters))
        scale = float(on_host.samples.abs().max())
        err = float((on_card.samples.cpu() - on_host.samples).abs().max()) / scale
        worst = max(worst, err)
        print(f"rmhmc float64 card vs CPU, {integrator.name} {metric.name}: accepts "
              f"{on_host.stats.accepted.float().mean():.3f}, fp_iters "
              f"{on_host.stats.fp_iters.reshape(-1).tolist()}, identical accepts and fp_iters "
              f"{same}, positions {err:.3e} of max |theta|")
        if not (same and err <= 1e-8):
            raise SmokeError(f"rmhmc card vs CPU {integrator.name} {metric.name}: identical "
                             f"{same}, error {err:.3e}")
    print(f"rmhmc card vs CPU: {len(cases)} cases, worst {worst:.3e}; "
          f"{time.perf_counter() - t0:.1f} s")

    # 4. the softabs backward on the card at exactly repeated eigenvalues
    # against a central difference in float64
    g64 = torch.Generator().manual_seed(45)
    a = torch.diag(torch.tensor([2.0, 2.0, 2.0, -1.0, 0.5], dtype=torch.float64)).to(device)
    w = torch.randn(5, 5, generator=g64, dtype=torch.float64).to(device)
    e = torch.randn(5, 5, generator=g64, dtype=torch.float64).to(device)
    e = 0.5 * (e + e.T)

    def loss(m):
        g, lam = metrics.softabs_transform(m, 10.0)
        return (g * w).sum() + torch.log(lam).sum()

    grad = torch.func.vmap(torch.func.grad(loss))(a[None])[0]
    h = 1e-6
    fd = float((loss(a + h * e) - loss(a - h * e)) / (2 * h))
    ad = float((grad * e).sum())
    eigh_grad = torch.func.grad(lambda m: torch.linalg.eigh(m)[1].sum())(a)
    print(f"softabs backward on the card at eigenvalues (2, 2, 2, -1, 0.5), vmap over grad: "
          f"finite {bool(torch.isfinite(grad).all())}, directional derivative {ad:.12f} against "
          f"the central difference {fd:.12f} (diff {abs(ad - fd):.3e}); eigh's own backward "
          f"finite: {bool(torch.isfinite(eigh_grad).all())}")
    if not (bool(torch.isfinite(grad).all()) and abs(ad - fd) <= 1e-6 * max(1.0, abs(fd))):
        raise SmokeError(f"softabs backward on the card: {ad} against {fd}")

    # 5. a HESSIAN metric that is not SPD (the funnel away from its mode): NaN, a divergence
    def funnel(t):
        v, x = t[0], t[1:]
        return -0.5 * v ** 2 / 9.0 - 0.5 * torch.sum(x ** 2) * torch.exp(-v) - 2.0 * v

    bad = torch.tensor([-1.0, 2.0, 0.5, -1.5, 1.0], device=device)
    res = run_rmhmc(46, funnel, bad, MCMCConfig(num_samples=3, num_steps_per_sample=2,
                                                step_size=0.1),
                    metric=Metric.HESSIAN, fixed_point_max_iterations=3)
    rejected = bool(res.stats.divergent.all()) and not bool(res.stats.accepted.any())
    print(f"rmhmc HESSIAN metric on the funnel at {bad.tolist()} (not SPD): energies "
          f"{res.stats.energy_old.tolist()}, every draw divergent and rejected {rejected}")
    if not (rejected and torch.equal(res.samples[-1], bad)):
        raise SmokeError("rmhmc: a non-SPD metric was not rejected as a divergence")

    # 6. sample(sampler=RMHMC): store_on_GPU=False gives the on-card trace
    kw = dict(num_samples=4, num_steps_per_sample=3, step_size=0.15, burn=1,
              sampler=Sampler.RMHMC, integrator=Integrator.IMPLICIT, metric=Metric.SOFTABS,
              softabs_const=1e2, fixed_point_max_iterations=8, key=47, verbose=False)
    on_card = sample(banana_lp, torch.zeros(2, device=device), **kw)
    offloaded = sample(banana_lp, torch.zeros(2, device=device), store_on_GPU=False, **kw)
    same = offloaded.device.type == "cpu" and torch.equal(on_card.cpu(), offloaded)
    print(f"sample(sampler=RMHMC) banana, store_on_GPU=False vs True: identical {same}")
    if not same:
        raise SmokeError("sample(sampler=RMHMC): the offloaded trace differs")


def mnist_split_model(torch, device):
    """BASELINE config 5 (``examples/mnist_scale_split_hmc.py``) at its
    widths: a 784-256-10 tanh ``nn.Sequential`` (seed 0) on 6,000
    MNIST-shaped rows (10 numpy prototypes + 0.5 noise, seed 0) in 6 splits.
    Returns (net, loss, batches, splits, term_fn, num_terms, flat start,
    stacked data) of ``define_split_model_log_prob`` on ``device``."""
    import numpy as np
    from torch import nn

    from hamiltorch_tpu_torch.models.bnn import define_split_model_log_prob

    rng = np.random.RandomState(0)
    prototypes = rng.randn(10, 784).astype(np.float32)
    labels = rng.randint(0, 10, 6000)
    x = (prototypes[labels] + 0.5 * rng.randn(6000, 784)).astype(np.float32)
    splits = 6
    batches = [(x[i::splits], labels[i::splits].astype(np.float32)) for i in range(splits)]
    torch.manual_seed(0)
    net = nn.Sequential(nn.Linear(784, 256), nn.Tanh(), nn.Linear(256, 10))
    loss = "multi_class_linear_output"
    term_fn, m_terms, flat, _, data = define_split_model_log_prob(
        net, loss, batches, splits, tau_out=1.0, verbose=False, device=device)
    return net, loss, batches, splits, term_fn, m_terms, flat, data


def regression_bnn(torch, dtype):
    """The regression BNN of ``examples/sgld_bnn_example.py`` (and
    ``split_hmc_bnn_example.py``): a 1-100-100-1 tanh ``nn.Sequential``
    (seed 1) on 400 points of sin(4x) + 0.1 noise (seed 0) in 4 splits of
    100, tau_out 100.  Returns (net, batches)."""
    import numpy as np
    from torch import nn

    rng = np.random.RandomState(0)
    xr = np.linspace(-1, 1, 400)[:, None]
    yr = np.sin(4 * xr) + 0.1 * rng.randn(*xr.shape)
    batches = [(xr[i::4], yr[i::4]) for i in range(4)]
    torch.manual_seed(1)
    net = nn.Sequential(nn.Linear(1, 100), nn.Tanh(), nn.Linear(100, 100), nn.Tanh(),
                        nn.Linear(100, 1)).to(dtype)
    return net, batches


def split_path(torch, device, card):
    """Symmetric-split minibatch HMC (no kernel of its own): BASELINE config
    5 (``examples/mnist_scale_split_hmc.py``) at its widths, the split terms
    against the full-data potential, timed; SPLITTING_RAND and SPLITTING_KMID
    on the regression BNN of ``examples/split_hmc_bnn_example.py``, card
    against CPU on injected noise; the offloaded and checkpointed runners
    against the straight run."""
    import dataclasses
    import tempfile

    from hamiltorch_tpu_torch import Integrator, MCMCConfig, sample_split_model
    from hamiltorch_tpu_torch import checkpoint as ck
    from hamiltorch_tpu_torch.models.bnn import define_model_log_prob, define_split_model_log_prob
    from hamiltorch_tpu_torch.samplers import (
        run_split_hmc_host_offload,
        run_split_hmc_stacked,
    )

    # 1. MNIST-shaped data, 6 splits
    net, loss, batches, splits, term_fn, m_terms, flat, data = mnist_split_model(torch, device)
    dims = flat.numel()
    xs, ys = (t.reshape((-1,) + tuple(t.shape[2:])) for t in data)
    full, _, _ = define_model_log_prob(net, loss, xs, ys, tau_out=1.0, device=device)
    theta = flat + 0.01 * torch.randn(dims, generator=torch.Generator().manual_seed(51)).to(device)
    g_full, v_full = torch.func.grad_and_value(full)(theta)
    v_sum = sum(term_fn(theta, m, data) for m in range(m_terms))
    g_sum = sum(torch.func.grad(lambda t, m=m: term_fn(t, m, data))(theta) for m in range(m_terms))
    v_err = abs(float(v_sum - v_full)) / abs(float(v_full))
    g_err = float((g_sum - g_full).abs().max()) / float(g_full.abs().max())
    print(f"split: nn.Sequential 784-256-10 tanh ({dims:,} parameters), {m_terms} terms of "
          f"{data[0].shape[1]} rows: the terms' sum {float(v_sum):.6f} against "
          f"define_model_log_prob on all {xs.shape[0]} rows {float(v_full):.6f} ({v_err:.3e} "
          f"relative), gradient {g_err:.3e} of max |g|")
    if not (v_err <= SPLIT_RTOL and g_err <= SPLIT_RTOL):
        raise SmokeError(f"split: the terms do not sum to the full potential: {v_err:.3e}, "
                         f"{g_err:.3e}")

    # 2. timed: run_split_hmc_stacked, SPLITTING, step 2e-4, L=10, SPLIT_DRAWS draws
    cfg = MCMCConfig(num_samples=SPLIT_DRAWS, num_steps_per_sample=10, step_size=2e-4)
    run_split_hmc_stacked(52, term_fn, m_terms, flat, dataclasses.replace(cfg, num_samples=1),
                          data=data)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls, res = [], None
    for rep in range(3):
        t0 = time.perf_counter()
        res = run_split_hmc_stacked(53 + rep, term_fn, m_terms, flat, cfg, data=data)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    per_draw = 10 * 2 * m_terms
    finite = bool(torch.isfinite(res.samples).all())
    print(f"split: run_split_hmc_stacked SPLITTING, {SPLIT_DRAWS} draws x L=10, step 2e-4, one "
          f"chain: {', '.join(f'{w:.2f}' for w in walls)} s (median {wall:.2f} s), "
          f"{SPLIT_DRAWS / wall:.2f} draws/s, {SPLIT_DRAWS * per_draw / wall:,.1f} "
          f"term-gradients/s ({per_draw} a draw); acceptance {float(res.acc_rate):.3f}; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB [{card}]")
    if not (finite and float(res.acc_rate) > 0.0):
        raise SmokeError(f"split: finite {finite}, acceptance {float(res.acc_rate)}")
    t0 = time.perf_counter()
    samples = sample_split_model(net, batches, num_splits=splits, model_loss=loss,
                                 num_samples=4, num_steps_per_sample=10, step_size=2e-4,
                                 tau_out=1.0, key=54, verbose=False, device=device)
    print(f"split: sample_split_model 4 draws: {tuple(samples.shape)} on {samples.device}, "
          f"finite {bool(torch.isfinite(samples).all())}; {time.perf_counter() - t0:.2f} s")
    if not (samples.device == theta.device and bool(torch.isfinite(samples).all())):
        raise SmokeError("split: sample_split_model's draws are not finite on the card")

    # 3. the regression BNN of examples/split_hmc_bnn_example.py (step 5e-4),
    # float64 card vs CPU
    reg, reg_batches = regression_bnn(torch, torch.float64)
    reg_cfg = MCMCConfig(num_samples=4, num_steps_per_sample=10, step_size=5e-4)

    def reg_terms(dev):
        return define_split_model_log_prob(reg, "regression", reg_batches, 4, tau_out=100.0,
                                           verbose=False, device=dev)

    rdims = reg_terms("cpu")[2].numel()
    gen = torch.Generator().manual_seed(55)
    noise = (torch.randn(4, 1, rdims, generator=gen, dtype=torch.float64),
             torch.rand(4, 1, generator=gen, dtype=torch.float64).log(),
             torch.stack([torch.randperm(4, generator=gen) for _ in range(4)])[:, None])
    for integrator in (Integrator.SPLITTING_RAND, Integrator.SPLITTING_KMID):
        out = {}
        for dev in (device, "cpu"):
            fn, m, flat_r, _, data_r = reg_terms(dev)
            out[dev if dev == "cpu" else "card"] = run_split_hmc_stacked(
                56, fn, m, flat_r, reg_cfg, integrator=integrator, data=data_r,
                _noise=tuple(t[:, 0].to(dev) for t in noise))
        same = torch.equal(out["card"].stats.accepted.cpu(), out["cpu"].stats.accepted)
        scale = float(out["cpu"].samples.abs().max())
        err = float((out["card"].samples.cpu() - out["cpu"].samples).abs().max()) / scale
        finite = bool(torch.isfinite(out["card"].samples).all())
        print(f"split regression BNN ({rdims} parameters) {integrator.name}, float64 card vs CPU "
              f"on the same noise: accepts {out['cpu'].stats.accepted.tolist()}, identical {same}, "
              f"positions {err:.3e} of max |theta|, finite {finite}")
        if not (same and finite and err <= 1e-8):
            raise SmokeError(f"split {integrator.name} card vs CPU: identical {same}, error {err}")

    # 4. the offloaded and checkpointed runners against the straight run (float32)
    fn, m, flat_r, _, data_r = define_split_model_log_prob(
        reg.float(), "regression", reg_batches, 4, tau_out=100.0, verbose=False, device=device)
    cfg = MCMCConfig(num_samples=9, num_steps_per_sample=5, step_size=5e-4)
    kw = dict(integrator=Integrator.SPLITTING_RAND, data=data_r)
    want = run_split_hmc_stacked(57, fn, m, flat_r, cfg, **kw)
    off = run_split_hmc_host_offload(57, fn, m, flat_r, cfg, chunk_size=4, **kw)
    (REPO / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        ck.run_split_hmc_checkpointed(57, fn, m, flat_r, dataclasses.replace(cfg, num_samples=5),
                                      tmp, chunk_size=3, **kw)
        resumed = ck.run_split_hmc_checkpointed(57, fn, m, flat_r, cfg, tmp, chunk_size=3, **kw)
    same_off = torch.equal(off.samples, want.samples.cpu()) and all(
        torch.equal(a, b.cpu()) for a, b in zip(off.stats, want.stats))
    same_ck = same_tensors(torch, resumed.samples, want.samples) and same_tensors(
        torch, tuple(resumed.stats), tuple(want.stats))
    print(f"split SPLITTING_RAND: host offload (chunks of 4) identical {same_off}; checkpointed "
          f"(stopped at 5, chunks of 3) identical {same_ck}")
    if not (same_off and same_ck):
        raise SmokeError(f"split: offload identical {same_off}, checkpoint identical {same_ck}")


def ess_quantiles(torch, samples, seed=1234):
    """(min, 10th percentile) ESS of a (C, N, D) trace over its first 64
    coordinates and 32 random unit projections (bench.py's
    ``ess_quantiles``)."""
    from hamiltorch_tpu_torch.diagnostics import effective_sample_size

    gen = torch.Generator().manual_seed(seed)
    dirs = torch.randn(samples.shape[-1], 32, generator=gen).to(samples.device)
    dirs = dirs / dirs.norm(dim=0)
    ess = torch.cat([effective_sample_size(samples[:, :, :64]).reshape(-1),
                     effective_sample_size(samples @ dirs).reshape(-1)]).double().cpu()
    return float(ess.min()), float(torch.quantile(ess, 0.1))


def idle_sync_us(torch, device) -> float:
    """The median time of one device-to-host read of a flag on an idle card."""
    flag = torch.zeros(1, dtype=torch.bool, device=device)
    bool(flag.any())
    times = []
    for _ in range(200):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bool(flag.any())
        times.append(1e6 * (time.perf_counter() - t0))
    return statistics.median(times)


def chees_path(torch, device, card):
    """ChEES-HMC (no kernel of its own: it evaluates the generic potential,
    as the JAX package's does): bench.py's ChEES configuration on the
    flagship at 64 chains, timed in grad-steps/s and min-ESS/s; the
    correlated 2-D Gaussian of ``tests/test_chees.py``; float64 card against
    CPU on injected noise; ``run_chees_checkpointed`` stopped and resumed."""
    import dataclasses
    import tempfile

    from hamiltorch_tpu_torch import ChEESConfig, run_chees
    from hamiltorch_tpu_torch import checkpoint as ck
    from hamiltorch_tpu_torch.models.flagship import make_flagship_potential
    from hamiltorch_tpu_torch.samplers.chees import _run_chees, prepare_chees
    from hamiltorch_tpu_torch.samplers.warmup import schedule_flags

    # 1. the flagship: a warmup chunk thinned to one row, then a sampling
    # chunk resumed from its carry (bench.py's two chunks)
    lp, theta0 = make_flagship_potential(device=device)
    calls = [0]

    def counted(theta):  # one call a batched gradient (vmap runs it once)
        calls[0] += 1
        return lp(theta)

    cfg = ChEESConfig(num_samples=CHEES_WARMUP + CHEES_SAMPLING, step_size=2e-4,
                      burn=CHEES_WARMUP, adapt_mass=True, init_trajectory_length=0.01)
    cfg_warm = dataclasses.replace(cfg, num_samples=CHEES_WARMUP, thin=CHEES_WARMUP)
    cfg_samp = dataclasses.replace(cfg, num_samples=CHEES_SAMPLING, thin=1)
    thetas0, mass = prepare_chees(20260819, theta0, cfg, CHEES_CHAINS)
    cf_w, ef_w = schedule_flags(cfg.burn, 0, CHEES_WARMUP)
    cf_s, ef_s = schedule_flags(cfg.burn, CHEES_WARMUP, CHEES_SAMPLING)
    # untimed: the first calls of this path in the process
    _run_chees(20260819, thetas0, lp, dataclasses.replace(cfg, num_samples=2, burn=0), mass)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    warm = _run_chees(20260820, thetas0, counted, cfg_warm, mass, collect_flags=cf_w,
                      end_flags=ef_w)
    torch.cuda.synchronize()
    wall_w, grads_w = time.perf_counter() - t0, calls[0] - 1
    calls[0] = 0
    t0 = time.perf_counter()
    res = _run_chees(20260821, warm.final_carry.thetas, counted, cfg_samp, mass,
                     init_carry=warm.final_carry, start_iter=CHEES_WARMUP, collect_flags=cf_s,
                     end_flags=ef_s)
    torch.cuda.synchronize()
    wall_s, grads_s = time.perf_counter() - t0, calls[0]
    peak = torch.cuda.max_memory_allocated()
    used = int(res.info.num_leapfrog.sum())
    sync_us = idle_sync_us(torch, device)
    ess_min, ess_p10 = ess_quantiles(torch, res.samples)
    eps, traj = float(res.final_step_size), float(res.final_trajectory_length)
    acc = float(res.info.accept_prob.mean())
    metric = res.final_carry.metric
    print(f"chees: flagship ({theta0.numel():,} parameters) {CHEES_CHAINS} chains, step 2e-4, "
          f"T0 0.01, adapt_mass diag: warmup chunk {CHEES_WARMUP} draws (thin "
          f"{CHEES_WARMUP}) {wall_w:.2f} s, {grads_w} batched gradients = "
          f"{grads_w * CHEES_CHAINS / wall_w:,.1f} grad-steps/s; sampling chunk "
          f"{CHEES_SAMPLING} draws {wall_s:.2f} s, L per draw "
          f"{res.info.num_leapfrog.tolist()} (sum {used}, {grads_s} batched gradients), "
          f"{used * CHEES_CHAINS / wall_s:,.1f} grad-steps/s; one sync {sync_us:.1f} us on an "
          f"idle card x {CHEES_WARMUP + CHEES_SAMPLING} draws = "
          f"{1e-6 * sync_us * (CHEES_WARMUP + CHEES_SAMPLING) / (wall_w + wall_s):.3%} of the "
          f"wall; final eps {eps:.6g}, T {traj:.6g}; mean post-burn accept_prob {acc:.4f}; "
          f"min-ESS {ess_min:.1f} (p10 {ess_p10:.1f}) over {CHEES_SAMPLING} draws: "
          f"chees_min_ess_per_sec {ess_min / wall_s:.2f} (p10 {ess_p10 / wall_s:.2f}); "
          f"adapted inverse mass median {float(metric.median()):.4g}; peak memory "
          f"{peak / 2**30:.3f} GiB [{card}]")
    finite = bool(torch.isfinite(res.samples).all()) and bool(
        torch.isfinite(warm.samples).all())
    capped = int(res.info.num_leapfrog.max()) <= cfg.max_leapfrog_steps and int(
        warm.info.num_leapfrog.max()) <= cfg.max_leapfrog_steps
    if not (finite and capped and 0 < eps < float("inf") and 0 < traj < float("inf")
            and grads_s == used):
        raise SmokeError(f"ChEES flagship: finite {finite}, capped {capped}, eps {eps}, T {traj}, "
                         f"{grads_s} gradients for {used} leapfrogs")

    # 2. the correlated 2-D Gaussian of tests/test_chees.py: its moments
    # (1200 draws, burn 500, step 0.3) and its acceptance (1000 draws, burn
    # 600, step 1.5: 0.45 < mean accept_prob after 700 < 0.9), 16 chains
    cov = torch.tensor([[1.0, 0.7], [0.7, 1.0]], device=device)
    prec = torch.linalg.inv(cov)
    t0 = time.perf_counter()
    mom = run_chees(31, lambda t: -0.5 * t @ prec @ t, torch.zeros(2, device=device),
                    ChEESConfig(num_samples=1200, step_size=0.3, burn=500), num_chains=16)
    pooled = mom.samples[:, 600:].reshape(-1, 2)
    mean_err = float(pooled.mean(0).abs().max())
    cov_err = float((torch.cov(pooled.T) - cov).abs().max())
    accr = run_chees(32, lambda t: -0.5 * t @ prec @ t, torch.zeros(2, device=device),
                     ChEESConfig(num_samples=1000, step_size=1.5, burn=600), num_chains=16)
    post = float(accr.info.accept_prob[700:].mean())
    print(f"chees: correlated 2-D Gaussian, 16 chains: mean max_abs_err {mean_err:.4f} "
          f"(tolerance 0.1), covariance {cov_err:.4f} (0.12); step 1.5 run post-burn "
          f"accept_prob {post:.4f} (0.45-0.9); {time.perf_counter() - t0:.1f} s [{card}]")
    if not (mean_err <= 0.1 and cov_err <= 0.12 and 0.45 < post < 0.9):
        raise SmokeError(f"ChEES Gaussian: mean {mean_err:.4f}, covariance {cov_err:.4f}, "
                         f"acceptance {post:.4f}")

    # 3. float64 card against CPU on the same injected noise (burn 150: one
    # slow window, diagonal warmup), 8 chains on a 4-D non-Gaussian target
    gen = torch.Generator().manual_seed(33)
    f64 = dict(generator=gen, dtype=torch.float64)
    noise = (torch.randn(160, 8, 4, **f64), torch.rand(160, 8, **f64).log(),
             torch.rand(160, **f64))
    start = torch.randn(8, 4, **f64)
    scales = torch.tensor([1.0, 1.5, 0.8, 1.2], dtype=torch.float64)
    cfg64 = ChEESConfig(num_samples=160, step_size=0.1, burn=150, adapt_mass="diag",
                        desired_accept_rate=0.95)

    def run64(dev):
        sc = scales.to(dev)
        return run_chees(0, lambda t: -0.5 * torch.sum((t / sc) ** 2) + 0.05 * torch.sum(
            torch.sin(t)), start.to(dev), cfg64, 8, _noise=tuple(t.to(dev) for t in noise))

    card64, host64 = run64(device), run64("cpu")
    same_l = torch.equal(card64.info.num_leapfrog.cpu(), host64.info.num_leapfrog)
    moved = lambda s: (s[:, 1:] != s[:, :-1]).any(dim=-1)  # noqa: E731
    same_acc = torch.equal(moved(card64.samples.cpu()), moved(host64.samples))
    scale = float(host64.samples.abs().max())
    err = float((card64.samples.cpu() - host64.samples).abs().max()) / scale
    print(f"chees: float64 card vs CPU on the same noise, 8 chains x 160 draws (burn 150, "
          f"diag): leapfrog counts identical {same_l}, accepts identical {same_acc}, positions "
          f"{err:.3e} of max |theta|")
    if not (same_l and same_acc and err <= 1e-8):
        raise SmokeError(f"ChEES card vs CPU: L {same_l}, accepts {same_acc}, error {err:.3e}")

    # 4. run_chees_checkpointed stopped at 90 draws, resumed to 170 (chunks
    # of 16; burn 160 puts the slow window across chunks)
    lp4 = lambda t: -0.5 * torch.sum((t / scales.to(t))**2)  # noqa: E731
    ck_cfg = ChEESConfig(num_samples=170, step_size=0.3, burn=160, adapt_mass="diag")
    want = run_chees(34, lp4, torch.zeros(4, device=device), ck_cfg, 8)
    (REPO / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        ck.run_chees_checkpointed(34, lp4, torch.zeros(4, device=device),
                                  dataclasses.replace(ck_cfg, num_samples=90), tmp, 8,
                                  chunk_size=16)
        got = ck.run_chees_checkpointed(34, lp4, torch.zeros(4, device=device), ck_cfg, tmp, 8,
                                        chunk_size=16)
    same = same_tensors(torch, got.samples, want.samples) and same_tensors(
        torch, tuple(got.info), tuple(want.info)) and same_tensors(
        torch, got.final_step_size, want.final_step_size)
    print(f"chees: run_chees_checkpointed (stopped at 90, chunks of 16) identical {same}")
    if not same:
        raise SmokeError("ChEES: the checkpointed run is not the straight run")


def sgmcmc_path(torch, device, card):
    """SG-MCMC (no kernel of its own): SGLD, pSGLD, SGHMC and cSGLD on
    BASELINE config 5 at one chain and ``run_sgld_chains`` at 8, timed; the
    noisy-gradient Gaussian recovery of ``tests/test_sgmcmc.py``; float64
    card against CPU on the regression BNN of ``examples/sgld_bnn_example.py``;
    checkpointed SGLD and SGHMC against their straight runs."""
    import dataclasses
    import tempfile

    from hamiltorch_tpu_torch import (
        CSGMCMCConfig,
        SGHMCConfig,
        SGLDConfig,
        run_csgmcmc,
        run_sghmc,
        run_sgld,
        run_sgld_chains,
    )
    from hamiltorch_tpu_torch import checkpoint as ck
    from hamiltorch_tpu_torch.models.bnn import define_split_model_log_prob

    # 1. BASELINE config 5: one chain of each sampler, then 8 SGLD chains
    _, _, _, _, term_fn, m_terms, flat, data = mnist_split_model(torch, device)
    evals = [0]

    def counted(theta, m, d):  # one call a vmapped term gradient
        evals[0] += 1
        return term_fn(theta, m, d)

    runs = {
        "SGLD": (run_sgld, SGLDConfig(num_samples=SG_STEPS, step_size=1e-6, thin=10)),
        "pSGLD": (run_sgld, SGLDConfig(num_samples=SG_STEPS, step_size=1e-6, thin=10,
                                       preconditioner="rmsprop")),
        "SGHMC": (run_sghmc, SGHMCConfig(num_samples=SG_STEPS, step_size=1e-6, thin=10)),
        "cSGLD": (run_csgmcmc, CSGMCMCConfig(num_cycles=2, cycle_length=SG_STEPS // 2,
                                             step_size=1e-6, exploration_frac=0.5, thin=5)),
    }
    run_sgld(40, term_fn, m_terms, flat, SGLDConfig(num_samples=2, step_size=1e-6), data=data)
    for i, (name, (run, cfg)) in enumerate(runs.items()):
        evals[0] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run(41 + i, counted, m_terms, flat, cfg, data=data)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        finite = bool(torch.isfinite(res.samples).all())
        rejected = int(res.stats.divergent.sum())
        print(f"sgmcmc: {name} one chain, {SG_STEPS} steps on 784-256-10 ({flat.numel():,} "
              f"parameters, {m_terms} terms of {data[0].shape[1]} rows): {wall:.3f} s, "
              f"{SG_STEPS / wall:,.1f} steps/s, {evals[0] / wall:,.1f} term-gradients/s "
              f"({1e3 * wall / SG_STEPS:.2f} ms a step); kept {tuple(res.samples.shape)}, "
              f"grad norm at the last kept step {float(res.stats.grad_norm[-1]):.4g}, finite "
              f"{finite}, rejected steps {rejected} [{card}]")
        if not (finite and rejected == 0):
            raise SmokeError(f"SG-MCMC {name}: finite {finite}, {rejected} rejected steps")
    evals[0] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_sgld_chains(45, counted, m_terms, flat, SGLDConfig(num_samples=SG_STEPS,
                                                                step_size=1e-6, thin=10),
                          SG_CHAINS, data=data)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    finite, rejected = bool(torch.isfinite(res.samples).all()), int(res.stats.divergent.sum())
    print(f"sgmcmc: run_sgld_chains {SG_CHAINS} chains x {SG_STEPS} steps: {wall:.3f} s, "
          f"{SG_STEPS / wall:,.1f} steps/s ({SG_CHAINS * SG_STEPS / wall:,.1f} chain-steps/s), "
          f"{evals[0]} grouped term-gradient calls for {SG_CHAINS * SG_STEPS} chain "
          f"gradients ({SG_CHAINS * SG_STEPS / wall:,.1f} term-gradients/s); finite {finite}, "
          f"rejected steps {rejected} [{card}]")
    if not (finite and rejected == 0):
        raise SmokeError(f"SG-MCMC chains: finite {finite}, {rejected} rejected steps")

    # 2. tests/test_sgmcmc.py's noisy-gradient Gaussian: 8000 SGLD steps,
    # inv_mass = S2, pooled means after 2000 within 0.15
    mu = torch.tensor([1.0, -2.0, 0.5], device=device)
    s2 = torch.tensor([0.5, 1.0, 2.0], device=device)
    centres = mu + torch.tensor([[1.0, -1.0, 0.5], [-1.0, 1.0, -0.5], [0.5, 0.5, 1.0],
                                 [-0.5, -0.5, -1.0]], device=device)
    t0 = time.perf_counter()
    gauss = run_sgld_chains(46, lambda t, m: -0.125 * torch.sum((t - centres[m]) ** 2 / s2), 4,
                            mu, SGLDConfig(num_samples=SG_RECOVERY_STEPS, step_size=0.02),
                            SG_RECOVERY_CHAINS, inv_mass=s2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    pooled = gauss.samples[:, 2000:].reshape(-1, 3)
    mean_err = float((pooled.mean(0) - mu).abs().max())
    print(f"sgmcmc: noisy-gradient Gaussian, {SG_RECOVERY_CHAINS} chains x {SG_RECOVERY_STEPS} "
          f"SGLD steps: "
          f"{wall:.1f} s ({1e3 * wall / SG_RECOVERY_STEPS:.3f} ms a step); pooled mean "
          f"max_abs_err {mean_err:.4f} (tolerance 0.15), stds "
          f"{[round(v, 3) for v in pooled.std(0).tolist()]} (target "
          f"{[round(v, 3) for v in s2.sqrt().tolist()]}) [{card}]")
    if not (mean_err <= 0.15 and not bool(gauss.stats.divergent.any())):
        raise SmokeError(f"SG-MCMC Gaussian: mean error {mean_err:.4f}")

    # 3. the regression BNN of examples/sgld_bnn_example.py in float64: card
    # against CPU on the same normals; the terms come from the host hash on
    # both and are recorded by the term function
    reg, batches = regression_bnn(torch, torch.float64)
    steps = 10

    def reg_run(dev, run, cfg):
        fn, m, start, _, d = define_split_model_log_prob(reg, "regression", batches, 4,
                                                         tau_out=100.0, verbose=False,
                                                         device=dev)
        seen = []

        def rec(theta, k, data_):
            seen.append(k)
            return fn(theta, k, data_)

        gen = torch.Generator().manual_seed(47)
        z = torch.randn(steps, start.numel(), generator=gen, dtype=torch.float64).to(dev)
        from hamiltorch_tpu_torch.utils.rng import sg_term_indices

        idx = torch.tensor([sg_term_indices(48, g, 1, m)[0] for g in range(steps)])
        return run(48, rec, m, start, cfg, data=d, _noise={"m": idx, "z": z, "fresh": z}), seen

    for name, run, cfg in (("SGLD", run_sgld, SGLDConfig(num_samples=steps, step_size=2e-6)),
                           ("SGHMC", run_sghmc, SGHMCConfig(num_samples=steps, step_size=2e-6,
                                                            resample_momentum_every=4))):
        (card_r, seen_c), (host_r, seen_h) = reg_run(device, run, cfg), reg_run("cpu", run, cfg)
        scale = float(host_r.samples.abs().max())
        err = float((card_r.samples.cpu() - host_r.samples).abs().max()) / scale
        print(f"sgmcmc: {name} regression BNN float64, card vs CPU on the same normals: terms "
              f"{seen_c}, identical {seen_c == seen_h}; positions {err:.3e} of max |theta|")
        if not (seen_c == seen_h and err <= 1e-8):
            raise SmokeError(f"SG-MCMC {name} card vs CPU: terms {seen_c == seen_h}, "
                             f"error {err:.3e}")

    # 4. checkpointed SGLD and SGHMC (float32, stopped at 6 of 12 steps,
    # chunks of 4) against their straight runs
    fn, m, start, _, d = define_split_model_log_prob(reg.float(), "regression", batches, 4,
                                                     tau_out=100.0, verbose=False, device=device)
    (REPO / "build").mkdir(exist_ok=True)
    for name, run, run_ck, cfg in (
            ("SGLD", run_sgld, ck.run_sgld_checkpointed,
             SGLDConfig(num_samples=12, step_size=2e-6, thin=2)),
            ("SGHMC", run_sghmc, ck.run_sghmc_checkpointed,
             SGHMCConfig(num_samples=12, step_size=2e-6, thin=2, resample_momentum_every=5))):
        want = run(49, fn, m, start, cfg, data=d)
        with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
            run_ck(49, fn, m, start, dataclasses.replace(cfg, num_samples=6), tmp, chunk_size=4,
                   data=d)
            got = run_ck(49, fn, m, start, cfg, tmp, chunk_size=4, data=d)
        same = same_tensors(torch, got.samples, want.samples) and same_tensors(
            torch, tuple(got.stats), tuple(want.stats)) and same_tensors(
            torch, got.final_aux, want.final_aux)
        print(f"sgmcmc: {name} checkpointed (stopped at 6, chunks of 4) identical {same}")
        if not same:
            raise SmokeError(f"SG-MCMC {name}: the checkpointed run is not the straight run")


def tempering_path(torch, device, card):
    """Parallel tempering (no kernel of its own: it evaluates the generic
    potential, as the JAX package's does): ``run_pt_chains`` on the flagship
    at the main path's 64 chains (8 ladders of 8 replicas), timed in
    grad-steps/s; the bimodal mixture and the cross-ensemble R-hat of
    ``tests/test_tempering.py``; float64 card against CPU on injected noise;
    ``run_pt_checkpointed`` on the flagship, one ladder and ensembles."""
    import dataclasses
    import tempfile

    from hamiltorch_tpu_torch import PTConfig, run_parallel_tempering, run_pt_chains
    from hamiltorch_tpu_torch import checkpoint as ck
    from hamiltorch_tpu_torch.diagnostics import potential_scale_reduction
    from hamiltorch_tpu_torch.models.flagship import make_flagship_potential

    # 1. the flagship: E ladders of K replicas as one batch of E*K lanes
    lp, theta0 = make_flagship_potential(device=device)
    cfg = PTConfig(num_samples=PT_DRAWS, num_steps_per_sample=10, step_size=2e-4,
                   num_temps=PT_TEMPS, max_temp=30.0, burn=PT_BURN, adapt_ladder=True,
                   adapt_step_size=True)
    lanes = PT_ENSEMBLES * PT_TEMPS
    # untimed: the first calls of this path in the process
    run_pt_chains(1, lp, theta0, dataclasses.replace(cfg, num_samples=2, burn=1), PT_ENSEMBLES)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = run_pt_chains(20261017, lp, theta0, cfg, PT_ENSEMBLES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    betas = res.info.betas.double().cpu()  # (E, K)
    swap = res.info.swap_accept.float().mean(dim=(0, 1)).cpu()  # per pair, post-burn
    acc = res.info.accept_prob.float().mean(dim=(0, 1)).cpu()  # per slot, post-burn
    eps = res.info.step_sizes.double().cpu()
    print(f"tempering: flagship ({theta0.numel():,} parameters) run_pt_chains {PT_ENSEMBLES} "
          f"ladders x {PT_TEMPS} replicas = {lanes} lanes, L=10, step 2e-4, max_temp 30, "
          f"adapt_ladder and adapt_step_size, {PT_DRAWS} draws (burn {PT_BURN}): {wall:.2f} s "
          f"= {lanes * 10 * PT_DRAWS / wall:,.1f} grad-steps/s; adapted betas (ladder 0) "
          f"{[round(float(b), 5) for b in betas[0]]}, betas over ladders min/max at slot 1 "
          f"{float(betas[:, 1].min()):.5f}/{float(betas[:, 1].max()):.5f}; post-burn swap rate "
          f"per pair {[round(float(s), 3) for s in swap]}; accept_prob per slot "
          f"{[round(float(a), 3) for a in acc]}; step sizes (ladder 0) "
          f"{[f'{float(e):.3g}' for e in eps[0]]}; peak memory {peak / 2**30:.3f} GiB [{card}]")
    finite = all(bool(torch.isfinite(t).all()) for t in (
        res.replica_samples, res.info.betas, res.info.step_sizes, res.info.accept_prob))
    ends = float((betas[:, 0] - 1.0).abs().max()) <= 1e-5 and float(
        (betas[:, -1] - 1.0 / 30.0).abs().max()) <= 1e-5
    monotone = bool((torch.diff(betas, dim=-1) < 0).all())
    if not (finite and ends and monotone):
        raise SmokeError(f"PT flagship: finite {finite}, pinned ends {ends}, monotone {monotone}")

    # 2. the bimodal 1-D mixture of tests/test_tempering.py:12-37 (cut to
    # PT_BIMODAL_DRAWS draws; the same first 500 skipped): the cold chain
    # visits both modes
    def bimodal(t):
        return torch.logaddexp(-0.5 * torch.sum(((t + 4.0) / 0.5) ** 2),
                               -0.5 * torch.sum(((t - 4.0) / 0.5) ** 2))

    t0 = time.perf_counter()
    r = run_parallel_tempering(21, bimodal, torch.full((1,), -4.0, device=device),
                               PTConfig(num_samples=PT_BIMODAL_DRAWS, num_steps_per_sample=10,
                                        step_size=0.1, num_temps=8, max_temp=50.0))
    cold = r.samples[500:, 0].cpu()
    frac = float((cold > 0).float().mean())
    right, left = float(cold[cold > 0].mean()), float(cold[cold < 0].mean())
    wall_b = time.perf_counter() - t0
    print(f"tempering: bimodal mixture (+-4, sd 0.5), K=8, max_temp 50, {PT_BIMODAL_DRAWS} draws "
          f"in {wall_b:.1f} s: cold chain right of 0 {frac:.3f} (0.2-0.8), mode means "
          f"{right:.3f} / {left:.3f} (within 0.3 of +-4)")
    if not (0.2 < frac < 0.8 and abs(right - 4.0) < 0.3 and abs(left + 4.0) < 0.3):
        raise SmokeError(f"PT bimodal: right {frac}, means {right} / {left}")

    # 3. the 2-D cross-ensemble R-hat of tests/test_tempering.py:272-285
    # (cut to PT_RHAT_DRAWS draws, burn PT_RHAT_BURN)
    def two_modes(t):
        return torch.logaddexp(-0.5 * torch.sum((t - 2.0) ** 2), -0.5 * torch.sum((t + 2.0) ** 2))

    t0 = time.perf_counter()
    r = run_pt_chains(22, two_modes, torch.zeros(2, device=device),
                      PTConfig(num_samples=PT_RHAT_DRAWS, num_steps_per_sample=8, step_size=0.3,
                               num_temps=6, max_temp=50.0, burn=PT_RHAT_BURN), 4)
    rhat = potential_scale_reduction(r.samples).double().cpu()
    frac_pos = (r.samples[..., 0] > 0).float().mean(dim=1).cpu()
    print(f"tempering: 2-D modes at +-2, 4 ensembles x K=6, {PT_RHAT_DRAWS} draws (burn "
          f"{PT_RHAT_BURN}) in {time.perf_counter() - t0:.1f} s: R-hat "
          f"{[round(float(v), 4) for v in rhat]} (< 1.2), right-mode share per ensemble "
          f"{[round(float(v), 3) for v in frac_pos]} (0.15-0.85)")
    if not (bool((rhat < 1.2).all()) and bool(((frac_pos > 0.15) & (frac_pos < 0.85)).all())):
        raise SmokeError(f"PT R-hat: {rhat.tolist()}, shares {frac_pos.tolist()}")

    # 4. float64 card against CPU on the same injected noise, 2 ladders x 4
    # replicas on a 4-D two-mode target, ladder and step-size adaptation
    # across burn 25.  At the acceptance target 0.95 dual averaging does not
    # amplify a last-bit difference from draw to draw: positions within
    # 1e-8.  At the default 0.8 it does: the decisions stay identical and
    # the drift is held within 1e-5, beside the drift that a reversed
    # summation order makes on the CPU alone (the same mechanism, no card)
    gen = torch.Generator().manual_seed(23)
    f64 = dict(generator=gen, dtype=torch.float64)
    noise = {"z": torch.randn(40, 2, 4, 4, **f64), "u_mh": torch.rand(40, 2, 4, **f64),
             "u_swap": torch.rand(40, 2, 4, **f64)}
    start = 1.5 * torch.randn(2, 4, 4, **f64)

    def mixture(t, total=torch.sum):
        return (torch.logaddexp(-0.5 * total(((t - 1.5) / 0.6) ** 2),
                                -0.5 * total(((t + 1.5) / 0.6) ** 2))
                + 0.05 * total(torch.sin(t)))

    def mixture_reversed(t):
        return mixture(t, lambda v: torch.sum(v.flip(-1)))

    def run64(dev, target, lp=mixture):
        cfg64 = PTConfig(num_samples=40, num_steps_per_sample=4, step_size=0.25, num_temps=4,
                         max_temp=12.0, burn=25, adapt_ladder=True, adapt_step_size=True,
                         desired_accept_rate=target)
        return run_pt_chains(0, lp, start.to(dev), cfg64, 2,
                             _noise={k: v.to(dev) for k, v in noise.items()})

    def moved(s):
        return (s[:, 1:] != s[:, :-1]).any(dim=-1)

    def compare(a, b):
        """(identical swaps, identical accepts, positions of max |theta|)"""
        ra, rb = a.replica_samples.cpu(), b.replica_samples.cpu()
        return (torch.equal(a.info.swap_accept.cpu(), b.info.swap_accept.cpu()),
                torch.equal(moved(ra), moved(rb)), float((ra - rb).abs().max()) / float(
                    rb.abs().max()))

    strict = compare(run64(device, 0.95), run64("cpu", 0.95))
    default = compare(run64(device, 0.8), run64("cpu", 0.8))
    reordered = compare(run64("cpu", 0.8, mixture_reversed), run64("cpu", 0.8))
    print(f"tempering: float64 card vs CPU on the same noise, 2 ladders x 4 replicas x 40 draws "
          f"(adaptation across burn 25): target 0.95 swaps / accepts identical {strict[:2]}, "
          f"positions {strict[2]:.3e} of max |theta| (<= 1e-8); default target 0.8 identical "
          f"{default[:2]}, positions {default[2]:.3e} (<= 1e-5), where a reversed summation "
          f"order on the CPU alone drifts {reordered[2]:.3e} (identical {reordered[:2]})")
    if not (all(strict[:2]) and strict[2] <= 1e-8 and all(default[:2]) and default[2] <= 1e-5):
        raise SmokeError(f"PT card vs CPU: target 0.95 {strict}, target 0.8 {default}")

    # 5. run_pt_checkpointed on the flagship, one ladder and 2 ensembles,
    # stopped at 9 draws and resumed to 12 in chunks of 6: a boundary at burn
    ck_cfg = dataclasses.replace(cfg, num_samples=12, burn=6)
    (REPO / "build").mkdir(exist_ok=True)
    same = {}
    for name, ens in (("one ladder", None), ("2 ensembles", 2)):
        if ens is None:
            want = run_parallel_tempering(24, lp, theta0, ck_cfg)
        else:
            want = run_pt_chains(24, lp, theta0, ck_cfg, ens)
        with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
            ck.run_pt_checkpointed(24, lp, theta0, dataclasses.replace(ck_cfg, num_samples=9),
                                   tmp, chunk_size=6, num_ensembles=ens)
            got = ck.run_pt_checkpointed(24, lp, theta0, ck_cfg, tmp, chunk_size=6,
                                         num_ensembles=ens)
        same[name] = same_tensors(torch, got.replica_samples, want.replica_samples) and \
            same_tensors(torch, tuple(got.info), tuple(want.info))
    print(f"tempering: run_pt_checkpointed on the flagship (stopped at 9, chunks of 6, burn 6) "
          f"identical {same}")
    if not all(same.values()):
        raise SmokeError(f"PT: the checkpointed run is not the straight run: {same}")


def example_problem(torch, d, device):
    """``examples/model_comparison_example.py``'s data (80 points of a
    quadratic with noise 0.1) and its degree-(d - 1) polynomial model with an
    N(0, I) prior: ``(data, pointwise, log_lik, log_prior, analytic log Z)``.
    The prediction is ``features @ t``, the example's ``t[0] x^(d-1) + ... +
    t[d-1]`` as one product (fewer small operations a gradient on the
    host); the analytic value is log N(y; 0, Phi Phi^T + I / tau_out), in
    float64 with numpy."""
    import math

    import numpy as np

    rng = np.random.RandomState(0)
    xn = np.linspace(-1, 1, 80).astype(np.float32)
    yn = (0.6 * xn**2 - 0.4 * xn + 0.2) + 0.1 * rng.randn(80).astype(np.float32)
    tau_out = 100.0
    x = torch.as_tensor(xn, device=device)
    data = (torch.stack([x ** p for p in range(d - 1, -1, -1)], dim=1),
            torch.as_tensor(yn, device=device))

    def pointwise(t, data):
        phi, yy = data
        return 0.5 * math.log(tau_out / (2 * math.pi)) - 0.5 * tau_out * (phi @ t - yy) ** 2

    def log_lik(t, data):
        return torch.sum(pointwise(t, data))

    def log_prior(t):
        return -0.5 * torch.sum(t ** 2) - 0.5 * t.shape[0] * math.log(2 * math.pi)

    x64, y64 = xn.astype(np.float64), yn.astype(np.float64)
    phi = np.stack([x64 ** p for p in range(d - 1, -1, -1)], axis=1)
    k = phi @ phi.T + np.eye(80) / tau_out
    exact = float(-0.5 * y64 @ np.linalg.solve(k, y64) - 0.5 * np.linalg.slogdet(2 * np.pi * k)[1])
    return data, pointwise, log_lik, log_prior, exact


def linreg_problem(torch, device):
    """``tests/test_ti.py:289-306``'s Bayesian linear regression (24 points,
    an ``nn.Linear(1, 1)``, tau 1, tau_out 25) through
    ``define_model_prior_and_lik``: ``(log_prior, log_lik, prior_sample,
    template, analytic log Z)``, the analytic value in float64 with numpy."""
    import numpy as np

    from hamiltorch_tpu_torch.models.bnn import define_model_prior_and_lik

    n, tau, tau_out = 24, 1.0, 25.0
    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, size=(n, 1)).astype(np.float32)
    y = (0.8 * x[:, 0] - 0.3 + 0.2 * rng.normal(size=n)).astype(np.float32)[:, None]
    torch.manual_seed(0)
    lp, ll, ps, template = define_model_prior_and_lik(
        torch.nn.Linear(1, 1), "regression", x, y, tau_list=tau, tau_out=tau_out, device=device)
    phi = np.concatenate([x, np.ones_like(x)], axis=1)  # weight, bias
    k = phi @ phi.T / tau + np.eye(n) / tau_out
    exact = float(-0.5 * y[:, 0] @ np.linalg.solve(k, y[:, 0])
                  - 0.5 * np.linalg.slogdet(2 * np.pi * k)[1])
    return lp, ll, ps, template, exact


def prior_normal(torch, d, device):
    """``prior_sample_fn(seed, n)`` of an N(0, I) prior in d dimensions."""
    return lambda seed, n: torch.randn(n, d, generator=torch.Generator(device).manual_seed(seed),
                                       device=device)


# the evidence phase's statistical runs, each against its analytic log Z
EVIDENCE_CASES = ("ti_linear", "ti_quadratic", "smc_quadratic", "ti_linreg", "smc_linreg")


def evidence_case(torch, case, seed, device):
    """``(log Z, analytic log Z, result)`` of one run of an ``EVIDENCE_CASES``
    entry: TI (12 rungs, L=8, step 0.3) on the example's linear or quadratic
    model, SMC (2048 particles, 20 stages, 4 mutations, L=8, step
    ``SMC_STEP``) on its quadratic model, and TI and SMC on
    ``tests/test_ti.py:309-325``'s regression at that test's settings."""
    from hamiltorch_tpu_torch import SMCConfig, TIConfig, run_smc, run_ti

    if case == "ti_linreg":
        lp, ll, _, template, exact = linreg_problem(torch, device)
        r = run_ti(seed, lp, ll, template, TIConfig(
            num_samples=LINREG_TI_DRAWS, num_steps_per_sample=6, step_size=0.3, num_temps=12,
            burn=LINREG_TI_BURN))
    elif case == "smc_linreg":
        lp, ll, ps, _, exact = linreg_problem(torch, device)
        r = run_smc(seed, lp, ll, ps, SMCConfig(num_particles=1024, num_temps=20, mcmc_steps=4,
                                                leapfrog_steps=6, step_size=0.3))
    elif case in ("ti_linear", "ti_quadratic"):
        d = 2 if case == "ti_linear" else 3
        data, _, log_lik, log_prior, exact = example_problem(torch, d, device)
        r = run_ti(seed, log_prior, log_lik, torch.zeros(d, device=device), TIConfig(
            num_samples=EVIDENCE_DRAWS, num_steps_per_sample=8, step_size=0.3, num_temps=12,
            burn=EVIDENCE_BURN), data=data)
    elif case == "smc_quadratic":
        data, _, log_lik, log_prior, exact = example_problem(torch, 3, device)
        r = run_smc(seed, log_prior, log_lik, prior_normal(torch, 3, device), SMCConfig(
            num_particles=2048, num_temps=20, mcmc_steps=4, leapfrog_steps=8,
            step_size=SMC_STEP), data=data)
    else:
        raise ValueError(f"unknown evidence case {case!r}; cases: {', '.join(EVIDENCE_CASES)}")
    return float(r.log_evidence), exact, r


def evidence_path(torch, device, card):
    """Thermodynamic integration and tempered SMC (no kernel of their own):
    the configuration of ``examples/model_comparison_example.py`` rebuilt
    here and ``tests/test_ti.py:309-325``'s regression through
    ``define_model_prior_and_lik``, each against its analytic conjugate
    log Z; the 784-128-1 tanh ``nn.Sequential`` at the flagship's data
    shapes; float64 card against CPU on injected noise;
    ``run_ti_checkpointed`` stopped and resumed."""
    import dataclasses
    import math
    import tempfile

    from torch import nn

    from hamiltorch_tpu_torch import (
        SMCConfig,
        TIConfig,
        pointwise_log_lik,
        psis_loo,
        run_smc,
        run_ti,
        waic,
    )
    from hamiltorch_tpu_torch import checkpoint as ck
    from hamiltorch_tpu_torch.models.bnn import define_model_prior_and_lik

    # 1. the model comparison: TI on the linear and the quadratic model,
    # WAIC and PSIS-LOO of the beta=1 rung
    found = {}
    for seed, case in enumerate(("ti_linear", "ti_quadratic"), start=40):
        name = case[3:]
        t0 = time.perf_counter()
        lz, exact, r = evidence_case(torch, case, seed, device)
        wall = time.perf_counter() - t0
        data, pointwise, *_ = example_problem(torch, 2 if name == "linear" else 3, device)
        ll_mat = pointwise_log_lik(pointwise, r.samples, data=data)
        w, loo = waic(ll_mat), psis_loo(ll_mat)
        found[name] = lz, exact
        print(f"evidence: {name} TI ({EVIDENCE_DRAWS} draws, 12 rungs, burn {EVIDENCE_BURN}, "
              f"L=8, step 0.3) in {wall:.1f} s ({EVIDENCE_DRAWS / wall:,.1f} draws/s): log Z "
              f"stepping stone {lz:.4f}, corrected trapezoid {float(r.log_evidence_ti):.4f}, plain "
              f"{float(r.log_evidence_ti_plain):.4f}; analytic {exact:.4f} (tolerance "
              f"{EXAMPLE_TOL}); swap rate {float(r.info.swap_accept.float().mean()):.3f}; beta=1 "
              f"rung on {ll_mat.device}: waic elpd {w.elpd:.3f}, psis-loo elpd {loo.elpd:.3f} "
              f"(max pareto k {float(loo.pareto_k.max()):.3f})")
        if not (abs(lz - exact) <= EXAMPLE_TOL and ll_mat.device == device
                and math.isfinite(w.elpd) and math.isfinite(loo.elpd)):
            raise SmokeError(f"TI {name}: log Z {lz} vs {exact}, waic {w.elpd}, loo {loo.elpd}")
    if not found["quadratic"][0] > found["linear"][0]:
        raise SmokeError(f"the quadratic model does not win: {found}")
    t0 = time.perf_counter()
    runs = [evidence_case(torch, "smc_quadratic", seed, device)
            for seed in range(42, 42 + SMC_RUNS)]
    each = [lz for lz, *_ in runs]
    lz_smc = statistics.median(each)
    ti_quad, exact = found["quadratic"]
    first = runs[0][2]
    print(f"evidence: quadratic SMC (2048 particles, 20 stages, 4 mutations, L=8, step "
          f"{SMC_STEP}), {SMC_RUNS} runs in {time.perf_counter() - t0:.1f} s: log Z "
          f"{[round(v, 4) for v in each]}, median {lz_smc:.4f} (analytic {exact:.4f}, tolerance "
          f"0.2; TI {ti_quad:.4f}, tolerance {EXAMPLE_TOL}); resampled {int(first.info.resampled.sum())} "
          f"of 20 stages; mean accept_prob {float(first.info.accept_prob.mean()):.3f}; log Bayes "
          f"factor quadratic vs linear (TI) {ti_quad - found['linear'][0]:.2f}")
    if not (abs(lz_smc - exact) <= 0.2 and abs(lz_smc - ti_quad) <= EXAMPLE_TOL):
        raise SmokeError(f"SMC quadratic: log Z {lz_smc} vs {exact} and TI {ti_quad}")

    # the gates of tests/test_ti.py:309-325 at that test's settings: the
    # regression through define_model_prior_and_lik, TI within 0.15 and SMC
    # within 0.2 of the analytic log Z
    t0 = time.perf_counter()
    lz_ti, exact, _ = evidence_case(torch, "ti_linreg", 48, device)
    wall_ti = time.perf_counter() - t0
    lz_sm, _, _ = evidence_case(torch, "smc_linreg", 49, device)
    print(f"evidence: tests/test_ti.py:309-325's regression (nn.Linear(1, 1), 24 points) TI "
          f"({LINREG_TI_DRAWS} draws, 12 rungs, burn {LINREG_TI_BURN}, L=6, step 0.3) in "
          f"{wall_ti:.1f} s, SMC (1024 particles, 20 stages, 4 mutations, L=6) in "
          f"{time.perf_counter() - t0 - wall_ti:.1f} s: TI {lz_ti:.4f}, SMC {lz_sm:.4f}, "
          f"analytic {exact:.4f} (TI within 0.15, SMC within 0.2)")
    if not (abs(lz_ti - exact) < 0.15 and abs(lz_sm - exact) < 0.2):
        raise SmokeError(f"TI/SMC regression: TI {lz_ti}, SMC {lz_sm}, analytic {exact}")

    # 2. full width: the 784-128-1 tanh nn.Sequential on the flagship's data
    # shapes (N = 1024), the tree path through functional_call
    n, i_dim, h = FLAGSHIP["n"], FLAGSHIP["i"], FLAGSHIP["h"]
    x, y, *_ = bnn_inputs(torch, n, i_dim, h, 1, seed=41, device=device)
    torch.manual_seed(41)
    net = nn.Sequential(nn.Linear(i_dim, h), nn.Tanh(), nn.Linear(h, 1))
    lprior, llik, psample, template = define_model_prior_and_lik(
        net, "regression", x, y, tau_list=1.0, tau_out=10.0, device=device)
    width = sum(t.numel() for t in template)
    cfg_w = TIConfig(num_samples=WIDE_TI_DRAWS, num_steps_per_sample=10, step_size=1e-3,
                     num_temps=16, burn=WIDE_TI_BURN)
    run_ti(43, lprior, llik, template, TIConfig(num_samples=2, num_steps_per_sample=2,
                                                step_size=1e-3, num_temps=16, burn=1))  # untimed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rw = run_ti(44, lprior, llik, template, cfg_w)
    torch.cuda.synchronize()
    wall_ti = time.perf_counter() - t0
    grads = 16 * 11 * WIDE_TI_DRAWS  # L + 1 evaluations a draw: the draw's refresh
    t0 = time.perf_counter()
    sw = run_smc(45, lprior, llik, psample,
                 SMCConfig(num_particles=64, num_temps=10, mcmc_steps=2, leapfrog_steps=10,
                           step_size=1e-3))
    torch.cuda.synchronize()
    wall_smc = time.perf_counter() - t0
    ti_vals = [float(rw.log_evidence), float(rw.log_evidence_ti), float(rw.log_evidence_ti_plain)]
    acc_ti, acc_smc = rw.info.accept_prob.float(), sw.info.accept_prob.float()
    ess = sw.info.ess_fraction.float()
    print(f"evidence: 784-128-1 tanh nn.Sequential ({width:,} parameters, N={n}) TI 16 rungs x "
          f"{WIDE_TI_DRAWS} draws (burn {WIDE_TI_BURN}, L=10) {wall_ti:.2f} s = "
          f"{grads / wall_ti:,.1f} grad-steps/s (L + 1 gradients a draw); log Z "
          f"{[round(v, 2) for v in ti_vals]}; accept_prob per rung min/max "
          f"{float(acc_ti.mean(0).min()):.3f}/{float(acc_ti.mean(0).max()):.3f}; SMC 64 "
          f"particles x 10 stages x 2 mutations (L <= 10) {wall_smc:.2f} s: log Z "
          f"{float(sw.log_evidence):.2f}, ESS fractions min {float(ess.min()):.4f}, "
          f"accept_prob {[round(float(a), 3) for a in acc_smc]} [{card}]")
    ok = (all(math.isfinite(v) for v in ti_vals + [float(sw.log_evidence)])
          and bool(((acc_ti >= 0) & (acc_ti <= 1)).all())
          and bool(((acc_smc >= 0) & (acc_smc <= 1)).all())
          and bool(((ess > 0) & (ess <= 1)).all()))
    if not ok:
        raise SmokeError(f"full-width evidence: TI {ti_vals}, SMC {float(sw.log_evidence)}, "
                         f"ESS {ess.tolist()}")

    # 3. float64 card against CPU on the same injected noise: TI (5 rungs,
    # dual averaging across burn 20) and SMC (64 particles, trajectory
    # adaptation, resampling below ESS 0.8) on a 3-D ripple target
    gen = torch.Generator().manual_seed(46)
    f64 = dict(generator=gen, dtype=torch.float64)
    ti_noise = {"z": torch.randn(40, 5, 3, **f64), "u_mh": torch.rand(40, 5, **f64),
                "u_swap": torch.rand(40, 5, **f64)}
    smc_noise = {"z": torch.randn(8, 3, 64, 3, **f64), "jit": torch.rand(8, 3, **f64),
                 "u_mh": torch.rand(8, 3, 64, **f64), "u_res": torch.rand(8, **f64)}
    block = torch.randn(64, 3, **f64)

    def ripple(t):
        return -2.0 * torch.sum((t - 0.4) ** 2) + 0.3 * torch.sum(torch.cos(3.0 * t))

    def prior64(t):
        return -0.5 * torch.sum(t ** 2)

    def run64(dev):
        ti = run_ti(0, prior64, ripple, torch.zeros(3, dtype=torch.float64, device=dev),
                    TIConfig(num_samples=40, num_steps_per_sample=4, step_size=0.3, num_temps=5,
                             schedule_power=2.0, burn=20, desired_accept_rate=0.95),
                    _noise={k: v.to(dev) for k, v in ti_noise.items()})
        sm = run_smc(0, prior64, ripple, lambda seed, n_: block.to(dev),
                     SMCConfig(num_particles=64, num_temps=8, mcmc_steps=3, leapfrog_steps=6,
                               step_size=0.3, resample_threshold=0.8, adapt_trajectory=True),
                     _noise={k: v.to(dev) for k, v in smc_noise.items()})
        return ti, sm

    (ti_c, sm_c), (ti_h, sm_h) = run64(device), run64("cpu")

    def moved(s):
        return (s[1:] != s[:-1]).any(dim=-1)

    same_ti = torch.equal(ti_c.info.swap_accept.cpu(), ti_h.info.swap_accept) and torch.equal(
        moved(ti_c.samples.cpu()), moved(ti_h.samples))
    err_ti = float((ti_c.samples.cpu() - ti_h.samples).abs().max()) / float(
        ti_h.samples.abs().max())
    same_res = torch.equal(sm_c.info.resampled.cpu(), sm_h.info.resampled)
    # a different resample index moves a particle by O(1)
    err_smc = float((sm_c.particles.cpu() - sm_h.particles).abs().max()) / float(
        sm_h.particles.abs().max())
    err_z = abs(float(sm_c.log_evidence) - float(sm_h.log_evidence)) / abs(float(
        sm_h.log_evidence))
    print(f"evidence: float64 card vs CPU on the same noise: TI swaps and accepts identical "
          f"{same_ti}, positions {err_ti:.3e} of max |theta|; SMC resample decisions identical "
          f"{same_res} ({int(sm_h.info.resampled.sum())} of 8 stages), particles {err_smc:.3e} of "
          f"max |theta|, log Z {err_z:.3e} relative")
    if not (same_ti and err_ti <= 1e-8 and same_res and err_smc <= 1e-8 and err_z <= 1e-8):
        raise SmokeError(f"TI/SMC card vs CPU: TI {same_ti} {err_ti:.3e}, SMC {same_res} "
                         f"{err_smc:.3e} {err_z:.3e}")

    # 4. run_ti_checkpointed on the quadratic model, stopped at 30 draws and
    # resumed to 60 in chunks of 10 (a boundary at burn 20)
    ck_cfg = TIConfig(num_samples=60, num_steps_per_sample=8, step_size=0.3, num_temps=12,
                      burn=20)
    data, _, log_lik, log_prior, _ = example_problem(torch, 3, device)
    want = run_ti(47, log_prior, log_lik, torch.zeros(3, device=device), ck_cfg, data=data)
    (REPO / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        ck.run_ti_checkpointed(47, log_prior, log_lik, torch.zeros(3, device=device),
                               dataclasses.replace(ck_cfg, num_samples=30), tmp,
                               chunk_size=10, data=data)
        got = ck.run_ti_checkpointed(47, log_prior, log_lik, torch.zeros(3, device=device), ck_cfg,
                                     tmp, chunk_size=10, data=data)
    same = same_tensors(torch, tuple(got), tuple(want))
    print(f"evidence: run_ti_checkpointed (stopped at 30, chunks of 10, burn 20) identical {same}")
    if not same:
        raise SmokeError("TI: the checkpointed run is not the straight run")


def gradient_free_path(torch, device, card):
    """Barker, the stretch move and elliptical slice (no kernel of their own:
    the generic potential, one vmapped evaluation a draw or a shrink
    iteration): Barker and elliptical slice at full width, timed; the stretch
    move on the examples' targets and at D=64, timed; the statistical gates
    of the JAX tests; float64 card against CPU on injected noise; the
    checkpointed Barker and stretch runs identical to the straight ones."""
    import dataclasses
    import math
    import tempfile

    from torch import nn

    from hamiltorch_tpu_torch import (
        BarkerConfig,
        EllipticalConfig,
        StretchConfig,
        run_barker,
        run_barker_chains,
        run_elliptical_chains,
        run_stretch,
    )
    from hamiltorch_tpu_torch import checkpoint as ck
    from hamiltorch_tpu_torch.models.bnn import define_model_prior_and_lik
    from hamiltorch_tpu_torch.models.flagship import make_flagship_potential_tree

    # 1. Barker on the flagship at 64 chains, dual averaging over the burn
    lp, theta0 = make_flagship_potential_tree(device=device)
    width = sum(t.numel() for t in theta0.values())
    cfg = BarkerConfig(num_samples=BARKER_DRAWS, burn=BARKER_BURN, step_size=1e-3)
    run_barker_chains(1, lp, theta0, BarkerConfig(num_samples=3, burn=1, step_size=1e-3),
                      BARKER_CHAINS)  # untimed: the first calls of this path
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = run_barker_chains(2, lp, theta0, cfg, BARKER_CHAINS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    acc = res.acc_rate.float().cpu()
    eps = res.step_size.float().cpu()
    finite = all(bool(torch.isfinite(t).all()) for t in res.samples.values())
    print(f"gradient_free: Barker on the flagship ({width:,} parameters) run_barker_chains "
          f"{BARKER_CHAINS} chains x {BARKER_DRAWS} draws (burn {BARKER_BURN}, dual averaging "
          f"from 1e-3): {wall:.2f} s = {BARKER_CHAINS * BARKER_DRAWS / wall:,.1f} grad-steps/s "
          f"(one gradient a draw); post-burn acceptance min/median/max {float(acc.min()):.3f}/"
          f"{float(acc.median()):.3f}/{float(acc.max()):.3f} (target 0.574); adapted eps median "
          f"{float(eps.median()):.3e}; divergent draws {int(res.stats.divergent.sum())}; peak "
          f"memory {peak / 2**30:.3f} GiB [{card}]")
    if not (finite and bool(((acc > 0) & (acc <= 1)).all())):
        raise SmokeError(f"Barker flagship: finite {finite}, acceptance {acc.tolist()}")

    # 2. elliptical slice on the 784-128-1 module at the flagship's data shapes
    n, i_dim, h = FLAGSHIP["n"], FLAGSHIP["i"], FLAGSHIP["h"]
    x, y, *_ = bnn_inputs(torch, n, i_dim, h, 1, seed=61, device=device)
    torch.manual_seed(61)
    net = nn.Sequential(nn.Linear(i_dim, h), nn.Tanh(), nn.Linear(h, 1))
    tau = 1.0
    _, llik, _, template = define_model_prior_and_lik(net, "regression", x, y, tau_list=tau,
                                                      tau_out=10.0, device=device)
    calls = [0]

    def counted(t):
        calls[0] += 1
        return llik(t)

    ess_cfg = EllipticalConfig(num_samples=ESS_WIDE_DRAWS)
    prior_std = [1.0 / math.sqrt(tau)] * len(template)  # per leaf
    run_elliptical_chains(3, llik, template, EllipticalConfig(num_samples=1), BARKER_CHAINS,
                          prior_scale=prior_std)  # untimed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    es = run_elliptical_chains(4, counted, template, ess_cfg, BARKER_CHAINS,
                               prior_scale=prior_std)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    shrinks = es.stats.shrinks.float().cpu()
    ll_final = es.final_loglik.float().cpu()
    evals = calls[0] * BARKER_CHAINS  # each call one vmapped batch of every lane
    print(f"gradient_free: elliptical slice on a 784-128-1 tanh nn.Sequential "
          f"({sum(t.numel() for t in template):,} parameters, N={n}, prior std 1/sqrt(tau) per "
          f"leaf) run_elliptical_chains {BARKER_CHAINS} chains x {ESS_WIDE_DRAWS} draws: "
          f"{wall:.2f} s, {calls[0]} vmapped likelihood calls = {evals / wall:,.1f} likelihood "
          f"evaluations/s; mean shrinks a draw {float(shrinks.mean()):.2f} (max "
          f"{int(shrinks.max())}), cap hits {int(es.stats.divergent.sum())}; final log-likelihood "
          f"median {float(ll_final.median()):.1f} [{card}]")
    if not (bool(torch.isfinite(ll_final).all()) and float(shrinks.max()) <= ess_cfg.max_shrink):
        raise SmokeError(f"elliptical full width: log-likelihood {ll_final.tolist()}, shrinks "
                         f"max {float(shrinks.max())}")

    # 3. the stretch move: D=64 correlated Gaussian at 256 walkers, timed
    gen = torch.Generator().manual_seed(62)
    a = torch.randn(STRETCH_DIM, STRETCH_DIM, generator=gen, dtype=torch.float64)
    prec64 = torch.linalg.inv(a @ a.T / STRETCH_DIM + torch.eye(STRETCH_DIM, dtype=torch.float64))
    prec = prec64.float().to(device)
    evals = [0]

    def gauss64(t):
        evals[0] += 1
        return -0.5 * t @ prec @ t

    run_stretch(5, gauss64, torch.zeros(STRETCH_DIM, device=device), StretchConfig(2),
                STRETCH_WALKERS)  # untimed
    evals[0] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = run_stretch(6, gauss64, torch.zeros(STRETCH_DIM, device=device),
                     StretchConfig(STRETCH_ITERS), STRETCH_WALKERS, init_jitter=0.5)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_evals = STRETCH_ITERS * STRETCH_WALKERS
    print(f"gradient_free: stretch move on a D={STRETCH_DIM} correlated Gaussian, "
          f"{STRETCH_WALKERS} walkers x {STRETCH_ITERS} iterations: {wall:.2f} s = "
          f"{n_evals / wall:,.1f} log-density evaluations/s ({evals[0]} vmapped calls of "
          f"{STRETCH_WALKERS // 2}), acceptance {float(st.acc_rate):.3f} [{card}]")
    if not (bool(torch.isfinite(st.samples).all()) and 0.0 < float(st.acc_rate) <= 1.0):
        raise SmokeError(f"stretch D=64: acceptance {float(st.acc_rate)}")

    # 4. statistical gates, from the JAX tests
    t0 = time.perf_counter()
    stds = torch.linspace(0.5, 3.0, 8, device=device)
    rb = run_barker_chains(7, lambda t: -0.5 * torch.sum((t / stds) ** 2),
                           torch.zeros(8, device=device) + 0.1,
                           BarkerConfig(num_samples=GATE_DRAWS, burn=GATE_BURN, adapt_scale=True),
                           32)
    pooled = rb.samples[:, GATE_BURN:].reshape(-1, 8).double()
    rec = pooled.std(0).cpu() / stds.double().cpu()
    acc = float(rb.acc_rate.mean())
    corr = float(torch.corrcoef(torch.stack([rb.scale.double().mean(0).cpu(),
                                             stds.double().cpu()]))[0, 1])
    ok_b = (bool(((rec - 1).abs() < 0.12).all()) and float(pooled.mean(0).abs().max()) < 0.25
            and 0.45 < acc < 0.70 and not bool(rb.stats.divergent[:, GATE_BURN:].any())
            and corr > 0.95)
    quartic = run_barker_chains(8, lambda t: -0.25 * torch.sum(t ** 4),
                                torch.zeros(4, device=device) + 0.2,
                                BarkerConfig(num_samples=GATE_DRAWS, burn=GATE_BURN,
                                             step_size=50.0), 32)
    var = quartic.samples[:, GATE_BURN:].reshape(-1, 4).double().var(0).cpu()
    ok_q = bool(((var / 0.675978 - 1).abs() < 0.15).all()) and not bool(
        quartic.stats.divergent.any())
    print(f"gradient_free: Barker 8-D Gaussian with scale adaptation (32 chains x {GATE_DRAWS}, "
          f"burn {GATE_BURN}): std / true {[round(float(r), 3) for r in rec]} (within 0.12), "
          f"acceptance {acc:.3f} (0.45-0.70), scale-truth correlation {corr:.4f} (> 0.95); quartic "
          f"from step 50: variances {[round(float(v), 4) for v in var]} (0.6760 within 15%), "
          f"adapted eps median {float(quartic.step_size.median()):.3f}, divergent draws "
          f"{int(quartic.stats.divergent.sum())}; {time.perf_counter() - t0:.1f} s")
    if not (ok_b and ok_q):
        raise SmokeError(f"Barker gates: Gaussian {ok_b} (std ratio {rec.tolist()}, acceptance "
                         f"{acc}, correlation {corr}), quartic {ok_q} ({var.tolist()})")

    t0 = time.perf_counter()
    sd3 = torch.tensor([0.5, 1.0, 2.0], device=device)
    sg = run_stretch(9, lambda t: -0.5 * torch.sum((t / sd3) ** 2), torch.zeros(3, device=device),
                     StretchConfig(STRETCH_GATE_ITERS), 32)
    pooled = sg.samples[STRETCH_GATE_ITERS // 4:].reshape(-1, 3).double()
    rec_s = pooled.std(0).cpu() / sd3.double().cpu()
    ok_s = (bool(((rec_s - 1).abs() < 0.10).all()) and float(pooled.mean(0).abs().max()) < 0.15
            and 0.2 < float(sg.acc_rate) < 0.8)
    rot = torch.tensor([[0.8, -0.6], [0.6, 0.8]], dtype=torch.float64)
    amat = rot @ torch.diag(torch.tensor([10.0, 0.1], dtype=torch.float64))  # condition 1e4
    hard_prec = torch.linalg.inv(amat @ amat.T).float().to(device)
    hard = run_stretch(10, lambda t: -0.5 * t @ hard_prec @ t, torch.zeros(2, device=device),
                       StretchConfig(STRETCH_AFFINE_ITERS), 32, init_jitter=1.0)
    white = run_stretch(10, lambda t: -0.5 * torch.sum(t ** 2), torch.zeros(2, device=device),
                        StretchConfig(STRETCH_AFFINE_ITERS), 32, init_jitter=1.0)
    z = hard.samples[STRETCH_AFFINE_ITERS // 3:].reshape(-1, 2).double().cpu() @ torch.linalg.inv(
        amat).T
    acc_gap = abs(float(hard.acc_rate) - float(white.acc_rate))
    ok_a = acc_gap < 0.05 and bool(((z.std(0) - 1).abs() < 0.1).all())
    stair = run_stretch(11, lambda t: -0.5 * torch.floor(torch.sum(t ** 2) * 4.0) / 4.0,
                        torch.zeros(2, device=device), StretchConfig(STRETCH_GATE_ITERS), 32)
    stair_std = stair.samples[STRETCH_GATE_ITERS // 4:].reshape(-1, 2).double().std(0).cpu()
    ok_t = bool(((stair_std - 1).abs() < 0.15).all()) and float(stair.acc_rate) > 0.2
    print(f"gradient_free: stretch 3-D Gaussian (32 walkers x {STRETCH_GATE_ITERS}): std / true "
          f"{[round(float(r), 3) for r in rec_s]} (within 0.10), acceptance "
          f"{float(sg.acc_rate):.3f}; condition-1e4 Gaussian vs its whitened twin "
          f"({STRETCH_AFFINE_ITERS}): acceptance {float(hard.acc_rate):.3f} / "
          f"{float(white.acc_rate):.3f} (gap < 0.05), z-scored std "
          f"{[round(float(v), 3) for v in z.std(0)]}; staircase std "
          f"{[round(float(v), 3) for v in stair_std]} (1 within 0.15), acceptance "
          f"{float(stair.acc_rate):.3f}; {time.perf_counter() - t0:.1f} s")
    if not (ok_s and ok_a and ok_t):
        raise SmokeError(f"stretch gates: Gaussian {ok_s}, affine {ok_a}, staircase {ok_t}")

    t0 = time.perf_counter()
    ea = run_elliptical_chains(12, lambda t: -0.5 * torch.sum(((t - 1.0) / 0.5) ** 2),
                               torch.zeros(3, device=device), EllipticalConfig(ESS_GATE_DRAWS),
                               ESS_GATE_CHAINS)
    kept = ea.samples[:, ESS_GATE_DRAWS // 5:].reshape(-1, 3).double()
    mean_e, var_e = kept.mean(0).cpu(), kept.var(0).cpu()
    mean_shrinks = float(ea.stats.shrinks.float().mean())
    ok_e = (bool(((mean_e - 0.8).abs() < 0.05).all()) and bool(((var_e - 0.2).abs() < 0.03).all())
            and 0.5 < mean_shrinks < 5.0 and not bool(ea.stats.divergent.any()))
    print(f"gradient_free: elliptical slice, N(0, 1) prior x N(1, 0.5^2) likelihood "
          f"({ESS_GATE_CHAINS} chains x {ESS_GATE_DRAWS}): mean "
          f"{[round(float(v), 4) for v in mean_e]} (0.8 within 0.05), variance "
          f"{[round(float(v), 4) for v in var_e]} (0.2 within 0.03), "
          f"mean shrinks {mean_shrinks:.2f}; {time.perf_counter() - t0:.1f} s")
    if not ok_e:
        raise SmokeError(f"elliptical gate: mean {mean_e.tolist()}, variance {var_e.tolist()}, "
                         f"shrinks {mean_shrinks}")

    # 5. float64 card against CPU on the same injected noise
    gen = torch.Generator().manual_seed(63)
    f64 = dict(generator=gen, dtype=torch.float64)

    def ripple(t):
        return (-0.5 * torch.sum((t / torch.linspace(0.5, 2.0, t.shape[-1], dtype=t.dtype,
                                                     device=t.device)) ** 2)
                + 0.2 * torch.sum(torch.cos(t)))

    c, d = 4, 6
    b_noise = {"z": torch.randn(48, c, d, **f64), "u_keep": torch.rand(48, c, d, **f64),
               "u_mh": torch.rand(48, c, generator=gen)}
    s_noise = {"u_z": torch.rand(60, 2, 8, **f64),
               "j": torch.randint(0, 8, (60, 2, 8), generator=gen),
               "u_mh": torch.rand(60, 2, 8, generator=gen)}
    e_noise = {"nu": torch.randn(40, c, d, **f64), "u": torch.rand(40, c, generator=gen),
               "t0": torch.rand(40, c, generator=gen),
               "t_shrink": torch.rand(40, c, 64, generator=gen)}
    walkers = torch.randn(16, d, **f64)
    chol = torch.linalg.cholesky(torch.eye(d, dtype=torch.float64) + 0.5)

    def run64(dev):
        def on(nz):
            return {k: v.to(dev) for k, v in nz.items()}
        t0_ = torch.full((d,), 0.3, dtype=torch.float64, device=dev)
        rb_ = run_barker_chains(0, ripple, t0_, BarkerConfig(48, burn=16, adapt_scale=True,
                                                             desired_accept_rate=0.95), c,
                                _noise=on(b_noise))
        rs_ = run_stretch(0, ripple, walkers.to(dev), StretchConfig(60), 16, _noise=on(s_noise))
        re_ = run_elliptical_chains(0, lambda t: -0.5 * torch.sum(((t - 1.0) / 0.5) ** 2), t0_,
                                    EllipticalConfig(40), c, prior_scale=chol.to(dev),
                                    _noise=on(e_noise))
        return rb_, rs_, re_

    (bc, sc, ec), (bh, sh, eh) = run64(device), run64("cpu")

    def rel(a_, b_):
        return float((a_.cpu() - b_).abs().max()) / float(b_.abs().max())

    same = {"barker accepts": torch.equal(bc.stats.accepted.cpu(), bh.stats.accepted),
            "stretch accepts": torch.equal(sc.stats.accept_frac.cpu(), sh.stats.accept_frac),
            "elliptical shrinks": torch.equal(ec.stats.shrinks.cpu(), eh.stats.shrinks)}
    errs = {"barker": rel(bc.samples, bh.samples), "stretch": rel(sc.samples, sh.samples),
            "elliptical": rel(ec.samples, eh.samples)}
    print(f"gradient_free: float64 card vs CPU on the same noise (Barker 4 chains x 48 draws with "
          f"both adaptations, stretch 16 walkers x 60, elliptical 4 chains x 40 under a Cholesky "
          f"prior): identical {same}; positions of max |theta| "
          f"{ {k: f'{v:.3e}' for k, v in errs.items()} } (<= 1e-10); Barker acceptance "
          f"{float(bh.stats.accepted.float().mean()):.3f}, elliptical shrinks max "
          f"{int(eh.stats.shrinks.max())}")
    if not (all(same.values()) and max(errs.values()) <= 1e-10):
        raise SmokeError(f"gradient-free card vs CPU: {same}, {errs}")

    # 6. the checkpointed runners on the card: stopped at 25, resumed to 40,
    # chunks of 7 (Barker's Welford window [5, 15) and scale switch cross them)
    (REPO / "build").mkdir(exist_ok=True)
    t_start = torch.zeros(6, device=device)
    b_cfg = BarkerConfig(num_samples=40, burn=20, adapt_scale=True)
    s_cfg = StretchConfig(num_samples=40)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        ck.run_barker_checkpointed(13, ripple, t_start, dataclasses.replace(b_cfg, num_samples=25),
                                   tmp + "/b", chunk_size=7)
        got_b = ck.run_barker_checkpointed(13, ripple, t_start, b_cfg, tmp + "/b", chunk_size=7)
        ck.run_stretch_checkpointed(13, ripple, t_start, dataclasses.replace(s_cfg, num_samples=25),
                                    tmp + "/s", chunk_size=7, num_walkers=16)
        got_s = ck.run_stretch_checkpointed(13, ripple, t_start, s_cfg, tmp + "/s", chunk_size=7,
                                            num_walkers=16)
    want_b = run_barker(13, ripple, t_start, b_cfg)
    want_s = run_stretch(13, ripple, t_start, s_cfg, 16)
    same = {"barker": same_tensors(torch, tuple(got_b), tuple(want_b)),
            "stretch": same_tensors(torch, tuple(got_s), tuple(want_s))}
    print(f"gradient_free: run_barker_checkpointed / run_stretch_checkpointed (stopped at 25, "
          f"chunks of 7) identical {same}")
    if not all(same.values()):
        raise SmokeError(f"gradient-free checkpoints: {same}")


def optim_path(torch, device, card):
    """MAP, Laplace and ADVI (no kernel of their own: torch.optim's Adam over
    the generic potential): Adam and mean-field ADVI on the flagship, timed;
    the Laplace evidence of tests/test_ti.py:309-325's conjugate regression
    against its exact log Z; full-rank ADVI against a correlated Gaussian's
    covariance; ADVI's stds as Barker's scale (examples/
    barker_robustness_example.py, part 3)."""
    from hamiltorch_tpu_torch import (
        BarkerConfig,
        advi,
        advi_cov,
        laplace_approx,
        map_estimate,
        run_barker_chains,
    )
    from hamiltorch_tpu_torch.models.flagship import make_flagship_potential

    # 1. the flagship: Adam (MAP) and mean-field ADVI over all 100,609 parameters
    lp, theta0 = make_flagship_potential(device=device)
    map_estimate(lp, theta0, num_steps=2, learning_rate=1e-3)  # untimed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = map_estimate(lp, theta0, num_steps=MAP_STEPS, learning_rate=1e-3)
    torch.cuda.synchronize()
    wall_map = time.perf_counter() - t0
    t0 = time.perf_counter()
    fit = advi(lp, theta0, num_steps=ADVI_WIDE_STEPS, learning_rate=1e-3)
    torch.cuda.synchronize()
    wall_advi = time.perf_counter() - t0
    trace = fit.elbo_trace.double().cpu()
    tail = max(ADVI_WIDE_STEPS // 10, 1)
    print(f"optim: map_estimate on the flagship ({theta0.numel():,} parameters, Adam lr 1e-3) "
          f"{MAP_STEPS} steps {wall_map:.2f} s = {MAP_STEPS / wall_map:,.1f} steps/s, log p "
          f"{float(m.log_prob_trace[0]):.1f} -> {float(m.log_prob):.1f}, rejected "
          f"{int(m.num_rejected)}; mean-field advi {ADVI_WIDE_STEPS} steps x 4 Monte Carlo draws "
          f"{wall_advi:.2f} s = {ADVI_WIDE_STEPS / wall_advi:,.1f} steps/s, ELBO "
          f"{float(trace[:tail].mean()):.1f} -> {float(fit.elbo):.1f} [{card}]")
    if not (bool(torch.isfinite(m.theta).all()) and float(m.log_prob) > float(m.log_prob_trace[0])
            and bool(torch.isfinite(trace).all()) and float(fit.elbo) > float(trace[:tail].mean())):
        raise SmokeError(f"optim flagship: MAP {float(m.log_prob)}, ELBO {float(fit.elbo)}")

    # 2. Laplace on the conjugate regression: the posterior is Gaussian, so
    # the Laplace evidence is the exact log Z
    lprior, llik, _, template, exact = linreg_problem(torch, device)
    post = map_estimate(lambda t: lprior(t) + llik(t), template, num_steps=2000,
                        learning_rate=0.05)
    lap = laplace_approx(lambda t: lprior(t) + llik(t), post.theta)
    err = abs(float(lap.log_evidence) - exact)
    print(f"optim: laplace_approx on tests/test_ti.py:309-325's regression (MAP by Adam, 2000 "
          f"steps): log Z {float(lap.log_evidence):.5f} against the exact {exact:.5f} (diff "
          f"{err:.2e}, within 1e-3)")
    if not err <= 1e-3:
        raise SmokeError(f"Laplace evidence {float(lap.log_evidence)} against {exact}")

    # 3. full-rank ADVI against a correlated D=6 Gaussian's covariance
    d = 6
    cov = 0.7 ** torch.abs(torch.arange(d)[:, None] - torch.arange(d)[None, :]).double()
    prec = torch.linalg.inv(cov).float().to(device)
    mu = torch.linspace(-1.0, 1.0, d, device=device)
    t0 = time.perf_counter()
    fr = advi(lambda t: -0.5 * (t - mu) @ prec @ (t - mu), torch.zeros(d, device=device),
              num_steps=FULLRANK_STEPS, learning_rate=0.02, num_mc_samples=8, method="fullrank")
    fit_cov = advi_cov(fr).double().cpu()
    err_cov = float((fit_cov - cov).abs().max())
    err_mu = float((fr.mean - mu).abs().max())
    print(f"optim: full-rank advi on a D={d} Gaussian (rho 0.7^|i-j|), {FULLRANK_STEPS} steps x 8 "
          f"draws in {time.perf_counter() - t0:.1f} s: covariance within {err_cov:.4f} (0.15), "
          f"mean within {err_mu:.4f} (0.1)")
    if not (err_cov <= 0.15 and err_mu <= 0.1):
        raise SmokeError(f"full-rank ADVI: covariance {err_cov}, mean {err_mu}")

    # 4. examples/barker_robustness_example.py part 3: ADVI's stds as Barker's scale
    stds = torch.linspace(0.25, 9.0, 6, device=device)

    def aniso(t):
        return -0.5 * torch.sum((t / stds) ** 2)

    t0 = time.perf_counter()
    vi = advi(aniso, torch.zeros(6, device=device), num_steps=2000)
    vi_std = torch.exp(vi.log_std)
    rb = run_barker_chains(14, aniso, vi.mean, BarkerConfig(num_samples=2000, burn=500), 16,
                           scale=vi_std)
    rec = rb.samples[:, 500:].reshape(-1, 6).double().std(0).cpu() / stds.double().cpu()
    ratio = (vi_std / stds).double().cpu()
    print(f"optim: ADVI-seeded Barker scale (the 36:1 Gaussian): ADVI std / true "
          f"{[round(float(v), 3) for v in ratio]} (within 0.15), Barker 16 chains x 2000 (burn "
          f"500) recovered std / true {[round(float(v), 3) for v in rec]} (within 0.2), acceptance "
          f"{float(rb.acc_rate.mean()):.3f}; {time.perf_counter() - t0:.1f} s")
    if not (bool(((ratio - 1).abs() < 0.15).all()) and bool(((rec - 1).abs() < 0.2).all())):
        raise SmokeError(f"ADVI-seeded Barker: ADVI {ratio.tolist()}, Barker {rec.tolist()}")


def flagship_shards(torch, device, dtype=None):
    """The flagship in the data-sharded contract: ``(loglik_shard_fn,
    log_prior_fn, x, y, theta0)``, the data and start of
    ``make_flagship_potential`` (seed 0), whose potential is the prior plus
    the likelihood of every row."""
    from hamiltorch_tpu_torch.models.flagship import HIDDEN, IN_DIM, N_DATA, _data

    dtype = dtype or torch.float32
    x, y, theta0 = _data(IN_DIM, HIDDEN, N_DATA, dtype, 0, None, None, None, device)
    s0, s1 = IN_DIM * HIDDEN, IN_DIM * HIDDEN + HIDDEN
    s2 = s1 + HIDDEN

    def loglik_shard(theta, xs, ys):
        h = torch.tanh(xs @ theta[:s0].reshape(IN_DIM, HIDDEN) + theta[s0:s1])
        out = h @ theta[s1:s2].reshape(HIDDEN, 1) + theta[s2:]
        return -0.5 * 10.0 * torch.sum((out - ys) ** 2)

    def log_prior(theta):
        return -0.5 * torch.dot(theta, theta)

    return loglik_shard, log_prior, x, y, theta0


def svgd_path(torch, device, card):
    """SVGD (no kernel of its own: its three products a step are plain
    float32 matmuls, as the JAX package's are XLA's): ``run_svgd`` on the
    flagship at the JAX default of 100 particles, timed in steps/s with its
    peak memory and gated on no rejected step; the correlated Gaussian of
    ``examples/svgd_example.py`` at ``tests/test_svgd.py``'s tolerances;
    float64 card against CPU on a small target from the same cloud."""
    import numpy as np

    from hamiltorch_tpu_torch import SVGDConfig, run_svgd
    from hamiltorch_tpu_torch.models.flagship import make_flagship_potential

    # 1. the flagship, 100 particles; the JAX defaults (AdaGrad, step 0.1,
    # the median heuristic, a cloud of scale 0.1 around theta0)
    lp, theta0 = make_flagship_potential(device=device)
    run_svgd(0, lp, theta0, SVGDConfig(num_steps=2), SVGD_PARTICLES)  # warm up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    r = run_svgd(1, lp, theta0, SVGDConfig(num_steps=SVGD_STEPS), SVGD_PARTICLES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    phi = r.phi_norm_trace
    print(f"svgd: flagship ({theta0.numel():,} parameters, N={FLAGSHIP['n']}), {SVGD_PARTICLES} "
          f"particles x {SVGD_STEPS} steps in {wall:.2f} s = {SVGD_STEPS / wall:.1f} steps/s "
          f"({SVGD_PARTICLES * SVGD_STEPS / wall:,.1f} gradients/s), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; mean |phi| {float(phi[0]):.4g} -> "
          f"{float(phi[-1]):.4g}, bandwidth h {float(r.bandwidth_trace[-1]):.4g}, rejected "
          f"{int(r.num_rejected)} [{card}]")
    if not (int(r.num_rejected) == 0 and bool(torch.isfinite(r.particles).all())
            and r.particles.shape == (SVGD_PARTICLES, theta0.numel())):
        raise SmokeError(f"svgd flagship: rejected {int(r.num_rejected)}, shape "
                         f"{tuple(r.particles.shape)}")

    # 2. examples/svgd_example.py's correlated Gaussian at tests/test_svgd.py:28's gates
    cov = torch.tensor([[1.0, 0.8], [0.8, 2.0]], device=device)
    prec = torch.linalg.inv(cov)
    t0 = time.perf_counter()
    g = run_svgd(0, lambda t: -0.5 * t @ prec @ t, torch.zeros(2, device=device),
                 SVGDConfig(num_steps=SVGD_GAUSS_STEPS, step_size=0.2), 200)
    x = g.particles.double().cpu().numpy()
    emp = np.cov(x.T)
    ptr = g.phi_norm_trace
    print(f"svgd: correlated Gaussian, 200 particles x {SVGD_GAUSS_STEPS} steps in "
          f"{time.perf_counter() - t0:.2f} s: mean {np.round(x.mean(0), 4).tolist()}, cov "
          f"{np.round(emp, 4).tolist()} (target [[1, 0.8], [0.8, 2]]); mean |phi| last "
          f"{float(ptr[-1]):.4f} against {float(ptr[:10].max()):.4f} early")
    if not (np.allclose(x.mean(0), 0.0, atol=0.15)
            and np.allclose(emp, cov.cpu().numpy(), rtol=0.15, atol=0.15)
            and int(g.num_rejected) == 0 and float(ptr[-1]) < 0.2 * float(ptr[:10].max())):
        raise SmokeError(f"svgd Gaussian: mean {x.mean(0)}, cov {emp}")

    # 3. float64 card against CPU from the same cloud (the update runs in
    # float32 as the JAX package's does; the cloud keeps float64:
    # SVGD_CARD_TOL)
    gen = torch.Generator().manual_seed(7)
    p0 = torch.randn(16, 3, generator=gen, dtype=torch.float64)
    scales = torch.tensor([1.0, 0.5, 2.0], dtype=torch.float64)

    def small(dev):
        s = scales.to(dev)
        return run_svgd(0, lambda t: -0.5 * torch.sum((t / s) ** 2) + 0.2 * torch.sum(torch.sin(t)),
                        torch.zeros(3, dtype=torch.float64, device=dev),
                        SVGDConfig(num_steps=20, step_size=0.05), 16, particles0=p0.to(dev))

    on_card, on_host = small(device), small("cpu")
    err = float((on_card.particles.cpu() - on_host.particles).abs().max()) / float(
        on_host.particles.abs().max())
    print(f"svgd: float64 card vs CPU, 16 particles x 20 steps: {err:.3e} of max |x|")
    if not err <= SVGD_CARD_TOL:
        raise SmokeError(f"svgd card vs CPU: {err:.3e}")


def parallel_path(torch, device, card):
    """The sharded samplers (no kernel of their own) on a one-rank NCCL mesh:
    ``run_hmc_chains_sharded`` at the main path's configuration bit for bit
    against ``run_hmc_chains``, timed beside it; ``sample_chains_sharded``
    with the flagship likelihood against the full-batch run;
    ``run_chees_sharded`` and ``run_svgd_sharded`` against their local runs.
    One card cannot hold more than one rank (NCCL refuses two ranks on one
    GPU): the multi-rank collectives are held by the CPU tests."""
    import dataclasses

    import torch.distributed as dist

    from hamiltorch_tpu_torch import (
        ChEESConfig,
        MCMCConfig,
        SVGDConfig,
        run_chees,
        run_hmc_chains,
        run_svgd,
    )
    from hamiltorch_tpu_torch.models.flagship import (
        make_flagship_potential,
        make_flagship_potential_tree,
    )
    from hamiltorch_tpu_torch.parallel import sharding as sh

    mesh = sh.make_mesh()
    try:
        backend, dev = dist.get_backend(), sh.mesh_device(mesh)
        print(f"parallel: mesh {tuple(mesh.mesh.shape)} {mesh.mesh_dim_names}, backend {backend}, "
              f"world {dist.get_world_size()}, device {dev}")
        if backend != "nccl" or dev.type != "cuda":
            raise SmokeError(f"the mesh runs on {backend} / {dev}, not nccl / cuda")

        # 1. the main path's HMC, sharded and not, in turns (64 chains x 10 x 50)
        lp_tree, params0 = make_flagship_potential_tree(device=device)
        draws, steps, eps = PARALLEL_HMC
        cfg = MCMCConfig(num_samples=draws, num_steps_per_sample=steps, step_size=eps)
        c = FLAGSHIP["c"]
        sh.run_hmc_chains_sharded(0, lp_tree, params0, dataclasses.replace(cfg, num_samples=1),
                                  mesh, c)  # warm up
        walls, runs = {}, {}
        for turn in ("sharded", "local"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if turn == "local":
                runs[turn] = run_hmc_chains(1, lp_tree, params0, cfg, c)
            else:
                runs[turn] = sh.run_hmc_chains_sharded(1, lp_tree, params0, cfg, mesh, c)
            torch.cuda.synchronize()
            walls[turn] = time.perf_counter() - t0
        trace_dev = runs["sharded"].samples["w1"].device
        same = same_tensors(torch, runs["sharded"], runs["local"])
        rate = {k: c * draws * steps / v for k, v in walls.items()}
        print(f"parallel: run_hmc_chains_sharded flagship tree {c} chains {draws}x{steps} on the "
              f"1x1 mesh: identical to run_hmc_chains {same}, trace on {trace_dev}; "
              f"{rate['sharded']:,.1f} grad-steps/s sharded, {rate['local']:,.1f} unsharded "
              f"[{card}]")
        if not (same and trace_dev.type == "cuda"):
            raise SmokeError(f"run_hmc_chains_sharded: identical {same}, trace on {trace_dev}")

        # 2. the data-summed flagship likelihood against the full-batch potential
        loglik, prior, x, y, theta0 = flagship_shards(torch, device)
        lp_flat, _ = make_flagship_potential(device=device)
        cfg_d = dataclasses.replace(cfg, num_samples=PARALLEL_DRAWS)
        # warm up both: the data group's first all-reduce creates its NCCL
        # communicator, a one-time cost that is not a gradient's
        warm = dataclasses.replace(cfg, num_samples=1)
        sh.sample_chains_sharded(2, loglik, prior, x, y, theta0, warm, mesh, c)
        run_hmc_chains(2, lp_flat, theta0, warm, c)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = sh.sample_chains_sharded(2, loglik, prior, x, y, theta0, cfg_d, mesh, c)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = run_hmc_chains(2, lp_flat, theta0, cfg_d, c)
        torch.cuda.synchronize()
        wall_l = time.perf_counter() - t0
        err = float((got.samples - want.samples).abs().max()) / float(want.samples.abs().max())
        n_grad = c * PARALLEL_DRAWS * steps
        print(f"parallel: sample_chains_sharded flagship likelihood (1x1 mesh, {c} chains x "
              f"{PARALLEL_DRAWS} x {steps}): {err:.3e} of max |theta| from the full-batch run, accepts "
              f"identical {torch.equal(got.stats.accepted, want.stats.accepted)}; "
              f"{n_grad / wall_s:,.1f} grad-steps/s with the all-reduce a gradient, "
              f"{n_grad / wall_l:,.1f} without [{card}]")
        if not err <= 1e-6:
            raise SmokeError(f"sample_chains_sharded: {err:.3e} from the full-batch run")
        # one batched evaluation (value and gradient of 64 chains) with and
        # without the data-summing autograd.Function and its all-reduce
        from hamiltorch_tpu_torch.ops.potential import value_and_grad

        thetas = theta0.expand(c, -1).contiguous()
        lp_psum = sh.make_psum_log_prob(loglik, prior, x, y, mesh.get_group("data"))
        per_eval = {}
        for name, fn in (("psum", lp_psum), ("plain", lp_flat), ("psum", lp_psum),
                         ("plain", lp_flat)):
            vg = torch.func.vmap(value_and_grad(fn))
            vg(thetas)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                vg(thetas)
            torch.cuda.synchronize()
            per_eval[name] = min(per_eval.get(name, 1e9), (time.perf_counter() - t0) / 20 * 1e3)
        print(f"parallel: one batched value and gradient of {c} flagship chains: "
              f"{per_eval['psum']:.3f} ms through make_psum_log_prob (one all-reduce of "
              f"{c} x {theta0.numel() + 1} float32), {per_eval['plain']:.3f} ms plain (host "
              f"clock after a sync, 20 calls, best of 2 in turns) [{card}]")

        # 3. the pooled ensemble and SVGD on the flagship, against their local runs
        cfg_c = ChEESConfig(num_samples=PARALLEL_DRAWS, step_size=2e-4, burn=PARALLEL_DRAWS // 2,
                            init_trajectory_length=0.01)
        got = sh.run_chees_sharded(3, lp_flat, theta0, cfg_c, mesh, c)
        want = run_chees(3, lp_flat, theta0, cfg_c, c)
        same_c = same_tensors(torch, got, want)
        cfg_v = SVGDConfig(num_steps=PARALLEL_DRAWS)
        got_v = sh.run_svgd_sharded(4, loglik, prior, x, y, theta0, cfg_v, mesh, SVGD_PARTICLES)
        want_v = run_svgd(4, lp_flat, theta0, cfg_v, SVGD_PARTICLES)
        err_v = float((got_v.particles - want_v.particles).abs().max()) / float(
            want_v.particles.abs().max())
        print(f"parallel: run_chees_sharded {c} chains x {PARALLEL_DRAWS} identical to run_chees "
              f"{same_c} (leapfrogs {got.info.num_leapfrog.tolist()}); run_svgd_sharded "
              f"{SVGD_PARTICLES} particles x {PARALLEL_DRAWS} steps {err_v:.3e} of max |x| from "
              f"run_svgd on the full potential, identical {torch.equal(got_v.particles, want_v.particles)}")
        if not (same_c and err_v <= 1e-6 and int(got_v.num_rejected) == 0):
            raise SmokeError(f"run_chees_sharded identical {same_c}; run_svgd_sharded {err_v:.3e}")
    finally:
        dist.destroy_process_group()


def tiny_card_vs_cpu(torch, device):
    """The port's tensor path is the same on the card as on the CPU."""
    from hamiltorch_tpu_torch import MCMCConfig, run_hmc_chains
    from hamiltorch_tpu_torch.models.flagship import make_flagship_potential_tree

    lp_c, p_c = make_flagship_potential_tree(in_dim=8, hidden=4, n_data=16, device=device)
    lp_h, p_h = make_flagship_potential_tree(in_dim=8, hidden=4, n_data=16, device="cpu")
    gen = torch.Generator().manual_seed(2)
    z, u = torch.randn(5, 4, 41, generator=gen), torch.rand(5, 4, generator=gen)
    cfg = MCMCConfig(num_samples=5, num_steps_per_sample=5, step_size=0.05)
    on_card = run_hmc_chains(0, lp_c, p_c, cfg, 4, _noise=(z.to(device), u.log().to(device)))
    on_host = run_hmc_chains(0, lp_h, p_h, cfg, 4, _noise=(z, u.log()))
    path_err = max(float((on_card.samples[k].cpu() - on_host.samples[k]).abs().max())
                   for k in on_host.samples)
    print(f"run_hmc_chains tiny flagship, card vs CPU: max_abs_err {path_err:.3e}")
    if not path_err <= ATOL:
        raise SmokeError(f"run_hmc_chains on the card disagrees with the CPU: {path_err:.3e}")


def _spread_run(case, seed, draws=None):
    """One seed of ``evidence_spread`` in a worker process: ``(log Z,
    analytic log Z, seconds)``; ``draws = (draws, burn)`` overrides a TI
    case's."""
    import torch

    sys.path.insert(0, str(REPO))
    if draws is not None:
        global EVIDENCE_DRAWS, EVIDENCE_BURN, LINREG_TI_DRAWS, LINREG_TI_BURN
        if case == "ti_linreg":
            LINREG_TI_DRAWS, LINREG_TI_BURN = draws
        else:
            EVIDENCE_DRAWS, EVIDENCE_BURN = draws
    t0 = time.perf_counter()
    est, exact, _ = evidence_case(torch, case, seed, torch.device("cuda:0"))
    return est, exact, time.perf_counter() - t0


def evidence_spread(argv) -> int:
    """``python3 chip_smoke.py --evidence-spread CASE [--draws N BURN]
    [SEED ...]``: the seed-to-seed spread on the card of one of the
    ``evidence`` phase's statistical runs (``EVIDENCE_CASES``, at the
    phase's settings, or for a TI case at ``--draws`` draws with ``BURN``
    burned), against which its gates are set.  The seeds run in one
    process a CPU core (the runs are host-bound).  Each seed's error
    against the analytic log Z is printed, then their mean, standard
    deviation and largest |error|, and for an SMC case the same of the
    medians of consecutive groups of ``SMC_RUNS`` seeds (the phase gates
    such a median).  Seeds 1-16 by default."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import torch

    if not argv or argv[0] not in EVIDENCE_CASES:
        print(f"usage: chip_smoke.py --evidence-spread {{{','.join(EVIDENCE_CASES)}}} [SEED ...]",
              file=sys.stderr)
        return 2
    if not (REPO / "hamiltorch_tpu_torch").is_dir() or not torch.cuda.is_available():
        print("--evidence-spread runs on a GPU from a checkout of the repository",
              file=sys.stderr)
        return 2
    case, rest, draws = argv[0], argv[1:], None
    if rest[:1] == ["--draws"]:
        if not case.startswith("ti"):
            print("--draws applies to the TI cases", file=sys.stderr)
            return 2
        draws, rest = (int(rest[1]), int(rest[2])), rest[3:]
    seeds = [int(s) for s in rest] or list(range(1, 17))
    workers = min(len(seeds), os.cpu_count() or 1)
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        runs = list(pool.map(_spread_run, [case] * len(seeds), seeds, [draws] * len(seeds)))
    errs = []
    for seed, (est, exact, sec) in zip(seeds, runs):
        errs.append(est - exact)
        print(f"{case} seed {seed}: log Z {est:.4f}, analytic {exact:.4f}, error "
              f"{est - exact:+.4f} ({sec:.1f} s beside {workers - 1} other processes)")

    def stats(v):
        sd = statistics.stdev(v) if len(v) > 1 else float("nan")
        return (f"mean error {statistics.fmean(v):+.4f}, sd {sd:.4f}, max |error| "
                f"{max(map(abs, v)):.4f}")

    at = "" if draws is None else f" at {draws[0]} draws (burn {draws[1]})"
    print(f"{case}{at} on the card [{card_line()}]: {len(errs)} seeds, {stats(errs)}")
    if case.startswith("smc") and len(errs) >= SMC_RUNS:
        meds = [statistics.median(errs[i:i + SMC_RUNS])
                for i in range(0, len(errs) - SMC_RUNS + 1, SMC_RUNS)]
        print(f"{case}: medians of {SMC_RUNS} consecutive seeds, {len(meds)} groups, "
              f"{stats(meds)}")
    return 0


def main() -> int:
    if not (REPO / "hamiltorch_tpu_torch").is_dir():
        print("chip_smoke.py must run from a checkout of the repository", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs only on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda:0")
    t_all = time.perf_counter()

    # 1. the card
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind} "
          f"count {torch.cuda.device_count()}")

    # 2. build every kernel from the checkout's sources
    from hamiltorch_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build_all([name for name, *_ in KERNELS]
                            + ["bnn_grad", "frn_tlu", "conv3x3", PROBES])
    logs = {Path(name).stem: log for name, log in logs.items()}
    print(f"build: {time.perf_counter() - t0:.1f} s ({', '.join(logs) or 'cached'})")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  [{name}] {line.strip()}")
    tensor_core_check()

    # 3. kernel vs plain: one gradient alone, then the samplers on injected noise
    errs = {}
    for shape, seed in ((FLAGSHIP, 5), (dict(n=100, i=50, h=128, c=3), 3),
                        (dict(n=200, i=784, h=256, c=2), 4)):
        compare_bnn_gradient(torch, shape, seed, device)
    # both bnn_hmc shapes reject a few draws, so accept decisions are tested too
    _, small_acc = compare_bnn_hmc(torch, dict(n=100, i=50, h=128, c=3), draws=4, steps=4,
                                   eps=0.02, seed=3, device=device)
    errs["bnn_hmc"], flagship_acc = compare_bnn_hmc(torch, FLAGSHIP, draws=3, steps=5, eps=0.01,
                                                    seed=5, device=device)
    if not (0.0 < small_acc < 1.0 and 0.0 < flagship_acc < 1.0):
        raise SmokeError(f"acceptance {small_acc}, {flagship_acc}: a Metropolis outcome never occurred")
    # MCLMC's gradient bends a unit velocity spread over ~1e5 dims, so its
    # part of the move clears SIGNAL in every block only at large steps
    # (eps 2, 5 draws; at eps 0.5 the b1 block moves 5e-5)
    compare_bnn_mclmc(torch, dict(n=100, i=50, h=128, c=3), draws=5, eps=2.0, length=10.0,
                      seed=3, device=device)
    errs["bnn_mclmc"] = compare_bnn_mclmc(torch, FLAGSHIP, draws=5, eps=2.0, length=10.0, seed=5,
                                          device=device)
    # a velocity anti-parallel to the gradient, at a step where zeta = 0.04
    errs["bnn_mclmc"] = max(errs["bnn_mclmc"], compare_bnn_mclmc(
        torch, FLAGSHIP, draws=2, eps=None, length=None, seed=6, device=device, anti_parallel=True))
    # one shape per variant of gaussian_hmc's kernel, and every shape its
    # main path launches: (D, dense, chains)
    errs["gaussian_hmc"] = max(
        compare_gaussian_hmc(torch, d, dense, chains, 20, 6, 0.2, seed=seed, device=device)
        for seed, (d, dense, chains) in enumerate((
            (3, False, 256), (3, False, 37),  # 4 lanes per chain; ragged chain count
            (20, False, 64), (20, True, 64),  # 32 lanes per chain
            (200, False, 64),  # a warp per chain
            (128, True, 64),  # tensor cores, 3xTF32
            (192, True, 37),  # beyond the tensor-core variant's range: float32 FMA
            (2, True, 256), (2, False, 256), (3, False, 16), (64, True, 256),  # the main path's
            (1000, False, 64), (512, True, 64),
        ), start=3))
    # the any-D variant (5): beyond 256 diagonal and 240 dense, ragged D included
    from hamiltorch_tpu_torch.kernels.gaussian_hmc import _plan

    for seed, d, dense, chains, group in WIDE_SHAPES:
        plan = _plan(d, dense, 8, chains)
        if (plan.variant, plan.group) != (5, group):
            raise SmokeError(f"D={d} dense={dense} at {chains} chains plans {plan}, "
                             f"not variant 5 with group {group}")
    wide_err = max(compare_gaussian_hmc(torch, d, dense, chains, 20, 6, 0.2, seed=seed, device=device)
                   for seed, d, dense, chains, _ in WIDE_SHAPES)
    wide_err = max([wide_err] + [compare_forced_wide(torch, d, dense, device)
                                 for d, dense in FORCED_SHAPES])
    errs["gaussian_hmc"] = max(errs["gaussian_hmc"], wide_err)
    print(f"gaussian_hmc any-D variant: worst max_abs_err {wide_err:.3e}")

    # 4. kernels alone on Philox, their plain versions and cuBLAS, timed
    pair_ms, gemm_ms = bnn_gemm_ms(torch, device)
    flops = gradient_flops(FLAGSHIP)
    print(f"flagship GEMM pair (W1^T x^T and da^T x, 64 chains): kernel {pair_ms:.4f} ms per gradient "
          f"(3xTF32 wgmma, with epilogues and the per-chain reduction), cuBLAS float32 "
          f"{gemm_ms:.4f} ms; bounds {bound(flops, 0)[0]:.4f} ms (float32 FMA), "
          f"{tf32_bound_ms(flops):.4f} ms (3xTF32 tensor cores) [{card}]")
    gradient_anatomy(torch, device, card)
    draws, steps, eps = 10, 50, 2e-4
    times = {
        "bnn_hmc": time_bnn_hmc(torch, device, gemm_ms, draws, steps, eps, card),
        "bnn_mclmc": time_bnn_mclmc(torch, device, gemm_ms, 500, 2e-3, 10.0, card),
    }
    fma_latency_cycles(torch, device, 4096)  # warm up
    (fma_cycles, probe_hz), clock_hz = fma_latency_cycles(torch, device, 1 << 20), max_sm_clock_hz()
    fma_ns = fma_cycles / clock_hz * 1e9
    print(f"dependent float32 FMA: {fma_cycles:.3f} cycles (probe kernel, which ran at "
          f"{probe_hz / 1e6:.0f} MHz), {fma_ns:.4f} ns at the card's maximum SM clock of "
          f"{clock_hz / 1e6:.0f} MHz [{card}]")
    mma_cyc = mma_cycles(torch, device)
    mma_ns = mma_cyc / clock_hz * 1e9
    print(f"mma.sync.m16n8k8 tf32: {mma_cyc:.3f} cycles per instruction and SM sub-core (probe "
          f"kernel, 8 warps): {2 * 16 * 8 * 8 * 4 * 132 / mma_ns / 1e3:.1f} TFLOP/s over 132 SMs "
          f"against the {PEAK_TF32 / 1e12:.0f} TFLOP/s that wgmma reaches [{card}]")
    time_gaussian_hmc(torch, device, 3, False, 1024, 1000, 6, 0.2, card, fma_ns, mma_ns)
    # many chains: the lane groups fill their warps and the time is throughput
    time_gaussian_hmc(torch, device, 3, False, 65536, 100, 6, 0.2, card, fma_ns, mma_ns)
    times["gaussian_hmc"] = time_gaussian_hmc(torch, device, 128, True, 1024, 200, 10, 0.2, card,
                                              fma_ns, mma_ns)
    # the any-D variant at D=1024
    wide_times = {dense: time_gaussian_hmc(torch, device, 1024, dense, 1024, 100, 10, 0.2, card,
                                           fma_ns, mma_ns) for dense in (False, True)}

    frn = frn_tlu_phase(torch, device, card)
    conv = conv3x3_phase(torch, device, card)

    # 5. the main paths, each counted from 0
    t_paths = time.perf_counter()
    launches = {
        "bnn_hmc": hmc_main_path(torch, device, draws, steps, eps, card),
        "bnn_mclmc": mclmc_main_path(torch, device, card),
    }
    launches["gaussian_hmc"], draws_3d = gaussian_main_path(torch, device)
    print(f"main-path launches: {launches}")
    for name, count in launches.items():
        if count < 1:
            raise SmokeError(f"kernel {name} was not launched on its main path")
    # the paths of this slice run no kernel of their own (no TPU kernel is on them)
    diagnostics_on_card(torch, draws_3d)
    mams_main_path(torch, device, card)
    warmup_main_path(torch, device, card)
    # the BNN layer on an nn.Module: sample_model runs the unfused run_hmc,
    # as the JAX package's does, so no kernel of the port is on it
    from hamiltorch_tpu_torch.kernels import bnn_hmc, bnn_mclmc, gaussian_hmc

    kernel_fns = (bnn_hmc, bnn_mclmc, gaussian_hmc)
    for kernel in kernel_fns:
        kernel.launches = 0
    t_model = time.perf_counter()
    bnn_model_path(torch, device, card)
    print(f"bnn_model phase: {time.perf_counter() - t_model:.1f} s, kernel launches "
          f"{ {kernel.__name__: kernel.launches for kernel in kernel_fns} }")
    # tree-doubling NUTS, checkpoint/resume, RMHMC, split HMC, ChEES,
    # SG-MCMC, parallel tempering, TI, SMC, Barker, the stretch move,
    # elliptical slice and optim: no kernel of the port on them
    for phase, fn in (("cnn_lstm", cnn_lstm_path), ("nuts", nuts_path),
                      ("checkpoint", checkpoint_path),
                      ("rmhmc", rmhmc_path), ("split", split_path), ("chees", chees_path),
                      ("sgmcmc", sgmcmc_path), ("tempering", tempering_path),
                      ("evidence", evidence_path), ("gradient_free", gradient_free_path),
                      ("optim", optim_path), ("svgd", svgd_path), ("parallel", parallel_path)):
        for kernel in kernel_fns:
            kernel.launches = 0
        t_phase = time.perf_counter()
        fn(torch, device, card)
        counts = {kernel.__name__: kernel.launches for kernel in kernel_fns}
        print(f"{phase} phase: {time.perf_counter() - t_phase:.1f} s, kernel launches {counts}")
        if any(counts.values()):
            raise SmokeError(f"the {phase} phase launched a fused kernel: {counts}")
    print(f"main paths: {time.perf_counter() - t_paths:.1f} s")

    # 6. the tiny flagship, card vs CPU
    tiny_card_vs_cpu(torch, device)

    print(f"total {time.perf_counter() - t_all:.1f} s")
    summary = [{"name": name, "route": route, "source": source, "replaces": replaces,
                "launches": launches[name], "max_abs_err": errs[name], **times[name]}
               for name, route, source, replaces in KERNELS]
    gauss = summary[-1]
    summary.append({"name": "frn_tlu", "route": "cuda",
                    "source": "hamiltorch_tpu_torch/kernels/csrc/frn_tlu.cu", "replaces": None,
                    **frn})
    summary.append({"name": "conv3x3", "route": "cuda",
                    "source": "hamiltorch_tpu_torch/kernels/csrc/conv3x3.cu", "replaces": None,
                    **conv})
    gauss["max_abs_err_variant5"] = wide_err
    for dense, t in wide_times.items():
        gauss[f"variant5_d1024_{'dense' if dense else 'diagonal'}"] = {
            k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "bound_ops_peak",
                              "library_ms", "bound_3xtf32_ms")}
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--evidence-spread"]:
        sys.exit(evidence_spread(sys.argv[2:]))
    if sys.argv[1:2] == ["--frn-tlu"]:
        sys.exit(frn_tlu_only())
    if sys.argv[1:2] == ["--conv3x3"]:
        sys.exit(conv3x3_only())
    if sys.argv[1:2] == ["--cnn-lstm"]:
        sys.exit(cnn_lstm_only())
    sys.exit(main())

"""hamiltorch_tpu_torch — the PyTorch/CUDA port of ``hamiltorch_tpu``.

A second package beside the JAX one, which stays the reference.  Module
paths and public names mirror ``hamiltorch_tpu``'s, so each counterpart is
found under the same name.  This package imports ``torch`` and never
``jax``.

Ported so far: the HMC chain sampler (``sample`` for ``Sampler.HMC`` /
``HMC_NUTS``, ``run_hmc``, ``run_hmc_chains``) with its potential, mass
(block-diagonal included), leapfrog, dual-averaging, windowed mass warmup
and driver layers; MCLMC (``run_mclmc``, ``run_mclmc_chains``); MAMS
(``run_mams``, ``run_mams_chains``); the diagnostics (``diagnostics``:
ESS, R-hat, ``summary``); the flagship BNN models; and the fused samplers
``kernels.bnn_hmc``, ``kernels.bnn_mclmc`` and ``kernels.gaussian_hmc`` as
CUDA kernels for Hopper.  ROADMAP.md lists what is still to port.
"""

__version__ = "0.6.0"

from .api import sample
from .enums import Integrator, Metric, Sampler
from .samplers.driver import MCMCConfig, MCMCResult, MCMCStats
from .samplers.hmc import run_hmc, run_hmc_chains
from .samplers.mams import MAMSConfig, MAMSResult, run_mams, run_mams_chains
from .samplers.mclmc import MCLMCConfig, MCLMCResult, run_mclmc, run_mclmc_chains
from .utils.rng import next_key, set_random_seed

__all__ = [
    "sample",
    "Sampler",
    "Integrator",
    "Metric",
    "set_random_seed",
    "next_key",
    "run_hmc",
    "run_hmc_chains",
    "MCMCConfig",
    "MCMCResult",
    "MCMCStats",
    "run_mclmc",
    "run_mclmc_chains",
    "MCLMCConfig",
    "MCLMCResult",
    "MAMSConfig",
    "MAMSResult",
    "run_mams",
    "run_mams_chains",
]

"""hamiltorch_tpu_torch — the PyTorch/CUDA port of ``hamiltorch_tpu``.

A second package beside the JAX one, which stays the reference.  Module
paths and public names mirror ``hamiltorch_tpu``'s, so each counterpart is
found under the same name.  This package imports ``torch`` and never
``jax``.

Ported so far: ``sample`` with every sampler, integrator and metric of the
JAX package's, progress lines and ``store_on_GPU=False``; the HMC chain
sampler (``run_hmc``, ``run_hmc_chains``, ``run_hmc_host_offload``) with
its potential, mass (block-diagonal included), leapfrog, dual-averaging,
windowed mass warmup and driver layers; tree-doubling NUTS (``run_nuts``,
``run_nuts_chains``, ``run_nuts_ensemble``,
``samplers.run_nuts_host_offload``); Riemannian-manifold HMC
(``run_rmhmc``, ``run_rmhmc_chains``, ``samplers.run_rmhmc_host_offload``;
``ops.metrics``, the implicit, explicit and midpoint integrators);
symmetric-split minibatch HMC (``samplers.run_split_hmc``,
``run_split_hmc_stacked``, ``run_split_hmc_chains``,
``run_split_hmc_host_offload``; ``sample_split_model``); ChEES-HMC
(``run_chees``); stochastic-gradient MCMC (``run_sgld``, ``run_sghmc``,
their ``_chains`` forms, cyclical ``run_csgmcmc`` / ``run_csgmcmc_chains``);
parallel tempering (``run_parallel_tempering``, ``run_pt_chains``) and the
evidence estimators, thermodynamic integration (``run_ti``) and tempered
SMC (``run_smc``, ``smc_posterior_sample``); the Barker proposal
(``run_barker``, ``run_barker_chains``), the gradient-free stretch move
(``run_stretch``) and elliptical slice sampling (``run_elliptical``,
``run_elliptical_chains``); MAP, Laplace and ADVI (``optim``:
``map_estimate``, ``laplace_approx``, ``advi``, ...); checkpoint/resume for
every family the JAX package checkpoints (``checkpoint``); MCLMC
(``run_mclmc``, ``run_mclmc_chains``); MAMS
(``run_mams``, ``run_mams_chains``); the diagnostics (``diagnostics``:
ESS, R-hat, ``summary``); model comparison (``waic``, ``psis_loo``,
``compare``); the BNN layer on ``torch.nn.Module``s (``sample_model``,
``predict_model``, ``models.bnn``); the ``hamiltorch.util`` namespace
(``util``); the flagship BNN models; Stein variational gradient descent
(``run_svgd``); chain- and data-sharded sampling over ``torch.distributed``
(``parallel.sharding``, ``parallel.multihost``); and the fused samplers
``kernels.bnn_hmc``, ``kernels.bnn_mclmc`` and ``kernels.gaussian_hmc`` as
CUDA kernels for Hopper.  ROADMAP.md lists what was left out by decision.
"""

__version__ = "0.9.0"

from . import util
from .api import sample
from .enums import Integrator, Metric, Sampler
from .model_comparison import (
    compare,
    pointwise_log_lik,
    pointwise_log_lik_from_predictions,
    psis_loo,
    waic,
)
from .optim import (
    ADVIResult,
    LaplaceResult,
    MAPResult,
    advi,
    advi_cov,
    advi_sample,
    laplace_approx,
    laplace_sample,
    map_estimate,
)
from .samplers.barker import BarkerConfig, BarkerResult, run_barker, run_barker_chains
from .samplers.chees import ChEESConfig, ChEESResult, run_chees
from .samplers.driver import MCMCConfig, MCMCResult, MCMCStats
from .samplers.hmc import run_hmc, run_hmc_chains, run_hmc_host_offload
from .samplers.mams import MAMSConfig, MAMSResult, run_mams, run_mams_chains
from .samplers.mclmc import MCLMCConfig, MCLMCResult, run_mclmc, run_mclmc_chains
from .samplers.nuts import NUTSConfig, run_nuts, run_nuts_chains, run_nuts_ensemble
from .samplers.rmhmc import run_rmhmc, run_rmhmc_chains
from .samplers.elliptical import (
    EllipticalConfig,
    EllipticalResult,
    run_elliptical,
    run_elliptical_chains,
)
from .samplers.smc import SMCConfig, run_smc, smc_posterior_sample
from .samplers.stretch import StretchConfig, StretchResult, run_stretch
from .samplers.tempering import PTConfig, run_parallel_tempering, run_pt_chains
from .samplers.ti import TIConfig, run_ti
from .samplers.sgmcmc import (
    CSGMCMCConfig,
    SGHMCConfig,
    SGLDConfig,
    SGMCMCResult,
    run_csgmcmc,
    run_csgmcmc_chains,
    run_sghmc,
    run_sghmc_chains,
    run_sgld,
    run_sgld_chains,
)
from .svgd import SVGDConfig, SVGDResult, run_svgd
from .utils.rng import next_key, set_random_seed

__all__ = [
    "sample",
    "sample_model",
    "sample_split_model",
    "predict_model",
    "Sampler",
    "Integrator",
    "Metric",
    "set_random_seed",
    "next_key",
    "run_hmc",
    "run_hmc_chains",
    "run_hmc_host_offload",
    "run_nuts",
    "run_nuts_chains",
    "run_nuts_ensemble",
    "run_rmhmc",
    "run_rmhmc_chains",
    "NUTSConfig",
    "ChEESConfig",
    "ChEESResult",
    "run_chees",
    "PTConfig",
    "run_parallel_tempering",
    "run_pt_chains",
    "SMCConfig",
    "run_smc",
    "smc_posterior_sample",
    "MCMCConfig",
    "MCMCResult",
    "MCMCStats",
    "run_mclmc",
    "run_mclmc_chains",
    "MCLMCConfig",
    "MCLMCResult",
    "BarkerConfig",
    "BarkerResult",
    "run_barker",
    "run_barker_chains",
    "MAMSConfig",
    "MAMSResult",
    "run_mams",
    "run_mams_chains",
    "StretchConfig",
    "StretchResult",
    "run_stretch",
    "EllipticalConfig",
    "EllipticalResult",
    "run_elliptical",
    "run_elliptical_chains",
    "TIConfig",
    "run_ti",
    "waic",
    "psis_loo",
    "compare",
    "pointwise_log_lik",
    "pointwise_log_lik_from_predictions",
    "SGLDConfig",
    "SGHMCConfig",
    "CSGMCMCConfig",
    "run_csgmcmc",
    "run_csgmcmc_chains",
    "run_sgld",
    "run_sgld_chains",
    "run_sghmc",
    "run_sghmc_chains",
    "map_estimate",
    "MAPResult",
    "laplace_approx",
    "laplace_sample",
    "LaplaceResult",
    "advi",
    "advi_cov",
    "advi_sample",
    "ADVIResult",
    "SVGDConfig",
    "SVGDResult",
    "run_svgd",
]


def __getattr__(name):
    # imported on first use, as in the JAX package
    if name in ("sample_model", "sample_split_model", "predict_model"):
        from . import models

        return getattr(models, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

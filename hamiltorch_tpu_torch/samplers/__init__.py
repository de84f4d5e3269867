from .adaptation import DualAveragingState, da_init, da_update
from .chees import ChEESConfig, ChEESResult, run_chees
from .driver import ChainState, MCMCConfig, MCMCResult, MCMCStats, run_mcmc
from .elliptical import (
    EllipticalConfig,
    EllipticalResult,
    EllipticalStats,
    run_elliptical,
    run_elliptical_chains,
)
from .hmc import hmc_transition, run_hmc, run_hmc_chains, run_hmc_host_offload
from .mams import MAMSConfig, MAMSResult, MAMSStats, run_mams, run_mams_chains
from .mclmc import MCLMCConfig, MCLMCResult, MCLMCStats, run_mclmc, run_mclmc_chains
from .nuts import NUTSConfig, NUTSInfo, run_nuts, run_nuts_chains, run_nuts_ensemble
from .offload import run_nuts_host_offload, run_rmhmc_host_offload, run_split_hmc_host_offload
from .rmhmc import run_rmhmc, run_rmhmc_chains
from .sgmcmc import (
    SGHMCConfig,
    SGLDConfig,
    SGMCMCResult,
    run_sghmc,
    run_sghmc_chains,
    run_sgld,
    run_sgld_chains,
)
from .smc import SMCConfig, SMCResult, run_smc, smc_posterior_sample
from .splitting import run_split_hmc, run_split_hmc_chains, run_split_hmc_stacked
from .stretch import StretchConfig, StretchResult, StretchStats, run_stretch
from .tempering import PTConfig, PTResult, run_parallel_tempering, run_pt_chains
from .ti import TIConfig, TIResult, evidence_from_loglik_draws, run_ti

# the JAX package's list (hamiltorch_tpu/samplers/__init__.py), in its order,
# for the samplers ported so far; every name listed is imported above (the
# JAX list names Stretch* without importing them)
__all__ = [
    "ChainState",
    "MCMCConfig",
    "MCMCResult",
    "MCMCStats",
    "run_mcmc",
    "run_hmc",
    "run_hmc_chains",
    "hmc_transition",
    "NUTSConfig",
    "NUTSInfo",
    "run_nuts",
    "run_nuts_chains",
    "ChEESConfig",
    "ChEESResult",
    "run_chees",
    "run_rmhmc",
    "run_rmhmc_chains",
    "run_nuts_ensemble",
    "run_split_hmc",
    "run_split_hmc_chains",
    "run_split_hmc_stacked",
    "run_hmc_host_offload",
    "run_nuts_host_offload",
    "run_rmhmc_host_offload",
    "run_split_hmc_host_offload",
    "PTConfig",
    "PTResult",
    "run_parallel_tempering",
    "run_pt_chains",
    "SMCConfig",
    "SMCResult",
    "run_smc",
    "smc_posterior_sample",
    "MCLMCConfig",
    "MCLMCResult",
    "MCLMCStats",
    "run_mclmc",
    "run_mclmc_chains",
    "MAMSConfig",
    "MAMSResult",
    "MAMSStats",
    "run_mams",
    "run_mams_chains",
    "StretchConfig",
    "StretchResult",
    "StretchStats",
    "run_stretch",
    "EllipticalConfig",
    "EllipticalResult",
    "EllipticalStats",
    "run_elliptical",
    "run_elliptical_chains",
    "TIConfig",
    "TIResult",
    "run_ti",
    "evidence_from_loglik_draws",
    "SGLDConfig",
    "SGHMCConfig",
    "SGMCMCResult",
    "run_sgld",
    "run_sgld_chains",
    "run_sghmc",
    "run_sghmc_chains",
    "DualAveragingState",
    "da_init",
    "da_update",
]

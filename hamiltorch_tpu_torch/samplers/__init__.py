from .adaptation import DualAveragingState, da_init, da_update
from .driver import ChainState, MCMCConfig, MCMCResult, MCMCStats, run_mcmc
from .hmc import hmc_transition, run_hmc, run_hmc_chains
from .mclmc import MCLMCConfig, MCLMCResult, MCLMCStats, run_mclmc, run_mclmc_chains

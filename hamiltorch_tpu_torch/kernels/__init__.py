"""Hand-written CUDA kernels for Hopper (sm_90a), with their plain PyTorch versions."""

from .bnn_hmc import bnn_hmc, bnn_hmc_reference
from .bnn_mclmc import bnn_mclmc, bnn_mclmc_reference
from .gaussian_hmc import gaussian_hmc, gaussian_hmc_reference

__all__ = [
    "gaussian_hmc",
    "gaussian_hmc_reference",
    "bnn_hmc",
    "bnn_hmc_reference",
    "bnn_mclmc",
    "bnn_mclmc_reference",
]

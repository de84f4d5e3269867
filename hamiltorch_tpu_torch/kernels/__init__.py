"""Hand-written CUDA kernels for Hopper (sm_90a), with their plain PyTorch versions."""

from .bnn_hmc import bnn_hmc, bnn_hmc_reference

__all__ = ["bnn_hmc", "bnn_hmc_reference"]

"""Public enums selecting sampler / integrator / metric behaviour.

API parity with the reference library's enums (reference:
hamiltorch/samplers.py:11-31), kept as plain Enums so user code that did
``hamiltorch.Sampler.HMC`` ports over unchanged.  The values are the JAX
package's (``hamiltorch_tpu.enums``), so the two packages agree on them.
"""

from enum import Enum


class Sampler(Enum):
    HMC = 1
    RMHMC = 2
    HMC_NUTS = 3  # reference semantics: HMC + dual-averaging step size only
    NUTS = 4  # extension: true tree-doubling NUTS (samplers/nuts.py)


class Integrator(Enum):
    EXPLICIT = 1
    IMPLICIT = 2
    S3 = 3
    SPLITTING = 4
    SPLITTING_RAND = 5
    SPLITTING_KMID = 6
    # extension: implicit midpoint for RMHMC (integrators/midpoint.py) —
    # one joint fixed point per step, symplectic for any Hamiltonian
    MIDPOINT = 7


class Metric(Enum):
    HESSIAN = 1
    SOFTABS = 2
    JACOBIAN_DIAG = 3

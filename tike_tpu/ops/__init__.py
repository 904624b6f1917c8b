"""Pure-functional JAX operators: the compute core of tike-tpu.

Replaces the reference's CuPy Operator classes + CUDA kernels
(`upstream/src/tike/operators/cupy/`) with jit/vmap/shard_map-friendly
functions.
"""

from .patch import patch_fwd, patch_adj, patch_fwd_padded
from .propagation import (
    propagation_fwd,
    propagation_adj,
    fresnel_spectrum_propagator,
    fresnel_fwd,
    fresnel_adj,
)
from .objective import (
    gaussian,
    gaussian_grad,
    gaussian_each_pattern,
    poisson,
    poisson_grad,
    poisson_each_pattern,
)
from .ptycho import (
    PtychoConfig,
    ptycho_fwd,
    ptycho_fwd_with_probes,
    ptycho_adj,
    ptycho_cost,
    multislice_fwd,
    intensity_from_farplane,
    simulate_intensity,
)

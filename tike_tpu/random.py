"""Random number helpers for complex data types.

Equivalent of `upstream/src/tike/random.py`. A module-level seeded
generator provides reproducible host-side randomness (batch permutations,
RANSAC subsets); jax PRNG keys are used inside jitted code.
"""

import numpy as np

from .precision import cfloating, floating

randomizer_np = np.random.default_rng()


def numpy_complex(*shape, rng=None):
    """Return a complex random array in the range [-0.5, 0.5)."""
    rng = randomizer_np if rng is None else rng
    return (
        rng.random(size=(*shape, 2), dtype=floating) - 0.5
    ).view(cfloating)[..., 0]


def jax_complex(key, *shape):
    """Return a complex random device array in the range [-0.5, 0.5).

    JAX equivalent of the reference's ``cupy_complex``
    (`random.py:22-26`): on-device complex uniforms, but driven by an
    explicit jax PRNG key so it is reproducible under jit/vmap.
    """
    import jax

    re, im = jax.random.uniform(
        key, (2, *shape), dtype=floating, minval=-0.5, maxval=0.5
    )
    return (re + 1j * im).astype(cfloating)


def cluster_wobbly_center(*args, **kwargs):
    """Deprecated alias for :func:`tike_tpu.cluster.wobbly_center`.

    Kept for parity with `random.py:29-38`.
    """
    import warnings

    warnings.warn(
        "tike_tpu.random.cluster_wobbly_center is deprecated. "
        "Use tike_tpu.cluster.wobbly_center instead.",
        DeprecationWarning,
    )
    from . import cluster

    return cluster.wobbly_center(*args, **kwargs)


def cluster_compact(*args, **kwargs):
    """Deprecated alias for :func:`tike_tpu.cluster.compact`.

    Kept for parity with `random.py:41-50`.
    """
    import warnings

    warnings.warn(
        "tike_tpu.random.cluster_compact is deprecated. "
        "Use tike_tpu.cluster.compact instead.",
        DeprecationWarning,
    )
    from . import cluster

    return cluster.compact(*args, **kwargs)

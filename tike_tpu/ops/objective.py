"""Noise-model cost functions and gradients for ptychography.

JAX equivalent of `upstream/src/tike/operators/cupy/objective.py`.
The reference fuses elementwise kernels with ``cp.fuse()``; under jit XLA
performs the same fusion automatically. Costs are means (not sums) so values
are comparable across mini-batch sizes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# --- Gaussian (amplitude least-squares) model ---


def _gaussian_elem(data, intensity):
    diff = jnp.sqrt(intensity) - jnp.sqrt(data)
    return diff * diff


def gaussian(data, intensity):
    """Mean Gaussian-model objective over all pixels."""
    return jnp.mean(_gaussian_elem(data, intensity))


def gaussian_each_pattern(data, intensity):
    """Per-pattern mean Gaussian objective. data/intensity: (N, M, M)."""
    return jnp.mean(_gaussian_elem(data, intensity), axis=(-2, -1))


def gaussian_grad(data, farplane, intensity):
    """Wirtinger gradient of the Gaussian objective wrt the farplane.

    farplane: (N, ..., M, M); data/intensity: (N, M, M). The broadcast adds
    singleton axes to align the trailing detector dims, matching the
    reference (`objective.py:31-44`).
    """
    scale = 1 - jnp.sqrt(data) / (jnp.sqrt(intensity) + 1e-9)
    extra = farplane.ndim - data.ndim
    scale = scale.reshape(data.shape[0], *([1] * extra), *data.shape[-2:])
    return farplane * scale


# --- Poisson model ---


def _poisson_elem(data, intensity):
    return intensity - data * jnp.log(intensity + 1e-9)


def poisson(data, intensity):
    """Mean Poisson-model objective over all pixels."""
    return jnp.mean(_poisson_elem(data, intensity))


def poisson_each_pattern(data, intensity):
    """Per-pattern mean Poisson objective."""
    return jnp.mean(_poisson_elem(data, intensity), axis=(-2, -1))


def poisson_grad(data, farplane, intensity):
    """Wirtinger gradient of the Poisson objective wrt the farplane."""
    scale = 1 - data / (intensity + 1e-9)
    extra = farplane.ndim - data.ndim
    scale = scale.reshape(data.shape[0], *([1] * extra), *data.shape[-2:])
    return farplane * scale


EACH_PATTERN = {
    "gaussian": gaussian_each_pattern,
    "poisson": poisson_each_pattern,
}
ELEMENTWISE = {"gaussian": _gaussian_elem, "poisson": _poisson_elem}
GRAD = {"gaussian": gaussian_grad, "poisson": poisson_grad}
COST = {"gaussian": gaussian, "poisson": poisson}

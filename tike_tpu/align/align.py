"""Alignment drivers: reconstruct, simulate, invert.

JAX equivalent of `upstream/src/tike/align/align.py:19-88`.
"""

from __future__ import annotations

import logging

import jax.numpy as jnp
import numpy as np

from tike_tpu.ops.alignment import alignment_fwd_p, alignment_inv_p
from . import solvers

__all__ = ["reconstruct", "simulate", "invert"]

logger = logging.getLogger(__name__)


def _to_device(kwargs):
    out = {}
    for key, value in kwargs.items():
        if not isinstance(value, tuple) and np.ndim(value) > 0:
            out[key] = jnp.asarray(value)
        else:
            out[key] = value
    return out


def simulate(original, **kwargs):
    """Return original transformed by the alignment operator."""
    kwargs = _to_device(kwargs)
    unaligned = alignment_fwd_p(
        jnp.asarray(original, jnp.complex64), **kwargs
    )
    return np.asarray(unaligned)


def invert(original, **kwargs):
    """Return original passed through the inverse alignment operator."""
    kwargs = _to_device(kwargs)
    aligned = alignment_inv_p(
        jnp.asarray(original, jnp.complex64), **kwargs
    )
    return np.asarray(aligned)


def reconstruct(original, unaligned, algorithm, num_iter=1, rtol=-1, **kwargs):
    """Solve the alignment problem; returns the estimated shift or flow."""
    if algorithm not in solvers.__all__:
        raise ValueError(
            "The '{}' algorithm is not an available.".format(algorithm)
        )
    logger.info(
        "{} on {:,d} - {:,d} by {:,d} images for {:,d} iterations.".format(
            algorithm, *unaligned.shape, num_iter
        )
    )
    result = getattr(solvers, algorithm)(
        None,
        original=original,
        unaligned=unaligned,
        num_iter=num_iter,
        **kwargs,
    )
    return {
        k: np.asarray(v) if np.ndim(v) > 0 else v for k, v in result.items()
    }

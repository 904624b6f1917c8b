"""Helpers for generating ptychographic deep-learning training data.

Equivalent of `upstream/src/tike/ptycho/learn.py`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from tike_tpu.ops.patch import patch_fwd
from .position import check_allowed_positions

__all__ = ["extract_patches"]

# Module-level so the jit cache survives across calls.
_patch_fwd_p = jax.jit(patch_fwd, static_argnames=("patch_width",))


def extract_patches(psi, scan, patch_width):
    """Extract patches of psi at the given scan positions.

    psi (H, W) complex; scan (POSI, 2) float32; returns
    (POSI, patch_width, patch_width) complex64 numpy array.
    """
    check_allowed_positions(scan, psi, (patch_width, patch_width))
    return np.asarray(
        _patch_fwd_p(jnp.asarray(psi), jnp.asarray(scan), patch_width)
    )

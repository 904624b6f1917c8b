"""Rotation of 2D image stacks by Lanczos remap on a rotated grid.

JAX equivalent of `upstream/src/tike/operators/cupy/rotate.py`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .interp import remap_lanczos_adj, remap_lanczos_fwd


def _rotated_grid(shape, angle, dtype=jnp.float32):
    """The rotated sample coordinates (H*W, 2) (`rotate.py:24-41`)."""
    h, w = shape[-2:]
    cos, sin = jnp.cos(angle), jnp.sin(angle)
    shifti = (h - 1) / 2.0
    shiftj = (w - 1) / 2.0
    i, j = jnp.meshgrid(
        jnp.arange(h, dtype=dtype), jnp.arange(w, dtype=dtype), indexing="ij"
    )
    i = i - shifti
    j = j - shiftj
    i1 = (+cos * i + sin * j) + shifti
    j1 = (-sin * i + cos * j) + shiftj
    return jnp.stack([i1.ravel(), j1.ravel()], axis=-1)


def rotate_fwd(unrotated, angle, cval=0.0):
    if angle is None:
        return unrotated
    shape = unrotated.shape
    h, w = shape[-2:]
    coords = _rotated_grid(shape, angle)
    fs = unrotated.reshape(-1, h, w)
    out = jax.vmap(lambda img: remap_lanczos_fwd(img, coords, 2, cval))(fs)
    return out.reshape(shape)


def rotate_adj(rotated, angle, cval=0.0):
    if angle is None:
        return rotated
    shape = rotated.shape
    h, w = shape[-2:]
    coords = _rotated_grid(shape, angle)
    gs = rotated.reshape(-1, h * w)
    out = jax.vmap(lambda pts: remap_lanczos_adj(pts, coords, 2, (h, w)))(gs)
    return out.reshape(shape)


def rotate_inv(rotated, angle, cval=0.0):
    return rotate_fwd(rotated, None if angle is None else -angle, cval)

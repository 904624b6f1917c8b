"""Per-image padding/cropping with unique corners.

JAX equivalent of `upstream/src/tike/operators/cupy/pad.py`:
the reference's per-image Python loop becomes a vmapped dynamic-slice.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("padded_shape",))
def pad_fwd(unpadded, corner=None, padded_shape=None, cval=0.0):
    """Pad a stack of images into larger frames at per-image corners.

    unpadded (N, h, w); corner (N, 2) int or None (centered); returns
    (N, H, W) filled with cval outside.
    """
    if padded_shape is None:
        padded_shape = unpadded.shape
    n, h, w = unpadded.shape
    H, W = padded_shape[-2:]
    if corner is None:
        corner = jnp.tile(
            jnp.asarray([[(H - h) // 2, (W - w) // 2]], jnp.int32), (n, 1)
        )
    corner = corner.astype(jnp.int32)
    base = jnp.full((H, W), cval, dtype=unpadded.dtype)

    def one(img, c):
        return jax.lax.dynamic_update_slice(base, img, (c[0], c[1]))

    return jax.vmap(one)(unpadded, corner)


@functools.partial(jax.jit, static_argnames=("unpadded_shape",))
def pad_adj(padded, corner=None, unpadded_shape=None):
    """Crop the per-image regions back out (adjoint of :func:`pad_fwd`)."""
    if unpadded_shape is None:
        unpadded_shape = padded.shape
    n, H, W = padded.shape
    h, w = unpadded_shape[-2:]
    if corner is None:
        corner = jnp.tile(
            jnp.asarray([[(H - h) // 2, (W - w) // 2]], jnp.int32), (n, 1)
        )
    corner = corner.astype(jnp.int32)

    def one(img, c):
        return jax.lax.dynamic_slice(img, (c[0], c[1]), (h, w))

    return jax.vmap(one)(padded, corner)


pad_inv = pad_adj

"""Sub-pixel shift of image stacks by Fourier phase ramp.

JAX equivalent of `upstream/src/tike/operators/cupy/shift.py`.
"""

from __future__ import annotations

import jax.numpy as jnp


def shift_fwd(a, shift):
    """Shift the last two axes of `a` by fractional amounts.

    a (..., H, W) complex; shift (..., 2) float broadcastable against the
    leading axes. shift is (dy, dx).
    """
    if shift is None:
        return a
    f = jnp.fft.fft2(a, axes=(-2, -1))
    fy = jnp.fft.fftfreq(a.shape[-2]).astype(shift.dtype)
    fx = jnp.fft.fftfreq(a.shape[-1]).astype(shift.dtype)
    ramp = jnp.exp(
        -2j
        * jnp.pi
        * (
            fy[:, None] * shift[..., 0, None, None]
            + fx[None, :] * shift[..., 1, None, None]
        )
    )
    return jnp.fft.ifft2(f * ramp, axes=(-2, -1))


def shift_adj(a, shift):
    """Adjoint (= inverse) shift: apply the negated shifts."""
    if shift is None:
        return a
    return shift_fwd(a, -shift)


shift_inv = shift_adj

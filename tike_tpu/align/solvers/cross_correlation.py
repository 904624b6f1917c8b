"""Subpixel phase cross-correlation image registration.

JAX equivalent of
`upstream/src/tike/align/solvers/cross_correlation.py` (itself derived
from skimage.registration.phase_cross_correlation / Guizar-Sicairos 2008):
coarse shift by FFT cross-correlation peak, refined by an upsampled
matrix-multiply DFT in a small neighborhood — the upsampled DFT is two batched
matmuls.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def _triangle(N):
    x = jnp.linspace(0, 1, N, endpoint=False) + 0.5 / N
    return 1 - jnp.abs(x - 0.5)


def _area_overlap(shape):
    """Overlapping-area weight for preferring small shifts."""
    w = _triangle(shape[-2])
    w = w[:, None] * _triangle(shape[-1])[None, :]
    return w


def _upsampled_dft(data, ups, upsample_factor, axis_offsets):
    """Batched matrix-multiply DFT around the shift estimates."""
    im2pi = -2j * np.pi
    shape = data.shape
    kernel = (
        (jnp.arange(ups) - axis_offsets[:, 1:2])[:, :, None]
        * jnp.fft.fftfreq(shape[2], upsample_factor)
    )
    kernel = jnp.exp(im2pi * kernel)
    data = jnp.einsum("ijk,ipk->ijp", kernel, data)
    kernel = (
        (jnp.arange(ups) - axis_offsets[:, 0:1])[:, :, None]
        * jnp.fft.fftfreq(shape[1], upsample_factor)
    )
    kernel = jnp.exp(im2pi * kernel)
    return jnp.einsum("ijk,ipk->ijp", kernel, data)


def cross_correlation(
    op,
    original,
    unaligned,
    upsample_factor=1,
    space="real",
    num_iter=None,
    reg_weight=1e-9,
    **kwargs,
):
    """Efficient subpixel translation alignment by cross-correlation.

    original/unaligned (N, H, W) complex. Returns {'shift': (N, 2), 'cost'}.

    The numeric core runs as one program; only the real shifts come back.
    """
    shifts = _cross_correlation_program(
        jnp.asarray(original, jnp.complex64),
        jnp.asarray(unaligned, jnp.complex64),
        upsample_factor=int(upsample_factor),
        space=str(space).lower(),
        reg_weight=float(reg_weight),
    )
    return {"shift": np.asarray(shifts).astype(np.float32), "cost": -1}


@functools.partial(
    jax.jit, static_argnames=("upsample_factor", "space", "reg_weight")
)
def _cross_correlation_program(
    original,
    unaligned,
    *,
    upsample_factor: int,
    space: str,
    reg_weight: float,
):
    if space.lower() == "fourier":
        src_freq = unaligned
        target_freq = original
    elif space.lower() == "real":
        src_freq = jnp.fft.fft2(unaligned)
        target_freq = jnp.fft.fft2(original)
    else:
        raise ValueError(f"space must be 'fourier' or 'real' not '{space}'.")

    shape = src_freq.shape
    image_product = src_freq * target_freq.conj()
    cc = jnp.fft.ifft2(image_product)

    if reg_weight > 0:
        w = jnp.fft.fftshift(_area_overlap(cc.shape)) * reg_weight
    else:
        w = 0

    A = jnp.abs(cc) + w
    maxima = jnp.argmax(A.reshape(A.shape[0], -1), axis=1)
    shifts = jnp.stack(
        jnp.unravel_index(maxima, A.shape[-2:]), axis=-1
    ).astype(jnp.float32)

    midpoints = jnp.asarray(
        [shape[1] // 2, shape[2] // 2], dtype=jnp.float32
    )
    dims = jnp.asarray([shape[1], shape[2]], dtype=jnp.float32)
    shifts = jnp.where(shifts > midpoints, shifts - dims, shifts)

    if upsample_factor > 1:
        shifts = jnp.round(shifts * upsample_factor) / upsample_factor
        upsampled_region_size = int(np.ceil(upsample_factor * 1.5))
        dftshift = np.fix(upsampled_region_size / 2.0)
        normalization = src_freq[0].size * upsample_factor**2
        sample_region_offset = dftshift - shifts * upsample_factor
        cc = _upsampled_dft(
            image_product.conj(),
            upsampled_region_size,
            upsample_factor,
            sample_region_offset,
        ).conj()
        cc = cc / normalization
        A = jnp.abs(cc)
        maxima = jnp.argmax(A.reshape(A.shape[0], -1), axis=1)
        maxima = jnp.stack(
            jnp.unravel_index(maxima, A.shape[-2:]), axis=-1
        ).astype(jnp.float32) - dftshift
        shifts = shifts + maxima / upsample_factor
    return shifts

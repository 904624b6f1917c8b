"""Free-space and Fresnel-spectrum wave propagation (JAX).

JAX equivalents of the reference operators:
- far-field propagation = ortho-normalized 2D FFT over the last two axes
  (`upstream/src/tike/operators/cupy/propagation.py:13-79`);
- Fresnel spectrum propagation between multislice planes
  (`fresnelspectprop.py:15-135`).

The reference caches cuFFT plans per shape (`cache.py:13-82`); under jit XLA
compiles and caches the FFT automatically, so no plan cache is needed.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..precision import jcfloating


def propagation_fwd(nearplane: jax.Array) -> jax.Array:
    """Far-field propagation: batched ortho 2D FFT of the last two axes."""
    return jnp.fft.fft2(nearplane, axes=(-2, -1), norm="ortho")


def propagation_adj(farplane: jax.Array) -> jax.Array:
    """Adjoint far-field propagation: batched ortho 2D IFFT."""
    return jnp.fft.ifft2(farplane, axes=(-2, -1), norm="ortho")


@functools.partial(jax.jit, static_argnames=("shape",))
def fresnel_spectrum_propagator(
    shape: tuple[int, int],
    probe_FOV: tuple[float, float] = (1e-6, 1e-6),
    distance: float = 1e-6,
    wavelength: float = 1e-9,
) -> jax.Array:
    """Build the Fresnel spectrum transfer function H(Kx, Ky).

    H = exp(i * d * sqrt((2*pi/lambda)^2 - Kx^2 - Ky^2)), fftshifted so it can
    be applied directly to an unshifted FFT. Matches the reference grid
    construction (`fresnelspectprop.py:113-135`).
    """
    n0, n1 = shape
    xgrid = (0.5 + jnp.linspace(-0.5 * n1, 0.5 * n1 - 1, num=n1)) / n1
    ygrid = (0.5 + jnp.linspace(-0.5 * n0, 0.5 * n0 - 1, num=n0)) / n0
    kx = 2 * jnp.pi * n1 * xgrid / probe_FOV[1]
    ky = 2 * jnp.pi * n0 * ygrid / probe_FOV[0]
    Kx, Ky = jnp.meshgrid(kx, ky, indexing="xy")
    arg = (2 * jnp.pi / wavelength) ** 2 - Kx**2 - Ky**2
    # sqrt of possibly-negative argument -> evanescent waves decay; use
    # complex sqrt for correctness beyond the paraxial band.
    root = jnp.sqrt(arg.astype(jnp.complex64))
    h = jnp.exp(1j * distance * root)
    return jnp.fft.fftshift(h).astype(jcfloating)


def fresnel_fwd(nearplane: jax.Array, propagator: jax.Array) -> jax.Array:
    """Short-range Fresnel propagation: IFFT(H * FFT(x)) with ortho norm."""
    f = jnp.fft.fft2(nearplane, axes=(-2, -1), norm="ortho")
    return jnp.fft.ifft2(f * propagator, axes=(-2, -1), norm="ortho")


def fresnel_adj(farplane: jax.Array, propagator: jax.Array) -> jax.Array:
    """Adjoint Fresnel propagation: IFFT(conj(H) * FFT(x))."""
    f = jnp.fft.fft2(farplane, axes=(-2, -1), norm="ortho")
    return jnp.fft.ifft2(f * jnp.conj(propagator), axes=(-2, -1), norm="ortho")

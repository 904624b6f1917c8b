"""Exitwave update options and Poisson step-length solvers.

JAX equivalent of `upstream/src/tike/ptycho/exitwave.py`.
The boolean-mask advanced indexing of the reference (dynamic shapes) is
replaced by masked reductions with static shapes, which is required for jit.
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np
import numpy.typing as npt
import jax.numpy as jnp


@dataclasses.dataclass
class ExitWaveOptions:
    """Manage data and settings related to exitwave updates."""

    measured_pixels: npt.NDArray[np.bool_]
    """Boolean detector mask: True for good pixels, False for bad ones."""

    noise_model: str = "gaussian"
    """'gaussian' OR 'poisson' noise model for the exitwave updates."""

    step_length_weight: float = 0.5
    """Weighted-average weight between previous and current step length."""

    step_length_usemodes: str = "all_modes"
    """'dominant_mode' or 'all_modes' Poisson step-length strategy."""

    step_length_start: float = 0.5
    """Initialization for the iterative step-length solver."""

    unmeasured_pixels_scaling: float = 1.00
    """Scaling of unmeasured detector regions in the exitwave update."""

    propagation_normalization: str = "ortho"
    """FFT normalization of the forward model: ortho, forward, or backward."""

    def copy_to_device(self) -> "ExitWaveOptions":
        out = dataclasses.replace(self)
        out.measured_pixels = jnp.asarray(self.measured_pixels, dtype=bool)
        return out

    def copy_to_host(self) -> "ExitWaveOptions":
        out = dataclasses.replace(self)
        out.measured_pixels = np.asarray(self.measured_pixels, dtype=bool)
        return out

    def resample(self, factor: float) -> "ExitWaveOptions":
        out = dataclasses.replace(self)
        out.measured_pixels = crop_fourier_space(
            np.asarray(self.measured_pixels),
            int(self.measured_pixels.shape[-1] * factor),
        )
        return out


def poisson_steplength_all_modes(
    xi,
    abs2_Psi,
    I_e,
    I_m,
    measured_pixels,
    step_length,
    weight_avg,
    num_iter: int = 2,
):
    """Optimal Poisson step length, one per exitwave mode.

    Shapes follow the reference (`exitwave.py:122-179`):
    xi (B, 1, 1, W, H); abs2_Psi (B, 1, M, W, H); I_m/I_e (B, W, H);
    measured_pixels (W, H) bool; step_length (B, 1, M, 1, 1).
    The masked-pixel sums use multiply-by-mask instead of boolean indexing.
    """
    mask = measured_pixels.astype(xi.dtype)
    I_e = I_e[:, None, None, :, :]
    I_m = I_m[:, None, None, :, :]
    xi_abs_Psi2 = xi * abs2_Psi
    denom_final = jnp.sum(
        xi * xi_abs_Psi2 * mask, axis=(-2, -1), keepdims=True
    )
    for _ in range(num_iter):
        xi_alpha_minus_one = xi * step_length - 1
        denom = abs2_Psi * jnp.square(xi_alpha_minus_one) + I_e - abs2_Psi
        numer = jnp.sum(
            xi_abs_Psi2 * (1 + (I_m * xi_alpha_minus_one) / denom) * mask,
            axis=(-2, -1),
            keepdims=True,
        )
        step_length = (
            step_length * (1 - weight_avg)
            + (numer / denom_final) * weight_avg
        )
    return step_length


def poisson_steplength_dominant_mode(
    xi,
    I_e,
    I_m,
    measured_pixels,
    step_length,
    weight_avg,
    num_iter: int = 2,
):
    """Optimal Poisson step length from the dominant mode only.

    Mirrors `exitwave.py:182-234` with masked reductions.
    """
    mask = measured_pixels.astype(xi.dtype)
    I_e = I_e[:, None, None, :, :]
    I_m = I_m[:, None, None, :, :]
    sum_denom = jnp.sum(
        jnp.square(xi) * I_e * mask, axis=(-2, -1), keepdims=True
    )
    for _ in range(num_iter):
        numer = xi * (I_e - I_m / (1 - step_length * xi))
        numer_over_denom = (
            jnp.sum(numer * mask, axis=(-2, -1), keepdims=True) / sum_denom
        )
        step_length = (
            (1 - weight_avg) * step_length + weight_avg * numer_over_denom
        )
    return step_length


def crop_fourier_space(x: np.ndarray, w: int) -> np.ndarray:
    """Crop a 2D frequency-space image with zero frequency in the corner."""
    assert x.shape[-2] == x.shape[-1], "Only works on square arrays right now."
    half1 = w // 2
    half0 = w - half1
    cols = np.r_[0:half0, (x.shape[-1] - half1) : x.shape[-1]]
    rows = np.r_[0:half0, (x.shape[-2] - half1) : x.shape[-2]]
    return x[..., rows, :][..., :, cols]

"""The composite ptychography forward model (JAX, functional).

JAX equivalent of the reference operator stack
(`upstream/src/tike/operators/cupy/ptycho.py:26-204`,
`multislice.py:35-279`, `convolution.py:11-154`): far-field propagation of a
probe modulated by (possibly multi-slice) object transmission patches.

Design: instead of context-manager Operator classes holding device state, the
model is a set of pure functions parameterized by a hashable static
:class:`PtychoConfig`. Everything composes with jit/vmap/shard_map.

Array conventions (identical to the reference):
- psi : (D, H, W) complex — object transmission, D slices
- scan : (B, 2) float — (y, x) min-corner probe positions
- probe : (B or 1, M, P, P) complex — M incoherent probe modes; leading axis
  is 1 for a shared probe or B for per-position (eigen) probes
- farplane : (B, M, DET, DET) complex
- data : (B, DET, DET) float — measured intensities

The reference's multislice path de-facto requires DET == P (intermediate
exitwaves are padded to DET but reused as P-sized probes); here inter-slice
propagation stays at P×P and padding to DET happens once before the far-field
FFT, which is identical when DET == P and well-defined otherwise.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from .patch import patch_fwd, patch_adj
from .propagation import (
    fresnel_adj,
    fresnel_fwd,
    fresnel_spectrum_propagator,
    propagation_adj,
    propagation_fwd,
)


@jax.tree_util.register_static
@dataclasses.dataclass(frozen=True)
class PtychoConfig:
    """Static configuration of the ptychography forward model."""

    probe_shape: int
    detector_shape: int
    nz: int
    n: int
    nslices: int = 1
    probe_wavelength: float = 1e-9
    probe_FOV_lengths: tuple = (1e-6, 1e-6)
    multislice_propagation_distance: float = 1e-6

    def __post_init__(self):
        if self.detector_shape < self.probe_shape:
            raise ValueError(
                f"detector_shape ({self.detector_shape}) must be >= "
                f"probe_shape ({self.probe_shape}); the exit wave is "
                "zero-padded (never cropped) up to the detector."
            )

    @property
    def pad(self) -> int:
        return (self.detector_shape - self.probe_shape) // 2

    def propagator(self) -> jax.Array | None:
        """The inter-slice Fresnel transfer function, or None if single-slice."""
        if self.nslices == 1:
            return None
        return fresnel_spectrum_propagator(
            (self.probe_shape, self.probe_shape),
            self.probe_FOV_lengths,
            self.multislice_propagation_distance,
            self.probe_wavelength,
        )


def _pad_to_detector(nearplane: jax.Array, cfg: PtychoConfig) -> jax.Array:
    p = cfg.pad
    extra = cfg.detector_shape - cfg.probe_shape - p
    if p == 0 and extra == 0:
        return nearplane
    widths = [(0, 0)] * (nearplane.ndim - 2) + [(p, extra), (p, extra)]
    return jnp.pad(nearplane, widths)


def _crop_from_detector(farplane: jax.Array, cfg: PtychoConfig) -> jax.Array:
    p = cfg.pad
    if p == 0 and cfg.detector_shape == cfg.probe_shape:
        return farplane
    end = p + cfg.probe_shape
    return farplane[..., p:end, p:end]


def multislice_fwd(
    cfg: PtychoConfig,
    psi: jax.Array,
    scan: jax.Array,
    probe: jax.Array,
    precision=jax.lax.Precision.HIGHEST,
    return_patches: bool = False,
):
    """Propagate the probe through all object slices.

    Returns ``(exitwave (B, M, P, P), slice_probes (D, B, M, P, P))`` where
    ``slice_probes[t]`` is the incident illumination at slice t — the
    intermediate probes the solvers reuse (`multislice.py:97-141`). With
    ``return_patches`` also returns ``slice_patches (D, B, P, P)``, the
    extracted object windows, so solver backward passes can reuse them
    instead of re-running the patch gather (the single largest HBM-traffic
    stage; bitwise-identical since psi is unchanged within a batch step).
    """
    b = scan.shape[0]
    m = probe.shape[-3]
    p = cfg.probe_shape
    probe0 = jnp.broadcast_to(probe, (b, m, p, p))

    if cfg.nslices == 1:
        patches = patch_fwd(psi[0], scan, p, precision=precision)
        exitwave = patches[:, None, :, :] * probe0
        if return_patches:
            return exitwave, probe0[None], patches[None]
        return exitwave, probe0[None]

    prop = cfg.propagator()

    def step(carry_probe, psi_slice):
        patches = patch_fwd(psi_slice, scan, p, precision=precision)
        exitwave = patches[:, None, :, :] * carry_probe
        next_probe = fresnel_fwd(exitwave, prop)
        return next_probe, (carry_probe, exitwave, patches)

    _, (slice_probes, exitwaves, slice_patches) = jax.lax.scan(
        step, probe0, psi
    )
    if return_patches:
        return exitwaves[-1], slice_probes, slice_patches
    return exitwaves[-1], slice_probes


def ptycho_fwd(
    cfg: PtychoConfig,
    psi: jax.Array,
    scan: jax.Array,
    probe: jax.Array,
) -> jax.Array:
    """Full forward model: object interaction then far-field propagation.

    probe: (B or 1, M, P, P); returns farplane (B, M, DET, DET).
    """
    exitwave, _ = multislice_fwd(cfg, psi, scan, probe)
    return propagation_fwd(_pad_to_detector(exitwave, cfg))


def ptycho_fwd_with_probes(cfg, psi, scan, probe, return_patches=False):
    """Forward model also returning per-slice incident probes for solvers.

    Solver-internal: the patch einsum runs at
    :data:`tike_tpu.precision.SOLVER_MATMUL`. With ``return_patches`` also
    returns the per-slice object windows for backward-pass reuse (see
    :func:`multislice_fwd`).
    """
    from ..precision import SOLVER_MATMUL

    out = multislice_fwd(
        cfg, psi, scan, probe,
        precision=SOLVER_MATMUL,
        return_patches=return_patches,
    )
    farplane = propagation_fwd(_pad_to_detector(out[0], cfg))
    if return_patches:
        return farplane, out[1], out[2]
    return farplane, out[1]


def intensity_from_farplane(farplane: jax.Array) -> jax.Array:
    """Detector intensity: sum of |farplane|^2 over all mode axes.

    Matches `_intensity_from_farplane` (`operators/cupy/ptycho.py:18-23`).
    """
    return jnp.sum(
        (farplane * farplane.conj()).real,
        axis=tuple(range(1, farplane.ndim - 2)),
    )


def ptycho_adj(
    cfg: PtychoConfig,
    farplane: jax.Array,
    probe: jax.Array,
    scan: jax.Array,
    psi: jax.Array,
):
    """Adjoint of the linearized forward model.

    Returns ``(psi_adj (D, H, W), probe_adj (1|B, M, P, P))`` — gradients wrt
    object (probe fixed) and probe (object fixed). Mirrors `Multislice.adj`
    (`multislice.py:144-194`) including its 1/nslices normalization of the
    object gradient.
    """
    b = scan.shape[0]
    m = probe.shape[-3]
    p = cfg.probe_shape
    diff = _crop_from_detector(propagation_adj(farplane), cfg)  # (B, M, P, P)

    _, slice_probes = multislice_fwd(cfg, psi, scan, probe)

    if cfg.nslices == 1:
        psi_adj = patch_adj(
            jnp.sum(jnp.conj(slice_probes[0]) * diff, axis=1),
            scan,
            (cfg.nz, cfg.n),
        )[None]
        patches = patch_fwd(psi[0], scan, p)
        probe_adj = jnp.conj(patches)[:, None] * diff
    else:
        prop = cfg.propagator()
        # Iterate slices from last to first; the carried "diff" becomes the
        # probe gradient propagated back through earlier slices.
        last = cfg.nslices - 1
        psi_g_last = patch_adj(
            jnp.sum(jnp.conj(slice_probes[last]) * diff, axis=1),
            scan,
            (cfg.nz, cfg.n),
        )
        patches_last = patch_fwd(psi[last], scan, p)
        probe_g = jnp.conj(patches_last)[:, None] * diff

        psi_adj_list = [psi_g_last]
        for t in range(last - 1, -1, -1):
            probe_g = fresnel_adj(probe_g, prop)
            psi_adj_list.append(
                patch_adj(
                    jnp.sum(jnp.conj(slice_probes[t]) * probe_g, axis=1),
                    scan,
                    (cfg.nz, cfg.n),
                )
            )
            patches = patch_fwd(psi[t], scan, p)
            probe_g = jnp.conj(patches)[:, None] * probe_g

        psi_adj = jnp.stack(psi_adj_list[::-1]) / cfg.nslices

    # Reduce per-position probe gradients to the shared-probe shape.
    if probe.shape[0] == 1:
        probe_adj_out = jnp.sum(
            probe_adj if cfg.nslices == 1 else probe_g, axis=0, keepdims=True
        )
    else:
        probe_adj_out = probe_adj if cfg.nslices == 1 else probe_g
    return psi_adj, probe_adj_out


@functools.partial(jax.jit, static_argnames=("cfg",))
def ptycho_cost(
    cfg: PtychoConfig,
    data: jax.Array,
    psi: jax.Array,
    scan: jax.Array,
    probe: jax.Array,
    model: str = "gaussian",
) -> jax.Array:
    from . import objective

    intensity = intensity_from_farplane(ptycho_fwd(cfg, psi, scan, probe))
    return objective.COST[model](data, intensity)


@functools.partial(jax.jit, static_argnames=("cfg",))
def simulate_intensity(
    cfg: PtychoConfig,
    psi: jax.Array,
    scan: jax.Array,
    probe: jax.Array,
) -> jax.Array:
    """Simulate noise-free detector intensities (`ptycho/ptycho.py:128-179`)."""
    return intensity_from_farplane(ptycho_fwd(cfg, psi, scan, probe))

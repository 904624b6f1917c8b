"""Object (psi) options, constraints, and helpers.

JAX equivalent of `upstream/src/tike/ptycho/object.py`.
Constraints are jit-friendly jnp functions; the 3x3 smoothing convolution is
expressed as shifted adds (XLA fuses it) rather than an ndimage call.
"""

from __future__ import annotations

import dataclasses
import logging
import typing

import numpy as np
import numpy.typing as npt
import jax.numpy as jnp

import tike_tpu.linalg
from tike_tpu.precision import cfloating, floating, integer

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class ObjectOptions:
    """Manage data and settings related to object correction."""

    convergence_tolerance: float = 0
    """Terminate early when the mnorm of the object update drops below this."""

    update_mnorm: typing.List[float] = dataclasses.field(
        init=False, default_factory=list
    )
    """A record of the previous mnorms of the object update."""

    positivity_constraint: float = 0
    """Weight passed to :func:`positivity_constraint`."""

    smoothness_constraint: float = 0
    """Weight passed to :func:`smoothness_constraint`."""

    use_adaptive_moment: bool = False
    """Whether or not to use adaptive moment."""

    vdecay: float = 0.999
    """Second-moment decay for adaptive moment."""

    mdecay: float = 0.9
    """First-moment decay for adaptive moment."""

    v: typing.Union[npt.NDArray, None] = dataclasses.field(
        init=False, default_factory=lambda: None
    )
    """The second moment for adaptive moment."""

    m: typing.Union[npt.NDArray, None] = dataclasses.field(
        init=False, default_factory=lambda: None
    )
    """The first moment for adaptive moment."""

    preconditioner: typing.Union[npt.NDArray, None] = dataclasses.field(
        init=False, default_factory=lambda: None
    )
    """Magnitude of the illumination used to condition object updates."""

    clip_magnitude: bool = False
    """Whether to force the object magnitude to remain <= 1."""

    multislice_propagation_distance: float = 1.0e-9
    """Slice-to-slice propagation distance (meters) for multislice."""

    def _clone(self) -> "ObjectOptions":
        out = ObjectOptions(
            convergence_tolerance=self.convergence_tolerance,
            positivity_constraint=self.positivity_constraint,
            smoothness_constraint=self.smoothness_constraint,
            use_adaptive_moment=self.use_adaptive_moment,
            vdecay=self.vdecay,
            mdecay=self.mdecay,
            clip_magnitude=self.clip_magnitude,
            multislice_propagation_distance=self.multislice_propagation_distance,
        )
        out.update_mnorm = list(self.update_mnorm)
        return out

    def copy_to_device(self) -> "ObjectOptions":
        out = self._clone()
        if self.v is not None:
            out.v = jnp.asarray(self.v)
        if self.m is not None:
            out.m = jnp.asarray(self.m)
        if self.preconditioner is not None:
            out.preconditioner = jnp.asarray(self.preconditioner)
        return out

    def copy_to_host(self) -> "ObjectOptions":
        out = self._clone()
        if self.v is not None:
            out.v = np.asarray(self.v)
        if self.m is not None:
            out.m = np.asarray(self.m)
        if self.preconditioner is not None:
            out.preconditioner = np.asarray(self.preconditioner)
        return out

    def resample(self, factor: float, interp=None) -> "ObjectOptions":
        # Momentum and preconditioner reset when the grid scale changes.
        return self._clone()


from tike_tpu.ptycho.probe import _host_safe


@_host_safe(("r",))
def positivity_constraint(x, r):
    """Blend x toward its own magnitude: r*|x| + (1-r)*x (`object.py:208-224`)."""
    if r > 0:
        if r > 1:
            raise ValueError(
                f"Positivity constraint must be in the range [0, 1] not {r}."
            )
        return r * jnp.abs(x) + (1 - r) * x
    return x


@_host_safe(("a",))
def smoothness_constraint(x, a):
    """Convolve with the 3x3 kernel [[a..],[a,1-8a,a],[a..]], edge-replicated.

    Mirrors `object.py:227-253`. Expressed as 8 shifted adds on a
    replicate-padded array so XLA fuses it into one elementwise pass.
    """
    if not (0 <= a < 1.0 / 8.0):
        raise ValueError(
            f"Smoothness constraint must be in range [0, 1/8) not {a}."
        )
    pad = [(0, 0)] * (x.ndim - 2) + [(1, 1), (1, 1)]
    xp = jnp.pad(x, pad, mode="edge")
    neighborhood = (
        xp[..., :-2, :-2] + xp[..., :-2, 1:-1] + xp[..., :-2, 2:]
        + xp[..., 1:-1, :-2] + xp[..., 1:-1, 2:]
        + xp[..., 2:, :-2] + xp[..., 2:, 1:-1] + xp[..., 2:, 2:]
    )
    return a * neighborhood + (1.0 - 8.0 * a) * x


@_host_safe(("a_max",))
def clip_magnitude(x, a_max=1.0):
    """Clip the complex magnitude without changing the phase."""
    magnitude = jnp.abs(x)
    scale = jnp.where(magnitude > a_max, a_max / magnitude, 1.0)
    return x * scale


def remove_object_ambiguity(psi, probe, preconditioner):
    """Remove the scaling ambiguity between probe and psi (`object.py:324-335`).

    Rescales so the illumination-weighted mean |psi| is ~0.5.
    """
    W = preconditioner.real
    W = W / tike_tpu.linalg.mnorm(W)
    object_norm = 2 * jnp.sqrt(jnp.mean(jnp.square(jnp.abs(psi)) * W))
    return psi / object_norm, probe * object_norm


def get_padded_object(scan, probe, extra: int = 0):
    """Return a 0.5-initialized object sized to cover the scan, and new scan.

    Mirrors `object.py:256-273`.
    """
    scan = np.asarray(scan)
    int_scan = scan // 1
    min_corner = np.min(int_scan, axis=-2)
    max_corner = np.max(int_scan, axis=-2)
    span = (max_corner - min_corner + probe.shape[-1] + 2 + 2 * extra).astype(
        integer
    )
    psi = np.full(tuple(span), 0.5 + 0j, dtype=cfloating)
    return psi, (scan + 1 - min_corner + extra).astype(floating)


def get_absorbtion_image(data, scan, *, rescale=1.0, method="cubic"):
    """Approximate a scanning-transmission image from diffraction patterns.

    Host-side utility (matches `object.py:281-321` in the reference): the
    total intensity of each pattern becomes one sample of an absorption map
    at its (rescaled) scan position, resampled onto an integer grid with
    ``scipy.interpolate.griddata``. Points outside the convex hull are
    filled with the maximum intensity (fully transmitting).
    """
    import scipy.interpolate

    data = np.asarray(data)
    scan = np.asarray(scan)
    rescaled = scan * rescale

    def span(x):
        return np.arange(np.floor(x.min()), np.ceil(x.max()))

    coord0, coord1 = np.meshgrid(
        span(rescaled[:, 0]), span(rescaled[:, 1]), indexing="ij"
    )
    values = np.sum(np.square(np.abs(data)), axis=(-2, -1))
    image = scipy.interpolate.griddata(
        points=rescaled,
        values=values,
        xi=(coord0.flatten(), coord1.flatten()),
        method=method,
        fill_value=np.amax(values),
    )
    return np.reshape(image, coord0.shape)

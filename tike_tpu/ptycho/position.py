"""Scan-position correction: affine model, RANSAC regularization, options.

JAX equivalent of `upstream/src/tike/ptycho/position.py`.

Coordinate conventions match the reference: scan positions are (y, x)
min-corner coordinates of the probe grid in the psi frame; positions must
keep a 1-pixel margin inside psi (see :func:`check_allowed_positions`).

Host/device split: the RANSAC affine fit is data-dependent control flow and
stays host-side numpy (the reference effectively does the same — it gathers
positions to one device); the per-position gradient math used by the solvers
is jnp (see solvers/lstsq.py).
"""

from __future__ import annotations

import dataclasses
import logging
import typing

import jax
import jax.numpy as jnp
import numpy as np
import numpy.typing as npt

import tike_tpu.linalg
from tike_tpu.precision import floating

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class AffineTransform:
    """A 2D affine transformation: scale @ shear @ rotate (+ translation)."""

    scale0: float = 1.0
    scale1: float = 1.0
    shear1: float = 0.0
    angle: float = 0.0
    t0: float = 0.0
    t1: float = 0.0

    def resample(self, factor: float) -> "AffineTransform":
        return AffineTransform(
            self.scale0,
            self.scale1,
            self.shear1,
            self.angle,
            self.t0 * factor,
            self.t1 * factor,
        )

    @classmethod
    def frombuffer(cls, buffer: np.ndarray) -> "AffineTransform":
        return AffineTransform(*(float(v) for v in buffer))

    def asbuffer(self) -> np.ndarray:
        return np.array(self.astuple())

    @classmethod
    def fromarray(cls, T: np.ndarray) -> "AffineTransform":
        """Decompose a 2x2 (or 3x2) matrix (Graphics Gems 2, Section 7.1)."""
        R = np.array(T[:2, :2], dtype=np.float64, copy=True)
        scale0 = float(np.linalg.norm(R[0]))
        if scale0 <= 0:
            return AffineTransform()
        R[0] /= scale0
        shear1 = float(R[0] @ R[1])
        R[1] -= shear1 * R[0]
        scale1 = float(np.linalg.norm(R[1]))
        if scale1 <= 0:
            return AffineTransform()
        R[1] /= scale1
        shear1 /= scale1
        angle = float(np.arccos(np.clip(R[0, 0], -1.0, 1.0)))
        return AffineTransform(
            scale0=scale0,
            scale1=scale1,
            shear1=shear1,
            angle=angle,
            t0=float(T[2, 0]) if T.shape[0] > 2 else 0.0,
            t1=float(T[2, 1]) if T.shape[0] > 2 else 0.0,
        )

    def asarray(self) -> np.ndarray:
        """Return the 2x2 scale @ shear @ rotate matrix."""
        cosx = np.cos(self.angle)
        sinx = np.sin(self.angle)
        scale = np.array(
            [[self.scale0, 0.0], [0.0, self.scale1]], dtype=floating
        )
        shear = np.array([[1.0, 0.0], [self.shear1, 1.0]], dtype=floating)
        rotate = np.array([[+cosx, -sinx], [+sinx, +cosx]], dtype=floating)
        return scale @ shear @ rotate

    def asarray3(self) -> np.ndarray:
        """Return the 3x2 matrix including translation in the last row."""
        T = np.empty((3, 2), dtype=floating)
        T[2] = (self.t0, self.t1)
        T[:2, :2] = self.asarray()
        return T

    def astuple(self) -> tuple:
        return (
            self.scale0,
            self.scale1,
            self.shear1,
            self.angle,
            self.t0,
            self.t1,
        )

    def __call__(self, x: np.ndarray, shift=True) -> np.ndarray:
        result = x @ self.asarray()
        if shift:
            result = result + np.array((self.t0, self.t1))
        return result


def estimate_global_transformation(
    positions0: np.ndarray,
    positions1: np.ndarray,
    weights: np.ndarray = None,
    transform=None,
) -> typing.Tuple[AffineTransform, float]:
    """Weighted least-squares fit of the global affine transformation."""
    a = np.pad(positions0, ((0, 0), (0, 1)), constant_values=1)
    try:
        if weights is not None:
            aw = a * weights[:, None]
            bw = positions1 * weights[:, None]
        else:
            aw, bw = a, positions1
        x, *_ = np.linalg.lstsq(aw, bw, rcond=None)
        result = AffineTransform.fromarray(x)
    except np.linalg.LinAlgError:
        result = AffineTransform()
    return result, float(np.linalg.norm(result(positions0) - positions1))


def estimate_global_transformation_ransac(
    positions0: np.ndarray,
    positions1: np.ndarray,
    weights: np.ndarray = None,
    transform: AffineTransform = AffineTransform(),
    min_sample: int = 4,
    max_error: float = 32,
    min_consensus: float = 0.75,
    max_iter: int = 20,
    rng: np.random.Generator | None = None,
) -> typing.Tuple[AffineTransform, float]:
    """RANSAC estimate of the global affine transformation.

    Mirrors `position.py:252-327`: candidate fits on random subsets, accept
    when >= min_consensus of points are within max_error, refit on inliers.
    """
    rng = np.random.default_rng() if rng is None else rng
    best_fitness = np.inf
    for subset in rng.choice(
        a=len(positions0), size=(max_iter, min_sample), replace=True
    ):
        candidate, _ = estimate_global_transformation(
            positions0[subset], positions1[subset], weights=None
        )
        position_error = np.linalg.norm(
            candidate(positions0) - positions1, axis=-1
        )
        inliers = position_error <= max_error
        if np.sum(inliers) / len(inliers) >= min_consensus:
            candidate, fitness = estimate_global_transformation(
                positions0[inliers], positions1[inliers], weights=None
            )
            if fitness < best_fitness:
                best_fitness = fitness
                transform = candidate
    return transform, best_fitness


@dataclasses.dataclass
class PositionOptions:
    """Manage data and settings related to position correction."""

    initial_scan: np.ndarray
    """The original scan positions before position correction."""

    use_adaptive_moment: bool = False
    """Whether AdaM is used to accelerate position correction updates."""

    vdecay: float = 0.999
    """Second-moment decay."""

    mdecay: float = 0.9
    """First-moment decay."""

    use_position_regularization: bool = False
    """Whether positions are constrained to an affine + random error model."""

    update_magnitude_limit: float = 0
    """Clip per-epoch position update magnitudes to this value if > 0."""

    transform: AffineTransform = AffineTransform()
    """Global transform of positions."""

    origin: npt.NDArray = dataclasses.field(
        default_factory=lambda: np.zeros(2)
    )
    """Rotation center applied before fitting the global transformation."""

    confidence: np.ndarray = dataclasses.field(default_factory=lambda: None)
    """A rating of the confidence of position information at each position."""

    update_start: int = 0
    """Start position updates at this epoch."""

    _momentum: np.ndarray = dataclasses.field(
        init=False, default_factory=lambda: None
    )

    def __post_init__(self):
        self.initial_scan = np.asarray(self.initial_scan).astype(floating)
        if self.confidence is None:
            self.confidence = np.ones(
                shape=self.initial_scan.shape, dtype=floating
            )
        if self.use_adaptive_moment:
            self._momentum = np.zeros(
                (*self.initial_scan.shape[:-1], 4), dtype=floating
            )

    def _replace_arrays(self, convert) -> "PositionOptions":
        out = PositionOptions(
            initial_scan=convert(self.initial_scan),
            use_adaptive_moment=self.use_adaptive_moment,
            vdecay=self.vdecay,
            mdecay=self.mdecay,
            use_position_regularization=self.use_position_regularization,
            update_magnitude_limit=self.update_magnitude_limit,
            transform=self.transform,
            origin=self.origin,
            confidence=None
            if self.confidence is None
            else convert(self.confidence),
            update_start=self.update_start,
        )
        if self.use_adaptive_moment and self._momentum is not None:
            out._momentum = convert(self._momentum)
        return out

    def copy_to_device(self) -> "PositionOptions":
        return self._replace_arrays(jnp.asarray)

    def copy_to_host(self) -> "PositionOptions":
        return self._replace_arrays(np.asarray)

    def split(self, indices) -> "PositionOptions":
        out = PositionOptions(
            initial_scan=np.asarray(self.initial_scan)[..., indices, :],
            use_adaptive_moment=self.use_adaptive_moment,
            vdecay=self.vdecay,
            mdecay=self.mdecay,
            use_position_regularization=self.use_position_regularization,
            update_magnitude_limit=self.update_magnitude_limit,
            transform=self.transform,
            origin=self.origin,
            confidence=None
            if self.confidence is None
            else np.asarray(self.confidence)[..., indices, :],
            update_start=self.update_start,
        )
        if self.use_adaptive_moment and self._momentum is not None:
            out._momentum = np.asarray(self._momentum)[..., indices, :]
        return out

    @staticmethod
    def join(x, reorder):
        if x is None or any(e is None for e in x):
            return None
        out = PositionOptions(
            initial_scan=np.concatenate(
                [np.asarray(e.initial_scan) for e in x], axis=0
            )[reorder],
            use_adaptive_moment=x[0].use_adaptive_moment,
            vdecay=x[0].vdecay,
            mdecay=x[0].mdecay,
            use_position_regularization=x[0].use_position_regularization,
            update_magnitude_limit=x[0].update_magnitude_limit,
            transform=x[0].transform,
            origin=x[0].origin,
            update_start=x[0].update_start,
        )
        if x[0].confidence is not None:
            out.confidence = np.concatenate(
                [np.asarray(e.confidence) for e in x], axis=0
            )[reorder]
        if x[0].use_adaptive_moment and x[0]._momentum is not None:
            out._momentum = np.concatenate(
                [np.asarray(e._momentum) for e in x], axis=0
            )[reorder]
        return out

    def resample(self, factor: float) -> "PositionOptions":
        out = self._replace_arrays(np.asarray)
        out.initial_scan = out.initial_scan * factor
        out.transform = self.transform.resample(factor)
        out.origin = self.origin * factor
        out._momentum = None  # momentum reset when grid scale changes
        if self.use_adaptive_moment:
            out._momentum = np.zeros(
                (*out.initial_scan.shape[:-1], 4), dtype=floating
            )
        return out

    # Momentum accessor views matching the reference API.
    @property
    def v(self):
        return self._momentum[..., 0:2]

    @v.setter
    def v(self, x):
        self._momentum[..., 0:2] = x

    @property
    def m(self):
        return self._momentum[..., 2:4]

    @m.setter
    def m(self, x):
        self._momentum[..., 2:4] = x


def check_allowed_positions(scan, psi, probe_shape):
    """Check that all positions are within the field of view.

    Mirrors `position.py:600-628`: positions must be >= 1 and
    positions + 1 + probe.shape <= psi.shape.
    """
    int_scan = np.asarray(scan) // 1
    min_corner = np.min(int_scan, axis=-2)
    max_corner = np.max(int_scan, axis=-2)
    valid_min = (1, 1)
    valid_max = (
        psi.shape[-2] - probe_shape[-2] - 1,
        psi.shape[-1] - probe_shape[-1] - 1,
    )
    if (
        min_corner[0] < valid_min[0]
        or min_corner[1] < valid_min[1]
        or max_corner[0] > valid_max[0]
        or max_corner[1] > valid_max[1]
    ):
        raise ValueError(
            "Scan positions must be >= 1 and "
            "scan positions + 1 + probe.shape must be <= psi.shape. "
            "psi may be too small or the scan positions may be scaled wrong. "
            f"The span of scan is {min_corner} to {max_corner}, and "
            f"the shape of psi is {psi.shape}."
        )


def _affine_position_helper(scan, position_options, max_error, relax=0.9):
    predicted = position_options.transform(
        position_options.initial_scan, shift=False
    )
    return scan * (1 - relax) + relax * predicted


def affine_position_regularization(
    updated,
    position_options: PositionOptions,
    max_error: float = 32,
    rng: np.random.Generator | None = None,
):
    """Fit and (optionally) apply the global affine position model.

    Mirrors `position.py:731-776`. ``rng`` seeds the RANSAC subset draws;
    multi-process callers must pass identical rngs so every process fits
    the same transform.
    """
    updated_np = np.asarray(updated)
    new_transform, _ = estimate_global_transformation_ransac(
        positions0=np.asarray(position_options.initial_scan)
        - position_options.origin,
        positions1=updated_np - position_options.origin,
        transform=position_options.transform,
        max_error=max_error,
        rng=rng,
    )
    position_options.transform = new_transform
    if position_options.use_position_regularization:
        updated = _affine_position_helper(
            updated_np, position_options, max_error=max_error
        )
    return updated, position_options


def gaussian_gradient(x, sigma: float = 0.333, truncate: float = 6.0):
    """1st-order Gaussian derivative of the last two axes of x.

    Returns (d/dy, d/dx) of -x like the reference (`position.py:779-810`).
    Implemented as a small explicit derivative-of-gaussian correlation.
    """
    radius = max(int(truncate * sigma + 0.5), 1)
    t = np.arange(-radius, radius + 1)
    g = np.exp(-0.5 * (t / sigma) ** 2)
    g /= g.sum()
    # Derivative of gaussian: -t/sigma^2 * g. Correlation kernel for order=1.
    dg = (-t / sigma**2) * g
    k_host = dg[::-1].copy()
    # Skip numerically-zero taps (at the default sigma=0.333 the +-2 taps
    # weigh ~1e-8 of the +-1 taps, and the center tap is exactly 0): each
    # dropped tap removes a full pass over the batch in the hot
    # position-gradient path.
    keep = np.flatnonzero(np.abs(k_host) > 1e-6 * np.abs(k_host).max())
    k = jnp.asarray(k_host, dtype=jnp.float32)

    def correlate(arr, axis):
        pad = [(0, 0)] * arr.ndim
        pad[axis] = (radius, radius)
        xp = jnp.pad(arr, pad, mode="edge")
        acc = jnp.zeros_like(arr)
        extent = arr.shape[axis]
        for i in keep:
            sl = [slice(None)] * arr.ndim
            sl[axis] = slice(i, i + extent)
            acc = acc + k[i] * xp[tuple(sl)]
        return acc

    if jnp.iscomplexobj(x):
        def corr_c(arr, axis):
            return correlate(arr.real, axis) + 1j * correlate(arr.imag, axis)
        return corr_c(-x, -2), corr_c(-x, -1)
    return correlate(-x, -2), correlate(-x, -1)


def update_positions_pd(cfg, data, psi, probe, scan, *, dx=-1.0, step=0.05):
    """Update scan positions by the gradient-of-intensity method.

    JAX equivalent of `position.py:631-706` (Dwivedi et al. 2018):
    finite-difference farplane derivatives with respect to position in each
    direction, then a per-position least-squares solve for the shift that
    best explains the intensity residual. The whole update (including the
    drift-removing recentering and the new-cost evaluation) is one jitted
    program; only the bounds check runs on host.

    Returns ``(new_scan, cost)``.
    """
    new_scan, cost = _update_positions_pd_program(
        cfg,
        jnp.asarray(data),
        psi,
        probe,
        scan,
        jnp.asarray(dx, jnp.float32),
        jnp.asarray(step, jnp.float32),
    )
    check_allowed_positions(
        np.asarray(new_scan), np.zeros(psi.shape), probe.shape
    )
    return new_scan, float(cost)


def _update_positions_pd_math(cfg, data, psi, probe, scan, dx, step):
    from tike_tpu.ops import objective
    from tike_tpu.ops.ptycho import intensity_from_farplane, ptycho_fwd

    b = scan.shape[0]
    npix = cfg.detector_shape * cfg.detector_shape
    probe2 = probe.reshape((1, *probe.shape[-3:]))  # (1, M, P, P)

    intensity = intensity_from_farplane(
        ptycho_fwd(cfg, psi, scan, probe2)
    )
    dI = (data - intensity).reshape(b, npix)

    dI_dx = jnp.zeros((b, npix), jnp.float32)
    dI_dy = jnp.zeros((b, npix), jnp.float32)
    for m in range(probe2.shape[-3]):
        pm = probe2[:, m : m + 1]
        f0 = ptycho_fwd(cfg, psi, scan, pm)
        fx = ptycho_fwd(
            cfg, psi, scan + jnp.stack([0 * dx, dx]), pm
        )
        fy = ptycho_fwd(
            cfg, psi, scan + jnp.stack([dx, 0 * dx]), pm
        )
        dI_dx = dI_dx + (
            2 * ((f0 - fx) / dx * jnp.conj(f0)).real
        ).reshape(b, npix)
        dI_dy = dI_dy + (
            2 * ((f0 - fy) / dx * jnp.conj(f0)).real
        ).reshape(b, npix)

    A = jnp.stack([dI_dy, dI_dx], axis=-1)  # (B, npix, 2)
    grad = tike_tpu.linalg.lstsq(A, dI[..., None])[..., 0]  # (B, 2)

    # Remove drift: keep the center of mass stationary.
    center0 = jnp.mean(scan, axis=-2, keepdims=True)
    new_scan = scan - step * grad
    new_scan = new_scan + center0 - jnp.mean(
        new_scan, axis=-2, keepdims=True
    )

    new_intensity = intensity_from_farplane(
        ptycho_fwd(cfg, psi, new_scan, probe2)
    )
    cost = objective.COST["gaussian"](data, new_intensity)
    return new_scan, cost


_update_positions_pd_program = jax.jit(
    _update_positions_pd_math, static_argnames=("cfg",)
)

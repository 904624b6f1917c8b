"""Probe options, eigen (variable) probes, mode factories, and constraints.

JAX equivalent of `upstream/src/tike/ptycho/probe.py`.

Probes are (1, 1, SHARED, W, H) complex64; eigen probes are
(1, EIGEN, SHARED, W, H) and eigen weights are (POSI, EIGEN + 1, SHARED).
The unique probe at a position is weights[0]*probe + sum(weights[1:]*eigen).
"""

from __future__ import annotations

import dataclasses
import logging
import typing

import jax
import jax.numpy as jnp
import numpy as np
import numpy.typing as npt

import tike_tpu.linalg as la
from tike_tpu.precision import cfloating, floating
from tike_tpu.utils.ndimage import (
    center_of_mass2d,
    gaussian_filter2d,
    integer_shift2d,
    median_filter2d,
)

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class ProbeOptions:
    """Manage data and settings related to probe correction."""

    update_start: int = 0
    """Start probe updates at this epoch."""

    update_period: int = 1
    """The number of epochs between probe updates."""

    init_rescale_from_measurements: bool = True
    """Initial rescaling of probe using measured intensity."""

    probe_photons: float = np.nan
    """The shared probe mode intensity must add up to this number."""

    probe_wavelength: float = np.nan
    """Wavelength (meters) of the probing wavefield."""

    probe_FOV_lengths: typing.Tuple[float, float] = (np.nan, np.nan)
    """Transverse field of view of the probe (meters): (vertical, horizontal)."""

    force_orthogonality: bool = False
    """Forces probes to be orthogonal each iteration."""

    force_centered_intensity: bool = False
    """Forces the probe intensity to be centered."""

    force_sparsity: float = 0.0
    """Forces this proportion of zero elements."""

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

    probe_support: float = 0.0
    """Weight of the finite probe support constraint; zero or greater."""

    probe_support_radius: float = 0.5 * 0.7
    """Radius of finite probe support as fraction of probe grid. [0.0, 0.5]."""

    probe_support_degree: float = 2.5
    """Degree of the supergaussian defining the probe support."""

    additional_probe_penalty: float = 0.0
    """Penalty applied linearly-increasing across modes to prefer low modes."""

    median_filter_abs_probe: bool = False
    """Whether to median filter the magnitude of each shared probe mode."""

    median_filter_abs_probe_px: typing.Tuple[float, float] = (1.0, 1.0)
    """Median filter pixel widths along each dimension."""

    preconditioner: typing.Union[npt.NDArray, None] = dataclasses.field(
        init=False, default_factory=lambda: None
    )

    power: typing.List[typing.List[float]] = dataclasses.field(
        init=False, default_factory=list
    )
    """The power of the primary probe modes at each iteration."""

    def recover_probe(self, epoch: int) -> bool:
        """Return whether to update probe at this epoch."""
        return (epoch >= self.update_start) and (
            epoch % self.update_period == 0
        )

    def _clone(self) -> "ProbeOptions":
        out = ProbeOptions(
            update_start=self.update_start,
            update_period=self.update_period,
            init_rescale_from_measurements=self.init_rescale_from_measurements,
            probe_photons=self.probe_photons,
            probe_wavelength=self.probe_wavelength,
            probe_FOV_lengths=self.probe_FOV_lengths,
            force_orthogonality=self.force_orthogonality,
            force_centered_intensity=self.force_centered_intensity,
            force_sparsity=self.force_sparsity,
            use_adaptive_moment=self.use_adaptive_moment,
            vdecay=self.vdecay,
            mdecay=self.mdecay,
            probe_support=self.probe_support,
            probe_support_radius=self.probe_support_radius,
            probe_support_degree=self.probe_support_degree,
            additional_probe_penalty=self.additional_probe_penalty,
            median_filter_abs_probe=self.median_filter_abs_probe,
            median_filter_abs_probe_px=self.median_filter_abs_probe_px,
        )
        out.power = self.power
        return out

    def copy_to_device(self) -> "ProbeOptions":
        out = self._clone()
        if self.v is not None:
            out.v = jnp.asarray(self.v)
        if self.m is not None:
            out.m = jnp.asarray(self.m)
        if self.preconditioner is not None:
            out.preconditioner = jnp.asarray(self.preconditioner)
        return out

    def copy_to_host(self) -> "ProbeOptions":
        out = self._clone()
        if self.v is not None:
            out.v = np.asarray(self.v)
        if self.m is not None:
            out.m = np.asarray(self.m)
        if self.preconditioner is not None:
            out.preconditioner = np.asarray(self.preconditioner)
        return out

    def resample(self, factor: float, interp=None) -> "ProbeOptions":
        # Momentum reset to zero when grid scale changes.
        return self._clone()


def _host_safe(static_argnames=()):
    """Make a probe utility callable standalone on host arrays.

    These functions run unchanged inside jitted programs (their
    ``jnp.asarray`` is a no-op on tracers). Called standalone with a host
    (numpy) array, the input runs through one jitted program and comes back
    as numpy.
    """
    import functools

    def deco(fn):
        prog = jax.jit(fn, static_argnames=static_argnames)

        @functools.wraps(fn)
        def wrapper(probe, *args, **kwargs):
            if isinstance(probe, np.ndarray):
                out = prog(jnp.asarray(probe), *args, **kwargs)
                return jax.tree_util.tree_map(
                    np.asarray,
                    out,
                    is_leaf=lambda v: hasattr(v, "shape"),
                )
            return fn(probe, *args, **kwargs)

        wrapper.__wrapped__ = fn
        return wrapper

    return deco


def get_varying_probe(shared_probe, eigen_probe=None, weights=None):
    """Combine shared and eigen probes with weights into per-position probes.

    shared_probe (..., 1, 1, SHARED, W, H); eigen_probe
    (..., 1, EIGEN, SHARED, W, H); weights (..., POSI, EIGEN+1, SHARED).
    Returns (..., POSI, 1, SHARED, W, H) unique probes (or a copy of the
    shared probe when weights is None). Mirrors `probe.py:272-303`.
    """
    if weights is None:
        return shared_probe
    unique = weights[..., 0:1, :, None, None] * shared_probe
    if eigen_probe is not None:
        m = eigen_probe.shape[-3]
        contrib = jnp.sum(
            weights[..., 1:, :m, None, None]
            * eigen_probe[..., 0:, :m, :, :],
            axis=-4,
            keepdims=True,
        )
        unique = unique.at[..., :m, :, :].add(
            contrib.astype(unique.dtype)
        )
    return unique


def constrain_variable_probe(variable_probe, weights):
    """Constrain eigen probes: normalize, orthogonalize, sort, de-outlier.

    Mirrors `probe.py:306-359`.
    """
    # Normalize variable probes; move energy into the weights.
    vnorm = la.mnorm(variable_probe, axis=(-2, -1), keepdims=True)
    variable_probe = variable_probe / (vnorm + 1e-32)
    probes_with_modes = variable_probe.shape[-3]
    weights = weights.at[..., 1:, :probes_with_modes].multiply(
        jnp.asarray(vnorm)[..., 0, 0]
    )

    # Orthogonalize across the EIGEN axis.
    variable_probe = la.orthogonalize_gs(variable_probe, axis=(-2, -1))

    # Sort probes by energy.
    power = (
        la.norm(weights[..., 1:, :probes_with_modes], axis=-3, keepdims=True)
        ** 2
    )
    weights = np.array(np.asarray(weights))  # writable host copies for sort
    variable_probe = np.array(np.asarray(variable_probe))
    for i in range(probes_with_modes):
        order = np.argsort(-np.asarray(power)[..., i].flatten())
        weights[..., 1:, i] = weights[..., 1 + order, i]
        variable_probe[..., :, i, :, :] = variable_probe[..., order, i, :, :]

    # Remove outliers from weights.
    aevol = np.abs(weights)
    weights = np.minimum(
        aevol,
        1.5 * np.percentile(aevol, 95, axis=-3, keepdims=True),
    ).astype(weights.dtype) * np.sign(weights)
    return jnp.asarray(variable_probe), jnp.asarray(weights)


def update_eigen_probe(
    R, eigen_probe, weights, patches, diff, valid=None, *, β=0.1, c=1, m=0
):
    """Update one eigen probe from residual probe updates (batch portion).

    Port of the ptychoshelves-style update (`probe.py:362-476`), vectorized:
    R (B, 1, 1, W, H) residual updates; patches (B, 1, 1, W, H);
    diff (B, 1, SHARED, W, H); eigen_probe (1, EIGEN, SHARED, W, H);
    weights (B, EIGEN+1, SHARED) — the *batch slice* of the full weights.
    `valid` is an optional (B,) 0/1 mask for padded batch entries.
    Returns (updated eigen_probe, updated weight slice).
    """
    v = jnp.ones(R.shape[0], R.real.dtype) if valid is None else valid
    v5 = v[:, None, None, None, None]
    w = weights[:, c : c + 1, m : m + 1, None, None]
    norm_weights = jnp.sum(jnp.square(w) * v5, axis=0, keepdims=True) + 1e-32

    proj = (
        jnp.real(R.conj() * eigen_probe[:, c - 1 : c, m : m + 1, :, :]) + w
    ) / norm_weights
    nvalid = jnp.sum(v) + 1e-32
    update = (
        jnp.sum(
            R * jnp.mean(proj, axis=(-2, -1), keepdims=True) * v5,
            axis=0,
            keepdims=True,
        )
        / nvalid
    )

    update_norm = la.mnorm(update, axis=(-2, -1), keepdims=True) + 1e-32
    new_eigen = eigen_probe[:, c - 1 : c, m : m + 1, :, :] + (
        β * update / update_norm
    )
    new_eigen = new_eigen / (
        la.mnorm(new_eigen, axis=(-2, -1), keepdims=True) + 1e-32
    )
    eigen_probe = eigen_probe.at[:, c - 1 : c, m : m + 1, :, :].set(new_eigen)

    # New weights for the updated eigen probe.
    phi = patches * new_eigen
    n = jnp.mean(
        jnp.real(diff[:, :, m : m + 1, :, :] * phi.conj()), axis=(-1, -2)
    )
    d = jnp.mean(jnp.square(jnp.abs(phi)), axis=(-1, -2))
    d_mean = jnp.sum(d * v[:, None, None], axis=0, keepdims=True) / nvalid
    weight_update = (n / (d + 0.1 * d_mean)) * v[:, None, None]
    weights = weights.at[:, c : c + 1, m : m + 1].add(
        weight_update.reshape(weights[:, c : c + 1, m : m + 1].shape)
    )
    return eigen_probe, weights


@_host_safe(())
def adjust_probe_power(probe, power=None):
    """Rescale probe modes to the given relative power (default 1/N)."""
    probe = jnp.asarray(probe)
    if power is None:
        power = 1.0 / np.arange(1, probe.shape[-3] + 1)
    power = jnp.asarray(power)[..., None, None]
    norm = la.norm(probe, axis=(-2, -1), keepdims=True)
    return probe * power * norm[..., 0:1, :, :] / (norm + 1e-32)


def add_modes_random_phase(probe, nmodes, rng=None):
    """Add probe modes by random linear phase shifts of the first mode.

    Mirrors `probe.py:500-531`.
    """
    rng = np.random.default_rng() if rng is None else rng
    probe = np.asarray(probe)
    all_modes = np.empty(
        (*probe.shape[:-3], nmodes, *probe.shape[-2:]), dtype=probe.dtype
    )
    pw = probe.shape[-1]
    for m in range(nmodes):
        if m < probe.shape[-3]:
            all_modes[..., m, :, :] = probe[..., m, :, :]
        else:
            shift = np.exp(
                -2j
                * np.pi
                * (rng.random((2, 1)) - 0.5)
                * ((np.arange(0, pw) + 0.5) / pw - 0.5)
            )
            all_modes[..., m, :, :] = (
                probe[..., 0, :, :] * shift[0][None] * shift[1][:, None]
            )
    return all_modes


def add_modes_cartesian_hermite(probe, nmodes: int):
    """Create probe modes from 2D Cartesian Hermite basis functions.

    Mirrors `probe.py:534-644` (Odstrcil et al. 2018): multiply the probe by
    polynomial-times-gaussian envelopes, Gram-Schmidt as you go.
    """
    if nmodes < 1:
        raise ValueError(f"nmodes cannot be less than 1. It was {nmodes}.")
    probe = np.asarray(probe)
    if probe.ndim < 3:
        raise ValueError(
            "probe should be (..., 1, W, H) not " + str(probe.shape)
        )

    M = int(np.ceil(np.sqrt(nmodes)))
    N = int(np.ceil(nmodes / M))
    X, Y = np.meshgrid(
        np.arange(probe.shape[-2]) - (probe.shape[-2] // 2 - 1),
        np.arange(probe.shape[-1]) - (probe.shape[-2] // 2 - 1),
        indexing="xy",
    )
    p2 = np.abs(probe) ** 2
    tot = np.sum(p2, axis=(-2, -1), keepdims=True)
    cenx = np.sum(X * p2, axis=(-2, -1), keepdims=True) / tot
    ceny = np.sum(Y * p2, axis=(-2, -1), keepdims=True) / tot
    varx = np.sum((X - cenx) ** 2 * p2, axis=(-2, -1), keepdims=True) / tot
    vary = np.sum((Y - ceny) ** 2 * p2, axis=(-2, -1), keepdims=True) / tot

    def _norm(x):
        return np.sqrt(np.sum(np.abs(x) ** 2, axis=(-2, -1), keepdims=True))

    new_probes = []
    for nii in range(N):
        for mii in range(M):
            basis = ((X - cenx) ** mii) * ((Y - ceny) ** nii) * probe
            if not (mii == 0 and nii == 0):
                basis = basis * np.exp(
                    -((X - cenx) ** 2) / (2 * varx)
                    - ((Y - ceny) ** 2) / (2 * vary)
                )
            basis = basis / _norm(basis)
            for H in new_probes:
                basis = basis - H * np.sum(
                    np.conj(H) * basis, axis=(-2, -1), keepdims=True
                )
            basis = basis / _norm(basis)
            new_probes.append(basis)
            if len(new_probes) == nmodes:
                return np.concatenate(new_probes, axis=-3)[
                    ..., :nmodes, :, :
                ].astype(cfloating)
    raise RuntimeError("add_modes_cartesian_hermite never reached a return.")


def simulate_varying_weights(scan, eigen_probe, rng=None):
    """Random-sinusoid eigen weights for simulation (`probe.py:648-658`)."""
    rng = np.random.default_rng() if rng is None else rng
    N = scan.shape[1]
    x = np.arange(N)[..., :, None, None]
    period = N * rng.random(eigen_probe.shape[:-2])
    phase = 2 * np.pi * rng.random(eigen_probe.shape[:-2])
    return np.sin(2 * np.pi / period * x - phase)


def init_varying_probe(
    scan, shared_probe, num_eigen_probes, probes_with_modes=1, rng=None
):
    """Initialize eigen probe and weight arrays (`probe.py:660-723`)."""
    rng = np.random.default_rng() if rng is None else rng
    probes_with_modes = max(probes_with_modes, 0)
    if probes_with_modes > shared_probe.shape[-3]:
        raise ValueError(
            f"probes_with_modes ({probes_with_modes}) cannot be more than "
            f"the number of probes ({shared_probe.shape[-3]})!"
        )
    if num_eigen_probes < 1:
        return None, None

    weights = 1e-6 * rng.random(
        (*scan.shape[:-1], num_eigen_probes, shared_probe.shape[-3])
    ).astype(floating)
    weights -= np.mean(weights, axis=-3, keepdims=True)
    weights[..., 0, :] = 1.0
    weights[..., 1:, probes_with_modes:] = 0

    if num_eigen_probes == 1:
        return None, weights

    eigen_probe = (
        rng.standard_normal(
            (
                *shared_probe.shape[:-4],
                num_eigen_probes - 1,
                probes_with_modes,
                *shared_probe.shape[-2:],
            )
        )
        + 1j
        * rng.standard_normal(
            (
                *shared_probe.shape[:-4],
                num_eigen_probes - 1,
                probes_with_modes,
                *shared_probe.shape[-2:],
            )
        )
    ).astype(cfloating)
    eigen_probe /= np.asarray(
        la.mnorm(eigen_probe, axis=(-2, -1), keepdims=True)
    )
    return eigen_probe, weights


def _orthogonalize_eig_body(x):
    """Device-side eigen orthogonalization + power-descending sort."""
    nmodes = x.shape[-3]
    flat = x.reshape(*x.shape[:-2], -1)
    # A_ij = <x_i, x_j> like the reference (`probe.py:752-759`); the
    # conjugate-transposed variant also orthogonalizes but mixes modes
    # with conjugated coefficients, producing different mode shapes than
    # the reference/PtychoShelves convention (tests/data/ortho-*.mat).
    A = jnp.conj(flat) @ jnp.swapaxes(flat, -1, -2)
    _, vectors = jnp.linalg.eigh(A)
    result = (jnp.swapaxes(vectors, -1, -2) @ flat).reshape(x.shape)
    pwr = jnp.sum((result * jnp.conj(result)).real, axis=(-2, -1))
    order = jnp.argsort(-pwr.reshape(-1))
    # Permute modes with a one-hot matmul: a (M, M) matmul is trivially
    # cheap.
    k = pwr.reshape(-1).shape[0]
    perm = jax.nn.one_hot(order, k, dtype=result.real.dtype)
    flat_modes = result.reshape(k, -1)
    sorted_modes = (
        perm @ flat_modes.real + 1j * (perm @ flat_modes.imag)
    ).astype(result.dtype)
    return sorted_modes.reshape(x.shape), pwr.reshape(-1)[order]


_orthogonalize_eig_program = jax.jit(_orthogonalize_eig_body)


def orthogonalize_eig(x):
    """Orthogonalize modes via eigenvectors of the pairwise dot product.

    Returns (orthogonalized probes sorted by power desc, power). Mirrors
    `probe.py:726-770`. One jitted program; the power vector is the only
    host transfer.
    """
    result, pwr = _orthogonalize_eig_program(jnp.asarray(x))
    if isinstance(x, np.ndarray):
        result = np.asarray(result)
    return result, np.asarray(pwr)


@jax.jit
def _power_program(probe):
    return jnp.sum((probe * jnp.conj(probe)).real, axis=(-2, -1)).reshape(-1)


def power(probe):
    """Return the power of each probe mode (`probe.py:773-781`)."""
    return np.asarray(_power_program(jnp.asarray(probe)))


def gaussian(size, rin=0.8, rout=1.0):
    """A real circular probe amplitude with soft edges (`probe.py:784-814`)."""
    r, c = np.mgrid[:size, :size] + 0.5
    rs = np.sqrt((r - size / 2) ** 2 + (c - size / 2) ** 2)
    rmax = np.sqrt(2) * 0.5 * rout * rs.max() + 1.0
    rmin = np.sqrt(2) * 0.5 * rin * rs.max()
    img = np.zeros((size, size), dtype=floating)
    img[rs < rmin] = 1.0
    img[rs > rmax] = 0.0
    zone = np.logical_and(rs > rmin, rs < rmax)
    img[zone] = np.divide(rmax - rs[zone], rmax - rmin)
    return img


@_host_safe(())
def constrain_center_peak(probe):
    """Shift the probe (<=1px/epoch) so its blurred intensity is centered.

    Mirrors `probe.py:817-856`.
    """
    probe = jnp.asarray(probe)
    half = probe.shape[-2] // 2, probe.shape[-1] // 2
    stack = probe.reshape((-1, *probe.shape[-2:]))
    intensity = gaussian_filter2d(
        jnp.sum(jnp.square(jnp.abs(stack)), axis=0),
        sigma=(half[0] / 3, half[1] / 3),
        mode="constant",
        truncate=6.0,
    )
    cy, cx = center_of_mass2d(intensity)
    dy = jnp.clip(jnp.round(half[0] - cy), -1, 1).astype(jnp.int32)
    dx = jnp.clip(jnp.round(half[1] - cx), -1, 1).astype(jnp.int32)
    shifted = integer_shift2d(stack, (dy, dx))
    return shifted.reshape(probe.shape)


@_host_safe(("med_filt_px",))
def apply_median_filter_abs_probe(probe, med_filt_px=(1.0, 1.0)):
    """Median filter each shared probe mode's magnitude (`probe.py:859-893`)."""
    probe = jnp.asarray(probe)
    abs_probe = jnp.abs(probe[0, 0])
    filt = median_filter2d(
        abs_probe, (max(int(med_filt_px[0]), 1), max(int(med_filt_px[1]), 1))
    )
    return probe.at[0, 0].set(
        (filt * jnp.exp(1j * jnp.angle(probe[0, 0]))).astype(probe.dtype)
    )


@_host_safe(("f",))
def constrain_probe_sparsity(probe, f):
    """Zero the `f` fraction of pixels with least blurred intensity.

    Mirrors `probe.py:896-916`.
    """
    if f == 0:
        return probe
    probe = jnp.asarray(probe)
    stack = probe.reshape((-1, *probe.shape[-2:]))
    intensity = jnp.sum(jnp.square(jnp.abs(stack)), axis=0)
    sigma = (probe.shape[-2] / 8, probe.shape[-1] / 8)
    intensity = gaussian_filter2d(intensity, sigma, mode="wrap")
    k = int(f * probe.shape[-1] * probe.shape[-2])
    flat = intensity.reshape(-1)
    # Threshold at the k-th smallest blurred intensity.
    kth = jnp.sort(flat)[k]
    keep = (flat >= kth).reshape(intensity.shape)
    return probe * keep


def finite_probe_support(probe, *, radius=0.5, degree=5.0, p=1.0):
    """Supergaussian penalty mask for finite probe support (`probe.py:919-961`).

    penalty = p - p * exp(-((x/radius)^2 + (y/radius)^2)^degree)
    """
    if p <= 0:
        return 0.0
    N = probe.shape[-1]
    centers = jnp.linspace(-0.5, 0.5, num=N, endpoint=False) + 0.5 / N
    i, j = jnp.meshgrid(centers, centers)
    mask = 1 - jnp.exp(
        -((jnp.square(i / radius) + jnp.square(j / radius)) ** degree)
    )
    return p * mask.astype(floating)


@_host_safe(())
def rescale_probe_using_fixed_intensity_photons(
    probe, Nphotons, probe_power_fraction=None
):
    """Rescale shared probes so intensity sums to Nphotons (`probe.py:964-991`)."""
    probe = jnp.asarray(probe)
    probe_photons = jnp.sum(jnp.abs(probe) ** 2, axis=(-1, -2))
    if probe_power_fraction is None:
        probe_power_fraction = probe_photons / jnp.sum(probe_photons)
    return probe * jnp.sqrt(
        probe_power_fraction * Nphotons / (probe_photons + 1e-32)
    )[..., None, None]

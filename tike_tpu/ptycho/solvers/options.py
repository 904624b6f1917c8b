"""Algorithm options and the PtychoParameters state object.

JAX equivalent of
`upstream/src/tike/ptycho/solvers/options.py:19-330`. PtychoParameters
is the complete solver checkpoint: probe, psi, scan, eigen probes/weights plus
all option objects, with split/join/copy/resample lifecycle. Device transfer
uses jax.device_put instead of cupy; arrays are pytree leaves so a
PtychoParameters round-trips through orbax or pickle.
"""

from __future__ import annotations

import abc
import copy
import dataclasses
import typing

import jax
import numpy as np
import numpy.typing as npt

from tike_tpu.precision import cfloating, floating
from ..exitwave import ExitWaveOptions
from ..object import ObjectOptions
from ..position import PositionOptions, check_allowed_positions
from ..probe import ProbeOptions


@dataclasses.dataclass
class IterativeOptions(abc.ABC):
    """A base class providing options for iterative algorithms."""

    name: str = dataclasses.field(default="", init=False)
    """The name of the algorithm."""

    num_batch: int = 1
    """The dataset is divided into this number of groups processed
    sequentially."""

    batch_method: str = "wobbly_center"
    """The name of the batch selection method from tike_tpu.cluster."""

    rescale_method: str = "mean_of_abs_object"
    """'mean_of_abs_object' or 'constant_probe_photons' scaling control."""

    rescale_period: int = 10
    """How often (epochs) object/probe rescaling is applied."""

    costs: typing.List[typing.List[float]] = dataclasses.field(
        init=False, default_factory=list
    )
    """The objective function value at previous iterations, per mini-batch."""

    num_iter: int = 1
    """The number of epochs to process before returning."""

    times: typing.List[float] = dataclasses.field(
        init=False, default_factory=list
    )
    """The per-iteration wall-time for each previous iteration."""

    convergence_window: int = 0
    """Number of epochs for convergence monitoring; < 2 disables."""

    time_limit: float = np.inf
    """Stop reconstruction when wall-time exceeds this number of seconds."""


@dataclasses.dataclass
class RpieOptions(IterativeOptions):
    """Options for the regularized ptychographic iterative engine."""

    name: str = dataclasses.field(default="rpie", init=False)

    num_batch: int = 5

    alpha: float = 0.05
    """Step-length control; rPIE becomes ePIE when this is 1."""


@dataclasses.dataclass
class LstsqOptions(IterativeOptions):
    """Options for the least-squares maximum-likelihood solver (LSQML)."""

    name: str = dataclasses.field(default="lstsq_grad", init=False)


@dataclasses.dataclass
class PtychoParameters:
    """The entire ptychography solver state (the checkpoint object)."""

    probe: npt.NDArray
    """(1, 1, SHARED, WIDE, HIGH) complex64 shared illumination."""

    psi: npt.NDArray
    """(DEPTH, WIDE, HIGH) complex64 object transmission."""

    scan: npt.NDArray
    """(POSI, 2) float32 probe min-corner positions (y, x)."""

    eigen_probe: typing.Union[npt.NDArray, None] = None
    """(1, EIGEN, SHARED, WIDE, HIGH) complex64 eigen probes."""

    eigen_weights: typing.Union[npt.NDArray, None] = None
    """(POSI, EIGEN+1, SHARED) float32 eigen-probe weights."""

    algorithm_options: IterativeOptions = dataclasses.field(
        default_factory=RpieOptions
    )
    """Algorithm-specific parameters."""

    exitwave_options: typing.Union[ExitWaveOptions, None] = None
    """Settings related to exitwave updates."""

    probe_options: typing.Union[ProbeOptions, None] = None
    """Settings related to probe updates."""

    object_options: typing.Union[ObjectOptions, None] = None
    """Settings related to object updates."""

    position_options: typing.Union[PositionOptions, None] = None
    """Settings related to position correction."""

    def __post_init__(self):
        # Validate via shapes only -- materializing device arrays here would
        # force device-to-host transfers on every construction.
        scan = self.scan
        if scan.ndim != 2 or scan.shape[1] != 2 or np.any(
            np.asarray(scan.shape) < 1
        ):
            raise ValueError(
                f"scan shape {scan.shape} is incorrect. It should be (N, 2) "
                "where N >= 1 is the number of scan positions."
            )
        probe = self.probe
        if (
            probe.ndim != 5
            or probe.shape[:2] != (1, 1)
            or np.any(np.asarray(probe.shape) < 1)
            or probe.shape[-2] != probe.shape[-1]
        ):
            raise ValueError(
                f"probe shape {probe.shape} is incorrect. "
                "It should be (1, 1, S, W, H) "
                "where S >=1 is the number of probes, and "
                "W, H >= 1 are the square probe grid dimensions."
            )
        psi = self.psi
        if psi.ndim != 3 or np.any(
            np.asarray(psi.shape[-2:]) <= np.asarray(probe.shape[-2:])
        ):
            raise ValueError(
                f"psi shape {psi.shape} is incorrect. "
                "It should be (D, W, H) where W, H > probe.shape[-2:]."
            )
        # Value validation only for host arrays: device arrays were already
        # validated before upload, and downloading them here would force a
        # device-to-host transfer on every construction.
        if isinstance(scan, np.ndarray):
            check_allowed_positions(scan, psi, probe.shape)
        if self.exitwave_options is None:
            self.exitwave_options = ExitWaveOptions(
                measured_pixels=np.ones(probe.shape[-2:], dtype=np.bool_)
            )

    def resample(
        self,
        factor: float,
        interp: typing.Optional[typing.Callable] = None,
    ) -> "PtychoParameters":
        """Return a new PtychoParameters rescaled by ``factor``."""
        interp = _resize_fft if interp is None else interp
        return PtychoParameters(
            probe=interp(np.asarray(self.probe), factor).astype(cfloating),
            psi=_resize_spline(np.asarray(self.psi), factor).astype(cfloating),
            scan=np.asarray(self.scan) * factor,
            eigen_probe=interp(np.asarray(self.eigen_probe), factor).astype(
                cfloating
            )
            if self.eigen_probe is not None
            else None,
            eigen_weights=self.eigen_weights,
            algorithm_options=self.algorithm_options,
            probe_options=self.probe_options.resample(factor, interp)
            if self.probe_options is not None
            else None,
            object_options=self.object_options.resample(factor, interp)
            if self.object_options is not None
            else None,
            position_options=self.position_options.resample(factor)
            if self.position_options is not None
            else None,
            exitwave_options=self.exitwave_options.resample(factor)
            if self.exitwave_options is not None
            else None,
        )

    def copy_to_device(self, sharding=None) -> "PtychoParameters":
        """Copy arrays to device (optionally with a jax.sharding spec)."""

        def put(x, dtype):
            return jax.device_put(np.asarray(x, dtype), sharding)

        return PtychoParameters(
            probe=put(self.probe, cfloating),
            psi=put(self.psi, cfloating),
            scan=put(self.scan, floating),
            eigen_probe=put(self.eigen_probe, cfloating)
            if self.eigen_probe is not None
            else None,
            eigen_weights=put(self.eigen_weights, floating)
            if self.eigen_weights is not None
            else None,
            algorithm_options=self.algorithm_options,
            exitwave_options=self.exitwave_options.copy_to_device()
            if self.exitwave_options is not None
            else None,
            probe_options=self.probe_options.copy_to_device()
            if self.probe_options is not None
            else None,
            object_options=self.object_options.copy_to_device()
            if self.object_options is not None
            else None,
            position_options=self.position_options.copy_to_device()
            if self.position_options is not None
            else None,
        )

    def copy_to_host(self) -> "PtychoParameters":
        return PtychoParameters(
            probe=np.asarray(self.probe),
            psi=np.asarray(self.psi),
            scan=np.asarray(self.scan),
            eigen_probe=np.asarray(self.eigen_probe)
            if self.eigen_probe is not None
            else None,
            eigen_weights=np.asarray(self.eigen_weights)
            if self.eigen_weights is not None
            else None,
            algorithm_options=self.algorithm_options,
            exitwave_options=self.exitwave_options.copy_to_host()
            if self.exitwave_options is not None
            else None,
            probe_options=self.probe_options.copy_to_host()
            if self.probe_options is not None
            else None,
            object_options=self.object_options.copy_to_host()
            if self.object_options is not None
            else None,
            position_options=self.position_options.copy_to_host()
            if self.position_options is not None
            else None,
        )

    @staticmethod
    def split(indices, *, x: "PtychoParameters") -> "PtychoParameters":
        """Return a new PtychoParameters with only the data from indices."""
        return PtychoParameters(
            probe=np.asarray(x.probe).astype(cfloating),
            psi=np.asarray(x.psi).astype(cfloating),
            scan=np.asarray(x.scan)[indices].astype(floating),
            eigen_probe=np.asarray(x.eigen_probe).astype(cfloating)
            if x.eigen_probe is not None
            else None,
            eigen_weights=np.asarray(x.eigen_weights)[indices].astype(floating)
            if x.eigen_weights is not None
            else None,
            algorithm_options=copy.deepcopy(x.algorithm_options),
            exitwave_options=x.exitwave_options,
            probe_options=x.probe_options,
            object_options=x.object_options,
            position_options=x.position_options.split(indices)
            if x.position_options is not None
            else None,
        )

    @staticmethod
    def join(
        x: typing.Sequence["PtychoParameters"],
        reorder,
        stripe_start: typing.List[int],
    ) -> "PtychoParameters":

        def join_psi(parts):
            joined = np.array(parts[0], copy=True)
            w = x[0].probe.shape[-2] // 2
            for i in range(1, len(parts)):
                lo = stripe_start[i] + w
                hi = (
                    stripe_start[i + 1] + w
                    if i + 1 < len(parts)
                    else parts[0].shape[1]
                )
                joined[:, lo:hi, :] = parts[i][:, lo:hi, :]
            return joined

        return PtychoParameters(
            probe=np.asarray(x[0].probe),
            psi=join_psi([np.asarray(e.psi) for e in x]),
            scan=np.concatenate([np.asarray(e.scan) for e in x], axis=0)[
                reorder
            ],
            eigen_probe=np.asarray(x[0].eigen_probe)
            if x[0].eigen_probe is not None
            else None,
            eigen_weights=np.concatenate(
                [np.asarray(e.eigen_weights) for e in x], axis=0
            )[reorder]
            if x[0].eigen_weights is not None
            else None,
            algorithm_options=x[0].algorithm_options,
            exitwave_options=x[0].exitwave_options,
            probe_options=x[0].probe_options,
            object_options=x[0].object_options,
            position_options=PositionOptions.join(
                [e.position_options for e in x], reorder
            ),
        )


def _resize_spline(x: np.ndarray, f: float) -> np.ndarray:
    import scipy.ndimage

    return scipy.ndimage.zoom(
        x, zoom=[1] * (x.ndim - 2) + [f, f], grid_mode=True, prefilter=False
    )


def crop_fourier_space(x: np.ndarray, w: int) -> np.ndarray:
    """Crop x assuming 2D frequency space with zero frequency in corner."""
    assert x.shape[-2] == x.shape[-1], "Only works on square arrays right now."
    half1 = w // 2
    half0 = w - half1
    cols = np.r_[0:half0, (x.shape[-1] - half1) : x.shape[-1]]
    rows = np.r_[0:half0, (x.shape[-2] - half1) : x.shape[-2]]
    return x[..., rows, :][..., :, cols]


def pad_fourier_space(x: np.ndarray, w: int) -> np.ndarray:
    """Pad x assuming 2D frequency space with zero frequency in corner."""
    assert x.shape[-2] == x.shape[-1], "Only works on square arrays right now."
    half1 = x.shape[-1] // 2
    half0 = x.shape[-1] - half1
    new_x = np.zeros((*x.shape[:-2], w, w), dtype=x.dtype)
    new_x[..., 0:half0, np.r_[0:half0, (w - half1) : w]] = x[..., 0:half0, :]
    new_x[..., -half1:, np.r_[0:half0, (w - half1) : w]] = x[..., -half1:, :]
    return new_x


def _resize_fft(x: np.ndarray, f: float) -> np.ndarray:
    """Fourier interpolation resize of the last 2 dimensions of x."""
    if f == 1:
        return x
    crop_or_pad = crop_fourier_space if f < 1 else pad_fourier_space
    return np.fft.ifft2(
        crop_or_pad(
            np.fft.fft2(x, norm="ortho", axes=(-2, -1)),
            w=int(x.shape[-1] * f),
        ),
        norm="ortho",
        axes=(-2, -1),
    )


def _resize_cv(x: np.ndarray, f: float, interpolation: int) -> np.ndarray:
    """Image-space resize of the last 2 dims (`options.py:342-364` analog).

    The reference delegates to OpenCV via tike.view.resize_complex_image;
    here the same helper is backed by scipy splines so the interpolator
    family works without the optional cv2 dependency.
    """
    import tike_tpu.view

    shape = x.shape
    flat = x.reshape(-1, *shape[-2:])
    out = [
        tike_tpu.view.resize_complex_image(
            img, scale_factor=(f, f), interpolation=interpolation
        )
        for img in flat
    ]
    return np.asarray(out).reshape(*shape[:-2], *out[0].shape[-2:])


def _resize_linear(x: np.ndarray, f: float) -> np.ndarray:
    return _resize_cv(x, f, 1)


def _resize_cubic(x: np.ndarray, f: float) -> np.ndarray:
    return _resize_cv(x, f, 2)


def _resize_lanczos(x: np.ndarray, f: float) -> np.ndarray:
    return _resize_cv(x, f, 4)

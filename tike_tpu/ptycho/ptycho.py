"""User-facing ptychography drivers: reconstruct, Reconstruction, simulate.

JAX equivalent of `upstream/src/tike/ptycho/ptycho.py:182-1047`.

Differences from the reference driver:
- No ThreadPool/MPI: data and scan live as (optionally sharded) jax arrays;
  multi-chip scaling shards the pattern axis over a jax.sharding.Mesh and XLA
  inserts the collectives that the reference's pool/MPI code did by hand
  (see tike_tpu.parallel).
- Mini-batches are padded to one fixed length so each epoch re-runs a single
  compiled XLA program.
"""

from __future__ import annotations

import copy
import logging
import time
import typing
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import numpy.typing as npt

import tike_tpu.cluster
from tike_tpu.ops.ptycho import (
    PtychoConfig,
    intensity_from_farplane,
    ptycho_fwd,
    simulate_intensity,
)
from tike_tpu.precision import cfloating, floating

from . import object as object_module
from . import probe as probe_module
from .position import affine_position_regularization, check_allowed_positions
from . import solvers
from .solvers import PtychoParameters
from .solvers._preconditioner import update_preconditioners

__all__ = [
    "reconstruct",
    "simulate",
    "simulate_device",
    "Reconstruction",
    "reconstruct_multigrid",
]

logger = logging.getLogger(__name__)


def _simulate_impl(
    detector_shape: int,
    probe,
    scan,
    psi,
    fly: int,
    eigen_probe,
    eigen_weights,
    to_host: bool,
    **kwargs,
):
    """Shared body of :func:`simulate` / :func:`simulate_device`.

    Per probe mode, apply the varying probe and accumulate |farplane|^2 —
    one program per mode. ``to_host`` selects whether each mode's intensity
    is brought back to numpy or the accumulation stays device-resident.
    """
    probe = np.asarray(probe)
    psi = np.asarray(psi)
    scan = np.asarray(scan)
    cfg = PtychoConfig(
        probe_shape=probe.shape[-1],
        detector_shape=detector_shape,
        nz=psi.shape[-2],
        n=psi.shape[-1],
        nslices=psi.shape[0],
        **{
            k: v
            for k, v in kwargs.items()
            if k
            in (
                "probe_wavelength",
                "probe_FOV_lengths",
                "multislice_propagation_distance",
            )
        },
    )
    intensity = None
    psi_d = jnp.asarray(psi, dtype=cfloating)
    scan_d = jnp.asarray(scan, dtype=floating)
    for m in range(probe.shape[-3]):
        mode_intensity = _simulate_mode_program(
            cfg,
            psi_d,
            scan_d,
            jnp.asarray(
                np.ascontiguousarray(probe[..., m : m + 1, :, :]),
                dtype=cfloating,
            ),
            None
            if eigen_probe is None
            else jnp.asarray(
                np.ascontiguousarray(eigen_probe[..., m : m + 1, :, :]),
                dtype=cfloating,
            ),
            None
            if eigen_weights is None
            else jnp.asarray(eigen_weights[..., m : m + 1], dtype=floating),
        )
        if to_host:
            mode_intensity = np.asarray(mode_intensity)
        intensity = (
            mode_intensity
            if intensity is None
            else intensity + mode_intensity
        )
    if fly > 1:
        intensity = intensity.reshape(
            scan.shape[-2] // fly, fly, detector_shape, detector_shape
        ).sum(axis=1)
    return intensity


def simulate(
    detector_shape: int,
    probe,
    scan,
    psi,
    fly: int = 1,
    eigen_probe=None,
    eigen_weights=None,
    **kwargs,
) -> np.ndarray:
    """Propagate the wavefront to the detector and return intensities.

    Equivalent of `ptycho/ptycho.py:128-179`: per probe mode, apply the
    varying probe and accumulate |farplane|^2, with fly-scan frame grouping.
    """
    return _simulate_impl(
        detector_shape, probe, scan, psi, fly, eigen_probe, eigen_weights,
        to_host=True, **kwargs,
    )


def simulate_device(
    detector_shape: int,
    probe,
    scan,
    psi,
    fly: int = 1,
    eigen_probe=None,
    eigen_weights=None,
    **kwargs,
) -> jax.Array:
    """:func:`simulate`, but the intensities STAY on device.

    Returns a (N, detector, detector) float jax.Array suitable for passing
    directly to :class:`Reconstruction` (device-resident data path), so
    simulate-then-reconstruct pipelines (benchmarks, synthetic studies)
    never move the dataset between host and device.
    """
    return _simulate_impl(
        detector_shape, probe, scan, psi, fly, eigen_probe, eigen_weights,
        to_host=False, **kwargs,
    )


@jax.jit(static_argnames=("cfg",))
def _simulate_mode_program(cfg, psi, scan, probe_m, eigen_m, weights_m):
    """Varying-probe blend + forward intensity for one mode, one program."""
    unique = probe_module.get_varying_probe(probe_m, eigen_m, weights_m)
    return simulate_intensity(cfg, psi, scan, unique[:, 0])


class Reconstruction:
    """Context manager for ptychography reconstruction.

    Same API as the reference (`ptycho/ptycho.py:265-610`): data structures
    stay device-resident while the context is open, so `iterate` can be
    called repeatedly and `get_result` mid-run.
    """

    def __init__(
        self,
        data: npt.NDArray,
        parameters: PtychoParameters,
        num_gpu: typing.Union[int, typing.Tuple[int, ...]] = 1,
        use_mpi: bool = False,
        mesh=None,
        store_data_on_device: typing.Optional[bool] = None,
        random_seed: typing.Optional[int] = None,
        object_sharding: str = "replicated",
        _force_stripes: typing.Optional[int] = None,
    ):
        if object_sharding not in ("replicated", "striped"):
            raise ValueError(
                "object_sharding must be 'replicated' or 'striped', "
                f"not {object_sharding!r}"
            )
        if object_sharding == "striped" and mesh is None:
            raise ValueError("object_sharding='striped' requires a mesh")
        self.object_sharding = object_sharding
        # A multi-host striped run may legitimately pass a zero-length
        # block: a process whose stripes contain no scan positions (the
        # striped_local_indices contract) still participates in the
        # collectives.
        min_patterns = (
            0
            if object_sharding == "striped" and jax.process_count() > 1
            else 1
        )
        if (
            data.ndim != 3
            or data.shape[0] < min_patterns
            or np.any(np.asarray(data.shape[-2:]) < 1)
            or data.shape[-2] != data.shape[-1]
        ):
            raise ValueError(
                f"data shape {data.shape} is incorrect. "
                "It should be (N, W, H), "
                "where N >= 1 is the number of square diffraction patterns."
            )
        self.mesh = mesh
        # Testing/advanced: emulate an N-process stripe layout on one
        # process (same global program as a real N-process run).
        self._force_stripes = _force_stripes
        if (
            data.shape[0] != parameters.scan.shape[0]
            and not self._is_multi_host()
            and not (
                object_sharding == "striped" and jax.process_count() > 1
            )
        ):
            # Only the multi-host layout may pass a per-process data stripe
            # (validated against the stripe length in _enter_multi_host);
            # every other path requires matching leading dimensions.
            raise ValueError(
                f"data shape {data.shape} and scan shape "
                f"{parameters.scan.shape} are incompatible. They should have "
                "the same leading dimension."
            )
        if np.any(
            np.asarray(parameters.probe.shape[-2:])
            > np.asarray(data.shape[-2:])
        ):
            raise ValueError(
                f"probe shape {parameters.probe.shape} "
                f"and data shape {data.shape} are incompatible. "
                "The probe width/height must be <= the data width/height."
            )
        logger.info(
            "{} on {:,d} - {:,d} by {:,d} frames for at most {:,d} "
            "epochs.".format(
                parameters.algorithm_options.name,
                *data.shape[-3:],
                parameters.algorithm_options.num_iter,
            )
        )
        # Device-resident data (a jax.Array, e.g. produced by on-device
        # ``simulate`` or an upstream jitted pipeline) is accepted for the
        # replicated layout: it skips the host->device upload entirely and
        # is re-indexed into batch-major order on device. Beyond the
        # reference, which requires host numpy (`ptycho.py:182-254`).
        self._device_data = isinstance(data, jax.Array) and not isinstance(
            data, np.ndarray
        )
        if self._device_data:
            if object_sharding == "striped" or self._is_multi_host():
                raise NotImplementedError(
                    "device-resident data requires the replicated "
                    "single-process layout; pass host numpy data for "
                    "striped/multi-host runs."
                )
            if store_data_on_device is False:
                raise ValueError(
                    "store_data_on_device=False (host streaming) requires "
                    "host numpy data, but data is already device-resident."
                )
            self.store_data_on_device = store_data_on_device = True
        self.data_host = data
        self.parameters_host = copy.deepcopy(parameters)
        # store_data_on_device=False composes with every layout, like the
        # reference (stream.py:285-404 pipelines run identically under
        # MPI): the replicated single-process path double-buffers
        # device_put uploads, the multi-host DP layout streams each batch
        # as a globally-sharded array (HostStreamedBatches), and the
        # striped epoch feeds batches from host RAM (>HBM data with a
        # >HBM object).
        if store_data_on_device is None:
            # Stream from host when the dataset is a large fraction of
            # device memory; 4 GB is a conservative cut.
            store_data_on_device = data.nbytes < 4 * 2**30
        self.store_data_on_device = store_data_on_device
        self.operator = PtychoConfig(
            probe_shape=parameters.probe.shape[-1],
            detector_shape=data.shape[-1],
            nz=parameters.psi.shape[-2],
            n=parameters.psi.shape[-1],
            nslices=parameters.psi.shape[0],
            probe_wavelength=(
                parameters.probe_options.probe_wavelength
                if parameters.probe_options is not None
                else 1e-9
            ),
            probe_FOV_lengths=(
                tuple(parameters.probe_options.probe_FOV_lengths)
                if parameters.probe_options is not None
                else (1e-6, 1e-6)
            ),
            multislice_propagation_distance=(
                parameters.object_options.multislice_propagation_distance
                if parameters.object_options is not None
                else 1e-9
            ),
        )
        self._seed = random_seed
        self._rng = np.random.default_rng(random_seed)

    def _is_multi_host(self) -> bool:
        """Whether this run uses the stripe-major multi-process layout."""
        return self.mesh is not None and (
            (
                jax.process_count() > 1
                and self.mesh.size == jax.device_count()
            )
            or self._force_stripes is not None
        )

    def _enter_multi_host(self):
        """Multi-process setup: per-process data, one global SPMD program.

        The reference's MPI axis (`mpi.py:61-92`, `comm.py:80-136`): every
        process holds the full (small) scan and only its stripe of the
        diffraction data; batch layouts are computed identically everywhere
        from the full scan, the data is assembled into one globally-sharded
        array without gathering, and the hierarchical ICI+DCN reductions are
        GSPMD-inserted psums in the unchanged solver programs.
        """
        from tike_tpu.parallel import batch_sharding, distributed as dist
        from tike_tpu.parallel import replicated_sharding

        data = self.data_host
        emulate = jax.process_count() == 1
        n_proc = (
            self._force_stripes if emulate else jax.process_count()
        )
        if n_proc < 1 or self.mesh.size % n_proc != 0:
            raise ValueError(
                f"the mesh size ({self.mesh.size}) must be a positive "
                f"multiple of the process count ({n_proc}) so every "
                "process contributes the same number of devices"
            )
        if self._seed is None:
            # All processes must draw identical batch layouts and orders.
            self._rng = np.random.default_rng(0)
            logger.info(
                "multi-host: no random_seed given; using 0 so all "
                "processes agree on batch layouts"
            )
        scan_full = np.asarray(self.parameters_host.scan)
        (
            global_order,
            batch_idx,
            batch_mask,
            stripe_slots,
            self.stripe_start,
        ) = dist.striped_batches(
            scan_full,
            n_proc,
            batch_method=self.parameters_host.algorithm_options.batch_method,
            num_batch=self.parameters_host.algorithm_options.num_batch,
            rng=self._rng,
            local_multiple=self.mesh.size // n_proc,
        )
        self.order = global_order
        self.batches = (batch_idx, batch_mask)

        seg_lengths = [len(s) for s in dist.stripe_indices(scan_full, n_proc)]
        seg_offsets = np.cumsum([0] + seg_lengths)

        def stripe_block(pid: int) -> np.ndarray:
            """(nb, Lp, DET, DET) data block for stripe ``pid``."""
            order_segment = global_order[
                seg_offsets[pid] : seg_offsets[pid + 1]
            ]
            if data.shape[0] == scan_full.shape[0]:
                # Convenience: full data given on every process.
                local_ordered = data[order_segment]
            elif data.shape[0] == seg_lengths[pid]:
                # Production: data rows follow dist.stripe_for_process(scan).
                local_idx = dist.stripe_for_process(
                    scan_full, num_processes=n_proc, process_id=pid
                )
                from tike_tpu.parallel.striped import local_row_lookup

                rows = local_row_lookup(scan_full.shape[0], local_idx)[
                    order_segment
                ]
                assert np.all(rows >= 0), (
                    "local data rows do not match stripe_for_process(scan)"
                )
                local_ordered = data[rows]
            else:
                raise ValueError(
                    f"data has {data.shape[0]} patterns but this process's "
                    f"stripe has {seg_lengths[pid]} (or pass the full "
                    f"{scan_full.shape[0]})."
                )
            idx_p, _ = stripe_slots[pid]
            return np.ascontiguousarray(local_ordered[idx_p].astype(floating))

        if emulate:
            # Single-process emulation: all stripes assembled locally,
            # sharded like the real multi-process layout.
            global_block = np.concatenate(
                [stripe_block(p) for p in range(n_proc)], axis=1
            )
            if self.store_data_on_device:
                self.data = jax.device_put(
                    jnp.asarray(global_block),
                    batch_sharding(self.mesh, axis=1),
                )
            else:
                self.data = dist.HostStreamedBatches(
                    self.mesh, global_block, 1
                )
        else:
            local_block = stripe_block(jax.process_index())
            if self.store_data_on_device:
                self.data = dist.make_global_batch_data(
                    self.mesh, local_block, n_proc
                )
            else:
                self.data = dist.HostStreamedBatches(
                    self.mesh, local_block, n_proc
                )

        parameters = PtychoParameters.split(
            self.order, x=self.parameters_host
        )
        self.parameters = parameters.copy_to_device(
            replicated_sharding(self.mesh)
        )
        if (
            self.parameters.probe_options is not None
            and self.parameters.probe_options.init_rescale_from_measurements
        ):
            self.parameters = _rescale_probe(
                self.operator, self.data, self.batches, self.parameters
            )
        return self

    def _enter_striped(self):
        """Row-striped object decomposition (`parallel/striped.py`).

        The reference's default multi-GPU behavior: each device owns a row
        stripe of psi plus its scan positions; probe is all-reduced and the
        halo rows cross-faded every epoch (`ptycho/ptycho.py:371-396,
        491-502` in the reference).
        """
        from tike_tpu.parallel import striped

        p = self.parameters_host
        algo = p.algorithm_options
        if algo.name == "lstsq_grad" and p.psi.shape[0] != 1:
            raise ValueError(
                "LSQML is single-slice (like the reference); use rpie "
                "for multislice objects"
            )
        margin = 8
        multi = jax.process_count() > 1
        if multi and self._seed is None:
            # All processes must draw identical per-stripe batch layouts.
            self._rng = np.random.default_rng(0)
            logger.info(
                "striped multi-host: no random_seed given; using 0 so all "
                "processes agree on batch layouts"
            )
        probe = np.asarray(p.probe)
        if (
            p.probe_options is not None
            and p.probe_options.init_rescale_from_measurements
        ):
            scan_full = np.asarray(p.scan)
            data_arr = np.asarray(self.data_host)
            if multi:
                # The branch below enters a collective, so the decision
                # must be agreed globally: a process whose stripes happen
                # to cover every position has a local block the size of
                # the full dataset, and deciding from the local shape
                # alone would deadlock the others in process_allgather.
                from jax.experimental import multihost_utils

                all_n = np.asarray(
                    multihost_utils.process_allgather(
                        np.int64(data_arr.shape[0])
                    )
                )
                all_full = bool(np.all(all_n == scan_full.shape[0]))
            else:
                all_full = True
            if multi and not all_full:
                # Per-process data blocks: partial measured-power sums are
                # combined across processes (identically-seeded rng keeps
                # the sample and hence the scale in agreement).
                local_idx = striped.striped_local_indices(
                    scan_full,
                    np.asarray(p.psi).shape[-2:],
                    probe.shape[-1],
                    self.mesh,
                    position_margin=margin,
                )
                scale = striped.estimate_probe_rescale_multihost(
                    data_arr,
                    local_idx,
                    np.asarray(p.psi),
                    probe,
                    scan_full,
                    rng=self._rng,
                )
            else:
                scale = striped.estimate_probe_rescale(
                    data_arr,
                    np.asarray(p.psi),
                    probe,
                    scan_full,
                    rng=self._rng,
                )
            logger.info("Probe rescaled by %f (striped mode)", scale)
            probe = probe * scale
            if np.isnan(p.probe_options.probe_photons):
                # Parity with _rescale_probe_helper: derive the photon
                # target from the freshly-rescaled probe.
                p.probe_options.probe_photons = float(
                    np.sum(np.square(np.abs(probe)))
                )
        if algo.rescale_method == "constant_probe_photons" and (
            p.probe_options is None
            or not np.isfinite(p.probe_options.probe_photons)
        ):
            raise ValueError(
                "rescale_method='constant_probe_photons' requires "
                "probe_options.probe_photons (set it explicitly, or enable "
                "init_rescale_from_measurements to derive it from the "
                "rescaled probe)"
            )
        ew = p.exitwave_options
        popt = p.position_options
        plan = self._make_plan(p, num_iter=1)
        self._striped = striped.setup_striped_full(
            np.asarray(self.data_host),
            np.asarray(p.psi),
            probe,
            np.asarray(p.scan),
            mesh=self.mesh,
            epoch_plan=plan,
            batch_method=algo.batch_method,
            num_batch=int(algo.num_batch),
            store_data_on_device=self.store_data_on_device,
            eigen_probe=(
                np.asarray(p.eigen_probe)
                if p.eigen_probe is not None
                else None
            ),
            eigen_weights=(
                np.asarray(p.eigen_weights)
                if p.eigen_weights is not None
                else None
            ),
            measured_pixels=(
                np.asarray(ew.measured_pixels) if ew is not None else None
            ),
            step_length_start=(
                float(ew.step_length_start) if ew is not None else 0.5
            ),
            step_length_weight=(
                float(ew.step_length_weight) if ew is not None else 0.5
            ),
            unmeasured_pixels_scaling=(
                float(ew.unmeasured_pixels_scaling)
                if ew is not None
                else 1.0
            ),
            position_margin=margin,
            pos_momentum=(
                np.asarray(popt._momentum)
                if popt is not None and popt._momentum is not None
                else None
            ),
            prev_costs=[float(c[0]) for c in algo.costs],
            rng=self._rng,
            epochs_done=len(algo.times),
        )
        self.parameters = copy.deepcopy(p)
        self.order = np.arange(p.scan.shape[0])
        self.stripe_start = None
        return self

    def __enter__(self):
        data = self.data_host
        if self._device_data:
            bad = float(
                jnp.sum(~jnp.isfinite(data)) + jnp.sum(data < 0)
            )
            data_ok = bad == 0
        else:
            data_ok = np.all(np.isfinite(data)) and not np.any(data < 0)
        if not data_ok:
            warnings.warn(
                "Diffraction patterns contain invalid data. "
                "All data should be non-negative and finite.",
                UserWarning,
            )
        if self.object_sharding == "striped":
            return self._enter_striped()
        if self._is_multi_host():
            return self._enter_multi_host()

        # Order the data by batches (contiguous in device memory like the
        # reference, `ptycho.py:371-396`) and build fixed-size batch indices.
        # num_stripes stays 1 here by design: the reference stripes the scan
        # so each GPU's shard is spatially contiguous, but with a replicated
        # object the batch-major layout + mesh sharding already gives every
        # device a contiguous slice of each batch. Spatial striping returns
        # in two places that need it: the multi-host layout
        # (`parallel/distributed.striped_batches`, one stripe per process)
        # and the striped object decomposition (`object_sharding="striped"`).
        (
            order,
            batches,
            self.stripe_start,
        ) = tike_tpu.cluster.by_scan_stripes_contiguous(
            scan=np.asarray(self.parameters_host.scan),
            num_stripes=1,
            batch_method=self.parameters_host.algorithm_options.batch_method,
            num_batch=self.parameters_host.algorithm_options.num_batch,
            rng=self._rng,
        )
        self.order = order[0]
        n_dev = 1 if self.mesh is None else self.mesh.size
        self.batches = tike_tpu.cluster.batches_padded(
            batches[0], multiple_of=n_dev
        )

        sharding = None
        if self.mesh is not None:
            from tike_tpu.parallel import batch_sharding, replicated_sharding

            sharding = replicated_sharding(self.mesh)
            data_sharding = batch_sharding(self.mesh, axis=1)
        parameters = PtychoParameters.split(
            self.order, x=self.parameters_host
        )
        self.parameters = parameters.copy_to_device(sharding)
        # Store data batch-major (num_batch, L, DET, DET) so per-batch slices
        # never cross device-shard boundaries (the L axis is sharded).
        batch_idx, _ = self.batches
        if self._device_data:
            # Re-index on device: one device gather instead of a host
            # round trip (the upload is the point being skipped).
            perm = jnp.asarray(self.order, dtype=jnp.int32)[
                jnp.asarray(batch_idx, dtype=jnp.int32).reshape(-1)
            ]
            dat = jnp.take(data.astype(floating), perm, axis=0).reshape(
                batch_idx.shape + data.shape[-2:]
            )
            if self.mesh is not None:
                dat = jax.device_put(dat, data_sharding)
            self.data = dat
            dat_np = None
        else:
            dat_np = np.ascontiguousarray(
                data[self.order][batch_idx].astype(floating)
            )
        if dat_np is not None and self.store_data_on_device:
            # Straight to the batch-sharded layout with a mesh: the data
            # never lands whole on one device.
            self.data = jax.device_put(
                dat_np, data_sharding if self.mesh is not None else None
            )
        elif dat_np is not None:
            # Host-resident streaming mode: solvers double-buffer the
            # per-batch uploads (the reference's pinned-memory role).
            self.data = dat_np

        if (
            self.parameters.probe_options is not None
            and self.parameters.probe_options.init_rescale_from_measurements
        ):
            self.parameters = _rescale_probe(
                self.operator, self.data, self.batches, self.parameters
            )
        return self

    def _fused_eligible(self) -> bool:
        """Whether iterate() can run as one fused multi-epoch program."""
        p = self.parameters
        # Position correction is fused for lstsq (the only solver that
        # updates positions, like the reference); the RANSAC affine fit is
        # host-side and runs once after the program (diagnostic-only when
        # use_position_regularization is off).
        positions_ok = p.position_options is None or (
            p.algorithm_options.name == "lstsq_grad"
            and not p.position_options.use_position_regularization
        )
        return (
            (
                p.algorithm_options.name == "rpie"
                or (
                    p.algorithm_options.name == "lstsq_grad"
                    and self.operator.nslices == 1
                )
            )
            and positions_ok
            # Host-resident streaming (np.ndarray or HostStreamedBatches)
            # takes the per-epoch path, which double-buffers uploads.
            and isinstance(self.data, jax.Array)
            and self.data.ndim == 4
            and (
                p.algorithm_options.rescale_method == "mean_of_abs_object"
                or (
                    p.algorithm_options.rescale_method
                    == "constant_probe_photons"
                    and p.probe_options is not None
                    and np.isfinite(p.probe_options.probe_photons)
                )
            )
            and p.algorithm_options.time_limit == np.inf
        )

    def _make_plan(self, p, num_iter: int):
        """Build the fused EpochPlan from the parameter objects.

        Shared by the replicated fused path and the striped
        (object-decomposed) path — the two run the same epoch math
        (`solvers.fused._epoch_math`).
        """
        from .solvers.fused import EpochPlan

        popts = p.probe_options
        oopts = p.object_options
        ew = p.exitwave_options
        algo = p.algorithm_options
        compact = algo.batch_method == "compact"
        return EpochPlan(
            cfg=self.operator,
            solver=(
                "lstsq"
                if p.algorithm_options.name == "lstsq_grad"
                else "rpie"
            ),
            n_epochs=num_iter,
            compact=compact,
            noise_model=ew.noise_model,
            steplength_usemodes=ew.step_length_usemodes,
            recover_psi=oopts is not None,
            recover_probe=popts is not None,
            has_eigen=p.eigen_weights is not None,
            update_start=popts.update_start if popts else 0,
            update_period=popts.update_period if popts else 1,
            probe_support=popts.probe_support if popts else 0.0,
            probe_support_radius=(
                popts.probe_support_radius if popts else 0.35
            ),
            probe_support_degree=(
                popts.probe_support_degree if popts else 2.5
            ),
            additional_probe_penalty=(
                popts.additional_probe_penalty if popts else 0.0
            ),
            median_filter=(
                popts.median_filter_abs_probe if popts else False
            ),
            median_filter_px=(
                tuple(popts.median_filter_abs_probe_px)
                if popts
                else (1.0, 1.0)
            ),
            force_center=(
                popts.force_centered_intensity if popts else False
            ),
            force_sparsity=popts.force_sparsity if popts else 0.0,
            force_orthogonality=(
                popts.force_orthogonality if popts else False
            ),
            positivity=float(oopts.positivity_constraint) if oopts else 0.0,
            smoothness=float(oopts.smoothness_constraint) if oopts else 0.0,
            clip_magnitude=bool(oopts.clip_magnitude) if oopts else False,
            rescale_mean_abs=(
                oopts is not None
                and algo.rescale_method == "mean_of_abs_object"
            ),
            rescale_photons=(
                float(popts.probe_photons)
                if popts is not None
                and algo.rescale_method == "constant_probe_photons"
                else 0.0
            ),
            rescale_period=algo.rescale_period,
            alpha=float(getattr(algo, "alpha", 0.05)),
            fft_precond=(
                solvers._preconditioner.USE_FFT_PRECOND
                and solvers._preconditioner.fft_precond_profitable(
                    n_positions=p.scan.shape[0],
                    probe_shape=self.operator.probe_shape,
                    nz=self.operator.nz,
                    n=self.operator.n,
                )
            ),
            recover_positions=p.position_options is not None,
            pos_update_start=(
                p.position_options.update_start
                if p.position_options is not None
                else 0
            ),
            pos_use_adaptive_moment=(
                p.position_options.use_adaptive_moment
                if p.position_options is not None
                else False
            ),
            pos_vdecay=(
                p.position_options.vdecay
                if p.position_options is not None
                else 0.999
            ),
            pos_mdecay=(
                p.position_options.mdecay
                if p.position_options is not None
                else 0.9
            ),
            pos_update_magnitude_limit=(
                p.position_options.update_magnitude_limit
                if p.position_options is not None
                else 0.0
            ),
            # Adaptive moments, matching the per-epoch paths: rPIE uses
            # per-batch adam (non-compact) or epoch-end momentum_checked
            # (compact); LSQML uses per-batch classical momentum
            # (non-compact) or momentum_checked (compact) for the object
            # and epoch-end momentum_checked for the probe.
            obj_moment=(
                (
                    "checked"
                    if compact
                    else (
                        "adam"
                        if p.algorithm_options.name == "rpie"
                        else "momentum"
                    )
                )
                if oopts is not None and oopts.use_adaptive_moment
                else "none"
            ),
            probe_moment=(
                (
                    ("checked" if compact else "adam")
                    if p.algorithm_options.name == "rpie"
                    else "checked"
                )
                if popts is not None and popts.use_adaptive_moment
                else "none"
            ),
            obj_vdecay=(oopts.vdecay if oopts is not None else 0.999),
            obj_mdecay=(oopts.mdecay if oopts is not None else 0.9),
            probe_vdecay=(popts.vdecay if popts is not None else 0.999),
            probe_mdecay=(popts.mdecay if popts is not None else 0.9),
        )

    def _iterate_fused(self, num_iter: int) -> None:
        """Run num_iter epochs as a single XLA program (see solvers.fused)."""
        from .solvers.fused import iterate_program

        p = self.parameters
        popts = p.probe_options
        oopts = p.object_options
        ew = p.exitwave_options
        algo = p.algorithm_options
        total_epochs0 = len(algo.times)
        compact = algo.batch_method == "compact"
        batch_idx, batch_mask = self.batches
        nb = batch_idx.shape[0]
        plan = self._make_plan(p, num_iter)
        if compact:
            orders = np.tile(np.arange(nb, dtype=np.int32), (num_iter, 1))
        else:
            orders = np.stack(
                [
                    self._rng.permutation(nb).astype(np.int32)
                    for _ in range(num_iter)
                ]
            )
        pos_v = pos_m = None
        popt = p.position_options
        if popt is not None and popt.use_adaptive_moment:
            if popt._momentum is not None:
                mom = np.asarray(popt._momentum)
                pos_v = jnp.asarray(mom[..., 0:2])
                pos_m = jnp.asarray(mom[..., 2:4])
        # Object/probe adaptive-moment states: continue from the options'
        # stored states (the per-epoch path persists them there too), or
        # initialize fresh per the moment kind.
        obj_v = obj_m = probe_v = probe_m = err_hist = None
        if plan.obj_moment != "none":
            psi_shape = tuple(p.psi.shape)
            obj_m = (
                oopts.m
                if oopts.m is not None
                else jnp.zeros(psi_shape, jnp.complex64)
            )
            if plan.obj_moment == "adam":
                obj_v = (
                    oopts.v
                    if oopts.v is not None
                    else jnp.zeros(psi_shape, jnp.float32)
                )
            elif plan.obj_moment == "checked":
                obj_v = (
                    oopts.v
                    if oopts.v is not None
                    else jnp.zeros((3, *psi_shape), jnp.complex64)
                )
            else:  # classical momentum keeps no second state
                obj_v = jnp.zeros((), jnp.float32)
        if plan.probe_moment != "none":
            pw = p.probe.shape[-1]
            gshape = (
                (pw, pw) if plan.solver == "rpie" else (1, 1, pw, pw)
            )
            probe_m = (
                popts.m
                if popts.m is not None
                else jnp.zeros(gshape, jnp.complex64)
            )
            if plan.probe_moment == "adam":
                probe_v = (
                    popts.v
                    if popts.v is not None
                    else jnp.zeros(gshape, jnp.float32)
                )
            else:
                probe_v = (
                    popts.v
                    if popts.v is not None
                    else jnp.zeros((3, *gshape), jnp.complex64)
                )
        if "checked" in (plan.obj_moment, plan.probe_moment):
            from .solvers.fused import seed_err_hist

            err_hist = jnp.asarray(
                seed_err_hist([float(c[0]) for c in algo.costs])
            )
        start = time.perf_counter()
        (
            psi,
            probe,
            eigen_probe,
            eigen_weights,
            scan,
            pos_v,
            pos_m,
            obj_v,
            obj_m,
            probe_v,
            probe_m,
            costs,
            powers,
        ) = iterate_program(
            plan,
            jnp.asarray(total_epochs0, jnp.int32),
            self.data,
            p.scan,
            jnp.asarray(batch_idx),
            jnp.asarray(batch_mask),
            jnp.asarray(orders),
            p.psi,
            p.probe,
            p.eigen_probe,
            p.eigen_weights,
            ew.measured_pixels,
            ew.step_length_start,
            ew.step_length_weight,
            ew.unmeasured_pixels_scaling,
            pos_v,
            pos_m,
            obj_v,
            obj_m,
            probe_v,
            probe_m,
            err_hist,
        )
        if plan.obj_moment != "none":
            oopts.m = obj_m
            if plan.obj_moment != "momentum":
                oopts.v = obj_v
        if plan.probe_moment != "none":
            popts.v = probe_v
            popts.m = probe_m
        jax.block_until_ready(psi)
        elapsed = time.perf_counter() - start
        p.psi = psi
        p.probe = probe
        if p.eigen_probe is not None:
            p.eigen_probe = eigen_probe
        if p.eigen_weights is not None:
            p.eigen_weights = eigen_weights
        if popt is not None:
            p.scan = scan
            if popt.use_adaptive_moment:
                momentum = np.zeros((*scan.shape[:-1], 4), np.float32)
                momentum[..., 0:2] = np.asarray(pos_v)
                momentum[..., 2:4] = np.asarray(pos_m)
                popt._momentum = momentum
            # One host-side affine fit for the diagnostic transform (the
            # per-epoch path refits every epoch; the final fit is the same).
            self.parameters = _apply_position_constraints(self.parameters)
        costs_host = np.asarray(costs)
        powers_host = np.asarray(powers)
        for e in range(num_iter):
            algo.costs.append([float(np.mean(costs_host[e]))])
            algo.times.append(elapsed / num_iter)
            if popts is not None:
                popts.power.append(powers_host[e])
        logger.info(
            "%10s cost is %+1.3e (fused %d epochs)",
            ew.noise_model,
            float(np.mean(costs_host[-1])),
            num_iter,
        )

    def iterate(self, num_iter: int) -> None:
        """Advance the reconstruction by num_iter epochs.

        When ``algorithm_options.convergence_window >= 2`` the epoch loop
        stops early once the cost slope over the window is non-negative
        (`opt.py:21-43` wired into the driver).
        """
        from tike_tpu.opt import is_converged

        algo = self.parameters.algorithm_options
        if self.object_sharding == "striped":
            from tike_tpu.parallel import striped

            # Multi-epoch fused chunks (like the replicated fused path);
            # convergence_window / time_limit are tested between chunks.
            # The host-side RANSAC affine position regularization runs
            # per epoch in the reference (`ptycho/ptycho.py:856-868`), so
            # it forces 1-epoch chunks with the fit applied between them.
            popt = self.parameters.position_options
            regularize = (
                popt is not None and popt.use_position_regularization
            )
            window = algo.convergence_window
            chunk = num_iter if window < 2 else max(1, window // 2)
            if regularize:
                chunk = 1
            done = 0
            while done < num_iter:
                if np.sum(algo.times) > algo.time_limit:
                    logger.info("Maximum reconstruction time exceeded.")
                    break
                step = min(chunk, num_iter - done)
                start = time.perf_counter()
                costs = striped.striped_iterate(self._striped, step)
                if regularize:
                    # Deterministic rng keyed on the epoch counter so all
                    # processes of a multi-host run fit the SAME transform.
                    scan_g, popt = affine_position_regularization(
                        striped.striped_scan_global(self._striped),
                        popt,
                        rng=np.random.default_rng(
                            1000 + self._striped.epochs_done
                        ),
                    )
                    self.parameters.position_options = popt
                    striped.striped_set_scan(self._striped, scan_g)
                elapsed = time.perf_counter() - start
                popts = self.parameters.probe_options
                for e, cost in enumerate(costs):
                    algo.costs.append([cost])
                    algo.times.append(elapsed / step)
                    if popts is not None:
                        popts.power.append(
                            self._striped.last_powers[e]
                        )
                logger.info("striped cost is %+1.3e", costs[-1])
                done += step
                if is_converged(algo):
                    break
            if popt is not None and not regularize:
                # One diagnostic transform fit, matching the fused
                # replicated path's end-of-iterate behavior.
                _, popt = affine_position_regularization(
                    striped.striped_scan_global(self._striped),
                    popt,
                    rng=np.random.default_rng(
                        1000 + self._striped.epochs_done
                    ),
                )
                self.parameters.position_options = popt
            return
        if num_iter > 0 and self._fused_eligible():
            window = algo.convergence_window
            if window < 2:
                return self._iterate_fused(num_iter)
            # Early stopping needs the cost history on the host, so run the
            # fused program in window//2-epoch chunks and test between
            # chunks (at most two distinct chunk lengths get compiled).
            chunk = max(1, window // 2)
            done = 0
            while done < num_iter:
                step = min(chunk, num_iter - done)
                self._iterate_fused(step)
                done += step
                if is_converged(algo):
                    return
            return
        start = time.perf_counter()
        for _ in range(num_iter):
            if (
                np.sum(self.parameters.algorithm_options.times)
                > self.parameters.algorithm_options.time_limit
            ):
                logger.info("Maximum reconstruction time exceeded.")
                break
            total_epochs = len(self.parameters.algorithm_options.times)
            logger.info(
                f"{self.parameters.algorithm_options.name} epoch "
                f"{total_epochs:,d}"
            )

            self.parameters = _apply_probe_constraints(
                self.parameters, epoch=total_epochs
            )
            self.parameters = update_preconditioners(
                self.operator, self.parameters, self.batches
            )
            solver = getattr(solvers, self.parameters.algorithm_options.name)
            self.parameters = solver(
                self.parameters,
                self.data,
                self.batches,
                op=self.operator,
                epoch=total_epochs,
                rng=self._rng,
            )
            self.parameters = _apply_object_constraints(self.parameters)
            self.parameters = _apply_position_constraints(self.parameters)

            self.parameters.algorithm_options.times.append(
                time.perf_counter() - start
            )
            start = time.perf_counter()
            logger.info(
                "%10s cost is %+1.3e",
                self.parameters.exitwave_options.noise_model,
                np.mean(self.parameters.algorithm_options.costs[-1]),
            )
            if is_converged(self.parameters.algorithm_options):
                break

    def get_scan(self) -> np.ndarray:
        reorder = np.argsort(self.order)
        return np.asarray(self.parameters.scan)[reorder]

    def get_result(self) -> PtychoParameters:
        """Return the current parameter estimates (host copies)."""
        if self.object_sharding == "striped":
            from tike_tpu.parallel import striped

            res = striped.striped_full_result(self._striped)
            result = self.parameters
            result.psi = res["psi"]
            result.probe = res["probe"]
            result.scan = res["scan"]
            if result.eigen_probe is not None:
                result.eigen_probe = res["eigen_probe"]
            if result.eigen_weights is not None:
                result.eigen_weights = res["eigen_weights"]
            popt = result.position_options
            if popt is not None and "position_momentum" in res:
                popt._momentum = res["position_momentum"]
            return result
        reorder = np.argsort(self.order)
        return PtychoParameters.join(
            [self.parameters.copy_to_host()],
            reorder,
            stripe_start=self.stripe_start,
        )

    def get_convergence(self):
        """Return the (costs, times) series."""
        return (
            self.parameters.algorithm_options.costs,
            self.parameters.algorithm_options.times,
        )

    def get_psi(self) -> np.ndarray:
        if self.object_sharding == "striped":
            from tike_tpu.parallel import striped

            return striped.striped_result(self._striped)[0]
        return np.asarray(self.parameters.psi)

    def get_probe(self):
        """Return (probe, eigen_probe, eigen_weights) as numpy arrays."""
        p = self.parameters
        reorder = np.argsort(self.order)
        return (
            np.asarray(p.probe),
            None if p.eigen_probe is None else np.asarray(p.eigen_probe),
            None
            if p.eigen_weights is None
            else np.asarray(p.eigen_weights)[reorder],
        )

    def __exit__(self, type, value, traceback):
        self.parameters = self.parameters.copy_to_host()
        self.data = None

    def append_new_data(self, new_data, new_scan):
        """Append new diffraction patterns and positions mid-reconstruction.

        Online (streaming-acquisition) reconstruction. The reference defines
        this API but ships it disabled
        (`upstream/src/tike/ptycho/ptycho.py:646-721`); this
        implementation follows that method's documented semantics: validate
        the new patterns, append data and positions, re-cluster the
        mini-batches, pad eigen weights with their column means, and extend
        the position-correction state (initial positions, confidence,
        moments). All solver state — object, probe, eigen probes, adaptive
        moments, cost/time histories — carries over, so ``iterate`` resumes
        where it left off with the enlarged dataset. Because array shapes
        grow, the epoch programs recompile on the next ``iterate`` call
        (XLA static shapes).
        """
        if self.object_sharding == "striped" or self._is_multi_host():
            raise NotImplementedError(
                "append_new_data supports the single-process replicated "
                "layout; striped/multi-host runs must restart with the "
                "combined dataset"
            )
        if self._device_data:
            raise NotImplementedError(
                "append_new_data requires host numpy data; restart with the "
                "combined dataset instead."
            )
        new_data = np.asarray(new_data)
        new_scan = np.asarray(new_scan, dtype=floating)
        if (
            new_data.ndim != 3
            or new_scan.ndim != 2
            or new_scan.shape[-1] != 2
            or new_data.shape[0] != new_scan.shape[0]
        ):
            raise ValueError(
                f"new data shape {new_data.shape} and new scan shape "
                f"{new_scan.shape} are incompatible. They should be "
                "(K, W, H) and (K, 2) with the same leading dimension."
            )
        if new_data.shape[-2:] != tuple(self.data_host.shape[-2:]):
            raise ValueError(
                f"new data frames {new_data.shape[-2:]} do not match the "
                f"existing detector shape {tuple(self.data_host.shape[-2:])}."
            )
        if not np.all(np.isfinite(new_data)) or np.any(new_data < 0):
            warnings.warn(
                "New diffraction patterns contain invalid data. "
                "All data should be non-negative and finite.",
                UserWarning,
            )

        # Harvest the current state in original position order, then extend.
        params = self.get_result()
        check_allowed_positions(
            new_scan, np.asarray(params.psi), params.probe.shape
        )
        n_new = new_scan.shape[0]
        params.scan = np.concatenate(
            [np.asarray(params.scan), new_scan], axis=0
        )
        if params.eigen_weights is not None:
            # New positions start from the mean weights of the existing
            # ones (the reference pads with ``mode='mean'``).
            params.eigen_weights = np.pad(
                np.asarray(params.eigen_weights),
                ((0, n_new), (0, 0), (0, 0)),
                mode="mean",
            )
        popt = params.position_options
        if popt is not None:
            popt.initial_scan = np.concatenate(
                [np.asarray(popt.initial_scan), new_scan], axis=0
            )
            if popt.confidence is not None:
                popt.confidence = np.concatenate(
                    [
                        np.asarray(popt.confidence),
                        np.ones((n_new, 2), dtype=floating),
                    ],
                    axis=0,
                )
            if popt._momentum is not None:
                popt._momentum = np.pad(
                    np.asarray(popt._momentum), ((0, n_new), (0, 0))
                )
        if params.probe_options is not None:
            # The probe is no longer "initial"; re-entering must not
            # re-apply the measurement-power rescale to the refined probe.
            params.probe_options.init_rescale_from_measurements = False

        self.data_host = np.concatenate(
            [np.asarray(self.data_host), new_data], axis=0
        )
        self.parameters_host = params
        return self.__enter__()


def reconstruct(
    data: npt.NDArray,
    parameters: PtychoParameters,
    num_gpu: typing.Union[int, typing.Tuple[int, ...]] = 1,
    use_mpi: bool = False,
    mesh=None,
    object_sharding: str = "replicated",
) -> PtychoParameters:
    """Solve the ptychography problem (functional API).

    Same signature semantics as the reference (`ptycho/ptycho.py:182-254`);
    `num_gpu`/`use_mpi` are accepted for compatibility and superseded by
    `mesh`, a jax.sharding.Mesh for multi-chip runs. Pass
    ``object_sharding="striped"`` with a mesh to decompose the object into
    per-device row stripes (the reference's multi-GPU psi decomposition).
    """
    with Reconstruction(
        data,
        parameters,
        num_gpu,
        use_mpi,
        mesh,
        object_sharding=object_sharding,
    ) as context:
        context.iterate(parameters.algorithm_options.num_iter)
        result = context.get_result()

    if (
        logger.getEffectiveLevel() <= logging.INFO
    ) and result.position_options:
        t = result.position_options.transform.asarray()
        logger.info(
            "Affine transform parameters:\n"
            f"{t[0, 0]: .3e}, {t[0, 1]: .3e}\n"
            f"{t[1, 0]: .3e}, {t[1, 1]: .3e}"
        )
    return result


@jax.jit(
    static_argnames=(
        "support",
        "support_radius",
        "support_degree",
        "penalty",
        "median",
        "median_px",
        "center",
        "sparsity",
        "orthogonality",
    ),
)
def _probe_constraints_program(
    probe,
    *,
    support: float,
    support_radius: float,
    support_degree: float,
    penalty: float,
    median: bool,
    median_px: tuple,
    center: bool,
    sparsity: float,
    orthogonality: bool,
):
    """All per-epoch probe constraints fused into one XLA program.

    The reference applies these as separate CuPy calls
    (`ptycho/ptycho.py:723-810`); fusing them avoids one dispatch per
    constraint and keeps every intermediate on-device.
    """
    if support > 0:
        b0 = probe_module.finite_probe_support(
            probe, p=support, radius=support_radius, degree=support_degree
        )
        probe = probe - b0 * jnp.conj(b0 * probe)
    if penalty > 0:
        b1 = (
            penalty
            * jnp.linspace(0, 1, probe.shape[-3], dtype=floating)[
                ..., None, None
            ]
        )
        probe = probe - b1 * jnp.conj(b1 * probe)
    if median:
        probe = probe_module.apply_median_filter_abs_probe(
            probe, med_filt_px=median_px
        )
    if center:
        probe = probe_module.constrain_center_peak(probe)
    if sparsity < 1:
        probe = probe_module.constrain_probe_sparsity(probe, f=sparsity)
    if orthogonality:
        probe, pwr = probe_module._orthogonalize_eig_program(probe)
    else:
        pwr = probe_module._power_program(probe)
    return probe, pwr


def _apply_probe_constraints(
    parameters: PtychoParameters, *, epoch: int
) -> PtychoParameters:
    """Per-epoch probe constraints (`ptycho/ptycho.py:723-810`)."""
    if parameters.probe_options is not None:
        popts = parameters.probe_options
        if popts.recover_probe(epoch):
            probe, pwr = _probe_constraints_program(
                parameters.probe,
                support=popts.probe_support,
                support_radius=popts.probe_support_radius,
                support_degree=popts.probe_support_degree,
                penalty=popts.additional_probe_penalty,
                median=popts.median_filter_abs_probe,
                median_px=tuple(popts.median_filter_abs_probe_px),
                center=popts.force_centered_intensity,
                sparsity=popts.force_sparsity,
                orthogonality=popts.force_orthogonality,
            )
            popts.power.append(np.asarray(pwr))
            parameters.probe = probe

        if (
            parameters.algorithm_options.rescale_method
            == "constant_probe_photons"
            and len(parameters.algorithm_options.costs)
            % parameters.algorithm_options.rescale_period
            == 0
        ):
            parameters.probe = (
                probe_module.rescale_probe_using_fixed_intensity_photons(
                    parameters.probe,
                    Nphotons=popts.probe_photons,
                    probe_power_fraction=None,
                )
            )

        if parameters.eigen_probe is not None and popts.recover_probe(epoch):
            (
                parameters.eigen_probe,
                parameters.eigen_weights,
            ) = probe_module.constrain_variable_probe(
                parameters.eigen_probe, parameters.eigen_weights
            )
    return parameters


@jax.jit(
    static_argnames=("positivity", "smoothness", "clip", "rescale"),
)
def _object_constraints_program(
    psi,
    probe,
    preconditioner,
    *,
    positivity: float,
    smoothness: float,
    clip: bool,
    rescale: bool,
):
    """All per-epoch object constraints fused into one XLA program."""
    if positivity:
        psi = object_module.positivity_constraint(psi, r=positivity)
    if smoothness:
        psi = object_module.smoothness_constraint(psi, a=smoothness)
    if clip:
        psi = object_module.clip_magnitude(psi, a_max=1.0)
    if rescale:
        psi, probe = object_module.remove_object_ambiguity(
            psi, probe, preconditioner
        )
    return psi, probe


def _apply_object_constraints(
    parameters: PtychoParameters,
) -> PtychoParameters:
    """Per-epoch object constraints (`ptycho/ptycho.py:812-853`)."""
    oopts = parameters.object_options
    if oopts is None:
        return parameters
    rescale = (
        parameters.algorithm_options.name != "dm"
        and parameters.algorithm_options.rescale_method == "mean_of_abs_object"
        and oopts.preconditioner is not None
        and len(parameters.algorithm_options.costs)
        % parameters.algorithm_options.rescale_period
        == 0
    )
    parameters.psi, parameters.probe = _object_constraints_program(
        parameters.psi,
        parameters.probe,
        oopts.preconditioner
        if oopts.preconditioner is not None
        else jnp.ones_like(parameters.psi),
        positivity=float(oopts.positivity_constraint),
        smoothness=float(oopts.smoothness_constraint),
        clip=bool(oopts.clip_magnitude),
        rescale=bool(rescale),
    )
    return parameters


def _apply_position_constraints(
    parameters: PtychoParameters,
) -> PtychoParameters:
    """Per-epoch position regularization (`ptycho/ptycho.py:856-868`)."""
    if parameters.position_options:
        (
            parameters.scan,
            parameters.position_options,
        ) = affine_position_regularization(
            updated=parameters.scan,
            position_options=parameters.position_options,
        )
    return parameters


def _rescale_probe(
    cfg: PtychoConfig, data, batches, parameters: PtychoParameters
) -> PtychoParameters:
    """Rescale probe so modeled and measured intensity match in total energy.

    Equivalent of `_rescale_probe` (`ptycho/ptycho.py:873-972`). `data` is
    batch-major (num_batch, L, DET, DET); processing is per batch slice so
    one fixed-shape program is compiled and padded slots (mask 0) are not
    double-counted.
    """

    @jax.jit(static_argnames=("cfg",))
    def sums(cfg, data_b, bmask, psi, scan_b, probe, measured_pixels):
        intensity = intensity_from_farplane(
            ptycho_fwd(cfg, psi, scan_b, probe[:, 0])
        )
        w = measured_pixels.astype(intensity.dtype)
        s_data = jnp.sum(jnp.sum(data_b * w, axis=(-2, -1)) * bmask)
        s_model = jnp.sum(jnp.sum(intensity * w, axis=(-2, -1)) * bmask)
        return s_data, s_model

    batch_idx, batch_mask = batches
    s_data = 0.0
    s_model = 0.0
    try:
        for n in range(batch_idx.shape[0]):
            idx = jnp.asarray(batch_idx[n])
            scan_b = jnp.take(parameters.scan, idx, axis=0)
            sd, sm = sums(
                cfg,
                data[n],
                jnp.asarray(batch_mask[n]),
                parameters.psi,
                scan_b,
                parameters.probe,
                parameters.exitwave_options.measured_pixels,
            )
            s_data += sd
            s_model += sm
    except Exception as error:
        msg = str(error)
        if "RESOURCE_EXHAUSTED" in msg or "out of memory" in msg.lower():
            # Same guidance as the reference on GPU OOM
            # (`ptycho/ptycho.py:940-944`).
            raise MemoryError(
                "The device ran out of memory while scaling the probe. "
                "Increase algorithm_options.num_batch so each mini-batch "
                "fits in HBM, or pass store_data_on_device=False to stream "
                "diffraction data from the host."
            ) from error
        raise
    rescale = jnp.sqrt(s_data / (s_model + 1e-32)).astype(floating)
    if logger.isEnabledFor(logging.INFO):
        logger.info(
            "Probe rescaled by %f", float(rescale)
        )
    parameters.probe = parameters.probe * rescale
    if np.isnan(parameters.probe_options.probe_photons):
        parameters.probe_options.probe_photons = float(
            jax.jit(lambda p: jnp.sum(jnp.square(jnp.abs(p))))(
                parameters.probe
            )
        )
    return parameters


def reconstruct_multigrid(
    data: npt.NDArray,
    parameters: PtychoParameters,
    num_gpu: typing.Union[int, typing.Tuple[int, ...]] = 1,
    use_mpi: bool = False,
    num_levels: int = 3,
    interp: typing.Callable = None,
    mesh=None,
    object_sharding: str = "replicated",
    store_data_on_device: typing.Optional[bool] = None,
) -> PtychoParameters:
    """Coarse-to-fine reconstruction (`ptycho/ptycho.py:975-1047`).

    ``object_sharding="striped"`` decomposes the object at every level
    (the reference's multigrid inherits its implicit multi-GPU psi
    striping); ``store_data_on_device=False`` streams batches from host
    RAM at every level."""
    from .solvers.options import _resize_fft, crop_fourier_space

    interp = _resize_fft if interp is None else interp
    if (data.shape[-1] * 0.5 ** (num_levels - 1)) < 64:
        warnings.warn(
            "Cropping diffraction patterns to less than 64 pixels wide is "
            "not recommended because the full doughnut may be visible."
        )
    resampled_parameters = parameters.resample(
        0.5 ** (num_levels - 1), interp
    )
    for level in range(num_levels - 1, -1, -1):
        with Reconstruction(
            data=data
            if level == 0
            else crop_fourier_space(data, data.shape[-1] // (2**level)),
            parameters=resampled_parameters,
            num_gpu=num_gpu,
            use_mpi=use_mpi,
            mesh=mesh,
            object_sharding=object_sharding,
            store_data_on_device=store_data_on_device,
        ) as context:
            context.iterate(resampled_parameters.algorithm_options.num_iter)
            result = context.get_result()
        if level == 0:
            return result
        resampled_parameters = result.resample(2.0, interp)
    raise RuntimeError("This should not happen.")

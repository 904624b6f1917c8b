"""Regularized ptychographic iterative engine (rPIE).

JAX equivalent of `upstream/src/tike/ptycho/solvers/rpie.py`.

Design: the reference streams 64-pattern chunks through CUDA streams
(`stream.py:285-404`) because data lives in pinned host memory; here the
diffraction data is device-resident (HBM) and each mini-batch is one jitted
XLA program with static shapes. Batches are padded to a common length with a
validity mask (see cluster.batches_padded) so the whole epoch reuses a single
compiled executable.

References
----------
Maiden & Rodenburg 2009 (Ultramicroscopy 109); Maiden, Johnson, Li 2017
(Optica 4) — same as the reference solver.
"""

from __future__ import annotations

import logging
import typing

import jax
import jax.numpy as jnp
import numpy as np

import tike_tpu.opt
from tike_tpu.ops.objective import ELEMENTWISE, GRAD
from tike_tpu.ops.patch import patch_adj, patch_fwd
from tike_tpu.ops.propagation import fresnel_adj, propagation_adj
from tike_tpu import precision
from tike_tpu.ops.ptycho import (
    PtychoConfig,
    _crop_from_detector,
    intensity_from_farplane,
    ptycho_fwd_with_probes,
)
from ..exitwave import (
    poisson_steplength_all_modes,
    poisson_steplength_dominant_mode,
)
from ..probe import get_varying_probe
from .options import PtychoParameters, RpieOptions

logger = logging.getLogger(__name__)

# Reusing the forward pass's object windows in the backward pass saves a
# patch gather but keeps (B, P, P) windows live across the farplane/exitwave
# chain. Off by default; TIKE_REUSE_WINDOWS=1 turns it on.
import os as _os

_REUSE_WINDOWS = _os.environ.get("TIKE_REUSE_WINDOWS", "0") == "1"



def _masked_mean_each_pattern(elem, pixel_mask):
    """Per-pattern mean over measured pixels only (static-shape version of
    the reference's boolean indexing `data[:, measured_pixels]`)."""
    w = pixel_mask.astype(elem.dtype)
    return jnp.sum(elem * w, axis=(-2, -1)) / jnp.sum(w)


def _batch_gradients_math(
    cfg: PtychoConfig,
    data_b,
    scan,
    idx,
    bmask,
    psi,
    probe,
    eigen_probe,
    eigen_weights,
    measured_pixels,
    step_length_start,
    step_length_weight,
    unmeasured_pixels_scaling,
    *,
    noise_model: str,
    steplength_usemodes: str,
    recover_probe: bool,
):
    """Forward + exitwave step + backpropagated numerators for one batch.

    Equivalent of `_get_nearplane_gradients` (`rpie.py:315-567`) minus the
    stream pipeline. data_b (B, DET, DET) is this batch's (batch-major,
    possibly device-sharded) slice of the data; idx (B,) indexes into the
    full scan / eigen weights; bmask (B,) zeroes padded batch slots.

    Returns (costs (B,), psi_num (D,H,W), probe_num (D,1,1,M,P,P),
    eigen_weight_delta (B,) or None).
    """
    nmodes = probe.shape[-3]
    scan_b = jnp.take(scan, idx, axis=0)

    if eigen_weights is not None:
        w_b = jnp.take(eigen_weights, idx, axis=0)
        unique_probe = get_varying_probe(probe, eigen_probe, w_b)[:, 0]
    else:
        unique_probe = probe[:, 0]  # (1, M, P, P)

    if _REUSE_WINDOWS:
        farplane, slice_probes, slice_patches = ptycho_fwd_with_probes(
            cfg, psi, scan_b, unique_probe, return_patches=True
        )  # (B, M, DET, DET), (D, B, M, P, P), (D, B, P, P)
    else:
        farplane, slice_probes = ptycho_fwd_with_probes(
            cfg, psi, scan_b, unique_probe
        )
        slice_patches = None
    intensity = intensity_from_farplane(farplane)  # (B, DET, DET)

    costs = _masked_mean_each_pattern(
        ELEMENTWISE[noise_model](data_b, intensity), measured_pixels
    )

    # --- Exitwave update step (`rpie.py:388-446`) ---
    if noise_model == "poisson":
        xi = (1 - data_b / (intensity + 1e-9))[:, None, :, :]
        grad_cost = farplane * xi
        step_length = jnp.full(
            (farplane.shape[0], 1, nmodes, 1, 1),
            step_length_start,
            dtype=intensity.dtype,
        )
        if steplength_usemodes == "dominant_mode":
            step_length = poisson_steplength_dominant_mode(
                xi[:, :, None],
                intensity,
                data_b,
                measured_pixels,
                step_length,
                step_length_weight,
            )
        else:
            step_length = poisson_steplength_all_modes(
                xi[:, :, None],
                jnp.square(jnp.abs(farplane))[:, None],
                intensity,
                data_b,
                measured_pixels,
                step_length,
                step_length_weight,
            )
        update = -step_length[:, 0] * grad_cost
    else:
        update = -GRAD[noise_model](data_b, farplane, intensity)

    chi = jnp.where(
        measured_pixels,
        update,
        farplane * (unmeasured_pixels_scaling - 1.0),
    )

    diff = _crop_from_detector(propagation_adj(chi), cfg)  # (B, M, P, P)
    diff = diff * bmask[:, None, None, None]

    # --- Backward slice loop (`rpie.py:448-474`) ---
    psi_num_slices = []
    probe_num_slices = []
    prop = cfg.propagator()
    for tt in range(cfg.nslices - 1, -1, -1):
        grad_psi = (
            jnp.sum(jnp.conj(slice_probes[tt]) * diff, axis=1) / nmodes
        )
        psi_num_slices.append(
            patch_adj(
                grad_psi, scan_b, (cfg.nz, cfg.n),
                precision=precision.SOLVER_MATMUL,
            )
        )
        # Reuse the forward pass's object windows instead of re-running
        # the patch gather (identical inputs -> identical values) when
        # TIKE_REUSE_WINDOWS is on.
        patches_tt = (
            slice_patches[tt]
            if slice_patches is not None
            else patch_fwd(
                psi[tt], scan_b, cfg.probe_shape,
                precision=precision.SOLVER_MATMUL,
            )
        )
        probe_num_slices.append(
            jnp.sum(jnp.conj(patches_tt)[:, None] * diff, axis=0)
        )
        if tt > 0:
            diff = fresnel_adj(diff, prop)

    psi_num = jnp.stack(psi_num_slices[::-1])  # (D, H, W)
    probe_num = jnp.stack(probe_num_slices[::-1])[
        :, None, None
    ]  # (D, 1, 1, M, P, P)

    # --- Eigen weight update (`rpie.py:493-506`) ---
    eigen_delta = None
    if recover_probe and eigen_weights is not None:
        patches0 = (
            slice_patches[0]
            if slice_patches is not None
            else patch_fwd(
                psi[0], scan_b, cfg.probe_shape,
                precision=precision.SOLVER_MATMUL,
            )
        )[:, None]
        OP = patches0 * probe[0, :, 0:1, :, :]
        eigen_numerator = jnp.sum(
            jnp.real(jnp.conj(OP) * diff[:, 0:1]), axis=(-1, -2)
        )
        eigen_denominator = jnp.sum(jnp.abs(OP) ** 2, axis=(-1, -2)) + 1e-32
        eigen_delta = (
            0.1 * (eigen_numerator / eigen_denominator)[:, 0] * bmask
        )

    return costs, psi_num, probe_num, eigen_delta


@jax.jit(
    static_argnames=(
        "cfg",
        "noise_model",
        "steplength_usemodes",
        "recover_probe",
    ),
)
def _batch_gradients(*args, **kwargs):
    """Jitted single-batch gradients (see :func:`_batch_gradients_math`)."""
    return _batch_gradients_math(*args, **kwargs)


@jax.jit(
    static_argnames=(
        "cfg",
        "noise_model",
        "steplength_usemodes",
        "recover_probe",
        "recover_psi",
        "compact",
    ),
)
def _rpie_epoch_program(
    cfg: PtychoConfig,
    data,            # (nb, L, DET, DET) batch-major
    scan,            # (N, 2)
    batch_idx,       # (nb, L) int32
    batch_mask,      # (nb, L) f32
    order,           # (nb,) int32 batch visit order
    psi,
    probe,
    eigen_probe,
    eigen_weights,
    measured_pixels,
    psi_precond,
    probe_precond,
    alpha,
    step_length_start,
    step_length_weight,
    unmeasured_pixels_scaling,
    *,
    noise_model: str,
    steplength_usemodes: str,
    recover_psi: bool,
    recover_probe: bool,
    compact: bool,
):
    """One full rPIE epoch as a single XLA program.

    A `lax.scan` over mini-batches replaces the per-batch Python loop,
    collapsing several programs per batch into one dispatch per epoch.
    Equivalent to the reference epoch loop (`rpie.py:106-186`) for the
    non-adaptive-moment paths; adaptive moments use the Python loop.
    """
    nb = data.shape[0]
    has_eigen = eigen_weights is not None

    def batch_step(carry, i):
        psi_c, probe_c, eigen_w, psi_acc, probe_acc = carry
        n = order[i]
        data_b = data[n]
        idx = batch_idx[n]
        bmask = batch_mask[n]
        costs, psi_num, probe_num, eigen_delta = _batch_gradients_math(
            cfg,
            data_b,
            scan,
            idx,
            bmask,
            psi_c,
            probe_c,
            eigen_probe,
            eigen_w,
            measured_pixels,
            step_length_start,
            step_length_weight,
            unmeasured_pixels_scaling,
            noise_model=noise_model,
            steplength_usemodes=steplength_usemodes,
            recover_probe=recover_probe,
        )
        if has_eigen and eigen_delta is not None:
            eigen_w = eigen_w.at[idx, 0, 0].add(eigen_delta)
        if compact:
            psi_acc = psi_acc + psi_num
            probe_acc = probe_acc + probe_num
        else:
            if recover_psi:
                deno = (1 - alpha) * psi_precond + alpha * jnp.abs(
                    psi_precond
                ).max(axis=(-2, -1), keepdims=True)
                psi_c = psi_c + psi_num / deno
            if recover_probe:
                ppre = jnp.abs(probe_precond[0])
                pdeno = (1 - alpha) * ppre + alpha * ppre.max()
                probe_c = probe_c + probe_num[0] / pdeno
        cost = jnp.sum(costs * bmask) / jnp.maximum(jnp.sum(bmask), 1)
        return (psi_c, probe_c, eigen_w, psi_acc, probe_acc), (n, cost)

    psi_acc0 = jnp.zeros_like(psi)
    probe_acc0 = jnp.zeros((psi.shape[0], *probe.shape), probe.dtype)
    (psi, probe, eigen_weights, psi_acc, probe_acc), (ns, costs) = (
        jax.lax.scan(
            batch_step,
            (psi, probe, eigen_weights, psi_acc0, probe_acc0),
            jnp.arange(nb),
        )
    )
    if compact:
        if recover_psi:
            deno = (1 - alpha) * psi_precond + alpha * jnp.abs(
                psi_precond
            ).max(axis=(-2, -1), keepdims=True)
            psi = psi + psi_acc / deno
        if recover_probe:
            ppre = jnp.abs(probe_precond[0])
            pdeno = (1 - alpha) * ppre + alpha * ppre.max()
            probe = probe + probe_acc[0] / pdeno
    # Unpermute per-batch costs to batch order.
    costs_by_batch = jnp.zeros(nb, costs.dtype).at[ns].set(costs)
    return psi, probe, eigen_weights, costs_by_batch


@jax.jit(static_argnames=("recover_psi", "recover_probe"))
def _plain_update_program(
    psi,
    probe,
    psi_num,
    probe_num,
    psi_precond,
    probe_precond,
    alpha,
    *,
    recover_psi: bool,
    recover_probe: bool,
):
    """The non-momentum rPIE update fused into one XLA program."""
    if recover_psi:
        deno = (1 - alpha) * psi_precond + alpha * jnp.abs(psi_precond).max(
            axis=(-2, -1), keepdims=True
        )
        psi = psi + psi_num / deno
    if recover_probe:
        ppre = jnp.abs(probe_precond[0])
        pdeno = (1 - alpha) * ppre + alpha * ppre.max()
        probe = probe + probe_num[0] / pdeno
    return psi, probe


def _update(
    psi,
    probe,
    psi_update_numerator,
    probe_update_numerator,
    object_options,
    probe_options,
    recover_probe: bool,
    algorithm_options: RpieOptions,
    errors=None,
):
    """Apply object/probe updates with optional adaptive moments.

    Mirrors `rpie.py:217-312`. The adam / checked-momentum state mutation
    happens here on the options objects (host-held jnp arrays).
    """
    alpha = algorithm_options.alpha
    use_moments = (
        object_options is not None and object_options.use_adaptive_moment
    ) or (
        recover_probe
        and probe_options is not None
        and probe_options.use_adaptive_moment
    )
    if not use_moments:
        # Fast path: one fused program, no intermediate dispatches.
        return _plain_update_program(
            psi,
            probe,
            psi_update_numerator
            if psi_update_numerator is not None
            else jnp.zeros_like(psi),
            probe_update_numerator
            if probe_update_numerator is not None
            else jnp.zeros((1, *probe.shape), probe.dtype),
            object_options.preconditioner
            if object_options is not None
            else jnp.ones_like(psi),
            probe_options.preconditioner
            if probe_options is not None and recover_probe
            else jnp.ones((1, *probe.shape[-2:]), probe.dtype),
            jnp.asarray(alpha, jnp.float32),
            recover_psi=object_options is not None,
            recover_probe=recover_probe,
        )
    if object_options:
        dpsi = psi_update_numerator
        deno = (1 - alpha) * object_options.preconditioner + alpha * jnp.abs(
            object_options.preconditioner
        ).max(axis=(-2, -1), keepdims=True)
        psi = psi + dpsi / deno
        if object_options.use_adaptive_moment:
            if errors:
                (
                    dpsi,
                    object_options.v,
                    object_options.m,
                ) = tike_tpu.opt.momentum_checked(
                    dpsi,
                    object_options.v,
                    object_options.m,
                    mdecay=object_options.mdecay,
                    errors=errors,
                    memory_length=3,
                )
            else:
                (
                    dpsi,
                    object_options.v,
                    object_options.m,
                ) = tike_tpu.opt.adam(
                    dpsi,
                    object_options.v,
                    object_options.m,
                    vdecay=object_options.vdecay,
                    mdecay=object_options.mdecay,
                )
            psi = psi + dpsi / deno

    if recover_probe:
        dprobe = probe_update_numerator[0]
        # NOTE: The reference snapshot divides by alpha*max(precond) only
        # (`rpie.py:269-280`), which linearizes to a per-batch gain of
        # 1/(num_batch*alpha) — divergent for the default num_batch=5,
        # alpha=0.05. We use the rPIE paper's preconditioned denominator
        # (Maiden, Johnson, Li 2017 eq. 6; also the commented-out
        # predecessor in the reference), which is stable:
        # (1-a)*sum|O|^2 + a*max(sum|O|^2).
        ppre = jnp.abs(probe_options.preconditioner[0])
        pdeno = (1 - alpha) * ppre + alpha * ppre.max()
        probe = probe + dprobe / pdeno
        if probe_options.use_adaptive_moment:
            # ptychoshelves only applies momentum to the main probe
            mode = 0
            if errors:
                (
                    d,
                    probe_options.v,
                    probe_options.m,
                ) = tike_tpu.opt.momentum_checked(
                    g=dprobe[0, 0, mode],
                    v=probe_options.v,
                    m=probe_options.m,
                    mdecay=probe_options.mdecay,
                    errors=errors,
                    memory_length=3,
                )
            else:
                (
                    d,
                    probe_options.v,
                    probe_options.m,
                ) = tike_tpu.opt.adam(
                    g=dprobe[0, 0, mode],
                    v=probe_options.v,
                    m=probe_options.m,
                    vdecay=probe_options.vdecay,
                    mdecay=probe_options.mdecay,
                )
            probe = probe.at[0, 0, mode].add(d / pdeno)
    return psi, probe


_jit_add = jax.jit(lambda a, b: jax.tree_util.tree_map(jnp.add, a, b))


def _normalize_eigen_weights(eigen_weights):
    import tike_tpu.linalg as la

    # The epsilon keeps all-zero weight columns (unused eigen slots, e.g.
    # modes beyond probes_with_modes) at zero instead of 0/0 = NaN; the
    # reference (`rpie.py:209-216`) divides unguarded.
    return eigen_weights / (
        la.mnorm(eigen_weights, axis=-3, keepdims=True) + 1e-32
    )


def rpie(
    parameters: PtychoParameters,
    data,
    batches: typing.Tuple[np.ndarray, np.ndarray],
    *,
    op: PtychoConfig,
    epoch: int,
    rng: np.random.Generator | None = None,
) -> PtychoParameters:
    """One rPIE epoch over all mini-batches.

    Equivalent of the reference solver entry (`rpie.py:26-206`). `batches` is
    the (indices, mask) pair from cluster.batches_padded; `data` is the full
    device-resident (N, DET, DET) array.
    """
    rng = np.random.default_rng() if rng is None else rng
    scan = parameters.scan
    psi = parameters.psi
    probe = parameters.probe
    algorithm_options = parameters.algorithm_options
    eigen_weights = parameters.eigen_weights
    eigen_probe = parameters.eigen_probe
    exitwave_options = parameters.exitwave_options
    object_options = parameters.object_options
    probe_options = parameters.probe_options
    # Unified gating: both update_start and update_period are honored, the
    # documented semantics of ProbeOptions.recover_probe (the reference's
    # solvers check only update_start, `rpie.py:91`, diverging from its own
    # driver; here the per-epoch and fused paths agree by construction).
    recover_probe = (
        probe_options is not None and probe_options.recover_probe(epoch)
    )

    batch_idx, batch_mask = batches
    num_batch = batch_idx.shape[0]
    compact = algorithm_options.batch_method == "compact"
    if compact:
        order = np.arange(num_batch)
    else:
        order = rng.permutation(num_batch)

    use_moments = (
        object_options is not None and object_options.use_adaptive_moment
    ) or (
        recover_probe
        and probe_options is not None
        and probe_options.use_adaptive_moment
    )
    # Fast path: the whole epoch as one XLA program (device-resident
    # batch-major data, no host-side adaptive-moment control flow).
    if not use_moments and isinstance(data, jax.Array) and data.ndim == 4:
        psi, probe, eigen_weights, costs_by_batch = _rpie_epoch_program(
            op,
            data,
            scan,
            jnp.asarray(batch_idx),
            jnp.asarray(batch_mask),
            jnp.asarray(order.astype(np.int32)),
            psi,
            probe,
            eigen_probe,
            eigen_weights,
            exitwave_options.measured_pixels,
            object_options.preconditioner
            if object_options is not None
            else jnp.ones_like(psi),
            probe_options.preconditioner
            if probe_options is not None and recover_probe
            else jnp.ones((1, *probe.shape[-2:]), probe.dtype),
            jnp.asarray(algorithm_options.alpha, jnp.float32),
            exitwave_options.step_length_start,
            exitwave_options.step_length_weight,
            exitwave_options.unmeasured_pixels_scaling,
            noise_model=exitwave_options.noise_model,
            steplength_usemodes=exitwave_options.step_length_usemodes,
            recover_psi=object_options is not None,
            recover_probe=recover_probe,
            compact=compact,
        )
        costs_host = np.asarray(costs_by_batch)
        algorithm_options.costs.append([float(np.mean(costs_host))])
        if eigen_weights is not None:
            eigen_weights = _normalize_eigen_weights(eigen_weights)
        parameters.scan = scan
        parameters.psi = psi
        parameters.probe = probe
        parameters.eigen_weights = eigen_weights
        parameters.eigen_probe = eigen_probe
        return parameters

    psi_update_numerator = None
    probe_update_numerator = None
    # Per-batch costs stay device-resident scalars during the sweep and are
    # downloaded once per epoch — a blocking device->host read per batch
    # would serialize host and device.
    batch_cost_dev: typing.List[jax.Array] = []

    # Double-buffered host-to-device prefetch when data is host-resident
    # (the >HBM streaming mode, replacing the reference's CUDA-stream
    # pipeline `stream.py:285-404`): upload of batch k+1 overlaps compute
    # of batch k because device_put is asynchronous.
    host_data = not isinstance(data, jax.Array)

    def _put(n):
        # np.ndarray batch -> async single-put; HostStreamedBatches batch
        # -> already a globally-sharded device array (async assembly).
        b = data[n]
        return b if isinstance(b, jax.Array) else jax.device_put(b)

    if host_data:
        next_dev = _put(order[0])
    for k, n in enumerate(order):
        idx = jnp.asarray(batch_idx[n])
        bmask = jnp.asarray(batch_mask[n])
        if host_data:
            data_b = next_dev
            if k + 1 < len(order):
                next_dev = _put(order[k + 1])
        else:
            # data may be batch-major (num_batch, L, DET, DET) or flat
            # (N, DET, DET); slice or gather accordingly.
            data_b = (
                data[n] if data.ndim == 4 else jnp.take(data, idx, axis=0)
            )
        costs, psi_num, probe_num, eigen_delta = _batch_gradients(
            op,
            data_b,
            scan,
            idx,
            bmask,
            psi,
            probe,
            eigen_probe,
            eigen_weights,
            exitwave_options.measured_pixels,
            exitwave_options.step_length_start,
            exitwave_options.step_length_weight,
            exitwave_options.unmeasured_pixels_scaling,
            noise_model=exitwave_options.noise_model,
            steplength_usemodes=exitwave_options.step_length_usemodes,
            recover_probe=recover_probe,
        )
        nvalid = batch_mask[n].sum()
        batch_cost_dev.append(
            jnp.sum(costs * bmask) / max(nvalid, 1)
        )

        if eigen_delta is not None:
            eigen_weights = eigen_weights.at[idx, 0, 0].add(eigen_delta)

        if psi_update_numerator is None:
            psi_update_numerator = psi_num
            probe_update_numerator = probe_num
        else:
            psi_update_numerator, probe_update_numerator = _jit_add(
                (psi_update_numerator, probe_update_numerator),
                (psi_num, probe_num),
            )

        if algorithm_options.batch_method != "compact":
            psi, probe = _update(
                psi,
                probe,
                psi_update_numerator,
                probe_update_numerator,
                object_options,
                probe_options,
                recover_probe,
                algorithm_options,
            )
            psi_update_numerator = None
            probe_update_numerator = None

    batch_cost = np.asarray(jnp.stack(batch_cost_dev))
    algorithm_options.costs.append([float(np.mean(batch_cost))])

    if algorithm_options.batch_method == "compact":
        psi, probe = _update(
            psi,
            probe,
            psi_update_numerator,
            probe_update_numerator,
            object_options,
            probe_options,
            recover_probe,
            algorithm_options,
            errors=[float(x[0]) for x in algorithm_options.costs[-3:]],
        )

    if eigen_weights is not None:
        eigen_weights = _normalize_eigen_weights(eigen_weights)

    parameters.scan = scan
    parameters.psi = psi
    parameters.probe = probe
    parameters.algorithm_options = algorithm_options
    parameters.eigen_weights = eigen_weights
    parameters.eigen_probe = eigen_probe
    parameters.exitwave_options = exitwave_options
    parameters.object_options = object_options
    parameters.probe_options = probe_options
    return parameters

"""Least-squares maximum-likelihood (LSQML) solver.

JAX equivalent of `upstream/src/tike/ptycho/solvers/lstsq.py`
implementing Odstrcil, Menzel, Guizar-Sicairos 2018 (Optics Express): object
and probe updated simultaneously with jointly-optimal step sizes from a
per-position 2x2 least-squares solve, plus eigen-probe (OPR) updates and
gradient-based position correction.

Single-slice only, like the reference implementation (its `_get_nearplane_
gradients` indexes `psi[0]` / `object_upd_sum[0]` directly).
"""

from __future__ import annotations

import logging
import typing

import jax
import jax.numpy as jnp
import numpy as np

import tike_tpu.linalg as la
import tike_tpu.opt
from tike_tpu.ops.objective import ELEMENTWISE, GRAD
from tike_tpu.ops.patch import patch_adj, patch_fwd
from tike_tpu import precision
from tike_tpu.ops.propagation import propagation_adj, propagation_fwd
from tike_tpu.ops.ptycho import (
    PtychoConfig,
    _crop_from_detector,
    _pad_to_detector,
)
from ..exitwave import (
    poisson_steplength_all_modes,
    poisson_steplength_dominant_mode,
)
from ..position import gaussian_gradient
from ..probe import get_varying_probe, update_eigen_probe
from .options import PtychoParameters
from .rpie import _masked_mean_each_pattern

logger = logging.getLogger(__name__)

_jit_add = jax.jit(lambda a, b: jax.tree_util.tree_map(jnp.add, a, b))
_bmul = jax.jit(lambda b, x: b * x)
_precondition_object_update_p = None  # set below after definition


def _fz(x):
    """Replace non-finite entries with 0 (degenerate-batch 0/0 guards).

    A no-op on finite data, so replicated-path parity is unchanged.
    """
    return jnp.where(jnp.isfinite(x), x, 0)


def _trim_mean(x, proportion=0.05, axis=0):
    """Mean with the extreme `proportion` trimmed from both ends."""
    n = x.shape[axis]
    k = int(n * proportion)
    s = jnp.sort(x, axis=axis)
    sl = [slice(None)] * x.ndim
    sl[axis] = slice(k, n - k)
    return jnp.mean(s[tuple(sl)], axis=axis, keepdims=True)


def _masked_trim_mean(x, mask, proportion=0.05):
    """:func:`_trim_mean` over axis 0 counting only ``mask > 0`` rows.

    Equals _trim_mean when the mask is all ones; used by the striped mode
    where positions are padded to a common per-stripe capacity.
    """
    valid = mask > 0
    big = jnp.where(valid[:, None], x, jnp.inf)
    s = jnp.sort(big, axis=0)
    nv = jnp.sum(valid).astype(jnp.int32)
    k = (proportion * nv).astype(jnp.int32)
    idx = jnp.arange(x.shape[0])[:, None]
    inr = (idx >= k) & (idx < nv - k)
    cnt = jnp.maximum(jnp.sum(inr, axis=0), 1)
    return jnp.sum(jnp.where(inr, s, 0.0), axis=0, keepdims=True) / cnt


def _lstsq_batch_math(
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
    psi_preconditioner,
    step_length_start,
    step_length_weight,
    unmeasured_pixels_scaling,
    *,
    num_batch: float,
    noise_model: str,
    steplength_usemodes: str,
    recover_psi: bool,
    recover_probe: bool,
    recover_positions: bool,
):
    """One LSQML mini-batch: gradients, optimal betas, eigen + position terms.

    Fuses the reference's `_get_nearplane_gradients` (`lstsq.py:367-602`),
    `_update_nearplane` (`:297-364`), and `_precondition_nearplane_gradients`
    (`:619-718`) into one jitted program.

    Returns a dict of updates; eigen_probe/eigen_weights are returned
    updated in-place (weights for the batch slice only, as deltas applied to
    the full array via idx).
    """
    nmodes = probe.shape[-3]
    m = 0  # the mode used for beta/eigen/position solves
    scan_b = jnp.take(scan, idx, axis=0)

    if eigen_weights is not None:
        w_b = jnp.take(eigen_weights, idx, axis=0)
        unique_probe = get_varying_probe(probe, eigen_probe, w_b)  # (B,1,M,P,P)
    else:
        w_b = None
        unique_probe = jnp.broadcast_to(
            probe, (scan_b.shape[0], 1, nmodes, cfg.probe_shape, cfg.probe_shape)
        )

    # Forward model (single slice).
    patches2d = patch_fwd(
        psi[0], scan_b, cfg.probe_shape, precision=precision.SOLVER_MATMUL
    )  # (B, P, P)
    nearplane = patches2d[:, None, None] * unique_probe  # (B,1,M,P,P)
    farplane = propagation_fwd(_pad_to_detector(nearplane, cfg))
    intensity = jnp.sum(
        jnp.square(jnp.abs(farplane)), axis=(1, 2)
    )  # (B, DET, DET)

    costs = _masked_mean_each_pattern(
        ELEMENTWISE[noise_model](data_b, intensity), measured_pixels
    )

    if noise_model == "poisson":
        xi = (1 - data_b / (intensity + 1e-9))[:, None, None]
        grad_cost = farplane * xi
        step_length = jnp.full(
            (farplane.shape[0], 1, nmodes, 1, 1),
            step_length_start,
            dtype=intensity.dtype,
        )
        if steplength_usemodes == "dominant_mode":
            step_length = poisson_steplength_dominant_mode(
                xi, intensity, data_b, measured_pixels, step_length,
                step_length_weight,
            )
        else:
            step_length = poisson_steplength_all_modes(
                xi, jnp.square(jnp.abs(farplane)), intensity, data_b,
                measured_pixels, step_length, step_length_weight,
            )
        update = -step_length * grad_cost
    else:
        update = -GRAD[noise_model](data_b, farplane, intensity)

    chi_far = jnp.where(
        measured_pixels, update, farplane * (unmeasured_pixels_scaling - 1.0)
    )
    chi = _crop_from_detector(propagation_adj(chi_far), cfg)  # (B,1,M,P,P)
    chi = chi * bmask[:, None, None, None, None]

    out = {"costs": costs}

    # (24b)/(25b) object gradient: sum over modes and positions.
    if recover_psi:
        object_update_proj = jnp.conj(unique_probe) * chi
        object_upd_sum = patch_adj(
            jnp.sum(object_update_proj[:, 0], axis=1), scan_b,
            (cfg.nz, cfg.n),
            precision=precision.SOLVER_MATMUL,
        )[None]
        out["object_upd_sum"] = object_upd_sum
    else:
        object_upd_sum = None

    # (24a)/(25a) probe gradient: simple average over batch (ptychoshelves).
    bpatches = patches2d[:, None, None]  # (B,1,1,P,P)
    if recover_probe:
        bprobe_update = jnp.conj(bpatches) * chi  # (B,1,M,P,P)
        m_probe_update = (
            jnp.sum(bprobe_update, axis=0, keepdims=True)[None][0] / num_batch
        )  # (1,1,M,P,P)
        out["m_probe_update"] = m_probe_update
    else:
        bprobe_update = None
        m_probe_update = None

    # Eigen probe (OPR) updates (`lstsq.py:297-364`).
    if recover_probe and eigen_weights is not None:
        # _get_coefs_intensity: update weight of the shared probe component.
        OP = bpatches * probe[:, :, m : m + 1]
        num = jnp.sum(
            jnp.real(jnp.conj(OP) * chi[:, :, m : m + 1]), axis=(-1, -2)
        )
        den = jnp.sum(jnp.abs(OP) ** 2, axis=(-1, -2)) + 1e-32
        w_b = w_b.at[:, 0:1, m : m + 1].add(
            0.1 * (num / den) * bmask[:, None, None]
        )

        if w_b.shape[-2] > 1 and eigen_probe is not None:
            R = (
                bprobe_update[..., m : m + 1, :, :]
                - m_probe_update[..., m : m + 1, :, :]
            )
            for c in range(1, eigen_probe.shape[-4] + 1):
                if m < eigen_probe.shape[-3]:
                    eigen_probe, w_b = update_eigen_probe(
                        R,
                        eigen_probe,
                        w_b,
                        bpatches,
                        chi,
                        valid=bmask,
                        β=min(0.1, 1.0 / num_batch),
                        c=c,
                        m=m,
                    )
                    if c + 1 < w_b.shape[-2]:
                        R = R - la.projection(
                            R,
                            eigen_probe[:, c - 1 : c, m : m + 1],
                            axis=(-2, -1),
                        )
        out["eigen_probe"] = eigen_probe
        out["w_b"] = w_b

    # Position gradient terms (`lstsq.py:545-579`).
    if recover_positions:
        grad_x, grad_y = gaussian_gradient(bpatches, sigma=0.333)
        crop = probe.shape[-1] // 4
        up = unique_probe[..., m : m + 1, crop:-crop, crop:-crop]
        cc = chi[..., m : m + 1, crop:-crop, crop:-crop]
        gx = grad_x[..., crop:-crop, crop:-crop] * up
        gy = grad_y[..., crop:-crop, crop:-crop] * up
        pos_num = jnp.stack(
            [
                jnp.sum(jnp.real(jnp.conj(gx) * cc), axis=(-4, -3, -2, -1)),
                jnp.sum(jnp.real(jnp.conj(gy) * cc), axis=(-4, -3, -2, -1)),
            ],
            axis=-1,
        )
        pos_den = jnp.stack(
            [
                jnp.sum(jnp.abs(gx) ** 2, axis=(-4, -3, -2, -1)),
                jnp.sum(jnp.abs(gy) ** 2, axis=(-4, -3, -2, -1)),
            ],
            axis=-1,
        )
        out["pos_num"] = pos_num * bmask[:, None]
        out["pos_den"] = pos_den * bmask[:, None]

    # Optimal step sizes (`lstsq.py:619-718`).
    eps = 1e-9 / (cfg.probe_shape * cfg.probe_shape)
    A1 = A2 = A4 = b1 = b2 = dOP = dPO = None
    if recover_psi:
        object_update_precond = _precondition_object_update(
            object_upd_sum, psi_preconditioner
        )
        out["object_update_precond"] = object_update_precond
        proj = patch_fwd(
            object_update_precond[0], scan_b, cfg.probe_shape,
            precision=precision.SOLVER_MATMUL,
        )
        dOP = proj[:, None, None] * unique_probe[..., m : m + 1, :, :]
        A1 = jnp.sum((dOP * dOP.conj()).real + eps, axis=(-2, -1))
        A1 = A1 + 0.5 * jnp.mean(A1, axis=-3)
    if recover_probe:
        dPO = m_probe_update[..., m : m + 1, :, :] * bpatches
        A4 = jnp.sum((dPO * dPO.conj()).real + eps, axis=(-2, -1))
        A4 = A4 + 0.5 * jnp.mean(A4, axis=-3)

    chi_m = chi[..., m : m + 1, :, :]
    x1_solo = None
    if recover_psi and recover_probe:
        b1 = jnp.sum((dOP.conj() * chi_m).real, axis=(-2, -1))
        b2 = jnp.sum((dPO.conj() * chi_m).real, axis=(-2, -1))
        A2 = jnp.sum(dOP * dPO.conj(), axis=(-2, -1))
        A3 = A2.conj()
        determinant = A1 * A4 - A2 * A3
        determinant = jnp.where(jnp.abs(determinant) == 0, 1e-32, determinant)
        x1 = -jnp.conj(A2 * b2 - A4 * b1) / determinant
        x2 = jnp.conj(A1 * b2 - A3 * b1) / determinant
        # The uncoupled object step, for epochs where the fused program
        # gates probe recovery off (matches the per-epoch recover_probe=False
        # solve exactly).
        x1_solo = b1 / A1
    elif recover_psi:
        b1 = jnp.sum((dOP.conj() * chi_m).real, axis=(-2, -1))
        x1 = b1 / A1
        x2 = None
    elif recover_probe:
        b2 = jnp.sum((dPO.conj() * chi_m).real, axis=(-2, -1))
        x2 = b2 / A4
        x1 = None
    else:
        x1 = x2 = None

    nvalid = jnp.sum(bmask) + 1e-32
    # Degenerate (all-masked) batches — empty stripes in the striped
    # object mode — give 0/0 in the per-position solves; their masked
    # weighted sums must be 0, not NaN (NaN * 0 = NaN otherwise).
    if x1 is not None:
        step = 0.9 * jnp.maximum(0, _fz(x1[..., None, None].real))
        out["beta_object"] = (
            jnp.sum(step * bmask[:, None, None, None, None], axis=0) / nvalid
        )[0, 0, 0]
    if x1_solo is not None:
        step = 0.9 * jnp.maximum(0, _fz(x1_solo[..., None, None].real))
        out["beta_object_solo"] = (
            jnp.sum(step * bmask[:, None, None, None, None], axis=0) / nvalid
        )[0, 0, 0]
    if x2 is not None:
        step = 0.9 * jnp.maximum(0, _fz(x2[..., None, None].real))
        out["beta_probe"] = (
            jnp.sum(step * bmask[:, None, None, None, None], axis=0) / nvalid
        )
    return out


_lstsq_batch = jax.jit(
    static_argnames=(
        "cfg",
        "num_batch",
        "noise_model",
        "steplength_usemodes",
        "recover_psi",
        "recover_probe",
        "recover_positions",
    ),
)(_lstsq_batch_math)


def _precondition_object_update(
    object_upd_sum, psi_update_denominator, alpha: float = 0.05
):
    """`lstsq.py:605-616`: divide by smoothed illumination magnitude."""
    d = jnp.abs(psi_update_denominator)
    return object_upd_sum / jnp.sqrt(
        jnp.square((1 - alpha) * d)
        + jnp.square(alpha * jnp.amax(d, axis=(-2, -1), keepdims=True))
    )


# Largest float margin below the valid-position limit dim - P: positions
# clamp to dim - P - _POS_EDGE, whose floor is dim - P - 1 — the exact
# upper corner check_allowed_positions accepts. Exactly representable in
# float32 (2^-8) and large enough to survive rounding at realistic dims.
_POS_EDGE = 1.0 / 256.0


def _update_position(
    scan,
    position_options,
    position_update_numerator,
    position_update_denominator,
    *,
    alpha=0.05,
    max_shift=1,
    epoch=0,
    bounds=None,
):
    """Apply the accumulated position gradient step (`lstsq.py:764-806`).

    ``bounds=(psi_shape, probe_shape)`` clamps the updated positions to
    check_allowed_positions's valid window, matching the fused program
    (drifted positions would otherwise corrupt gradients silently — see
    ops/patch.py boundary semantics).
    """
    if epoch < position_options.update_start:
        return scan, position_options

    step = position_update_numerator / (
        (1 - alpha) * position_update_denominator
        + alpha * jnp.maximum(position_update_denominator.max(), 1e-6)
    )
    if position_options.update_magnitude_limit > 0:
        step = jnp.clip(
            step,
            -position_options.update_magnitude_limit,
            position_options.update_magnitude_limit,
        )
    step = step - _trim_mean(step, 0.05, axis=0)

    if position_options.use_adaptive_moment:
        step, v, mm = tike_tpu.opt.adam(
            step,
            None if position_options._momentum is None
            else jnp.asarray(position_options.v),
            None if position_options._momentum is None
            else jnp.asarray(position_options.m),
            vdecay=position_options.vdecay,
            mdecay=position_options.mdecay,
        )
        momentum = np.zeros((*scan.shape[:-1], 4), dtype=np.float32)
        momentum[..., 0:2] = np.asarray(v)
        momentum[..., 2:4] = np.asarray(mm)
        position_options._momentum = momentum

    scan = scan - step
    if bounds is not None:
        # Clamp drift to exactly check_allowed_positions's valid window
        # (corner floor <= dim - P - 1, i.e. values strictly below
        # dim - P): _POS_EDGE keeps the float below that limit without
        # moving any position the driver-level check would accept.
        psi_shape, probe_shape = bounds
        scan = jnp.stack(
            [
                jnp.clip(
                    scan[..., 0],
                    1.0,
                    psi_shape[-2] - probe_shape[-2] - _POS_EDGE,
                ),
                jnp.clip(
                    scan[..., 1],
                    1.0,
                    psi_shape[-1] - probe_shape[-1] - _POS_EDGE,
                ),
            ],
            axis=-1,
        )
    return scan, position_options


def lstsq_grad(
    parameters: PtychoParameters,
    data,
    batches: typing.Tuple[np.ndarray, np.ndarray],
    *,
    op: PtychoConfig,
    epoch: int,
    rng: np.random.Generator | None = None,
) -> PtychoParameters:
    """One LSQML epoch over all mini-batches (`lstsq.py:25-294`)."""
    rng = np.random.default_rng() if rng is None else rng
    scan = parameters.scan
    psi = parameters.psi
    probe = parameters.probe
    algorithm_options = parameters.algorithm_options
    eigen_weights = parameters.eigen_weights
    eigen_probe = parameters.eigen_probe
    exitwave_options = parameters.exitwave_options
    position_options = parameters.position_options
    object_options = parameters.object_options
    probe_options = parameters.probe_options
    # Unified gating: update_start AND update_period (see rpie.py note).
    recover_probe = (
        probe_options is not None and probe_options.recover_probe(epoch)
    )
    recover_psi = object_options is not None

    assert op.nslices == 1, "LSQML is single-slice (like the reference)."

    batch_idx, batch_mask = batches
    num_batch = batch_idx.shape[0]
    if algorithm_options.batch_method == "compact":
        order = np.arange(num_batch)
    else:
        order = rng.permutation(num_batch)

    object_combined_update = jnp.zeros_like(psi)
    probe_combined_update = jnp.zeros_like(probe)
    pos_num = jnp.zeros_like(scan) if position_options is not None else None
    pos_den = jnp.zeros_like(scan) if position_options is not None else None
    # Device-resident per-batch costs, downloaded once per epoch (see
    # rpie.py: a blocking scalar read per batch serializes the sweep).
    batch_cost_dev: typing.List[jax.Array] = []
    beta_object: typing.List[float] = []
    beta_probe: typing.List[jax.Array] = []

    # Double-buffered host-to-device prefetch when data is host-resident
    # (the >HBM streaming mode; see rpie.py for details).
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
            data_b = (
                data[n] if data.ndim == 4 else jnp.take(data, idx, axis=0)
            )
        out = _lstsq_batch(
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
            object_options.preconditioner
            if object_options is not None
            else jnp.ones((1, op.nz, op.n), jnp.float32),
            exitwave_options.step_length_start,
            exitwave_options.step_length_weight,
            exitwave_options.unmeasured_pixels_scaling,
            num_batch=float(num_batch),
            noise_model=exitwave_options.noise_model,
            steplength_usemodes=exitwave_options.step_length_usemodes,
            recover_psi=recover_psi,
            recover_probe=recover_probe,
            recover_positions=position_options is not None,
        )
        nvalid = batch_mask[n].sum()
        batch_cost_dev.append(
            jnp.sum(out["costs"] * bmask) / max(nvalid, 1)
        )

        if recover_probe and eigen_weights is not None:
            eigen_probe = out["eigen_probe"]
            # Write back batch weight slice; padded slots duplicate idx[0]
            # but their values equal the original (masked updates), so the
            # 'last write wins' scatter is correct.
            eigen_weights = eigen_weights.at[idx].set(out["w_b"])

        if position_options is not None:
            pos_num = pos_num.at[idx].add(out["pos_num"])
            pos_den = pos_den.at[idx].add(out["pos_den"])

        if recover_psi:
            if algorithm_options.batch_method != "compact":
                dpsi = _bmul(
                    out["beta_object"], out["object_update_precond"]
                )
                if object_options.use_adaptive_moment:
                    (
                        dpsi,
                        object_options.v,
                        object_options.m,
                    ) = tike_tpu.opt.momentum(
                        dpsi,
                        object_options.v,
                        object_options.m,
                        vdecay=object_options.vdecay,
                        mdecay=object_options.mdecay,
                    )
                psi = psi + dpsi
            else:
                object_combined_update = _jit_add(
                    object_combined_update, out["object_upd_sum"]
                )
            beta_object.append(out["beta_object"])

        if recover_probe:
            dprobe = _bmul(out["beta_probe"], out["m_probe_update"])
            probe_combined_update = (
                probe_combined_update + dprobe / num_batch
            )
            probe = probe + dprobe
            beta_probe.append(out["beta_probe"])

    if (
        position_options is not None
        and pos_num is not None
        and pos_den is not None
    ):
        scan, position_options = _update_position(
            scan,
            position_options,
            pos_num,
            pos_den,
            epoch=epoch,
            bounds=(psi.shape, probe.shape),
        )

    batch_cost = np.asarray(jnp.stack(batch_cost_dev))
    algorithm_options.costs.append([float(np.mean(batch_cost))])

    if recover_psi and algorithm_options.batch_method == "compact":
        object_update_precond = jax.jit(_precondition_object_update)(
            object_combined_update, object_options.preconditioner
        )
        bobj = float(
            jnp.mean(jnp.stack([jnp.asarray(b) for b in beta_object]))
        )
        dpsi = object_update_precond * bobj
        psi = psi + dpsi
        if object_options.use_adaptive_moment:
            (
                dpsi,
                object_options.v,
                object_options.m,
            ) = tike_tpu.opt.momentum_checked(
                dpsi,
                object_options.v,
                object_options.m,
                mdecay=object_options.mdecay,
                errors=[float(x[0]) for x in algorithm_options.costs[-3:]],
                beta=bobj,
                memory_length=3,
            )
            psi = psi + jax.jit(
                lambda w, d: (
                    jnp.abs(w) / (0.1 * jnp.abs(w).max() + jnp.abs(w))
                )
                * d
            )(object_options.preconditioner, dpsi)

    if recover_probe and probe_options.use_adaptive_moment:
        bprb = float(jnp.mean(jnp.stack(beta_probe)))
        mode = 0
        (
            d,
            probe_options.v,
            probe_options.m,
        ) = tike_tpu.opt.momentum_checked(
            probe_combined_update[..., mode, :, :],
            probe_options.v,
            probe_options.m,
            mdecay=probe_options.mdecay,
            errors=[float(x[0]) for x in algorithm_options.costs[-3:]],
            beta=bprb,
            memory_length=3,
        )
        probe = probe.at[..., mode, :, :].add(d)

    parameters.scan = scan
    parameters.psi = psi
    parameters.probe = probe
    parameters.algorithm_options = algorithm_options
    parameters.eigen_weights = eigen_weights
    parameters.eigen_probe = eigen_probe
    parameters.exitwave_options = exitwave_options
    parameters.position_options = position_options
    parameters.object_options = object_options
    parameters.probe_options = probe_options
    return parameters

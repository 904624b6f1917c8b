"""Fully-fused multi-epoch rPIE: the entire iterate() as one XLA program.

Each host-device round trip costs a dispatch and a sync, so the per-epoch
sequence [probe constraints -> preconditioners -> mini-batches -> object
constraints] is folded into a single program scanning over epochs. Cost and probe-power
histories accumulate on-device and are downloaded once at the end.

Supported configuration (the driver falls back to the per-epoch path
otherwise): rpie or lstsq (LSQML) solver, position correction (lstsq),
adaptive moments (adam / classical / momentum-checked), device-resident
batch-major data, 'mean_of_abs_object' or no rescaling.
Epoch-dependent behavior (probe update gating, periodic rescale, the
momentum-checked cost-trend decision) uses traced predicates with
`jnp.where` blends, matching the reference's host control flow
(`ptycho/ptycho.py:431-564`) exactly for these paths.

The epoch body (`_epoch_math`) is shared with the striped
object-decomposed mode (`tike_tpu.parallel.striped`), which passes a
`StripeComm` so the same math runs per stripe inside `shard_map` with the
cross-stripe collectives inserted.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

import tike_tpu.linalg
from tike_tpu.ops.ptycho import PtychoConfig

from .. import probe as probe_module
from .. import object as object_module
import tike_tpu.opt
from ._preconditioner import (
    _probe_precond_fft_math,
    _probe_precond_math,
    _psi_precond_fft_math,
    _psi_precond_math,
)
from .lstsq import (
    _POS_EDGE,
    _fz,
    _lstsq_batch_math,
    _masked_trim_mean,
    _precondition_object_update,
    _trim_mean,
)
from .rpie import _batch_gradients_math


@jax.tree_util.register_static
@dataclasses.dataclass(frozen=True)
class EpochPlan:
    """All static configuration for a fused multi-epoch run."""

    cfg: PtychoConfig
    solver: str  # 'rpie' | 'lstsq'
    n_epochs: int
    compact: bool
    noise_model: str
    steplength_usemodes: str
    recover_psi: bool
    recover_probe: bool
    has_eigen: bool
    # probe update schedule
    update_start: int
    update_period: int
    # probe constraints
    probe_support: float
    probe_support_radius: float
    probe_support_degree: float
    additional_probe_penalty: float
    median_filter: bool
    median_filter_px: tuple
    force_center: bool
    force_sparsity: float
    force_orthogonality: bool
    # object constraints
    positivity: float
    smoothness: float
    clip_magnitude: bool
    # rescale
    rescale_mean_abs: bool
    rescale_period: int
    alpha: float
    # position correction (lstsq only, like the reference)
    recover_positions: bool = False
    pos_update_start: int = 0
    pos_use_adaptive_moment: bool = False
    pos_vdecay: float = 0.999
    pos_mdecay: float = 0.9
    pos_update_magnitude_limit: float = 0.0
    # adaptive moments for object/probe (`rpie.py:335-457`,
    # `lstsq.py:472-584` in this package; reference `rpie.py:154-206`,
    # `lstsq.py:809-858`). The host decision logic of momentum_checked
    # becomes traced predicates (opt.momentum_checked_traced).
    obj_moment: str = "none"  # none | adam | momentum | checked
    probe_moment: str = "none"  # none | adam | checked
    obj_vdecay: float = 0.999
    obj_mdecay: float = 0.9
    probe_vdecay: float = 0.999
    probe_mdecay: float = 0.9
    # FFT-formulation preconditioners (single-slice; exact — see
    # _preconditioner.py). Static so flipping it retraces the program.
    fft_precond: bool = False
    # rescale_method='constant_probe_photons': rescale shared probe modes
    # to this photon count every rescale_period epochs (0 = off; the
    # reference's `ptycho/ptycho.py:783-795`).
    rescale_photons: float = 0.0


def _probe_constraints_math(plan: EpochPlan, probe):
    """The reference's per-epoch probe constraints (`ptycho.py:723-810`)."""
    if plan.probe_support > 0:
        b0 = probe_module.finite_probe_support(
            probe,
            p=plan.probe_support,
            radius=plan.probe_support_radius,
            degree=plan.probe_support_degree,
        )
        probe = probe - b0 * jnp.conj(b0 * probe)
    if plan.additional_probe_penalty > 0:
        b1 = (
            plan.additional_probe_penalty
            * jnp.linspace(0, 1, probe.shape[-3], dtype=jnp.float32)[
                ..., None, None
            ]
        )
        probe = probe - b1 * jnp.conj(b1 * probe)
    if plan.median_filter:
        probe = probe_module.apply_median_filter_abs_probe(
            probe, med_filt_px=plan.median_filter_px
        )
    if plan.force_center:
        probe = probe_module.constrain_center_peak(probe)
    if plan.force_sparsity < 1:
        probe = probe_module.constrain_probe_sparsity(
            probe, f=plan.force_sparsity
        )
    if plan.force_orthogonality:
        probe, pwr = probe_module._orthogonalize_eig_body(probe)
    else:
        pwr = jnp.sum(
            (probe * jnp.conj(probe)).real, axis=(-2, -1)
        ).reshape(-1)
    return probe, pwr


def seed_err_hist(prev_costs) -> np.ndarray:
    """(3,) tail of the epoch-cost series, right-aligned before the
    current slot (the momentum-checked decision reads costs[-3:] after
    the in-program roll appends the current epoch's cost)."""
    eh = np.full(3, np.inf, np.float32)
    tail = list(prev_costs)[-2:]
    if len(tail) >= 1:
        eh[2] = tail[-1]
    if len(tail) >= 2:
        eh[1] = tail[-2]
    return eh


@jax.tree_util.register_static
@dataclasses.dataclass(frozen=True)
class StripeComm:
    """Static SPMD configuration for the striped (object-decomposed) mode.

    When passed to :func:`_epoch_math`, probe/eigen reconciliation become
    weighted psum-means over ``axis``, the probe preconditioner is psummed,
    the momentum-checked decision uses the global epoch cost, and the psi
    halo rows are cross-faded with the stripe neighbors (the reference's
    per-epoch `Allreduce_mean` + `swap_edges`, `ptycho/ptycho.py:474-502`).
    """

    axis: str
    ndev: int
    halo: int
    hs: int  # stripe interior height
    height: int  # global object height H (rows), before stripe padding


def _epoch_begin_math(
    plan: EpochPlan, comm, psi, probe, scan, batch_idx, batch_mask,
    recover_now, total_e,
):
    """Data-free start of an epoch: gated probe constraints and the
    whole-epoch preconditioners (both depend only on psi/probe/scan, never
    on the diffraction data — which is what makes host-streaming the data
    per batch possible, `striped.py` streamed mode)."""
    cfg = plan.cfg
    if plan.recover_probe:
        constrained, pwr = _probe_constraints_math(plan, probe)
        probe = jnp.where(recover_now, constrained, probe)
    else:
        pwr = jnp.sum(
            (probe * jnp.conj(probe)).real, axis=(-2, -1)
        ).reshape(-1)
    if plan.rescale_photons > 0:
        # rescale_method='constant_probe_photons' applies with the
        # start-of-epoch constraints, gated on the epochs completed so far
        # (the reference's `len(costs) % rescale_period == 0`,
        # `ptycho/ptycho.py:783-795`) and independent of probe recovery.
        do_rp = (total_e % plan.rescale_period) == 0
        rescaled = probe_module.rescale_probe_using_fixed_intensity_photons(
            probe, Nphotons=plan.rescale_photons, probe_power_fraction=None
        )
        probe = jnp.where(do_rp, rescaled, probe)

    # Preconditioners over all batches: one FFT-formulation program when
    # single-slice (exact — tests/ptycho/test_precond_fft.py), else a
    # lax.scan of per-batch patch gathers.
    psi_pre0 = jnp.zeros((cfg.nslices, cfg.nz, cfg.n), jnp.float32)
    probe_pre0 = jnp.zeros(
        (cfg.nslices, cfg.probe_shape, cfg.probe_shape), jnp.float32
    )
    if plan.fft_precond and cfg.nslices == 1:
        w_all = (
            jnp.zeros(scan.shape[0], jnp.float32)
            .at[batch_idx.reshape(-1)]
            .add(batch_mask.reshape(-1))
        )
        psi_pre = (
            _psi_precond_fft_math(cfg, scan, probe, w_all)
            if plan.recover_psi
            else psi_pre0
        )
        probe_pre = (
            _probe_precond_fft_math(cfg, psi, scan, w_all)
            if plan.recover_probe
            else probe_pre0
        )
    else:

        def pre_body(carry2, inp):
            psi_pre, probe_pre = carry2
            idx, bmask = inp
            scan_b = jnp.take(scan, idx, axis=0)
            if plan.recover_psi:
                psi_pre = psi_pre + _psi_precond_math(
                    cfg, psi, scan_b, probe, bmask
                )
            if plan.recover_probe:
                probe_pre = probe_pre + _probe_precond_math(
                    cfg, psi, scan_b, bmask
                )
            return (psi_pre, probe_pre), None

        (psi_pre, probe_pre), _ = jax.lax.scan(
            pre_body, (psi_pre0, probe_pre0), (batch_idx, batch_mask)
        )
    if comm is not None and plan.recover_probe:
        # The probe preconditioner sums |patches|^2 over every stripe's
        # positions (the reference pools it across GPUs,
        # `_preconditioner.py:170-209`).
        probe_pre = jax.lax.psum(probe_pre, comm.axis)
    return probe, pwr, psi_pre, probe_pre


def _epoch_math(
    plan: EpochPlan,
    comm,              # None (single device) or StripeComm (inside shard_map)
    epoch0,
    data,
    batch_idx,
    batch_mask,
    orders,
    measured_pixels,
    step_length_start,
    step_length_weight,
    unmeasured_pixels_scaling,
    row_mask,          # (nz,) f32 interior-row mask for global stats, or None
    pos_mask,          # (N,) f32 valid-position mask, or None
    carry,
    e,
):
    """One full solver epoch: the shared math of the fused replicated path
    (:func:`iterate_program`, comm=None) and the striped object-decomposed
    path (`tike_tpu.parallel.striped`, comm=StripeComm inside shard_map).
    Composed from :func:`_epoch_begin_math`, :func:`_batch_update_math`,
    and :func:`_epoch_end_math` so the striped streamed mode can run the
    same pieces as separate programs with host-fed batch data.
    """
    nb = batch_idx.shape[0]

    (
        psi,
        probe,
        eigen_p,
        eigen_w,
        scan,
        pos_v,
        pos_m,
        obj_v,
        obj_m,
        probe_v,
        probe_m,
        err_hist,
    ) = carry

    total_e = epoch0 + e
    recover_now = jnp.logical_and(
        total_e >= plan.update_start,
        (total_e % plan.update_period) == 0,
    )
    probe, pwr, psi_pre, probe_pre = _epoch_begin_math(
        plan, comm, psi, probe, scan, batch_idx, batch_mask, recover_now,
        total_e,
    )

    # Mini-batch sweep.
    order = orders[e]
    gate = recover_now.astype(jnp.float32)

    def batch_step(carry2, i):
        n = order[i]
        new_carry, (cost, beta_obj) = _batch_update_math(
            plan,
            data[n],
            scan,
            batch_idx[n],
            batch_mask[n],
            psi_pre,
            probe_pre,
            measured_pixels,
            step_length_start,
            step_length_weight,
            unmeasured_pixels_scaling,
            gate,
            recover_now,
            nb,
            carry2,
        )
        return new_carry, (n, cost, beta_obj)

    return _epoch_sweep_and_end(
        plan,
        comm,
        batch_step,
        nb,
        psi,
        probe,
        eigen_p,
        eigen_w,
        scan,
        pos_v,
        pos_m,
        obj_v,
        obj_m,
        probe_v,
        probe_m,
        err_hist,
        psi_pre,
        probe_pre,
        batch_mask,
        row_mask,
        pos_mask,
        recover_now,
        gate,
        total_e,
        pwr,
    )


def _batch_update_math(
    plan: EpochPlan,
    data_n,            # (L, DET, DET) this batch's diffraction patterns
    scan,
    idx_n,             # (L,) int32 rows of scan/eigen_w for this batch
    mask_n,            # (L,) f32 padded-slot mask
    psi_pre,
    probe_pre,
    measured_pixels,
    step_length_start,
    step_length_weight,
    unmeasured_pixels_scaling,
    gate,
    recover_now,
    nb,                # static: number of batches in the epoch
    carry2,
):
    """One mini-batch update against the epoch's preconditioners.

    The only input that touches the diffraction data is ``data_n``, so the
    striped streamed mode can invoke this as its own program per batch with
    the data device_put just-in-time.
    """
    cfg = plan.cfg
    alpha = jnp.asarray(plan.alpha, jnp.float32)
    (
        psi_c,
        probe_c,
        eigen_p2,
        eigen_w2,
        psi_acc,
        probe_acc,
        pos_num,
        pos_den,
        obj_v2,
        obj_m2,
        probe_v2,
        probe_m2,
        pcomb,
        pbeta_sum,
    ) = carry2
    if plan.solver == "lstsq":
        out = _lstsq_batch_math(
            cfg,
            data_n,
            scan,
            idx_n,
            mask_n,
            psi_c,
            probe_c,
            eigen_p2 if plan.has_eigen else None,
            eigen_w2 if plan.has_eigen else None,
            measured_pixels,
            psi_pre,
            step_length_start,
            step_length_weight,
            unmeasured_pixels_scaling,
            num_batch=float(nb),
            noise_model=plan.noise_model,
            steplength_usemodes=plan.steplength_usemodes,
            recover_psi=plan.recover_psi,
            recover_probe=plan.recover_probe,
            recover_positions=plan.recover_positions,
        )
        costs = out["costs"]
        if plan.recover_positions:
            pos_num = pos_num.at[idx_n].add(out["pos_num"])
            pos_den = pos_den.at[idx_n].add(out["pos_den"])
        beta_obj = jnp.asarray(0.0, jnp.float32)
        if plan.recover_psi:
            beta = out["beta_object"]
            if "beta_object_solo" in out:
                # On epochs where probe recovery is gated off, the
                # per-epoch path solves the uncoupled object step;
                # select the matching beta.
                beta = jnp.where(
                    recover_now, beta, out["beta_object_solo"]
                )
            beta_obj = beta.astype(jnp.float32)
            if plan.compact:
                psi_acc = psi_acc + out["object_upd_sum"]
            else:
                dpsi = _fz(beta * out["object_update_precond"])
                if plan.obj_moment == "momentum":
                    # Per-batch classical momentum
                    # (`lstsq.py:477-492` host path).
                    obj_m2 = (
                        plan.obj_mdecay * obj_m2
                        + (1 - plan.obj_mdecay) * dpsi
                    )
                    dpsi = obj_m2
                psi_c = psi_c + dpsi
        if plan.recover_probe:
            dprobe = out["beta_probe"] * out["m_probe_update"]
            probe_c = probe_c + gate * dprobe
            if plan.probe_moment == "checked":
                pcomb = pcomb + dprobe / nb
                pbeta_sum = pbeta_sum + jnp.mean(out["beta_probe"])
            if plan.has_eigen:
                # Gate the OPR updates with the probe-recovery
                # predicate (host control flow in the reference).
                if "eigen_probe" in out and out["eigen_probe"] is not None:
                    eigen_p2 = (
                        gate * out["eigen_probe"]
                        + (1 - gate) * eigen_p2
                    )
                old_w = jnp.take(eigen_w2, idx_n, axis=0)
                new_w = gate * out["w_b"] + (1 - gate) * old_w
                eigen_w2 = eigen_w2.at[idx_n].set(new_w)
    else:
        costs, psi_num, probe_num, eigen_delta = (
            _batch_gradients_math(
                cfg,
                data_n,
                scan,
                idx_n,
                mask_n,
                psi_c,
                probe_c,
                eigen_p2 if plan.has_eigen else None,
                eigen_w2 if plan.has_eigen else None,
                measured_pixels,
                step_length_start,
                step_length_weight,
                unmeasured_pixels_scaling,
                noise_model=plan.noise_model,
                steplength_usemodes=plan.steplength_usemodes,
                recover_probe=plan.recover_probe,
            )
        )
        beta_obj = jnp.asarray(0.0, jnp.float32)
        if plan.has_eigen and eigen_delta is not None:
            eigen_w2 = eigen_w2.at[idx_n, 0, 0].add(
                eigen_delta * gate
            )
        if plan.compact:
            psi_acc = psi_acc + psi_num
            probe_acc = probe_acc + probe_num
        else:
            if plan.recover_psi:
                deno = (1 - alpha) * psi_pre + alpha * jnp.abs(
                    psi_pre
                ).max(axis=(-2, -1), keepdims=True)
                psi_c = psi_c + _fz(psi_num / deno)
                if plan.obj_moment == "adam":
                    # Per-batch adam on the numerator
                    # (`rpie.py:386-414` host path).
                    d2, obj_v2, obj_m2 = tike_tpu.opt.adam(
                        psi_num,
                        obj_v2,
                        obj_m2,
                        vdecay=plan.obj_vdecay,
                        mdecay=plan.obj_mdecay,
                    )
                    psi_c = psi_c + _fz(d2 / deno)
            if plan.recover_probe:
                ppre = jnp.abs(probe_pre[0])
                pdeno = (1 - alpha) * ppre + alpha * ppre.max()
                probe_c = probe_c + gate * _fz(probe_num[0] / pdeno)
                if plan.probe_moment == "adam":
                    d2, pv2, pm2 = tike_tpu.opt.adam(
                        probe_num[0][0, 0, 0],
                        probe_v2,
                        probe_m2,
                        vdecay=plan.probe_vdecay,
                        mdecay=plan.probe_mdecay,
                    )
                    # Moment state only advances on probe-recovery
                    # epochs (host gating in `rpie._update`).
                    probe_v2 = jnp.where(recover_now, pv2, probe_v2)
                    probe_m2 = jnp.where(recover_now, pm2, probe_m2)
                    probe_c = probe_c.at[0, 0, 0].add(
                        gate * d2 / pdeno
                    )
    cost = jnp.sum(costs * mask_n) / jnp.maximum(
        jnp.sum(mask_n), 1
    )
    return (
        (
            psi_c,
            probe_c,
            eigen_p2,
            eigen_w2,
            psi_acc,
            probe_acc,
            pos_num,
            pos_den,
            obj_v2,
            obj_m2,
            probe_v2,
            probe_m2,
            pcomb,
            pbeta_sum,
        ),
        (cost, beta_obj),
    )

def _batch_sweep_init(plan: EpochPlan, psi, probe, scan):
    """Zeroed per-epoch accumulators threaded through the batch sweep."""
    psi_acc0 = jnp.zeros_like(psi)
    probe_acc0 = jnp.zeros((psi.shape[0], *probe.shape), probe.dtype)
    pos_acc0 = jnp.zeros_like(scan)
    # The probe_combined_update accumulator resets every epoch
    # (`lstsq.py:411-418` host path); the moment states persist.
    pcomb0 = (
        jnp.zeros_like(probe)
        if plan.solver == "lstsq" and plan.probe_moment == "checked"
        else jnp.zeros((), probe.real.dtype)
    )
    return psi_acc0, probe_acc0, pos_acc0, pcomb0


def _epoch_sweep_and_end(
    plan: EpochPlan,
    comm,
    batch_step,
    nb,
    psi,
    probe,
    eigen_p,
    eigen_w,
    scan,
    pos_v,
    pos_m,
    obj_v,
    obj_m,
    probe_v,
    probe_m,
    err_hist,
    psi_pre,
    probe_pre,
    batch_mask,
    row_mask,
    pos_mask,
    recover_now,
    gate,
    total_e,
    pwr,
):
    """lax.scan the mini-batch sweep, then apply the epoch end."""
    psi_acc0, probe_acc0, pos_acc0, pcomb0 = _batch_sweep_init(
        plan, psi, probe, scan
    )
    (
        (
            psi,
            probe,
            eigen_p,
            eigen_w,
            psi_acc,
            probe_acc,
            pos_num,
            pos_den,
            obj_v,
            obj_m,
            probe_v,
            probe_m,
            pcomb,
            pbeta_sum,
        ),
        (ns, costs, beta_objs),
    ) = jax.lax.scan(
        batch_step,
        (
            psi,
            probe,
            eigen_p,
            eigen_w,
            psi_acc0,
            probe_acc0,
            pos_acc0,
            pos_acc0,
            obj_v,
            obj_m,
            probe_v,
            probe_m,
            pcomb0,
            jnp.zeros((), jnp.float32),
        ),
        jnp.arange(nb),
    )
    costs_by_batch = jnp.zeros(nb, costs.dtype).at[ns].set(costs)
    return _epoch_end_math(
        plan,
        comm,
        psi,
        probe,
        eigen_p,
        eigen_w,
        scan,
        pos_v,
        pos_m,
        obj_v,
        obj_m,
        probe_v,
        probe_m,
        err_hist,
        psi_acc,
        probe_acc,
        pos_num,
        pos_den,
        pcomb,
        pbeta_sum,
        jnp.mean(beta_objs),
        psi_pre,
        probe_pre,
        batch_mask,
        row_mask,
        pos_mask,
        recover_now,
        gate,
        total_e,
        pwr,
        costs_by_batch,
    )


def _epoch_end_math(
    plan: EpochPlan,
    comm,
    psi,
    probe,
    eigen_p,
    eigen_w,
    scan,
    pos_v,
    pos_m,
    obj_v,
    obj_m,
    probe_v,
    probe_m,
    err_hist,
    psi_acc,
    probe_acc,
    pos_num,
    pos_den,
    pcomb,
    pbeta_sum,
    beta_obj_mean,
    psi_pre,
    probe_pre,
    batch_mask,
    row_mask,
    pos_mask,
    recover_now,
    gate,
    total_e,
    pwr,
    costs_by_batch,
):
    """Everything after the mini-batch sweep: epoch cost/history, the
    once-per-epoch position step, compact-mode application, adaptive
    moments, stripe reconciliation, eigen normalization, object
    constraints, periodic rescale. Diffraction-data-free, so the striped
    streamed mode runs it as its own end-of-epoch program."""
    cfg = plan.cfg
    nb = batch_mask.shape[0]
    alpha = jnp.asarray(plan.alpha, jnp.float32)
    # Epoch cost and its on-device history tail: the host path appends
    # the batch-mean cost to algorithm_options.costs before the
    # momentum-checked decision consults the last three entries.
    if comm is None:
        epoch_cost = jnp.mean(costs_by_batch)
    else:
        # Global weighted epoch cost so the momentum-checked decision is
        # identical on every stripe (the replicated-path semantics).
        bw = jnp.sum(batch_mask, axis=1)
        num = jax.lax.psum(jnp.sum(costs_by_batch * bw), comm.axis)
        den = jax.lax.psum(jnp.sum(bw), comm.axis)
        epoch_cost = num / jnp.maximum(den, 1.0)
    err_hist = jnp.roll(err_hist, shift=-1).at[-1].set(epoch_cost)
    n_done = total_e + 1
    # Position update once per epoch (`lstsq.py:764-806` semantics),
    # gated on the traced epoch predicate like the host control flow.
    if plan.recover_positions:
        pos_gate = total_e >= plan.pos_update_start
        palpha = 0.05
        step = pos_num / (
            (1 - palpha) * pos_den
            + palpha * jnp.maximum(pos_den.max(), 1e-6)
        )
        if plan.pos_update_magnitude_limit > 0:
            step = jnp.clip(
                step,
                -plan.pos_update_magnitude_limit,
                plan.pos_update_magnitude_limit,
            )
        if comm is None:
            step = step - _trim_mean(step, 0.05, axis=0)
        else:
            # Striped mode pads each stripe's positions to a common
            # capacity; the de-trend must ignore the padded slots (the
            # reference's per-GPU stripes are ragged, so its plain
            # trim_mean sees only real positions).
            step = step - _masked_trim_mean(step, pos_mask, 0.05)
            step = step * pos_mask[:, None]
        if plan.pos_use_adaptive_moment:
            step2, v2, m2 = tike_tpu.opt.adam(
                step,
                pos_v,
                pos_m,
                vdecay=plan.pos_vdecay,
                mdecay=plan.pos_mdecay,
            )
            pos_v = jnp.where(pos_gate, v2, pos_v)
            pos_m = jnp.where(pos_gate, m2, pos_m)
            step = step2
        scan = jnp.where(pos_gate, scan - step, scan)
        # Positions must stay inside the valid window (the local stripe
        # in striped mode, the full object otherwise): patch reads and
        # writes zero-weight past the bottom/right edge but are undefined
        # for negative corners, so a position that drifted out of bounds
        # would corrupt gradients without error. Replicated mode clamps
        # to exactly check_allowed_positions's valid region
        # (corner floor <= dim - P - 1, i.e. values < dim - P), so valid
        # near-edge positions are never moved. Striped mode needs
        # per-stripe row bounds: local rows map to global rows
        # local - halo + i*hs, and the FIRST stripe's upper halo and the
        # LAST stripe's lower halo are zero padding outside the object —
        # a position drifting there would be globally invalid (scan < 1
        # or scan >= H - P) even though it is inside the local window.
        # Interior halo rows are real neighbor rows and stay allowed up
        # to a 2-pixel local margin. Applied only when the update itself
        # is gated on (pos_gate), matching the host path, which does not
        # touch positions before update_start.
        if comm is None:
            lo0 = 1.0
            hi0 = cfg.nz - cfg.probe_shape - _POS_EDGE
            hi1 = cfg.n - cfg.probe_shape - _POS_EDGE
        else:
            off = (
                comm.halo
                - jax.lax.axis_index(comm.axis).astype(jnp.float32)
                * comm.hs
            )
            lo0 = jnp.maximum(1.0, 1.0 + off)
            hi0 = jnp.minimum(
                cfg.nz - cfg.probe_shape - 2.0,
                comm.height - cfg.probe_shape - _POS_EDGE + off,
            )
            hi1 = cfg.n - cfg.probe_shape - _POS_EDGE
        clamped = jnp.stack(
            [
                jnp.clip(scan[:, 0], lo0, hi0),
                jnp.clip(scan[:, 1], 1.0, hi1),
            ],
            axis=-1,
        )
        scan = jnp.where(pos_gate, clamped, scan)
    if plan.compact:
        if plan.solver == "lstsq":
            if plan.recover_psi:
                bobj = beta_obj_mean
                dpsi = _fz(
                    bobj * _precondition_object_update(psi_acc, psi_pre)
                )
                psi = psi + dpsi
                if plan.obj_moment == "checked":
                    # Epoch-end momentum_checked on the preconditioned
                    # step, weighted by the preconditioner magnitude
                    # (`lstsq.py:519-550` host path).
                    d2, obj_v, obj_m = (
                        tike_tpu.opt.momentum_checked_traced(
                            dpsi,
                            obj_v,
                            obj_m,
                            plan.obj_mdecay,
                            err_hist,
                            n_done,
                            beta=bobj,
                        )
                    )
                    W = jnp.abs(psi_pre)
                    psi = psi + _fz((W / (0.1 * W.max() + W)) * d2)
        else:
            if plan.recover_psi:
                deno = (1 - alpha) * psi_pre + alpha * jnp.abs(
                    psi_pre
                ).max(axis=(-2, -1), keepdims=True)
                psi = psi + _fz(psi_acc / deno)
                if plan.obj_moment == "checked":
                    # (`rpie.py:386-414` host path with errors.)
                    d2, obj_v, obj_m = (
                        tike_tpu.opt.momentum_checked_traced(
                            psi_acc,
                            obj_v,
                            obj_m,
                            plan.obj_mdecay,
                            err_hist,
                            n_done,
                        )
                    )
                    psi = psi + _fz(d2 / deno)
            if plan.recover_probe:
                ppre = jnp.abs(probe_pre[0])
                pdeno = (1 - alpha) * ppre + alpha * ppre.max()
                probe = probe + gate * _fz(probe_acc[0] / pdeno)
                if plan.probe_moment == "checked":
                    d2, pv2, pm2 = (
                        tike_tpu.opt.momentum_checked_traced(
                            probe_acc[0][0, 0, 0],
                            probe_v,
                            probe_m,
                            plan.probe_mdecay,
                            err_hist,
                            n_done,
                        )
                    )
                    probe_v = jnp.where(recover_now, pv2, probe_v)
                    probe_m = jnp.where(recover_now, pm2, probe_m)
                    probe = probe.at[0, 0, 0].add(gate * d2 / pdeno)

    if (
        plan.solver == "lstsq"
        and plan.recover_probe
        and plan.probe_moment == "checked"
    ):
        # Epoch-end momentum_checked on the mean probe update, main
        # mode only (`lstsq.py:552-584` host path; runs for compact and
        # non-compact alike).
        bprb = pbeta_sum / nb
        d2, pv2, pm2 = tike_tpu.opt.momentum_checked_traced(
            pcomb[..., 0, :, :],
            probe_v,
            probe_m,
            plan.probe_mdecay,
            err_hist,
            n_done,
            beta=bprb,
        )
        probe_v = jnp.where(recover_now, pv2, probe_v)
        probe_m = jnp.where(recover_now, pm2, probe_m)
        probe = probe.at[..., 0, :, :].add(gate * d2)

    if comm is not None:
        # End-of-epoch stripe reconciliation, in the reference's order
        # (`ptycho/ptycho.py:474-502`): weighted probe mean, weighted
        # eigen-probe mean, then the psi halo cross-fade. Empty stripes
        # carry zero weight.
        w = jnp.sum(pos_mask)
        den = jnp.maximum(jax.lax.psum(w, comm.axis), 1.0)

        def pmean(x):
            return jax.lax.psum(x * w, comm.axis) / den

        if plan.recover_probe:
            probe = pmean(probe)
            if plan.probe_moment != "none":
                # Moment states follow the probe so replicas stay in sync.
                probe_v = pmean(probe_v)
                probe_m = pmean(probe_m)
        if plan.has_eigen:
            eigen_p = pmean(eigen_p)

        # Halo cross-fade: both neighbors compute the identical linear
        # blend of the 2*halo seam rows, so the duplicated rows agree
        # (the reference's swap_edges ramps, `pool.py:415-476`).
        w2 = 2 * comm.halo
        i = jax.lax.axis_index(comm.axis)
        seam_bot = jax.lax.dynamic_slice_in_dim(psi, comm.hs, w2, axis=-2)
        seam_top = jax.lax.dynamic_slice_in_dim(psi, 0, w2, axis=-2)
        perm_up = [(j, (j - 1) % comm.ndev) for j in range(comm.ndev)]
        perm_dn = [(j, (j + 1) % comm.ndev) for j in range(comm.ndev)]
        from_below = jax.lax.ppermute(seam_top, comm.axis, perm_up)
        from_above = jax.lax.ppermute(seam_bot, comm.axis, perm_dn)
        ramp = jnp.linspace(0.0, 1.0, w2 + 2, dtype=jnp.float32)[1:-1][
            None, :, None
        ]
        blended_bot = (1 - ramp) * seam_bot + ramp * from_below
        blended_top = (1 - ramp) * from_above + ramp * seam_top
        new_bot = jnp.where(i < comm.ndev - 1, blended_bot, seam_bot)
        new_top = jnp.where(i > 0, blended_top, seam_top)
        psi = jax.lax.dynamic_update_slice_in_dim(
            psi, new_bot, comm.hs, axis=-2
        )
        psi = jax.lax.dynamic_update_slice_in_dim(psi, new_top, 0, axis=-2)

    if plan.has_eigen and plan.solver == "rpie":
        # Epsilon keeps all-zero weight columns at zero (see
        # rpie._normalize_eigen_weights).
        if comm is None:
            norm = tike_tpu.linalg.mnorm(eigen_w, axis=-3, keepdims=True)
        else:
            # Per-stripe normalization over REAL positions only (padded
            # capacity slots would deflate the RMS).
            msk = pos_mask[:, None, None]
            norm = jnp.sqrt(
                jnp.sum((eigen_w * eigen_w.conj()).real * msk, axis=-3, keepdims=True)
                / jnp.maximum(jnp.sum(pos_mask), 1.0)
            )
        eigen_w = eigen_w / (norm + 1e-32)

    # Object constraints (`ptycho.py:812-853`).
    if plan.recover_psi:
        if plan.positivity:
            psi = object_module.positivity_constraint(
                psi, r=plan.positivity
            )
        if plan.smoothness:
            psi = object_module.smoothness_constraint(
                psi, a=plan.smoothness
            )
        if plan.clip_magnitude:
            psi = object_module.clip_magnitude(psi, a_max=1.0)
        if plan.rescale_mean_abs:
            do_rescale = ((total_e + 1) % plan.rescale_period) == 0
            if comm is None:
                W = psi_pre.real
                W = W / tike_tpu.linalg.mnorm(W)
                object_norm = 2 * jnp.sqrt(
                    jnp.mean(jnp.square(jnp.abs(psi)) * W)
                )
            else:
                # Global statistics over the interior rows only (halo and
                # padding rows are duplicates/background), so every stripe
                # applies the same scale and the probe stays replicated.
                rm = row_mask[None, :, None]
                cnt = jnp.maximum(
                    jax.lax.psum(
                        jnp.sum(rm)
                        * psi_pre.shape[0]
                        * psi_pre.shape[-1],
                        comm.axis,
                    ),
                    1.0,
                )
                W = psi_pre.real * rm
                wrms = jnp.sqrt(
                    jax.lax.psum(jnp.sum(W * W), comm.axis) / cnt
                )
                Wn = W / jnp.maximum(wrms, 1e-32)
                object_norm = 2 * jnp.sqrt(
                    jax.lax.psum(
                        jnp.sum(jnp.square(jnp.abs(psi)) * Wn), comm.axis
                    )
                    / cnt
                )
            scale = jnp.where(do_rescale, object_norm, 1.0)
            psi = psi / scale
            probe = probe * scale

    return (
        (
            psi,
            probe,
            eigen_p,
            eigen_w,
            scan,
            pos_v,
            pos_m,
            obj_v,
            obj_m,
            probe_v,
            probe_m,
            err_hist,
        ),
        (costs_by_batch, pwr, epoch_cost),
    )


@jax.jit(static_argnames=("plan",))
def iterate_program(
    plan: EpochPlan,
    epoch0,        # () int32: number of epochs already completed
    data,          # (nb, L, DET, DET)
    scan,          # (N, 2)
    batch_idx,     # (nb, L) int32
    batch_mask,    # (nb, L) f32
    orders,        # (E, nb) int32 per-epoch batch orders
    psi,
    probe,
    eigen_probe,
    eigen_weights,
    measured_pixels,
    step_length_start,
    step_length_weight,
    unmeasured_pixels_scaling,
    pos_v=None,        # (N, 2) f32 position-adam second moment
    pos_m=None,        # (N, 2) f32 position-adam first moment
    obj_v=None,        # object moment 2nd state (shape per obj_moment)
    obj_m=None,        # object moment 1st state (psi-shaped)
    probe_v=None,      # probe moment 2nd state (shape per probe_moment)
    probe_m=None,      # probe moment 1st state
    err_hist=None,     # (3,) f32 tail of the epoch-cost series (oldest first)
):
    """Run ``plan.n_epochs`` full rPIE or LSQML epochs in one XLA program.

    Returns (psi, probe, eigen_probe, eigen_weights, scan, pos_v, pos_m,
    obj_v, obj_m, probe_v, probe_m, costs (E, nb), powers (E, modes)).
    """
    def epoch_body(carry, e):
        return _epoch_math(
            plan,
            None,
            epoch0,
            data,
            batch_idx,
            batch_mask,
            orders,
            measured_pixels,
            step_length_start,
            step_length_weight,
            unmeasured_pixels_scaling,
            None,
            None,
            carry,
            e,
        )

    if eigen_probe is None:
        eigen_probe = jnp.zeros((), jnp.float32)
    if eigen_weights is None:
        eigen_weights = jnp.zeros((), jnp.float32)
    if pos_v is None:
        pos_v = jnp.zeros_like(scan) if plan.recover_positions else jnp.zeros((), jnp.float32)
    if pos_m is None:
        pos_m = jnp.zeros_like(scan) if plan.recover_positions else jnp.zeros((), jnp.float32)
    if obj_v is None:
        obj_v = jnp.zeros((), jnp.float32)
    if obj_m is None:
        obj_m = jnp.zeros((), jnp.float32)
    if probe_v is None:
        probe_v = jnp.zeros((), jnp.float32)
    if probe_m is None:
        probe_m = jnp.zeros((), jnp.float32)
    if err_hist is None:
        err_hist = jnp.full((3,), jnp.inf, jnp.float32)
    (
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
            err_hist,
        ),
        (all_costs, all_powers, _),
    ) = jax.lax.scan(
        epoch_body,
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
            err_hist,
        ),
        jnp.arange(plan.n_epochs),
    )
    return (
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
        all_costs,
        all_powers,
    )

"""Row-striped (spatial/model-parallel) ptychographic reconstruction.

JAX equivalent of the reference's object decomposition, where each
GPU reconstructs a row stripe of psi covering its own scan positions plus a
probe-width overlap, neighbors reconcile the overlap with a linear
cross-fade each epoch, and the stripes are stitched at the end
(`ptycho/ptycho.py:371-396,491-502`, `pool.py:415-476`, `object.py:154-167`
in `upstream/src/tike`).

Design: ONE `shard_map` over the device mesh running the SAME fused epoch
math as the replicated path (`tike_tpu.ptycho.solvers.fused._epoch_math`)
with a `StripeComm` that inserts the cross-stripe collectives — weighted
probe/eigen psum-means, pooled probe preconditioner, global epoch cost for
the momentum decisions, and the psi halo cross-fade. Because the epoch math
is shared, the striped path supports the full solver feature set: eigen
(OPR) probes, position correction, adaptive moments, probe constraints and
the update schedule, object constraints, and periodic rescaling — exactly
like the reference runs the complete solver on every GPU stripe
(`upstream/src/tike/ptycho/ptycho.py:463-525`).

Every device owns

- a local psi window of R = Hs + 2*halo rows (stripe height Hs = ceil(H/n),
  halo >= probe_width + 1 plus a position-drift margin),
- its stripe's diffraction patterns in batch-major layout, scan positions
  rebased to local rows, per-stripe mini-batch clusters (the reference
  clusters batches *within* each stripe, `cluster.py:238-242`), and local
  eigen weights / position states.

The replicated path remains the default when psi fits in HBM; this module
is the scaling path for objects larger than per-chip HBM, reachable via
``Reconstruction(..., object_sharding="striped")``.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import typing

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tike_tpu.ops.ptycho import PtychoConfig
from tike_tpu.ptycho.solvers.fused import (
    EpochPlan,
    StripeComm,
    _batch_sweep_init,
    _batch_update_math,
    _epoch_begin_math,
    _epoch_end_math,
    _epoch_math,
)

from . import BATCH_AXIS

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class StripePlan:
    """Host-side geometry of a row-striped decomposition."""

    ndev: int
    stripe_height: int  # Hs: interior rows per stripe
    halo: int  # overlap rows shared with each neighbor
    local_height: int  # R = Hs + 2*halo
    width: int
    assignment: np.ndarray  # (N,) stripe index of each scan position
    counts: np.ndarray  # (ndev,) positions per stripe
    capacity: int  # padded per-stripe position count


def plan_stripes(
    scan: np.ndarray,
    object_shape: typing.Tuple[int, int],
    probe_width: int,
    ndev: int,
    position_margin: int = 8,
) -> StripePlan:
    """Assign scan positions to row stripes (`cluster.py:176-262` analog).

    ``position_margin`` extends the halo beyond the probe footprint so that
    fractional offsets and (bounded) position-correction drift never read
    or write outside the local window.
    """
    h, w = object_shape
    hs = -(-h // ndev)
    halo = probe_width + 1 + max(int(position_margin), 1)
    assignment = np.clip(
        (np.floor(scan[:, 0]).astype(np.int64)) // hs, 0, ndev - 1
    )
    counts = np.bincount(assignment, minlength=ndev)
    capacity = int(counts.max())
    return StripePlan(
        ndev=ndev,
        stripe_height=hs,
        halo=halo,
        local_height=hs + 2 * halo,
        width=w,
        assignment=assignment,
        counts=counts,
        capacity=capacity,
    )


def stitch(plan: StripePlan, psi_s: np.ndarray, h: int) -> np.ndarray:
    """Crop each stripe's interior rows and concatenate (`join_psi`)."""
    parts = [
        psi_s[k][:, plan.halo : plan.halo + plan.stripe_height]
        for k in range(plan.ndev)
    ]
    return np.concatenate(parts, axis=-2)[:, :h]


def estimate_probe_rescale(
    data: np.ndarray,
    psi: np.ndarray,
    probe: np.ndarray,
    scan: np.ndarray,
    sample: int = 256,
    rng: typing.Optional[np.random.Generator] = None,
) -> float:
    """Host-side probe power rescale factor (`ptycho/ptycho.py:873-972`).

    By Parseval (ortho-norm FFT), the modeled far-field energy of a
    position equals sum_px |patch|^2 * sum_modes |probe|^2, so the rescale
    sqrt(sum data / sum model) is computed from bilinear patches alone --
    no forward FFT and no device-resident full object, which matters in
    striped mode where psi never materializes on one device.
    """
    rng = np.random.default_rng(0) if rng is None else rng
    sel = _rescale_sample(scan.shape[0], sample, rng)
    model = _sampled_model_power(psi, probe, scan, sel)
    measured = float(np.sum(data[sel]))
    return float(np.sqrt(measured / (model + 1e-32)))


def local_row_lookup(n: int, local_indices: np.ndarray) -> np.ndarray:
    """(n,) map from global position index to this process's data row.

    Encodes the per-process data-row contract (``striped_local_indices``):
    entry i is the row of the local block holding global position i, or -1
    when this process does not own it.
    """
    lookup = np.full(n, -1, np.int64)
    lookup[np.asarray(local_indices)] = np.arange(len(local_indices))
    return lookup


def _rescale_sample(
    n: int, sample: int, rng: np.random.Generator
) -> np.ndarray:
    return (
        np.arange(n)
        if n <= sample
        else rng.choice(n, size=sample, replace=False)
    )


def _sampled_model_power(
    psi: np.ndarray,
    probe: np.ndarray,
    scan: np.ndarray,
    sel: np.ndarray,
) -> float:
    p = probe.shape[-1]
    probe_power = np.sum(np.abs(probe[0, 0]) ** 2, axis=0)  # (P, P)
    corner = np.floor(scan[sel]).astype(np.int64)
    frac = scan[sel] - corner
    model = 0.0
    for c, f in zip(corner, frac):
        win = psi[0, c[0] : c[0] + p + 1, c[1] : c[1] + p + 1]
        fy, fx = f
        patch = (
            (1 - fy) * (1 - fx) * win[:-1, :-1]
            + (1 - fy) * fx * win[:-1, 1:]
            + fy * (1 - fx) * win[1:, :-1]
            + fy * fx * win[1:, 1:]
        )
        model += float(np.sum(np.abs(patch) ** 2 * probe_power))
    return model


def estimate_probe_rescale_multihost(
    data_local: np.ndarray,
    local_indices: np.ndarray,
    psi: np.ndarray,
    probe: np.ndarray,
    scan: np.ndarray,
    sample: int = 256,
    rng: typing.Optional[np.random.Generator] = None,
) -> float:
    """Multi-process :func:`estimate_probe_rescale` over per-process data.

    Every process passes the SAME psi/probe/scan (and an identically-seeded
    ``rng``, so the sample agrees) plus its own data block whose rows are
    ``scan[local_indices]`` (the :func:`striped_local_indices` contract).
    The model term is computed redundantly from the shared arrays; the
    measured term sums each process's sampled rows via ``process_allgather``
    (the reference rescales from the full dataset before the MPI split,
    `ptycho/ptycho.py:873-972`).
    """
    rng = np.random.default_rng(0) if rng is None else rng
    sel = _rescale_sample(scan.shape[0], sample, rng)
    model = _sampled_model_power(psi, probe, scan, sel)
    rows = local_row_lookup(scan.shape[0], local_indices)[sel]
    measured_local = np.float64(np.sum(data_local[rows[rows >= 0]]))
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        measured = float(
            np.sum(multihost_utils.process_allgather(measured_local))
        )
    else:
        measured = float(measured_local)
    return float(np.sqrt(measured / (model + 1e-32)))


@dataclasses.dataclass
class StripedState:
    """Device-resident state of a striped reconstruction in progress."""

    plan: StripePlan
    epoch_plan: EpochPlan  # static config of one epoch (n_epochs ignored)
    comm: StripeComm
    mesh: Mesh
    height: int  # global object rows (for stitching)
    order: typing.List[np.ndarray]  # per-stripe global indices, batch order
    # --- device-resident, stripe-major (leading axis = device) ---
    psi: jax.Array  # (ndev, D, R, W)
    data: typing.Any  # (ndev, nb, L, DET, DET), or None when streaming
    scan: jax.Array  # (ndev, cap, 2) local-row coordinates
    batch_idx: jax.Array  # (ndev, nb, L)
    batch_mask: jax.Array  # (ndev, nb, L)
    row_mask: jax.Array  # (ndev, R)
    pos_mask: jax.Array  # (ndev, cap)
    eigen_w: typing.Any  # (ndev, cap, C, M) or None
    pos_v: typing.Any
    pos_m: typing.Any
    obj_v: typing.Any
    obj_m: typing.Any
    # --- replicated ---
    probe: typing.Any
    eigen_p: typing.Any
    probe_v: typing.Any
    probe_m: typing.Any
    err_hist: typing.Any
    measured_pixels: typing.Any
    step_length_start: float
    step_length_weight: float
    unmeasured_pixels_scaling: float
    epochs_done: int = 0
    last_powers: typing.Any = None  # (E, modes) per-epoch probe mode power
    # Host-streaming mode (>HBM data): the caller's per-process data array
    # stays in host RAM (`data` is None); data_rows (n_own, nb, L) maps
    # each batch slot to its row (-1 = padding) and batches are gathered
    # and device_put double-buffered into the per-batch program.
    data_host: typing.Any = None
    data_rows: typing.Any = None
    _programs: dict = dataclasses.field(default_factory=dict)
    _rng: np.random.Generator = dataclasses.field(
        default_factory=lambda: np.random.default_rng(0)
    )

    # -- helpers ----------------------------------------------------------
    def _nb(self) -> int:
        return int(self.batch_idx.shape[1])

    def _program(self, n_epochs: int):
        key = n_epochs
        if key in self._programs:
            return self._programs[key]
        plan = dataclasses.replace(self.epoch_plan, n_epochs=n_epochs)
        comm = self.comm
        mesh = self.mesh
        dev = P(BATCH_AXIS)
        rep = P()

        has_eigen = plan.has_eigen
        has_pos = plan.recover_positions
        # psi-shaped moment states live with the stripe; classical
        # 'momentum' only allocates obj_m (obj_v stays a rank-0 scalar
        # and must keep a replicated spec or shard_map rejects it).
        om_dev = plan.obj_moment != "none"
        ov_dev = plan.obj_moment in ("adam", "checked")
        probe_mom = plan.probe_moment != "none"

        def run(
            epoch0,
            data,
            scan,
            batch_idx,
            batch_mask,
            orders,
            psi,
            probe,
            eigen_p,
            eigen_w,
            measured,
            row_mask,
            pos_mask,
            pos_v,
            pos_m,
            obj_v,
            obj_m,
            probe_v,
            probe_m,
            err_hist,
            sls,
            slw,
            ups,
        ):
            # shard_map keeps a leading length-1 device axis on
            # stripe-major blocks; strip it for the epoch math.
            local = lambda x: x[0]
            psi_l = local(psi)
            scan_l = local(scan)
            ew_l = local(eigen_w) if has_eigen else None
            pv_l = local(pos_v) if has_pos else pos_v
            pm_l = local(pos_m) if has_pos else pos_m
            ov_l = local(obj_v) if ov_dev else obj_v
            om_l = local(obj_m) if om_dev else obj_m

            def epoch_body(carry, e):
                return _epoch_math(
                    plan,
                    comm,
                    epoch0,
                    local(data),
                    local(batch_idx),
                    local(batch_mask),
                    orders,
                    measured,
                    sls,
                    slw,
                    ups,
                    local(row_mask),
                    local(pos_mask),
                    carry,
                    e,
                )

            carry0 = (
                psi_l,
                probe,
                eigen_p if has_eigen else jnp.zeros((), jnp.float32),
                ew_l if has_eigen else jnp.zeros((), jnp.float32),
                scan_l,
                pv_l,
                pm_l,
                ov_l,
                om_l,
                probe_v,
                probe_m,
                err_hist,
            )
            (
                (
                    psi_l,
                    probe,
                    eigen_p2,
                    ew_l,
                    scan_l,
                    pv_l,
                    pm_l,
                    ov_l,
                    om_l,
                    probe_v,
                    probe_m,
                    err_hist,
                ),
                (costs, pwr, ecosts),
            ) = jax.lax.scan(epoch_body, carry0, jnp.arange(n_epochs))
            return (
                psi_l[None],
                probe,
                eigen_p2 if has_eigen else eigen_p,
                ew_l[None] if has_eigen else eigen_w,
                scan_l[None],
                pv_l[None] if has_pos else pos_v,
                pm_l[None] if has_pos else pos_m,
                ov_l[None] if ov_dev else obj_v,
                om_l[None] if om_dev else obj_m,
                probe_v,
                probe_m,
                err_hist,
                ecosts,  # (E,) globally-weighted epoch costs, replicated
                pwr,
            )

        in_specs = (
            rep,  # epoch0
            dev,  # data
            dev,  # scan
            dev,  # batch_idx
            dev,  # batch_mask
            rep,  # orders
            dev,  # psi
            rep,  # probe
            rep,  # eigen_p
            dev if has_eigen else rep,  # eigen_w
            rep,  # measured
            dev,  # row_mask
            dev,  # pos_mask
            dev if has_pos else rep,  # pos_v
            dev if has_pos else rep,  # pos_m
            dev if ov_dev else rep,  # obj_v
            dev if om_dev else rep,  # obj_m
            rep,  # probe_v
            rep,  # probe_m
            rep,  # err_hist
            rep,  # sls
            rep,  # slw
            rep,  # ups
        )
        out_specs = (
            dev,  # psi
            rep,  # probe
            rep,  # eigen_p
            dev if has_eigen else rep,  # eigen_w
            dev,  # scan
            dev if has_pos else rep,  # pos_v
            dev if has_pos else rep,  # pos_m
            dev if ov_dev else rep,  # obj_v
            dev if om_dev else rep,  # obj_m
            rep,  # probe_v
            rep,  # probe_m
            rep,  # err_hist
            rep,  # epoch costs (globally weighted, identical everywhere)
            rep,  # pwr
        )
        # check_vma=False: the patch-op scans initialize accumulators with
        # unvarying zeros, which the varying-manual-axes analysis rejects
        # even though the computation is correct per device.
        program = jax.jit(
            jax.shard_map(
                run,
                mesh=mesh,
                in_specs=in_specs,
                out_specs=out_specs,
                check_vma=False,
            )
        )
        self._programs[key] = program
        return program

    def _streamed_programs(self):
        """(begin, batch, end) programs for host-streamed epochs.

        The fused whole-epoch program requires the diffraction data
        resident in HBM; these three programs run the SAME epoch math
        (`fused._epoch_begin_math` / `_batch_update_math` /
        `_epoch_end_math`) with the data fed one batch at a time from the
        host — the >HBM-data counterpart of the replicated path's
        double-buffered streaming (`solvers/rpie.py:620-640`). Mid-epoch
        state is per-stripe (leading device axis); the end program's
        reconciliation (probe psum-mean, halo cross-fade) restores the
        fused path's epoch-boundary layout, so streamed and fused epochs
        are interchangeable.
        """
        key = "streamed"
        if key in self._programs:
            return self._programs[key]
        plan = dataclasses.replace(self.epoch_plan, n_epochs=1)
        comm = self.comm
        mesh = self.mesh
        dev = P(BATCH_AXIS)
        rep = P()
        has_eigen = plan.has_eigen
        has_pos = plan.recover_positions
        om_dev = plan.obj_moment != "none"
        ov_dev = plan.obj_moment in ("adam", "checked")
        probe_mom = plan.probe_moment != "none"
        nb = self._nb()
        local = lambda x: x[0]

        def predicates(epoch_idx):
            recover_now = jnp.logical_and(
                epoch_idx >= plan.update_start,
                (epoch_idx % plan.update_period) == 0,
            )
            return recover_now, recover_now.astype(jnp.float32)

        def run_begin(
            epoch_idx, psi, probe, scan, batch_idx, batch_mask,
            eigen_p, probe_v, probe_m,
        ):
            recover_now, _ = predicates(epoch_idx)
            psi_l = local(psi)
            scan_l = local(scan)
            probe2, pwr, psi_pre, probe_pre = _epoch_begin_math(
                plan, comm, psi_l, probe, scan_l,
                local(batch_idx), local(batch_mask), recover_now,
                epoch_idx,
            )
            psi_acc0, probe_acc0, pos_acc0, pcomb0 = _batch_sweep_init(
                plan, psi_l, probe2, scan_l
            )
            return (
                probe2[None],
                pwr,
                psi_pre[None],
                probe_pre,
                psi_acc0[None],
                probe_acc0[None],
                pos_acc0[None],
                pos_acc0[None],
                pcomb0[None],
                jnp.zeros((1,), jnp.float32),  # pbeta_sum
                jnp.zeros((1, nb), jnp.float32),  # costs_by_batch
                jnp.zeros((1,), jnp.float32),  # beta_obj sum
                eigen_p[None] if has_eigen else eigen_p,
                probe_v[None] if probe_mom else probe_v,
                probe_m[None] if probe_mom else probe_m,
            )

        begin = jax.jit(
            jax.shard_map(
                run_begin,
                mesh=mesh,
                in_specs=(rep, dev, rep, dev, dev, dev, rep, rep, rep),
                out_specs=(
                    dev, rep, dev, rep, dev, dev, dev, dev, dev, dev,
                    dev, dev,
                    dev if has_eigen else rep,
                    dev if probe_mom else rep,
                    dev if probe_mom else rep,
                ),
                check_vma=False,
            )
        )

        carry_specs = (
            dev,  # psi
            dev,  # probe (per-stripe mid-epoch)
            dev if has_eigen else rep,  # eigen_p
            dev if has_eigen else rep,  # eigen_w
            dev,  # psi_acc
            dev,  # probe_acc
            dev,  # pos_num
            dev,  # pos_den
            dev if ov_dev else rep,  # obj_v
            dev if om_dev else rep,  # obj_m
            dev if probe_mom else rep,  # probe_v
            dev if probe_mom else rep,  # probe_m
            dev,  # pcomb
            dev,  # pbeta_sum
            dev,  # costs_by_batch
            dev,  # beta_obj sum
        )

        def _carry_local(carry):
            (
                psi, probe, eigen_p, eigen_w, psi_acc, probe_acc,
                pos_num, pos_den, obj_v, obj_m, probe_v, probe_m,
                pcomb, pbeta_sum,
            ) = carry
            return (
                local(psi),
                local(probe),
                local(eigen_p) if has_eigen else eigen_p,
                local(eigen_w) if has_eigen else eigen_w,
                local(psi_acc),
                local(probe_acc),
                local(pos_num),
                local(pos_den),
                local(obj_v) if ov_dev else obj_v,
                local(obj_m) if om_dev else obj_m,
                local(probe_v) if probe_mom else probe_v,
                local(probe_m) if probe_mom else probe_m,
                local(pcomb),
                local(pbeta_sum),
            )

        def _carry_global(carry):
            (
                psi, probe, eigen_p, eigen_w, psi_acc, probe_acc,
                pos_num, pos_den, obj_v, obj_m, probe_v, probe_m,
                pcomb, pbeta_sum,
            ) = carry
            return (
                psi[None],
                probe[None],
                eigen_p[None] if has_eigen else eigen_p,
                eigen_w[None] if has_eigen else eigen_w,
                psi_acc[None],
                probe_acc[None],
                pos_num[None],
                pos_den[None],
                obj_v[None] if ov_dev else obj_v,
                obj_m[None] if om_dev else obj_m,
                probe_v[None] if probe_mom else probe_v,
                probe_m[None] if probe_mom else probe_m,
                pcomb[None],
                pbeta_sum[None],
            )

        def run_batch(
            n, epoch_idx, data_b, scan, batch_idx, batch_mask,
            measured, sls, slw, ups, psi_pre, probe_pre,
            *carry_ext,
        ):
            recover_now, gate = predicates(epoch_idx)
            carry2 = _carry_local(carry_ext[:14])
            costs_b, beta_sum = carry_ext[14], carry_ext[15]
            new_carry, (cost, beta_obj) = _batch_update_math(
                plan,
                local(data_b),
                local(scan),
                local(batch_idx)[n],
                local(batch_mask)[n],
                local(psi_pre),
                probe_pre,
                measured,
                sls,
                slw,
                ups,
                gate,
                recover_now,
                nb,
                carry2,
            )
            return _carry_global(new_carry) + (
                local(costs_b).at[n].set(cost)[None],
                (local(beta_sum) + beta_obj)[None],
            )

        batch = jax.jit(
            jax.shard_map(
                run_batch,
                mesh=mesh,
                in_specs=(
                    rep,  # n
                    rep,  # epoch_idx
                    dev,  # data_b
                    dev,  # scan
                    dev,  # batch_idx
                    dev,  # batch_mask
                    rep,  # measured
                    rep,  # sls
                    rep,  # slw
                    rep,  # ups
                    dev,  # psi_pre
                    rep,  # probe_pre
                )
                + carry_specs,
                out_specs=carry_specs,
                check_vma=False,
            )
        )

        def run_end(
            epoch_idx, scan, batch_mask, row_mask, pos_mask, err_hist,
            pwr, psi_pre, probe_pre, pos_v, pos_m, *carry_ext,
        ):
            recover_now, gate = predicates(epoch_idx)
            (
                psi, probe, eigen_p, eigen_w, psi_acc, probe_acc,
                pos_num, pos_den, obj_v, obj_m, probe_v, probe_m,
                pcomb, pbeta_sum,
            ) = _carry_local(carry_ext[:14])
            costs_b, beta_sum = carry_ext[14], carry_ext[15]
            (
                (
                    psi, probe, eigen_p, eigen_w, scan_l, pos_v2, pos_m2,
                    obj_v, obj_m, probe_v, probe_m, err_hist,
                ),
                (costs_by_batch, pwr_out, epoch_cost),
            ) = _epoch_end_math(
                plan,
                comm,
                psi,
                probe,
                eigen_p,
                eigen_w,
                local(scan),
                local(pos_v) if has_pos else pos_v,
                local(pos_m) if has_pos else pos_m,
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
                local(beta_sum) / nb,
                local(psi_pre),
                probe_pre,
                local(batch_mask),
                local(row_mask),
                local(pos_mask),
                recover_now,
                gate,
                epoch_idx,
                pwr,
                local(costs_b),
            )
            return (
                psi[None],
                probe,
                eigen_p,
                eigen_w[None] if has_eigen else eigen_w,
                scan_l[None],
                pos_v2[None] if has_pos else pos_v2,
                pos_m2[None] if has_pos else pos_m2,
                obj_v[None] if ov_dev else obj_v,
                obj_m[None] if om_dev else obj_m,
                probe_v,
                probe_m,
                err_hist,
                epoch_cost,
                pwr_out,
            )

        end = jax.jit(
            jax.shard_map(
                run_end,
                mesh=mesh,
                in_specs=(
                    rep,  # epoch_idx
                    dev,  # scan
                    dev,  # batch_mask
                    dev,  # row_mask
                    dev,  # pos_mask
                    rep,  # err_hist
                    rep,  # pwr
                    dev,  # psi_pre
                    rep,  # probe_pre
                    dev if has_pos else rep,  # pos_v
                    dev if has_pos else rep,  # pos_m
                )
                + carry_specs,
                out_specs=(
                    dev,  # psi
                    rep,  # probe (psum-mean reconciled)
                    rep,  # eigen_p
                    dev if has_eigen else rep,  # eigen_w
                    dev,  # scan
                    dev if has_pos else rep,  # pos_v
                    dev if has_pos else rep,  # pos_m
                    dev if ov_dev else rep,  # obj_v
                    dev if om_dev else rep,  # obj_m
                    rep,  # probe_v
                    rep,  # probe_m
                    rep,  # err_hist
                    rep,  # epoch cost (globally weighted)
                    rep,  # pwr
                ),
                check_vma=False,
            )
        )
        def make_chunk(K: int):
            """Program applying K consecutive mini-batches per dispatch.

            Scanning K batches inside one shard_map program amortizes the
            per-call dispatch K-fold. The scan body is the SAME
            `_batch_update_math` as the single-batch program, so results
            are bitwise-identical for any chunking of the epoch's batch
            order.
            """
            ckey = ("streamed_chunk", K)
            if ckey in self._programs:
                return self._programs[ckey]

            def run_chunk(
                ns, epoch_idx, data_c, scan, batch_idx, batch_mask,
                measured, sls, slw, ups, psi_pre, probe_pre,
                *carry_ext,
            ):
                recover_now, gate = predicates(epoch_idx)
                carry2 = _carry_local(carry_ext[:14])
                costs_b = local(carry_ext[14])
                beta_sum = local(carry_ext[15])

                def step(c, inp):
                    cin, costs_in, beta_in = c
                    n, data_b = inp
                    new_carry, (cost, beta_obj) = _batch_update_math(
                        plan,
                        data_b,
                        local(scan),
                        local(batch_idx)[n],
                        local(batch_mask)[n],
                        local(psi_pre),
                        probe_pre,
                        measured,
                        sls,
                        slw,
                        ups,
                        gate,
                        recover_now,
                        nb,
                        cin,
                    )
                    return (
                        new_carry,
                        costs_in.at[n].set(cost),
                        # beta_obj is (1,) for lstsq, scalar for rpie;
                        # keep the carry rank-0 either way.
                        beta_in + jnp.reshape(beta_obj, ()),
                    ), None

                (carry2, costs_b, beta_sum), _ = jax.lax.scan(
                    step, (carry2, costs_b, beta_sum), (ns, local(data_c))
                )
                return _carry_global(carry2) + (
                    costs_b[None],
                    beta_sum[None],
                )

            program = jax.jit(
                jax.shard_map(
                    run_chunk,
                    mesh=mesh,
                    in_specs=(
                        rep,  # ns (K,)
                        rep,  # epoch_idx
                        dev,  # data_c (ndev, K, L, DET, DET)
                        dev,  # scan
                        dev,  # batch_idx
                        dev,  # batch_mask
                        rep,  # measured
                        rep,  # sls
                        rep,  # slw
                        rep,  # ups
                        dev,  # psi_pre
                        rep,  # probe_pre
                    )
                    + carry_specs,
                    out_specs=carry_specs,
                    check_vma=False,
                )
            )
            self._programs[ckey] = program
            return program

        self._programs[key] = (begin, batch, end, make_chunk)
        return self._programs[key]


def _own_stripe_rows(mesh: Mesh) -> np.ndarray:
    """Stripe indices (mesh axis-0 positions) owned by this process.

    Shard k of a P(BATCH_AXIS)-sharded stripe-major array lives on
    ``mesh.devices.flat[k]``; in a multi-process run each process
    contributes the rows of its own devices (ascending order, as
    `jax.make_array_from_process_local_data` expects).
    """
    import jax

    pidx = jax.process_index()
    return np.array(
        [
            k
            for k, d in enumerate(mesh.devices.flat)
            if d.process_index == pidx
        ],
        dtype=np.int64,
    )


def striped_local_indices(
    scan: np.ndarray,
    object_shape: typing.Tuple[int, int],
    probe_width: int,
    mesh: Mesh,
    position_margin: int = 8,
) -> np.ndarray:
    """Global scan indices whose stripes this process owns (ascending).

    The multi-host data contract (the reference's `MPIio_ptycho` analog,
    `mpi.py:61-92`): each process loads ``data[striped_local_indices(...)]``
    and passes that block to the striped driver.
    """
    plan = plan_stripes(
        np.asarray(scan),
        object_shape,
        probe_width,
        mesh.size,
        position_margin=position_margin,
    )
    own = _own_stripe_rows(mesh)
    return np.flatnonzero(np.isin(plan.assignment, own))


def setup_striped_full(
    data: np.ndarray,
    psi: np.ndarray,
    probe: np.ndarray,
    scan: np.ndarray,
    *,
    mesh: Mesh,
    epoch_plan: EpochPlan,
    batch_method: str = "compact",
    num_batch: int = 1,
    eigen_probe: typing.Optional[np.ndarray] = None,
    eigen_weights: typing.Optional[np.ndarray] = None,
    measured_pixels: typing.Optional[np.ndarray] = None,
    step_length_start: float = 0.5,
    step_length_weight: float = 0.5,
    unmeasured_pixels_scaling: float = 1.0,
    position_margin: int = 8,
    pos_momentum: typing.Optional[np.ndarray] = None,
    prev_costs: typing.Sequence[float] = (),
    rng: typing.Optional[np.random.Generator] = None,
    epochs_done: int = 0,
    store_data_on_device: bool = True,
) -> StripedState:
    """Shard the full solver state into row stripes.

    ``epoch_plan`` carries the complete solver configuration (solver,
    constraints, schedule, moments) — the same EpochPlan the replicated
    fused path uses, except cfg.nz must equal the local window height
    (set here). Mini-batches are clustered *within* each stripe with
    ``batch_method`` (the reference's per-stripe clustering,
    `cluster.py:238-242`).
    """
    import jax as _jax
    import tike_tpu.cluster as cluster

    rng = np.random.default_rng(0) if rng is None else rng
    ndev = mesh.size
    data = np.asarray(data)
    psi = np.asarray(psi)
    scan = np.asarray(scan)
    d, h, w = psi.shape
    p = probe.shape[-1]
    det = data.shape[-1]
    plan = plan_stripes(
        scan, (h, w), p, ndev, position_margin=position_margin
    )
    num_batch = max(1, int(num_batch))
    # Multi-process: this process assembles only its own devices' stripe
    # blocks; the plan/batching above is computed identically on every
    # process (pass a seeded rng so clustering layouts agree). Data may be
    # the full array or this process's `striped_local_indices` block.
    multi = _jax.process_count() > 1 and all(
        d_.process_index is not None for d_ in mesh.devices.flat
    )
    own = _own_stripe_rows(mesh) if multi else np.arange(ndev)
    own_set = set(int(k) for k in own)
    data_lookup = None
    if multi and data.shape[0] != scan.shape[0]:
        local_idx = np.flatnonzero(np.isin(plan.assignment, own))
        if data.shape[0] != len(local_idx):
            raise ValueError(
                f"data has {data.shape[0]} patterns but this process's "
                f"stripes cover {len(local_idx)} (or pass the full "
                f"{scan.shape[0]})"
            )
        data_lookup = local_row_lookup(scan.shape[0], local_idx)

    # --- per-stripe mini-batch clustering --------------------------------
    method = cluster.BATCH_METHODS[batch_method]
    import inspect

    takes_rng = "rng" in inspect.signature(method).parameters
    order: typing.List[np.ndarray] = []
    all_idx: typing.List[np.ndarray] = []
    all_mask: typing.List[np.ndarray] = []
    L = 1
    per_stripe = []
    for k in range(ndev):
        sel = np.flatnonzero(plan.assignment == k)
        if len(sel):
            if takes_rng:
                local_batches = method(scan[sel], num_batch, rng=rng)
            else:
                local_batches = method(scan[sel], num_batch)
        else:
            local_batches = [np.zeros(0, np.int64) for _ in range(num_batch)]
        # Reorder the stripe's positions batch-contiguously (like
        # by_scan_stripes_contiguous) so batch_idx rows are ranges.
        contiguous = (
            sel[np.concatenate(local_batches)] if len(sel) else sel
        )
        order.append(contiguous)
        sizes = [len(b) for b in local_batches]
        breaks = np.cumsum(sizes)[:-1]
        local_ranges = np.array_split(np.arange(len(contiguous)), breaks)
        idx_k, mask_k = cluster.batches_padded(local_ranges)
        per_stripe.append((idx_k, mask_k))
        L = max(L, idx_k.shape[1])
    nb = num_batch
    cap = max(1, max(len(o) for o in order))

    # --- assemble stripe-major arrays (this process's rows only) ---------
    n_own = len(own)
    # Streaming mode keeps the caller's array as the single host copy and
    # gathers one batch at a time through data_rows (materializing a
    # second full-size batch-major copy would double peak host RAM for
    # exactly the >HBM datasets the mode exists for).
    data_s = (
        np.zeros((n_own, nb, L, det, det), np.float32)
        if store_data_on_device
        else None
    )
    data_rows = np.full((n_own, nb, L), -1, np.int64)
    scan_s = np.zeros((n_own, cap, 2), np.float32)
    pos_mask = np.zeros((n_own, cap), np.float32)
    bidx_s = np.zeros((n_own, nb, L), np.int32)
    bmask_s = np.zeros((n_own, nb, L), np.float32)
    row_mask = np.zeros((n_own, plan.local_height), np.float32)
    C = eigen_weights.shape[-2] if eigen_weights is not None else 0
    M = eigen_weights.shape[-1] if eigen_weights is not None else 0
    ew_s = (
        np.zeros((n_own, cap, C, M), np.float32)
        if eigen_weights is not None
        else None
    )
    pvm = None
    if pos_momentum is not None:
        pvm = np.zeros((n_own, cap, 4), np.float32)
    for j, k in enumerate(own):
        sel = order[k]
        nk = len(sel)
        idx_k, mask_k = per_stripe[k]
        lk = idx_k.shape[1]
        bidx_s[j, :, :lk] = idx_k
        bmask_s[j, :, :lk] = mask_k
        if nk:
            local = scan[sel].copy()
            local[:, 0] += plan.halo - k * plan.stripe_height
            scan_s[j, :nk] = local
            # Padded capacity slots duplicate a real position (mask 0).
            scan_s[j, nk:] = local[0]
            pos_mask[j, :nk] = 1.0
            # Batch-major data: rows follow the local contiguous order.
            for b in range(nb):
                valid = mask_k[b] > 0
                rows = idx_k[b][valid]
                gsel = sel[rows]
                if data_lookup is not None:
                    gsel = data_lookup[gsel]
                    assert np.all(gsel >= 0)
                data_rows[j, b, : len(rows)] = gsel
                if data_s is not None:
                    data_s[j, b, : len(rows)] = data[gsel]
            if ew_s is not None:
                ew_s[j, :nk] = eigen_weights[sel]
            if pvm is not None:
                pvm[j, :nk] = pos_momentum[sel]
        else:
            scan_s[j, :] = (plan.halo + 1, 1)
        lo = k * plan.stripe_height
        hi = min((k + 1) * plan.stripe_height, h)
        if hi > lo:
            row_mask[j, plan.halo : plan.halo + (hi - lo)] = 1.0

    # Local psi windows: rows [k*Hs - halo, k*Hs + Hs + halo), padded with
    # the background value outside the global object.
    psi_pad = np.pad(
        psi,
        (
            (0, 0),
            (plan.halo, plan.halo + ndev * plan.stripe_height - h),
            (0, 0),
        ),
        constant_values=1.0,
    )
    psi_s = np.stack(
        [
            psi_pad[
                :,
                k * plan.stripe_height : k * plan.stripe_height
                + plan.local_height,
            ]
            for k in own
        ]
    ).astype(np.complex64)

    cfg = dataclasses.replace(
        epoch_plan.cfg,
        probe_shape=p,
        detector_shape=det,
        nz=plan.local_height,
        n=w,
        nslices=d,
    )
    plan_static = dataclasses.replace(epoch_plan, cfg=cfg)
    comm = StripeComm(
        axis=BATCH_AXIS,
        ndev=ndev,
        halo=plan.halo,
        hs=plan.stripe_height,
        height=h,
    )

    if measured_pixels is None:
        measured_pixels = np.ones((det, det), bool)

    dev_sharding = NamedSharding(mesh, P(BATCH_AXIS))
    rep_sharding = NamedSharding(mesh, P())
    from . import put_process_local, put_replicated_global

    def put_dev(x):
        """Stripe-major placement; x holds this process's rows only."""
        return put_process_local(x, dev_sharding, ndev)

    def put_rep(x):
        """Replicated placement (identical full array on every process)."""
        return put_replicated_global(x, rep_sharding)

    # Moment states (per the EpochPlan moment kinds). An unused state is a
    # replicated scalar: the program returns it replicated on the mesh, so
    # placing it there from the start keeps the second call from retracing.
    unused = put_rep(np.zeros((), np.float32))
    psi_local_shape = (n_own, d, plan.local_height, w)
    obj_v = obj_m = unused
    if plan_static.obj_moment != "none":
        obj_m = put_dev(
            np.zeros(psi_local_shape, np.complex64)
        )
        if plan_static.obj_moment == "adam":
            obj_v = put_dev(np.zeros(psi_local_shape, np.float32))
        elif plan_static.obj_moment == "checked":
            obj_v = put_dev(
                np.zeros((n_own, 3, *psi_local_shape[1:]), np.complex64),
                complex=True,
            )
    probe_v = probe_m = unused
    if plan_static.probe_moment != "none":
        gshape = (
            (p, p) if plan_static.solver == "rpie" else (1, 1, p, p)
        )
        probe_m = put_rep(np.zeros(gshape, np.complex64))
        if plan_static.probe_moment == "adam":
            probe_v = put_rep(np.zeros(gshape, np.float32))
        else:
            probe_v = put_rep(
                np.zeros((3, *gshape), np.complex64)
            )
    from tike_tpu.ptycho.solvers.fused import seed_err_hist

    eh = seed_err_hist(prev_costs)

    pos_v = pos_m = unused
    if plan_static.recover_positions:
        if pvm is not None:
            pos_v = put_dev(pvm[..., 0:2])
            pos_m = put_dev(pvm[..., 2:4])
        else:
            pos_v = put_dev(np.zeros((n_own, cap, 2), np.float32))
            pos_m = put_dev(np.zeros((n_own, cap, 2), np.float32))

    return StripedState(
        plan=plan,
        epoch_plan=plan_static,
        comm=comm,
        mesh=mesh,
        height=h,
        order=order,
        psi=put_dev(psi_s),
        # Streaming mode (>HBM data): the caller's array stays the single
        # host copy; _striped_iterate_streamed gathers one batch at a time
        # through data_rows.
        data=put_dev(data_s) if store_data_on_device else None,
        data_host=None if store_data_on_device else data,
        data_rows=None if store_data_on_device else data_rows,
        scan=put_dev(scan_s),
        batch_idx=put_dev(bidx_s),
        batch_mask=put_dev(bmask_s),
        row_mask=put_dev(row_mask),
        pos_mask=put_dev(pos_mask),
        eigen_w=(
            # Weights are real float32, like the replicated path
            # (options.py: floating).
            put_dev(ew_s)
            if ew_s is not None
            else None
        ),
        pos_v=pos_v,
        pos_m=pos_m,
        obj_v=obj_v,
        obj_m=obj_m,
        probe=put_rep(np.asarray(probe, np.complex64)),
        eigen_p=(
            put_rep(np.asarray(eigen_probe, np.complex64))
            if eigen_probe is not None
            else jnp.zeros((), jnp.float32)
        ),
        probe_v=probe_v,
        probe_m=probe_m,
        err_hist=put_rep(np.asarray(eh)),
        measured_pixels=jnp.asarray(np.asarray(measured_pixels)),
        step_length_start=step_length_start,
        step_length_weight=step_length_weight,
        unmeasured_pixels_scaling=unmeasured_pixels_scaling,
        epochs_done=epochs_done,
        _rng=rng,
    )


def _striped_iterate_streamed(
    state: StripedState, n_epochs: int
) -> typing.List[float]:
    """Advance ``n_epochs`` epochs streaming data from the host per batch.

    The same epoch math as the fused program, but the diffraction data
    block never resides in HBM: each batch's (n_own, L, DET, DET) slice is
    device_put while the previous batch computes (double-buffered, like
    the replicated path's host-streaming mode)."""
    from . import put_process_local

    nb = state._nb()
    begin, batch, end, make_chunk = state._streamed_programs()
    dev_sharding = NamedSharding(state.mesh, P(BATCH_AXIS))

    def put_batch(b):
        # One batch-sized gather from the caller's array (the only host
        # copy); padded slots read row 0 and are zeroed.
        rows = state.data_rows[:, b]
        block = np.asarray(
            state.data_host[np.maximum(rows, 0)], dtype=np.float32
        )
        block[rows < 0] = 0.0
        return put_process_local(block, dev_sharding, state.comm.ndev)

    def put_chunk(ns):
        # K batches in one host gather and one globally-sharded upload.
        rows = state.data_rows[:, ns]  # (n_own, K, L)
        block = np.asarray(
            state.data_host[np.maximum(rows, 0)], dtype=np.float32
        )
        block[rows < 0] = 0.0
        return put_process_local(block, dev_sharding, state.comm.ndev)

    # Dispatch chunking: K mini-batches per program call amortizes the
    # per-call dispatch. K is bounded by HBM headroom: the chunk plus its
    # double-buffered prefetch must stay a small fraction of HBM.
    L = state.data_rows.shape[2]
    det = state.data_host.shape[-1]
    per_batch_dev_bytes = L * det * det * 4
    env_k = os.environ.get("TIKE_STREAM_CHUNK")
    K = 0
    if env_k:
        try:
            K = max(1, min(nb, int(env_k)))
        except ValueError:
            logger.warning(
                "ignoring non-integer TIKE_STREAM_CHUNK=%r", env_k
            )
    if not K:
        K = int(max(1, min(nb, (256 * 2**20) // max(per_batch_dev_bytes, 1))))
    chunk_prog = make_chunk(K) if K > 1 else None

    sls = jnp.asarray(state.step_length_start, jnp.float32)
    slw = jnp.asarray(state.step_length_weight, jnp.float32)
    ups = jnp.asarray(state.unmeasured_pixels_scaling, jnp.float32)
    zero = jnp.zeros((), jnp.float32)
    ecosts = []
    powers = []
    for e in range(n_epochs):
        epoch_idx = jnp.asarray(state.epochs_done, jnp.int32)
        if state.epoch_plan.compact:
            order = np.arange(nb, dtype=np.int32)
        else:
            order = state._rng.permutation(nb).astype(np.int32)
        (
            probe_s,
            pwr,
            psi_pre,
            probe_pre,
            psi_acc,
            probe_acc,
            pos_num,
            pos_den,
            pcomb,
            pbeta_sum,
            costs_b,
            beta_sum,
            eigen_p_s,
            probe_v_s,
            probe_m_s,
        ) = begin(
            epoch_idx,
            state.psi,
            state.probe,
            state.scan,
            state.batch_idx,
            state.batch_mask,
            state.eigen_p,
            state.probe_v,
            state.probe_m,
        )
        carry = (
            state.psi,
            probe_s,
            eigen_p_s,
            state.eigen_w if state.eigen_w is not None else zero,
            psi_acc,
            probe_acc,
            pos_num,
            pos_den,
            state.obj_v,
            state.obj_m,
            probe_v_s,
            probe_m_s,
            pcomb,
            pbeta_sum,
            costs_b,
            beta_sum,
        )
        # Split the epoch's batch order into full K-chunks plus a tail of
        # single batches (two compiled programs at most); results are
        # bitwise-identical for any chunking because the chunk program
        # scans the same per-batch math sequentially.
        n_full = nb // K if chunk_prog is not None else 0
        steps = [
            ("chunk", order[c * K : (c + 1) * K]) for c in range(n_full)
        ] + [("single", order[k]) for k in range(n_full * K, nb)]

        def put_step(step):
            kind, ns = step
            if kind == "chunk":
                return put_chunk(ns)
            return put_batch(int(ns))

        nxt = put_step(steps[0])
        for k, (kind, ns) in enumerate(steps):
            data_b = nxt
            if k + 1 < len(steps):
                # Prefetch the next chunk/batch while this one computes
                # (device_put is asynchronous).
                nxt = put_step(steps[k + 1])
            common = (
                epoch_idx,
                data_b,
                state.scan,
                state.batch_idx,
                state.batch_mask,
                state.measured_pixels,
                sls,
                slw,
                ups,
                psi_pre,
                probe_pre,
            )
            if kind == "chunk":
                carry = chunk_prog(
                    jnp.asarray(ns, jnp.int32), *common, *carry
                )
            else:
                carry = batch(
                    jnp.asarray(int(ns), jnp.int32), *common, *carry
                )
        (
            state.psi,
            state.probe,
            eigen_p,
            eigen_w,
            state.scan,
            state.pos_v,
            state.pos_m,
            state.obj_v,
            state.obj_m,
            state.probe_v,
            state.probe_m,
            state.err_hist,
            epoch_cost,
            pwr_out,
        ) = end(
            epoch_idx,
            state.scan,
            state.batch_mask,
            state.row_mask,
            state.pos_mask,
            state.err_hist,
            pwr,
            psi_pre,
            probe_pre,
            state.pos_v,
            state.pos_m,
            *carry,
        )
        if state.eigen_w is not None:
            state.eigen_w = eigen_w
            state.eigen_p = eigen_p
        state.epochs_done += 1
        # Device handles only: converting here would drain the device
        # queue at every epoch boundary and stall the next epoch's
        # dispatch/prefetch.
        ecosts.append(epoch_cost)
        powers.append(pwr_out)
    state.last_powers = np.stack([np.asarray(p_) for p_ in powers])
    return [float(c) for c in ecosts]


def striped_iterate(state: StripedState, n_epochs: int) -> typing.List[float]:
    """Advance ``n_epochs`` fused epochs in place; return per-epoch costs.

    Dispatches to the host-streaming per-batch path when the data block
    lives in host RAM (setup with ``store_data_on_device=False``)."""
    if state.data is None:
        return _striped_iterate_streamed(state, n_epochs)
    nb = state._nb()
    if state.epoch_plan.compact:
        orders = np.tile(np.arange(nb, dtype=np.int32), (n_epochs, 1))
    else:
        orders = np.stack(
            [
                state._rng.permutation(nb).astype(np.int32)
                for _ in range(n_epochs)
            ]
        )
    program = state._program(n_epochs)
    (
        state.psi,
        state.probe,
        eigen_p,
        eigen_w,
        state.scan,
        state.pos_v,
        state.pos_m,
        state.obj_v,
        state.obj_m,
        state.probe_v,
        state.probe_m,
        state.err_hist,
        ecosts,
        pwr,
    ) = program(
        jnp.asarray(state.epochs_done, jnp.int32),
        state.data,
        state.scan,
        state.batch_idx,
        state.batch_mask,
        jnp.asarray(orders),
        state.psi,
        state.probe,
        state.eigen_p,
        state.eigen_w
        if state.eigen_w is not None
        else jnp.zeros((), jnp.float32),
        state.measured_pixels,
        state.row_mask,
        state.pos_mask,
        state.pos_v,
        state.pos_m,
        state.obj_v,
        state.obj_m,
        state.probe_v,
        state.probe_m,
        state.err_hist,
        jnp.asarray(state.step_length_start, jnp.float32),
        jnp.asarray(state.step_length_weight, jnp.float32),
        jnp.asarray(state.unmeasured_pixels_scaling, jnp.float32),
    )
    if state.eigen_w is not None:
        state.eigen_w = eigen_w
        state.eigen_p = eigen_p
    state.epochs_done += n_epochs
    # Probe mode power history (the replicated path's popts.power).
    state.last_powers = np.asarray(pwr)  # (E, modes)
    # Globally-weighted epoch costs come out of the program replicated
    # (psum-weighted inside _epoch_math), so this also works when the
    # stripes span multiple processes.
    return [float(c) for c in np.asarray(ecosts)]


def striped_epoch(state: StripedState) -> float:
    """Advance one epoch in place; return the mean cost."""
    return striped_iterate(state, 1)[0]


def _fetch_dev(x) -> np.ndarray:
    """Host copy of a stripe-major global array (see parallel.fetch_global)."""
    from . import fetch_global

    return fetch_global(x)


def striped_result(
    state: StripedState,
) -> typing.Tuple[np.ndarray, np.ndarray]:
    """Stitch the stripes back into (psi (D, H, W), probe)."""

    return (
        stitch(state.plan, _fetch_dev(state.psi), state.height),
        np.asarray(state.probe),
    )


def striped_scan_global(state: StripedState) -> np.ndarray:
    """Scan positions reassembled in the original global order."""
    n_total = sum(len(o) for o in state.order)
    scan_l = _fetch_dev(state.scan)
    scan_g = np.zeros((n_total, 2), np.float32)
    for k, sel in enumerate(state.order):
        nk = len(sel)
        local = scan_l[k, :nk].copy()
        local[:, 0] -= state.plan.halo - k * state.plan.stripe_height
        scan_g[sel] = local
    return scan_g


def striped_set_scan(state: StripedState, scan_g: np.ndarray) -> None:
    """Write corrected global positions back into the stripe layout.

    The inverse of :func:`striped_scan_global`: re-offsets each stripe's
    rows into its local window, clamps to the window interior (the same
    clamp the in-program position update applies — positions beyond the
    halo margin would corrupt gradients silently), keeps padded capacity
    slots unchanged, and re-places the stripe-major block with this
    process's rows (multi-host safe: every process must pass the SAME
    global scan).
    """
    from . import put_process_local

    from tike_tpu.ptycho.solvers.lstsq import _POS_EDGE

    cfg = state.epoch_plan.cfg
    p = cfg.probe_shape
    scan_l = _fetch_dev(state.scan).copy()
    for k, sel in enumerate(state.order):
        nk = len(sel)
        local = np.asarray(scan_g[sel], np.float32).copy()
        off = state.plan.halo - k * state.plan.stripe_height
        local[:, 0] += off
        # Same per-stripe bounds as the in-program clamp: the local
        # window interior, intersected with the GLOBAL valid region
        # [1, H - P) mapped into local coordinates (the first stripe's
        # upper halo / last stripe's lower halo are padding, not object).
        local[:, 0] = np.clip(
            local[:, 0],
            max(1.0, 1.0 + off),
            min(cfg.nz - p - 2.0, state.height - p - _POS_EDGE + off),
        )
        local[:, 1] = np.clip(local[:, 1], 1.0, cfg.n - p - _POS_EDGE)
        scan_l[k, :nk] = local
    own = _own_stripe_rows(state.mesh)
    state.scan = put_process_local(
        scan_l[own], state.scan.sharding, state.comm.ndev
    )


def striped_full_result(state: StripedState) -> dict:
    """All solver state reassembled in the original global position order."""

    n_total = sum(len(o) for o in state.order)
    out = {
        "psi": stitch(state.plan, _fetch_dev(state.psi), state.height),
        "probe": np.asarray(state.probe),
        "eigen_probe": (
            np.asarray(state.eigen_p) if state.eigen_w is not None else None
        ),
    }
    out["scan"] = striped_scan_global(state)
    if state.eigen_w is not None:
        ew_l = _fetch_dev(state.eigen_w)
        ew_g = np.zeros((n_total, *ew_l.shape[2:]), ew_l.dtype)
        for k, sel in enumerate(state.order):
            ew_g[sel] = ew_l[k, : len(sel)]
        out["eigen_weights"] = ew_g
    else:
        out["eigen_weights"] = None
    if state.epoch_plan.recover_positions:
        pv = _fetch_dev(state.pos_v)
        pm = _fetch_dev(state.pos_m)
        mom = np.zeros((n_total, 4), np.float32)
        for k, sel in enumerate(state.order):
            mom[sel, 0:2] = pv[k, : len(sel)]
            mom[sel, 2:4] = pm[k, : len(sel)]
        out["position_momentum"] = mom
    return out


def _default_plan(
    solver: str,
    noise_model: str,
    alpha: float,
    num_batch: int,
    recover_probe: bool = True,
) -> EpochPlan:
    """Minimal EpochPlan for the functional striped API."""
    return EpochPlan(
        cfg=PtychoConfig(probe_shape=1, detector_shape=1, nz=1, n=1),
        solver=solver,
        n_epochs=1,
        compact=True,
        noise_model=noise_model,
        steplength_usemodes="all_modes",
        recover_psi=True,
        recover_probe=recover_probe,
        has_eigen=False,
        update_start=0,
        update_period=1,
        probe_support=0.0,
        probe_support_radius=0.35,
        probe_support_degree=2.5,
        additional_probe_penalty=0.0,
        median_filter=False,
        median_filter_px=(1.0, 1.0),
        force_center=False,
        force_sparsity=1.0,
        force_orthogonality=False,
        positivity=0.0,
        smoothness=0.0,
        clip_magnitude=False,
        rescale_mean_abs=False,
        rescale_period=10**9,
        alpha=alpha,
    )


def setup_striped(
    data: np.ndarray,
    psi: np.ndarray,
    probe: np.ndarray,
    scan: np.ndarray,
    *,
    mesh: Mesh,
    solver: str = "rpie",
    noise_model: str = "gaussian",
    alpha: float = 0.05,
    position_margin: int = 8,
    num_batch: int = 1,
    recover_probe: bool = True,
) -> StripedState:
    """Shard the problem into row stripes (compact accumulation).

    Functional-API entry with the historical signature; the driver path
    (`Reconstruction(..., object_sharding="striped")`) builds the full
    EpochPlan from PtychoParameters instead.
    """
    if solver not in ("rpie", "lstsq"):
        raise ValueError(f"striped mode supports rpie/lstsq, not {solver!r}")
    plan = _default_plan(
        solver, noise_model, alpha, num_batch, recover_probe
    )
    return setup_striped_full(
        data,
        np.asarray(psi),
        probe,
        scan,
        mesh=mesh,
        epoch_plan=plan,
        batch_method="compact",
        num_batch=num_batch,
        position_margin=position_margin,
    )


def reconstruct_striped(
    data: np.ndarray,
    psi: np.ndarray,
    probe: np.ndarray,
    scan: np.ndarray,
    *,
    mesh: Mesh,
    num_iter: int,
    solver: str = "rpie",
    noise_model: str = "gaussian",
    alpha: float = 0.05,
    num_batch: int = 1,
) -> typing.Tuple[np.ndarray, np.ndarray, list]:
    """Row-striped reconstruction over a device mesh (functional API).

    The scaling path for objects larger than per-chip HBM: psi lives only as
    per-device stripes; the probe is replicated and all-reduced. Runs the
    full fused epoch math per stripe (multi-mode probes, compact
    accumulation; the driver path adds OPR/positions/constraints).

    Returns (stitched psi (D, H, W), probe, costs per epoch).
    """
    state = setup_striped(
        data,
        np.asarray(psi),
        probe,
        scan,
        mesh=mesh,
        solver=solver,
        noise_model=noise_model,
        alpha=alpha,
        num_batch=num_batch,
    )
    costs = striped_iterate(state, num_iter)
    psi_out, probe_out = striped_result(state)
    return psi_out, probe_out, costs

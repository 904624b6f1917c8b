"""Bucket laminography drivers: reconstruct and simulate.

JAX equivalent of `upstream/src/tike/lamino/bucket.py:91-188`.
The reference splits the voxel grid across MPI ranks / device groups
(object-domain model parallelism); here the grid/volume pair can be sharded
over a mesh axis for the same effect.
"""

from __future__ import annotations

import logging

import jax.numpy as jnp
import numpy as np

from tike_tpu.ops.bucket import BucketConfig, bucket_fwd_p, make_grid
from . import solvers

__all__ = ["reconstruct", "simulate"]

logger = logging.getLogger(__name__)


def simulate(obj, theta, tilt, eps=1.0, **kwargs):
    """Return complex projections simulated with the Bucket operator."""
    assert obj.ndim == 3
    assert np.ndim(theta) == 1
    n = obj.shape[-1]
    cfg = BucketConfig.from_eps(n=n, tilt=float(tilt), eps=eps)
    grid = make_grid(n)
    data = bucket_fwd_p(
        cfg,
        jnp.asarray(obj, jnp.complex64),
        jnp.asarray(theta, dtype=jnp.float32),
        jnp.asarray(grid),
    )
    return np.asarray(data)


def reconstruct(
    data,
    theta,
    tilt,
    algorithm="bucket",
    obj=None,
    num_iter=1,
    rtol=-1,
    eps=1e-1,
    num_gpu=1,
    obj_split=1,
    use_mpi=False,
    mesh=None,
    **kwargs,
):
    """Solve the laminography problem with the Bucket operator.

    Volume model parallelism (the reference's ``obj_split``,
    `lamino/bucket.py:132-147`): pass ``obj_split > 1`` (shards the volume
    over the first ``obj_split`` local devices) or an explicit ``mesh``
    whose single axis shards the volume's first dimension. Each device owns
    an x-slab of voxels; partial projections are psum-reduced and gradients
    stay owner-local (see ops.bucket.sharded_bucket_ops).
    """
    n = data.shape[2]
    obj = np.zeros([n, n, n], dtype="complex64") if obj is None else obj
    if algorithm not in solvers.__all__:
        raise ValueError(
            "The '{}' algorithm is not an available.".format(algorithm)
        )
    cfg = BucketConfig.from_eps(n=n, tilt=float(tilt), eps=eps)
    # Host arrays until placed: with a mesh they go straight to their
    # shards, never whole onto one device first.
    data_d = np.asarray(data, np.complex64)
    theta_d = np.asarray(theta, dtype=np.float32)
    obj_d = np.asarray(obj, np.complex64)

    if mesh is None and obj_split > 1:
        from tike_tpu.parallel import make_mesh

        mesh = make_mesh(obj_split)
    if mesh is not None and len(mesh.axis_names) == 2:
        # 2D (data x volume) mesh: theta/data sharded over axis 0, volume
        # x-slabs over axis 1 — the reference's data-group x obj_split grid
        # (`upstream/src/tike/lamino/solvers/bucket.py:34-54,111-114`).
        from jax.sharding import NamedSharding, PartitionSpec as P

        from tike_tpu.ops.bucket import (
            make_grid_full,
            sharded_bucket_ops_2d,
        )
        from tike_tpu.parallel import put_replicated_global

        d_axis, v_axis = mesh.axis_names
        if n % mesh.shape[v_axis] != 0:
            raise ValueError(
                f"the volume mesh axis ({mesh.shape[v_axis]}) must evenly "
                f"divide the volume side ({n})"
            )
        if len(theta) % mesh.shape[d_axis] != 0:
            raise ValueError(
                f"the data mesh axis ({mesh.shape[d_axis]}) must evenly "
                f"divide the number of angles ({len(theta)})"
            )
        vol_sharding = NamedSharding(mesh, P(v_axis))
        data_sharding = NamedSharding(mesh, P(d_axis))
        grid = put_replicated_global(make_grid_full(n), vol_sharding)
        data_d = put_replicated_global(data_d, data_sharding)
        theta_d = put_replicated_global(theta_d, data_sharding)
        obj_d = put_replicated_global(obj_d, vol_sharding)
        _, _, cost_raw, grad_raw, _ = sharded_bucket_ops_2d(
            cfg, mesh, d_axis, v_axis, raw=True
        )
        _, _, _, _, step_sm = sharded_bucket_ops_2d(
            cfg, mesh, d_axis, v_axis
        )
        kwargs.setdefault("raw_cost", cost_raw)
        kwargs.setdefault("raw_grad", grad_raw)
        kwargs.setdefault(
            "step_scale_op", lambda u, t_: step_sm(u, t_, grid)
        )
    elif mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        from tike_tpu.ops.bucket import make_grid_full, sharded_bucket_ops

        axis = mesh.axis_names[0]
        if n % mesh.size != 0:
            raise ValueError(
                f"the mesh size ({mesh.size}) must evenly divide the "
                f"volume side ({n}) so each device owns a whole x-slab"
            )
        vol_sharding = NamedSharding(mesh, P(axis))
        rep = NamedSharding(mesh, P())
        from tike_tpu.parallel import put_replicated_global

        # Multi-process: the voxel grid spans all processes (the
        # reference's MPI-rank grid split, `bucket.py:267-274`); every
        # process holds full copies of the small data/theta. The volume
        # and grid are globally sharded (each process contributes its own
        # x-slabs via the replicated-source callback).
        grid = put_replicated_global(make_grid_full(n), vol_sharding)
        data_d = put_replicated_global(data_d, rep)
        theta_d = put_replicated_global(theta_d, rep)
        obj_d = put_replicated_global(obj_d, vol_sharding)
        _, _, cost_raw, grad_raw, _ = sharded_bucket_ops(
            cfg, mesh, axis, raw=True
        )
        _, _, _, _, step_sm = sharded_bucket_ops(cfg, mesh, axis)
        kwargs.setdefault("raw_cost", cost_raw)
        kwargs.setdefault("raw_grad", grad_raw)
        kwargs.setdefault(
            "step_scale_op", lambda u, t_: step_sm(u, t_, grid)
        )
    else:
        grid = jnp.asarray(make_grid(n))
        data_d, theta_d, obj_d = map(jnp.asarray, (data_d, theta_d, obj_d))

    logger.info(
        "{} on {:,d} by {:,d} by {:,d} volume for {:,d} "
        "iterations.".format(algorithm, *obj.shape, num_iter)
    )
    result = {"obj": obj_d}
    costs = []
    for i in range(num_iter):
        kwargs.update(result)
        result = getattr(solvers, algorithm)(
            cfg, data=data_d, theta=theta_d, grid=grid, **kwargs
        )
        if result.get("cost") is not None:
            costs.append(float(result["cost"]))
        if len(costs) > 1 and abs(
            (costs[-1] - costs[-2]) / costs[-2]
        ) < rtol:
            logger.info(
                "Cost function rtol < %g reached at %d iterations.", rtol, i
            )
            break

    result["cost"] = np.asarray(costs)
    from tike_tpu.parallel import fetch_global

    return {
        k: fetch_global(v) if not np.isscalar(v) and np.ndim(v) > 0 else v
        for k, v in result.items()
    }

"""Laminography drivers: reconstruct and simulate.

JAX equivalent of `upstream/src/tike/lamino/lamino.py:67-179`.
The reference scatters data/theta over a GPU ThreadPool; here the theta axis
is the natural sharding axis (projections are independent in the forward
model) — shard data/theta over a mesh and XLA reduces the gradient.
"""

from __future__ import annotations

import logging

import jax
import jax.numpy as jnp
import numpy as np

from tike_tpu.ops.lamino import LaminoConfig, lamino_fwd_p
from . import solvers

__all__ = ["reconstruct", "simulate"]

logger = logging.getLogger(__name__)


def simulate(obj, theta, tilt, eps=1e-3, upsample=1, kernel="kb", **kwargs):
    """Return complex values of simulated laminography data."""
    assert obj.ndim == 3
    assert np.ndim(theta) == 1
    cfg = LaminoConfig(
        n=obj.shape[-1], tilt=float(tilt), eps=float(eps), upsample=upsample,
        kernel=kernel,
    )
    data = lamino_fwd_p(
        cfg,
        jnp.asarray(obj, dtype=jnp.complex64),
        jnp.asarray(theta, dtype=jnp.float32),
    )
    return np.asarray(data)


def reconstruct(
    data,
    theta,
    tilt,
    algorithm,
    obj=None,
    num_iter=1,
    rtol=-1,
    eps=1e-3,
    num_gpu=1,
    upsample=1,
    mesh=None,
    kernel="kb",
    **kwargs,
):
    """Solve the laminography problem using the given algorithm.

    Same parameters as the reference (`lamino/lamino.py:89-179`); `mesh`
    optionally shards the theta axis across devices. ``algorithm`` is
    ``"cgrad"`` (the reference's backtracking CG) or ``"cgls"``
    (beyond-reference optimal-step CG on the normal equations — faster
    per iteration AND deeper-converging; see docs/lamino.md).
    """
    n = data.shape[2]
    obj = np.zeros([n, n, n], dtype="complex64") if obj is None else obj
    if algorithm == "bucket":
        raise ValueError(
            "Use tike_tpu.lamino.bucket.reconstruct for the bucket solver."
        )
    if algorithm not in solvers.__all__:
        raise ValueError(
            "The '{}' algorithm is not an available.".format(algorithm)
        )
    cfg = LaminoConfig(
        n=obj.shape[-1], tilt=float(tilt), eps=float(eps), upsample=upsample,
        kernel=kernel,
    )
    # Host arrays until placed: with a mesh they go straight to their
    # shards, never whole onto one device first.
    data_d = np.asarray(data, dtype=np.complex64)
    theta_d = np.asarray(theta, dtype=np.float32)
    obj_d = np.asarray(obj, dtype=np.complex64)
    if mesh is None:
        data_d, theta_d, obj_d = map(jnp.asarray, (data_d, theta_d, obj_d))
    else:
        from tike_tpu.parallel import batch_sharding, replicated_sharding

        from tike_tpu.parallel import (
            put_process_local,
            put_replicated_global,
        )

        # Multi-process (`MPIio_lamino`, `mpi.py:87-92`): each process
        # holds its own contiguous theta chunk; single-process this is a
        # plain device_put.
        nproc = jax.process_count()
        ntheta_local = data_d.shape[0]
        data_d = put_process_local(
            data_d, batch_sharding(mesh), nproc * ntheta_local
        )
        theta_d = put_process_local(
            theta_d, batch_sharding(mesh), nproc * ntheta_local
        )
        obj_d = put_replicated_global(obj_d, replicated_sharding(mesh))

    logger.info(
        "{} on {:,d} by {:,d} by {:,d} volume for {:,d} "
        "iterations.".format(algorithm, *obj.shape, num_iter)
    )

    result = {"obj": obj_d}
    costs = []
    for i in range(num_iter):
        kwargs.update(result)
        result = getattr(solvers, algorithm)(
            cfg, data=data_d, theta=theta_d, **kwargs
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
    return {
        k: np.asarray(v) if not np.isscalar(v) and np.ndim(v) > 0 else v
        for k, v in result.items()
    }

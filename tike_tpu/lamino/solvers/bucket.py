"""Conjugate-gradient solver for the Bucket laminography operator.

JAX equivalent of `upstream/src/tike/lamino/solvers/bucket.py`.
The reference's device-group reduction structure (obj_split) collapses into
sharded arrays: sharding the voxel grid over a mesh axis shards the volume,
and XLA reduces the projections.

All cost/gradient/step-scale evaluations are single programs; only real
scalars are downloaded between CG steps.
"""

from __future__ import annotations

import functools
import logging

import jax

import numpy as np

import tike_tpu.opt
from tike_tpu.ops.bucket import (
    BucketConfig,
    bucket_adj,
    bucket_cost,
    bucket_fwd,
    bucket_step_scale,
)

logger = logging.getLogger(__name__)



@functools.lru_cache(maxsize=8)
def _single_device_raw(cfg: BucketConfig):
    """Traceable (cost, grad) pair for the unsharded operator.

    Memoized per cfg so `_fused_outer`'s identity-keyed cache hits across
    outer iterations (fresh closures would re-trace every call)."""

    def cost_raw(data, u, theta, grid):
        return bucket_cost(data, bucket_fwd(cfg, u, theta, grid))

    def grad_raw(data, u, theta, grid):
        fd = bucket_fwd(cfg, u, theta, grid)
        g = bucket_adj(cfg, fd - data, theta, grid)
        return g / (data.shape[-3] * cfg.n**3)

    return cost_raw, grad_raw


@functools.lru_cache(maxsize=8)
def _fused_outer(raw_cost, raw_grad, cg_iter):
    """One whole outer CG iteration as a single program.

    Same reasoning as the USFFT solver
    (`lamino/solvers/cgrad._cgrad_outer_program`): rather than one host
    round trip per cost/grad call, the inner loop (grads, Dai-Yuan directions, backtracking line searches) traces
    into one program. Cached on the raw-op identities: the driver builds
    its (possibly shard_map'ed) raw ops once per reconstruct() call.
    """

    @jax.jit
    def prog(data, theta, obj, grid, step):
        return tike_tpu.opt.conjugate_gradient_traced(
            obj,
            cost_function=lambda u: raw_cost(data, u, theta, grid),
            grad=lambda u: _reshape_like_traced(
                raw_grad(data, u, theta, grid), u
            ),
            num_iter=cg_iter,
            step_length=step,
        )

    return prog


def _reshape_like_traced(g, u):
    return g.reshape(u.shape) if g.shape != u.shape else g


def bucket(
    cfg: BucketConfig,
    data,
    theta,
    obj,
    grid,
    cg_iter=4,
    step_length=1,
    raw_cost=None,
    raw_grad=None,
    step_scale_op=None,
    **kwargs,
):
    """One outer CG iteration for the Bucket laminography problem.

    ``raw_cost``/``raw_grad`` are TRACEABLE (data, u, theta, grid)
    functions, defaulting to the single-device operators; the
    model-parallel drivers inject the shard_map versions from
    ``tike_tpu.ops.bucket.sharded_bucket_ops[_2d](..., raw=True)`` (the
    reference's obj_split path, `lamino/solvers/bucket.py:41-172`). The
    whole inner loop runs as one program (`_fused_outer`).
    """
    if raw_cost is None or raw_grad is None:
        raw_cost, raw_grad = _single_device_raw(cfg)

    if step_scale_op is None:

        def step_scale_op(u, theta_):
            return bucket_step_scale(cfg, u, theta_, grid)

    if step_length == 1:
        s = float(step_scale_op(obj, theta))
        step_length = s if np.isfinite(s) and s > 0 else 1.0

    import jax.numpy as jnp

    obj, cost_d, _ = _fused_outer(raw_cost, raw_grad, cg_iter)(
        data, theta, obj, grid, jnp.float32(step_length)
    )
    cost = float(cost_d)
    # The line-search-adapted step stays INSIDE the program's inner
    # iterations; each outer iteration restarts from the estimated step —
    # the reference's behavior (its conjugate_gradient never returns the
    # adapted step), and measurably better-conditioned for bucket.
    logger.info("%10s cost is %+12.5e", "object", cost)
    return {"obj": obj, "cost": cost, "step_length": step_length}

"""Conjugate-gradient solver for laminography.

JAX equivalent of `upstream/src/tike/lamino/solvers/cgrad.py`.
The reference's pool.map + Allreduce structure collapses into jitted cost and
gradient functions; with a sharded theta axis, XLA inserts the reductions.
"""

from __future__ import annotations

import logging

import jax

import numpy as np

import tike_tpu.linalg
import tike_tpu.opt
from tike_tpu.ops.lamino import (
    LaminoConfig,
    lamino_step_scale,
)

logger = logging.getLogger(__name__)



@jax.jit(static_argnames=("cfg", "cg_iter"))
def _cgrad_outer_program(cfg, data, theta, obj, step_length, cg_iter):
    """One WHOLE outer CG iteration as a single program.

    Tracing grads, Dai-Yuan directions, and the backtracking line searches
    into one program leaves one dispatch + one scalar download per OUTER
    iteration instead of ~15 host-side program calls.
    """
    from tike_tpu.ops.lamino import lamino_cost, lamino_grad

    return tike_tpu.opt.conjugate_gradient_traced(
        obj,
        cost_function=lambda u: lamino_cost(cfg, data, theta, u),
        grad=lambda u: lamino_grad(cfg, data, theta, u),
        num_iter=cg_iter,
        step_length=step_length,
    )


def _estimate_step_length(obj, theta, cfg):
    """Step-length scale = |F*Fm| / |m| (`cgrad.py:9-24`).

    One program; only the real scalar is downloaded.
    """
    s = float(lamino_step_scale(cfg, obj, theta))
    # A zero initial object yields 0/0; fall back to unit step like the
    # reference does for the NaN it produces there.
    return s if np.isfinite(s) and s > 0 else 1.0


def cgrad(
    cfg: LaminoConfig,
    data,
    theta,
    obj,
    cg_iter=4,
    step_length=1,
    **kwargs,
):
    """One outer iteration of CG for the laminography problem.

    Runs as ONE device program (`_cgrad_outer_program`): only the final
    cost scalar and the adapted step length are downloaded per call.
    """
    if step_length == 1:
        step_length = _estimate_step_length(obj, theta, cfg)

    import jax.numpy as jnp

    obj, cost_d, _ = _cgrad_outer_program(
        cfg, data, theta, obj,
        jnp.float32(step_length),
        cg_iter,
    )
    cost = float(cost_d)
    # The adapted step stays INSIDE the program's inner iterations; each
    # outer iteration restarts from the estimated step (the reference's
    # conjugate_gradient never returns the adapted step).
    logger.info("%10s cost is %+12.5e", "object", cost)
    return {"obj": obj, "cost": cost, "step_length": step_length}

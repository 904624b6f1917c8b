"""CGLS solver for laminography (beyond-reference option).

The laminography forward model is LINEAR, so the least-squares problem is
exactly quadratic and CGLS (conjugate gradients on the normal equations,
`tike_tpu.opt.cgls_traced`) needs one fwd + one adj per inner iteration
with optimal step lengths — no backtracking cost evaluations. The
reference applies its generic Dai-Yuan + backtracking machinery here
(`upstream/src/tike/lamino/solvers/cgrad.py`); ``algorithm="cgrad"``
keeps that behavior for parity, ``algorithm="cgls"`` is the faster exact
alternative. Each outer iteration runs as ONE program.
"""

from __future__ import annotations

import logging

import jax

import tike_tpu.opt
from tike_tpu.ops.lamino import LaminoConfig, lamino_adj_exact, lamino_fwd

logger = logging.getLogger(__name__)


@jax.jit(static_argnames=("cfg", "cg_iter"))
def _cgls_outer_program(cfg, data, theta, obj, cg_iter):
    # CGLS requires the TRUE adjoint (lamino_adj_exact): the reference's
    # -xi adjoint identity drifts ~20% from adjointness at upsample=1
    # (Nyquist-row aliasing) — harmless to backtracking CG, divergent for
    # optimal-step CG (measured: cost tripled in 16 steps).
    return tike_tpu.opt.cgls_traced(
        fwd=lambda u: lamino_fwd(cfg, u, theta),
        adj=lambda r: lamino_adj_exact(cfg, r, theta),
        b=data,
        x0=obj,
        num_iter=cg_iter,
    )


def cgls(
    cfg: LaminoConfig,
    data,
    theta,
    obj,
    cg_iter=4,
    **kwargs,
):
    """One outer iteration (= ``cg_iter`` CGLS steps) as one program."""

    obj, cost_d = _cgls_outer_program(cfg, data, theta, obj, cg_iter)
    cost = float(cost_d)
    logger.info("%10s cost is %+12.5e", "object", cost)
    return {"obj": obj, "cost": cost}

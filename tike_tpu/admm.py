"""Joint ptycho-tomography reconstruction by ADMM.

Re-derivation of the reference's legacy joint pipeline
(`upstream/src/broken/tike.py:87-178`,
`src/broken/ptycho/solvers/admm.py:26-215`) over the new JAX
primitives. The legacy code targets an older API and does not run against the
current reference; this module implements the same splitting for the modern
stack, with the laminography operator standing in for the Radon transform
(tilt = pi/2 is conventional tomography, SURVEY.md §2.1).

Problem: recover a 3D complex refractive index `obj` from ptychographic
diffraction measurements at multiple rotation angles. Split variables:

    minimize  sum_t ptycho_cost(data_t; psi_t)
    s.t.      psi_t = exp(i k voxelsize * P_t(obj))      (P_t = projection)

ADMM iteration (rho = penalty, lamda = scaled dual):
  1. psi_t  <- ptycho epochs on data_t, then proximal blend toward
               hobj_t - lamda_t/rho
  2. phi_t  = -i/k * log(psi_t + lamda_t/rho) / voxelsize
  3. obj    <- laminography CG fit of phi
  4. hobj_t = exp(i k voxelsize P_t(obj))
  5. lamda += rho (psi - hobj)
"""

from __future__ import annotations

import copy
import logging
import typing

import jax
import jax.numpy as jnp
import numpy as np

import tike_tpu.lamino
from tike_tpu.constants import wavenumber
from tike_tpu.ops.lamino import LaminoConfig, lamino_fwd_p
from tike_tpu.ptycho.solvers import PtychoParameters


@jax.jit(static_argnames=("shape",))
def _coverage_program(pw_broadcast, scan, shape):
    """Illumination coverage: real |probe|^2 accumulated over scan windows
    as ONE program with real (float) boundaries only."""
    from tike_tpu.ops.patch import patch_adj

    return patch_adj(pw_broadcast, scan, shape)

logger = logging.getLogger(__name__)

__all__ = ["reconstruct_joint_admm"]


def reconstruct_joint_admm(
    data: typing.Sequence[np.ndarray],
    parameters: typing.Sequence[PtychoParameters],
    theta: np.ndarray,
    tilt: float = np.pi / 2,
    obj: np.ndarray | None = None,
    voxelsize: float = 1.0,
    energy: float = 10.0,
    num_iter: int = 1,
    rho: float = 0.5,
    ptycho_iter: int = 2,
    lamino_iter: int = 2,
    eps: float = 1e-3,
    upsample: float = 2.0,
    gauge: str = "target",
    coverage_weighted: bool = True,
):
    """Jointly reconstruct a 3D object from multi-angle ptychography.

    Parameters
    ----------
    data : list of (POSI, DET, DET) float32, one per rotation angle
    parameters : list of PtychoParameters, one per angle (psi is the
        per-angle projection transmission estimate)
    theta : (T,) float32 rotation angles [radians]
    tilt : float, angle between rotation axis and beam (pi/2 = tomography)
    voxelsize : float [cm], object voxel side length
    energy : float [keV], probe energy
    rho : float, ADMM penalty. Sets the data-vs-consensus blend
        ``rho/(w+rho)`` per iteration. Measured on
        `scripts/admm_quality.py` (16 angles, coverage-weighted blend):
        smooth phantoms are insensitive (0.95-0.96 for rho in [0.5, 2]);
        sharp-edged phantoms converge faster with stronger coupling
        (rho=2: corr 0.88 at 12 iters, 0.91 at 24; rho=0.5: 0.84 at 12).
    ptycho_iter, lamino_iter : int, inner iterations per ADMM iteration.
        2/2 balances the subproblems: the quality benchmark measures no
        gain from deeper inner solves (per-angle phase error is set by
        coverage, not inner convergence — see `scripts/admm_quality.py`),
        so total work scales linearly with num_iter instead.
    gauge : str, per-angle phase piston estimator ("target", "median",
        "none") — see the inline comment at the blend step.
    coverage_weighted : bool, weight the proximal blend by illumination
        coverage so weakly-measured pixels lean on the consensus volume
        (measured +0.1 corr on sharp phantoms; exact unweighted blend
        when False).

    Returns
    -------
    dict with 'obj' (N, N, N) complex64, 'parameters' (updated list),
    'costs' (per-iteration mean ptycho cost).
    """
    import tike_tpu.ptycho as tp

    if gauge not in ("target", "median", "none"):
        raise ValueError(f"unknown gauge: {gauge!r}")
    T = len(theta)
    assert len(data) == T and len(parameters) == T
    n = parameters[0].psi.shape[-1]
    k = wavenumber(energy)
    if obj is None:
        obj = np.zeros((n, n, n), dtype=np.complex64)
    cfg = LaminoConfig(n=n, tilt=float(tilt), eps=eps, upsample=upsample)

    psi = np.stack([np.asarray(p.psi)[0] for p in parameters])  # (T, n, n)
    hobj = np.ones_like(psi)
    lamda = np.zeros_like(psi)
    params = [copy.deepcopy(p) for p in parameters]

    # Per-angle illumination coverage (sum of |probe|^2 over scan windows,
    # the psi-preconditioner quantity). Used to weight the proximal blend:
    # per-angle ptychography phase error concentrates where coverage is low
    # (measured 0.21 vs 0.09 rad rms on the quality benchmark), and
    # substituting the consensus there — which the volume fit fills from
    # the OTHER angles' well-measured projections of the same voxels —
    # lifts the reconstruction (scripts/admm_quality.py). Uniform weight
    # w = 1 reduces the blend exactly to the unweighted (raw + rho*t)/(1+rho).
    if coverage_weighted:
        weights = []
        for p in params:
            pw = np.sum(
                np.square(np.abs(np.asarray(p.probe))[0, 0]), axis=0
            ).astype(np.float32)
            npos = p.scan.shape[0]
            # Real-valued, one jitted program instead of eager op-by-op
            # dispatch.
            cov = np.asarray(
                _coverage_program(
                    jnp.asarray(
                        np.ascontiguousarray(
                            np.broadcast_to(
                                pw, (npos, pw.shape[0], pw.shape[1])
                            )
                        )
                    ),
                    jnp.asarray(p.scan, dtype=jnp.float32),
                    psi.shape[-2:],
                )
            )
            weights.append(cov / (cov.mean() + 1e-12))
        weights = np.asarray(weights, dtype=np.float32)
    else:
        weights = np.ones((T,) + psi.shape[-2:], dtype=np.float32)
    for p in params:
        # The periodic object-magnitude rescale fixes the psi/probe scale
        # degeneracy of STANDALONE ptychography; under ADMM the consensus
        # constraint psi = h(obj) already anchors psi's scale (|h| = 1
        # transmission), and a mid-run rescale of psi/probe would desync
        # them from hobj/lamda (observed: probe power jumps ~3x when the
        # rescale fires and the iteration diverges). Disable it.
        p.algorithm_options.rescale_period = int(1e9)
    costs = []

    for it in range(num_iter):
        # 1. Per-angle ptychography with proximal blend toward the consensus.
        angle_costs = []
        for t in range(T):
            params[t].psi = psi[t][None].copy()
            params[t].algorithm_options.num_iter = ptycho_iter
            params[t] = tp.reconstruct(data[t], params[t])
            angle_costs.append(
                float(np.mean(params[t].algorithm_options.costs[-1]))
            )
            target = hobj[t] - lamda[t] / rho
            raw = np.asarray(params[t].psi)[0]
            # Gauge fix: diffraction intensities are invariant to a global
            # phase on psi, so each angle's ptychography can drift by an
            # arbitrary constant — which log-linearizes into a constant
            # offset of phi_t that is NOT consistent across angles and
            # destroys the tomographic fit. Piston estimators (measured on
            # scripts/admm_quality.py; differences are small because the
            # benchmark is detector-bandwidth-limited, see that script):
            # - "target" (default): least-squares gauge (vdot with the
            #   consensus target) — best measured on the sharp cube
            #   phantom (0.70 vs 0.67/0.62 at 16 angles).
            # - "median": rotate by the amplitude-robust median of the
            #   pointwise phase difference to the target; tracks the air
            #   offset when the majority of the FOV is air (slightly
            #   better on smooth phantoms: 0.931 vs 0.927).
            # - "none": trust the ptychography initialization (psi=1 air
            #   anchors phase zero) and the consensus blend alone.
            if gauge == "target":
                z = np.vdot(target, raw)
                if np.abs(z) > 0:
                    raw = raw * (np.conj(z) / np.abs(z))
            elif gauge == "median":
                d = np.angle(raw * np.conj(target))
                raw = raw * np.exp(-1j * np.median(d))
            elif gauge != "none":
                raise ValueError(f"unknown gauge: {gauge!r}")
            w = weights[t]
            psi[t] = (w * raw + rho * target) / (w + rho)
        costs.append(float(np.mean(angle_costs)))

        # 2. Log-linearize the projections.
        phi = (
            -1j / k * np.log(psi + lamda / rho + 1e-12) / voxelsize
        ).astype(np.complex64)

        # 3. Fit the volume to the projections.
        result = tike_tpu.lamino.reconstruct(
            data=phi,
            theta=theta,
            tilt=tilt,
            algorithm="cgrad",
            obj=obj,
            num_iter=lamino_iter,
            eps=eps,
            upsample=upsample,
        )
        obj = result["obj"].astype(np.complex64)

        # 4. Re-project and re-exponentiate the consensus variable.
        line_integrals = np.asarray(
            lamino_fwd_p(
                cfg,
                jnp.asarray(obj, dtype=jnp.complex64),
                jnp.asarray(theta, dtype=jnp.float32),
            )
        ) * voxelsize
        hobj = np.exp(1j * k * line_integrals).astype(np.complex64)

        # 5. Dual ascent on the residual of the constraint psi = h(obj).
        # With the augmented Lagrangian written on (psi - h) — the same
        # convention as the psi-target h - lamda/rho in step 1 and the
        # fit to psi + lamda/rho in step 2 — the multiplier must ascend
        # along (psi - hobj). (The legacy reference ships this update
        # commented out with the opposite sign, `src/broken/tike.py:172`;
        # that sign makes the iteration diverge once residuals grow.)
        lamda = lamda + rho * (psi - hobj)
        logger.info(
            "ADMM iteration %d: ptycho cost %.3e", it, costs[-1]
        )

    for t in range(T):
        params[t].psi = psi[t][None]
    return {"obj": obj, "parameters": params, "costs": costs}

"""Joint ptycho-tomography by ADMM: 3D object from multi-angle scans.

Runnable equivalent of the reference's `docs/source/examples/admm.ipynb`
(the `src/broken` ADMM specification, re-derived over the tike_tpu
primitives): simulate ptychographic scans of a synthetic 3D object at
several rotation angles, then alternate per-angle ptychography, a
laminography solve that ties the projections to one volume, and the dual
update. Prints the per-iteration ptycho cost and the final volume error.

Run: python examples/admm.py  (JAX_PLATFORMS=cpu to stay on the CPU)
"""

import numpy as np

import tike_tpu.lamino
import tike_tpu.ptycho as tp
from tike_tpu.admm import reconstruct_joint_admm
from tike_tpu.constants import wavelength


def main():
    rng = np.random.default_rng(0)
    n, P, T, NPOS = 48, 12, 16, 160
    voxelsize, energy = 1e-6, 10.0

    # A smooth complex 3D object (delta + i*beta refractive contrast).
    g = np.exp(
        -((np.mgrid[0:n, 0:n, 0:n] - n / 2) ** 2).sum(0) / (n / 4) ** 2
    )
    obj_true = (1e-4 * g + 1e-5j * g).astype(np.complex64)

    # Its transmission projections at T rotation angles become the psi
    # "measurements" the per-angle ptychography solves for.
    theta = np.linspace(0, np.pi, T, endpoint=False).astype(np.float32)
    proj = tike_tpu.lamino.simulate(obj_true, theta, tilt=np.pi / 2)
    wav = wavelength(energy)
    psis = np.exp(1j * 2 * np.pi / wav * proj * voxelsize).astype(
        np.complex64
    )[:, None]

    probe = (tp.gaussian(P) * np.exp(1j * 0.1 * tp.gaussian(P)))[
        None, None, None
    ].astype(np.complex64)
    scan = np.stack(
        [rng.uniform(2, n - P - 3, NPOS), rng.uniform(2, n - P - 3, NPOS)],
        -1,
    ).astype(np.float32)

    data, params = [], []
    for t in range(T):
        data.append(tp.simulate(P, probe, scan, psis[t]).astype(np.float32))
        params.append(
            tp.PtychoParameters(
                probe=probe.copy(),
                psi=np.ones_like(psis[t]),
                scan=scan.copy(),
                algorithm_options=tp.RpieOptions(
                    num_batch=2, num_iter=2, batch_method="compact"
                ),
                object_options=tp.ObjectOptions(),
                probe_options=tp.ProbeOptions(
                    init_rescale_from_measurements=False
                ),
            )
        )

    out = reconstruct_joint_admm(
        data,
        params,
        theta,
        tilt=np.pi / 2,
        voxelsize=voxelsize,
        energy=energy,
        num_iter=10,
        ptycho_iter=3,
        lamino_iter=4,
    )
    costs = np.asarray(out["costs"], np.float64)
    print("per-iteration mean ptycho cost:", [f"{c:.3e}" for c in costs])
    obj = np.asarray(out["obj"])
    # The DC (mean) component of each projection is unobservable from
    # diffraction intensities (global-phase gauge), so compare the volume
    # modulo its mean.
    a, b = obj - obj.mean(), obj_true - obj_true.mean()
    corr = abs(np.vdot(a, b)) / (
        np.linalg.norm(a) * np.linalg.norm(b) + 1e-30
    )
    print(f"volume correlation with truth (DC removed): {corr:.3f}")
    assert np.all(np.isfinite(costs))
    assert costs[-1] < costs[0]
    assert corr > 0.5


if __name__ == "__main__":
    main()

"""Ptychography quickstart: simulate and reconstruct a siemens-star scan.

Runnable equivalent of the reference's `docs/source/examples/ptycho.ipynb`:
load the bundled measured dataset, add Hermite probe modes, reconstruct
with rPIE then refine with LSQML (+OPR and position correction), and plot.

Run: python examples/ptycho.py  (JAX_PLATFORMS=cpu to stay on the CPU)
"""

import bz2

import numpy as np

import tike_tpu.ptycho as tp

import os as _os

DATA = _os.path.join(
    _os.path.dirname(_os.path.abspath(__file__)),
    "..", "tests", "data", "siemens-star-small.npz.bz2",
)
if not _os.path.isfile(DATA):
    DATA = "/root/reference/tests/data/siemens-star-small.npz.bz2"


def load_dataset():
    with bz2.open(DATA, "rb") as f:
        archive = np.load(f)
        scan = archive["scan"][0].astype(np.float32)
        data = archive["data"][0].astype(np.float32)
        probe = archive["probe"][0].astype(np.complex64)
    scan -= np.amin(scan, axis=-2) - 20
    # 5 Cartesian-Hermite probe modes, power-balanced and orthogonalized.
    probe = tp.add_modes_cartesian_hermite(probe, 5)
    probe = np.asarray(tp.adjust_probe_power(probe))
    probe, _ = tp.orthogonalize_eig(probe)
    probe = np.asarray(probe)
    w = probe.shape[-1]
    h = int(np.ceil(scan[:, 0].max())) + w + 20
    ww = int(np.ceil(scan[:, 1].max())) + w + 20
    psi = np.full((1, h, ww), 0.5 + 0j, dtype=np.complex64)
    return data, scan, probe, psi


def main():
    data, scan, probe, psi = load_dataset()

    # Stage 1: rPIE warm-up.
    parameters = tp.PtychoParameters(
        probe=probe,
        psi=psi,
        scan=scan,
        algorithm_options=tp.RpieOptions(num_batch=5, num_iter=16),
        object_options=tp.ObjectOptions(),
        probe_options=tp.ProbeOptions(),
    )
    parameters = tp.reconstruct(data, parameters)

    # Stage 2: LSQML with variable probe (OPR) + position correction.
    eigen_probe, eigen_weights = tp.init_varying_probe(
        scan, parameters.probe, num_eigen_probes=2,
        probes_with_modes=parameters.probe.shape[-3],
    )
    parameters.eigen_probe = eigen_probe
    parameters.eigen_weights = eigen_weights
    parameters.position_options = tp.PositionOptions(
        initial_scan=parameters.scan.copy(), update_magnitude_limit=2.0
    )
    parameters.algorithm_options = tp.LstsqOptions(
        num_batch=5, num_iter=16, convergence_window=8
    )
    parameters = tp.reconstruct(data, parameters)

    costs = [float(np.mean(c)) for c in parameters.algorithm_options.costs]
    print("cost series:", " ".join(f"{c:1.3e}" for c in costs))

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        import tike_tpu.view

        fig, ax = plt.subplots(1, 2, figsize=(10, 5))
        ax[0].imshow(np.angle(parameters.psi[0]), cmap="twilight")
        ax[0].set_title("object phase")
        ax[1].imshow(tike_tpu.view.complexHSV_to_RGB(parameters.probe[0, 0, 0]))
        ax[1].set_title("probe mode 0")
        fig.savefig("ptycho_example.png", dpi=120)
        print("wrote ptycho_example.png")
    except ImportError:
        pass


if __name__ == "__main__":
    main()

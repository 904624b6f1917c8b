"""Shared ptychography test fixtures.

Mirrors `upstream/tests/ptycho/templates.py`: load the bundled
siemens-star dataset, add 5 Cartesian-Hermite probe modes, and run
reconstructions twice to prove warm-restart consistency.
"""

import bz2
import os

import numpy as np

import tike_tpu.ptycho as tp

# The dataset is vendored in-repo (the reference ships it in its own
# tests/data); fall back to the reference mount if the local copy is gone.
_LOCAL = os.path.join(os.path.dirname(__file__), "..", "data")
DATA_FILE = os.path.abspath(
    os.path.join(_LOCAL, "siemens-star-small.npz.bz2")
)
if not os.path.isfile(DATA_FILE):
    DATA_FILE = "/root/reference/tests/data/siemens-star-small.npz.bz2"


def siemens_star_data(filename=DATA_FILE):
    """Return (data, scan, probe, psi) for function-style tests."""
    setup = SiemensStarSetup()
    setup.setUp(filename)
    return setup.data, setup.scan, setup.probe, setup.psi


class SiemensStarSetup:
    """Load the siemens-star dataset like the reference test fixture."""

    def setUp(self, filename=DATA_FILE):
        with bz2.open(filename, "rb") as f:
            archive = np.load(f)
            self.scan = archive["scan"][0]
            self.data = archive["data"][0].astype(np.float32)
            self.probe = archive["probe"][0]
        self.scan -= np.amin(self.scan, axis=-2) - 20
        self.scan = self.scan.astype(np.float32)
        self.probe = tp.add_modes_cartesian_hermite(self.probe, 5)
        self.probe = np.asarray(tp.adjust_probe_power(self.probe))
        probe, _ = tp.orthogonalize_eig(self.probe)
        self.probe = np.asarray(probe)
        self.psi = np.full((1, 600, 600), 0.5 + 0j, dtype=np.complex64)


def siemens_star_subset(n_keep=160, filename=DATA_FILE):
    """A small spatial subset of the siemens-star scan for fast tests.

    Keeps the ``n_keep`` positions nearest the scan median and crops the
    object to the covered region, cutting solver test wall time ~10x while
    exercising the same real measured data.
    """
    setup = SiemensStarSetup()
    setup.setUp(filename)
    scan, data, probe = setup.scan, setup.data, setup.probe
    center = np.median(scan, axis=0)
    keep = np.argsort(np.max(np.abs(scan - center), axis=1))[:n_keep]
    scan = scan[keep] - np.amin(scan[keep], axis=0) + 20
    data = np.ascontiguousarray(data[keep])
    w = probe.shape[-1]
    # Even dimensions so multigrid resampling round-trips exactly.
    hh = (int(np.ceil(scan[:, 0].max())) + w + 22) // 2 * 2
    ww = (int(np.ceil(scan[:, 1].max())) + w + 22) // 2 * 2
    psi = np.full((1, hh, ww), 0.5 + 0j, dtype=np.complex64)
    return data, scan.astype(np.float32), probe, psi


class ReconstructTwice:
    """Call reconstruct twice in a loop to check continuation correctness."""

    def template_consistent_algorithm(self, *, data, params):
        for _ in range(2):
            params = tp.reconstruct(data=data, parameters=params)
        costs = [c[0] for c in params.algorithm_options.costs]
        print()
        print("\n".join(f"{c:1.3e}" for c in costs))
        # The cost should be reduced from the starting value and be finite.
        assert np.all(np.isfinite(costs)), costs
        assert costs[-1] < costs[0], costs
        return params

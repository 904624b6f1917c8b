"""Integration tests for ptychography reconstruction.

Mirrors the reference strategy (`upstream/tests/ptycho/test_ptycho.py`):
consistency (reconstruct twice, cost decreasing and finite) across solver ×
noise model × option combinations, on the bundled siemens-star dataset.
Epoch counts are kept small for CPU CI speed.
"""

import unittest

import numpy as np
import pytest

import tike_tpu.ptycho as tp

from .templates import ReconstructTwice, siemens_star_subset

NUM_EPOCH = 2


class TestPtychoRecon(ReconstructTwice, unittest.TestCase):
    """Solver x noise-model x option consistency matrix.

    Runs on the 160-position spatial subset of the measured siemens-star
    scan (same data as the reference's full-suite fixture, ~10x faster),
    covering the reference's parametrized matrix at
    `upstream/tests/ptycho/test_ptycho.py:270-670`.
    """

    def setUp(self):
        self.data, self.scan, self.probe, self.psi = siemens_star_subset()

    def _params(self, algorithm_options, probe_options=None, **kwargs):
        return tp.PtychoParameters(
            probe=self.probe.copy(),
            psi=self.psi.copy(),
            scan=self.scan.copy(),
            algorithm_options=algorithm_options,
            object_options=kwargs.pop("object_options", tp.ObjectOptions()),
            probe_options=probe_options,
            **kwargs,
        )

    def test_consistent_rpie(self):
        params = self._params(
            tp.RpieOptions(num_batch=5, num_iter=NUM_EPOCH),
            probe_options=tp.ProbeOptions(force_orthogonality=True),
        )
        self.template_consistent_algorithm(data=self.data, params=params)

    @pytest.mark.slow
    def test_consistent_rpie_off(self):
        """Probe recovery disabled."""
        params = self._params(
            tp.RpieOptions(num_batch=5, num_iter=NUM_EPOCH),
            probe_options=None,
        )
        self.template_consistent_algorithm(data=self.data, params=params)

    @pytest.mark.slow
    def test_consistent_rpie_poisson(self):
        params = self._params(
            tp.RpieOptions(num_batch=5, num_iter=NUM_EPOCH),
            probe_options=tp.ProbeOptions(),
            exitwave_options=tp.ExitWaveOptions(
                measured_pixels=np.ones(
                    self.probe.shape[-2:], dtype=np.bool_
                ),
                noise_model="poisson",
            ),
        )
        self.template_consistent_algorithm(data=self.data, params=params)

    @pytest.mark.slow
    def test_consistent_rpie_compact(self):
        params = self._params(
            tp.RpieOptions(
                num_batch=5, num_iter=NUM_EPOCH, batch_method="compact"
            ),
            probe_options=tp.ProbeOptions(use_adaptive_moment=True),
            object_options=tp.ObjectOptions(use_adaptive_moment=True),
        )
        self.template_consistent_algorithm(data=self.data, params=params)

    def test_consistent_lstsq(self):
        params = self._params(
            tp.LstsqOptions(num_batch=5, num_iter=NUM_EPOCH),
            probe_options=tp.ProbeOptions(force_orthogonality=True),
        )
        self.template_consistent_algorithm(data=self.data, params=params)

    @pytest.mark.slow
    def test_consistent_lstsq_poisson_dominant(self):
        params = self._params(
            tp.LstsqOptions(num_batch=5, num_iter=NUM_EPOCH),
            probe_options=tp.ProbeOptions(),
            exitwave_options=tp.ExitWaveOptions(
                measured_pixels=np.ones(
                    self.probe.shape[-2:], dtype=np.bool_
                ),
                noise_model="poisson",
                step_length_usemodes="dominant_mode",
            ),
        )
        self.template_consistent_algorithm(data=self.data, params=params)

    @pytest.mark.slow
    def test_consistent_lstsq_compact_momentum(self):
        params = self._params(
            tp.LstsqOptions(
                num_batch=5, num_iter=NUM_EPOCH, batch_method="compact"
            ),
            probe_options=tp.ProbeOptions(use_adaptive_moment=True),
            object_options=tp.ObjectOptions(use_adaptive_moment=True),
        )
        self.template_consistent_algorithm(data=self.data, params=params)

    @pytest.mark.slow
    def test_consistent_rpie_poisson_dominant(self):
        """rPIE + poisson + dominant-mode step lengths
        (`test_ptycho.py:490`)."""
        params = self._params(
            tp.RpieOptions(num_batch=5, num_iter=NUM_EPOCH),
            probe_options=tp.ProbeOptions(),
            exitwave_options=tp.ExitWaveOptions(
                measured_pixels=np.ones(
                    self.probe.shape[-2:], dtype=np.bool_
                ),
                noise_model="poisson",
                step_length_usemodes="dominant_mode",
            ),
        )
        self.template_consistent_algorithm(data=self.data, params=params)

    @pytest.mark.slow
    def test_consistent_lstsq_poisson_allmodes(self):
        """LSQML + poisson + all-modes step lengths
        (`test_ptycho.py:270`)."""
        params = self._params(
            tp.LstsqOptions(num_batch=5, num_iter=NUM_EPOCH),
            probe_options=tp.ProbeOptions(),
            exitwave_options=tp.ExitWaveOptions(
                measured_pixels=np.ones(
                    self.probe.shape[-2:], dtype=np.bool_
                ),
                noise_model="poisson",
                step_length_usemodes="all_modes",
            ),
        )
        self.template_consistent_algorithm(data=self.data, params=params)

    @pytest.mark.slow
    def test_consistent_lstsq_masked_detector(self):
        """LSQML with unmeasured detector regions (`test_ptycho.py:324`)."""
        mask = np.ones(self.probe.shape[-2:], dtype=np.bool_)
        c = mask.shape[0] // 2
        mask[c - 3 : c + 3, c - 3 : c + 3] = False
        params = self._params(
            tp.LstsqOptions(num_batch=5, num_iter=NUM_EPOCH),
            probe_options=tp.ProbeOptions(),
            exitwave_options=tp.ExitWaveOptions(
                measured_pixels=mask,
                noise_model="gaussian",
                unmeasured_pixels_scaling=0.95,
            ),
        )
        self.template_consistent_algorithm(data=self.data, params=params)

    @pytest.mark.slow
    def test_consistent_lstsq_no_probe(self):
        """LSQML with probe recovery off (`test_ptycho.py:390`)."""
        params = self._params(
            tp.LstsqOptions(num_batch=5, num_iter=NUM_EPOCH),
            probe_options=None,
        )
        self.template_consistent_algorithm(data=self.data, params=params)

    @pytest.mark.slow
    def test_consistent_rpie_compact_no_probe(self):
        """Compact rPIE with probe recovery off (`test_ptycho.py:651`)."""
        params = self._params(
            tp.RpieOptions(
                num_batch=5, num_iter=NUM_EPOCH, batch_method="compact"
            ),
            probe_options=None,
        )
        self.template_consistent_algorithm(data=self.data, params=params)

    def _variable_probe_kwargs(self):
        """One eigen component + per-position weights (OPR), initialized
        like the reference (`probe.py:660-723`)."""
        m = self.probe.shape[-3]
        eigen_probe, weights = tp.init_varying_probe(
            self.scan,
            self.probe,
            num_eigen_probes=2,
            probes_with_modes=m,
            rng=np.random.default_rng(7),
        )
        return dict(eigen_probe=eigen_probe, eigen_weights=weights)

    def test_consistent_rpie_variable_probe(self):
        """rPIE with OPR (eigen probe + weights), like the reference's
        variable-probe cases (`test_ptycho.py:270-670`)."""
        params = self._params(
            tp.RpieOptions(num_batch=5, num_iter=NUM_EPOCH),
            probe_options=tp.ProbeOptions(),
            **self._variable_probe_kwargs(),
        )
        result = self.template_consistent_algorithm(
            data=self.data, params=params
        )
        assert np.all(np.isfinite(np.asarray(result.eigen_weights)))

    @pytest.mark.slow
    def test_consistent_lstsq_variable_probe(self):
        params = self._params(
            tp.LstsqOptions(num_batch=5, num_iter=NUM_EPOCH),
            probe_options=tp.ProbeOptions(),
            **self._variable_probe_kwargs(),
        )
        result = self.template_consistent_algorithm(
            data=self.data, params=params
        )
        assert np.all(np.isfinite(np.asarray(result.eigen_probe)))
        assert np.all(np.isfinite(np.asarray(result.eigen_weights)))

    def test_lstsq_multislice_rejected(self):
        """LSQML asserts single-slice, like the reference; rPIE handles
        multislice (`tests/ptycho/test_multislice_recon.py`)."""
        params = tp.PtychoParameters(
            probe=self.probe.copy(),
            psi=np.concatenate([self.psi, self.psi]),
            scan=self.scan.copy(),
            algorithm_options=tp.LstsqOptions(
                num_batch=5, num_iter=1
            ),
            object_options=tp.ObjectOptions(),
            probe_options=tp.ProbeOptions(),
        )
        with self.assertRaises(AssertionError):
            tp.reconstruct(data=self.data, parameters=params)

    @pytest.mark.slow
    def test_consistent_rpie_masked_detector(self):
        mask = np.ones(self.probe.shape[-2:], dtype=np.bool_)
        mask[40:50, 40:50] = False  # dead detector region
        params = self._params(
            tp.RpieOptions(num_batch=5, num_iter=NUM_EPOCH),
            probe_options=tp.ProbeOptions(),
            exitwave_options=tp.ExitWaveOptions(
                measured_pixels=mask, noise_model="gaussian"
            ),
        )
        self.template_consistent_algorithm(data=self.data, params=params)


class TestPtychoSimulate(unittest.TestCase):
    def test_simulate_round_trip_cost_is_zero(self):
        """A reconstruction's forward model must reproduce its own simulate."""
        rng = np.random.default_rng(0)
        P, HW, N = 16, 96, 64
        yy, xx = np.mgrid[0:HW, 0:HW] / HW
        psi = np.exp(1j * np.sin(5 * yy) * np.cos(3 * xx)).astype(
            np.complex64
        )[None]
        probe = (tp.gaussian(P) * (1 + 0j))[None, None, None].astype(
            np.complex64
        )
        scan = np.stack(
            [rng.uniform(2, HW - P - 3, N), rng.uniform(2, HW - P - 3, N)],
            -1,
        ).astype(np.float32)
        data = tp.simulate(P, probe, scan, psi)
        assert data.shape == (N, P, P)
        assert np.all(data >= 0)
        # Energy conservation: ortho FFT means sum(data) == sum |exitwave|^2.
        from tike_tpu.ops import PtychoConfig, multislice_fwd
        import jax.numpy as jnp

        cfg = PtychoConfig(
            probe_shape=P, detector_shape=P, nz=HW, n=HW
        )
        exitwave, _ = multislice_fwd(
            cfg, jnp.asarray(psi), jnp.asarray(scan), jnp.asarray(probe[0, 0])
        )
        np.testing.assert_allclose(
            data.sum(),
            float(jnp.sum(jnp.abs(exitwave) ** 2)),
            rtol=1e-4,
        )


def test_replicated_host_streaming_matches_device_resident():
    """store_data_on_device=False (double-buffered host streaming) matches
    the device-resident per-epoch path on the replicated layout (the
    reference's pinned-memory streaming role, `stream.py`)."""
    import numpy as np
    import tike_tpu.ptycho as tp
    from .templates import siemens_star_subset

    data, scan, probe, psi = siemens_star_subset()

    def run(on_device):
        params = tp.PtychoParameters(
            psi=psi.copy(),
            probe=probe.copy(),
            scan=scan.copy(),
            algorithm_options=tp.RpieOptions(
                num_iter=3, num_batch=3, batch_method="compact"
            ),
            object_options=tp.ObjectOptions(),
            probe_options=tp.ProbeOptions(
                init_rescale_from_measurements=False
            ),
        )
        with tp.Reconstruction(
            data,
            params,
            random_seed=0,
            store_data_on_device=on_device,
        ) as ctx:
            ctx.iterate(3)
            return ctx.get_result()

    d = run(True)
    h = run(False)
    cd = [float(np.mean(c)) for c in d.algorithm_options.costs]
    ch = [float(np.mean(c)) for c in h.algorithm_options.costs]
    np.testing.assert_allclose(ch, cd, rtol=1e-4)
    np.testing.assert_allclose(
        np.asarray(h.psi), np.asarray(d.psi), rtol=1e-3, atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(h.probe), np.asarray(d.probe), rtol=1e-3, atol=1e-5
    )


if __name__ == "__main__":
    unittest.main()

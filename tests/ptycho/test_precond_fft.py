"""FFT-formulation preconditioners match the gather formulation exactly.

The FFT forms re-express the same interp-then-square math
(`upstream/src/tike/ptycho/solvers/_preconditioner.py:48-167`) as
point densities convolved/correlated with full-object fields, so they must
agree with the per-patch gather versions to float32 rounding.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from tike_tpu.ops.ptycho import PtychoConfig
from tike_tpu.ptycho.solvers._preconditioner import (
    _probe_precond_fft_math,
    _probe_precond_math,
    _psi_precond_fft_math,
    _psi_precond_math,
)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(7)
    H, W, P, N, M = 200, 170, 32, 300, 2
    cfg = PtychoConfig(probe_shape=P, detector_shape=P, nz=H, n=W)
    psi = (
        rng.standard_normal((1, H, W)) + 1j * rng.standard_normal((1, H, W))
    ).astype(np.complex64)
    probe = (
        rng.standard_normal((1, 1, M, P, P))
        + 1j * rng.standard_normal((1, 1, M, P, P))
    ).astype(np.complex64)
    scan = np.stack(
        [
            rng.uniform(2, H - P - 3, N),
            rng.uniform(2, W - P - 3, N),
        ],
        -1,
    ).astype(np.float32)
    # Mixed mask: some zero-weight (padded) slots must drop out.
    w = (rng.random(N) > 0.2).astype(np.float32)
    return cfg, jnp.asarray(psi), jnp.asarray(probe), jnp.asarray(scan), jnp.asarray(w)


def test_psi_preconditioner_fft_matches_gather(setup):
    cfg, psi, probe, scan, w = setup
    ref = _psi_precond_math(cfg, psi, scan, probe, w)
    fft = _psi_precond_fft_math(cfg, scan, probe, w)
    assert fft.shape == ref.shape
    np.testing.assert_allclose(
        np.asarray(fft),
        np.asarray(ref),
        rtol=2e-4,
        atol=2e-3 * float(jnp.max(jnp.abs(ref))),
    )


def test_probe_preconditioner_fft_matches_gather(setup):
    cfg, psi, probe, scan, w = setup
    ref = _probe_precond_math(cfg, psi, scan, w)
    fft = _probe_precond_fft_math(cfg, psi, scan, w)
    assert fft.shape == ref.shape
    np.testing.assert_allclose(
        np.asarray(fft),
        np.asarray(ref),
        rtol=2e-4,
        atol=2e-3 * float(jnp.max(jnp.abs(ref))),
    )


def test_probe_preconditioner_fft_integer_positions(setup):
    """Integer positions (all fractional weights 0/1) are the degenerate
    corner of the bilinear cross terms."""
    cfg, psi, probe, scan, w = setup
    scan_i = jnp.floor(scan)
    ref = _probe_precond_math(cfg, psi, scan_i, w)
    fft = _probe_precond_fft_math(cfg, psi, scan_i, w)
    np.testing.assert_allclose(
        np.asarray(fft),
        np.asarray(ref),
        rtol=2e-4,
        atol=2e-3 * float(jnp.max(jnp.abs(ref))),
    )


def test_reconstruction_with_fft_precond_matches_default(monkeypatch):
    """A full fused LSQML reconstruction with the FFT preconditioners
    tracks the gather-formulation run (same math, f32 rounding only)."""
    import tike_tpu.ptycho as tp
    import tike_tpu.ptycho.solvers._preconditioner as pc

    from .templates import siemens_star_subset

    data, scan, probe, psi = siemens_star_subset(n_keep=96)

    def run():
        params = tp.PtychoParameters(
            probe=probe,
            psi=psi,
            scan=scan,
            algorithm_options=tp.LstsqOptions(num_batch=3, num_iter=1),
            object_options=tp.ObjectOptions(),
            probe_options=tp.ProbeOptions(),
        )
        with tp.Reconstruction(data, params, random_seed=0) as context:
            context.iterate(4)
            out = context.get_result()
        return [c[0] for c in out.algorithm_options.costs], out.psi

    costs_ref, psi_ref = run()
    monkeypatch.setattr(pc, "USE_FFT_PRECOND", True)
    costs_fft, psi_fft = run()

    np.testing.assert_allclose(costs_fft, costs_ref, rtol=1e-3)
    np.testing.assert_allclose(psi_fft, psi_ref, rtol=1e-2, atol=1e-2)

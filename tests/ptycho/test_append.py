"""Online reconstruction: Reconstruction.append_new_data.

The reference defines this API but ships it disabled
(`upstream/src/tike/ptycho/ptycho.py:646-721`); tike_tpu implements
it. These tests check the documented semantics: data/scan grow, mini-batches
re-cluster, eigen weights pad with their means, position state extends, and
iteration resumes from the carried-over solver state.
"""

import numpy as np
import pytest

import tike_tpu.ptycho as tp

from .templates import siemens_star_subset


def _halves(data, scan):
    """Interleaved halves so both cover the full field of view."""
    first = np.arange(0, len(scan), 2)
    second = np.arange(1, len(scan), 2)
    return (data[first], scan[first]), (data[second], scan[second])


def test_append_new_data_resumes_and_converges():
    data, scan, probe, psi = siemens_star_subset(n_keep=96)
    (d1, s1), (d2, s2) = _halves(data, scan)

    params = tp.PtychoParameters(
        probe=probe,
        psi=psi,
        scan=s1,
        algorithm_options=tp.RpieOptions(num_batch=3, num_iter=1),
        object_options=tp.ObjectOptions(),
        probe_options=tp.ProbeOptions(),
    )
    context = tp.Reconstruction(d1, params)
    context.__enter__()
    context.iterate(4)
    costs_before = [c[0] for c in context.parameters.algorithm_options.costs]

    context.append_new_data(d2, s2)
    assert context.data_host.shape[0] == len(scan)
    assert context.parameters_host.scan.shape[0] == len(scan)
    context.iterate(6)
    result = context.get_result()
    context.__exit__(None, None, None)

    costs = [c[0] for c in result.algorithm_options.costs]
    # History carries over and iteration continues to converge on the
    # enlarged dataset.
    assert costs[: len(costs_before)] == costs_before
    assert costs[-1] < costs[len(costs_before)]
    assert result.scan.shape == (len(scan), 2)
    assert np.all(np.isfinite(result.psi))


def test_append_new_data_extends_per_position_state():
    data, scan, probe, psi = siemens_star_subset(n_keep=64)
    (d1, s1), (d2, s2) = _halves(data, scan)

    eigen_probe, eigen_weights = tp.init_varying_probe(
        s1, probe, num_eigen_probes=2
    )
    params = tp.PtychoParameters(
        probe=probe,
        psi=psi,
        scan=s1,
        eigen_probe=eigen_probe,
        eigen_weights=eigen_weights,
        algorithm_options=tp.LstsqOptions(num_batch=2, num_iter=1),
        object_options=tp.ObjectOptions(),
        probe_options=tp.ProbeOptions(),
        position_options=tp.PositionOptions(
            s1, use_adaptive_moment=True
        ),
    )
    context = tp.Reconstruction(data=d1, parameters=params)
    context.__enter__()
    context.iterate(2)
    context.append_new_data(d2, s2)

    p = context.parameters_host
    n = len(s1) + len(s2)
    assert p.eigen_weights.shape[0] == n
    # New rows are the column means of the existing weights (reference
    # semantics: np.pad mode='mean').
    np.testing.assert_allclose(
        p.eigen_weights[len(s1):],
        np.broadcast_to(
            p.eigen_weights[: len(s1)].mean(axis=0, keepdims=True),
            (len(s2), *p.eigen_weights.shape[1:]),
        ),
        rtol=1e-5,
    )
    popt = p.position_options
    assert popt.initial_scan.shape == (n, 2)
    assert popt.confidence.shape == (n, 2)
    assert popt._momentum.shape == (n, 4)
    # Appended momentum starts at rest.
    assert np.all(popt._momentum[len(s1):] == 0)
    # The probe must not be re-rescaled from measurements on re-entry.
    assert p.probe_options.init_rescale_from_measurements is False

    context.iterate(2)
    result = context.get_result()
    context.__exit__(None, None, None)
    assert np.all(np.isfinite(result.psi))
    assert result.eigen_weights.shape[0] == n


def test_append_new_data_validates_shapes():
    data, scan, probe, psi = siemens_star_subset(n_keep=32)
    params = tp.PtychoParameters(
        probe=probe,
        psi=psi,
        scan=scan,
        algorithm_options=tp.RpieOptions(num_batch=2, num_iter=1),
        object_options=tp.ObjectOptions(),
    )
    context = tp.Reconstruction(data, params)
    context.__enter__()
    with pytest.raises(ValueError, match="incompatible"):
        context.append_new_data(data[:4], scan[:3])
    with pytest.raises(ValueError, match="detector"):
        context.append_new_data(data[:4, :-2, :-2], scan[:4])
    context.__exit__(None, None, None)

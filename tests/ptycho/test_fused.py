"""Fused multi-epoch program parity and OPR (eigen probe) reconstruction.

The fused path (`tike_tpu/ptycho/solvers/fused.py`) folds whole epochs into
one XLA program; these tests pin it to the per-epoch reference path
bit-for-bit (same seed => same batches) for both solvers, mirroring how the
reference validates solver variants against each other on the siemens-star
dataset (`upstream/tests/test_ptycho.py`). Variants cover the probe
update schedule (update_period > 1) and in-program position correction.
"""

import numpy as np
import pytest

import tike_tpu.ptycho as tp

from .templates import siemens_star_subset


def _run(
    algo_cls,
    fused: bool,
    eigen: bool = False,
    num_iter: int = 3,
    update_period: int = 1,
    positions: bool = False,
    positions_adam: bool = False,
    convergence_window: int = 0,
    batch_method: str = "compact",
    obj_adaptive: bool = False,
    probe_adaptive: bool = False,
    rescale_method: str = "mean_of_abs_object",
    rescale_period: int = 10,
):
    data, scan, probe, psi = siemens_star_subset()
    kwargs = {}
    if eigen:
        n = scan.shape[0]
        m = probe.shape[-3]
        kwargs["eigen_probe"] = 0.01 * probe[:, :1, :1].repeat(1, axis=-4)
        weights = np.zeros((n, 2, m), np.float32)
        weights[:, 0, :] = 1.0
        kwargs["eigen_weights"] = weights
    if positions:
        kwargs["position_options"] = tp.PositionOptions(
            initial_scan=scan,
            use_adaptive_moment=positions_adam,
            update_magnitude_limit=2.0,
        )
    params = tp.PtychoParameters(
        psi=psi,
        probe=probe,
        scan=scan,
        algorithm_options=algo_cls(
            num_iter=num_iter,
            num_batch=4,
            batch_method=batch_method,
            convergence_window=convergence_window,
            rescale_method=rescale_method,
            rescale_period=rescale_period,
        ),
        object_options=tp.ObjectOptions(use_adaptive_moment=obj_adaptive),
        probe_options=tp.ProbeOptions(
            update_period=update_period,
            use_adaptive_moment=probe_adaptive,
            probe_photons=(
                1e6 if rescale_method == "constant_probe_photons" else np.nan
            ),
        ),
        **kwargs,
    )
    with tp.Reconstruction(
        data=data, parameters=params, random_seed=42
    ) as context:
        if not fused:
            context._fused_eligible = lambda: False
        else:
            assert context._fused_eligible()
        context.iterate(num_iter)
        result = context.get_result()
    costs = [float(np.mean(c)) for c in result.algorithm_options.costs]
    return (
        costs,
        np.asarray(result.psi),
        np.asarray(result.probe),
        np.asarray(result.scan),
    )


# The fast set pins one variant per solver; the remaining schedule/momentum
# variants run with `-m slow`.
_FAST = {("rpie", "plain")}
_CASES = [
    pytest.param(
        algo_cls,
        variant,
        id=f"{algo_id}-{variant}",
        marks=[] if (algo_id, variant) in _FAST else [pytest.mark.slow],
    )
    for algo_cls, algo_id in [
        (tp.RpieOptions, "rpie"),
        (tp.LstsqOptions, "lstsq"),
    ]
    for variant in ["plain", "period2", "positions", "positions_adam"]
]


@pytest.mark.parametrize("algo_cls,variant", _CASES)
def test_fused_matches_per_epoch(algo_cls, variant):
    """One fused program == the per-epoch driver loop, same seed."""
    if variant.startswith("positions") and algo_cls is tp.RpieOptions:
        pytest.skip("position correction is lstsq-only (like the reference)")
    kw = dict(
        update_period=2 if variant == "period2" else 1,
        positions=variant.startswith("positions"),
        positions_adam=variant == "positions_adam",
        num_iter=4 if variant == "period2" else 3,
    )
    cf, psi_f, probe_f, scan_f = _run(algo_cls, fused=True, **kw)
    cu, psi_u, probe_u, scan_u = _run(algo_cls, fused=False, **kw)
    np.testing.assert_allclose(cf, cu, rtol=1e-3)
    scale = np.max(np.abs(psi_u))
    assert np.max(np.abs(psi_f - psi_u)) / scale < 1e-3
    pscale = np.max(np.abs(probe_u))
    assert np.max(np.abs(probe_f - probe_u)) / pscale < 1e-3
    if variant.startswith("positions"):
        # The two paths moved the positions identically.
        assert np.max(np.abs(scan_u - scan_f)) < 1e-3


# Adaptive-moment configurations: compact -> momentum_checked (the traced
# epoch-cost-trend decision), non-compact -> per-batch adam (rPIE) /
# classical momentum (LSQML). One fast case per solver; the rest slow.
_MOM_FAST = set()  # all moment variants run with -m slow
_MOM_CASES = [
    pytest.param(
        algo_cls,
        variant,
        id=f"{algo_id}-{variant}",
        marks=[]
        if (algo_id, variant) in _MOM_FAST
        else [pytest.mark.slow],
    )
    for algo_cls, algo_id in [
        (tp.RpieOptions, "rpie"),
        (tp.LstsqOptions, "lstsq"),
    ]
    for variant in ["adam", "checked", "checked_probe"]
]


@pytest.mark.parametrize("algo_cls,variant", _MOM_CASES)
def test_fused_adaptive_moments_match_per_epoch(algo_cls, variant):
    """Fused adaptive-moment configs == the per-epoch path, same seed.

    'adam' = non-compact batches (per-batch adam / classical momentum);
    'checked' = compact batches with object momentum_checked;
    'checked_probe' adds the probe momentum too. Five epochs so the
    cost-trend decision actually fires at least once.
    """
    kw = dict(
        batch_method=(
            "wobbly_center" if variant == "adam" else "compact"
        ),
        obj_adaptive=True,
        probe_adaptive=variant == "checked_probe" or variant == "adam",
        num_iter=5,
    )
    cf, psi_f, probe_f, _ = _run(algo_cls, fused=True, **kw)
    cu, psi_u, probe_u, _ = _run(algo_cls, fused=False, **kw)
    np.testing.assert_allclose(cf, cu, rtol=1e-3)
    scale = np.max(np.abs(psi_u))
    assert np.max(np.abs(psi_f - psi_u)) / scale < 2e-3
    pscale = np.max(np.abs(probe_u))
    assert np.max(np.abs(probe_f - probe_u)) / pscale < 2e-3


@pytest.mark.slow
def test_fused_positions_actually_move():
    """The fused position path produces a nonzero update."""
    _, _, _, scan_f = _run(
        tp.LstsqOptions, fused=True, positions=True, num_iter=3
    )
    data, scan0, _, _ = siemens_star_subset()
    assert np.max(np.abs(scan_f - scan0)) > 1e-4


@pytest.mark.slow
def test_fused_convergence_window_chunks_match():
    """Chunked fused runs (convergence_window early-stop path) == one run.

    With the compact batch method the batch order is deterministic, so
    running 4 epochs as two 2-epoch fused programs must reproduce the
    single 4-epoch program exactly; the cost history also feeds
    tike_tpu.opt.is_converged between chunks.
    """
    c1, psi1, probe1, _ = _run(tp.RpieOptions, fused=True, num_iter=4)
    c2, psi2, probe2, _ = _run(
        tp.RpieOptions, fused=True, num_iter=4, convergence_window=4
    )
    assert len(c2) <= len(c1)  # early stop may trigger, never overruns
    n = len(c2)
    np.testing.assert_allclose(c1[:n], c2, rtol=1e-5)
    if n == len(c1):
        np.testing.assert_allclose(psi1, psi2, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(probe1, probe2, rtol=1e-5, atol=1e-6)


def test_fused_lstsq_eigen_converges():
    """Fused LSQML with OPR (eigen probe + weights) reduces the cost."""
    costs, psi, probe, _ = _run(
        tp.LstsqOptions, fused=True, eigen=True, num_iter=4
    )
    assert np.all(np.isfinite(costs))
    assert costs[-1] < costs[0] / 2
    assert np.all(np.isfinite(psi)) and np.all(np.isfinite(probe))


@pytest.mark.parametrize("algo_cls", [tp.RpieOptions, tp.LstsqOptions])
def test_fused_constant_probe_photons_matches_per_epoch(algo_cls):
    """rescale_method='constant_probe_photons' runs inside the fused
    program (reference applies it every rescale_period epochs,
    `ptycho/ptycho.py:783-795`) and matches the per-epoch path."""
    f = _run(
        algo_cls, fused=True,
        rescale_method="constant_probe_photons", rescale_period=2,
        num_iter=4,
    )
    p = _run(
        algo_cls, fused=False,
        rescale_method="constant_probe_photons", rescale_period=2,
        num_iter=4,
    )
    np.testing.assert_allclose(f[0], p[0], rtol=1e-4)  # costs
    np.testing.assert_allclose(f[2], p[2], rtol=1e-3, atol=1e-5)  # probe
    np.testing.assert_allclose(f[1], p[1], rtol=1e-3, atol=1e-5)  # psi
    # Photon counts agree between the paths (the count is pinned at each
    # rescale instant; subsequent probe updates drift it identically).
    np.testing.assert_allclose(
        np.sum(np.abs(f[2]) ** 2), np.sum(np.abs(p[2]) ** 2), rtol=1e-4
    )

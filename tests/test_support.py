"""Tests for support modules: linalg, opt, cluster, scan, trajectory, random.

Mirrors the reference's `test_linalg.py`, `test_opt.py`, `test_random.py`,
`test_trajectory.py` coverage.
"""

import numpy as np
import jax.numpy as jnp

import tike_tpu.cluster
import tike_tpu.linalg as la
import tike_tpu.opt
import tike_tpu.random
import tike_tpu.scan
import tike_tpu.trajectory


class TestLinalg:
    def test_norm_inner_consistency(self):
        rng = np.random.default_rng(0)
        x = (rng.standard_normal(64) + 1j * rng.standard_normal(64)).astype(
            np.complex64
        )
        n2 = float(la.norm(jnp.asarray(x))) ** 2
        ip = complex(la.inner(jnp.asarray(x), jnp.asarray(x)))
        np.testing.assert_allclose(n2, ip.real, rtol=1e-5)
        assert abs(ip.imag) < 1e-3

    def test_lstsq_solves_small_system(self):
        rng = np.random.default_rng(1)
        a = rng.standard_normal((5, 8, 3)).astype(np.float32)
        x_true = rng.standard_normal((5, 3, 2)).astype(np.float32)
        b = a @ x_true
        x = la.lstsq(jnp.asarray(a), jnp.asarray(b))
        np.testing.assert_allclose(np.asarray(x), x_true, rtol=1e-3, atol=1e-4)

    def test_orthogonalize_gs(self):
        rng = np.random.default_rng(2)
        x = (
            rng.standard_normal((4, 16)) + 1j * rng.standard_normal((4, 16))
        ).astype(np.complex64)
        u = np.asarray(la.orthogonalize_gs(jnp.asarray(x), axis=-1))
        gram = np.conj(u) @ u.T
        off = gram - np.diag(np.diag(gram))
        assert np.abs(off).max() < 1e-3

    def test_projection(self):
        a = jnp.asarray(np.array([1.0, 2.0, 3.0], np.float32))
        b = jnp.asarray(np.array([1.0, 0.0, 0.0], np.float32))
        p = np.asarray(la.projection(a, b))
        np.testing.assert_allclose(p, [1.0, 0, 0], atol=1e-6)


class TestOpt:
    def test_adam_direction_descends_quadratic(self):
        x = jnp.asarray(np.array([5.0, -3.0], np.float32))
        v = m = None
        for _ in range(200):
            g = 2 * x
            d, v, m = tike_tpu.opt.adam(g, v, m)
            x = x - 0.1 * d
        assert float(jnp.abs(x).max()) < 0.5

    def test_conjugate_gradient_quadratic(self):
        A = np.array([[3.0, 1.0], [1.0, 2.0]], np.float32)
        b = np.array([1.0, 1.0], np.float32)

        def cost(x):
            return float(0.5 * x @ A @ x - b @ x)

        def grad(x):
            return jnp.asarray(A) @ x - jnp.asarray(b)

        x0 = jnp.zeros(2, jnp.float32)
        x, c = tike_tpu.opt.conjugate_gradient(
            None, x=x0, cost_function=cost, grad=grad, num_iter=8
        )
        want = np.linalg.solve(A, b)
        np.testing.assert_allclose(np.asarray(x), want, atol=1e-2)

    def test_fit_line(self):
        slope, intercept = tike_tpu.opt.fit_line_least_squares(
            y=[1.0, 3.0, 5.0], x=[0.0, 1.0, 2.0]
        )
        np.testing.assert_allclose([slope, intercept], [2.0, 1.0], atol=1e-6)

    def test_is_converged_window(self):
        class Opts:
            convergence_window = 4
            costs = [[5.0], [4.0], [4.1], [4.2]]

        assert tike_tpu.opt.is_converged(Opts()) in (True, False)


class TestCluster:
    def test_wobbly_center_partitions(self):
        rng = np.random.default_rng(0)
        pop = rng.random((100, 2))
        clusters = tike_tpu.cluster.wobbly_center(pop, 7)
        allidx = np.sort(np.concatenate(clusters))
        np.testing.assert_array_equal(allidx, np.arange(100))

    def test_compact_equal_sizes(self):
        rng = np.random.default_rng(1)
        pop = rng.random((101, 2))
        clusters = tike_tpu.cluster.compact(pop, 4, rng=rng)
        sizes = sorted(len(c) for c in clusters)
        assert sizes in ([25, 25, 25, 26], [25, 25, 26, 25])
        allidx = np.sort(np.concatenate(clusters))
        np.testing.assert_array_equal(allidx, np.arange(101))

    def test_stripes_contiguous(self):
        rng = np.random.default_rng(2)
        scan = rng.random((60, 2)).astype(np.float32) * 100
        order, batches, starts = (
            tike_tpu.cluster.by_scan_stripes_contiguous(
                scan, num_stripes=2, batch_method="wobbly_center", num_batch=3
            )
        )
        assert len(order) == 2 and len(batches) == 2
        # Each stripe's batches partition its local indices.
        for o, bs in zip(order, batches):
            local = np.sort(np.concatenate(bs))
            np.testing.assert_array_equal(local, np.arange(len(o)))

    def test_batches_padded(self):
        batches = [np.array([0, 1, 2]), np.array([3, 4])]
        idx, mask = tike_tpu.cluster.batches_padded(batches, multiple_of=4)
        assert idx.shape == (2, 4)
        np.testing.assert_array_equal(mask, [[1, 1, 1, 0], [1, 1, 0, 0]])

    def test_by_scan_grid_partitions_and_is_spatial(self):
        rng = np.random.default_rng(3)
        scan = rng.random((200, 2)).astype(np.float32) * 100
        cells = tike_tpu.cluster.by_scan_grid(scan, shape=(2, 3))
        assert len(cells) == 6
        allidx = np.sort(np.concatenate(cells))
        np.testing.assert_array_equal(allidx, np.arange(200))
        # Row-major order: first 3 cells hold the lower half of axis 0.
        mid0 = np.median(scan[:, 0])
        top = np.concatenate(cells[:3])
        assert scan[top, 0].max() <= mid0 + 15  # contiguous lower stripe
        # Each cell is a contiguous rectangle: axis-1 ranges of cells in the
        # same row do not overlap (beyond boundary ties).
        for row in (cells[:3], cells[3:]):
            hi = -np.inf
            for c in row:
                if len(c) == 0:
                    continue
                assert scan[c, 1].min() >= hi - 1e-5
                hi = scan[c, 1].max()

    def test_by_scan_grid_fly_groups_stay_together(self):
        rng = np.random.default_rng(4)
        scan = rng.random((60, 2)).astype(np.float32) * 10
        cells = tike_tpu.cluster.by_scan_grid(scan, shape=(2, 2), fly=3)
        for c in cells:
            assert len(c) % 3 == 0
            np.testing.assert_array_equal(c % 3, np.tile([0, 1, 2], len(c) // 3))


class TestScanTrajectory:
    def test_raster_is_bounded(self):
        t = tike_tpu.scan.scantimes(0, 2, f=30)
        x, y = tike_tpu.scan.raster(5, 1, 2, 0, 0, t)
        assert x.min() >= 0 and x.max() <= 5

    def test_lissajous_amplitude(self):
        t = tike_tpu.scan.scantimes(0, 1, f=1000)
        x, y = tike_tpu.scan.lissajous(2, 3, 5, 3, 0, 0.5, t)
        assert abs(x).max() <= 2 + 1e-6 and abs(y).max() <= 3 + 1e-6

    def test_discrete_trajectory_steps_bounded(self):
        def traj(t):
            return t, np.sin(t), np.cos(t)

        theta, v, h, dwell, times = (
            tike_tpu.trajectory.discrete_trajectory(
                traj, 0, 1, xstep=0.1, tstep=0.1
            )
        )
        d = tike_tpu.trajectory.euclidian_dist_approx(theta, v, h)
        assert np.all(d <= 0.1 + 1e-6)

    def test_coded_exposure_reference_vectors(self):
        """Bit-exact parity with the reference's pinned test vectors
        (`upstream/tests/test_trajectory.py:31-54`)."""
        c_time = np.arange(11)
        c_dwell = np.ones(11) * 0.5
        time = np.array(
            [-1.0, 0.8, 1.8, 3.0, 4.1, 4.2, 6.1, 7.5, 8.6, 8.9, 8.9,
             8.9, 20, 21]
        )
        dwell = np.array(
            [0.1, 0.2, 0.4, 0.5, 0.1, 0.1, 0.6, 0.2, 0.2, 2, 0, 0.3,
             1.0, 1.0]
        )
        theta = np.arange(time.size)
        v = np.arange(time.size)
        h = np.arange(time.size)
        th1, v1, h1, t1, d1, b1 = tike_tpu.trajectory.coded_exposure(
            theta, v, h, time, dwell, c_time, c_dwell
        )
        np.testing.assert_equal(th1, [2, 3, 4, 5, 6, 9, 11, 9])
        np.testing.assert_equal(v1, [2, 3, 4, 5, 6, 9, 11, 9])
        np.testing.assert_equal(h1, [2, 3, 4, 5, 6, 9, 11, 9])
        np.testing.assert_equal(t1, [2.0, 3.0, 4.1, 4.2, 6.1, 9.0, 9.0, 10.0])
        np.testing.assert_allclose(
            d1, [0.2, 0.5, 0.1, 0.1, 0.4, 0.5, 0.2, 0.5]
        )
        np.testing.assert_equal(b1, [0, 1, 2, 4, 5, 7])

    def test_coded_exposure_bins(self):
        time = np.arange(11).astype(float)
        dwell = np.full(11, 0.5)
        theta, v, h = time * 0.1, time * 0.2, time * 0.3
        c_time = np.array([2.0, 8.0])
        c_dwell = np.array([1.5, 2.5])
        th1, v1, h1, t1, d1, bundles = tike_tpu.trajectory.coded_exposure(
            theta, v, h, time, dwell, c_time, c_dwell
        )
        assert len(bundles) <= 2
        assert np.all(t1 >= 2.0)


class TestRandom:
    def test_numpy_complex_range(self):
        x = tike_tpu.random.numpy_complex(100)
        assert x.dtype == np.complex64
        assert np.abs(x.real).max() <= 0.5
        assert np.abs(x.imag).max() <= 0.5

    def test_jax_complex_range(self):
        import jax

        x = np.asarray(tike_tpu.random.jax_complex(jax.random.key(0), 50, 3))
        assert x.shape == (50, 3)
        assert x.dtype == np.complex64
        assert np.abs(x.real).max() <= 0.5
        assert np.abs(x.imag).max() <= 0.5
        assert np.std(x.real) > 0.1  # not degenerate

    def test_deprecated_cluster_aliases(self):
        import warnings

        pop = np.random.default_rng(0).random((20, 2))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            a = tike_tpu.random.cluster_wobbly_center(pop, 2)
            b = tike_tpu.random.cluster_compact(pop, 2)
        np.testing.assert_array_equal(
            np.sort(np.concatenate(a)), np.arange(20)
        )
        np.testing.assert_array_equal(
            np.sort(np.concatenate(b)), np.arange(20)
        )


class TestSmallHelpers:
    """Name-parity helpers (`opt.py:57-64,304-309`, `linalg.py:103-111`)."""

    def test_get_put_batch(self):
        x = np.arange(10.0)
        b = [np.array([1, 3]), np.array([0, 2])]
        np.testing.assert_array_equal(tike_tpu.opt.get_batch(x, b, 1), [0, 2])
        y = tike_tpu.opt.put_batch(np.array([9.0, 9.0]), x, b, 0)
        assert y[1] == 9.0 and y[3] == 9.0
        xj = jnp.arange(10.0)
        yj = tike_tpu.opt.put_batch(jnp.array([9.0, 9.0]), xj, b, 0)
        assert float(yj[1]) == 9.0 and float(yj[3]) == 9.0

    def test_update_dir_single(self):
        assert tike_tpu.opt.update_single(1.0, 0.5, 4.0) == 3.0
        assert tike_tpu.opt.dir_single("z") == "z"

    def test_hermitian_cov(self):
        rng = np.random.default_rng(5)
        x = (rng.standard_normal((4, 3)) + 1j * rng.standard_normal((4, 3)))
        np.testing.assert_allclose(
            np.asarray(la.hermitian(jnp.asarray(x))), x.conj().T, rtol=1e-6
        )
        c = np.asarray(la.cov(jnp.asarray(x)))
        x0 = x - x.mean(axis=0, keepdims=True)
        np.testing.assert_allclose(c, x0.conj().T @ x0, rtol=1e-5)


class TestResizeInterpolators:
    """Multigrid resample interpolator family (`options.py:333-366`)."""

    def _roundtrip(self, fn):
        rng = np.random.default_rng(3)
        x = (
            rng.standard_normal((2, 16, 16))
            + 1j * rng.standard_normal((2, 16, 16))
        ).astype(np.complex64)
        up = fn(x, 2.0)
        assert up.shape == (2, 32, 32)
        down = fn(up, 0.5)
        assert down.shape == x.shape
        # Up-then-down preserves smooth content approximately.
        err = np.abs(down - x).mean() / np.abs(x).mean()
        assert err < 0.5, err

    def test_linear(self):
        from tike_tpu.ptycho.solvers.options import _resize_linear

        self._roundtrip(_resize_linear)

    def test_cubic(self):
        from tike_tpu.ptycho.solvers.options import _resize_cubic

        self._roundtrip(_resize_cubic)

    def test_lanczos(self):
        from tike_tpu.ptycho.solvers.options import _resize_lanczos

        self._roundtrip(_resize_lanczos)

    def test_fft_matches_shape(self):
        from tike_tpu.ptycho.solvers.options import _resize_fft

        self._roundtrip(_resize_fft)


class TestFarnebackRescale:
    def test_rescale_8bit_range_and_contrast(self):
        from tike_tpu.align.solvers.farneback import _rescale_8bit

        rng = np.random.default_rng(0)
        b = rng.normal(10.0, 2.0, (64, 64)).astype(np.float32)
        b[0, 0] = 1e6  # outlier must not crush the contrast window
        a = b + 1.0
        a8, b8 = _rescale_8bit(a, b)
        assert a8.min() >= 0 and a8.max() <= 255
        assert b8.min() >= 0 and b8.max() <= 255
        # The bulk of the data should span most of the 8-bit range.
        assert np.percentile(b8, 99) - np.percentile(b8, 1) > 100

    def test_rescale_8bit_explicit_window(self):
        from tike_tpu.align.solvers.farneback import _rescale_8bit

        a = np.linspace(0, 10, 100, dtype=np.float32)
        a8, b8 = _rescale_8bit(a, a, hi=10.0, lo=0.0)
        np.testing.assert_allclose(a8, np.linspace(0, 255, 100), rtol=1e-5)


class TestRandomBatches:
    def test_random_batches_partition(self):
        import tike_tpu.cluster

        rng = np.random.default_rng(0)
        scan = rng.random((103, 2)).astype(np.float32)
        batches = tike_tpu.cluster.random_batches(scan, 7, rng=rng)
        assert len(batches) == 7
        allidx = np.sort(np.concatenate(batches))
        np.testing.assert_array_equal(allidx, np.arange(103))
        sizes = [len(b) for b in batches]
        assert max(sizes) - min(sizes) <= 1

    def test_random_batch_method_reconstructs(self):
        import tike_tpu.ptycho as tp

        rng = np.random.default_rng(1)
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
        data = tp.simulate(P, probe, scan, psi).astype(np.float32)
        params = tp.PtychoParameters(
            probe=probe,
            psi=np.full_like(psi, 0.5),
            scan=scan,
            algorithm_options=tp.RpieOptions(
                num_batch=4, num_iter=2, batch_method="random"
            ),
            object_options=tp.ObjectOptions(),
            probe_options=tp.ProbeOptions(),
        )
        result = tp.reconstruct(data, params)
        costs = [float(np.mean(c)) for c in result.algorithm_options.costs]
        assert np.isfinite(costs).all() and costs[-1] < costs[0]

    def test_lanczos_differs_from_cubic(self):
        """Lanczos must be a real windowed-sinc, not a cubic alias."""
        from tike_tpu.ptycho.solvers.options import (
            _resize_cubic,
            _resize_lanczos,
        )

        rng = np.random.default_rng(5)
        x = (
            rng.standard_normal((1, 16, 16))
            + 1j * rng.standard_normal((1, 16, 16))
        ).astype(np.complex64)
        up_l = _resize_lanczos(x, 2.0)
        up_c = _resize_cubic(x, 2.0)
        assert up_l.shape == up_c.shape == (1, 32, 32)
        assert np.abs(up_l - up_c).max() > 1e-4
        # Lanczos rows are normalized: a constant image stays constant.
        const = np.ones((1, 16, 16), np.complex64)
        np.testing.assert_allclose(
            _resize_lanczos(const, 2.0), np.ones((1, 32, 32)), rtol=1e-5
        )

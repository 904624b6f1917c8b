"""Laminography operator and solver tests.

Mirrors the reference strategy (`tests/test_lamino.py` + operator adjoint
tests): adjoint property of the Lamino operator, simulate consistency, and a
CG reconstruction whose cost decreases.
"""

import numpy as np
import jax.numpy as jnp

import tike_tpu.lamino
from tike_tpu.ops.lamino import (
    LaminoConfig,
    lamino_adj,
    lamino_fwd,
    make_grids,
)
from .operators.util import random_complex, check_adjoint

N = 16
NTHETA = 8
TILT = np.pi / 3


def _setup(seed=0):
    rng = np.random.default_rng(seed)
    u = random_complex(rng, N, N, N)
    theta = np.linspace(0, 2 * np.pi, NTHETA, endpoint=False).astype(
        np.float32
    )
    d = random_complex(rng, NTHETA, N, N)
    return u, theta, d


def test_make_grids_matches_kernel_formula():
    theta = np.array([0.3, 1.2], dtype=np.float32)
    xi = np.asarray(make_grids(jnp.asarray(theta), N, TILT))
    assert xi.shape == (2 * N * N, 3)
    # Check one sample against the scalar formula from grid.cu:36-44.
    p, y, x = 1, 3, 7
    kv = (y - N // 2) / N
    ku = (x - N // 2) / N
    ct, st = np.cos(theta[p]), np.sin(theta[p])
    ctl, stl = np.cos(TILT), np.sin(TILT)
    want = np.array(
        [kv * stl, -ku * st + kv * ct * ctl, ku * ct + kv * st * ctl]
    )
    got = xi[(p * N + y) * N + x]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # NOTE: plane-corner frequencies may exceed [-0.5, 0.5); the gather wraps
    # them periodically, matching the reference kernel's modulo indexing.


def test_lamino_adjoint():
    u, theta, d = _setup()
    cfg = LaminoConfig(n=N, tilt=TILT, eps=1e-6, upsample=2)
    fwd = lamino_fwd(cfg, jnp.asarray(u), jnp.asarray(theta))
    adj = lamino_adj(cfg, jnp.asarray(d), jnp.asarray(theta))
    # Lamino.adj's built-in 1/n^2 (`lamino.py:109-144`) exactly cancels the
    # unnormalized-FFT factors, making it the true adjoint of fwd.
    check_adjoint(fwd, u, adj, d, rtol=2e-3)


def test_cgrad_reconstruction_converges():
    # A smooth-ish object is recoverable from many angles.
    u = np.zeros((N, N, N), dtype=np.complex64)
    u[4:12, 4:12, 4:12] = 1.0 + 0.5j
    theta = np.linspace(0, 2 * np.pi, 16, endpoint=False).astype(np.float32)
    data = tike_tpu.lamino.simulate(u, theta, TILT, eps=1e-6, upsample=2)

    result = tike_tpu.lamino.reconstruct(
        data,
        theta,
        TILT,
        algorithm="cgrad",
        num_iter=4,
        eps=1e-6,
        upsample=2,
        cg_iter=3,
    )
    costs = result["cost"]
    assert np.all(np.isfinite(costs))
    assert costs[-1] < 0.5 * costs[0], costs


class TestBucket:
    """Bucket (voxel-projection) operator tests."""

    def test_bucket_adjoint(self):
        import jax.numpy as jnp
        from tike_tpu.ops.bucket import (
            BucketConfig, bucket_fwd, bucket_adj, make_grid,
        )
        from .operators.util import random_complex, check_adjoint

        rng = np.random.default_rng(0)
        n = 12
        cfg = BucketConfig(n=n, tilt=np.pi / 3, precision=2)
        grid = jnp.asarray(make_grid(n))
        u = random_complex(rng, n, n, n)
        theta = np.linspace(0, np.pi, 4, endpoint=False).astype(np.float32)
        d = random_complex(rng, 4, n, n)
        f = bucket_fwd(cfg, jnp.asarray(u), jnp.asarray(theta), grid)
        a = bucket_adj(cfg, jnp.asarray(d), jnp.asarray(theta), grid)
        check_adjoint(f, u, a.reshape(u.shape), d, rtol=1e-4)

    def test_bucket_matches_line_integral(self):
        """At tilt=pi/2, theta=0, projection = sum along one axis."""
        import jax.numpy as jnp
        from tike_tpu.ops.bucket import (
            BucketConfig, bucket_fwd, make_grid,
        )

        n = 16
        rng = np.random.default_rng(1)
        u = (rng.random((n, n, n)) + 1j * rng.random((n, n, n))).astype(
            np.complex64
        )
        cfg = BucketConfig(n=n, tilt=np.pi / 2, precision=2)
        grid = jnp.asarray(make_grid(n))
        data = np.asarray(
            bucket_fwd(
                cfg, jnp.asarray(u), jnp.asarray([0.0], np.float32), grid
            )
        )[0]
        # tilt=pi/2: normal = (0, 0, -sin(0)...) -> beam along x-ish; the
        # total mass must be conserved regardless of direction.
        np.testing.assert_allclose(
            data.sum(), u.sum(), rtol=1e-3, atol=1e-3 * abs(u.sum())
        )

    def test_bucket_cgrad_converges(self):
        import tike_tpu.lamino.bucket as bucket

        n = 16
        u = np.zeros((n, n, n), dtype=np.complex64)
        u[5:11, 5:11, 5:11] = 1.0 - 0.5j
        theta = np.linspace(0, 2 * np.pi, 16, endpoint=False).astype(
            np.float32
        )
        data = bucket.simulate(u, theta, np.pi / 3, eps=0.2)
        result = bucket.reconstruct(
            data, theta, np.pi / 3, algorithm="bucket", num_iter=6,
            eps=0.2, cg_iter=4,
        )
        costs = result["cost"]
        assert np.all(np.isfinite(costs))
        assert costs[-1] < 0.3 * costs[0], costs


class TestLaminoRadonEquivalence:
    """Fourier (USFFT) lamino == Bucket == direct axis sums (Radon).

    Mirrors `upstream/tests/test_lamino.py:258-329`, but actually
    asserts (the reference swallows its AssertionErrors). A tiny integer
    volume padded with zeros is projected at the three orientations where
    the projection equals a direct sum along one axis.
    """

    # (tilt, axis, theta) triples from the reference's _radon_equal.
    CASES = [(0.0, 0, 0.0), (np.pi / 2, 1, 0.0), (np.pi / 2, 2, -np.pi / 2)]

    def _volume(self):
        rng = np.random.default_rng(5)
        return np.pad(
            rng.integers(-5, 5, (2, 2, 2)).astype(np.complex64), 3
        )

    def test_fourier_matches_radon(self):
        u = self._volume()
        for tilt, axis, theta in self.CASES:
            cfg = LaminoConfig(
                n=u.shape[0], tilt=float(tilt), eps=1e-10, upsample=4
            )
            p = np.asarray(
                lamino_fwd(
                    cfg, jnp.asarray(u), jnp.asarray([theta], np.float32)
                )
            )[0]
            np.testing.assert_allclose(
                p, np.sum(u, axis=axis), atol=2e-2
            )

    def test_bucket_matches_radon(self):
        from tike_tpu.ops.bucket import BucketConfig, bucket_fwd, make_grid

        u = self._volume()
        for tilt, axis, theta in self.CASES:
            cfg = BucketConfig(n=u.shape[0], tilt=float(tilt), precision=4)
            p = np.asarray(
                bucket_fwd(
                    cfg,
                    jnp.asarray(u),
                    jnp.asarray([theta], np.float32),
                    jnp.asarray(make_grid(u.shape[0])),
                )
            )[0]
            np.testing.assert_allclose(
                p, np.sum(u, axis=axis), atol=2e-2
            )

    def test_fourier_matches_bucket_generic_angle(self):
        """The two operators agree at a non-axis-aligned orientation.

        Bucket is a low-order quadrature of the same line integrals the
        Fourier operator evaluates exactly, so pointwise agreement needs a
        band-limited (smooth) volume; total mass must match tightly.
        """
        from tike_tpu.ops.bucket import BucketConfig, bucket_fwd, make_grid

        n = 16
        g = np.mgrid[0:n, 0:n, 0:n] - (n - 1) / 2
        u = (
            np.exp(-(g**2).sum(0) / (n / 5) ** 2) * (1 + 0.5j)
        ).astype(np.complex64)
        tilt, theta = np.pi / 3, 0.7
        cfg = LaminoConfig(n=n, tilt=float(tilt), eps=1e-10, upsample=4)
        pf = np.asarray(
            lamino_fwd(cfg, jnp.asarray(u), jnp.asarray([theta], np.float32))
        )[0]
        bcfg = BucketConfig(n=n, tilt=float(tilt), precision=4)
        pb = np.asarray(
            bucket_fwd(
                bcfg,
                jnp.asarray(u),
                jnp.asarray([theta], np.float32),
                jnp.asarray(make_grid(n)),
            )
        )[0]
        rel = np.abs(pf - pb).max() / np.abs(pf).max()
        assert rel < 0.2, rel
        np.testing.assert_allclose(pf.sum(), pb.sum(), rtol=1e-2)

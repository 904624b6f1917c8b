"""conjugate_gradient_traced must match the host-control-flow CG exactly.

The lamino solvers fused their outer iterations into single programs
(round 5); these tests pin the traced line search / CG loop to the
host-side reference implementation (`opt.line_search`/`conjugate_gradient`)
on problems small enough to compare trajectories step by step.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tike_tpu.opt import (
    conjugate_gradient,
    conjugate_gradient_traced,
    direction_dy,
    line_search,
    line_search_traced,
)


def _quadratic(seed=0, n=12):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n)).astype(np.float32)
    A = A @ A.T / n + 0.5 * np.eye(n, dtype=np.float32)
    b = rng.standard_normal(n).astype(np.float32)

    def cost(x):
        return 0.5 * jnp.vdot(x, A @ x).real - jnp.vdot(b, x).real

    def grad(x):
        return A @ x - b

    x0 = rng.standard_normal(n).astype(np.float32)
    return cost, grad, x0


@pytest.mark.parametrize("step0", [1.0, 0.3, 1e-4])
def test_line_search_traced_matches_host(step0):
    cost, grad, x0 = _quadratic(1)
    x = jnp.asarray(x0)
    d = -grad(x)
    c0 = float(cost(x))

    s_host, f_host, x_host = line_search(
        f=lambda v: float(cost(v)),
        x=x,
        d=d,
        update_multi=lambda x, g, d: x + g * d,
        step_length=step0,
    )
    s_tr, f_tr, x_tr = jax.jit(
        lambda x, d: line_search_traced(cost, x, d, step0, jnp.float32(c0))
    )(x, d)
    np.testing.assert_allclose(float(s_tr), s_host, rtol=1e-6)
    np.testing.assert_allclose(float(f_tr), f_host, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(x_tr), np.asarray(x_host),
                               rtol=1e-5, atol=1e-6)


def _isotropic():
    """0.5 |x - 1|², from x = 0: the steepest-descent line's minimum is at
    step 1, and step 2 reaches the mirror image of x at the same cost."""

    def cost(x):
        r = x - 1
        return 0.5 * jnp.vdot(r, r).real

    x = jnp.zeros(7, jnp.float32)
    return cost, x, -(x - 1)


@pytest.mark.parametrize(
    "step0, grown, step_taken, next_step",
    [
        # A fresh trial that is merely no worse is accepted, and grown.
        (2.0, False, 2.0, 4.0),
        # A grown trial is held against its half: at the mirror image the
        # half, the minimum, wins, and the step is kept.
        (2.0, True, 1.0, 2.0),
        # A grown trial that beats its half is taken, and grown.
        (0.25, True, 0.25, 0.5),
    ],
)
def test_grown_first_trial_is_held_against_its_half(
    step0, grown, step_taken, next_step
):
    cost, x, d = _isotropic()
    c0 = float(cost(x))
    host = line_search(
        f=lambda v: float(cost(v)),
        x=x,
        d=d,
        update_multi=lambda x, g, d: x + g * d,
        step_length=step0,
        cost=c0,
        grown=grown,
    )
    traced = jax.jit(
        lambda x, d: line_search_traced(
            cost, x, d, step0, jnp.float32(c0), grown=grown
        )
    )(x, d)
    for s, f, x_new in (host, traced):
        assert float(s) == next_step
        np.testing.assert_allclose(np.asarray(x_new), step_taken, atol=1e-7)
        np.testing.assert_allclose(float(f), float(cost(x_new)), rtol=1e-6)


def test_conjugate_gradient_rejects_the_mirror_image():
    """A first step of half the line's minimiser: Dai-Yuan scales the
    second direction to fit that step, so the grown second trial lands on
    the mirror image of the first point, at exactly its cost (every number
    here is exact in f32). Its half, the minimum, wins."""
    cost, x, _ = _isotropic()

    def grad(v):
        return v - 1

    x_host, c_host = conjugate_gradient(
        None, x=x, cost_function=lambda v: float(cost(v)), grad=grad,
        num_iter=2, step_length=0.5,
    )
    x_tr, c_tr, _ = jax.jit(
        lambda x: conjugate_gradient_traced(
            x, cost, grad, num_iter=2, step_length=0.5
        )
    )(x)
    for got, c in ((x_host, c_host), (x_tr, c_tr)):
        np.testing.assert_array_equal(np.asarray(got), 1.0)
        assert float(c) == 0.0


def test_direction_dy_after_a_short_step():
    """After a short step the two gradients agree to about four digits.
    The denominator is summed from their difference; subtracting two f32
    sums instead cancels to errors near 1e-3 here."""
    rng = np.random.default_rng(5)
    g0 = rng.standard_normal(1 << 20).astype(np.float32)
    d = -g0
    g1 = (g0 * (1 - 1e-4) + 1e-5 * rng.standard_normal(g0.size)).astype(
        np.float32
    )
    got = np.asarray(jax.jit(direction_dy)(g0, g1, d))
    a, b, dd = (v.astype(np.float64) for v in (g0, g1, d))
    want = -b + np.dot(b, b) / np.dot(b - a, dd) * dd
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 1e-5


def test_line_search_traced_total_failure_keeps_x():
    """An ascent direction fails every backtrack: step 0, x unchanged,
    cost unchanged — the host 'else' branch."""
    cost, grad, x0 = _quadratic(2)
    x = jnp.asarray(x0)
    d = grad(x)  # ascent direction
    c0 = float(cost(x))
    s, f, x_new = jax.jit(
        lambda x, d: line_search_traced(cost, x, d, 1.0, jnp.float32(c0))
    )(x, d)
    assert float(s) == 0.0
    np.testing.assert_allclose(float(f), c0, rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(x_new), np.asarray(x))


def test_conjugate_gradient_traced_matches_host():
    cost, grad, x0 = _quadratic(3)
    x = jnp.asarray(x0)

    x_host, c_host = conjugate_gradient(
        None,
        x=x,
        cost_function=lambda v: float(cost(v)),
        grad=grad,
        num_iter=4,
        step_length=1.0,
    )
    x_tr, c_tr, _ = jax.jit(
        lambda x: conjugate_gradient_traced(
            x, cost, grad, num_iter=4, step_length=1.0
        )
    )(x)
    np.testing.assert_allclose(float(c_tr), float(c_host), rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(x_tr), np.asarray(x_host), rtol=1e-4, atol=1e-5
    )
    # And it actually minimizes.
    assert float(c_tr) < float(cost(x))


def test_conjugate_gradient_traced_complex():
    """Complex volumes (the lamino case): trajectory matches the host."""
    rng = np.random.default_rng(4)
    n = 8
    A = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    A = (A @ A.conj().T / n + 0.5 * np.eye(n)).astype(np.complex64)
    b = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64
    )

    def cost(x):
        return (0.5 * jnp.vdot(x, A @ x) - jnp.vdot(b, x)).real

    def grad(x):
        return A @ x - b

    x0 = jnp.asarray(
        (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
            np.complex64
        )
    )
    x_host, c_host = conjugate_gradient(
        None,
        x=x0,
        cost_function=lambda v: float(cost(v)),
        grad=grad,
        num_iter=3,
        step_length=0.7,
    )
    x_tr, c_tr, _ = jax.jit(
        lambda x: conjugate_gradient_traced(
            x, cost, grad, num_iter=3, step_length=0.7
        )
    )(x0)
    np.testing.assert_allclose(float(c_tr), float(c_host), rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(x_tr), np.asarray(x_host), rtol=1e-4, atol=1e-5
    )

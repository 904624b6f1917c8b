"""Generic optimization routines (adaptive moments, CG, line search).

JAX equivalent of `upstream/src/tike/opt.py`. Array math is jnp
(works under jit); the convergence bookkeeping helpers operate on host-side
Python lists, as in the reference.
"""

from __future__ import annotations

import logging
import typing

import jax.numpy as jnp
import numpy as np

import tike_tpu.linalg as la

logger = logging.getLogger(__name__)


def is_converged(algorithm_options) -> bool:
    """Return True if the cost slope is non-negative within the window.

    Mirrors `opt.py:21-43`.
    """
    window = algorithm_options.convergence_window
    if (
        window >= 2
        and len(algorithm_options.costs) >= window
        and len(algorithm_options.costs) % window // 2 == 0
    ):
        m = np.array(algorithm_options.costs[-window:])
        m = np.mean(np.reshape(m, (len(m), -1)), axis=1)
        p = np.polyfit(x=range(window), y=m, deg=1)
        if p[0] >= 0:
            logger.info(
                f"Considering the last {window:d} epochs, "
                "the cost function seems converged."
            )
            return True
    return False


def batch_indicies(n, m=1, use_random=True, rng=None):
    """Return list of indices [0...n) as m groups (`opt.py:46-54`)."""
    assert 0 < m <= n, (m, n)
    rng = np.random.default_rng() if rng is None else rng
    i = rng.permutation(n) if use_random else np.arange(n)
    return np.array_split(i, m)


def get_batch(x, b, n):
    """Return x[b[n]]; for use with map() (`opt.py:57-59`)."""
    return x[b[n]]


def put_batch(y, x, b, n):
    """Return x with x[b[n]] set to y (`opt.py:62-64`).

    The reference mutates the cupy array in place; jax arrays are
    immutable, so the updated array is returned instead.
    """
    if isinstance(x, np.ndarray):
        x[b[n]] = y
        return x
    return x.at[b[n]].set(y)


def update_single(x, step_length, d):
    """x + step_length * d (`opt.py:304-305`)."""
    return x + step_length * d


def dir_single(x):
    """Identity direction wrapper (`opt.py:308-309`)."""
    return x


def momentum(g, v, m, vdecay=None, mdecay=0.9):
    """Classical momentum direction (`opt.py:67-83`)."""
    m = 0 if m is None else m
    m = mdecay * m + (1 - mdecay) * g
    return m, None, m


def adagrad(g, v=None, m=None, eps=1e-6):
    """Adagrad direction (`opt.py:86-121`)."""
    if v is None:
        return g, (g * g.conj()).real, m
    v = v + (g * g.conj()).real
    return g / jnp.sqrt(v + eps), v, m


def adadelta(g, d0=None, v=None, m=None, decay=0.9, eps=1e-6):
    """Adadelta direction (`opt.py:124-162`)."""
    v = 0 if v is None else v
    m = 0 if m is None else m
    d0 = 0 if d0 is None else d0
    v = v * decay + (1 - decay) * (g * g.conj()).real
    m = m * decay + (1 - decay) * (d0 * d0.conj()).real
    return jnp.sqrt((m + eps) / (v + eps)) * g, v, m


def adam(g, v=None, m=None, vdecay=0.999, mdecay=0.9, eps=1e-8):
    """Adaptive moment estimation direction (`opt.py:165-213`)."""
    v = jnp.zeros_like(g.real) if v is None else v
    m = jnp.zeros_like(g) if m is None else m
    m = mdecay * m + (1 - mdecay) * g
    v = vdecay * v + (1 - vdecay) * (g * g.conj()).real
    m_ = m / (1 - mdecay)
    v_ = jnp.sqrt(v / (1 - vdecay))
    return m_ / (v_ + eps), v, m


def fit_line_least_squares(y, x):
    """Return the (slope, intercept) of the line fit to (x, y)."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    count = len(x)
    assert count == len(y)
    sx = x.sum()
    sy = y.sum()
    slope = (count * (x * y).sum() - sx * sy) / (
        count * (x * x).sum() - sx * sx
    )
    intercept = (sy - slope * sx) / count
    return slope, intercept


def momentum_checked(
    g,
    v,
    m,
    mdecay: float,
    errors: typing.List[float],
    beta: float = 1.0,
    memory_length: int = 3,
    vdecay=None,
):
    """Momentum, applied only when the cost is trending downward.

    Port of `_momentum_checked` (`lstsq.py:809-858`). The decision logic is
    data-dependent and runs on the host between jitted epoch steps; the array
    updates themselves are jnp.
    """
    g = jnp.asarray(g)
    m = jnp.zeros_like(g) if m is None else m
    previous_g = (
        jnp.zeros((memory_length, *g.shape), dtype=g.dtype) if v is None else v
    )

    previous_g = jnp.roll(previous_g, shift=-1, axis=0)
    gnorm = la.norm(g)
    previous_g = previous_g.at[-1].set(g / jnp.where(gnorm == 0, 1, gnorm) * beta)

    if len(errors) > 2 and max(errors[-3], errors[-2]) > min(
        errors[-2], errors[-1]
    ):
        corr = np.asarray(
            la.inner(previous_g[:-1], previous_g[-1:], axis=(-2, -1)).real
        ).flatten()
        if np.all(corr > 0):
            friction, _ = fit_line_least_squares(
                x=np.arange(len(corr) + 1),
                y=[0.0] + np.log(corr).tolist(),
            )
            friction = 0.5 * max(-friction, 0)
            m = (1 - friction) * m + g
            return mdecay * m, previous_g, m

    return jnp.zeros_like(g), previous_g, m / 2


def momentum_checked_traced(
    g,
    previous_g,
    m,
    mdecay,
    err_hist,
    n_epochs_done,
    beta=1.0,
):
    """Traced :func:`momentum_checked` for fully-fused epoch programs.

    Identical math, but the cost-trend decision becomes a `jnp.where`
    blend on traced predicates so the whole multi-epoch `lax.scan` stays
    one XLA program. ``err_hist`` is the (3,) on-device tail of the epoch
    cost series (current epoch last); ``n_epochs_done`` the traced length
    of that series. States must be pre-initialized arrays (``previous_g``:
    (memory_length, *g.shape); ``m``: like g).
    """
    previous_g = jnp.roll(previous_g, shift=-1, axis=0)
    gnorm = la.norm(g)
    previous_g = previous_g.at[-1].set(
        g / jnp.where(gnorm == 0, 1, gnorm) * beta
    )
    trending = jnp.logical_and(
        n_epochs_done > 2,
        jnp.maximum(err_hist[0], err_hist[1])
        > jnp.minimum(err_hist[1], err_hist[2]),
    )
    corr = la.inner(
        previous_g[:-1], previous_g[-1:], axis=(-2, -1)
    ).real.reshape(-1)
    allpos = jnp.all(corr > 0)
    # Line fit of [0, log corr...] against [0..len]: the host version's
    # fit_line_least_squares on the same points.
    y = jnp.concatenate(
        [jnp.zeros((1,), corr.dtype), jnp.log(jnp.maximum(corr, 1e-30))]
    )
    x = jnp.arange(y.shape[0], dtype=y.dtype)
    count = y.shape[0]
    slope = (count * jnp.sum(x * y) - x.sum() * y.sum()) / (
        count * jnp.sum(x * x) - x.sum() ** 2
    )
    friction = 0.5 * jnp.maximum(-slope, 0)
    take = jnp.logical_and(trending, allpos)
    m_new = jnp.where(take, (1 - friction) * m + g, m / 2)
    d = jnp.where(take, mdecay * m_new, jnp.zeros_like(g))
    return d, previous_g, m_new


def line_search(
    f,
    x,
    d,
    update_multi,
    step_length=1,
    linesearch_iterations=4,
    cost=None,
    grown=False,
):
    """Backtracking line search (`opt.py:216-278`).

    Finds a step length along direction d that decreases f; halves the step
    until improvement or iterations exhausted. A first trial that succeeds
    is doubled for the next search. Host-side control flow; f may be a
    jitted function. Returns (next step length, cost at the new x, new x).

    ``grown`` says that ``step_length`` was doubled that way. If such a
    trial succeeds at once, its half is tried too and the lower cost wins;
    when the half wins, the step is kept, not doubled. A Dai-Yuan direction
    is already scaled so that the previous step fits it: on a quadratic
    cost, twice that step lands near the mirror image of x across the
    line's minimum, at about the cost of x, while the half reaches the
    minimum. "No worse" alone would accept either, as rounding decides.
    """
    step_shrink = 0.5
    if cost is None:
        cost = f(x)
    first_step = step_length
    for _ in range(linesearch_iterations):
        xsd = update_multi(x, step_length, d)
        fxsd = f(xsd)
        if fxsd <= cost:
            break
        step_length *= step_shrink
    else:
        return 0, cost, x
    if step_length != first_step:
        return step_length, fxsd, xsd
    if grown:
        half = step_length * step_shrink
        x_half = update_multi(x, half, d)
        f_half = f(x_half)
        if f_half < fxsd:
            return step_length, f_half, x_half
    return step_length / step_shrink, fxsd, xsd


def line_search_traced(
    f,
    x,
    d,
    step_length,
    cost,
    linesearch_iterations=4,
    update_multi=None,
    grown=False,
):
    """Backtracking line search as traceable on-device control flow.

    Same semantics as :func:`line_search` (try the step; on failure halve
    and retry up to ``linesearch_iterations`` times; total failure keeps x
    and zero step; first-try success grows the step for next time, after
    a ``grown`` trial has beaten its half) but expressed with
    ``lax.while_loop`` so a whole CG iteration compiles into ONE program
    instead of one host round trip per f() call. ``grown`` may be traced.

    Returns (next_step_length, cost_at_new_x, new_x).
    """
    import jax

    update_multi = (
        (lambda x, gamma, d: x + gamma * d)
        if update_multi is None
        else update_multi
    )
    shrink = jnp.asarray(0.5, dtype=jnp.float32)
    step0 = jnp.asarray(step_length, dtype=jnp.float32)
    cost = jnp.asarray(cost, jnp.float32)

    def cond(carry):
        i, _, _, ok = carry
        return jnp.logical_and(i < linesearch_iterations, ~ok)

    def body(carry):
        i, step, fxsd, _ = carry
        fx = f(update_multi(x, step, d)).astype(jnp.float32)
        ok = fx <= cost
        return (
            i + 1,
            jnp.where(ok, step, step * shrink),
            jnp.where(ok, fx, fxsd),
            ok,
        )

    i, step, fxsd, ok = jax.lax.while_loop(
        cond, body, (jnp.int32(0), step0, cost, False)
    )
    first = jnp.logical_and(ok, i == 1)
    half = step * shrink
    if grown is False:
        take_half = False
    else:
        f_half = jax.lax.cond(
            jnp.logical_and(first, grown),
            lambda: f(update_multi(x, half, d)).astype(jnp.float32),
            lambda: jnp.float32(jnp.inf),
        )
        take_half = f_half < fxsd
        fxsd = jnp.where(take_half, f_half, fxsd)
    moved = jnp.where(ok, jnp.where(take_half, half, step), 0.0)
    fxsd = jnp.where(ok, fxsd, cost)
    new_x = update_multi(x, moved.astype(x.real.dtype), d)
    next_step = jnp.where(
        jnp.logical_and(first, ~jnp.asarray(take_half)),
        step0 / shrink,
        jnp.where(ok, step, 0.0),
    )
    return next_step, fxsd, new_x


def conjugate_gradient_traced(
    x,
    cost_function,
    grad,
    num_iter=1,
    step_length=1,
    linesearch_iterations=4,
):
    """Whole Dai-Yuan CG loop as traceable code (call under jax.jit).

    Device-fused equivalent of :func:`conjugate_gradient` with
    ``num_search = num_iter`` (always line-search, the solvers' default):
    the num_iter inner iterations unroll into one XLA program, so an outer
    solver iteration costs one dispatch + one scalar download instead of
    ~15 of each. Returns (x, cost, next_step_length).
    """
    grad1 = grad(x)
    dir_ = -grad1
    step = jnp.asarray(step_length, jnp.float32)
    cost = cost_function(x).astype(jnp.float32)
    grown = False
    for i in range(num_iter):
        if i > 0:
            grad0 = grad1
            grad1 = grad(x)
            dir_ = direction_dy(grad0, grad1, dir_)
        next_step, cost, x = line_search_traced(
            cost_function, x, dir_, step, cost, linesearch_iterations,
            grown=grown,
        )
        grown = next_step > step
        step = next_step
    return x, cost, step


def cgls_traced(fwd, adj, b, x0, num_iter=4):
    """CGLS — conjugate gradients on the normal equations — traceable.

    For LINEAR forward models (laminography USFFT / bucket: cost
    = |fwd(x) - b|^2 exactly), CGLS needs ONE fwd + ONE adj per iteration
    with mathematically optimal step lengths — no backtracking cost
    evaluations at all, and the data-space residual is maintained
    incrementally so the cost comes free. This is a beyond-reference
    alternative to the generic Dai-Yuan + backtracking machinery the
    reference applies to these linear problems (`opt.py:312-380` there).

    Returns (x, final_cost) where cost = |fwd(x) - b|^2.
    """
    r = b - fwd(x0)
    s = adj(r)
    p = s
    gamma = jnp.sum((s * jnp.conj(s)).real)
    x = x0
    for _ in range(num_iter):
        q = fwd(p)
        qq = jnp.sum((q * jnp.conj(q)).real)
        alpha = (gamma / jnp.where(qq == 0, 1.0, qq)).astype(jnp.float32)
        # A zero q means p is in the null space measured by the data —
        # no step can help; freeze (alpha would be gamma/1 otherwise).
        alpha = jnp.where(qq == 0, 0.0, alpha)
        x = x + alpha.astype(x.real.dtype) * p
        r = r - alpha.astype(r.real.dtype) * q
        s = adj(r)
        gamma_new = jnp.sum((s * jnp.conj(s)).real)
        beta = gamma_new / jnp.where(gamma == 0, 1.0, gamma)
        beta = jnp.where(gamma == 0, 0.0, beta)
        gamma = gamma_new
        p = s + beta.astype(p.real.dtype) * p
    cost = jnp.sum((r * jnp.conj(r)).real)
    return x, cost


def direction_dy(grad0, grad1, dir_):
    """Dai-Yuan conjugate gradient direction (`opt.py:281-310`).

    The denominator sums ``(grad1 - grad0) * dir_``, as the reference does,
    not the difference of two sums: after a short step the two gradients
    agree to many digits, and subtracting their f32 sums cancels to about
    1% error (Bucket laminography, 128³ after a first step of 1).
    """
    numer = la.inner(grad1, grad1)
    denom = jnp.sum(((grad1 - grad0).conj() * dir_).real)
    gamma = numer / jnp.where(denom == 0, 1e-32, denom)
    return -grad1 + gamma * dir_


def conjugate_gradient(
    array_module,
    x,
    cost_function,
    grad,
    direction_dy=direction_dy,
    dir_multi=None,
    update_multi=None,
    num_iter=1,
    step_length=1,
    num_search=None,
    cost=None,
):
    """Conjugate-gradient minimization with Dai-Yuan directions.

    Functional port of `opt.py:312-380`: num_iter outer iterations, each with
    a backtracking line search along the CG direction.
    """
    update_multi = (
        (lambda x, gamma, d: x + gamma * d)
        if update_multi is None
        else update_multi
    )
    num_search = num_iter if num_search is None else num_search

    grad1 = grad(x)
    dir_ = -grad1
    grown = False
    for i in range(num_iter):
        grad0 = grad1
        if i > 0:
            grad1 = grad(x)
            dir_ = direction_dy(grad0, grad1, dir_)
        if i < num_search:
            next_step, cost, x = line_search(
                f=cost_function,
                x=x,
                d=dir_,
                update_multi=update_multi,
                step_length=step_length,
                cost=cost,
                grown=grown,
            )
            grown = next_step > step_length
            step_length = next_step
        else:
            x = update_multi(x, step_length, dir_)
            cost = None
    if cost is None:
        cost = cost_function(x)
    return x, cost

"""Complex linear algebra helpers (JAX).

JAX re-implementation of the reference utilities in
`upstream/src/tike/linalg.py` (norm/mnorm/inner/projection/lstsq/
orthogonalize_gs/pca_eig). All functions are pure and jit/vmap friendly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def norm(x, axis=None, keepdims=False):
    """Return the complex vector 2-norm: sqrt(sum(|x|^2))."""
    return jnp.sqrt(jnp.sum((x * x.conj()).real, axis=axis, keepdims=keepdims))


def mnorm(x, axis=None, keepdims=False):
    """Return the root-mean-square magnitude (norm normalized by count)."""
    return jnp.sqrt(jnp.mean((x * x.conj()).real, axis=axis, keepdims=keepdims))


def hermitian(x):
    """Conjugate transpose of x along the last two dims (`linalg.py:103-105`)."""
    return x.conj().swapaxes(-1, -2)


def cov(x):
    """Covariance of x, observations along axis -2 (`linalg.py:108-111`)."""
    x0 = x - jnp.mean(x, axis=-2, keepdims=True)
    return hermitian(x0) @ x0


def inner(x, y, axis=None, keepdims=False):
    """Return the complex inner product <x|y>; conjugate-linear in x.

    Equals sum(conj(x) * y) — consistent with the reference convention
    (`linalg.py` inner).
    """
    return jnp.sum(jnp.conj(x) * y, axis=axis, keepdims=keepdims)


def projection(a, b, axis=None):
    """Return the vector projection of a onto b."""
    return inner(b, a, axis=axis, keepdims=True) / inner(
        b, b, axis=axis, keepdims=True
    ) * b


def lstsq(a, b, weights=None):
    """Return least-squares solution x to a @ x = b via normal equations.

    a: (..., M, N), b: (..., M, K) -> x: (..., N, K). Optionally weighted by
    per-row `weights (..., M)`. Matches the reference's batched normal-equation
    solve (`linalg.py:33-58`), which is faster than SVD for the tiny (2x2)
    systems ptychography needs and maps onto batched matmuls.
    """
    if weights is not None:
        w = weights[..., None]
        aT = jnp.swapaxes(a, -1, -2).conj() * jnp.swapaxes(w, -1, -2)
    else:
        aT = jnp.swapaxes(a, -1, -2).conj()
    ata = aT @ a
    atb = aT @ b
    return jnp.linalg.solve(ata, atb)


def orthogonalize_gs(x, axis=-1, N: int | None = None):
    """Gram-Schmidt orthogonalize vectors along the given flattened axes.

    x: (..., nvec, *vec_dims); `axis` may be an int or tuple naming the vector
    component axes; vectors are enumerated along the axis immediately before
    the first component axis. Mirrors `linalg.py:61-100`.
    """
    if isinstance(axis, int):
        axis = (axis,)
    axis = tuple(a % x.ndim for a in axis)
    # Move component axes to the end.
    rest = [a for a in range(x.ndim) if a not in axis]
    perm = rest + list(axis)
    xt = jnp.transpose(x, perm)
    comp_shape = xt.shape[len(rest):]
    nvec = xt.shape[len(rest) - 1]
    lead = xt.shape[: len(rest) - 1]
    flat = xt.reshape(*lead, nvec, -1)

    def body(i, u):
        # Subtract projections of vector i onto all previous vectors.
        vi = flat[..., i, :]

        def proj_body(j, acc):
            uj = u[..., j, :]
            coef = jnp.where(
                j < i,
                inner(uj, vi, axis=-1, keepdims=True)
                / (inner(uj, uj, axis=-1, keepdims=True) + 1e-32),
                jnp.zeros_like(vi[..., :1]),
            )
            return acc - coef * uj

        ui = jax.lax.fori_loop(0, nvec, proj_body, vi)
        return u.at[..., i, :].set(ui)

    u = jax.lax.fori_loop(0, nvec, body, flat)
    u = u.reshape(*lead, nvec, *comp_shape)
    inv = [0] * x.ndim
    for k, p in enumerate(perm):
        inv[p] = k
    return jnp.transpose(u, inv)


def pca_eig(data, k: int):
    """Return k principal components of data via eigendecomposition.

    data: (N, ..., D) flattened features; returns (S (k,), U (k, D)).
    Mirrors `linalg.py:114-137`.
    """
    flat = data.reshape(data.shape[0], -1)
    cov = flat.conj().T @ flat
    vals, vecs = jnp.linalg.eigh(cov)
    # eigh returns ascending; take top-k descending.
    vals = vals[::-1][:k]
    vecs = vecs[:, ::-1][:, :k]
    return vals, vecs.T.reshape(k, *data.shape[1:])

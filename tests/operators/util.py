"""Adjoint/scaling property harness for linear operator pairs.

Re-implements the reference's central operator test pattern
(`upstream/tests/operators/util.py:23-83`): for a linear operator pair
(fwd, adj), check <F m, d> == <m, F* d> and that F approximately preserves
norms (for unitary-normalized operators).
"""

import numpy as np
import jax.numpy as jnp

import tike_tpu.linalg as la


def random_complex(rng, *shape, dtype=np.complex64):
    return (
        rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    ).astype(dtype)


def check_adjoint(fwd_out, m, adj_out, d, rtol=1e-4):
    """Assert <F m, d> == <m, F* d> for sampled m, d."""
    a = complex(la.inner(jnp.asarray(fwd_out).ravel(), jnp.asarray(d).ravel()))
    b = complex(la.inner(jnp.asarray(m).ravel(), jnp.asarray(adj_out).ravel()))
    scale = max(abs(a), abs(b), 1e-12)
    assert abs(a - b) / scale < rtol, (a, b)


def check_scaled(fwd_of_adj, d, rtol=1e-4):
    """Assert ||F F* d|| ~= ||d|| for unitary-normalized operators."""
    a = float(la.norm(jnp.asarray(fwd_of_adj).ravel()))
    b = float(la.norm(jnp.asarray(d).ravel()))
    assert abs(a - b) / max(a, b) < rtol, (a, b)

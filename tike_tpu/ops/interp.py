"""Lanczos-windowed 2D resampling (remap) — forward and adjoint.

JAX equivalent of the reference CUDA kernels
`fwd_lanczos_interp2D` / `adj_lanczos_interp2D`
(`upstream/src/tike/operators/cupy/interp.cu:218-237`): for each
non-uniform sample point, a (2m+1)^2 neighborhood of the uniform grid is
combined with 2-lobe Lanczos weights; points outside the grid contribute the
constant `cval`. One `lax.scan` step per kernel tap does a batched gather
(forward) or deterministic scatter-add (adjoint) over all points.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def _lanczos_weight(d, nlobes=2.0):
    """The 1D Lanczos window (interp.cu:96-106), nlobes fixed at 2."""
    pix = d * jnp.pi
    safe = jnp.where(jnp.abs(pix) < 1e-12, 1.0, pix)
    w = nlobes * jnp.sin(safe) * jnp.sin(safe / nlobes) / (safe * safe)
    w = jnp.where(jnp.abs(d) < 1e-12, 1.0, w)
    return jnp.where(jnp.abs(d) <= nlobes, w, 0.0)


def _offsets2d(m: int):
    r = np.arange(-m, m + 1)
    i, j = np.meshgrid(r, r, indexing="ij")
    return np.stack([i.ravel(), j.ravel()], -1).astype(np.int32)


@functools.partial(jax.jit, static_argnames=("m",))
def remap_lanczos_fwd(Fe, x, m: int, cval=0.0):
    """Sample Fe (H, W) at points x (N, 2) with Lanczos filtering -> (N,)."""
    h, w = Fe.shape
    center = jnp.floor(x).astype(jnp.int32)  # (N, 2)
    # Float-pair gathers: complex gathers are unsupported on some backends.
    Fe_flat = jnp.stack(
        [Fe.real, Fe.imag], axis=-1
    ).reshape(-1, 2) if jnp.iscomplexobj(Fe) else Fe.reshape(-1, 1)
    nch = Fe_flat.shape[-1]
    offsets = jnp.asarray(_offsets2d(m))
    cval_c = jnp.asarray(cval, dtype=jnp.complex64)
    cval_f = jnp.asarray(
        [cval_c.real, cval_c.imag][:nch], dtype=Fe.real.dtype
    )

    def body(acc, off):
        pt = center + off[None, :]
        wgt = _lanczos_weight(
            x[:, 0] - pt[:, 0].astype(x.dtype)
        ) * _lanczos_weight(x[:, 1] - pt[:, 1].astype(x.dtype))
        inside = (
            (pt[:, 0] >= 0) & (pt[:, 0] < h) & (pt[:, 1] >= 0) & (pt[:, 1] < w)
        )
        flat = jnp.clip(pt[:, 0], 0, h - 1) * w + jnp.clip(pt[:, 1], 0, w - 1)
        vals = jnp.where(inside[:, None], Fe_flat[flat], cval_f[None, :])
        return acc + vals * wgt[:, None], None

    acc0 = jnp.zeros((x.shape[0], nch), dtype=Fe.real.dtype)
    acc, _ = jax.lax.scan(body, acc0, offsets)
    if jnp.iscomplexobj(Fe):
        return jax.lax.complex(acc[:, 0], acc[:, 1]).astype(Fe.dtype)
    return acc[:, 0].astype(Fe.dtype)


@functools.partial(jax.jit, static_argnames=("m", "grid_shape"))
def remap_lanczos_adj(points, x, m: int, grid_shape):
    """Adjoint: spread point values (N,) onto a (H, W) grid."""
    h, w = grid_shape
    center = jnp.floor(x).astype(jnp.int32)
    offsets = jnp.asarray(_offsets2d(m))
    pts = (
        jnp.stack([points.real, points.imag], axis=-1)
        if jnp.iscomplexobj(points)
        else points[:, None]
    )
    nch = pts.shape[-1]

    def body(G, off):
        pt = center + off[None, :]
        wgt = _lanczos_weight(
            x[:, 0] - pt[:, 0].astype(x.dtype)
        ) * _lanczos_weight(x[:, 1] - pt[:, 1].astype(x.dtype))
        inside = (
            (pt[:, 0] >= 0) & (pt[:, 0] < h) & (pt[:, 1] >= 0) & (pt[:, 1] < w)
        )
        flat = jnp.clip(pt[:, 0], 0, h - 1) * w + jnp.clip(pt[:, 1], 0, w - 1)
        vals = jnp.where(inside[:, None], pts * wgt[:, None], 0)
        return G.at[flat].add(vals), None

    G0 = jnp.zeros((h * w, nch), dtype=pts.dtype)
    G, _ = jax.lax.scan(body, G0, offsets)
    if jnp.iscomplexobj(points):
        return jax.lax.complex(G[:, 0], G[:, 1]).astype(points.dtype).reshape(
            h, w
        )
    return G[:, 0].astype(points.dtype).reshape(h, w)

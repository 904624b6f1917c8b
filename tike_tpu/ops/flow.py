"""Non-rigid dense warps (optical-flow remap) by Lanczos interpolation.

JAX equivalent of `upstream/src/tike/operators/cupy/flow.py`:
the per-image CUDA kernel-launch loop becomes a vmapped Lanczos remap.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .interp import remap_lanczos_adj, remap_lanczos_fwd


def _flow_coords(flow):
    """Convert displacements (..., H, W, 2) to sample coordinates (..., H*W, 2)."""
    h, w = flow.shape[-3:-1]
    coords = -flow
    coords = coords.at[..., 0].add(jnp.arange(h, dtype=flow.dtype)[:, None])
    coords = coords.at[..., 1].add(jnp.arange(w, dtype=flow.dtype)[None, :])
    return coords.reshape(*flow.shape[:-3], h * w, 2)


@functools.partial(jax.jit, static_argnames=("filter_size",))
def flow_fwd(f, flow, filter_size: int = 5, cval=0.0):
    """Remap each image of f by its per-pixel displacements.

    f (..., H, W) complex; flow (..., H, W, 2) float32 displacements.
    """
    if flow is None:
        return f
    h, w = f.shape[-2:]
    shape = f.shape
    coords = _flow_coords(flow).reshape(-1, h * w, 2)
    fs = f.reshape(-1, h, w)
    a = max(1, filter_size // 2)
    out = jax.vmap(lambda img, c: remap_lanczos_fwd(img, c, a, cval))(
        fs, coords
    )
    return out.reshape(shape)


@functools.partial(jax.jit, static_argnames=("filter_size",))
def flow_adj(g, flow, filter_size: int = 5, cval=0.0):
    """Adjoint remap: spread each warped image back onto the source grid."""
    if flow is None:
        return g
    h, w = g.shape[-2:]
    shape = g.shape
    coords = _flow_coords(flow).reshape(-1, h * w, 2)
    gs = g.reshape(-1, h * w)
    a = max(1, filter_size // 2)
    out = jax.vmap(lambda pts, c: remap_lanczos_adj(pts, c, a, (h, w)))(
        gs, coords
    )
    return out.reshape(shape)


def flow_inv(g, flow, filter_size: int = 5, cval=0.0):
    """Approximate inverse: warp by the negated flow (`flow.py:160-167`)."""
    return flow_fwd(g, None if flow is None else -flow, filter_size, cval)

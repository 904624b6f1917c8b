"""Composite alignment operator: pad -> shift -> flow -> rotate.

JAX equivalent of
`upstream/src/tike/operators/cupy/alignment.py:15-126`.
"""

from __future__ import annotations

import jax

from .flow import flow_adj, flow_fwd
from .pad import pad_adj, pad_fwd
from .rotate import rotate_adj, rotate_fwd
from .shift import shift_adj, shift_fwd


def alignment_fwd(
    unpadded,
    shift,
    flow,
    padded_shape,
    angle,
    unpadded_shape=None,
    cval=0.0,
):
    return rotate_fwd(
        flow_fwd(
            shift_fwd(
                pad_fwd(unpadded, padded_shape=padded_shape, cval=cval),
                shift,
            ),
            flow,
            cval=cval,
        ),
        angle,
        cval=cval,
    )


def alignment_adj(
    rotated,
    flow,
    shift,
    unpadded_shape,
    angle,
    padded_shape=None,
    cval=0.0,
):
    return pad_adj(
        shift_adj(
            flow_adj(
                rotate_adj(rotated, angle, cval=cval),
                flow,
                cval=cval,
            ),
            shift,
        ),
        unpadded_shape=unpadded_shape,
    )


def alignment_inv(
    rotated,
    flow,
    shift,
    unpadded_shape,
    angle,
    padded_shape=None,
    cval=0.0,
):
    from .flow import flow_fwd as _ffwd
    from .rotate import rotate_fwd as _rfwd

    return pad_adj(
        shift_adj(
            _ffwd(
                _rfwd(
                    rotated,
                    None if angle is None else -angle,
                    cval=cval,
                ),
                None if flow is None else -flow,
                cval=cval,
            ),
            shift,
        ),
        unpadded_shape=unpadded_shape,
    )


# The driver-facing variants run the whole pad->shift->flow->rotate
# composition as ONE program.
alignment_fwd_p = jax.jit(
    alignment_fwd, static_argnames=("padded_shape", "unpadded_shape")
)
alignment_adj_p = jax.jit(
    alignment_adj, static_argnames=("padded_shape", "unpadded_shape")
)
alignment_inv_p = jax.jit(
    alignment_inv, static_argnames=("padded_shape", "unpadded_shape")
)

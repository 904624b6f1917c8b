"""Farneback dense optical-flow alignment.

Equivalent of `upstream/src/tike/align/solvers/farneback.py`: a thin
wrapper around OpenCV's calcOpticalFlowFarneback on 8-bit rescaled images.
OpenCV is an optional host-side dependency (as in the reference); the import
is deferred so the rest of the align package works without it.
"""

from __future__ import annotations

import numpy as np


def _rescale_8bit(a, b, hi=None, lo=None):
    """Map a, b onto a shared robust 8-bit range estimated from b.

    Farneback operates on 8-bit images, so both frames must share one
    contrast window. When no window is given, it is estimated from b by
    discarding the sparsely-populated intensity tails (outlier pixels would
    otherwise compress all real contrast into a few grey levels).
    """
    if hi is None or lo is None:
        lo, hi = np.quantile(b, (0.001, 0.999))
        if hi <= lo:
            lo, hi = float(np.min(b)), float(np.max(b))
    span = hi - lo if hi > lo else 1.0
    a = np.clip(255 * (a - lo) / span, 0, 255)
    b = np.clip(255 * (b - lo) / span, 0, 255)
    return a, b


def farneback(
    op,
    original,
    unaligned,
    pyr_scale=0.5,
    levels=5,
    winsize=19,
    num_iter=16,
    poly_n=5,
    poly_sigma=1.1,
    flow=None,
    hi=None,
    lo=None,
    **kwargs,
):
    """Find the flow from unaligned to original with Farneback's algorithm.

    original, unaligned (L, M, N) float32. Returns {'flow': (L, M, N, 2)}.
    """
    try:
        from cv2 import calcOpticalFlowFarneback
    except ImportError as e:
        raise ImportError(
            "The farneback alignment solver requires OpenCV (cv2), which is "
            "an optional host-side dependency. Use the cross_correlation "
            "solver for rigid alignment without OpenCV."
        ) from e

    original = np.asarray(original)
    unaligned = np.asarray(unaligned)
    shape = original.shape
    assert original.dtype == np.float32, original.dtype
    assert unaligned.dtype == np.float32, unaligned.dtype

    if flow is None:
        flow = np.zeros((*shape, 2), dtype="float32")
    else:
        flow = np.asarray(flow)[..., ::-1].copy()

    for i in range(len(original)):
        flow[i] = calcOpticalFlowFarneback(
            *_rescale_8bit(
                original[i],
                unaligned[i],
                hi=hi[i] if hi is not None else None,
                lo=lo[i] if lo is not None else None,
            ),
            flow=flow[i],
            pyr_scale=pyr_scale,
            levels=levels,
            winsize=winsize,
            iterations=num_iter,
            poly_n=poly_n,
            poly_sigma=poly_sigma,
            flags=4,
        )
    return {"flow": flow[..., ::-1], "cost": -1}

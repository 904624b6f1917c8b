"""Bilinear patch extraction / accumulation at fractional scan positions.

Plain-XLA replacement for the reference CUDA kernels `fwd_patch`/`adj_patch`
(`upstream/src/tike/operators/cupy/convolution.cu:146-165` launched from
`patch.py:79-188`), which run one CUDA thread per patch pixel and accumulate
with atomicAdd. Two formulations of the same linear operator live here:

- the production pair :func:`patch_fwd` / :func:`patch_adj`: windows are
  addressed through (8, 128)-aligned tiles and the residual shift plus the
  bilinear blend are folded into small banded selection-matrix einsums;
- :func:`patch_adj_scatter`: the upstream design, one XLA scatter-add of all
  bilinear windows. On a GPU it lowers to atomics, so its sums (like the
  upstream kernel's) vary in the last bits from run to run.

Semantics notes (match the reference):
- ``positions`` are (y, x) coordinates of the *minimum corner* of each patch
  in image coordinates; fractional parts trigger bilinear interpolation.
- Boundary behavior (pinned by ``tests/operators/test_patch.py``): for any
  NON-NEGATIVE position — including positions arbitrarily far past the
  bottom/right edge — the forward reads zeros for out-of-image pixels and
  the adjoint drops out-of-image contributions, exactly matching the
  reference kernel's zero-weighting (`convolution.cu:27-49`); the alignment
  padding doubles as the zero-weight region and the pair stays an exact
  transpose. NEGATIVE positions are undefined (XLA clamps the aligned tile
  start, producing finite but shifted reads / dropped writes); as in the
  reference, the driver-level ``check_allowed_positions`` (positions >= 1)
  rejects them before any solver path, and position updates inside solvers
  clamp to the valid window.
"""

from __future__ import annotations

import functools


import jax
import jax.numpy as jnp


def _c2f(x):
    """View complex as leading-axis (re, im) float channels.

    All windowed gathers, scatters and selection einsums below run on real
    float channels and recombine at the end. The channel axis leads (2, ...)
    so the minor two dims stay the large, contiguous image axes. Real
    inputs pass through unchanged.
    """
    if jnp.iscomplexobj(x):
        return jnp.stack([x.real, x.imag], axis=0)
    return x[None]


def _f2c(x, dtype):
    if jnp.issubdtype(dtype, jnp.complexfloating):
        return jax.lax.complex(x[0], x[1]).astype(dtype)
    return x[0].astype(dtype)


def _split_positions(positions):
    """Split float positions into integer corners and fractional weights."""
    lo = jnp.floor(positions)
    frac = positions - lo
    return lo.astype(jnp.int32), frac


# Tiled formulation: every window is addressed through a corner aligned to an
# (8, 128) tile grid, so gathers and read-modify-writes touch whole tiles.
# The residual shift (corner mod (8, 128)) AND the bilinear fractional blend
# are folded into tiny banded selection matrices applied as einsums:
#   patch  = R^T @ tile @ C      (forward)
#   tile   = R @ patch @ C^T     (adjoint)
# where R = (1-fy)*S_ry + fy*S_{ry+1} selects/blends rows shifted by the
# row residual, and C does the same for columns. S_s are dynamic slices of a
# static banded 0/1 matrix, so the whole operator is gather-free.
_SUB, _LANE = 8, 128


def _tile_dims(p: int, sub: int = _SUB, lane: int = _LANE) -> tuple[int, int]:
    th = -(-(p + sub) // 8) * 8
    tw = -(-(p + lane) // lane) * lane
    return th, tw


def _selection_mats(p: int, corner, frac, sub: int = _SUB, lane: int = _LANE):
    """Per-window row/column selection+blend matrices (N,th,p), (N,tw,p)."""
    th, tw = _tile_dims(p, sub, lane)
    ry = corner[:, 0] % sub
    rx = corner[:, 1] % lane
    fy = frac[:, 0][:, None, None]
    fx = frac[:, 1][:, None, None]

    # S_s[y, j] = 1 iff y == j + s, blended over s in {r, r+1}. Built by
    # broadcast-comparing a static (rows, p) difference matrix against the
    # per-window residual — pure elementwise, no gather.
    dy = jnp.arange(th, dtype=jnp.int32)[:, None] - jnp.arange(
        p, dtype=jnp.int32
    )
    dx = jnp.arange(tw, dtype=jnp.int32)[:, None] - jnp.arange(
        p, dtype=jnp.int32
    )
    ryn = ry[:, None, None]
    rxn = rx[:, None, None]
    R = jnp.where(dy == ryn, 1 - fy, 0.0) + jnp.where(dy == ryn + 1, fy, 0.0)
    C = jnp.where(dx == rxn, 1 - fx, 0.0) + jnp.where(dx == rxn + 1, fx, 0.0)
    return R.astype(jnp.float32), C.astype(jnp.float32)


def _aligned_corners(corner, sub: int = _SUB, lane: int = _LANE):
    cy = corner[:, 0] - corner[:, 0] % sub
    cx = corner[:, 1] - corner[:, 1] % lane
    return cy, cx


def _padded_image_dims(
    h: int, w: int, p: int, sub: int = _SUB, lane: int = _LANE
) -> tuple[int, int]:
    th, tw = _tile_dims(p, sub, lane)
    return -(-h // sub) * sub + th, -(-w // lane) * lane + tw


def patch_fwd(
    images: jax.Array,
    positions: jax.Array,
    patch_width: int,
    precision=jax.lax.Precision.HIGHEST,
) -> jax.Array:
    """Extract bilinearly-interpolated square patches from an image.

    Parameters
    ----------
    images : (H, W) complex
    positions : (N, 2) float — (y, x) min-corner of each patch
    patch_width : int — static width P of the extracted patches

    Returns
    -------
    patches : (N, P, P) complex
    """
    p = patch_width
    h, w = images.shape
    n = positions.shape[0]
    corner, frac = _split_positions(positions)
    imf = _c2f(images)  # (C, H, W)
    nch = imf.shape[0]
    th, tw = _tile_dims(p)
    hp, wp = _padded_image_dims(h, w, p)
    padded = jnp.pad(imf, ((0, 0), (0, hp - h), (0, wp - w)))
    cy, cx = _aligned_corners(corner)

    # Fetch each window's (8, 128) tiles with ONE jnp.take of whole tiles
    # instead of a vmapped dynamic_slice per window.
    nbands, ntx = hp // _SUB, wp // _LANE
    ky, kx = th // _SUB, tw // _LANE
    # Clamp the band and tile-column indices BEFORE flattening: a window
    # past the bottom/right edge then reads the trailing zero-padding tiles
    # instead of aliasing into the next band (or off the end of the array).
    by = jnp.clip(
        (cy // _SUB)[:, None] + jnp.arange(ky, dtype=jnp.int32), 0, nbands - 1
    )
    bx = jnp.clip(
        (cx // _LANE)[:, None] + jnp.arange(kx, dtype=jnp.int32), 0, ntx - 1
    )
    tile_idx = (by[:, :, None] * ntx + bx[:, None, :]).reshape(-1)
    q = jnp.moveaxis(
        padded.reshape(nch, nbands, _SUB, ntx, _LANE), 3, 2
    ).reshape(nch, nbands * ntx, _SUB, _LANE)
    tiles = jnp.take(q, tile_idx, axis=1).reshape(
        nch, n, ky, kx, _SUB, _LANE
    )
    R, C = _selection_mats(p, corner, frac)
    # patch = R^T @ tile @ C, the (y, x) contractions decomposed over the
    # (8, 128) tile grid as two batched matmuls. Default HIGHEST keeps f32
    # blend weights (the parity surface); solver internals pass
    # tike_tpu.precision.SOLVER_MATMUL.
    Rt = R.reshape(n, ky, _SUB, p)
    Ct = C.reshape(n, kx, _LANE, p)
    t1 = jnp.einsum(
        "nuya,cnuvyx->cnavx", Rt, tiles, precision=precision
    )  # (C, N, P, kx, 128)
    out = jnp.einsum("cnavx,nvxb->cnab", t1, Ct, precision=precision)
    # (C, N, P, P) -> complex (N, P, P)
    return _f2c(out, images.dtype)


def _spread_windows_f(patches_f: jax.Array, frac: jax.Array) -> jax.Array:
    """Spread (N, C, P, P) float patches into (N, C, P+1, P+1) windows."""
    n, c, p, _ = patches_f.shape
    fy = frac[:, None, 0][:, :, None, None]
    fx = frac[:, None, 1][:, :, None, None]
    win = jnp.zeros((n, c, p + 1, p + 1), dtype=patches_f.dtype)
    win = win.at[:, :, :-1, :-1].add((1 - fy) * (1 - fx) * patches_f)
    win = win.at[:, :, :-1, 1:].add((1 - fy) * fx * patches_f)
    win = win.at[:, :, 1:, :-1].add(fy * (1 - fx) * patches_f)
    win = win.at[:, :, 1:, 1:].add(fy * fx * patches_f)
    return win


def patch_adj_scatter(
    patches: jax.Array,
    positions: jax.Array,
    images_shape: tuple[int, int],
    images: jax.Array | None = None,
) -> jax.Array:
    """patch_adj via one big XLA scatter-add (the upstream kernel's design).

    Colliding windows accumulate through the scatter; on a GPU that is
    atomics, so the sum's rounding varies from run to run. See
    :func:`patch_adj` for the production version.
    """
    h, w = images_shape
    n, p, _ = patches.shape
    corner, frac = _split_positions(positions)
    pf = jnp.moveaxis(_c2f(patches), 0, 1)  # (N, C, P, P)
    win = _spread_windows_f(pf, frac)  # (N, C, P+1, P+1)
    nch = win.shape[1]

    span = jnp.arange(p + 1, dtype=jnp.int32)
    rows = corner[:, 0:1] + span[None, :]  # (N, P+1)
    cols = corner[:, 1:2] + span[None, :]  # (N, P+1)
    flat = (rows[:, :, None] * w + cols[:, None, :]).reshape(-1)
    # Out-of-image pixels must be DROPPED (the reference kernel's
    # zero-weighting, convolution.cu:27-49). The flat index alone would
    # alias out-of-range columns into the next row, so send any pixel
    # outside [0,h)x[0,w) to an index mode="drop" discards.
    oob = (
        (rows[:, :, None] < 0)
        | (rows[:, :, None] >= h)
        | (cols[:, None, :] < 0)
        | (cols[:, None, :] >= w)
    ).reshape(-1)
    flat = jnp.where(oob, h * w, flat)

    if images is None:
        acc = jnp.zeros((nch, h * w), dtype=pf.dtype)
    else:
        acc = _c2f(images).reshape(nch, h * w)
    acc = acc.at[:, flat].add(
        jnp.moveaxis(win, 1, 0).reshape(nch, -1),
        mode="drop",
        unique_indices=False,
    )
    return _f2c(acc.reshape(nch, h, w), patches.dtype)


def uses_cell_grid(images_shape: tuple[int, int], n: int) -> bool:
    """Whether :func:`patch_adj` merges ``n`` windows on the coarse cell grid
    (True) or accumulates them with a sequential scan (False)."""
    h, w = images_shape
    return (-(-h // 128) + 1) * (-(-w // _LANE) + 1) < n


def patch_adj(
    patches: jax.Array,
    positions: jax.Array,
    images_shape: tuple[int, int],
    images: jax.Array | None = None,
    precision=jax.lax.Precision.HIGHEST,
) -> jax.Array:
    """Adjoint of :func:`patch_fwd`: accumulate patches into an image.

    Tiled formulation, scatter-free: each patch is rendered into a tile
    whose corner is (8, 128)-aligned — the residual offset and the bilinear
    fractional blend folded into selection matrices (tile = R @ patch @ C^T)
    — and the tiles are accumulated either by a one-hot merge onto a coarse
    cell grid plus a few dense shifted adds (dense scans), or by a
    sequential scan of aligned dynamic_update_slices, which XLA performs in
    place. Both are deterministic and handle overlapping windows exactly.

    Parameters
    ----------
    patches : (N, P, P) complex
    positions : (N, 2) float
    images_shape : (H, W) — static output shape
    images : optional (H, W) initial accumulator
    """
    h, w = images_shape
    n, p, _ = patches.shape
    corner, frac = _split_positions(positions)
    pf = jnp.moveaxis(_c2f(patches), 0, 1)  # (N, C, P, P)
    nch = pf.shape[1]

    # When the (sub x 128) corner grid has fewer cells than there are
    # windows, merge the tiles of each cell with a one-hot matmul and scan
    # over cells instead of windows (the sequential scan is the
    # latency-bound part). Coarser row alignment (sub=128) shrinks the grid
    # at the cost of taller tiles; it wins for dense scans.
    sub = _SUB
    gy = -(-h // 128) + 1
    gx = -(-w // _LANE) + 1
    merge = uses_cell_grid((h, w), n)
    if merge:
        sub = 128

    th, tw = _tile_dims(p, sub)
    cy, cx = _aligned_corners(corner, sub)

    # tile = R @ patch @ C^T: the exact transpose of the forward's
    # selection-matrix extraction. Default HIGHEST is the parity surface;
    # solver gradient internals pass tike_tpu.precision.SOLVER_MATMUL.
    R, C = _selection_mats(p, corner, frac, sub)
    tiles = jnp.einsum(
        "nya,ncab,nxb->ncyx",
        R,
        pf,
        C,
        precision=precision,
    )  # (N, C, th, tw)

    hp, wp = _padded_image_dims(h, w, p, sub)
    if merge:
        g = gy * gx
        gid = (cy // sub) * gx + (cx // _LANE)
        onehot = (
            gid[:, None] == jnp.arange(g, dtype=jnp.int32)[None, :]
        ).astype(jnp.float32)
        tiles = jnp.einsum(
            "ng,ncyx->gcyx", onehot, tiles, precision=precision
        )
        # The merged tiles live on an exact (sub x 128) cell grid, so the
        # sequential scan of read-modify-writes (169+ tiny steps whose
        # per-step launch overhead dominated) is replaced by splitting each
        # tile into cell-aligned chunks and doing ky*kx (typically 4) DENSE
        # shifted adds over the whole cell grid — no scan, no scatter.
        ky = -(-th // sub)
        kx = -(-tw // _LANE)
        tiles = jnp.pad(
            tiles,
            ((0, 0), (0, 0), (0, ky * sub - th), (0, kx * _LANE - tw)),
        )
        q = tiles.reshape(gy, gx, nch, ky, sub, kx, _LANE)
        grid = jnp.zeros(
            (gy + ky, gx + kx, nch, sub, _LANE), dtype=pf.dtype
        )
        for iy in range(ky):
            for ix in range(kx):
                grid = grid.at[iy : iy + gy, ix : ix + gx].add(
                    q[:, :, :, iy, :, ix, :]
                )
        acc = grid.transpose(2, 0, 3, 1, 4).reshape(
            nch, (gy + ky) * sub, (gx + kx) * _LANE
        )
        if images is not None:
            acc = acc.at[:, :h, :w].add(_c2f(images))
        return _f2c(acc[:, :h, :w], patches.dtype)

    if images is None:
        acc0 = jnp.zeros((nch, hp, wp), dtype=pf.dtype)
    else:
        acc0 = jnp.pad(_c2f(images), ((0, 0), (0, hp - h), (0, wp - w)))

    def body(acc, inp):
        tile, y0, x0 = inp
        cur = jax.lax.dynamic_slice(acc, (0, y0, x0), (nch, th, tw))
        return (
            jax.lax.dynamic_update_slice(acc, cur + tile, (0, y0, x0)),
            None,
        )

    acc, _ = jax.lax.scan(body, acc0, (tiles, cy, cx))
    return _f2c(acc[:, :h, :w], patches.dtype)


@functools.partial(jax.jit, static_argnames=("patch_width", "padded_width"))
def patch_fwd_padded(
    images: jax.Array,
    positions: jax.Array,
    patch_width: int,
    padded_width: int,
) -> jax.Array:
    """Extract patches zero-padded to ``padded_width`` (detector size).

    The valid P×P region is centered: offset pad = (padded - P) // 2, matching
    the reference's padding convention (`convolution.py:56-101`).
    """
    patches = patch_fwd(images, positions, patch_width)
    pad = (padded_width - patch_width) // 2
    if pad == 0 and padded_width == patch_width:
        return patches
    return jnp.pad(
        patches,
        ((0, 0), (pad, padded_width - patch_width - pad),
         (pad, padded_width - patch_width - pad)),
    )


def patch_fwd_fourier(
    images: jax.Array,
    positions: jax.Array,
    patch_width: int,
) -> jax.Array:
    """Patch extraction with Fourier-shift sub-pixel interpolation.

    Equivalent of the reference's ConvolutionFFT path
    (`convolution.py:156-292`): extract at the integer corner, then apply the
    fractional part as a Fourier phase-ramp shift of each patch. Band-limited
    (sinc) interpolation instead of bilinear.
    """
    from .shift import shift_adj

    lo = jnp.floor(positions)
    frac = positions - lo
    patches = patch_fwd(images, lo, patch_width)
    return shift_adj(patches, frac)


def patch_adj_fourier(
    patches: jax.Array,
    positions: jax.Array,
    images_shape: tuple,
    images: jax.Array | None = None,
) -> jax.Array:
    """Adjoint of :func:`patch_fwd_fourier`."""
    from .shift import shift_fwd

    lo = jnp.floor(positions)
    frac = positions - lo
    shifted = shift_fwd(patches, frac)
    return patch_adj(shifted, lo, images_shape, images)

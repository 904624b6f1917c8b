"""Patch gather/scatter operator tests.

Mirrors the reference's `tests/operators/test_patch.py` strategy: adjoint
property plus a numpy oracle for the bilinear interpolation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tike_tpu.ops import patch_fwd, patch_adj, patch_fwd_padded
from .util import random_complex, check_adjoint

H, W, P, N = 64, 70, 16, 27


def _setup(seed=0):
    rng = np.random.default_rng(seed)
    images = random_complex(rng, H, W)
    # In-bounds fractional positions with the reference's margin.
    positions = np.stack(
        [
            rng.uniform(1, H - P - 2, N),
            rng.uniform(1, W - P - 2, N),
        ],
        axis=-1,
    ).astype(np.float32)
    patches = random_complex(rng, N, P, P)
    return images, positions, patches


def _patch_fwd_oracle(images, positions, p):
    """Pure-numpy bilinear patch extraction oracle."""
    out = np.zeros((len(positions), p, p), dtype=images.dtype)
    for i, (y, x) in enumerate(positions):
        iy, ix = int(np.floor(y)), int(np.floor(x))
        fy, fx = y - iy, x - ix
        win = images[iy : iy + p + 1, ix : ix + p + 1]
        out[i] = (
            (1 - fy) * (1 - fx) * win[:-1, :-1]
            + (1 - fy) * fx * win[:-1, 1:]
            + fy * (1 - fx) * win[1:, :-1]
            + fy * fx * win[1:, 1:]
        )
    return out


def test_fwd_matches_oracle():
    images, positions, _ = _setup()
    got = np.asarray(patch_fwd(jnp.asarray(images), jnp.asarray(positions), P))
    want = _patch_fwd_oracle(images, positions, P)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_adjoint():
    images, positions, patches = _setup()
    fwd = patch_fwd(jnp.asarray(images), jnp.asarray(positions), P)
    adj = patch_adj(jnp.asarray(patches), jnp.asarray(positions), (H, W))
    check_adjoint(fwd, images, adj, patches)


def test_adjoint_integer_positions():
    images, positions, patches = _setup()
    positions = np.floor(positions).astype(np.float32)
    fwd = patch_fwd(jnp.asarray(images), jnp.asarray(positions), P)
    adj = patch_adj(jnp.asarray(patches), jnp.asarray(positions), (H, W))
    check_adjoint(fwd, images, adj, patches)


def test_fwd_padded_centers_patch():
    images, positions, _ = _setup()
    det = P + 10
    padded = np.asarray(
        patch_fwd_padded(jnp.asarray(images), jnp.asarray(positions), P, det)
    )
    assert padded.shape == (N, det, det)
    pad = (det - P) // 2
    inner = padded[:, pad : pad + P, pad : pad + P]
    np.testing.assert_allclose(
        inner, _patch_fwd_oracle(images, positions, P), rtol=1e-5, atol=1e-5
    )
    # Everything outside the central region is zero padding.
    total = np.abs(padded).sum()
    np.testing.assert_allclose(total, np.abs(inner).sum(), rtol=1e-6)


def test_accumulation_into_existing_image():
    images, positions, patches = _setup()
    base = random_complex(np.random.default_rng(7), H, W)
    out = patch_adj(
        jnp.asarray(patches), jnp.asarray(positions), (H, W), jnp.asarray(base)
    )
    zero = patch_adj(jnp.asarray(patches), jnp.asarray(positions), (H, W))
    np.testing.assert_allclose(
        np.asarray(out), base + np.asarray(zero), rtol=1e-5, atol=1e-5
    )


def test_fourier_patch_adjoint_and_integer_agreement():
    from tike_tpu.ops.patch import patch_fwd_fourier, patch_adj_fourier

    images, positions, patches = _setup()
    f = patch_fwd_fourier(jnp.asarray(images), jnp.asarray(positions), P)
    a = patch_adj_fourier(jnp.asarray(patches), jnp.asarray(positions), (H, W))
    check_adjoint(f, images, a, patches, rtol=1e-3)
    # At integer positions, Fourier and bilinear paths agree exactly.
    ipos = np.floor(positions).astype(np.float32)
    f_int = patch_fwd_fourier(jnp.asarray(images), jnp.asarray(ipos), P)
    b_int = patch_fwd(jnp.asarray(images), jnp.asarray(ipos), P)
    np.testing.assert_allclose(
        np.asarray(f_int), np.asarray(b_int), rtol=1e-4, atol=1e-5
    )


def test_patch_ops_irregular_sizes():
    """Adjoint property + oracle across patch widths and dense/sparse
    regimes, including non-power-of-2 and odd widths.

    Exercises both accumulation paths of patch_adj (the dense merged-cell
    path when windows outnumber grid cells, the per-window scan otherwise)
    and the tile padding for widths that do not quarter evenly.
    """
    import jax

    rng = np.random.default_rng(3)
    for p, h, w, n in [
        (8, 48, 48, 100),     # dense -> merged-cell path
        (24, 100, 90, 12),    # sparse -> per-window scan path
        (100, 260, 300, 40),  # non-power-of-2, tile pads unevenly
        (33, 140, 150, 80),   # odd width
    ]:
        images = random_complex(rng, h, w)
        positions = np.stack(
            [rng.uniform(1, h - p - 2, n), rng.uniform(1, w - p - 2, n)],
            axis=-1,
        ).astype(np.float32)
        patches = random_complex(rng, n, p, p)
        fwd = patch_fwd(jnp.asarray(images), jnp.asarray(positions), p)
        want = _patch_fwd_oracle(images, positions, p)
        np.testing.assert_allclose(
            np.asarray(fwd), want, rtol=1e-4, atol=1e-4,
            err_msg=f"p={p}",
        )
        adj = patch_adj(
            jnp.asarray(patches), jnp.asarray(positions), (h, w)
        )
        check_adjoint(fwd, images, adj, patches)
        # patch_adj agrees with the scatter-oracle formulation.
        from tike_tpu.ops.patch import patch_adj_scatter

        oracle = patch_adj_scatter(
            jnp.asarray(patches), jnp.asarray(positions), (h, w)
        )
        scale = float(jnp.max(jnp.abs(oracle)))
        assert (
            float(jnp.max(jnp.abs(adj - oracle))) / scale < 1e-4
        ), f"p={p}"


def _zero_weight_fwd_oracle(images, positions, p):
    """Reference-kernel semantics (`convolution.cu:27-49`): out-of-image
    pixels contribute zero weight. Valid for any position, not just
    in-bounds ones."""
    h, w = images.shape
    out = np.zeros((len(positions), p, p), dtype=images.dtype)
    for i, (y, x) in enumerate(positions):
        iy, ix = int(np.floor(y)), int(np.floor(x))
        fy, fx = y - iy, x - ix
        for oy, wy in ((0, (1 - fy)), (1, fy)):
            for ox, wx in ((0, (1 - fx)), (1, fx)):
                rows = iy + oy + np.arange(p)
                cols = ix + ox + np.arange(p)
                rmask = (rows >= 0) & (rows < h)
                cmask = (cols >= 0) & (cols < w)
                sub = np.zeros((p, p), dtype=images.dtype)
                rr = rows[rmask]
                cc = cols[cmask]
                sub[np.ix_(rmask, cmask)] = images[np.ix_(rr, cc)]
                out[i] += wy * wx * sub
    return out


def _zero_weight_adj_oracle(patches, positions, shape):
    """Exact transpose of _zero_weight_fwd_oracle: out-of-image
    contributions are dropped."""
    h, w = shape
    out = np.zeros(shape, dtype=patches.dtype)
    p = patches.shape[-1]
    for patch, (y, x) in zip(patches, positions):
        iy, ix = int(np.floor(y)), int(np.floor(x))
        fy, fx = y - iy, x - ix
        for oy, wy in ((0, (1 - fy)), (1, fy)):
            for ox, wx in ((0, (1 - fx)), (1, fx)):
                rows = iy + oy + np.arange(p)
                cols = ix + ox + np.arange(p)
                rmask = (rows >= 0) & (rows < h)
                cmask = (cols >= 0) & (cols < w)
                out[np.ix_(rows[rmask], cols[cmask])] += (
                    wy * wx * patch[np.ix_(rmask, cmask)]
                )
    return out


def test_out_of_bounds_semantics_pinned():
    """Pin the raw-op boundary behavior (VERDICT r3 item 7).

    For NON-NEGATIVE positions — in-bounds, straddling the bottom/right
    edge, or entirely past it — patch_fwd/patch_adj/patch_adj_scatter
    implement exactly the reference kernel's zero-weighting
    (`convolution.cu:27-49`): out-of-image pixels read as zero and
    out-of-image contributions are dropped. The fwd/adj pair remains an
    exact transpose under these positions. NEGATIVE positions are
    undefined (finite, but clamped-tile reads); solver paths guard them
    via check_allowed_positions and the in-solver position clamp.
    """
    from tike_tpu.ops.patch import patch_adj_scatter

    rng = np.random.default_rng(11)
    h, w, p = 48, 56, 12
    images = random_complex(rng, h, w)
    positions = np.array(
        [
            [3.5, 7.25],                 # in-bounds
            [h - p - 2.0, w - p - 2.0],  # last allowed corner
            [h - p + 2.5, w - p + 3.25], # straddles bottom-right edge
            [h - p + 0.5, 5.0],          # straddles bottom only
            [2.0, w - p + 6.75],         # straddles right only
            [h + 5.0, w + 9.5],          # entirely past the edge
        ],
        dtype=np.float32,
    )
    patches = random_complex(rng, len(positions), p, p)

    got_fwd = np.asarray(
        patch_fwd(jnp.asarray(images), jnp.asarray(positions), p)
    )
    want_fwd = _zero_weight_fwd_oracle(images, positions, p)
    np.testing.assert_allclose(got_fwd, want_fwd, rtol=1e-5, atol=1e-5)

    want_adj = _zero_weight_adj_oracle(patches, positions, (h, w))
    for adj_fn in (patch_adj, patch_adj_scatter):
        got_adj = np.asarray(
            adj_fn(jnp.asarray(patches), jnp.asarray(positions), (h, w))
        )
        np.testing.assert_allclose(
            got_adj, want_adj, rtol=1e-4, atol=1e-5,
            err_msg=adj_fn.__name__,
        )

    # The pair stays an exact transpose even with boundary-straddling
    # positions — the invariant gradient correctness rests on.
    check_adjoint(got_fwd, images, want_adj, patches)

    # Negative positions: documented-undefined but always finite.
    neg = np.array([[-3.5, -2.25], [-1.0, 4.5]], dtype=np.float32)
    out = np.asarray(patch_fwd(jnp.asarray(images), jnp.asarray(neg), p))
    assert np.isfinite(out).all()
    out = np.asarray(
        patch_adj(jnp.asarray(patches[:2]), jnp.asarray(neg), (h, w))
    )
    assert np.isfinite(out).all()


def test_far_out_of_range_windows_read_zeros():
    """patch_fwd clamps each tile's band and column index before
    flattening them, so windows far past the right or bottom edge read the
    zero padding instead of aliasing into the next tile band (right edge)
    or off the end of the tile array (bottom edge, which read NaN)."""
    rng = np.random.default_rng(5)
    h, w, p = 48, 56, 12
    images = random_complex(rng, h, w)
    positions = np.array(
        [
            [3.0, 376.5],    # spans the last tile column into the overflow
            [70.25, 3.0],    # bands past the bottom of the padded image
            [130.0, 500.0],  # both
        ],
        dtype=np.float32,
    )
    got = np.asarray(
        patch_fwd(jnp.asarray(images), jnp.asarray(positions), p)
    )
    np.testing.assert_array_equal(
        got, _zero_weight_fwd_oracle(images, positions, p)
    )


def test_position_update_clamps_to_valid_window():
    """Drifting position updates clamp to check_allowed_positions's valid
    region in the solver paths (VERDICT r3 item 7)."""
    from tike_tpu.ptycho.position import (
        PositionOptions,
        check_allowed_positions,
    )
    from tike_tpu.ptycho.solvers.lstsq import _update_position

    h, w, p, n = 40, 44, 8, 6
    rng = np.random.default_rng(0)
    scan = np.stack(
        [rng.uniform(1, h - p - 2, n), rng.uniform(1, w - p - 2, n)],
        axis=-1,
    ).astype(np.float32)
    opts = PositionOptions(scan)
    # A huge gradient step that would push every position far out.
    num = jnp.asarray(np.full((n, 2), 1e3, np.float32))
    den = jnp.asarray(np.ones((n, 2), np.float32))
    new_scan, _ = _update_position(
        jnp.asarray(scan), opts, num, den,
        bounds=((1, h, w), (1, 1, 1, p, p)),
    )
    check_allowed_positions(
        np.asarray(new_scan), np.zeros((1, h, w)), (1, 1, 1, p, p)
    )


def _dot_precisions(fn, *args):
    """precision of every dot_general in fn's jaxpr, sub-jaxprs included."""
    from jax.extend import core as jcore

    found = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                found.append(eqn.params["precision"])
            for value in eqn.params.values():
                for sub in value if isinstance(value, (list, tuple)) else [
                    value
                ]:
                    if isinstance(sub, jcore.ClosedJaxpr):
                        walk(sub.jaxpr)
                    elif isinstance(sub, jcore.Jaxpr):
                        walk(sub)

    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    return found


def _patch_path_cases():
    from tike_tpu.ops.ptycho import PtychoConfig
    from tike_tpu.ptycho.solvers import _preconditioner as pre
    from tike_tpu.ptycho.solvers.lstsq import _lstsq_batch_math
    from tike_tpu.ptycho.solvers.rpie import _batch_gradients_math

    from ..ptycho.test_numpy_oracle import make_inputs

    psi, probe, scan, data, precond = make_inputs(B=5, P=16, DET=32, M=2)
    cfg = PtychoConfig(probe_shape=16, detector_shape=32, nz=64, n=64)
    psi, probe = jnp.asarray(psi[None]), jnp.asarray(probe[None, None])
    idx, mask = jnp.arange(5), jnp.ones(5)
    pixels = jnp.ones((32, 32), bool)
    common = dict(noise_model="gaussian", steplength_usemodes="all_modes")
    patches = jnp.asarray(
        random_complex(np.random.default_rng(0), 5, 16, 16)
    )
    return {
        "patch_fwd": (lambda s: patch_fwd(psi[0], s, 16), scan),
        "patch_adj cell grid": (
            lambda s: patch_adj(patches, s, (64, 64)), scan
        ),
        "patch_adj scan": (
            lambda s: patch_adj(patches[:4], s[:4], (256, 256)), scan
        ),
        "rpie batch": (
            lambda s: _batch_gradients_math(
                cfg, data, s, idx, mask, psi, probe, None, None, pixels,
                0.5, 0.5, 1.0, recover_probe=True, **common,
            ),
            scan,
        ),
        "lstsq batch": (
            lambda s: _lstsq_batch_math(
                cfg, data, s, idx, mask, psi, probe, None, None, pixels,
                jnp.asarray(precond[None]), 0.5, 0.5, 1.0, num_batch=3.0,
                recover_psi=True, recover_probe=True,
                recover_positions=True, **common,
            ),
            scan,
        ),
        "psi preconditioner": (
            lambda s: pre._psi_precond_math(cfg, psi, s, probe), scan
        ),
        "probe preconditioner": (
            lambda s: pre._probe_precond_math(cfg, psi, s), scan
        ),
    }


@pytest.mark.parametrize(
    "case",
    [
        "patch_fwd",
        "patch_adj cell grid",
        "patch_adj scan",
        "rpie batch",
        "lstsq batch",
        "psi preconditioner",
        "probe preconditioner",
    ],
)
def test_patch_path_matmuls_state_their_precision(case):
    """No matrix product on the patch path is left at an implicit DEFAULT,
    which a GPU may run in TF32."""
    fn, scan = _patch_path_cases()[case]
    precisions = _dot_precisions(fn, jnp.asarray(scan))
    assert precisions, "no matrix product traced"
    assert all(p is not None for p in precisions), precisions

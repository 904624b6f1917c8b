"""Object and probe preconditioners.

JAX equivalent of
`upstream/src/tike/ptycho/solvers/_preconditioner.py`:
- psi preconditioner = sum over positions of |probe|^2 scatter-added into the
  object frame, per slice (`_preconditioner.py:48-104`);
- probe preconditioner = sum over positions of |patches|^2, per slice
  (`_preconditioner.py:116-167`).

Each is a single jitted XLA program over all positions (the reference streams
chunks because its data is host-pinned; ours is device-resident).
"""

from __future__ import annotations

import os as _os

import jax
import jax.numpy as jnp

from tike_tpu import precision
from tike_tpu.ops.patch import patch_adj, patch_fwd
from tike_tpu.ops.propagation import fresnel_fwd
from tike_tpu.ops.ptycho import PtychoConfig
from .options import PtychoParameters

_jit_add = jax.jit(lambda a, b: jax.tree_util.tree_map(jnp.add, a, b))


def _psi_precond_math(cfg: PtychoConfig, psi, scan, probe, mask=None):
    """Return (D, H, W) sum of |illumination|^2 at each object pixel.

    `mask` (N,) optionally zeroes padded batch slots.
    """
    n = scan.shape[0]
    p = cfg.probe_shape
    w = jnp.ones(n, probe.real.dtype) if mask is None else mask

    # Real-valued throughout: |probe|^2 is real, so the patch scatter runs
    # on ONE float channel instead of a complex pair (half the matmul work).
    probe_amp = jnp.sum(
        (probe[0, 0] * jnp.conj(probe[0, 0])).real, axis=0
    )  # (P, P) f32
    slices = [
        patch_adj(
            probe_amp[None] * w[:, None, None].astype(probe_amp.dtype),
            scan,
            (cfg.nz, cfg.n),
            precision=precision.SOLVER_MATMUL,
        )
    ]

    if cfg.nslices > 1:
        prop = cfg.propagator()
        probe1 = jnp.broadcast_to(probe[0, 0], (n, probe.shape[-3], p, p))
        for i in range(1, cfg.nslices):
            patches = patch_fwd(
                psi[i - 1], scan, p, precision=precision.SOLVER_MATMUL
            )
            probe1 = fresnel_fwd(patches[:, None] * probe1, prop)
            amp = jnp.sum(
                (probe1 * jnp.conj(probe1)).real, axis=1
            )  # (N, P, P) f32
            slices.append(
                patch_adj(
                    amp * w[:, None, None].astype(amp.dtype),
                    scan,
                    (cfg.nz, cfg.n),
                    precision=precision.SOLVER_MATMUL,
                )
            )

    return jnp.stack(slices)


def _probe_precond_math(cfg: PtychoConfig, psi, scan, mask=None):
    """Return (D, P, P) sum of |object patches|^2 per slice."""
    w = (
        jnp.ones(scan.shape[0], psi.real.dtype)
        if mask is None
        else mask
    )
    slices = []
    for i in range(cfg.nslices):
        patches = patch_fwd(
            psi[i], scan, cfg.probe_shape,
            precision=precision.SOLVER_MATMUL,
        )
        slices.append(
            jnp.sum(
                (patches * jnp.conj(patches)).real
                * w[:, None, None].astype(jnp.float32),
                axis=0,
            )
        )
    return jnp.stack(slices)


# ---------------------------------------------------------------------------
# FFT formulation (single slice): both preconditioners are sums over ALL
# positions of bilinearly-placed quantities, so they factor through small
# point densities scattered at integer pixels:
#   psi_pre   = (4-term bilinear density)  *  |probe|^2          (convolution)
#   probe_pre = sum_delta 2Re[(pair density_delta) star Z_delta] (correlation)
# where Z_delta(y,x) = psi(y,x) conj psi(y+dy, x+dx) covers the 3x3 bilinear
# cross terms of |interpolated patch|^2 (delta in {0,+-1}^2, half set by
# conjugate symmetry). Each is a handful of full-object FFTs instead of a
# gather of every patch — O(S^2 log S) vs O(N P^2) — and EXACT (same
# interp-then-square math as the reference kernel, not an approximation).
# ---------------------------------------------------------------------------


# TIKE_FFT_PRECOND selects the single-slice epoch programs' preconditioner
# formulation (exact either way; see tests/ptycho/test_precond_fft.py).
# Default on, gated per shape by fft_precond_profitable; set
# TIKE_FFT_PRECOND=0 to force the per-batch patch-gather formulation.
USE_FFT_PRECOND = _os.environ.get("TIKE_FFT_PRECOND", "1") == "1"


def fft_precond_profitable(
    n_positions: int, probe_shape: int, nz: int, n: int
) -> bool:
    """Whether the FFT formulation beats the per-position gather here.

    Cost model: the gather formulation touches one aligned (th x tw) tile
    per position; the FFT formulation pays a handful of full-object FFTs
    (~ s1*s2*log2 work) regardless of position count. The crossover
    constant 3.0 was fitted on another accelerator, between the 10k x 128²
    headline scan of a 1500² object (ratio 5.4, FFT faster) and the
    516 x 128² siemens-star scan (ratio 2.4, gather faster); it is to be
    re-fitted on the H100.
    """
    from tike_tpu.ops.patch import _tile_dims

    th, tw = _tile_dims(probe_shape)
    s1 = _fft_len(nz + probe_shape + 1)
    s2 = _fft_len(n + probe_shape + 1)
    import numpy as _np

    return n_positions * th * tw > 3.0 * s1 * s2 * _np.log2(s1 * s2)


def _fft_len(n: int) -> int:
    """Smallest 5-smooth length >= n (fast XLA FFT sizes)."""
    m = n
    while True:
        k = m
        for p in (2, 3, 5):
            while k % p == 0:
                k //= p
        if k == 1:
            return m
        m += 1


def _bilinear_split(scan):
    corner = jnp.floor(scan)
    fy = scan[:, 0] - corner[:, 0]
    fx = scan[:, 1] - corner[:, 1]
    Y = corner[:, 0].astype(jnp.int32)
    X = corner[:, 1].astype(jnp.int32)
    return Y, X, (1 - fy, fy), (1 - fx, fx)


def _psi_precond_fft_math(cfg: PtychoConfig, scan, probe, w):
    """Single-slice psi preconditioner as density-conv-|probe|^2.

    Exactly :func:`_psi_precond_math` (by linearity of the patch adjoint):
    the same |probe|^2 is spread at every position, so the sum is the
    4-corner bilinear point density convolved with |probe|^2.
    """
    h, wd, p = cfg.nz, cfg.n, cfg.probe_shape
    Y, X, wy, wx = _bilinear_split(scan)
    d = jnp.zeros((h + 1, wd + 1), jnp.float32)
    for a in (0, 1):
        for b in (0, 1):
            d = d.at[Y + a, X + b].add(w * wy[a] * wx[b])
    probe_amp = jnp.sum((probe[0, 0] * jnp.conj(probe[0, 0])).real, axis=0)
    s1, s2 = _fft_len(h + p + 1), _fft_len(wd + p + 1)
    out = jnp.fft.irfft2(
        jnp.fft.rfft2(d, s=(s1, s2)) * jnp.fft.rfft2(probe_amp, s=(s1, s2)),
        s=(s1, s2),
    )[:h, :wd]
    return out[None].astype(jnp.float32)


def _probe_precond_fft_math(cfg: PtychoConfig, psi, scan, w):
    """Single-slice probe preconditioner via 5 density-correlations.

    Expands sum_s |bilinear-interp patch_s|^2 into its 16 bilinear cross
    terms, grouped by pixel offset delta: interp-then-square, identical to
    :func:`_probe_precond_math` / the reference kernel semantics.
    """
    h, wd, p = cfg.nz, cfg.n, cfg.probe_shape
    psi0 = psi[0]
    Y, X, wy, wx = _bilinear_split(scan)
    rho = jnp.zeros((5, h + 2, wd + 2), jnp.float32)
    for a in (0, 1):
        for b in (0, 1):
            rho = rho.at[0, Y + a, X + b].add(w * (wy[a] * wx[b]) ** 2)
    for a in (0, 1):  # delta = (0, 1)
        rho = rho.at[1, Y + a, X].add(w * wy[a] ** 2 * wx[0] * wx[1])
    for b in (0, 1):  # delta = (1, 0)
        rho = rho.at[2, Y, X + b].add(w * wx[b] ** 2 * wy[0] * wy[1])
    wq = w * wy[0] * wy[1] * wx[0] * wx[1]
    rho = rho.at[3, Y, X].add(wq)  # delta = (1, 1)
    rho = rho.at[4, Y, X + 1].add(wq)  # delta = (1, -1)

    def shifted(dy, dx):
        pad = jnp.pad(psi0, ((0, max(dy, 0)), (max(-dx, 0), max(dx, 0))))
        return pad[dy : dy + h, max(-dx, 0) + dx : max(-dx, 0) + dx + wd]

    # Only the REAL part of each correlation is consumed below, and rho is
    # real, so Re(rho corr Z) == rho corr Re(Z): take the real part FIRST
    # and run the whole thing through half-spectrum real FFTs — exactly
    # the same output (pinned by tests/ptycho/test_precond_fft.py) at half
    # the FFT work.
    Z = jnp.stack(
        [
            (psi0 * jnp.conj(psi0)).real,
            (psi0 * jnp.conj(shifted(0, 1))).real,
            (psi0 * jnp.conj(shifted(1, 0))).real,
            (psi0 * jnp.conj(shifted(1, 1))).real,
            (psi0 * jnp.conj(shifted(1, -1))).real,
        ]
    ).astype(jnp.float32)
    s1, s2 = _fft_len(h + p + 2), _fft_len(wd + p + 2)
    corr = jnp.fft.irfft2(
        jnp.conj(jnp.fft.rfft2(rho, s=(s1, s2)))
        * jnp.fft.rfft2(Z, s=(s1, s2)),
        s=(s1, s2),
    )[:, :p, :p]
    out = corr[0] + 2 * jnp.sum(corr[1:], axis=0)
    return out[None].astype(jnp.float32)


@jax.jit(static_argnames=("cfg",))
def psi_preconditioner(cfg, psi, scan, probe, mask=None):
    """Jitted wrapper around :func:`_psi_precond_math`."""
    return _psi_precond_math(cfg, psi, scan, probe, mask)


@jax.jit(static_argnames=("cfg",))
def probe_preconditioner(cfg, psi, scan, mask=None):
    """Jitted wrapper around :func:`_probe_precond_math`."""
    return _probe_precond_math(cfg, psi, scan, mask)


def update_preconditioners(
    cfg: PtychoConfig,
    parameters: PtychoParameters,
    batches=None,
) -> PtychoParameters:
    """Refresh probe and object preconditioners (`_preconditioner.py:170-209`).

    When `batches` (padded index matrix + mask) is given, the scan is
    processed one batch slice at a time so every call reuses a single
    compiled program of fixed shape (the reference streams 64-pattern
    chunks for the same reason).
    """
    if batches is None:
        if parameters.object_options:
            parameters.object_options.preconditioner = psi_preconditioner(
                cfg, parameters.psi, parameters.scan, parameters.probe
            )
        if parameters.probe_options:
            parameters.probe_options.preconditioner = probe_preconditioner(
                cfg, parameters.psi, parameters.scan
            )
        return parameters

    batch_idx, batch_mask = batches
    want_psi = parameters.object_options is not None
    want_probe = parameters.probe_options is not None
    psi_pre, probe_pre = _preconditioner_epoch_program(
        cfg,
        parameters.psi,
        parameters.scan,
        parameters.probe,
        jnp.asarray(batch_idx),
        jnp.asarray(batch_mask),
        want_psi=want_psi,
        want_probe=want_probe,
        use_fft=USE_FFT_PRECOND,
    )
    if want_psi:
        parameters.object_options.preconditioner = psi_pre
    if want_probe:
        parameters.probe_options.preconditioner = probe_pre
    return parameters


@jax.jit(static_argnames=("cfg", "want_psi", "want_probe", "use_fft"))
def _preconditioner_epoch_program(
    cfg: PtychoConfig,
    psi,
    scan,
    probe,
    batch_idx,
    batch_mask,
    *,
    want_psi: bool,
    want_probe: bool,
    use_fft: bool = False,
):
    """Both preconditioners for the whole scan as one XLA program.

    lax.scan over the padded batch slices; one dispatch instead of
    2 * num_batch.
    """
    from tike_tpu.ops.patch import patch_adj, patch_fwd

    nb = batch_idx.shape[0]

    if use_fft and cfg.nslices == 1:
        w_all = (
            jnp.zeros(scan.shape[0], jnp.float32)
            .at[batch_idx.reshape(-1)]
            .add(batch_mask.reshape(-1))
        )
        psi_pre = (
            _psi_precond_fft_math(cfg, scan, probe, w_all).astype(
                jnp.complex64
            )
            if want_psi
            else jnp.zeros((cfg.nslices, cfg.nz, cfg.n), jnp.complex64)
        )
        probe_pre = (
            _probe_precond_fft_math(cfg, psi, scan, w_all).astype(
                jnp.complex64
            )
            if want_probe
            else jnp.zeros(
                (cfg.nslices, cfg.probe_shape, cfg.probe_shape),
                jnp.complex64,
            )
        )
        return psi_pre, probe_pre

    def body(carry, inp):
        psi_pre, probe_pre = carry
        idx, bmask = inp
        scan_b = jnp.take(scan, idx, axis=0)
        if want_psi:
            psi_pre = psi_pre + _psi_precond_math(
                cfg, psi, scan_b, probe, bmask
            )
        if want_probe:
            probe_pre = probe_pre + _probe_precond_math(
                cfg, psi, scan_b, bmask
            )
        return (psi_pre, probe_pre), None

    psi_pre0 = jnp.zeros((cfg.nslices, cfg.nz, cfg.n), jnp.complex64)
    probe_pre0 = jnp.zeros(
        (cfg.nslices, cfg.probe_shape, cfg.probe_shape), jnp.complex64
    )
    (psi_pre, probe_pre), _ = jax.lax.scan(
        body, (psi_pre0, probe_pre0), (batch_idx, batch_mask)
    )
    return psi_pre, probe_pre

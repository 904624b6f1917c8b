"""Laminography operator: 3D USFFT onto tilted projection planes.

JAX equivalent of `upstream/src/tike/operators/cupy/lamino.py`
and the `make_grids` CUDA kernel (`grid.cu:13-47`). The forward transform maps
a cubic volume u (n,n,n) to complex projections (ntheta, n, n) by evaluating
the volume's 3D Fourier transform on planes tilted by `tilt` and rotated by
each theta (Fourier slice theorem), then inverse 2D FFTing each plane.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from .usfft import eq2us, us2eq


@jax.tree_util.register_static
@dataclasses.dataclass(frozen=True)
class LaminoConfig:
    """Static configuration of the laminography operator."""

    n: int
    tilt: float
    eps: float = 1e-3
    upsample: float = 1.0
    # Spreading window: "kb" (Kaiser-Bessel, ~8x fewer taps at equal eps)
    # or "gaussian" (the reference's window, kept as a cross-check oracle).
    kernel: str = "kb"


def make_grids(theta, n: int, tilt: float):
    """Return (ntheta * n * n, 3) tilted-plane frequencies for the USFFT.

    Pure-jnp equivalent of `grid.cu:13-47`: for each rotation theta, an
    (n, n) grid of planar frequencies (ku, kv) in [-0.5, 0.5) maps to 3D as
    f = (kv sin(tilt), -ku sin(th) + kv cos(th) cos(tilt),
         ku cos(th) + kv sin(th) cos(tilt)).
    """
    k = (jnp.arange(n) - n // 2).astype(jnp.float32) / n
    ku = k[None, :]  # x varies along the last axis
    kv = k[:, None]
    ctilt, stilt = jnp.cos(tilt), jnp.sin(tilt)
    ctheta = jnp.cos(theta)[:, None, None]
    stheta = jnp.sin(theta)[:, None, None]
    f0 = jnp.broadcast_to(kv * stilt, (theta.shape[0], n, n))
    f1 = -ku * stheta + kv * ctheta * ctilt
    f2 = ku * ctheta + kv * stheta * ctilt
    return jnp.stack([f0, f1, f2], axis=-1).reshape(-1, 3)


def _centered_ifft2(F):
    """Zero-centered inverse 2D FFT (the reference's checkerboard pair)."""
    return jnp.fft.fftshift(
        jnp.fft.ifft2(jnp.fft.ifftshift(F, axes=(-2, -1)), axes=(-2, -1)),
        axes=(-2, -1),
    )


def _centered_fft2(d):
    return jnp.fft.fftshift(
        jnp.fft.fft2(jnp.fft.ifftshift(d, axes=(-2, -1)), axes=(-2, -1)),
        axes=(-2, -1),
    )


@functools.partial(jax.jit, static_argnames=("cfg",))
def lamino_fwd(cfg: LaminoConfig, u, theta):
    """Forward laminography: volume (n,n,n) -> projections (ntheta, n, n).

    Mirrors `lamino.py:73-107`: eq2us onto the tilted planes, then inverse
    2D FFT of each plane. The grids are passed row-structured — each
    (theta, detector-row) line shares its axis-0 frequency (f0 = kv sin
    tilt) — which routes the USFFT onto the scatter-free einsum path
    instead of one scatter-add per kernel tap.
    """
    n = cfg.n
    xi = make_grids(theta, n, cfg.tilt).reshape(theta.shape[0] * n, n, 3)
    F = eq2us(u, xi, n, cfg.eps, cfg.upsample, cfg.kernel).reshape(
        theta.shape[0], n, n
    )
    return _centered_ifft2(F)


@functools.partial(jax.jit, static_argnames=("cfg",))
def lamino_adj(cfg: LaminoConfig, data, theta):
    """Adjoint laminography: projections -> volume (`lamino.py:109-144`)."""
    n = cfg.n
    xi = make_grids(theta, n, cfg.tilt).reshape(theta.shape[0] * n, n, 3)
    F = _centered_fft2(data).reshape(theta.shape[0] * n, n)
    u = us2eq(F, -xi, n, cfg.eps, cfg.upsample, cfg.kernel)
    return u / cfg.n**2


@functools.partial(jax.jit, static_argnames=("cfg",))
def lamino_adj_exact(cfg: LaminoConfig, data, theta):
    """The EXACT adjoint of :func:`lamino_fwd` (any eps/upsample).

    The reference's adjoint (and :func:`lamino_adj`) evaluates us2eq at
    the NEGATED frequencies with a forward 3D FFT — an identity that is
    exact only when no energy sits on the even grid's Nyquist row (where
    k and -k alias to the same index). At upsample=1 the wrapped
    plane-corner frequencies put real energy there and the pair drifts
    ~20% from adjointness (measured <Au,d>/<u,A*d> = 0.81 - 0.22j at
    eps=1e-3, upsample=1). This version transposes the forward chain
    directly — scatter at +xi, true inverse 3D FFT, crop, deapodize —
    so <fwd(u), d> == <u, adj_exact(d)> to float precision always.
    CGLS (`lamino/solvers/cgls.py`) requires this; the backtracking-CG
    solver keeps :func:`lamino_adj` for reference parity.
    """
    from .usfft import kb_parameters, usfft_parameters, _kb_get_kernel, \
        _get_kernel, scatter_kb_rows, scatter_kb, scatter, \
        gather_kb_rows  # noqa: F401

    n = cfg.n
    xi = make_grids(theta, n, cfg.tilt).reshape(theta.shape[0] * n, n, 3)
    end_dtype = data.real.dtype
    # Adjoint of the trailing centered ifft2 (normalized 1/n^2): fft2 / n^2.
    F = _centered_fft2(data).reshape(theta.shape[0] * n, n) / (n * n)
    if cfg.kernel == "kb":
        upsampled, pad, m, beta = kb_parameters(n, cfg.eps, cfg.upsample)
        deapod = _kb_get_kernel(n, upsampled, m, beta, end_dtype)
        G = scatter_kb_rows(F, xi, upsampled, m, beta)
    else:
        upsampled, pad, mu, m = usfft_parameters(n, cfg.eps, cfg.upsample)
        deapod = _get_kernel(n, mu, dtype=end_dtype) * upsampled**3
        G = scatter(F.reshape(-1), xi.reshape(-1, 3), upsampled, m, mu)
    # Adjoint of the centered unnormalized fftn: upsampled^3 * ifftn.
    fe = jnp.fft.fftshift(
        jnp.fft.ifftn(jnp.fft.ifftshift(G))
    ) * (upsampled**3)
    end = pad + n
    return fe[pad:end, pad:end, pad:end] / deapod


@functools.partial(jax.jit, static_argnames=("cfg",))
def lamino_cost(cfg: LaminoConfig, data, theta, obj):
    """Least-squares cost (`lamino.py:146-152`)."""
    diff = lamino_fwd(cfg, obj, theta) - data
    return jnp.sum((diff * jnp.conj(diff)).real)


@functools.partial(jax.jit, static_argnames=("cfg",))
def lamino_grad(cfg: LaminoConfig, data, theta, obj):
    """Least-squares gradient (`lamino.py:154-164`)."""
    out = lamino_adj(cfg, lamino_fwd(cfg, obj, theta) - data, theta)
    return out / (data.shape[-3] * cfg.n**3)


# Jitted driver-facing programs.
lamino_fwd_p = jax.jit(lamino_fwd, static_argnames=("cfg",))
lamino_adj_p = jax.jit(lamino_adj, static_argnames=("cfg",))
lamino_cost_p = jax.jit(lamino_cost, static_argnames=("cfg",))
lamino_grad_p = jax.jit(lamino_grad, static_argnames=("cfg",))


@jax.jit(static_argnames=("cfg",))
def lamino_step_scale(cfg: LaminoConfig, obj, theta):
    """CG step-length scale 2|A*A u| / |u| (`cgrad.py:9-24`) as one program."""
    import tike_tpu.linalg as _la

    outnback = lamino_adj(cfg, lamino_fwd(cfg, obj, theta), theta)
    return 2 * _la.norm(outnback) / (_la.norm(obj) + 1e-32)

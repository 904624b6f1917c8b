"""Compare image-gradient implementations (dev harness).

JAX analog of `upstream/tests/compare_gradients.py`: the
reference compares its FFT phase-ramp image gradient against CuPy's sobel /
gradient / gaussian-derivative filters and saves side-by-side plots. Here the
same four formulations are expressed in jnp (separable convs instead of
cupyx.scipy.ndimage) so the gradient used by object regularization can be
sanity-checked against standard stencils.

Run as a script to save one PNG per implementation:

    JAX_PLATFORMS=cpu python tests/compare_gradients.py [width]

The pytest entry (`test_image_grads_agree`) checks the implementations agree
in the smooth interior of a synthetic image — a numeric pin instead of the
reference's eyeball-the-plots workflow.
"""

import sys

import numpy as np

import jax.numpy as jnp


def _image_grad_fft(x):
    """FFT phase-ramp derivative (the reference's `_image_grad`)."""
    ramp = 2j * jnp.pi * jnp.linspace(
        -0.5, 0.5, x.shape[-1], dtype="float32", endpoint=False
    )
    ramp = jnp.fft.ifftshift(ramp)
    fx = jnp.fft.ifftn(
        ramp[:, None] * jnp.fft.fftn(x, axes=(-2,)), axes=(-2,)
    )
    fy = jnp.fft.ifftn(ramp * jnp.fft.fftn(x, axes=(-1,)), axes=(-1,))
    return fx, fy


def _sep_filter(x, taps, axis):
    """Apply a short 1D stencil along one of the last two axes
    (edge-replicated, matching ndimage mode='nearest')."""
    half = len(taps) // 2
    pad = [(0, 0)] * x.ndim
    pad[axis] = (half, half)
    xp = jnp.pad(x, pad, mode="edge")
    out = jnp.zeros_like(x)
    for i, t in enumerate(taps):
        sl = [slice(None)] * x.ndim
        sl[axis] = slice(i, i + x.shape[axis])
        out = out + t * xp[tuple(sl)]
    return out


def _image_grad_gradient(x):
    """Central differences (np.gradient analog; the reference negates)."""
    return (
        _sep_filter(-x, [-0.5, 0.0, 0.5], -2),
        _sep_filter(-x, [-0.5, 0.0, 0.5], -1),
    )


def _image_grad_sobel(x):
    """Sobel: derivative [-1,0,1] along the axis, smoothing [1,2,1] across."""
    dx = _sep_filter(_sep_filter(-x, [-1.0, 0.0, 1.0], -2), [1.0, 2.0, 1.0], -1)
    dy = _sep_filter(_sep_filter(-x, [-1.0, 0.0, 1.0], -1), [1.0, 2.0, 1.0], -2)
    return dx, dy


def _gaussian_deriv_taps(s=1.0, order=1):
    """First-derivative-of-Gaussian stencil (gaussian_filter1d order=1)."""
    radius = int(4 * s + 0.5)
    t = np.arange(-radius, radius + 1, dtype=np.float64)
    g = np.exp(-0.5 * (t / s) ** 2)
    g /= g.sum()
    d = -t / s**2 * g  # d/dt of the gaussian
    return d.astype(np.float32)


def _image_grad_gaussian(x, s=1.0):
    taps = list(_gaussian_deriv_taps(s))
    return (_sep_filter(-x, taps, -2), _sep_filter(-x, taps, -1))


GRADS = {
    "fft": _image_grad_fft,
    "gradient": _image_grad_gradient,
    "sobel": _image_grad_sobel,
    "gaussian": _image_grad_gaussian,
}


def _test_image(w):
    yy, xx = np.mgrid[0:w, 0:w] / w
    # Exactly periodic over the grid so the FFT derivative is Gibbs-free
    # and all stencils can be compared in the interior.
    return (
        np.sin(2 * np.pi * 3 * yy) * np.cos(2 * np.pi * 2 * xx)
        + 1j * np.cos(2 * np.pi * (2 * xx + 3 * yy))
    ).astype(np.complex64)


def test_image_grads_agree(w=64):
    """All stencils approximate the same derivative up to their scale:
    after normalizing by a smooth-region scale factor, interiors agree."""
    x = jnp.asarray(_test_image(w))
    ref_dx, ref_dy = (np.asarray(g) for g in _image_grad_gradient(x))
    interior = (slice(8, -8), slice(8, -8))
    for name, grad in GRADS.items():
        dx, dy = (np.asarray(g) for g in grad(x))
        if name == "fft":  # FFT derivative has opposite sign convention
            dx, dy = -dx, -dy
        for got, want in ((dx, ref_dx), (dy, ref_dy)):
            got_i = got[interior]
            want_i = want[interior]
            scale = np.vdot(got_i, want_i) / (np.vdot(got_i, got_i) + 1e-12)
            err = np.abs(scale * got_i - want_i).max() / (
                np.abs(want_i).max() + 1e-12
            )
            assert err < 0.12, (name, err)


def main():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    w = int(sys.argv[1]) if len(sys.argv) > 1 else 512
    rng = np.random.default_rng(0)
    x = jnp.asarray(
        _test_image(w)
        + rng.normal(size=(w, w))
        + 1j * rng.normal(size=(w, w))
    )
    for name, grad in GRADS.items():
        dx, dy = (np.asarray(g) for g in grad(x))
        plt.figure(figsize=(8, 8))
        for i, (img, title) in enumerate(
            [
                (dx.imag, "dx.imag"),
                (dy.imag, "dy.imag"),
                (dx.real, "dx.real"),
                (dy.real, "dy.real"),
            ]
        ):
            plt.subplot(2, 2, i + 1)
            plt.imshow(img)
            plt.title(title)
            plt.colorbar()
        out = f"image_grad_{name}.png"
        plt.savefig(out)
        plt.close()
        print("wrote", out)


if __name__ == "__main__":
    main()

"""Hand-written numpy oracles for one rpie and one lstsq mini-batch step.

The golden-data parity tests (tests/test_parity_golden.py) pin the *forward*
model to the reference; these tests pin the *solver math* — every FFT norm,
padding convention, gradient sign, preconditioner formula, and the LSQML 2x2
joint step-size solve — to an independent straight-line numpy transcription
of the equations (Maiden 2017 rPIE eq. 6; Odstrcil 2018 eqs. 24-25 as
implemented by the reference at
`upstream/src/tike/ptycho/solvers/rpie.py:315-567` and
`lstsq.py:367-718`). If any piece of the jitted batch programs diverges,
these fail with a localized array mismatch rather than a slow drift in an
integration test.
"""

import jax.numpy as jnp
import numpy as np

from tike_tpu.ops.ptycho import PtychoConfig


# --- numpy reference implementations -------------------------------------


def np_patch_fwd(image, positions, p):
    """Bilinear min-corner patch gather (convolution.cu:146-155 semantics)."""
    out = np.zeros((len(positions), p, p), dtype=image.dtype)
    for b, (y, x) in enumerate(positions):
        cy, cx = int(np.floor(y)), int(np.floor(x))
        fy, fx = y - cy, x - cx
        w = image
        out[b] = (
            (1 - fy) * (1 - fx) * w[cy : cy + p, cx : cx + p]
            + (1 - fy) * fx * w[cy : cy + p, cx + 1 : cx + p + 1]
            + fy * (1 - fx) * w[cy + 1 : cy + p + 1, cx : cx + p]
            + fy * fx * w[cy + 1 : cy + p + 1, cx + 1 : cx + p + 1]
        )
    return out


def np_patch_adj(patches, positions, shape):
    """Exact transpose of np_patch_fwd (scatter-add with corner weights)."""
    p = patches.shape[-1]
    img = np.zeros(shape, dtype=patches.dtype)
    for b, (y, x) in enumerate(positions):
        cy, cx = int(np.floor(y)), int(np.floor(x))
        fy, fx = y - cy, x - cx
        img[cy : cy + p, cx : cx + p] += (1 - fy) * (1 - fx) * patches[b]
        img[cy : cy + p, cx + 1 : cx + p + 1] += (1 - fy) * fx * patches[b]
        img[cy + 1 : cy + p + 1, cx : cx + p] += fy * (1 - fx) * patches[b]
        img[cy + 1 : cy + p + 1, cx + 1 : cx + p + 1] += fy * fx * patches[b]
    return img


def np_fft2o(x):
    return np.fft.fft2(x, norm="ortho").astype(np.complex64)


def np_ifft2o(x):
    return np.fft.ifft2(x, norm="ortho").astype(np.complex64)


def np_pad_det(near, p, det):
    lo = (det - p) // 2
    hi = det - p - lo
    pads = [(0, 0)] * (near.ndim - 2) + [(lo, hi), (lo, hi)]
    return np.pad(near, pads)


def np_crop_det(far, p, det):
    lo = (det - p) // 2
    return far[..., lo : lo + p, lo : lo + p]


def np_gaussian_grad(data, farplane, intensity):
    scale = 1 - np.sqrt(data) / (np.sqrt(intensity) + 1e-9)
    return farplane * scale[:, None]


def make_inputs(seed=42, B=5, P=16, DET=32, M=2, H=64):
    """Random (psi, probe, scan, data, precond) for one mini-batch step."""
    rng = np.random.default_rng(seed)
    psi = (
        rng.standard_normal((H, H)) + 1j * rng.standard_normal((H, H))
    ).astype(np.complex64) * 0.5 + 1.0
    probe = (
        rng.standard_normal((M, P, P)) + 1j * rng.standard_normal((M, P, P))
    ).astype(np.complex64)
    scan = rng.uniform(2.0, H - P - 3.0, size=(B, 2)).astype(np.float32)
    data = rng.random((B, DET, DET)).astype(np.float32) * 10
    precond = (
        rng.random((H, H)).astype(np.float32) + 0.5
    ).astype(np.complex64)
    return psi, probe, scan, data, precond


def np_rpie_gradients(psi, probe, scan, data):
    """numpy oracle of one rPIE mini-batch: (costs, psi_num, probe_num)."""
    P, DET, M = probe.shape[-1], data.shape[-1], probe.shape[0]
    patches = np_patch_fwd(psi, scan, P)  # (B, P, P)
    nearplane = patches[:, None] * probe[None]  # (B, M, P, P)
    farplane = np_fft2o(np_pad_det(nearplane, P, DET))
    intensity = np.sum(np.abs(farplane) ** 2, axis=1)  # (B, DET, DET)
    costs = np.mean(
        (np.sqrt(intensity) - np.sqrt(data)) ** 2, axis=(-2, -1)
    )
    update = -np_gaussian_grad(data, farplane, intensity)
    diff = np_crop_det(np_ifft2o(update), P, DET)  # (B, M, P, P)
    grad_psi = np.sum(np.conj(probe)[None] * diff, axis=1) / M
    psi_num = np_patch_adj(grad_psi, scan, psi.shape)
    probe_num = np.sum(np.conj(patches)[:, None] * diff, axis=0)
    return costs, psi_num, probe_num


def run_rpie_gradients(psi, probe, scan, data):
    """tike_tpu's jitted rPIE mini-batch, same outputs as the oracle."""
    from tike_tpu.ptycho.solvers.rpie import _batch_gradients

    B, DET, P, H = len(scan), data.shape[-1], probe.shape[-1], psi.shape[-1]
    cfg = PtychoConfig(probe_shape=P, detector_shape=DET, nz=H, n=H)
    costs, psi_num, probe_num, eigen_delta = _batch_gradients(
        cfg,
        jnp.asarray(data),
        jnp.asarray(scan),
        jnp.arange(B, dtype=jnp.int32),
        jnp.ones(B, jnp.float32),
        jnp.asarray(psi[None]),  # (D=1, H, W)
        jnp.asarray(probe[None, None]),  # (1, 1, M, P, P)
        None,
        None,
        jnp.ones((DET, DET), bool),
        0.5,
        0.5,
        1.0,
        noise_model="gaussian",
        steplength_usemodes="all_modes",
        recover_probe=True,
    )
    assert eigen_delta is None
    return (
        np.asarray(costs),
        np.asarray(psi_num)[0],
        np.asarray(probe_num)[0, 0, 0],
    )


def test_rpie_batch_gradients_match_numpy_oracle():
    """One rpie mini-batch (single-slice, gaussian, no eigen) vs numpy."""
    psi, probe, scan, data, _ = make_inputs(B=5, P=16, DET=32, M=2, H=64)
    costs_np, psi_num_np, probe_num_np = np_rpie_gradients(
        psi, probe, scan, data
    )
    costs, psi_num, probe_num = run_rpie_gradients(psi, probe, scan, data)
    np.testing.assert_allclose(costs, costs_np, rtol=2e-5)
    np.testing.assert_allclose(psi_num, psi_num_np, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        probe_num, probe_num_np, rtol=1e-4, atol=1e-4
    )


def test_rpie_update_matches_numpy_oracle():
    """The rPIE preconditioned update formula vs numpy (Maiden 2017 eq. 6)."""
    from tike_tpu.ptycho.solvers.rpie import _plain_update_program

    rng = np.random.default_rng(3)
    H, M, P = 32, 2, 8
    psi = (rng.standard_normal((1, H, H)) * 1j + 1).astype(np.complex64)
    probe = rng.standard_normal((1, 1, M, P, P)).astype(np.complex64)
    psi_num = (
        rng.standard_normal((1, H, H)) + 1j * rng.standard_normal((1, H, H))
    ).astype(np.complex64)
    probe_num = (
        rng.standard_normal((1, 1, 1, M, P, P))
        + 1j * rng.standard_normal((1, 1, 1, M, P, P))
    ).astype(np.complex64)
    psi_pre = (rng.random((1, H, H)) + 0.1).astype(np.complex64)
    probe_pre = (rng.random((1, P, P)) + 0.1).astype(np.complex64)
    alpha = 0.05

    d = np.abs(psi_pre)
    psi_exp = psi + psi_num / (
        (1 - alpha) * psi_pre + alpha * d.max(axis=(-2, -1), keepdims=True)
    )
    pp = np.abs(probe_pre[0])
    probe_exp = probe + probe_num[0] / ((1 - alpha) * pp + alpha * pp.max())

    psi2, probe2 = _plain_update_program(
        jnp.asarray(psi),
        jnp.asarray(probe),
        jnp.asarray(psi_num),
        jnp.asarray(probe_num),
        jnp.asarray(psi_pre),
        jnp.asarray(probe_pre),
        jnp.float32(alpha),
        recover_psi=True,
        recover_probe=True,
    )
    np.testing.assert_allclose(np.asarray(psi2), psi_exp, rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(probe2), probe_exp, rtol=2e-5, atol=1e-5
    )


def np_lstsq_batch(psi, probe, scan, data, precond, num_batch):
    """numpy oracle of one LSQML mini-batch (gaussian, psi+probe, no eigen).

    Covers the object/probe gradients, illumination preconditioning, and the
    joint 2x2 optimal-step solve (`lstsq.py:619-718`).
    """
    P, DET = probe.shape[-1], data.shape[-1]
    eps = 1e-9 / (P * P)
    patches = np_patch_fwd(psi, scan, P)
    nearplane = patches[:, None, None] * probe[None, None]  # (B,1,M,P,P)
    farplane = np_fft2o(np_pad_det(nearplane, P, DET))
    intensity = np.sum(np.abs(farplane) ** 2, axis=(1, 2))
    costs = np.mean(
        (np.sqrt(intensity) - np.sqrt(data)) ** 2, axis=(-2, -1)
    )
    scale = 1 - np.sqrt(data) / (np.sqrt(intensity) + 1e-9)
    chi = np_crop_det(
        np_ifft2o(-farplane * scale[:, None, None]), P, DET
    )  # (B,1,M,P,P)

    obj_upd = np_patch_adj(
        np.sum(np.conj(probe)[None] * chi[:, 0], axis=1), scan, psi.shape
    )[None]
    m_probe_update = (
        np.sum(np.conj(patches)[:, None, None] * chi, axis=0, keepdims=True)
        / num_batch
    )  # (1,1,M,P,P)

    d = np.abs(precond)
    obj_upd_precond = obj_upd / np.sqrt(
        ((1 - 0.05) * d) ** 2 + (0.05 * d.max()) ** 2
    )
    proj = np_patch_fwd(obj_upd_precond[0], scan, P)
    dOP = proj[:, None, None] * probe[None, None][..., 0:1, :, :]
    A1 = np.sum(np.abs(dOP) ** 2 + eps, axis=(-2, -1))
    A1 = A1 + 0.5 * np.mean(A1, axis=-3)
    dPO = m_probe_update[..., 0:1, :, :] * patches[:, None, None]
    A4 = np.sum(np.abs(dPO) ** 2 + eps, axis=(-2, -1))
    A4 = A4 + 0.5 * np.mean(A4, axis=-3)
    chi_m = chi[..., 0:1, :, :]
    b1 = np.sum((np.conj(dOP) * chi_m).real, axis=(-2, -1))
    b2 = np.sum((np.conj(dPO) * chi_m).real, axis=(-2, -1))
    A2 = np.sum(dOP * np.conj(dPO), axis=(-2, -1))
    A3 = np.conj(A2)
    det = A1 * A4 - A2 * A3
    det = np.where(np.abs(det) == 0, 1e-32, det)
    x1 = -np.conj(A2 * b2 - A4 * b1) / det
    x2 = np.conj(A1 * b2 - A3 * b1) / det
    return {
        "costs": costs,
        "object_upd_sum": obj_upd,
        "m_probe_update": m_probe_update,
        "object_update_precond": obj_upd_precond,
        "beta_object": np.mean(0.9 * np.maximum(0, x1.real)),
        "beta_probe": np.mean(
            0.9 * np.maximum(0, x2.real)[..., None, None], axis=0
        ),
    }


def run_lstsq_batch(psi, probe, scan, data, precond, num_batch):
    """tike_tpu's jitted LSQML mini-batch: the oracle's keys, as numpy."""
    from tike_tpu.ptycho.solvers.lstsq import _lstsq_batch

    B, DET, P, H = len(scan), data.shape[-1], probe.shape[-1], psi.shape[-1]
    cfg = PtychoConfig(probe_shape=P, detector_shape=DET, nz=H, n=H)
    out = _lstsq_batch(
        cfg,
        jnp.asarray(data),
        jnp.asarray(scan),
        jnp.arange(B, dtype=jnp.int32),
        jnp.ones(B, jnp.float32),
        jnp.asarray(psi[None]),
        jnp.asarray(probe[None, None]),
        None,
        None,
        jnp.ones((DET, DET), bool),
        jnp.asarray(precond[None]),
        0.5,
        0.5,
        1.0,
        num_batch=num_batch,
        noise_model="gaussian",
        steplength_usemodes="all_modes",
        recover_psi=True,
        recover_probe=True,
        recover_positions=False,
    )
    return {
        k: np.asarray(out[k])
        for k in (
            "costs",
            "object_upd_sum",
            "m_probe_update",
            "object_update_precond",
            "beta_object",
            "beta_probe",
        )
    }


def test_lstsq_batch_matches_numpy_oracle():
    """One LSQML mini-batch (gaussian, psi+probe, no eigen) vs numpy."""
    psi, probe, scan, data, precond = make_inputs(
        B=5, P=16, DET=32, M=2, H=64
    )
    want = np_lstsq_batch(psi, probe, scan, data, precond, num_batch=3.0)
    got = run_lstsq_batch(psi, probe, scan, data, precond, num_batch=3.0)
    np.testing.assert_allclose(got["costs"], want["costs"], rtol=2e-5)
    np.testing.assert_allclose(
        got["object_upd_sum"], want["object_upd_sum"], rtol=1e-4, atol=1e-4
    )
    np.testing.assert_allclose(
        got["m_probe_update"], want["m_probe_update"], rtol=1e-4, atol=1e-5
    )
    np.testing.assert_allclose(
        got["object_update_precond"],
        want["object_update_precond"],
        rtol=1e-4,
        atol=1e-4,
    )
    np.testing.assert_allclose(
        got["beta_object"].ravel(), [want["beta_object"]], rtol=1e-4
    )
    np.testing.assert_allclose(
        got["beta_probe"].ravel(), want["beta_probe"].ravel(), rtol=1e-4
    )

"""Laminography model parallelism on a multi-device mesh.

Covers the reference's two lamino parallel axes
(`upstream/src/tike/lamino/solvers/bucket.py:34-54,111-114`,
`lamino/lamino.py:130-137`): the Bucket volume split (obj_split — each
device owns an x-slab of voxels, projections psum-reduced) and the USFFT
path's theta-axis data parallelism. Both must reproduce the single-device
result.
"""

import numpy as np
import pytest

import jax


def _problem(n=16, ntheta=6, seed=5):
    rng = np.random.default_rng(seed)
    obj = (
        rng.standard_normal((n, n, n)) + 1j * rng.standard_normal((n, n, n))
    ).astype(np.complex64) * 0.1
    theta = np.linspace(0, 2 * np.pi, ntheta, endpoint=False).astype(
        np.float32
    )
    tilt = np.pi / 3
    return obj, theta, tilt


def test_bucket_volume_parallel_matches_single_device():
    """obj_split over a 4-device mesh == single device, same CG trajectory."""
    import tike_tpu.lamino.bucket as tlb

    obj, theta, tilt = _problem(n=16)
    data = tlb.simulate(obj, theta, tilt, eps=1.0)

    kwargs = dict(
        data=data, theta=theta, tilt=tilt, num_iter=2, cg_iter=3, eps=1.0
    )
    single = tlb.reconstruct(**kwargs)
    split = tlb.reconstruct(obj_split=4, **kwargs)

    # The sharded psum's reduction order differs from the serial sum by
    # ~1e-4 relative; the Dai-Yuan line search amplifies that (a
    # near-threshold accept/reject flips and the CG trajectories split),
    # so trajectories are compared on convergence quality, not bit-wise.
    # Exact cost/gradient agreement between the sharded and unsharded
    # operators is pinned separately by
    # test_bucket_sharded_ops_match_unsharded.
    for r in (single, split):
        assert np.all(np.isfinite(r["cost"]))
        assert r["cost"][-1] < r["cost"][0]
    start = max(single["cost"][0], split["cost"][0])
    assert split["cost"][-1] < 0.5 * start
    assert single["cost"][-1] < 0.5 * start or np.allclose(
        split["cost"], single["cost"], rtol=1e-3
    )
    # Both reconstruct the same object (up to the trajectory difference).
    a, b = split["obj"], single["obj"]
    corr = np.abs(np.vdot(a, b)) / (
        np.linalg.norm(a) * np.linalg.norm(b) + 1e-12
    )
    assert corr > 0.9, corr


def test_bucket_sharded_ops_match_unsharded():
    """The shard_map fwd/adj pair == the flat single-device operators."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from tike_tpu.ops.bucket import (
        BucketConfig,
        bucket_adj,
        bucket_fwd,
        make_grid,
        make_grid_full,
        sharded_bucket_ops,
    )
    from tike_tpu.parallel import make_mesh

    obj, theta, tilt = _problem(n=16)
    cfg = BucketConfig(n=16, tilt=float(tilt), precision=2)
    mesh = make_mesh(4)
    axis = mesh.axis_names[0]
    vol = NamedSharding(mesh, P(axis))
    rep = NamedSharding(mesh, P())

    grid4 = jax.device_put(np.asarray(make_grid_full(16)), vol)
    u = jax.device_put(obj, vol)
    th = jax.device_put(theta, rep)
    fwd, adj, _, _, _ = sharded_bucket_ops(cfg, mesh, axis)

    expected_fwd = bucket_fwd(cfg, obj.reshape(-1), theta, make_grid(16))
    got_fwd = fwd(u, th, grid4)
    np.testing.assert_allclose(
        np.asarray(got_fwd), np.asarray(expected_fwd), rtol=1e-5, atol=1e-6
    )

    data = np.asarray(expected_fwd)
    expected_adj = bucket_adj(cfg, data, theta, make_grid(16)).reshape(
        16, 16, 16
    )
    got_adj = adj(jax.device_put(data, rep), th, grid4)
    np.testing.assert_allclose(
        np.asarray(got_adj), np.asarray(expected_adj), rtol=1e-5, atol=1e-6
    )


def test_bucket_2d_mesh_ops_match_unsharded():
    """2x4 (data x volume) mesh ops == flat single-device programs.

    The reference's obj_split x data-group grid
    (`upstream/src/tike/lamino/solvers/bucket.py:34-54,111-114`):
    partial projections Allreduced within volume groups, gradients reduced
    across data groups.
    """
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from tike_tpu.ops.bucket import (
        BucketConfig,
        bucket_adj,
        bucket_fwd,
        bucket_grad,
        bucket_step_scale,
        make_grid,
        make_grid_full,
        sharded_bucket_ops_2d,
    )

    obj, theta, tilt = _problem(n=16, ntheta=6)
    cfg = BucketConfig(n=16, tilt=float(tilt), precision=2)
    mesh = Mesh(np.asarray(jax.devices()).reshape(2, 4), ("d", "v"))
    vol = NamedSharding(mesh, P("v"))
    dat = NamedSharding(mesh, P("d"))

    grid4 = jax.device_put(np.asarray(make_grid_full(16)), vol)
    u = jax.device_put(obj, vol)
    th = jax.device_put(theta, dat)
    fwd, adj, cost_op, grad_op, step_op = sharded_bucket_ops_2d(
        cfg, mesh, "d", "v"
    )

    grid = make_grid(16)
    expected_fwd = np.asarray(bucket_fwd(cfg, obj.reshape(-1), theta, grid))
    got_fwd = fwd(u, th, grid4)
    np.testing.assert_allclose(
        np.asarray(got_fwd), expected_fwd, rtol=1e-5, atol=1e-6
    )

    data = expected_fwd * 0.9  # nonzero residual
    expected_adj = np.asarray(
        bucket_adj(cfg, data, theta, grid)
    ).reshape(16, 16, 16)
    got_adj = adj(jax.device_put(data, dat), th, grid4)
    np.testing.assert_allclose(
        np.asarray(got_adj), expected_adj, rtol=1e-5, atol=1e-6
    )

    # cost / grad / step-scale: replicated scalars and sharded gradient.
    data_d = jax.device_put(data, dat)
    diff = expected_fwd - data
    expected_cost = np.sum((diff * np.conj(diff)).real)
    got_cost = np.asarray(cost_op(data_d, u, th, grid4))
    np.testing.assert_allclose(got_cost, expected_cost, rtol=1e-5)

    import jax.numpy as jnp

    expected_grad = np.asarray(
        bucket_grad(cfg, data, theta, jnp.asarray(expected_fwd), grid)
    ).reshape(16, 16, 16)
    got_grad = np.asarray(grad_op(data_d, u, th, grid4))
    np.testing.assert_allclose(
        got_grad, expected_grad, rtol=1e-5, atol=1e-6
    )

    expected_step = np.asarray(bucket_step_scale(cfg, obj, theta, grid))
    got_step = np.asarray(step_op(u, th, grid4))
    np.testing.assert_allclose(got_step, expected_step, rtol=1e-5)


def test_bucket_2d_mesh_reconstruct_matches_single_device():
    """End-to-end reconstruct on a 2x4 (data x volume) mesh converges to
    the single-device solution (VERDICT r4 item 5 acceptance)."""
    from jax.sharding import Mesh

    import tike_tpu.lamino.bucket as tlb

    obj, theta, tilt = _problem(n=16, ntheta=6)
    data = tlb.simulate(obj, theta, tilt, eps=1.0)

    kwargs = dict(
        data=data, theta=theta, tilt=tilt, num_iter=2, cg_iter=3, eps=1.0
    )
    single = tlb.reconstruct(**kwargs)
    mesh = Mesh(np.asarray(jax.devices()).reshape(2, 4), ("d", "v"))
    meshed = tlb.reconstruct(mesh=mesh, **kwargs)

    for r in (single, meshed):
        assert np.all(np.isfinite(r["cost"]))
        assert r["cost"][-1] < r["cost"][0]
    start = max(single["cost"][0], meshed["cost"][0])
    assert meshed["cost"][-1] < 0.5 * start
    a, b = meshed["obj"], single["obj"]
    corr = np.abs(np.vdot(a, b)) / (
        np.linalg.norm(a) * np.linalg.norm(b) + 1e-12
    )
    assert corr > 0.9, corr


def test_usfft_cgrad_theta_mesh_matches_single_device():
    """USFFT lamino CG with theta sharded over 4 devices == single device."""
    import tike_tpu.lamino as tl
    from tike_tpu.parallel import make_mesh

    obj, theta, tilt = _problem(n=16, ntheta=8)
    data = tl.simulate(obj, theta, tilt, upsample=2)

    kwargs = dict(
        data=data,
        theta=theta,
        tilt=tilt,
        algorithm="cgrad",
        num_iter=2,
        cg_iter=2,
        upsample=2,
    )
    single = tl.reconstruct(**kwargs)
    meshed = tl.reconstruct(mesh=make_mesh(4), **kwargs)

    np.testing.assert_allclose(meshed["cost"], single["cost"], rtol=1e-3)
    np.testing.assert_allclose(
        meshed["obj"], single["obj"], rtol=1e-3, atol=1e-5
    )

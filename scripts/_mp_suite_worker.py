"""One rank of the 2-process consistency suite (see run_mp_suite.py).

Runs a matrix of reconstruct-consistency scenarios through the PRODUCTION
multi-process branches — the DP layout (`_enter_multi_host` with
`make_global_batch_data`) and the striped object decomposition — under a
real 2-process `jax.distributed` runtime, mirroring the reference's
``mpiexec -n 2 python -m pytest`` CI job
(`upstream/.github/workflows/unit-tests.yml:143`).
"""

import os
import sys

import numpy as np


def scenarios():
    """The test matrix: name -> (sharding, algo, features)."""
    return [
        ("dp_rpie_compact", "replicated", "rpie", {}),
        ("dp_lstsq_wobbly", "replicated", "lstsq_grad", {"wobbly": True}),
        ("dp_rpie_eigen", "replicated", "rpie", {"eigen": True}),
        # Host-streaming composed with the multi-host DP layout: each
        # rank's stripe block stays in host RAM, batches upload one at a
        # time as globally-sharded arrays (HostStreamedBatches).
        ("dp_rpie_streamed", "replicated", "rpie", {"stream": True}),
        ("striped_rpie", "striped", "rpie", {"rescale": True}),
        ("striped_rpie_streamed", "striped", "rpie", {"stream": True}),
        # All positions cluster in rank 0's stripes: rank 1 holds an empty
        # data block while rank 0's block equals the full dataset — the
        # auto-rescale's collective-entry decision must still agree.
        ("striped_rpie_degenerate", "striped", "rpie",
         {"rescale": True, "clustered": True}),
        ("striped_lstsq_opr_pos", "striped", "lstsq_grad",
         {"eigen": True, "positions": True}),
        ("lamino_cgrad_theta", "lamino", "cgrad", {}),
        ("lamino_bucket_volsplit", "bucket", "bucket", {}),
    ]


def build_problem(seed=11, h=128, p=16, n=120, nmodes=2):
    import tike_tpu.ptycho as tp

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:h] / h
    psi = (
        np.exp(1j * 0.5 * np.sin(5 * yy) * np.cos(3 * xx))
        * (0.9 + 0.1 * np.cos(7 * xx))
    ).astype(np.complex64)[None]
    probe = (tp.gaussian(p) * np.exp(1j * 0.2 * tp.gaussian(p)))[
        None, None, None
    ].astype(np.complex64)
    if nmodes > 1:
        probe = np.asarray(
            tp.add_modes_cartesian_hermite(probe, nmodes)
        ).astype(np.complex64)
    scan = np.stack(
        [rng.uniform(2, h - p - 3, n), rng.uniform(2, h - p - 3, n)], -1
    ).astype(np.float32)
    data = tp.simulate(detector_shape=p, probe=probe, scan=scan, psi=psi)
    return data.astype(np.float32), scan, probe, psi.shape


def run_scenario(name, sharding, algo, feat, mesh, dist):
    import tike_tpu.ptycho as tp
    from tike_tpu.parallel.striped import striped_local_indices

    if sharding == "lamino":
        return run_lamino(name, mesh)
    if sharding == "bucket":
        return run_bucket(name, mesh)

    data, scan, probe, psi_shape = build_problem()
    if feat.get("clustered"):
        # Confine every position to the top quarter of the field so one
        # rank's stripes cover all of them.
        rng = np.random.default_rng(5)
        h, p_w = psi_shape[-2], probe.shape[-1]
        scan = np.stack(
            [
                rng.uniform(2, h // 4, scan.shape[0]),
                rng.uniform(2, h - p_w - 3, scan.shape[0]),
            ],
            -1,
        ).astype(np.float32)
        import tike_tpu.ptycho as _tp

        data = _tp.simulate(
            detector_shape=p_w,
            probe=probe,
            scan=scan,
            psi=np.exp(
                1j
                * 0.5
                * np.sin(5 * np.mgrid[0:h, 0:h][0] / h)
            ).astype(np.complex64)[None],
        ).astype(np.float32)
    n = scan.shape[0]
    m = probe.shape[-3]
    kwargs = {}
    if feat.get("eigen"):
        weights = np.zeros((n, 2, m), np.float32)
        weights[:, 0, :] = 1.0
        kwargs["eigen_probe"] = 0.01 * probe[:, :1, :1]
        kwargs["eigen_weights"] = weights
    if feat.get("positions"):
        kwargs["position_options"] = tp.PositionOptions(
            initial_scan=scan, update_magnitude_limit=0.2
        )
    algo_cls = tp.RpieOptions if algo == "rpie" else tp.LstsqOptions
    params = tp.PtychoParameters(
        psi=np.full(psi_shape, 0.5 + 0j, np.complex64),
        probe=probe.copy(),
        scan=scan.copy(),
        algorithm_options=algo_cls(
            num_iter=3,
            num_batch=2,
            batch_method=(
                "wobbly_center" if feat.get("wobbly") else "compact"
            ),
        ),
        object_options=tp.ObjectOptions(),
        # rescale=True exercises the multi-host probe auto-rescale: each
        # rank contributes its own data block's measured power and both
        # must fit the SAME scale (checked by the rank-consistency
        # assertion over the resulting probe).
        probe_options=tp.ProbeOptions(
            init_rescale_from_measurements=bool(feat.get("rescale"))
        ),
        **kwargs,
    )
    if sharding == "striped":
        local_idx = striped_local_indices(
            scan, psi_shape[-2:], probe.shape[-1], mesh
        )
        data_local = data[local_idx]
        # stream=True: the multi-host x host-streaming x striped-object
        # composition — per-process data blocks stay in host RAM and
        # batches are device_put one at a time.
        with tp.Reconstruction(
            data_local,
            params,
            mesh=mesh,
            object_sharding="striped",
            store_data_on_device=not feat.get("stream"),
        ) as context:
            context.iterate(params.algorithm_options.num_iter)
            result = context.get_result()
    else:
        # Production DP: per-process data stripe, global SPMD program.
        local_idx = dist.stripe_for_process(scan)
        data_local = data[local_idx]
        with tp.Reconstruction(
            data=data_local,
            parameters=params,
            mesh=mesh,
            random_seed=0,
            store_data_on_device=not feat.get("stream"),
        ) as context:
            context.iterate(params.algorithm_options.num_iter)
            result = context.get_result()
    costs = np.asarray(
        [float(np.mean(c)) for c in result.algorithm_options.costs]
    )
    assert np.all(np.isfinite(costs)), (name, costs)
    assert costs[-1] < costs[0], (name, costs)
    return {
        f"{name}_psi": np.asarray(result.psi),
        f"{name}_probe": np.asarray(result.probe),
        f"{name}_costs": costs,
    }


def run_lamino(name, mesh):
    """Theta-sharded USFFT CG across 2 processes (`MPIio_lamino` analog).

    Each process loads its own contiguous theta chunk of the projection
    data; the global theta axis is sharded over the 4-device mesh.
    """
    import jax
    import tike_tpu.lamino

    n, ntheta = 32, 16
    rng = np.random.default_rng(0)
    obj = (
        rng.standard_normal((n, n, n)) + 1j * rng.standard_normal((n, n, n))
    ).astype(np.complex64) * np.exp(
        -((np.mgrid[0:n, 0:n, 0:n] - n / 2) ** 2).sum(0) / (n / 3) ** 2
    )
    theta = np.linspace(0, np.pi, ntheta, endpoint=False).astype(np.float32)
    tilt = np.pi / 3
    data = tike_tpu.lamino.simulate(obj, theta, tilt, eps=1e-6, upsample=2)
    # This process's contiguous theta chunk.
    nproc = jax.process_count()
    chunk = ntheta // nproc
    pid = jax.process_index()
    sel = slice(pid * chunk, (pid + 1) * chunk)
    result = tike_tpu.lamino.reconstruct(
        data[sel],
        theta[sel],
        tilt,
        algorithm="cgrad",
        num_iter=4,
        eps=1e-6,
        upsample=2,
        mesh=mesh,
    )
    costs = np.asarray(result["cost"], np.float64)
    assert np.all(np.isfinite(costs)), (name, costs)
    assert costs[-1] < costs[0], (name, costs)
    return {
        f"{name}_psi": np.asarray(result["obj"]),
        f"{name}_probe": np.zeros(1, np.float32),  # n/a for lamino
        f"{name}_costs": costs,
    }


def run_bucket(name, mesh):
    """Voxel-grid split across 2 processes (the reference's MPI-rank
    `_make_grid` split, `operators/cupy/bucket.py:267-274`)."""
    import tike_tpu.lamino.bucket as bucket

    n, ntheta = 16, 8
    rng = np.random.default_rng(0)
    obj = (
        rng.standard_normal((n, n, n)) + 1j * rng.standard_normal((n, n, n))
    ).astype(np.complex64) * np.exp(
        -((np.mgrid[0:n, 0:n, 0:n] - n / 2) ** 2).sum(0) / (n / 3) ** 2
    )
    theta = np.linspace(0, np.pi, ntheta, endpoint=False).astype(np.float32)
    tilt = np.pi / 2
    data = bucket.simulate(obj, theta, tilt, eps=1.0)
    result = bucket.reconstruct(
        data,
        theta,
        tilt,
        algorithm="bucket",
        num_iter=4,
        eps=1.0,
        mesh=mesh,
    )
    costs = np.asarray(result["cost"], np.float64)
    assert np.all(np.isfinite(costs)), (name, costs)
    assert costs[-1] < costs[0], (name, costs)
    return {
        f"{name}_psi": np.asarray(result["obj"]),
        f"{name}_probe": np.zeros(1, np.float32),
        f"{name}_costs": costs,
    }


def main():
    rank = int(sys.argv[1])
    port = sys.argv[2]
    out = sys.argv[3]

    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 2)
    import tike_tpu.parallel.distributed as dist

    dist.initialize(
        coordinator_address=f"localhost:{port}",
        num_processes=2,
        process_id=rank,
    )
    assert jax.device_count() == 4

    mesh = dist.global_mesh()
    results = {}
    for name, sharding, algo, feat in scenarios():
        results.update(run_scenario(name, sharding, algo, feat, mesh, dist))
        print(f"rank {rank}: {name} OK", flush=True)
    np.savez(f"{out}.{rank}.npz", **results)
    print(f"rank {rank} done", flush=True)


if __name__ == "__main__":
    main()

"""Worker for the 2-process striped-object reconstruction test.

Run as: python _striped_dist_worker.py <rank> <port> <out_prefix>

The reference's object-domain model parallelism spans MPI ranks
(`upstream/src/tike/operators/cupy/bucket.py:267-274` splits the
voxel grid by rank; scan stripes span nodes via `mpi.py:61-85`). Here: two
jax.distributed CPU processes (2 virtual devices each) run the striped
object decomposition over a 4-device mesh — each process loads only its
stripes' diffraction patterns (`striped_local_indices`) — and both must
produce the same stitched result as a single-process 4-device run.
"""

import os
import sys

import numpy as np


def build_problem():
    """Deterministic synthetic problem (shared with the test)."""
    import tike_tpu.ptycho as tp

    rng = np.random.default_rng(11)
    h = 128
    p = 16
    n = 120
    yy, xx = np.mgrid[0:h, 0:h] / h
    psi = (
        np.exp(1j * 0.5 * np.sin(5 * yy) * np.cos(3 * xx))
        * (0.9 + 0.1 * np.cos(7 * xx))
    ).astype(np.complex64)[None]
    probe = (tp.gaussian(p) * np.exp(1j * 0.2 * tp.gaussian(p)))[
        None, None, None
    ].astype(np.complex64)
    scan = np.stack(
        [rng.uniform(2, h - p - 3, n), rng.uniform(2, h - p - 3, n)], -1
    ).astype(np.float32)
    data = tp.simulate(detector_shape=p, probe=probe, scan=scan, psi=psi)
    return data.astype(np.float32), scan, probe, psi.shape


def make_parameters(scan, probe, psi_shape):
    import tike_tpu.ptycho as tp

    return tp.PtychoParameters(
        psi=np.full(psi_shape, 0.5 + 0j, dtype=np.complex64),
        probe=probe.copy(),
        scan=scan.copy(),
        algorithm_options=tp.LstsqOptions(
            num_iter=3, num_batch=2, batch_method="compact"
        ),
        object_options=tp.ObjectOptions(),
        probe_options=tp.ProbeOptions(init_rescale_from_measurements=False),
    )


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
    assert jax.device_count() == 4, jax.device_count()

    import tike_tpu.ptycho as tp
    from tike_tpu.parallel.striped import striped_local_indices

    data, scan, probe, psi_shape = build_problem()
    mesh = dist.global_mesh()
    # Production flow: this process loads only its stripes' patterns.
    local_idx = striped_local_indices(
        scan, psi_shape[-2:], probe.shape[-1], mesh
    )
    data_local = data[local_idx]
    params = make_parameters(scan, probe, psi_shape)

    result = tp.reconstruct(
        data_local,
        params,
        mesh=mesh,
        object_sharding="striped",
    )
    np.savez(
        f"{out}.{rank}.npz",
        psi=np.asarray(result.psi),
        probe=np.asarray(result.probe),
        costs=np.asarray(
            [float(np.mean(c)) for c in result.algorithm_options.costs]
        ),
    )
    print(f"rank {rank} done", flush=True)


if __name__ == "__main__":
    main()

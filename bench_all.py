"""Benchmark the BASELINE.json configurations on one GPU.

Usage: python bench_all.py [config ...]
  configs: rpie_siemens lsqml_opr_pos lamino_cgrad lamino_cgls admm_joint
           stream_1m stream_compare
  (default: rpie_siemens lsqml_opr_pos lamino_cgrad admm_joint)

One process. It prints the card (name and power limit), then one JSON line
per config. Without a GPU it exits non-zero and prints no result.

1. rpie_siemens   - single-probe rPIE on the bundled siemens-star dataset
                    (516 positions, 128^2 measured patterns).
2. lsqml_opr_pos  - multi-mode (3 probes) + eigen-probe LSQML with probe
                    and position correction, 10k synthetic 128^2 patterns.
3. lamino_cgrad   - laminography USFFT conjugate-gradient, 128^3 volume,
                    64 angles.
4. admm_joint     - joint ptycho+lamino ADMM pipeline (legacy src/broken
                    workload re-derived in tike_tpu.admm).
5. stream_1m      - data-parallel long-axis config: 1M patterns in
                    host-streaming mode.
"""

import json
import os
import resource
import sys
import time

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SIEMENS_STAR = os.path.join(_HERE, "tests", "data", "siemens-star-small.npz.bz2")


def siemens_star():
    import bz2

    with bz2.open(SIEMENS_STAR, "rb") as f:
        a = np.load(f)
        scan = a["scan"][0].astype(np.float32)
        data = a["data"][0].astype(np.float32)
        probe = a["probe"][0].astype(np.complex64)
    scan = scan - np.amin(scan, axis=-2) + 20
    w = probe.shape[-1]
    h = int(np.ceil(scan[:, 0].max())) + w + 21
    ww = int(np.ceil(scan[:, 1].max())) + w + 21
    psi = np.full((1, h, ww), 0.5 + 0j, dtype=np.complex64)
    return data, scan, probe, psi


def _timed_epochs(context, n_timed: int):
    """Time n_timed epochs after an identically-shaped warmup call."""
    import jax

    context.iterate(n_timed)
    jax.block_until_ready(context.parameters.psi)
    start = time.perf_counter()
    context.iterate(n_timed)
    jax.block_until_ready(context.parameters.psi)
    return time.perf_counter() - start


def bench_rpie_siemens():
    import tike_tpu.ptycho as tp

    data, scan, probe, psi = siemens_star()
    params = tp.PtychoParameters(
        probe=probe,
        psi=psi,
        scan=scan,
        algorithm_options=tp.RpieOptions(
            num_batch=5, num_iter=1, batch_method="compact"
        ),
        object_options=tp.ObjectOptions(),
        probe_options=tp.ProbeOptions(),
    )
    n_timed = 10
    with tp.Reconstruction(data, params, random_seed=0) as context:
        elapsed = _timed_epochs(context, n_timed)
        costs = [float(np.mean(c)) for c in context.get_convergence()[0]]
    pps = len(scan) * n_timed / elapsed
    return {
        "config": "rpie_siemens",
        "metric": "rpie_siemens_patterns_per_sec",
        "value": round(pps, 1),
        "unit": "patterns/s",
        "epoch_s": round(elapsed / n_timed, 4),
        "final_cost": costs[-1],
    }


def opr_pos_problem(n_patterns=10_000, hw=1500, probe_shape=128):
    """Headline scan and object with a 3-mode probe: (scan, probe, psi)."""
    import tike_tpu.ptycho as tp
    from bench import _make_inputs

    scan, psi, _ = _make_inputs(
        n_patterns, det=probe_shape, probe_shape=probe_shape, hw=hw
    )
    base = (
        tp.gaussian(probe_shape)
        * np.exp(1j * 0.2 * tp.gaussian(probe_shape))
    )[None, None, None].astype(np.complex64)
    probe = np.asarray(tp.add_modes_cartesian_hermite(base, 3)).astype(
        np.complex64
    )
    return scan, probe, psi


def opr_pos_parameters(scan, probe, psi, num_batch=10):
    """LSQML with eigen probes and position correction (config 2)."""
    import tike_tpu.ptycho as tp

    m = probe.shape[-3]
    eigen_probe = 0.01 * probe[:, :1].repeat(1, axis=-4)
    weights = np.zeros((len(scan), 2, m), np.float32)
    weights[:, 0, :] = 1.0
    return tp.PtychoParameters(
        probe=probe,
        psi=np.full_like(psi, 0.5),
        scan=scan,
        eigen_probe=eigen_probe.astype(np.complex64),
        eigen_weights=weights,
        algorithm_options=tp.LstsqOptions(
            num_batch=num_batch, num_iter=1, batch_method="compact"
        ),
        object_options=tp.ObjectOptions(),
        probe_options=tp.ProbeOptions(),
        position_options=tp.PositionOptions(
            initial_scan=scan, update_magnitude_limit=2.0
        ),
    )


def bench_lsqml_opr_pos(n_patterns=10_000):
    import tike_tpu.ptycho as tp
    from bench import _simulate_numpy

    scan, probe, psi = opr_pos_problem(n_patterns)
    data = _simulate_numpy(probe.shape[-1], probe, scan, psi)
    params = opr_pos_parameters(scan, probe, psi)
    n_timed = 3
    with tp.Reconstruction(data, params, random_seed=0) as context:
        assert context._fused_eligible(), "config 2 must run fused"
        elapsed = _timed_epochs(context, n_timed)
    pps = n_patterns * n_timed / elapsed
    return {
        "config": "lsqml_opr_pos",
        "metric": "lsqml_3mode_eigen_pos_patterns_per_sec_128px",
        "value": round(pps, 1),
        "unit": "patterns/s",
        "epoch_s": round(elapsed / n_timed, 4),
        "vs_north_star_10k": round(pps / 10_000, 3),
    }


def lamino_problem(n=128, ntheta=64):
    """Config 3's data: (data, theta, tilt) from a seeded random volume."""
    import tike_tpu.lamino

    rng = np.random.default_rng(0)
    obj = (
        rng.standard_normal((n, n, n)) + 1j * rng.standard_normal((n, n, n))
    ).astype(np.complex64) * np.exp(
        -((np.mgrid[0:n, 0:n, 0:n] - n / 2) ** 2).sum(0) / (n / 3) ** 2
    )
    theta = np.linspace(0, np.pi, ntheta, endpoint=False).astype(np.float32)
    tilt = np.pi / 3
    data = tike_tpu.lamino.simulate(obj, theta, tilt, eps=1e-3, upsample=1)
    return data, theta, tilt


def _bench_lamino(algorithm, n, ntheta):
    import tike_tpu.lamino

    data, theta, tilt = lamino_problem(n, ntheta)
    # Warmup: 1 iteration compiles the outer-iteration program.
    tike_tpu.lamino.reconstruct(
        data, theta, tilt, algorithm=algorithm, num_iter=1, upsample=1
    )
    n_timed = 5
    start = time.perf_counter()
    result = tike_tpu.lamino.reconstruct(
        data, theta, tilt, algorithm=algorithm, num_iter=n_timed, upsample=1
    )
    elapsed = time.perf_counter() - start
    return {
        "config": f"lamino_{algorithm}",
        "metric": f"lamino_{algorithm}_128cubed_sec_per_iter",
        "value": round(elapsed / n_timed, 4),
        "unit": "s/iter",
        "ntheta": ntheta,
        "final_cost": float(np.asarray(result["cost"])[-1]),
    }


def bench_lamino_cgrad(n=128, ntheta=64):
    return _bench_lamino("cgrad", n, ntheta)


def bench_lamino_cgls(n=128, ntheta=64):
    """CGLS variant of config 3: same problem, optimal-step linear CG.

    Beyond-reference solver (`lamino/solvers/cgls.py`): one fwd + one
    exact-adjoint per inner step, no backtracking cost evaluations.
    """
    return _bench_lamino("cgls", n, ntheta)


def admm_problem(n=64, P=16, T=8, NPOS=200):
    """Config 4's inputs: (data, parameters, theta, voxelsize, energy)."""
    import jax.numpy as jnp

    import tike_tpu.ptycho as tp
    from tike_tpu.constants import wavenumber
    from tike_tpu.ops.lamino import LaminoConfig, lamino_fwd_p

    rng = np.random.default_rng(0)
    energy, voxelsize = 10.0, 1e-7
    k = wavenumber(energy)
    delta = 0.5 / (k * voxelsize * n / 2)
    obj = np.zeros((n, n, n), dtype=np.complex64)
    s = slice(n // 4, 3 * n // 4)
    obj[s, s, s] = delta * (1 + 0.1j)
    theta = np.linspace(0, np.pi, T, endpoint=False).astype(np.float32)
    cfg = LaminoConfig(n=n, tilt=np.pi / 2, eps=1e-3, upsample=2)
    lines = np.asarray(
        lamino_fwd_p(cfg, jnp.asarray(obj, dtype=jnp.complex64),
                     jnp.asarray(theta, dtype=jnp.float32))
    ) * voxelsize
    psi_true = np.exp(1j * k * lines).astype(np.complex64)
    probe = (tp.gaussian(P) * (1 + 0j))[None, None, None].astype(np.complex64)
    scan = np.stack(
        [rng.uniform(2, n - P - 3, NPOS), rng.uniform(2, n - P - 3, NPOS)],
        -1,
    ).astype(np.float32)
    data = [
        tp.simulate(P, probe, scan, psi_true[t][None]).astype(np.float32)
        for t in range(T)
    ]
    parameters = [
        tp.PtychoParameters(
            psi=np.ones((1, n, n), np.complex64),
            probe=probe.copy(),
            scan=scan.copy(),
            algorithm_options=tp.RpieOptions(num_batch=1, num_iter=1),
            object_options=tp.ObjectOptions(),
            probe_options=tp.ProbeOptions(
                init_rescale_from_measurements=False
            ),
        )
        for _ in range(T)
    ]
    return data, parameters, theta, voxelsize, energy


def bench_admm_joint(n=64, P=16, T=8, NPOS=200):
    import tike_tpu.admm

    data, parameters, theta, voxelsize, energy = admm_problem(n, P, T, NPOS)
    # Warmup iteration compiles everything.
    out = tike_tpu.admm.reconstruct_joint_admm(
        data, parameters, theta, voxelsize=voxelsize, energy=energy,
        num_iter=1, ptycho_iter=2, lamino_iter=2,
    )
    n_timed = 3
    start = time.perf_counter()
    out = tike_tpu.admm.reconstruct_joint_admm(
        data, out["parameters"], theta, obj=out["obj"],
        voxelsize=voxelsize, energy=energy,
        num_iter=n_timed, ptycho_iter=2, lamino_iter=2,
    )
    elapsed = time.perf_counter() - start
    return {
        "config": "admm_joint",
        "metric": "admm_joint_sec_per_iter",
        "value": round(elapsed / n_timed, 4),
        "unit": "s/iter",
        "angles": T,
        "positions_per_angle": NPOS,
        "final_cost": float(out["costs"][-1]),
    }


def bench_stream_1m(n_patterns=1_000_000, det=64):
    """Long-axis demo: host-resident data streamed batch-by-batch."""
    import tike_tpu.ptycho as tp

    rng = np.random.default_rng(0)
    hw = 4096
    scan = np.stack(
        [
            rng.uniform(2, hw - det - 3, n_patterns),
            rng.uniform(2, hw - det - 3, n_patterns),
        ],
        -1,
    ).astype(np.float32)
    probe = (tp.gaussian(det) * np.exp(1j * 0.1 * tp.gaussian(det)))[
        None, None, None
    ].astype(np.complex64)
    # Throughput/memory demo: physically-plausible random data suffices.
    data = rng.random((n_patterns, det, det), np.float32)
    psi = np.full((1, hw, hw), 0.5 + 0j, np.complex64)
    params = tp.PtychoParameters(
        probe=probe,
        psi=psi,
        scan=scan,
        algorithm_options=tp.RpieOptions(
            # Clustering layouts are O(N*num_batch) on the host; at 1M
            # positions only the random partition is affordable.
            num_batch=100,
            num_iter=1,
            batch_method="random",
        ),
        object_options=tp.ObjectOptions(),
        probe_options=tp.ProbeOptions(
            init_rescale_from_measurements=False
        ),
    )
    with tp.Reconstruction(
        data, params, store_data_on_device=False, random_seed=0
    ) as context:
        assert isinstance(context.data, np.ndarray), "must be host-resident"
        start = time.perf_counter()
        context.iterate(1)
        elapsed = time.perf_counter() - start
    peak_rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    return {
        "config": "stream_1m",
        "metric": "stream_1m_patterns_per_sec",
        "value": round(n_patterns / elapsed, 1),
        "unit": "patterns/s",
        "epoch_s": round(elapsed, 2),
        "host_data_gb": round(data.nbytes / 2**30, 2),
        "peak_rss_gb": round(peak_rss_gb, 2),
    }


def bench_stream_compare(n_patterns=100_000, det=64):
    """Device-resident vs host-streamed throughput at the same size.

    At 100k x 64² the dataset (1.6 GB) fits device memory, so the same
    problem runs both ways: the delta isolates what host-streaming itself
    costs.
    """
    import jax
    import jax.numpy as jnp

    import tike_tpu.ptycho as tp

    rng = np.random.default_rng(0)
    hw = 4096
    scan = np.stack(
        [
            rng.uniform(2, hw - det - 3, n_patterns),
            rng.uniform(2, hw - det - 3, n_patterns),
        ],
        -1,
    ).astype(np.float32)
    probe = (tp.gaussian(det) * np.exp(1j * 0.1 * tp.gaussian(det)))[
        None, None, None
    ].astype(np.complex64)
    psi = np.full((1, hw, hw), 0.5 + 0j, np.complex64)

    def fresh_params():
        return tp.PtychoParameters(
            probe=probe.copy(),
            psi=psi.copy(),
            scan=scan.copy(),
            algorithm_options=tp.RpieOptions(
                num_batch=10, num_iter=1, batch_method="random"
            ),
            object_options=tp.ObjectOptions(),
            probe_options=tp.ProbeOptions(
                init_rescale_from_measurements=False
            ),
        )

    def timed(data, on_device):
        with tp.Reconstruction(
            data,
            fresh_params(),
            store_data_on_device=on_device,
            random_seed=0,
        ) as context:
            context.iterate(1)  # warm-up: compile
            jax.block_until_ready(context.parameters.psi)
            start = time.perf_counter()
            context.iterate(2)
            jax.block_until_ready(context.parameters.psi)
            return (time.perf_counter() - start) / 2

    # Device-resident arm: data born on the device (random suffices for
    # throughput).
    data_dev = jax.random.uniform(
        jax.random.PRNGKey(0), (n_patterns, det, det), jnp.float32
    )
    dev_s = timed(data_dev, on_device=True)
    del data_dev
    # Host-streamed arm: same shapes, data stays in host RAM and each
    # mini-batch uploads (double-buffered).
    data_host = rng.random((n_patterns, det, det)).astype(np.float32)
    host_s = timed(data_host, on_device=False)

    return {
        "config": "stream_compare",
        "metric": "stream100k_device_resident_patterns_per_sec",
        "value": round(n_patterns / dev_s, 1),
        "unit": "patterns/s",
        "host_streamed_patterns_per_sec": round(n_patterns / host_s, 1),
        "device_epoch_s": round(dev_s, 2),
        "host_epoch_s": round(host_s, 2),
        "n_patterns": n_patterns,
    }


BENCHES = {
    "rpie_siemens": bench_rpie_siemens,
    "lsqml_opr_pos": bench_lsqml_opr_pos,
    "lamino_cgrad": bench_lamino_cgrad,
    "lamino_cgls": bench_lamino_cgls,
    "admm_joint": bench_admm_joint,
    "stream_1m": bench_stream_1m,
    "stream_compare": bench_stream_compare,
}


def main():
    from tike_tpu import runtime

    runtime.require_gpu()
    cache = runtime.enable_compile_cache(_HERE)
    for line in runtime.describe_run(cache):
        print(line, flush=True)

    names = sys.argv[1:] or [
        "rpie_siemens",
        "lsqml_opr_pos",
        "lamino_cgrad",
        "admm_joint",
    ]
    for name in names:
        print(f"# running {name} ...", file=sys.stderr, flush=True)
        t0 = time.perf_counter()
        out = BENCHES[name]()
        out["bench_wall_s"] = round(time.perf_counter() - t0, 1)
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python
"""Error and time of each candidate solver matmul precision on a GPU.

    python profile/precision_sweep.py [--json PATH] [--small]

For every candidate of ``tike_tpu.precision.SOLVER_MATMUL`` it recompiles
the solver call sites and prints, per site, the error against HIGHEST
(max |x - x_HIGHEST| / max |x_HIGHEST|) at the headline widths: 1000
windows of 128² on a 1500² object, 2 probe modes. It then times the patch
operators and one rPIE step, and, for the candidates that keep f32
accuracy, the headline LSQML (10k x 128² patterns, 3 epochs after a
warm-up). A candidate that XLA refuses is reported as refused. ``--small``
shrinks every size, for a quick check of the script itself.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def median_seconds(fn, *args, repeats=20):
    import jax

    jax.block_until_ready(fn(*args))
    runs = []
    for _ in range(repeats):
        start = time.perf_counter()
        jax.block_until_ready(fn(*args))
        runs.append(time.perf_counter() - start)
    return float(np.median(runs))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--json", help="also write the results here")
    parser.add_argument("--small", action="store_true")
    args = parser.parse_args()

    import jax
    import jax.numpy as jnp

    import tike_tpu.ptycho as tp
    from bench import _make_inputs
    from tests.ptycho import test_numpy_oracle as oracle
    from tike_tpu import precision, runtime
    from tike_tpu.ops.patch import patch_adj, patch_fwd
    from tike_tpu.ops.ptycho import PtychoConfig, ptycho_fwd_with_probes
    from tike_tpu.ptycho.solvers._preconditioner import (
        probe_preconditioner,
        psi_preconditioner,
    )
    from tike_tpu.ptycho.solvers.rpie import _batch_gradients

    runtime.require_gpu()
    for line in runtime.describe_run(runtime.enable_compile_cache(HERE)):
        print(line, flush=True)

    lax = jax.lax
    candidates = [
        ("HIGHEST", lax.Precision.HIGHEST),
        ("HIGH", lax.Precision.HIGH),
        ("DEFAULT", lax.Precision.DEFAULT),
        ("BF16_BF16_F32_X3", lax.DotAlgorithmPreset.BF16_BF16_F32_X3),
        ("TF32_TF32_F32_X3", lax.DotAlgorithmPreset.TF32_TF32_F32_X3),
        ("TF32_TF32_F32", lax.DotAlgorithmPreset.TF32_TF32_F32),
    ]
    accurate = ("HIGHEST", "BF16_BF16_F32_X3", "TF32_TF32_F32_X3")
    hw, p, b, n_lsqml = (96, 16, 20, 64) if args.small else (
        1500, 128, 1000, 10_000)
    psi, probe, scan, data, precond = oracle.make_inputs(
        B=b, P=p, DET=p, M=2, H=hw)
    cfg = PtychoConfig(probe_shape=p, detector_shape=p, nz=hw, n=hw)
    psi_d = jnp.asarray(psi[None])
    probe_d = jnp.asarray(probe[None, None])
    scan_d = jnp.asarray(scan)
    data_d = jnp.asarray(data)
    rng = np.random.default_rng(0)
    patches = jnp.asarray((rng.standard_normal((b, p, p))
                           + 1j * rng.standard_normal((b, p, p))
                           ).astype(np.complex64))

    def sites():
        out = {
            "ops/ptycho.py farplane": jax.jit(
                lambda ps, s, pr: ptycho_fwd_with_probes(
                    cfg, ps, s, pr[:, 0])[0]
            )(psi_d, scan_d, probe_d[0]),
            "_preconditioner.py psi (patch_adj)": psi_preconditioner(
                cfg, psi_d, scan_d, probe_d),
            "_preconditioner.py probe (patch_fwd)": probe_preconditioner(
                cfg, psi_d, scan_d),
        }
        out.update(zip(
            ("rpie.py costs", "rpie.py psi_num", "rpie.py probe_num"),
            oracle.run_rpie_gradients(psi, probe, scan, data),
        ))
        step = oracle.run_lstsq_batch(psi, probe, scan, data, precond, 10.0)
        for name in ("object_upd_sum", "m_probe_update",
                     "object_update_precond", "beta_object", "beta_probe"):
            out[f"lstsq.py {name}"] = step[name]
        return {k: np.asarray(v) for k, v in out.items()}

    def rpie_step():
        return _batch_gradients(
            cfg, data_d, scan_d, jnp.arange(b, dtype=jnp.int32),
            jnp.ones(b, jnp.float32), psi_d, probe_d, None, None,
            jnp.ones((p, p), bool), 0.5, 0.5, 1.0, noise_model="gaussian",
            steplength_usemodes="all_modes", recover_probe=True)

    results = {}
    reference = None
    for name, prec in candidates:
        precision.SOLVER_MATMUL = prec
        jax.clear_caches()
        try:
            got = sites()
        except Exception as error:  # XLA may refuse an algorithm preset.
            if reference is None:
                raise
            print(f"== {name}: refused: {type(error).__name__}: "
                  f"{str(error)[:300]}", flush=True)
            continue
        reference = got if reference is None else reference
        errors = {
            k: float(np.max(np.abs(v - reference[k]))
                     / max(float(np.max(np.abs(reference[k]))), 1e-30))
            for k, v in got.items()
        }
        fwd = jax.jit(lambda im, po: patch_fwd(im, po, p, precision=prec))
        adj = jax.jit(lambda pa, po: patch_adj(pa, po, (hw, hw),
                                               precision=prec))
        times = {
            "patch_fwd_ms": 1e3 * median_seconds(fwd, psi_d[0], scan_d),
            "patch_adj_ms": 1e3 * median_seconds(adj, patches, scan_d),
            "rpie_step_ms": 1e3 * median_seconds(rpie_step),
        }
        results[name] = dict(errors=errors, **times)
        print(f"== {name}: " + ", ".join(
            f"{k} {v:.3f}" for k, v in times.items()), flush=True)
        for k, e in errors.items():
            print(f"   {k}: {e:.3e}", flush=True)

    scan, psi0, probe0 = _make_inputs(n_lsqml, det=p, probe_shape=p, hw=hw)
    data = jax.block_until_ready(tp.simulate_device(p, probe0, scan, psi0))
    for name, prec in candidates:
        if name not in accurate or name not in results:
            continue
        precision.SOLVER_MATMUL = prec
        jax.clear_caches()
        params = tp.PtychoParameters(
            probe=probe0, psi=np.full_like(psi0, 0.5), scan=scan,
            algorithm_options=tp.LstsqOptions(
                num_batch=10, num_iter=1, batch_method="compact"),
            object_options=tp.ObjectOptions(),
            probe_options=tp.ProbeOptions(),
        )
        with tp.Reconstruction(data, params, random_seed=0) as ctx:
            ctx.iterate(3)
            jax.block_until_ready(ctx.parameters.psi)
            start = time.perf_counter()
            ctx.iterate(3)
            jax.block_until_ready(ctx.parameters.psi)
            seconds = time.perf_counter() - start
            costs = [float(np.mean(c))
                     for c in ctx.parameters.algorithm_options.costs]
        rate = 3 * n_lsqml / seconds
        results[name]["headline_lsqml_patterns_per_s"] = rate
        print(f"== headline LSQML at {name}: {rate:.1f} patterns/s, "
              f"costs {np.array2string(np.asarray(costs), precision=6)}",
              flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()

#!/usr/bin/env python
"""Profile a ptychography reconstruction with the JAX profiler.

Equivalent of the reference's harness (`profile/profile_ptycho.py:32-83`,
which wraps reconstruction in pyinstrument + CUDA profiler ranges): here one
warm-up epoch compiles everything, then timed epochs run inside
`jax.profiler.trace`, producing a TensorBoard/XProf trace of the XLA
programs, DMAs, and collectives.

Usage:
    python profile/profile_ptycho.py [n_patterns] [trace_dir]
"""

import sys
import time

import numpy as np


def main():
    import jax

    import tike_tpu.ptycho as tp

    n_patterns = int(sys.argv[1]) if len(sys.argv) > 1 else 2000
    trace_dir = sys.argv[2] if len(sys.argv) > 2 else "build/trace"

    rng = np.random.default_rng(0)
    P = det = 128
    hw = 1200
    yy, xx = np.mgrid[0:hw, 0:hw] / hw
    psi = np.exp(1j * 0.5 * np.sin(17 * yy) * np.cos(13 * xx)).astype(
        np.complex64
    )[None]
    probe = (tp.gaussian(P) * np.exp(1j * 0.2 * tp.gaussian(P)))[
        None, None, None
    ].astype(np.complex64)
    scan = np.stack(
        [
            rng.uniform(2, hw - P - 3, n_patterns),
            rng.uniform(2, hw - P - 3, n_patterns),
        ],
        -1,
    ).astype(np.float32)

    import bench

    data = bench._simulate_numpy(det, probe, scan, psi)

    params = tp.PtychoParameters(
        probe=probe,
        psi=np.full_like(psi, 0.5),
        scan=scan,
        algorithm_options=tp.RpieOptions(
            num_batch=10, num_iter=1, batch_method="compact"
        ),
        object_options=tp.ObjectOptions(),
        probe_options=tp.ProbeOptions(),
    )
    with tp.Reconstruction(data, params) as context:
        context.iterate(1)  # warm-up: compile everything
        jax.block_until_ready(context.parameters.psi)

        with jax.profiler.trace(trace_dir):
            start = time.perf_counter()
            context.iterate(3)
            jax.block_until_ready(context.parameters.psi)
            elapsed = time.perf_counter() - start

    print(
        f"3 epochs over {n_patterns} patterns in {elapsed:.3f}s "
        f"({3 * n_patterns / elapsed:.0f} patterns/s)"
    )
    print(f"Trace written to {trace_dir} (open with xprof/tensorboard).")


if __name__ == "__main__":
    main()

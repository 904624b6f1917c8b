#!/usr/bin/env python
"""The >HBM object axis: striped reconstruction of a large psi.

`python bench_all.py stream_1m` scales the diffraction-pattern axis (1M
patterns, host-streamed); this demo covers the OTHER long axis — object
extent. The object never materializes on a single device: each device
holds only its row-stripe window (Hs + 2*halo rows), the probe is
psum-mean reconciled, halos cross-fade every epoch, and the full psi
exists only at stitch time on the host (the reference's multi-GPU psi
decomposition, `ptycho/ptycho.py:371-396,491-502`).

Run (defaults: 4096-row object on an 8-device mesh):

    python scripts/striped_demo.py [H] [n_positions]

On CPU the 8 virtual devices emulate the mesh; on a multi-GPU host the
same program shards over the cards (plus processes via
striped_local_indices).
"""

import os
import sys
import time

import numpy as np

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def main():
    import jax

    # Pin the platform BEFORE any backend-touching call. Set
    # TIKE_DEMO_PLATFORM=gpu to run on the GPUs instead.
    platform = os.environ.get("TIKE_DEMO_PLATFORM", "cpu")
    try:
        jax.config.update("jax_platforms", platform)
        if platform == "cpu":
            jax.config.update("jax_num_cpu_devices", 8)
    except RuntimeError:
        pass

    import tike_tpu.ptycho as tp
    from tike_tpu.parallel import make_mesh
    from tike_tpu.parallel.striped import plan_stripes

    H = int(sys.argv[1]) if len(sys.argv) > 1 else 4096
    NPOS = int(sys.argv[2]) if len(sys.argv) > 2 else 4096
    W, P = H, 32
    rng = np.random.default_rng(0)

    yy, xx = np.mgrid[0:512, 0:512] / 512
    tile = (
        np.exp(1j * 0.5 * np.sin(5 * yy) * np.cos(3 * xx))
        * (0.9 + 0.1 * np.cos(7 * xx))
    ).astype(np.complex64)
    psi_true = np.tile(tile, (H // 512, W // 512))[None]
    probe = (tp.gaussian(P) * np.exp(1j * 0.2 * tp.gaussian(P)))[
        None, None, None
    ].astype(np.complex64)
    scan = np.stack(
        [rng.uniform(2, H - P - 3, NPOS), rng.uniform(2, W - P - 3, NPOS)],
        -1,
    ).astype(np.float32)
    print(f"simulating {NPOS} patterns over a {H}x{W} object "
          f"({psi_true.nbytes / 2**20:.0f} MB psi) ...", flush=True)
    data = tp.simulate(P, probe, scan, psi_true).astype(np.float32)

    mesh = make_mesh()
    plan = plan_stripes(scan, (H, W), P, mesh.size)
    window_mb = plan.local_height * W * 8 / 2**20
    print(
        f"mesh={mesh.size} devices; per-device window "
        f"{plan.local_height}x{W} rows = {window_mb:.0f} MB "
        f"(vs {psi_true.nbytes / 2**20:.0f} MB full psi; "
        f"{psi_true.nbytes / 2**20 / window_mb:.1f}x reduction)",
        flush=True,
    )

    params = tp.PtychoParameters(
        probe=probe,
        psi=np.full_like(psi_true, 0.5),
        scan=scan,
        algorithm_options=tp.RpieOptions(
            num_batch=4, num_iter=5, batch_method="compact"
        ),
        object_options=tp.ObjectOptions(),
        probe_options=tp.ProbeOptions(),
    )
    t0 = time.perf_counter()
    result = tp.reconstruct(
        data, params, mesh=mesh, object_sharding="striped"
    )
    elapsed = time.perf_counter() - t0
    costs = [float(np.mean(c)) for c in result.algorithm_options.costs]
    assert np.all(np.isfinite(costs)) and costs[-1] < costs[0], costs

    # Quality over the well-illuminated interior.
    interior = (slice(None), slice(64, -64), slice(64, -64))
    a = np.asarray(result.psi)[interior]
    b = psi_true[interior]
    corr = np.abs(np.vdot(a, b)) / (
        np.linalg.norm(a) * np.linalg.norm(b) + 1e-12
    )
    import json

    print(
        json.dumps(
            {
                "config": "striped_object",
                "object": f"{H}x{W}",
                "patterns": NPOS,
                "devices": mesh.size,
                "window_rows": plan.local_height,
                "psi_mb": round(psi_true.nbytes / 2**20, 1),
                "window_mb": round(window_mb, 1),
                "epochs": len(costs),
                "wall_s": round(elapsed, 1),
                "cost_first_last": [round(costs[0], 5), round(costs[-1], 5)],
                "interior_corr_vs_truth": round(float(corr), 4),
            }
        ),
        flush=True,
    )


if __name__ == "__main__":
    main()

"""Benchmark: LSQML/rPIE epoch throughput on the headline configuration.

Headline metric (BASELINE.md): diffraction patterns per second over one
solver epoch, 10k 128x128 patterns of a 1500x1500 object, num_batch 10.
vs_baseline = value / 10000.

Usage: python bench.py [n_patterns] [lsqml|rpie]

One process on one GPU. It prints the card (name and power limit), then ONE
JSON line {"metric", "value", "unit", "vs_baseline", ...}. Without a GPU it
exits non-zero and prints no result.
"""

import json
import os
import sys
import time

import numpy as np


def _simulate_numpy(det, probe, scan, psi):
    """Host-side (numpy) forward model: the reference for simulate_device."""
    p = probe.shape[-1]
    probe2d = probe[0, 0]  # (M, P, P)
    corner = np.floor(scan).astype(np.int64)
    frac = scan - corner
    n = len(scan)
    out = np.empty((n, det, det), np.float32)
    chunk = 512
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        pats = np.empty((hi - lo, p, p), np.complex64)
        for k, (c, f) in enumerate(zip(corner[lo:hi], frac[lo:hi])):
            win = psi[0, c[0] : c[0] + p + 1, c[1] : c[1] + p + 1]
            fy, fx = f
            pats[k] = (
                (1 - fy) * (1 - fx) * win[:-1, :-1]
                + (1 - fy) * fx * win[:-1, 1:]
                + fy * (1 - fx) * win[1:, :-1]
                + fy * fx * win[1:, 1:]
            )
        near = pats[:, None] * probe2d[None]  # (B, M, P, P)
        pad = (det - p) // 2
        if pad:
            near = np.pad(
                near, ((0, 0), (0, 0), (pad, det - p - pad), (pad, det - p - pad))
            )
        far = np.fft.fft2(near, norm="ortho")
        out[lo:hi] = np.sum(np.abs(far) ** 2, axis=1)
    return out


def _make_inputs(n_patterns, det=128, probe_shape=128, hw=1500):
    """Deterministic benchmark inputs (seed 0), matching BASELINE.json."""
    from tike_tpu.ptycho import gaussian

    rng = np.random.default_rng(0)
    scan = np.stack(
        [
            rng.uniform(2, hw - probe_shape - 3, n_patterns),
            rng.uniform(2, hw - probe_shape - 3, n_patterns),
        ],
        -1,
    ).astype(np.float32)
    yy, xx = np.mgrid[0:hw, 0:hw] / hw
    psi = (
        np.exp(1j * 0.5 * np.sin(17 * yy) * np.cos(13 * xx))
        * (0.9 + 0.1 * np.cos(23 * xx * yy))
    ).astype(np.complex64)[None]
    win = gaussian(probe_shape, rin=0.8, rout=1.0)
    probe = (win * np.exp(1j * 0.2 * win))[None, None, None].astype(
        np.complex64
    )
    return scan, psi, probe


def main(argv):
    import jax

    from tike_tpu import runtime

    device = runtime.require_gpu()
    cache = runtime.enable_compile_cache(os.path.dirname(os.path.abspath(__file__)))
    for line in runtime.describe_run(cache):
        print(line, flush=True)

    import tike_tpu.ptycho as tp

    n_patterns = int(argv[0]) if argv else 10_000
    solver = argv[1] if len(argv) > 1 else "lsqml"
    num_batch = 10

    scan, psi, probe = _make_inputs(n_patterns)
    # The dataset is simulated on the device and stays there.
    data = jax.block_until_ready(tp.simulate_device(128, probe, scan, psi))
    params = tp.PtychoParameters(
        probe=probe,
        psi=np.full_like(psi, 0.5),
        scan=scan,
        algorithm_options=(
            tp.LstsqOptions if solver == "lsqml" else tp.RpieOptions
        )(num_batch=num_batch, num_iter=1, batch_method="compact"),
        object_options=tp.ObjectOptions(),
        probe_options=tp.ProbeOptions(),
    )
    n_timed = 3
    with tp.Reconstruction(data, params) as context:
        # Warm-up with the same epoch count, so the timed call reuses the
        # compiled multi-epoch program.
        start = time.perf_counter()
        context.iterate(n_timed)
        jax.block_until_ready(context.parameters.psi)
        setup_s = time.perf_counter() - start
        start = time.perf_counter()
        context.iterate(n_timed)
        jax.block_until_ready(context.parameters.psi)
        elapsed = time.perf_counter() - start
        costs = context.parameters.algorithm_options.costs

    patterns_per_sec = n_patterns * n_timed / elapsed
    print(
        json.dumps(
            {
                "metric": f"{solver}_epoch_patterns_per_sec_128px",
                "value": round(patterns_per_sec, 1),
                "unit": "patterns/s",
                "vs_baseline": round(patterns_per_sec / 10_000, 3),
                "final_cost": float(np.mean(costs[-1])),
                "num_batch": num_batch,
                "warmup_s": round(setup_s, 3),
                "device": device,
            }
        ),
        flush=True,
    )


if __name__ == "__main__":
    main(sys.argv[1:])

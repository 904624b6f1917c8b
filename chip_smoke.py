#!/usr/bin/env python
"""Run the reconstruction path once on a GPU at real widths, and check it.

    python chip_smoke.py          # one card: phases 1-5
    python chip_smoke.py --four   # four cards: the data-parallel, striped
                                  # and bucket-2D paths, each against the
                                  # same run on one card, and nothing else

Every phase drives the entry points a user calls, at the widths of the
benchmark configurations, and compares what comes out with the repository's
plain references: the numpy oracles of tests/ptycho/test_numpy_oracle.py,
the golden data of tests/test_parity_golden.py, and the same run on the CPU
or on one card. Per phase it prints the set-up time (compilation included),
the run time (ended by block_until_ready), the device's peak memory so far,
and each error beside its tolerance.

The last line of standard output is one JSON object,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a GPU, or when any phase fails, "ok" is false and the exit code 1.

Each phase function takes its sizes as arguments; tests/test_chip_smoke.py
runs them at tiny sizes on the CPU.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# Relative error of the patch operators against the numpy oracles. At
# HIGHEST every product is exact f32, so only summation order differs
# (~1e-7 per add); the solvers' precision may round the blend weights
# further (bf16x3 keeps ~1e-5).
HIGHEST_TOL = 1e-5
SOLVER_TOL = 1e-4
# One solver step (FFTs, reductions, a 2x2 solve) against numpy in f32/f64.
STEP_TOL = 1e-4
STEP_SIZE_TOL = 1e-3
# rPIE per-epoch costs on the GPU against the CPU. Both run the same f32
# program; cuFFT and the CPU's FFT, and the two backends' reductions, round
# differently (~1e-7 per operation), and three epochs of updates carry
# those differences forward. 1e-4 bounds that with margin, while a wrong
# sign, norm or index on either backend moves the cost by percents.
GPU_CPU_RTOL = 1e-4
# Four cards against one: the same program with its per-batch sums split
# into four partial sums and reduced across cards, so only the order of
# f32 additions differs. Costs follow that closely. LSQML's object does
# not: its per-position 2x2 step solve amplifies rounding (perturbing the
# data by 1e-7 moves psi by 4e-4, relative L2, after one epoch on the CPU),
# so psi is held to a looser bound that still catches a wrong shard or sum.
MESH_COST_RTOL = 1e-3
MESH_PSI_RTOL = 1e-2
# Bucket CG, two outer iterations at 128³ x 32 angles. The operator puts
# each voxel in the pixel under floor() of its projection, and 17,217 of
# the 134M projected coordinates (1.3e-4) change pixel between f32 and f64
# arithmetic, so two programs that round differently build slightly
# different operators. Over two calls on 4 x H100, a rerun of one
# compiled program agreed with itself to 1.3e-7 in cost and object; the
# 2x2 mesh missed the one card by up to 6.3e-5 in cost and 7.4e-5 in
# object (relative L2), the CPU by up to 9.4e-5 and 2.4e-2. The limits
# keep 10x or more over the costs and 4x over the objects; a wrong psum
# scale moves the costs by percents.
BUCKET_RERUN_RTOL = 1e-5
BUCKET_COST_RTOL = 1e-3
BUCKET_OBJ_RTOL = 1e-1


class Report:
    """Prints each check as it is made and keeps the failures."""

    def __init__(self):
        self.failures: list[str] = []

    def _line(self, ok: bool, text: str):
        print(f"  {'ok  ' if ok else 'FAIL'} {text}", flush=True)
        if not ok:
            self.failures.append(text)

    def error(self, name: str, err: float, tol: float):
        """Pass iff ``err`` is finite and at most ``tol``."""
        err = float(err)
        self._line(
            bool(np.isfinite(err) and err <= tol),
            f"{name}: error {err:.3e}, tolerance {tol:.1e}",
        )

    def require(self, name: str, ok, detail: str = ""):
        self._line(bool(ok), f"{name}: {detail}" if detail else name)

    def timing(self, name: str, setup_s: float, run_s: float, note=""):
        print(
            f"  time {name}: set-up {setup_s:.3f} s (compilation included), "
            f"run {run_s * 1e3:.3f} ms{note}",
            flush=True,
        )

    def info(self, text: str):
        print(f"  {text}", flush=True)


def rel_err(got, want) -> float:
    """max |got - want| / max |want|."""
    got = np.asarray(got)
    want = np.asarray(want)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    return float(np.max(np.abs(got - want))) / scale


def timed(fn, *args, repeats: int = 1):
    """(output, first-call seconds, median seconds of ``repeats`` calls)."""
    import jax

    start = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    setup = time.perf_counter() - start
    runs = []
    for _ in range(repeats):
        start = time.perf_counter()
        jax.block_until_ready(fn(*args))
        runs.append(time.perf_counter() - start)
    return out, setup, float(np.median(runs)) if runs else setup


_LOWERING = {"count": 0, "listening": False}


def _count_lowering(event, _seconds, **_):
    if event == "/jax/core/compile/jaxpr_to_mlir_module_duration":
        _LOWERING["count"] += 1


def lowered_programs() -> int:
    """Programs this process has traced and lowered so far.

    A timed call that lowers one was retraced, and its time includes the
    compilation, whether or not the compile cache then holds the result."""
    import jax

    if not _LOWERING["listening"]:
        jax.monitoring.register_event_duration_secs_listener(_count_lowering)
        _LOWERING["listening"] = True
    return _LOWERING["count"]


def peak_memory() -> str:
    """Largest ``peak_bytes_in_use`` over the devices, so far."""
    import jax

    peaks = [
        (d.memory_stats() or {}).get("peak_bytes_in_use")
        for d in jax.devices()
    ]
    peaks = [p for p in peaks if p is not None]
    return f"{max(peaks) / 2**30:.2f} GiB" if peaks else "not reported"


def check_decreasing(report: Report, name: str, costs):
    costs = np.asarray(costs, np.float64).ravel()
    report.require(
        f"{name}: costs finite and decreasing",
        costs.size > 1
        and np.all(np.isfinite(costs))
        and np.all(np.diff(costs) < 0),
        np.array2string(costs, precision=6),
    )


def random_complex(rng, *shape):
    return (
        rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    ).astype(np.complex64)


def plain_gather(image, positions, p):
    """Bilinear patch gather as XLA's own gather: one (P+1)² window per
    position, then the four-corner blend (the upstream kernel's design)."""
    import jax
    import jax.numpy as jnp

    corner = jnp.floor(positions).astype(jnp.int32)
    frac = positions - corner
    win = jax.vmap(
        lambda c: jax.lax.dynamic_slice(image, (c[0], c[1]), (p + 1, p + 1))
    )(corner)
    fy = frac[:, 0, None, None]
    fx = frac[:, 1, None, None]
    return (
        (1 - fy) * (1 - fx) * win[:, :-1, :-1]
        + (1 - fy) * fx * win[:, :-1, 1:]
        + fy * (1 - fx) * win[:, 1:, :-1]
        + fy * fx * win[:, 1:, 1:]
    )


def reconstruct_timed(data, parameters, epochs, **kwargs):
    """Run ``epochs`` epochs twice in one Reconstruction: the first call
    compiles (set-up), the second is timed. Returns (per-epoch costs,
    set-up s, run s, fused, host psi, programs lowered in the timed run)."""
    import jax

    import tike_tpu.ptycho as tp

    with tp.Reconstruction(data, parameters, random_seed=0, **kwargs) as ctx:
        fused = (
            kwargs.get("object_sharding") != "striped"
            and ctx._fused_eligible()
        )
        start = time.perf_counter()
        ctx.iterate(epochs)
        jax.block_until_ready(ctx.parameters.psi)
        setup = time.perf_counter() - start
        lowered = lowered_programs()
        start = time.perf_counter()
        ctx.iterate(epochs)
        jax.block_until_ready(ctx.parameters.psi)
        run = time.perf_counter() - start
        lowered = lowered_programs() - lowered
        result = ctx.get_result()
    costs = [float(np.mean(c)) for c in result.algorithm_options.costs]
    return costs, setup, run, fused, np.asarray(result.psi), lowered


def check_compiled_once(report: Report, name: str, lowered: int):
    report.require(f"{name}: the timed run compiles nothing", lowered == 0,
                   f"{lowered} programs lowered")


def headline_problem(n, hw, det, algorithm="lsqml", num_batch=10):
    """The headline scan (bench._make_inputs, seed 0), its data simulated
    on the device, and a parameters factory for ``algorithm``."""
    import jax

    import tike_tpu.ptycho as tp
    from bench import _make_inputs

    scan, psi, probe = _make_inputs(n, det=det, probe_shape=det, hw=hw)
    data = jax.block_until_ready(tp.simulate_device(det, probe, scan, psi))
    options = {"lsqml": tp.LstsqOptions, "rpie": tp.RpieOptions}[algorithm]

    def parameters():
        return tp.PtychoParameters(
            probe=probe,
            psi=np.full_like(psi, 0.5),
            scan=scan,
            algorithm_options=options(
                num_batch=num_batch, num_iter=1, batch_method="compact"
            ),
            object_options=tp.ObjectOptions(),
            probe_options=tp.ProbeOptions(),
        )

    return data, parameters


# ---------------------------------------------------------------------------
# One card
# ---------------------------------------------------------------------------


def phase_operators(
    report: Report,
    hw=1500,
    p=128,
    n=1000,
    scan_hw=4096,
    scan_n=128,
    modes=3,
    repeats=10,
):
    """Patch operators, simulate and one solver step against numpy."""
    import jax
    import jax.numpy as jnp

    import tike_tpu.ptycho as tp
    from bench import _make_inputs, _simulate_numpy
    from tests.ptycho import test_numpy_oracle as oracle
    from tike_tpu import precision
    from tike_tpu.ops.patch import (
        patch_adj,
        patch_adj_scatter,
        patch_fwd,
        uses_cell_grid,
    )

    rng = np.random.default_rng(0)
    image = random_complex(rng, hw, hw)
    positions = rng.uniform(1, hw - p - 2, (n, 2)).astype(np.float32)
    patches = random_complex(rng, n, p, p)
    scan_positions = rng.uniform(1, scan_hw - p - 2, (scan_n, 2)).astype(
        np.float32
    )
    scan_patches = random_complex(rng, scan_n, p, p)
    want_fwd = oracle.np_patch_fwd(image, positions, p)
    adj_cases = [
        ("merged cell grid", (hw, hw), positions, patches),
        ("sequential scan", (scan_hw, scan_hw), scan_positions, scan_patches),
    ]
    report.require(
        "patch_adj branches covered",
        uses_cell_grid((hw, hw), n)
        and not uses_cell_grid((scan_hw, scan_hw), scan_n),
        f"{n} windows on {hw}² merge, {scan_n} on {scan_hw}² scan",
    )
    want_adj = [
        oracle.np_patch_adj(pat, pos, shape)
        for _, shape, pos, pat in adj_cases
    ]
    image_d = jnp.asarray(image)
    positions_d = jnp.asarray(positions)

    prod = {}
    for label, prec, tol in (
        ("HIGHEST", jax.lax.Precision.HIGHEST, HIGHEST_TOL),
        (f"solver precision {precision.SOLVER_MATMUL}",
         precision.SOLVER_MATMUL, SOLVER_TOL),
    ):
        fwd = jax.jit(functools.partial(patch_fwd, patch_width=p,
                                        precision=prec))
        got, setup, run = timed(fwd, image_d, positions_d, repeats=repeats)
        report.error(f"patch_fwd {label} vs numpy", rel_err(got, want_fwd),
                     tol)
        report.timing(f"patch_fwd {label}", setup, run)
        prod["fwd"] = run
        for (branch, shape, pos, pat), want in zip(adj_cases, want_adj):
            adj = jax.jit(functools.partial(patch_adj, images_shape=shape,
                                            precision=prec))
            got, setup, run = timed(
                adj, jnp.asarray(pat), jnp.asarray(pos), repeats=repeats
            )
            report.error(f"patch_adj {branch} {label} vs numpy",
                         rel_err(got, want), tol)
            report.timing(f"patch_adj {branch} {label}", setup, run)
            if shape == (hw, hw):
                prod["adj"] = run

    # The upstream kernels' design in plain XLA, timed against production
    # at the same shapes: a gather of bilinear windows, and one scatter-add
    # (atomics on a GPU).
    gather = jax.jit(functools.partial(plain_gather, p=p))
    got, setup, run = timed(gather, image_d, positions_d, repeats=repeats)
    report.error("plain XLA gather vs numpy", rel_err(got, want_fwd),
                 HIGHEST_TOL)
    report.info(
        f"timing gather at {n} x {p}² from {hw}²: plain XLA gather "
        f"{run * 1e3:.3f} ms, production patch_fwd at solver precision "
        f"{prod['fwd'] * 1e3:.3f} ms"
    )
    scatter = jax.jit(functools.partial(patch_adj_scatter,
                                        images_shape=(hw, hw)))
    got, setup, run = timed(
        scatter, jnp.asarray(patches), positions_d, repeats=repeats
    )
    report.error("patch_adj_scatter vs numpy", rel_err(got, want_adj[0]),
                 HIGHEST_TOL)
    report.info(
        f"timing scatter at {n} x {p}² into {hw}²: patch_adj_scatter "
        f"{run * 1e3:.3f} ms, production patch_adj at solver precision "
        f"{prod['adj'] * 1e3:.3f} ms"
    )

    # simulate_device against the host forward model, several modes.
    scan, psi, probe1 = _make_inputs(n, det=p, probe_shape=p, hw=hw)
    probe = np.asarray(
        tp.add_modes_cartesian_hermite(probe1, modes), np.complex64
    )
    want = _simulate_numpy(p, probe, scan, psi)
    got, setup, run = timed(
        lambda: tp.simulate_device(p, probe, scan, psi)
    )
    report.error(f"simulate_device {n} x {modes} modes vs numpy",
                 rel_err(got, want), STEP_TOL)
    report.timing("simulate_device", setup, run)

    # One rPIE and one LSQML mini-batch step against the numpy oracles.
    psi, probe, scan, data, precond = oracle.make_inputs(
        B=n, P=p, DET=p, M=2, H=hw
    )
    want = oracle.np_rpie_gradients(psi, probe, scan, data)
    got, setup, run = timed(
        lambda: oracle.run_rpie_gradients(psi, probe, scan, data)
    )
    for name, g, w in zip(("costs", "psi_num", "probe_num"), got, want):
        report.error(f"rPIE step {name} vs numpy", rel_err(g, w), STEP_TOL)
    report.timing("rPIE step (host round trip included)", setup, run)
    want = oracle.np_lstsq_batch(psi, probe, scan, data, precond, 10.0)
    got, setup, run = timed(
        lambda: oracle.run_lstsq_batch(psi, probe, scan, data, precond, 10.0)
    )
    for name in ("costs", "object_upd_sum", "m_probe_update",
                 "object_update_precond"):
        report.error(f"LSQML step {name} vs numpy",
                     rel_err(got[name], want[name]), STEP_TOL)
    for name in ("beta_object", "beta_probe"):
        report.error(
            f"LSQML step {name} vs numpy",
            rel_err(got[name].ravel(), np.ravel(want[name])),
            STEP_SIZE_TOL,
        )
    report.timing("LSQML step (host round trip included)", setup, run)


def phase_headline(report: Report, n=10_000, hw=1500, det=128,
                   num_batch=10, epochs=3):
    """The headline LSQML through Reconstruction, data simulated on device."""
    data, parameters = headline_problem(n, hw, det, "lsqml", num_batch)
    costs, setup, run, fused, _, lowered = reconstruct_timed(
        data, parameters(), epochs
    )
    report.require("headline LSQML runs the fused program", fused)
    check_compiled_once(report, "headline LSQML", lowered)
    check_decreasing(report, "headline LSQML", costs)
    report.timing(f"headline LSQML {epochs} epochs", setup, run,
                  f" ({n * epochs / run:.1f} patterns/s)")


def phase_opr_pos(report: Report, n=10_000, hw=1500, det=128,
                  num_batch=10, epochs=3):
    """lsqml_opr_pos: 3 modes, an eigen probe and position correction."""
    import jax

    import tike_tpu.ptycho as tp
    from bench_all import opr_pos_parameters, opr_pos_problem

    scan, probe, psi = opr_pos_problem(n, hw=hw, probe_shape=det)
    data = jax.block_until_ready(tp.simulate_device(det, probe, scan, psi))
    params = opr_pos_parameters(scan, probe, psi, num_batch=num_batch)
    costs, setup, run, fused, _, lowered = reconstruct_timed(
        data, params, epochs
    )
    report.require("lsqml_opr_pos runs the fused program", fused)
    check_compiled_once(report, "lsqml_opr_pos", lowered)
    check_decreasing(report, "lsqml_opr_pos", costs)
    report.timing(f"lsqml_opr_pos {epochs} epochs", setup, run,
                  f" ({n * epochs / run:.1f} patterns/s)")


def phase_gpu_vs_cpu(report: Report, data, scan, probe, psi, epochs=3,
                     num_batch=5):
    """rPIE on measured data, on the default device and on the CPU."""
    import jax

    import tike_tpu.ptycho as tp

    def run(device):
        params = tp.PtychoParameters(
            probe=probe,
            psi=psi,
            scan=scan,
            algorithm_options=tp.RpieOptions(
                num_batch=num_batch, num_iter=epochs, batch_method="compact"
            ),
            object_options=tp.ObjectOptions(),
            probe_options=tp.ProbeOptions(),
        )
        with jax.default_device(device):
            start = time.perf_counter()
            with tp.Reconstruction(data, params, random_seed=0) as ctx:
                ctx.iterate(epochs)
                costs = ctx.parameters.algorithm_options.costs
            seconds = time.perf_counter() - start
        return np.asarray([np.mean(c) for c in costs]), seconds

    accel, accel_s = run(jax.devices()[0])
    host, host_s = run(jax.devices("cpu")[0])
    check_decreasing(report, f"rPIE {len(scan)} x {data.shape[-1]}²", accel)
    report.error(
        f"rPIE per-epoch costs, {jax.devices()[0].platform} vs cpu",
        np.max(np.abs(accel - host) / np.abs(host)),
        GPU_CPU_RTOL,
    )
    report.info(
        f"rPIE {epochs} epochs, compilation included: "
        f"{jax.devices()[0].platform} {accel_s:.2f} s, cpu {host_s:.2f} s"
    )


def phase_siemens_star(report: Report, epochs=3, num_batch=5):
    from bench_all import siemens_star

    data, scan, probe, psi = siemens_star()
    phase_gpu_vs_cpu(report, data, scan, probe, psi, epochs, num_batch)


def phase_lamino_admm(
    report: Report,
    n=128,
    ntheta=64,
    iters=3,
    admm_sizes=(64, 16, 8, 200),
    align_sizes=(16, 256),
    golden_reconstruction=True,
):
    """Laminography CG, the operator's adjoint, the golden data, ADMM and
    cross-correlation alignment."""
    import jax.numpy as jnp

    import tike_tpu.align as ta
    import tike_tpu.lamino
    from bench_all import admm_problem, lamino_problem
    from tests import test_parity_golden as golden
    from tike_tpu.admm import reconstruct_joint_admm
    from tike_tpu.ops.lamino import LaminoConfig, lamino_adj, lamino_fwd

    data, theta, tilt = lamino_problem(n, ntheta)
    for algorithm in ("cgrad", "cgls"):
        kwargs = dict(algorithm=algorithm, upsample=1)
        start = time.perf_counter()
        tike_tpu.lamino.reconstruct(data, theta, tilt, num_iter=1, **kwargs)
        setup = time.perf_counter() - start
        start = time.perf_counter()
        result = tike_tpu.lamino.reconstruct(
            data, theta, tilt, num_iter=iters, **kwargs
        )
        run = time.perf_counter() - start
        check_decreasing(report, f"lamino {algorithm} {n}³ x {ntheta}",
                         result["cost"])
        report.timing(f"lamino {algorithm} {iters} iterations", setup, run)

    rng = np.random.default_rng(1)
    cfg = LaminoConfig(n=n, tilt=tilt, eps=1e-6, upsample=2)
    u = random_complex(rng, n, n, n)
    d = random_complex(rng, ntheta, n, n)
    theta_d = jnp.asarray(theta)
    fu = np.asarray(lamino_fwd(cfg, jnp.asarray(u), theta_d))
    fd = np.asarray(lamino_adj(cfg, jnp.asarray(d), theta_d))
    a = np.vdot(fu.ravel().astype(np.complex128), d.ravel())
    b = np.vdot(u.ravel().astype(np.complex128), fd.ravel())
    report.error(f"lamino <Fu, d> vs <u, F*d> at {n}³ x {ntheta}",
                 abs(a - b) / max(abs(a), abs(b)), 2e-3)

    cases = [
        ("golden ptycho simulate", golden.ptycho_simulate_golden,
         golden.SIMULATE_ATOL),
        ("golden lamino simulate", golden.lamino_simulate_golden,
         golden.SIMULATE_ATOL),
        ("golden align simulate", golden.align_simulate_golden,
         golden.SIMULATE_ATOL),
    ]
    if golden_reconstruction:
        cases.append(("golden lamino cgrad reconstruction",
                      golden.lamino_cgrad_golden,
                      golden.RECONSTRUCTION_ATOL))
    for name, case, atol in cases:
        got, want = case()
        report.require(f"{name} shape", got.shape == want.shape,
                       f"{got.shape} vs {want.shape}")
        report.error(f"{name} (max abs)", np.max(np.abs(got - want)), atol)

    sizes = dict(zip(("n", "P", "T", "NPOS"), admm_sizes))
    data, parameters, theta, voxelsize, energy = admm_problem(**sizes)
    start = time.perf_counter()
    out = reconstruct_joint_admm(
        data, parameters, theta, voxelsize=voxelsize, energy=energy,
        num_iter=1, ptycho_iter=2, lamino_iter=2,
    )
    report.require(f"ADMM {sizes}: costs finite",
                   np.all(np.isfinite(np.asarray(out["costs"], float))),
                   str(np.asarray(out["costs"], float)))
    report.info(f"ADMM 1 iteration, compilation included: "
                f"{time.perf_counter() - start:.2f} s")

    k, s = align_sizes
    yy, xx = np.mgrid[0:s, 0:s] / s
    images = np.stack([
        np.exp(1j * np.sin((5 + i) * yy * 2 * np.pi))
        * (0.6 + 0.4 * np.cos((7 + i) * xx * yy))
        for i in range(k)
    ]).astype(np.complex64)
    shift = rng.uniform(-5, 5, (k, 2)).astype(np.float32)
    unaligned = ta.simulate(images, shift=shift, flow=None,
                            padded_shape=None, angle=None)
    found = ta.reconstruct(original=images, unaligned=unaligned,
                           algorithm="cross_correlation", upsample_factor=4)
    report.error(f"cross-correlation shifts of {k} x {s}² (pixels)",
                 np.max(np.abs(found["shift"] - shift)), 0.3)


ONE_CARD = [
    ("1 operators at headline widths", phase_operators),
    ("2 headline LSQML", phase_headline),
    ("3 lsqml_opr_pos", phase_opr_pos),
    ("4 siemens-star rPIE, GPU against CPU", phase_siemens_star),
    ("5 laminography, golden data, ADMM, alignment", phase_lamino_admm),
]


# ---------------------------------------------------------------------------
# Four cards
# ---------------------------------------------------------------------------


def phase_four_data_parallel(report: Report, n=10_000, hw=1500, det=128,
                             num_batch=10, epochs=3, cards=4):
    """Headline LSQML over make_mesh(cards) against one card."""
    from tike_tpu.parallel import make_mesh

    data, params = headline_problem(n, hw, det, "lsqml", num_batch)
    # Host data: the mesh run places each shard on its own card.
    data = np.asarray(data)
    one = reconstruct_timed(data, params(), epochs)
    many = reconstruct_timed(data, params(), epochs, mesh=make_mesh(cards))
    check_decreasing(report, f"data-parallel LSQML on {cards}", many[0])
    report.error(f"per-epoch costs, {cards} cards vs 1",
                 np.max(np.abs(np.subtract(many[0], one[0])) / one[0]),
                 MESH_COST_RTOL)
    report.error(f"psi, {cards} cards vs 1 (relative L2)",
                 np.linalg.norm(many[4] - one[4]) / np.linalg.norm(one[4]),
                 MESH_PSI_RTOL)
    report.info(f"psi, {cards} cards vs 1: max |difference| / max |psi| "
                f"{rel_err(many[4], one[4]):.3e}")
    for label, r in (("1 card", one), (f"{cards} cards", many)):
        check_compiled_once(report, f"headline LSQML on {label}", r[5])
        report.timing(f"headline LSQML {epochs} epochs on {label}", r[1],
                      r[2], f" ({n * epochs / r[2]:.1f} patterns/s)")


def phase_four_striped(report: Report, n=10_000, hw=1500, det=128,
                       num_batch=10, epochs=3, cards=4):
    """Striped-object rPIE on ``cards`` cards against the replicated run on
    one. Stripes see fewer positions each, so the check is the one the CPU
    tests make: comparable final cost and a matching interior."""
    from tike_tpu.parallel import make_mesh

    data, params = headline_problem(n, hw, det, "rpie", num_batch)
    # Striped runs take host data.
    data = np.asarray(data)
    one = reconstruct_timed(data, params(), epochs)
    many = reconstruct_timed(data, params(), epochs, mesh=make_mesh(cards),
                             object_sharding="striped")
    check_decreasing(report, "replicated rPIE on 1", one[0])
    check_decreasing(report, f"striped rPIE on {cards}", many[0])
    report.require(
        "striped final cost within 2x of replicated",
        many[0][-1] < 2.0 * max(one[0][-1], 1e-3) + 0.05,
        f"{many[0][-1]:.6g} vs {one[0][-1]:.6g}",
    )
    a = many[4][:, det:-det, det:-det].ravel()
    b = one[4][:, det:-det, det:-det].ravel()
    corr = np.abs(np.vdot(a, b)) / (np.linalg.norm(a) * np.linalg.norm(b))
    report.error("1 - interior correlation, striped vs replicated",
                 1 - corr, 0.05)
    for label, r in (("1 card replicated", one), (f"{cards} cards striped",
                                                  many)):
        check_compiled_once(report, f"rPIE on {label}", r[5])
        report.timing(f"rPIE {epochs} epochs on {label}", r[1], r[2],
                      f" ({n * epochs / r[2]:.1f} patterns/s)")


def phase_four_bucket(report: Report, n=128, ntheta=32, num_iter=2,
                      cg_iter=3):
    """Bucket laminography on a 2x2 (data x volume) mesh against one card.

    One card runs twice, to show that its result is reproducible, and the
    CPU runs once as a witness that shares neither the GPU's atomics nor
    its rounding. The mesh is held to the one card's costs and object by
    relative measures that see scale, so a wrong normalisation of either
    psum fails."""
    import jax
    from jax.sharding import Mesh

    import tike_tpu.lamino.bucket as tlb

    rng = np.random.default_rng(1)
    obj = 0.1 * random_complex(rng, n, n, n)
    theta = np.linspace(0, 2 * np.pi, ntheta, endpoint=False).astype(
        np.float32
    )
    tilt = np.pi / 3
    data = tlb.simulate(obj, theta, tilt, eps=1.0)
    kwargs = dict(data=data, theta=theta, tilt=tilt, num_iter=num_iter,
                  cg_iter=cg_iter, eps=1.0)

    def run(label, **more):
        start = time.perf_counter()
        result = tlb.reconstruct(**kwargs, **more)
        seconds = time.perf_counter() - start
        check_decreasing(report, f"bucket on {label}", result["cost"])
        return result, seconds

    single, single_s = run("1 card")
    again, _ = run("1 card, second run")
    with jax.default_device(jax.devices("cpu")[0]):
        host, host_s = run("the cpu")
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("d", "v"))
    meshed, meshed_s = run("a 2x2 mesh", mesh=mesh)
    for label, result, cost_rtol, obj_rtol in (
        ("1 card second run", again, BUCKET_RERUN_RTOL, BUCKET_RERUN_RTOL),
        ("cpu", host, BUCKET_COST_RTOL, BUCKET_OBJ_RTOL),
        ("2x2 mesh", meshed, BUCKET_COST_RTOL, BUCKET_OBJ_RTOL),
    ):
        report.error(
            f"bucket costs, {label} vs 1 card",
            np.max(np.abs(result["cost"] - single["cost"]) / single["cost"]),
            cost_rtol,
        )
        report.error(
            f"bucket object, {label} vs 1 card (relative L2)",
            np.linalg.norm(result["obj"] - single["obj"])
            / np.linalg.norm(single["obj"]),
            obj_rtol,
        )
    report.info(f"bucket {n}³ x {ntheta}, compilation included: 1 card "
                f"{single_s:.2f} s, cpu {host_s:.2f} s, 2x2 mesh "
                f"{meshed_s:.2f} s")


FOUR_CARDS = [
    ("a data-parallel LSQML, 4 cards against 1", phase_four_data_parallel),
    ("b striped rPIE, 4 cards against 1", phase_four_striped),
    ("c bucket laminography, 2x2 mesh against 1 card", phase_four_bucket),
]


def run_phases(report: Report, phases) -> None:
    for name, phase in phases:
        print(f"== phase {name}", flush=True)
        before = len(report.failures)
        start = time.perf_counter()
        try:
            phase(report)
        except Exception:
            traceback.print_exc(file=sys.stdout)
            report.failures.append(f"phase {name} raised")
        status = "ok" if len(report.failures) == before else "FAILED"
        print(
            f"== phase {name}: {status} in {time.perf_counter() - start:.1f}"
            f" s; peak device memory so far {peak_memory()}",
            flush=True,
        )


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--four", action="store_true",
        help="run only the four-card paths, each against one card",
    )
    args = parser.parse_args(argv)

    from tike_tpu import runtime

    try:
        device = runtime.require_gpu()
        if args.four and device["count"] < 4:
            raise RuntimeError(f"--four needs 4 GPUs, JAX found {device}")
    except RuntimeError as error:
        print(error, flush=True)
        print(json.dumps({"ok": False, "device": runtime.device_summary()}))
        return 1
    cache = runtime.enable_compile_cache(HERE)
    for line in runtime.describe_run(cache):
        print(line, flush=True)

    report = Report()
    run_phases(report, FOUR_CARDS if args.four else ONE_CARD)
    for failure in report.failures:
        print(f"FAILED: {failure}", flush=True)
    ok = not report.failures
    print(json.dumps({"ok": ok, "device": device}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

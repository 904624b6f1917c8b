"""chip_smoke.py's phases at tiny sizes on the CPU, and its refusal to run
without a GPU.

The script itself runs at real widths on a GPU; these tests keep its
phases, references and tolerances working where there is none.
"""

import json
import os
import pathlib
import re

import jax
import numpy as np
import pytest

import chip_smoke
import tike_tpu
from tike_tpu import runtime


def _run(phase, **sizes):
    report = chip_smoke.Report()
    phase(report, **sizes)
    assert report.failures == []


def test_phase_operators_tiny():
    _run(
        chip_smoke.phase_operators,
        hw=160, p=16, n=40, scan_hw=256, scan_n=4, modes=2, repeats=1,
    )


def test_phase_headline_tiny():
    _run(chip_smoke.phase_headline, n=64, hw=96, det=16, num_batch=2,
         epochs=2)


def test_phase_opr_pos_tiny():
    _run(chip_smoke.phase_opr_pos, n=64, hw=96, det=16, num_batch=2,
         epochs=2)


def test_phase_gpu_vs_cpu_tiny():
    import tike_tpu.ptycho as tp
    from bench import _make_inputs

    scan, psi, probe = _make_inputs(48, det=16, probe_shape=16, hw=80)
    data = tp.simulate(16, probe, scan, psi)
    _run(
        chip_smoke.phase_gpu_vs_cpu,
        data=data, scan=scan, probe=probe, psi=np.full_like(psi, 0.5),
        epochs=3, num_batch=2,
    )


def test_phase_lamino_admm_tiny():
    _run(
        chip_smoke.phase_lamino_admm,
        n=16, ntheta=8, iters=3, admm_sizes=(16, 8, 2, 20),
        align_sizes=(2, 32), golden_reconstruction=False,
    )


@pytest.mark.parametrize("argv", [[], ["--four"]])
def test_main_without_gpu_fails(argv, capsys):
    assert chip_smoke.main(argv) == 1
    last = capsys.readouterr().out.strip().splitlines()[-1]
    record = json.loads(last)
    assert record["ok"] is False
    assert record["device"]["platform"] == "cpu"


def test_report_fails_on_nonfinite_or_large_errors():
    report = chip_smoke.Report()
    report.error("small", 1e-6, 1e-5)
    report.error("large", 1e-4, 1e-5)
    report.error("nan", float("nan"), 1e-5)
    chip_smoke.check_decreasing(report, "rising", [1.0, 2.0])
    assert len(report.failures) == 3


def test_compile_cache_honours_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    before = jax.config.jax_compilation_cache_dir
    assert runtime.enable_compile_cache(str(tmp_path)) == str(tmp_path / "env")
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_checkout(monkeypatch, tmp_path):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = runtime.enable_compile_cache(str(tmp_path))
        assert path == os.path.join(str(tmp_path), ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_no_module_imports_pallas_tpu():
    root = pathlib.Path(tike_tpu.__file__).parent
    offenders = [
        str(path)
        for path in root.rglob("*.py")
        if re.search(r"pallas\.tpu|pltpu", path.read_text())
    ]
    assert offenders == []

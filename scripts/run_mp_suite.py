#!/usr/bin/env python
"""The 2-process consistency suite: the mpiexec-style CI job.

The reference runs its entire pytest suite under ``mpiexec -n 2``
(`upstream/.github/workflows/unit-tests.yml:143`). Here the
equivalent check launches two real ``jax.distributed`` CPU processes (2
virtual devices each) and runs the reconstruct-consistency matrix through
the PRODUCTION multi-process branches — the DP layout assembled by
``make_global_batch_data`` and the multi-host striped object decomposition
— then asserts both ranks produced identical results.

Usage:
    python scripts/run_mp_suite.py            # run and report
    pytest tests/parallel/test_mp_suite.py -m slow   # same, via pytest
"""

import os
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(port=23995, out_dir=None):
    worker = os.path.join(REPO, "scripts", "_mp_suite_worker.py")
    out_dir = out_dir or tempfile.mkdtemp(prefix="mp_suite_")
    out = os.path.join(out_dir, "mp")
    env = {
        k: v
        for k, v in os.environ.items()
        if k not in ("XLA_FLAGS", "JAX_PLATFORMS")
    }
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(rank), str(port), out],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        )
        for rank in (0, 1)
    ]
    logs = []
    for p in procs:
        stdout, _ = p.communicate(timeout=900)
        logs.append(stdout.decode())
    for p, log in zip(procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"worker failed:\n{log[-6000:]}")
    r0 = np.load(f"{out}.0.npz")
    r1 = np.load(f"{out}.1.npz")
    names = sorted({k.rsplit("_", 1)[0] for k in r0.files})
    for name in names:
        for part in ("psi", "probe", "costs"):
            key = f"{name}_{part}"
            np.testing.assert_allclose(
                r0[key],
                r1[key],
                rtol=1e-5,
                atol=1e-6,
                err_msg=f"rank mismatch in {key}",
            )
    return names


if __name__ == "__main__":
    names = run()
    print(f"2-process consistency suite: {len(names)} scenarios OK")
    for n in names:
        print(f"  {n}")

"""Pytest wrapper for the 2-process consistency suite.

Mirrors the reference CI job that re-runs the test suite under
``mpiexec -n 2`` (`upstream/.github/workflows/unit-tests.yml:143`):
the full reconstruct-consistency matrix (DP and striped, rPIE and LSQML,
OPR and position correction) executes under two real jax.distributed
processes through the production `_enter_multi_host` /
`setup_striped_full` branches; both ranks must agree.

Slow-marked (spawns 4 extra interpreters); `scripts/run_mp_suite.py` is
the standalone CI-style command.
"""

import pytest


@pytest.mark.slow
def test_two_process_consistency_suite():
    import sys, os

    sys.path.insert(
        0,
        os.path.join(
            os.path.dirname(os.path.dirname(os.path.dirname(__file__))),
            "scripts",
        ),
    )
    from run_mp_suite import run

    names = run(port=23997)
    assert len(names) >= 5, names

"""chip_smoke.py --four's phases at tiny sizes on four virtual CPU devices."""

import chip_smoke


def _run(phase, **sizes):
    report = chip_smoke.Report()
    phase(report, **sizes)
    assert report.failures == []


def test_four_data_parallel_tiny():
    _run(chip_smoke.phase_four_data_parallel, n=64, hw=96, det=16,
         num_batch=2, epochs=2)


def test_four_striped_tiny():
    _run(chip_smoke.phase_four_striped, n=64, hw=96, det=16, num_batch=2,
         epochs=2)


def test_four_bucket_tiny():
    _run(chip_smoke.phase_four_bucket, n=16, ntheta=8)

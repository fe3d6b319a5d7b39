"""The comparison's control and its limits at each cell's own size, on the
card (marked `cuda`; each test skips where there is none):

    python -m pytest h100_bench/tests/test_h100_bench_card.py -q

The control, the reference computed with fp8 products in the program's
place, has to come out not correct on every seed; so does the fault of half
a training batch left out; a sound run of the program has to pass.
"""

from __future__ import annotations

import pytest

from h100_bench import calibrate, core

pytestmark = pytest.mark.cuda

CELLS = ["geodesic_bd.train", "geodesic_bd_multires.train", "geodesic_bd.infer",
         "geodesic_bd_multires.infer"]
SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)


def _fails(numbers: dict, limits: dict) -> bool:
    return any(numbers[k] > limits[k] for k in limits)


@pytest.mark.parametrize("workload", CELLS)
def test_control_and_faults_fail_and_the_program_passes(spec, cuda, workload):
    limits = core.cell_files(spec, workload)[3]
    for seed in SEEDS:
        readings = calibrate.control_readings(spec, workload, seed, "cuda")
        for kind in ("control", "half_batch"):
            if kind in readings:
                assert _fails(readings[kind], limits), (kind, seed, readings[kind])
    program, _ = calibrate.program_reading(spec, workload, SEEDS[0], "cuda")
    assert not _fails(program, limits), program

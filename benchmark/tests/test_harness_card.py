"""On the card, at each cell's own size: the control (the reference as
float8 training computes it, in the program's place) and, in a train cell,
half of each batch left out fail one of the cell's numbers on three seeds,
while the program passes on the same seeds. These read what calibrate.py
reads; on the CPU they skip. (The planted faults are also broken into the
timed path by test_harness_run.py.)"""

import pytest

from benchmark import calibrate, spec
from benchmark.tests.conftest import ROOT

CELLS = [w["name"] for w in spec.load_benchmark(ROOT)["workloads"]]
SEEDS = (2 ** 31 + 501, 2 ** 31 + 502, 2 ** 31 + 503)


def _fails(numbers: dict, limits: dict) -> bool:
    return any(numbers[k] > entry["limit"] for k, entry in limits.items())


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_program_passes(cuda, cell):
    c = spec.load_cell(cell)
    for seed in SEEDS:
        got = calibrate.readings(c, seed, True, 3.0, cuda)
        assert not _fails(got["program"], c.limits), (seed, got)
        assert _fails(got["control"], c.limits), (seed, got)
        if "half_batch" in got:
            assert _fails(got["half_batch"], c.limits), (seed, got)

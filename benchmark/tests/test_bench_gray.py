"""tanabata_gray.train's check at bench_small's size on the CPU, held to the
cell's own limits: the gray step (C = 1, the event loss on the gray value
itself) passes, and each planted fault comes out not correct."""

from __future__ import annotations

import pytest

from bench_small import small

from benchmark.calibrate import planted
from benchmark.run import run_cell

CELL = "tanabata_gray.train"


@pytest.mark.parametrize("seed", [3_000_000_019, 2**31 + 7])
@pytest.mark.parametrize("mode,correct", [
    ("sound", True), ("half_batch", False), ("unchanged", False)])
def test_gray_cell_against_its_limits(mode, correct, seed):
    bench, conf, traffic = small(CELL)
    assert conf["config"]["channels"] == 1
    with planted(mode):
        result, checks = run_cell(bench, CELL, seed, 0.0, 0, "cpu",
                                  conf=conf, traffic=traffic)
    assert result["correct"] is correct, checks
    assert result["failed"] == 0 and result["attempted"] > 0

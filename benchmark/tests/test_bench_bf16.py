"""tanabata_bf16.train's check at a small size on the CPU, held to the
cell's own limits: the program in its bf16 mode passes, and the control
below bf16 (benchmark/below_bf16.py) and each planted fault come out not
correct. The MLPs keep the configuration's published width of 256 that
the limits were set at, where bench_small cuts it to 32: a bf16 gap is a
rounding error averaged over a leaf's entries, and over the 1,024 of a
32-wide layer it reads several times higher than over 65,536."""

from __future__ import annotations

import pytest

from bench_small import small

from benchmark import below_bf16
from benchmark.calibrate import planted
from benchmark.run import run_cell

CELL = "tanabata_bf16.train"
SEED = 3_000_000_019


@pytest.mark.parametrize("mode,correct", [
    ("sound", True), ("e4m3", False), ("half_batch", False),
    ("unchanged", False)])
def test_bf16_cell_against_its_limits(mode, correct):
    bench, conf, traffic = small(CELL)
    widths = conf["published_widths"]
    conf["config"].update(netwidth=widths["netwidth"],
                          netwidth_fine=widths["netwidth_fine"])
    if mode == "e4m3":
        result, checks = below_bf16.run(bench, CELL, SEED, "cpu", conf=conf,
                                        traffic=traffic)
    else:
        with planted(mode):
            result, checks = run_cell(bench, CELL, SEED, 0.0, 0, "cpu",
                                      conf=conf, traffic=traffic)
    assert result["correct"] is correct, checks
    assert result["failed"] == 0 and result["attempted"] > 0

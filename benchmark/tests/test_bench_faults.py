"""The check that decides `correct`, driven through a whole run at a small
size on the CPU (the look for a card skipped): the program as it stands
passes, and its control (the program's bfloat16 mode) and each fault the
cell can have, planted underneath the timed path, come out not correct."""

from __future__ import annotations

import pytest

from bench_small import run_small

from benchmark.calibrate import planted

SEED = 3_000_000_019


@pytest.mark.parametrize("cell", ["tanabata.train", "e2nerf_real_lego.train",
                                  "tanabata.render"])
def test_the_program_passes(cell):
    result, checks = run_small(cell, SEED)
    assert result["correct"], checks
    assert result["failed"] == 0 and result["attempted"] > 0


@pytest.mark.parametrize("cell", ["tanabata.train", "e2nerf_real_lego.train",
                                  "tanabata.render"])
def test_the_control_fails(cell):
    result, checks = run_small(cell, SEED, precision="bfloat16")
    assert not result["correct"], checks


@pytest.mark.parametrize("cell,fault", [
    ("tanabata.train", "unchanged"), ("tanabata.train", "half_batch"),
    ("e2nerf_real_lego.train", "unchanged"),
    ("e2nerf_real_lego.train", "half_batch"),
    ("tanabata.render", "altered")])
def test_a_planted_fault_fails(cell, fault):
    with planted(fault):
        result, checks = run_small(cell, SEED)
    assert not result["correct"], checks

"""A training cell on 4 chips, run on 4 gloo processes on the CPU: every
rank drives the sharded step, rank 0 holds it against the reference; with
the exchange between the ranks left out it comes out not correct."""

from __future__ import annotations

import multiprocessing as mp
import socket

import pytest

from bench_small import mesh_rank

WORLD = 4


def _run(fault):
    ctx = mp.get_context("spawn")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out = ctx.Queue()
    procs = [ctx.Process(target=mesh_rank, args=(r, WORLD, port, fault, out))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    result = out.get(timeout=300)
    for p in procs:
        p.join(timeout=60)
        assert p.exitcode == 0
    return result


@pytest.mark.parametrize("fault,correct", [("sound", True),
                                           ("no_exchange", False)])
def test_sharded_step_against_the_reference(fault, correct):
    result, checks = _run(fault)
    assert result["correct"] is correct, checks
    assert result["device"]["count"] == WORLD

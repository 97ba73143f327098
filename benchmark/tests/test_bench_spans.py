"""The readers of the program's spans (benchmark/spans.py and the metrics
spline_span_ms.train, step_self_ms.train, frame_self_ms.render) on the CPU:
None without a card, a program without spans read as nothing, and the
self-time arithmetic on planted span readings."""

from __future__ import annotations

import types

import pytest
import torch

import bench_small  # noqa: F401  (puts the repository on sys.path)

from benchmark import harness, spans

READERS = ("spline_span_ms.train", "step_self_ms.train", "frame_self_ms.render")


def _ctx(device="cpu", **objects):
    return harness.Context(workload="tanabata.train", conf={}, cfg=None,
                           device=torch.device(device), chips=1,
                           objects=dict(objects))


@pytest.mark.parametrize("name", READERS)
def test_a_reader_reads_nothing_on_the_cpu(name):
    ctx = _ctx()
    assert harness.reader(name)(ctx) is None
    assert ctx.objects == {"train_span_ms": None} or ctx.objects == {
        "frame_span_ms": None}


def test_the_readers_subtract_the_children_on_planted_spans():
    train = {"step": [40.0], "step.draws": [0.5], "spline.fwd": [2.0],
             "spline.bwd": [5.0], "mlp.fwd": [3.0, 4.0],
             "mlp.bwd": [10.0, 12.0], "step.adam": [1.0]}
    frame = {"frame": [600.0], "frame.chunk": [300.0, 290.0],
             "mlp.fwd": [100.0, 180.0, 95.0, 175.0]}
    ctx = _ctx("cuda", train_span_ms=train, frame_span_ms=frame)
    assert harness.reader("spline_span_ms.train")(ctx) == 7.0
    assert harness.reader("step_self_ms.train")(ctx) == 40.0 - 7.0 - 7.0 - 22.0
    assert harness.reader("frame_self_ms.render")(ctx) == 600.0 - 550.0
    assert spans.self_ms(train, "frame", ("mlp.fwd",)) is None
    without = _ctx("cuda", train_span_ms={"step": [40.0]})
    assert harness.reader("spline_span_ms.train")(without) is None
    assert harness.reader("step_self_ms.train")(without) == 40.0


def test_the_median_is_taken_span_by_span():
    runs = [{"step": [40.0], "mlp.fwd": [3.0, 5.0]},
            {"step": [42.0], "mlp.fwd": [4.0, 1.0]},
            {"step": [41.0], "mlp.fwd": [9.0, 2.0]}]
    assert spans._median_ms(runs) == {"step": [41.0], "mlp.fwd": [4.0, 2.0]}


def test_a_program_without_spans_is_read_as_nothing():
    def make_multi_step(cfg, H, W, n_inner, mesh=None):
        raise AssertionError("not to be called")

    old = types.SimpleNamespace(make_multi_step=make_multi_step)
    assert not spans._has_spans(old, "make_multi_step", "spans")
    assert not spans._has_spans(types.SimpleNamespace(), "make_multi_step",
                                "spans")
    from benerf_tpu_torch.train import step

    assert spans._has_spans(step, "make_multi_step", "spans")

"""The port's spans (core/profiling.py) on the CPU:

- off (no recording, no profiler), span() is one shared no-op context and
  the backward markers hand their tensors back as they are;
- under recording() host spans nest with the right parents and indices, a
  frame has one frame.chunk span a chunk, and device_ms() is empty (no card);
- the spans and backward markers of the train step leave its loss, every
  gradient and Adam's update bit for bit equal, and make_multi_step with
  spans equals it without;
- the program's span names land in a CPU torch.profiler trace of
  render_image, of a dispatch and of train()'s profile_iter.

The card's side (event pairs inside the captured step) is in
tests/test_torch_cuda.py.
"""

import dataclasses
import json
import math

import pytest
import torch

import test_golden_grad as gg
import test_torch_step as ts

from benerf_tpu_torch.core import config as tconfig
from benerf_tpu_torch.core import profiling
from benerf_tpu_torch.eval import frames as tframes
from benerf_tpu_torch.models import bridge
from benerf_tpu_torch.models import nerf as tnerf
from benerf_tpu_torch.render import renderer as trenderer
from benerf_tpu_torch.train import loop as tloop
from benerf_tpu_torch.train import step as tstep

# the step body's spans, in the order they open (one step, no mesh)
STEP_SPANS = ["step", "step.draws", "step.window", "spline.fwd", "render.fwd",
              "mlp.fwd", "mlp.fwd", "step.losses", "step.backward",
              "spline.bwd", "step.adam"]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The tensors here are tiny: one intra-op thread, so that six test
    workers sharing the CPU do not oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(case="synthetic_gray", **kw):
    return tconfig.Config(**{**dataclasses.asdict(gg.build_cfg(case)),
                             "optimize_nerf": True, "optimize_pose": True,
                             "optimize_trans": True,
                             "netwidth": 32, "netwidth_fine": 32, **kw})


def _batch(cfg):
    return tloop.make_batch(ts._tiny_scene(cfg.channels), cfg,
                            *tloop.intrinsics(cfg)[:2], "cpu")


def _frame_inputs():
    g = torch.Generator().manual_seed(0)
    params = {k: tnerf.init_params(g, depth=2, width=16, channels=3)
              for k in ("nerf", "nerf_fine")}
    settings = trenderer.RenderSettings(n_samples=4, n_importance=4)
    K = [[6.0, 0, 3.5], [0, 6.0, 2.5], [0, 0, 1]]
    pose = [[1.0, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0]]
    return params, pose, K, settings


def _names(prof):
    return {e.name for e in prof.events()}


def test_span_is_one_shared_no_op_when_off():
    assert profiling._current is None
    a, b = profiling.span("a"), profiling.span("b", index=3)
    assert a is b is profiling._NULL
    x, y = torch.zeros(2, requires_grad=True), torch.ones(3)
    marks = profiling.backward_span("region.bwd")
    assert marks.inputs(x, y) == (x, y) and marks.outputs(x)[0] is x
    with a as got:
        assert got is None


def test_recording_nests_host_spans_with_parents_and_indices():
    with profiling.recording("cpu") as rec:
        with profiling.span("outer", index=7):
            with profiling.span("inner"):
                pass
            with profiling.recording(enabled=False) as off:
                with profiling.span("suspended"):
                    pass
            with profiling.span("inner", index=(7, 1)):
                pass
        with profiling.span("after"):
            pass
    assert off is None and profiling._current is None
    assert [(r.name, r.parent, r.index) for r in rec.spans] == [
        ("outer", None, 7), ("inner", "outer", None),
        ("inner", "outer", (7, 1)), ("after", None, None)]
    host = rec.host_ms()
    assert list(host) == ["outer", "inner", "after"]
    assert len(host["inner"]) == 2 and all(v >= 0 for v in host["inner"])
    assert host["outer"][0] >= sum(host["inner"])
    assert rec.device_ms() == {}
    assert profiling.summed({"a": [1.0, 2.0]}) == {"a": 3.0}


@pytest.mark.parametrize("H,W,chunk", [(5, 7, 8), (4, 4, 16), (3, 5, 4)])
def test_a_frame_has_one_chunk_span_a_chunk(H, W, chunk):
    params, pose, K, settings = _frame_inputs()
    with profiling.recording("cpu") as rec:
        tframes.render_image(params, pose, K, H, W, settings, chunk=chunk,
                             key=(4, 2), device="cpu")
    n = math.ceil(H * W / chunk)
    chunks = [r for r in rec.spans if r.name == "frame.chunk"]
    assert [r.index for r in chunks] == [(4, 2, i) for i in range(n)]
    assert all(r.parent == "frame" for r in chunks)
    parents = {(r.name, r.parent) for r in rec.spans}
    assert parents == {("frame", None), ("frame.chunk", "frame"),
                       ("frame.draws", "frame.chunk"),
                       ("render.fwd", "frame.chunk"), ("mlp.fwd", "render.fwd"),
                       ("frame.to_host", "frame")}
    host = rec.host_ms()
    assert len(host["mlp.fwd"]) == 2 * n and len(host["frame"]) == 1
    assert rec.spans[0].index == (4, 2)
    assert rec.device_ms() == {}


def _params_grads(state):
    return [t.detach().clone() for t in bridge.tree_leaves(state.params)], [
        None if t.grad is None else t.grad.clone()
        for t in bridge.tree_leaves(state.params)]


@pytest.mark.parametrize("case,kw", [
    ("synthetic_gray", {}),
    ("crf_gray", dict(optimize_rgb_crf=True, optimize_event_crf=True,
                      log_knot_grad_terms=True)),
    ("real_color", dict(use_barf_c2f=True, barf_c2f_start=0.0, max_iter=8)),
], ids=["plain", "crf_knot_terms", "barf"])
def test_markers_leave_loss_and_gradients_bit_equal(case, kw):
    """Two steps of make_train_step with recording on against off, from
    equal states: every metric, every gradient and every parameter after
    Adam bit for bit; the spans of each step as the body opens them."""
    cfg = _cfg(case, **kw)
    batch = _batch(cfg)
    step_fn = tstep.make_train_step(cfg, ts.H_RGB, ts.W_RGB)
    off = tstep.init_state(cfg, cfg.seed, device="cpu")
    on = tstep.init_state(cfg, cfg.seed, device="cpu")
    for step in range(2):
        off, m_off = step_fn(off, batch, cfg.seed)
        with profiling.recording("cpu") as rec:
            on, m_on = step_fn(on, batch, cfg.seed)
        assert list(m_on) == list(m_off)
        for k in m_off:
            assert torch.equal(m_on[k], m_off[k]), k
        (p_on, g_on), (p_off, g_off) = _params_grads(on), _params_grads(off)
        for a, b in zip(p_on + g_on, p_off + g_off):
            assert (a is None and b is None) or torch.equal(a, b)
        names = [r.name for r in rec.spans]
        want = list(STEP_SPANS)
        if cfg.log_knot_grad_terms:  # one more backward a term
            i = want.index("spline.bwd")
            want[i:i] = ["spline.bwd"] * 2
        assert names == want
        parents = {r.name: r.parent for r in rec.spans}
        assert parents["spline.bwd"] == "step.backward"
        assert parents["mlp.fwd"] == "render.fwd"
        assert {parents[n] for n in want[1:] if n not in (
            "mlp.fwd", "spline.bwd")} == {"step"}
        assert rec.spans[0].index == step
        assert not rec.open and rec.device_ms() == {}


def test_multi_step_with_spans_equals_without():
    """make_multi_step(spans=True) on the CPU: two dispatches of 3 equal
    spans=False bit for bit; span_ms() is empty off the card and the last
    step's host spans are kept, the metrics row among them."""
    cfg = _cfg("crf_gray", pose_lrate_warmup=2, optimize_rgb_crf=True)
    batch = _batch(cfg)
    plain = tstep.make_multi_step(cfg, ts.H_RGB, ts.W_RGB, 3)
    spanned = tstep.make_multi_step(cfg, ts.H_RGB, ts.W_RGB, 3, spans=True)
    a = tstep.init_state(cfg, cfg.seed, device="cpu")
    b = tstep.init_state(cfg, cfg.seed, device="cpu")
    for _ in range(2):
        a, ma = plain(a, batch, cfg.seed)
        b, mb = spanned(b, batch, cfg.seed)
        for k in ma:
            assert torch.equal(ma[k], mb[k]), k
    for x, y in zip(bridge.tree_leaves(a.params), bridge.tree_leaves(b.params)):
        assert torch.equal(x, y)
    assert plain.records is None and plain.span_ms() == {}
    assert spanned.span_ms() == {}
    names = [r.name for r in spanned.records.spans]
    assert names == STEP_SPANS + ["step.row"]
    assert spanned.records.spans[0].index == 5


def test_span_names_land_in_a_cpu_profiler_trace():
    """render_image and a dispatch under torch.profiler (CPU activity): the
    program's spans are record_function ranges of the trace."""
    from torch.profiler import ProfilerActivity, profile

    params, pose, K, settings = _frame_inputs()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tframes.render_image(params, pose, K, 4, 5, settings, chunk=8,
                             device="cpu")
    names = _names(prof)
    assert {"frame", "frame.chunk", "frame.draws", "render.fwd", "mlp.fwd",
            "frame.to_host"} <= names
    assert sum(e.name == "frame.chunk" for e in prof.events()) == 3

    cfg = _cfg()
    batch = _batch(cfg)
    multi = tstep.make_multi_step(cfg, ts.H_RGB, ts.W_RGB, 2)
    state = tstep.init_state(cfg, cfg.seed, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state, m = multi(state, batch, cfg.seed)
        tstep.metrics_to_host(m)
    names = _names(prof)
    assert set(STEP_SPANS) - {"spline.bwd"} <= names
    assert {"step.row", "dispatch.prepare", "dispatch.read"} <= names
    assert "spline.bwd" not in names  # a marker records only under recording()


def test_profile_iter_builds_the_dispatch_with_spans(tmp_path, monkeypatch):
    """profile_iter > 0: train() builds its dispatch with spans=True and its
    Chrome trace holds the step's spans; profile_iter 0 builds it without."""
    made = []
    real = tstep.make_multi_step
    monkeypatch.setattr(tstep, "make_multi_step",
                        lambda *a, **k: made.append(k) or real(*a, **k))
    trace_dir = tmp_path / "trace"
    tloop.train(ts._tiny_train_cfg(tmp_path / "on", max_iter=4,
                                   console_log_iter=2, profile_iter=3,
                                   profile_dir=str(trace_dir)),
                ts._tiny_scene(), device="cpu")
    tloop.train(ts._tiny_train_cfg(tmp_path / "off", max_iter=2,
                                   console_log_iter=2),
                ts._tiny_scene(), device="cpu")
    assert [k["spans"] for k in made] == [True, False]
    trace = json.loads((trace_dir / "trace_iter000003.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"step", "step.backward", "render.fwd", "mlp.fwd",
            "dispatch.read"} <= names

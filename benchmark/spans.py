"""Layer readings from the program's own spans (benerf_tpu_torch/core/
profiling.py): the device ms of each span, timed by the event pairs that
the program records at its layer boundaries, inside the captured step too.

`train_span_ms(ctx)` builds a dispatch object of DISPATCH steps with spans
on (train/step.py make_multi_step(..., spans=True): the window's step, its
code, shapes and state, with the spans' event-record nodes in its graph),
runs one dispatch (the capture), then READS more, each followed by the host
read, and gives the median over those of each span's ms in the dispatch's
last replay. `frame_span_ms(ctx)` renders one frame (eval/frames.py
render_image, identity pose: a frame's work does not depend on its pose)
inside profiling.recording(). Each is computed once a run (cached on
ctx.objects) and is None off the card, under a mesh (the readers run on
rank 0 alone, and a dispatch of one rank would wait for the others), or
where the program has no spans.

`self_ms(ms, name, children)`: a span's ms less its named children's, each
name's spans summed.
"""

from __future__ import annotations

import inspect
import statistics

import torch

DISPATCH = 10
READS = 3
SEED = 0


def _summed(ms: dict) -> dict:
    return {k: sum(v) for k, v in ms.items()}


def self_ms(ms: dict, name: str, children) -> float:
    """ms[name] less every span named in children (each name's spans
    summed); None where ms holds no span `name`."""
    tot = _summed(ms)
    if name not in tot:
        return None
    return tot[name] - sum(tot.get(c, 0.0) for c in children)


def _median_ms(runs: list) -> dict:
    """{name: [median over runs of its k-th span]} of device_ms() dicts."""
    out = {}
    for name in runs[0]:
        cols = zip(*(r.get(name, []) for r in runs))
        out[name] = [statistics.median(c) for c in cols]
    return out


def _has_spans(module, fn_name: str, param: str) -> bool:
    fn = getattr(module, fn_name, None)
    return fn is not None and param in inspect.signature(fn).parameters


def _cached(ctx, key, compute):
    if key not in ctx.objects:
        ctx.objects[key] = (None if ctx.device.type != "cuda"
                            else compute(ctx))
    return ctx.objects[key]


def _train(ctx):
    from benerf_tpu_torch.train import step as step_mod

    o = ctx.objects
    if o.get("mesh") is not None or not _has_spans(
            step_mod, "make_multi_step", "spans"):
        return None
    multi = step_mod.make_multi_step(ctx.cfg, o["scene"]["H"], o["scene"]["W"],
                                     DISPATCH, None, spans=True)
    state, batch, runs = o["state"], o["batch"], []
    for i in range(READS + 1):
        state, metrics = multi(state, batch, SEED)
        step_mod.metrics_to_host(metrics)
        if i:
            runs.append(multi.span_ms())
    del multi
    torch.cuda.empty_cache()
    return _median_ms(runs) if runs[0] else None


def _render(ctx):
    from benerf_tpu_torch.core import profiling
    from benerf_tpu_torch.eval import frames

    if not hasattr(profiling, "recording"):
        return None
    o, c = ctx.objects, ctx.cfg
    K = [[c.rgb_fx, 0, c.rgb_cx], [0, c.rgb_fy, c.rgb_cy], [0, 0, 1]]
    pose = [[1.0, 0, 0, 0], [0, 1.0, 0, 0], [0, 0, 1.0, 0]]
    with profiling.recording(ctx.device) as rec:
        frames.render_image(o["params"], pose, K, o["H"], o["W"], o["settings"],
                            chunk=o["chunk"], key=(SEED,), device=ctx.device)
    torch.cuda.synchronize(ctx.device)
    return rec.device_ms() or None


def train_span_ms(ctx):
    """{span: [device ms]} of one captured step (see the module), or None."""
    return _cached(ctx, "train_span_ms", _train)


def frame_span_ms(ctx):
    """{span: [device ms]} of one frame (see the module), or None."""
    return _cached(ctx, "frame_span_ms", _render)

"""Training cells: the port's train step as `train()` runs it, in
dispatches of `steps_per_dispatch` steps through
train/step.py make_multi_step (on the card one CUDA graph of the step,
captured once and replayed), one host read of the metrics a dispatch.

Set-up builds the one dispatch object and the state (the benchmark's
scene and weights from the seed), and drives it through the first three
steps, one dispatch each: step 1 (the eager step that precedes the
capture), then steps 2 and 3, each one replay of the captured graph, so
Adam's state after step 1, step 2's gradients and the weights after
steps 1 and 3 can be read; then WARMUP_DISPATCHES whole dispatches (the
card's first seconds of steady load run ~5% slower). The window then runs whole
dispatches of the same object until `seconds` have passed; `iter_ms` is
the window over its steps.

Once the window has closed and the program's state is freed, the plain
float64 reference follows the same three steps from the same weights,
scene and seed, and step 2 again from the program's weights after step
1, and the check compares:
  loss_gap    the largest relative gap of a step's loss;
  grad_gap    the first gradient as Adam received it (its first moment
              after step 1 / (1 - beta1)): the largest gap between the
              program's and the reference's norms of a leaf, over the
              larger of that leaf's reference norm and the median leaf's;
  grad_median_gap  the median over the leaves of that gap: steady from
              seed to seed, where the largest swings with the rare ray whose
              render sits at a jump of the method (reference/render.py);
  replay_grad_median_gap  the same median for step 2's gradients, the
              first that a replay of the captured graph computes (the
              leaves' .grad after it), against the reference's step 2
              from the same weights: steady where a free-running step 2
              is not, since Adam's first update spreads step 1's gaps;
  change_gap  the largest gap of each leaf's change over the three steps,
              over the leaves whose reference gradient is at least 1e-3 of
              the median leaf's (the others move by round-off alone).
"""

from __future__ import annotations

import dataclasses
import math
import sys
import time

import torch

from benchmark import harness, inputs, tracing
from benchmark.reference import train as ref_train

CHECKED_STEPS = 3
BETA1 = 0.9
MOVED = 1e-3  # a leaf moves when its gradient is >= this x the median's
WARMUP_DISPATCHES = 2


def first_steps(multi, state, batch, seed, n_full):
    """Steps 1 to 3 through the window's dispatch object, one dispatch
    each -> (state, [losses of steps 1-3], {name: tensor} readings: Adam's
    first moments after step 1, the gradients of step 2 as Adam got them,
    the leaves after steps 1 and 3). The dispatch sizes its metric buffer
    at its first step from its step count, which the window needs at
    n_full; that first dispatch stops after its eager step."""
    body, calls = multi.body, []

    def sized(*args):
        out = body(*args)
        calls.append(1)
        multi.n_inner = n_full if len(calls) == 1 else 1
        return out

    multi.body, multi.n_inner = sized, 1
    paths = {id(t): p for p, t in ref_train.leaves(state.params)}
    losses, read = [], {}
    try:
        for step in range(1, CHECKED_STEPS + 1):
            state, m = multi(state, batch, seed)
            if state.step != step:
                raise RuntimeError(f"dispatch {step} ended at step {state.step}")
            multi.body, multi.n_inner = body, 1
            losses.append(float(m["loss"][0]))
            opt = state.optimizer.state
            if step == 1:
                read["m1"] = {paths[id(p)]: st["exp_avg"].detach().clone()
                              for p, st in opt.items()}
            if step == 2:  # .grad: what the replay's backward left for Adam
                read["g2"] = {paths[id(p)]: p.grad.detach().clone()
                              for p in opt if p.grad is not None}
            if step in (1, CHECKED_STEPS):
                read[f"p{step}"] = {p: t.detach().clone()
                                    for p, t in ref_train.leaves(state.params)}
    finally:
        multi.body, multi.n_inner = body, n_full
    return state, losses, read


def _gaps(prog, ref, names):
    """Per leaf |norm(prog) - norm(ref)| / max(norm(ref), the median
    leaf's norm), in the order of names."""
    norms = {k: float(torch.linalg.norm(ref[k])) for k in names}
    med = sorted(norms.values())[len(norms) // 2]
    return [abs(float(torch.linalg.norm(prog[k].double())) - norms[k])
            / max(norms[k], med, 1e-300) for k in names]


def _median_gap(prog, ref):
    return sorted(_gaps(prog, ref, sorted(ref)))[len(ref) // 2]


def _on_leaves(got, ref, scale=1.0):
    """got's tensors in float64 x scale on ref's leaves; zero on a leaf
    that got lacks (no Adam state or no .grad: it received no gradient)."""
    return {k: got[k].double() * scale if k in got else torch.zeros_like(g)
            for k, g in ref.items()}


def check_numbers(c, p0, shape, scene, seed, losses, read):
    """The numbers, from the reference's three steps from the leaves p0
    ({path: tensor}) of a tree shaped like `shape`, and its step 2 from
    the program's leaves after step 1 (first_steps' readings)."""
    params = ref_train.rebuild(shape, {k: v.double() for k, v in p0.items()})
    sc = dict(scene, image=scene["image"].double(),
              rgb_exp_ts=scene["rgb_exp_ts"].double(),
              K_rgb=scene["K_rgb"].double(), K_evt=scene["K_evt"].double())
    ref_losses, ref_grads, ref_after = ref_train.run_steps(
        c, params, sc, seed, CHECKED_STEPS)
    at_p1 = ref_train.rebuild(shape, {
        k: v.double().requires_grad_(True) for k, v in read["p1"].items()})
    _, ref_g2 = ref_train.gradient(c, at_p1, sc, seed, 1,
                                   ref_train.trained_paths(c, at_p1))
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    g1 = _on_leaves(read["m1"], ref_grads[0], 1 / (1 - BETA1))
    g2 = _on_leaves(read["g2"], ref_g2)
    grad_gaps = sorted(_gaps(g1, ref_grads[0], sorted(g1)))
    gnorm = {k: float(torch.linalg.norm(g)) for k, g in ref_grads[0].items()}
    med = sorted(gnorm.values())[len(gnorm) // 2]
    moved = [k for k in sorted(gnorm) if gnorm[k] >= MOVED * med]
    change = {k: read["p3"][k].double() - p0[k].double() for k in moved}
    ref_change = {k: ref_after[k] - p0[k].double() for k in moved}
    return {"loss_gap": loss_gap, "grad_gap": grad_gaps[-1],
            "grad_median_gap": grad_gaps[len(grad_gaps) // 2],
            "replay_grad_median_gap": _median_gap(g2, ref_g2),
            "change_gap": max(_gaps(change, ref_change, moved))}


def run(o):
    """One run of a training cell -> (result fields, checks), or (None,
    None) on a rank other than 0."""
    from benerf_tpu_torch.core.config import Config
    from benerf_tpu_torch.data import events as events_mod
    from benerf_tpu_torch.parallel import mesh as mesh_mod
    from benerf_tpu_torch.train import step as step_mod

    dev, mesh = o.device, o.mesh
    lead = mesh is None or mesh.rank == 0
    c = dict(o.conf["config"], compute_dtype=o.precision)
    cfg = Config(**c)
    scene = inputs.scene(o.conf, o.seed, dev)
    pix, ts, pol = scene["events"]
    cfg = dataclasses.replace(cfg, event_window_cap=events_mod.window_cap(
        ts.cpu().numpy(), cfg.accumulate_time_length))
    batch = step_mod.SceneBatch(
        events=events_mod.EventArrays(pix, ts, pol), image_flat=scene["image"],
        rgb_exp_ts=scene["rgb_exp_ts"], K_rgb=scene["K_rgb"],
        K_evt=scene["K_evt"])
    params = inputs.weights(c, o.seed, dev)
    p0 = {k: v.detach().clone() for k, v in ref_train.leaves(params)}
    for _, t in ref_train.leaves(params):
        t.requires_grad_(True)
    state = step_mod.init_state(cfg, params=params)
    mesh_mod.replicate_tree(state.params, mesh)
    n_inner = o.traffic["steps_per_dispatch"]
    multi = step_mod.make_multi_step(cfg, scene["H"], scene["W"], n_inner, mesh)
    state, losses, read = first_steps(multi, state, batch, o.seed, n_inner)
    for _ in range(WARMUP_DISPATCHES):
        state, metrics = multi(state, batch, o.seed)
        step_mod.metrics_to_host(metrics)

    # the window: whole dispatches until `seconds` have passed
    o.sync()
    setup_s = time.time() - o.t_start
    steps, bad, ends = 0, 0, []
    t0 = time.perf_counter()
    while True:
        state, metrics = multi(state, batch, o.seed)
        host = step_mod.metrics_to_host(metrics)
        steps += n_inner
        bad += int(sum(not math.isfinite(v) for v in host["loss"]))
        ends.append(time.perf_counter() - t0)
        if o.agree(ends[-1] >= o.seconds):
            break
    window = time.perf_counter() - t0
    print("dispatch ends (s): " + " ".join(f"{e:.4f}" for e in ends),
          file=sys.stderr)
    iter_ms = window / steps * 1e3
    peak = o.max_over_ranks(torch.cuda.max_memory_allocated(dev)
                            if dev.type == "cuda" else 0)

    e2e = {"setup_s": setup_s, "iter_ms": iter_ms}
    per_layer, trace = {}, None
    if o.trace:
        box = [state]

        def dispatch():
            box[0], m = multi(box[0], batch, o.seed)
            step_mod.metrics_to_host(m)

        _, prof = tracing.profiled(dispatch, dev)
        state = box[0]
        trace = {"busy_s": o.mean_over_ranks(prof.busy_s),
                 "window_s": o.mean_over_ranks(prof.wall_s)}
        if lead:
            ctx = harness.Context(
                workload=o.name, conf=o.conf, cfg=cfg, device=dev,
                chips=o.chips, e2e=e2e, profile=prof, steps=n_inner,
                objects=dict(state=state, batch=batch, scene=scene, mesh=mesh))
            per_layer = o.read_metrics(ctx)
            trace["breakdown"] = prof.breakdown()
    shape = ref_train.rebuild(params, {k: None for k in p0})
    del multi, state, batch, params
    o.free()
    if not lead:
        return None, None
    numbers = check_numbers(c, p0, shape, scene, o.seed, losses, read)
    return dict(e2e=e2e, per_layer=per_layer, trace=trace, peak=peak,
                attempted=steps, failed=bad), numbers

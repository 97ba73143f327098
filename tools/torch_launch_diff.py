#!/usr/bin/env python3
"""Device launches a train step, kernel by kernel, of two benchmark
configurations, and where they differ (one card).

    python3 tools/torch_launch_diff.py tanabata tanabata_gray \\
        [--steps 10] [--seed N] [--json_out FILE]

For each configuration (`benchmark/configs/<name>.json`) it builds the
benchmark's scene and weights from the seed, runs one dispatch of
`--steps` steps through train/step.py make_multi_step (the capture), then
traces a second dispatch with benchmark/tracing.py, as a `--trace 1` run
does: each kernel's launches a step as that reader counts them, and what
the MLP's launch and route counters (ops/mlp.py COUNTERS) gained. Then it
profiles one eager step (make_train_step, the same work) and counts every
device kernel by name and by the host operation that launched it. Prints
the launches a step of each, the counters and the GEMM kernels of the
traced dispatch, then every kernel or host operation whose count differs.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark import harness, inputs, tracing  # noqa: E402
from benchmark.reference import train as ref_train  # noqa: E402


def launches(name, steps, seed, device):
    """({kernel name: launches a step}, {host operation: launches of one
    eager step}, {kernel name: launches of that step}, [launches, routes]
    gained over the traced dispatch) of configuration `name`."""
    from benerf_tpu_torch.core.config import Config
    from benerf_tpu_torch.data import events as events_mod
    from benerf_tpu_torch.ops import mlp as mlp_ops
    from benerf_tpu_torch.train import step as step_mod

    conf = harness.load_json(ROOT / "benchmark" / "configs" / f"{name}.json")
    c = dict(conf["config"], compute_dtype=conf["precision"])
    scene = inputs.scene(conf, seed, device)
    pix, ts, pol = scene["events"]
    cfg = Config(**c)
    cfg = dataclasses.replace(cfg, event_window_cap=events_mod.window_cap(
        ts.cpu().numpy(), cfg.accumulate_time_length))
    batch = step_mod.SceneBatch(
        events=events_mod.EventArrays(pix, ts, pol), image_flat=scene["image"],
        rgb_exp_ts=scene["rgb_exp_ts"], K_rgb=scene["K_rgb"], K_evt=scene["K_evt"])
    params = inputs.weights(c, seed, device)
    for _, t in ref_train.leaves(params):
        t.requires_grad_(True)
    state = step_mod.init_state(cfg, params=params)
    multi = step_mod.make_multi_step(cfg, scene["H"], scene["W"], steps)
    state, m = multi(state, batch, seed)
    step_mod.metrics_to_host(m)
    box = [state]

    def dispatch():
        box[0], m = multi(box[0], batch, seed)
        step_mod.metrics_to_host(m)

    before = mlp_ops.counts()
    _, prof = tracing.profiled(dispatch, device)
    counters = mlp_ops.counts_since(before)
    by_kernel = {n: k / steps for n, k, _ in prof.kernels}

    from torch.profiler import ProfilerActivity, profile

    one = step_mod.make_train_step(cfg, scene["H"], scene["W"])
    state, _ = one(box[0], batch, seed)
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        one(state, batch, seed)
        torch.cuda.synchronize(device)
    by_op, eager = defaultdict(int), defaultdict(int)
    for e in p.events():
        if e.device_type == torch.autograd.DeviceType.CPU and e.kernels:
            by_op[e.name] += len(e.kernels)
        elif (e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)):
            eager[e.name] += 1
    return by_kernel, dict(by_op), dict(eager), counters


def _differ(a, b):
    return {k: [a.get(k, 0.0), b.get(k, 0.0)] for k in sorted(set(a) | set(b))
            if a.get(k, 0.0) != b.get(k, 0.0)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("configs", nargs=2)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--seed", type=int, default=2_424_000_001)
    p.add_argument("--json_out", default=None)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_launch_diff: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    (k0, o0, e0, c0), (k1, o1, e1, c1) = [launches(n, a.steps, a.seed, device)
                                          for n in a.configs]
    out = {"configs": a.configs, "steps": a.steps, "seed": a.seed,
           "counters": [c0, c1], "kernels": [k0, k1], "eager_kernels": [e0, e1],
           "gemm": [{n: k for n, k in kc.items() if "gemm" in n.lower()}
                    for kc in (k0, k1)],
           "launches_per_step": [sum(k0.values()), sum(k1.values())],
           "eager_step_launches": [sum(o0.values()), sum(o1.values())],
           "differ": _differ(k0, k1), "differ_by_op": _differ(o0, o1),
           "differ_eager": _differ(e0, e1)}
    print(f"{a.configs[0]} -> {a.configs[1]}: launches a step "
          f"{out['launches_per_step']}, an eager step {out['eager_step_launches']}")
    for n, c, g in zip(a.configs, out["counters"], out["gemm"]):
        print(f"{n}: counters over the traced dispatch {c}; GEMM kernels {g}")
    for what in ("differ", "differ_by_op", "differ_eager"):
        print(what)
        for k, (x, y) in sorted(out[what].items(), key=lambda kv: kv[1][1] - kv[1][0]):
            print(f"  {y - x:+7.2f}  {x:7.2f} -> {y:7.2f}  {k[:150]}")
    if a.json_out:
        Path(a.json_out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

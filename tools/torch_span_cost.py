#!/usr/bin/env python3
"""What the program's spans (benerf_tpu_torch/core/profiling.py) cost on
the card when they are on.

    python3 tools/torch_span_cost.py [--config tanabata] [--rounds 4]
                                     [--seed 0] [--out FILE.json]

On one benchmark configuration (benchmark/configs/<config>.json: its scene
and weights from the seed, as a benchmark cell makes them) it times, in
turns (off, on, on, off) within one process:
  - train: dispatches of 100 steps of make_multi_step without spans and of
    one built with spans=True (their event nodes in the graph), each
    followed by the host read; iter_ms = a dispatch's wall time / 100;
  - render: full frames of eval/frames.py render_image (chunks of 4,096
    rays, identity pose) without and inside profiling.recording(), the
    latter with its device_ms() read; frame_ms = a frame's wall time.
Then, for the spread of the span readings, it reads the spline's spans
(spline.fwd + spline.bwd) and `step` of the last step of READS dispatches
of 1, 10 and 100 steps each, and of 10 again after one dispatch under
torch.profiler (as a benchmark's traced run reads them).
Prints one JSON line: each side's per-round readings and medians, the
on / off ratios, the card's nvidia-smi name and power limit, the device
ms of each span of the last spanned step and frame, and those readings.
Needs one card; imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

from benchmark import harness, inputs  # noqa: E402
from benerf_tpu_torch.core import profiling  # noqa: E402
from benerf_tpu_torch.core.config import Config  # noqa: E402
from benerf_tpu_torch.data import events as events_mod  # noqa: E402
from benerf_tpu_torch.eval import frames  # noqa: E402
from benerf_tpu_torch.models.bridge import tree_leaves  # noqa: E402
from benerf_tpu_torch.render import renderer  # noqa: E402
from benerf_tpu_torch.train import step as step_mod  # noqa: E402

STEPS = 100
CHUNK = 4096
READS = 5
ORDER = (False, True, True, False)


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def _timed(fn, dev) -> float:
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize(dev)
    return time.perf_counter() - t0


def _summary(times: dict, scale: float) -> dict:
    med = {k: statistics.median(v) * scale for k, v in times.items()}
    return {"off": [t * scale for t in times[False]],
            "on": [t * scale for t in times[True]],
            "median_off": med[False], "median_on": med[True],
            "ratio_on_off": med[True] / med[False]}


def train_cost(conf, seed, rounds, dev) -> dict:
    c = dict(conf["config"], compute_dtype=conf["precision"])
    cfg = Config(**c)
    scene = inputs.scene(conf, seed, dev)
    pix, ts, pol = scene["events"]
    cfg = dataclasses.replace(cfg, event_window_cap=events_mod.window_cap(
        ts.cpu().numpy(), cfg.accumulate_time_length))
    batch = step_mod.SceneBatch(
        events=events_mod.EventArrays(pix, ts, pol), image_flat=scene["image"],
        rgb_exp_ts=scene["rgb_exp_ts"], K_rgb=scene["K_rgb"],
        K_evt=scene["K_evt"])
    params = inputs.weights(c, seed, dev)
    for t in tree_leaves(params):
        t.requires_grad_(True)
    box = [step_mod.init_state(cfg, params=params)]
    kinds = ((False, STEPS), (True, STEPS), (True, 10), (True, 1))
    multi = {(on, n): step_mod.make_multi_step(cfg, scene["H"], scene["W"], n,
                                               spans=on) for on, n in kinds}

    def dispatch(on, n=STEPS):
        box[0], m = multi[on, n](box[0], batch, seed)
        step_mod.metrics_to_host(m)

    def spline_reads(n):
        out = []
        for _ in range(READS):
            dispatch(True, n)
            ms = profiling.summed(multi[True, n].span_ms())
            out.append([ms["spline.fwd"] + ms["spline.bwd"], ms["step"]])
        return out

    for on in (False, True, False, True):  # the captures, then warm
        dispatch(on)
    times = {False: [], True: []}
    for _ in range(rounds):
        for on in ORDER:
            times[on].append(_timed(lambda: dispatch(on), dev))
    out = _summary(times, 1e3 / STEPS)
    out["span_ms"] = profiling.summed(multi[True, STEPS].span_ms())
    out["spline_step_ms"] = {n: spline_reads(n) for n in (1, 10, STEPS)}
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        dispatch(False)
    out["spline_step_ms"]["10_after_profiler"] = spline_reads(10)
    return out


def render_cost(conf, seed, rounds, dev) -> dict:
    c = dict(conf["config"], compute_dtype=conf["precision"])
    cfg = Config(**c)
    params = inputs.weights(c, seed, dev)
    net = {"nerf": params["nerf"], "nerf_fine": params["nerf_fine"]}
    settings = renderer.RenderSettings.from_config(cfg)
    K = [[cfg.rgb_fx, 0, cfg.rgb_cx], [0, cfg.rgb_fy, cfg.rgb_cy], [0, 0, 1]]
    pose = [[1.0, 0, 0, 0], [0, 1.0, 0, 0], [0, 0, 1.0, 0]]
    last = {}

    H, W = int(cfg.rgb_height), int(cfg.rgb_width)

    def frame(on):
        def run():
            return frames.render_image(net, pose, K, H, W, settings,
                                       chunk=CHUNK, key=(seed,), device=dev)
        if not on:
            run()
            return
        with profiling.recording(dev) as rec:
            run()
        torch.cuda.synchronize(dev)
        last["span_ms"] = profiling.summed(rec.device_ms())

    frame(False)
    frame(True)
    times = {False: [], True: []}
    for _ in range(rounds):
        for on in ORDER:
            times[on].append(_timed(lambda: frame(on), dev))
    out = _summary(times, 1e3)
    out["span_ms"] = {k: v for k, v in last["span_ms"].items()
                      if k != "frame.chunk"}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default="tanabata")
    p.add_argument("--rounds", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_span_cost: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    conf = harness.load_json(harness.config_file(harness.spec(), a.config))
    line = {"config": a.config, "card": _card(),
            "train": train_cost(conf, a.seed, a.rounds, dev)}
    torch.cuda.empty_cache()
    line["render"] = render_cost(conf, a.seed, a.rounds, dev)
    text = json.dumps(line)
    if a.out:
        Path(a.out).write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())

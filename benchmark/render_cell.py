"""Render cells: full frames as `cli.test` renders them, through
eval/frames.py render_trajectory (chunks of `chunk` rays, forward only,
the random-mode draws of each chunk seeded from (key, frame, chunk)), over
the `poses` poses of cli.test's trajectory along the spline (the knots
plus the transform over [0, 1]), the trajectory repeated until `seconds`
have passed. Set-up renders one frame to warm up every shape (the full
chunk and the last, shorter one). `frame_ms` is the window over its
frames.

The check: once the window has closed and the program's state is freed,
`check_chunks` chunks drawn from the seed among the frames rendered (the
last, shorter chunk of a frame among them) are rendered again by the plain
float64 reference from the same weights and draws. `rgb_gap` is the
largest absolute gap of a colour channel over their pixels, leaving out
the rays that the reference finds at a jump of the method, where a
rounding changes the colour by a step (reference/render.py: a fine depth
at the inverse CDF's rule for near-empty bins, a last sample whose sigma +
noise is within 1e-3 of 0); their count is printed beside it. The
reference alone picks them, so the program cannot move the count.
"""

from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch

from benchmark import harness, inputs, tracing
from benchmark.reference import draws as draws_mod
from benchmark.reference import geometry
from benchmark.reference import render as ref_render
from benchmark.reference import train as ref_train


def check_numbers(c, params, frames, seed, n_check, chunk, n_poses, device):
    """rgb_gap over n_check chunks drawn from the seed among `frames`
    [(key, frame index, rgb (H, W, C))] of a trajectory of n_poses."""
    H, W = int(c["rgb_height"]), int(c["rgb_width"])
    n_chunks = -(-H * W // chunk)
    rng = np.random.default_rng(seed)
    picks = {(int(rng.integers(len(frames))), n_chunks - 1)}
    while len(picks) < min(n_check, len(frames) * n_chunks):
        picks.add((int(rng.integers(len(frames))), int(rng.integers(n_chunks))))
    p = ref_train.rebuild(params, {k: v.detach().double()
                                   for k, v in ref_train.leaves(params)})
    knots = p["knots"] + p["transform"][None]
    poses = geometry.spline_poses(knots, 0.0, 1.0, n_poses)
    K = torch.tensor([[c["rgb_fx"], 0, c["rgb_cx"]], [0, c["rgb_fy"], c["rgb_cy"]],
                      [0, 0, 1]], dtype=torch.float64, device=device)
    gap, unsure, total = 0.0, 0, 0
    for f, j in sorted(picks):
        key, i, rgb = frames[f]
        idx = torch.arange(j * chunk, min((j + 1) * chunk, H * W), device=device)
        gens = draws_mod.generators((*key, i, j), draws_mod.CHUNK_CONSUMERS, device)
        ref, near = ref_render.render_chunk(
            p["nerf"], p["nerf_fine"], poses[i], K, H, W, idx, gens,
            c["N_samples"], c["N_importance"], c.get("sigma_noise_std", 1.0))
        got = torch.as_tensor(rgb.reshape(H * W, -1)[idx.cpu().numpy()],
                              device=device).double()
        g = torch.abs(got - ref).amax(-1)
        g = float(torch.max(torch.where(near, torch.zeros_like(g), g)))
        gap = max(gap, g if math.isfinite(g) else math.inf)
        unsure += int(near.sum())
        total += idx.shape[0]
    print(f"rays left out of rgb_gap at a jump of the method: {unsure} of "
          f"{total}", file=sys.stderr)
    return {"rgb_gap": gap}


def run(o):
    from benerf_tpu_torch.cli import test as test_cli
    from benerf_tpu_torch.core.config import Config
    from benerf_tpu_torch.eval import frames as frames_mod
    from benerf_tpu_torch.render import renderer as renderer_mod

    dev, tr = o.device, o.traffic
    c = dict(o.conf["config"], compute_dtype=o.precision)
    cfg = Config(**c)
    H, W = int(cfg.rgb_height), int(cfg.rgb_width)
    params = inputs.weights(c, o.seed, dev)
    poses = test_cli.pose_trajectory(params, cfg, tr["poses"])
    K = np.array([[cfg.rgb_fx, 0, cfg.rgb_cx], [0, cfg.rgb_fy, cfg.rgb_cy],
                  [0, 0, 1]], np.float32)
    settings = renderer_mod.RenderSettings.from_config(cfg)
    chunk = tr["chunk"]
    net = {"nerf": params["nerf"], "nerf_fine": params["nerf_fine"]}

    def trajectory(rep):
        return frames_mod.render_trajectory(net, poses, K, H, W, settings,
                                            chunk=chunk, key=(o.seed, rep),
                                            device=dev)

    next(trajectory(0))  # warm-up: one frame
    o.sync()
    setup_s = time.time() - o.t_start
    frames, bad = [], 0
    t0 = time.perf_counter()
    rep, done = 1, False
    while not done:
        for i, fr in enumerate(trajectory(rep)):
            frames.append(((o.seed, rep), i, fr["rgb"]))
            bad += int(not np.all(np.isfinite(fr["rgb"])))
            if time.perf_counter() - t0 >= o.seconds:
                done = True
                break
        rep += 1
    window = time.perf_counter() - t0
    frame_ms = window / len(frames) * 1e3
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    e2e = {"setup_s": setup_s, "frame_ms": frame_ms}
    per_layer, trace = {}, None
    if o.trace:
        _, prof = tracing.profiled(lambda: next(trajectory(rep)), dev)
        trace = {"busy_s": prof.busy_s, "window_s": prof.wall_s,
                 "breakdown": prof.breakdown()}
        ctx = harness.Context(
            workload=o.name, conf=o.conf, cfg=cfg, device=dev, chips=o.chips,
            e2e=e2e, profile=prof, steps=1,
            objects=dict(params=net, settings=settings, chunk=chunk, H=H, W=W))
        per_layer = o.read_metrics(ctx)
    o.free()
    numbers = check_numbers(c, {k: params[k] for k in
                                ("nerf", "nerf_fine", "knots", "transform")},
                            frames, o.seed, tr["check_chunks"], chunk,
                            tr["poses"], dev)
    return dict(e2e=e2e, per_layer=per_layer, trace=trace, peak=peak,
                attempted=len(frames), failed=bad), numbers

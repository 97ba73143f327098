#!/usr/bin/env python3
"""Where the time of one BeNeRF train step goes, for the PyTorch/CUDA port.

    python3 tools/torch_profile_step.py [--iters 5] [--multires-views L]
                                        [--compute-dtype bfloat16]
                                        [--dispatch G]
                                        [--config PATH] [--events N]
                                        [--out FILE.json]

Builds a config (default configs/benerf_blender/tanabata.txt) at full width
on an in-memory random scene of --events events (default 1,000,000, as
chip_smoke.py does); with --multires-views L other than 4, both NeRF MLPs
are built with a view encoding of 3 + 6 L rows (the path of the staged
kernels K3/K4, as chip_smoke.py phase 6); with --compute-dtype bfloat16 the
MLPs run K1/K2 (or K3/K4) in their bf16 mode. Runs a few warm-up steps,
then `--iters` uncaptured steps (make_train_step) under torch.profiler.
With --dispatch G it then does the same for dispatches of G steps through
make_multi_step (one CUDA graph of the step, captured once, replayed),
after two untimed dispatches. Prints and writes (JSON, --out), for each:
  - wall time per step (host clock, measured without the profiler; one
    host read of the metrics per step uncaptured, per dispatch captured,
    as the train loop reads them), the device's busy time (sum of kernel
    and copy times) and its idle share;
  - device time per group: K1 or K3 (and the weights' wgmma copies their
    launch writes first), K2's or K4's tile pass, their weight-gradient
    pass and partial-sum reduce, and every other kernel;
    launches per step;
  - device time per kernel, largest first.
Imports nothing of JAX or of the JAX package. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

N_EVENTS = 1_000_000
WARMUP = 3


# kernel name prefix -> group (csrc/*_mlp_*.cu, csrc/wgmma_layer.cuh)
GROUPS = (("fmlp::fwd_kernel", "K1"), ("fmlp::tile_kernel", "K2 tile pass"),
          ("wl::prep_kernel", "K1/K3 weight copies"),
          ("fmlp::staged_fwd_kernel", "K3"),
          ("fmlp::staged_tile_kernel", "K4 tile pass"),
          ("fmlp::wgrad_", "K2/K4 weight-gradient pass"),
          ("fmlp::reduce_kernel", "K2/K4 reduce"))


def _group(name: str) -> str:
    name = name.removeprefix("void ")  # templated kernels name their return type
    for prefix, group in GROUPS:
        if name.startswith(prefix):
            return group
    return "other kernels and copies"


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--multires-views", type=int, default=4)
    ap.add_argument("--compute-dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--dispatch", type=int, default=0,
                    help="also profile captured dispatches of this many steps")
    ap.add_argument("--config",
                    default=str(REPO / "configs/benerf_blender/tanabata.txt"))
    ap.add_argument("--events", type=int, default=N_EVENTS)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("torch_profile_step: torch sees no CUDA device")
    from benerf_tpu_torch.core.config import load_config
    from benerf_tpu_torch.data import datasets
    from benerf_tpu_torch.data import events as events_mod
    from benerf_tpu_torch.models import bridge, nerf
    from benerf_tpu_torch.ops import fused_mlp
    from benerf_tpu_torch.train import loop, step as step_mod

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    fused_mlp.build()

    cfg = load_config(args.config)
    scene = datasets.random_scene(cfg, args.events, seed=0, device="cuda")
    cap = events_mod.window_cap(scene.events.ts.cpu().numpy(),
                                cfg.accumulate_time_length)
    cfg = dataclasses.replace(cfg, event_window_cap=cap,
                              multires_views=args.multires_views,
                              compute_dtype=args.compute_dtype)
    H, W = scene.image.shape[1:3]
    K_rgb, K_evt, _, _, _ = loop.intrinsics(cfg)
    batch = loop.make_batch(scene, cfg, K_rgb, K_evt, "cuda")
    params = step_mod.build_params(cfg, cfg.seed, device="cuda")
    if cfg.multires_views != 4:  # build_params keeps 27 rows, as in JAX
        g = torch.Generator(device="cuda")
        g.manual_seed(cfg.seed + 1)
        for name in ("nerf", "nerf_fine"):
            params[name] = bridge.tree_map(
                lambda t: t.requires_grad_(True),
                nerf.init_params(g, input_ch_views=3 + 6 * cfg.multires_views,
                                 channels=cfg.channels, device="cuda"))
    state = step_mod.init_state(cfg, cfg.seed, device="cuda", params=params)
    step_fn = step_mod.make_train_step(cfg, H, W)
    rays = (2 * cfg.sampling_event_rays + cfg.num_interpolated_pose
            * (cfg.sampling_rgb_rays // cfg.num_interpolated_pose))

    for _ in range(WARMUP):
        state, metrics = step_fn(state, batch, cfg.seed)
        step_mod.metrics_to_host(metrics)

    def run(fn, n_calls):
        nonlocal state
        for _ in range(n_calls):
            state, metrics = fn(state, batch, cfg.seed)
            step_mod.metrics_to_host(metrics)  # the loop's host read

    result = {
        "card": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
        "config": args.config, "events": args.events,
        "multires_views": cfg.multires_views, "compute_dtype": cfg.compute_dtype,
        "rays_per_iter": rays,
        "uncaptured": profile_steps(lambda: run(step_fn, args.iters),
                                    args.iters, rays),
    }
    print(f"{smi}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"{args.config}, {args.events} events, L = {cfg.multires_views}, "
          f"{cfg.compute_dtype}")
    report("uncaptured step", result["uncaptured"])
    if args.dispatch:
        multi_fn = step_mod.make_multi_step(cfg, H, W, args.dispatch)
        run(multi_fn, 2)  # warm-up step, capture, replays; then replays
        result["dispatch"] = args.dispatch
        result["captured"] = profile_steps(lambda: run(multi_fn, 1),
                                           args.dispatch, rays)
        report(f"captured dispatch of {args.dispatch}", result["captured"])
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps({k: ({kk: vv for kk, vv in v.items() if kk != "kernels"}
                          if isinstance(v, dict) else v)
                      for k, v in result.items()}))


def profile_steps(fn, steps, rays):
    """fn() runs `steps` train steps: its unprofiled wall time, then one run
    under torch.profiler -> per-step wall, busy, idle share, groups and
    kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from benerf_tpu_torch.core.profiling import device_work

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
    torch.cuda.synchronize()

    kernels = [(name, count / steps, ms / steps)
               for name, count, ms in device_work(prof)]
    groups = {}
    for name, count, ms in kernels:
        g = groups.setdefault(_group(name), {"ms_per_step": 0.0,
                                             "launches_per_step": 0.0})
        g["ms_per_step"] += ms
        g["launches_per_step"] += count
    busy_ms = sum(k[2] for k in kernels)
    return {
        "steps": steps,
        "wall_ms_per_step": wall_ms, "rays_per_sec": rays / wall_ms * 1e3,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "launches_per_step": sum(k[1] for k in kernels),
        "groups": groups,
        "kernels": [{"name": n, "launches_per_step": c, "ms_per_step": ms}
                    for n, c, ms in kernels],
    }


def report(title, r):
    print(f"{title}: wall {r['wall_ms_per_step']:.2f} ms/step "
          f"({r['rays_per_sec']:,.0f} rays/s), device busy "
          f"{r['device_busy_ms_per_step']:.2f} ms/step, idle share "
          f"{r['device_idle_share']:.3f}, {r['launches_per_step']:.0f} "
          "launches/step")
    for g, v in sorted(r["groups"].items(), key=lambda kv: -kv[1]["ms_per_step"]):
        print(f"  {g:28s} {v['ms_per_step']:9.3f} ms  "
              f"x{v['launches_per_step']:.0f}")
    for k in r["kernels"][:25]:
        print(f"  {k['ms_per_step']:9.3f} ms  x{k['launches_per_step']:<6.0f} "
              f"{k['name'][:100]}")


if __name__ == "__main__":
    main()

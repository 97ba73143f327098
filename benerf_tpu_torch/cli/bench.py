"""Benchmark: train-step throughput of the port at the JAX package's bench
workload, the counterpart of bench.py.

Workload: the shipped-config iteration, 2 event poses x 1024 rays + 19 rgb
poses x 53 rays = 3,055 rays, each with 64 coarse + 128 fine points through
the 8x256 MLPs, forward + backward + the five Adam groups, on a random
400x600 scene of 1,000,000 uniform events from seed 0 (bench_config,
bench_batch). The steps run as the train loop runs them: dispatches of
--inner steps through train/step.py make_multi_step, on the card one CUDA
graph of the step, captured once and replayed.

Prints ONE JSON line on stdout: rays/s a card and ms/iter, the model FLOP
of one iteration, the delivered TFLOP/s and the share of one H100's dense
bf16 peak that a card delivers (989 TFLOP/s in both modes, as bench.py
keeps one denominator), the mode, the platform, the mesh size, the card
(nvidia-smi name and power limit) and, with --profile, the captured step's
device busy and launches.

    python3 -m benerf_tpu_torch.cli.bench                     # one card
    python3 -m benerf_tpu_torch.cli.bench --dtype bfloat16
    python3 -m benerf_tpu_torch.cli.bench --profile DIR       # + trace, top ops
    python3 -m torch.distributed.run --nproc_per_node N \\
        -m benerf_tpu_torch.cli.bench --mesh N                # N cards

--device cpu runs the plain version on the CPU; without it and without a
card the bench exits non-zero. Under a launcher every rank builds the same
scene, the step is sharded over the launch's ranks (parallel/mesh.py) and
rank 0 prints the line: `value` and `mfu_vs_bf16_peak` a card,
`mesh_rays_per_sec`, `ms_per_iter` and `delivered_tflops` the whole
mesh's. With --profile DIR one more steady-state dispatch runs under
torch.profiler: DIR/trace.json (Chrome trace) and DIR/top_ops.md (the
device kernels by total time, with launches; raises if the profiler saw no
device time).
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from benerf_tpu_torch import cli_device, resolve_device
from benerf_tpu_torch.core.config import Config
from benerf_tpu_torch.core.profiling import device_work
from benerf_tpu_torch.data import datasets
from benerf_tpu_torch.data import events as events_mod
from benerf_tpu_torch.parallel import mesh as mesh_mod
from benerf_tpu_torch.train import loop
from benerf_tpu_torch.train import step as step_mod

N_EVENTS = 1_000_000
# dense bf16 peak of one H100 SXM at 700 W (NVIDIA's data sheet)
PEAK_BF16_FLOPS = 989e12
TOP_OPS = 30  # rows of top_ops.md


def bench_config(**overrides) -> Config:
    """The bench workload's config: the port's copy of the JAX package's
    __graft_entry__._bench_config, every field and value."""
    kw = dict(
        dataset="BeNeRF_Blender",
        channels=3,
        N_samples=64,
        N_importance=64,
        use_viewdirs=True,
        sampling_event_rays=1024,
        sampling_rgb_rays=1024,
        num_interpolated_pose=19,
        event_time_window=True,
        random_sampling_window=True,
        event_loss=True,
        rgb_loss=True,
        event_threshold=0.1,
        event_coeff_syn=0.1,
        optimize_nerf=True,
        optimize_pose=True,
        lrate=5e-4,
        pose_lrate=5e-4,
        decay_rate=0.1,
        decay_rate_pose=0.1,
        lrate_decay=200,
        max_iter=80000,
        rgb_fx=541.85,
        rgb_fy=541.85,
        rgb_cx=300.0,
        rgb_cy=200.0,
        event_fx=541.85,
        event_fy=541.85,
        event_cx=300.0,
        event_cy=200.0,
        event_width=600,
        event_height=400,
        # top-k ray subsets (the config default is the reference's randperm)
        fast_ray_sampling=True,
    )
    kw.update(overrides)
    return Config(**kw)


def mlp_flops_per_point(depth=8, width=256, input_ch=63, views_ch=27,
                        channels=3):
    """Forward multiply-add FLOP (x2) of one NeRF MLP point evaluation, in
    the split-skip layout of models/nerf.py (bench.py's arithmetic)."""
    f = input_ch * width                      # layer 0
    f += (depth - 2) * width * width          # layers 1..depth-1 (non-skip)
    f += (width + input_ch) * width           # skip layer (concat input)
    f += width * width                        # feature linear
    f += width * 1                            # alpha linear
    f += (width + views_ch) * (width // 2)    # views linear
    f += (width // 2) * channels              # rgb linear
    return 2 * f


def rays_per_iter(cfg) -> int:
    """Rays rendered a step: both event poses' rays and the rgb rays of
    every interpolated pose."""
    return (2 * cfg.sampling_event_rays + cfg.num_interpolated_pose
            * (cfg.sampling_rgb_rays // cfg.num_interpolated_pose))


def workload_flops_per_iter(cfg) -> int:
    """Model FLOP of one training iteration: the MLP's forward and its
    backward (2x forward) at N_samples coarse + (N_samples + N_importance)
    fine points a ray. The MLP is >97% of the step's arithmetic; encoding,
    compositing, sampling, spline and Adam are O(width) a point."""
    evals = cfg.N_samples + (cfg.N_samples + cfg.N_importance)
    per_point = mlp_flops_per_point(depth=cfg.netdepth, width=cfg.netwidth,
                                    channels=cfg.channels)
    return rays_per_iter(cfg) * evals * per_point * 3


def bench_batch(cfg, H, W, n_events=N_EVENTS, seed=0, device=None):
    """(cfg with event_window_cap set from the events, as bench.py does,
    SceneBatch): the bench scene, `n_events` uniform events over the event
    sensor and a uniform H x W image from `seed` (datasets.random_scene,
    which draws what the JAX package's _random_batch draws, in its order)."""
    device = resolve_device(device)
    scene = datasets.random_scene(
        dataclasses.replace(cfg, rgb_height=H, rgb_width=W), n_events, seed,
        device=device)
    cfg = dataclasses.replace(cfg, event_window_cap=events_mod.window_cap(
        scene.events.ts.cpu().numpy(), cfg.accumulate_time_length))
    K_rgb, K_evt = loop.intrinsics(cfg)[:2]
    return cfg, loop.make_batch(scene, cfg, K_rgb, K_evt, device)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_step_bench(cfg, H, W, mesh=None, inner=25, chunks=4,
                   n_events=N_EVENTS, profile=False, profile_dir=None,
                   device=None):
    """Time the captured multi-step at the bench workload -> (rays/s,
    s/iter, the profile summary or None), under a mesh the whole mesh's
    rays/s. One untimed dispatch (the warm-up step and the capture of the
    step's graph); with `profile` or `profile_dir` one profiled dispatch
    (profile_summary, rank 0's card under a mesh; with `profile_dir` also
    written there by write_profile); then `chunks` dispatches of `inner`
    steps timed on the host clock between two synchronisations. The
    metrics are read once, at the end; a non-finite loss raises. device:
    the mesh's under a mesh, else the card unless given."""
    device = mesh.device if mesh is not None else resolve_device(device)
    cfg, batch = bench_batch(cfg, H, W, n_events, device=device)
    state = step_mod.init_state(cfg, 0, device=device)
    mesh_mod.replicate_tree(state.params, mesh)
    fn = step_mod.make_multi_step(cfg, H, W, inner, mesh=mesh)
    seed = 1  # the steps' draws, as bench.py's PRNGKey(1)

    state, metrics = fn(state, batch, seed)  # warm-up step, capture, replays
    step_mod.metrics_to_host(metrics)
    summary = None
    if profile or profile_dir:
        from torch.profiler import ProfilerActivity, profile as profiler

        with profiler(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            state, metrics = fn(state, batch, seed)
            _sync(device)
        if mesh is None or mesh.rank == 0:
            summary = profile_summary(prof, inner)
            if profile_dir:
                write_profile(prof, summary, profile_dir)
    _sync(device)
    t0 = time.perf_counter()
    losses = []
    for _ in range(chunks):
        state, metrics = fn(state, batch, seed)
        losses.append(metrics["loss"])
    _sync(device)
    dt = time.perf_counter() - t0
    loss = torch.cat(losses).cpu().numpy()
    if not np.all(np.isfinite(loss)):
        raise FloatingPointError(f"non-finite training loss: {loss}")
    iters = inner * chunks
    return rays_per_iter(cfg) * iters / dt, dt / iters, summary


def profile_summary(prof, steps):
    """The device work of a profile of `steps` steps -> {device busy ms and
    launches a step, [each kernel's launches and ms a step], largest
    first}. Raises if `prof` recorded no device time."""
    work = device_work(prof)
    if not work:
        raise RuntimeError("the profiler recorded no device time: profile "
                           "on the card")
    return {
        "steps": steps,
        "device_busy_ms_per_step": sum(ms for _, _, ms in work) / steps,
        "launches_per_step": sum(n for _, n, _ in work) / steps,
        "kernels": [{"name": name, "launches_per_step": n / steps,
                     "ms_per_step": ms / steps} for name, n, ms in work],
    }


def write_profile(prof, summary, profile_dir):
    """DIR/trace.json (the Chrome trace) and DIR/top_ops.md (profile_summary's
    busy and launches a step and its TOP_OPS kernels by total time)."""
    out = Path(profile_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "trace.json"))
    busy, kernels = summary["device_busy_ms_per_step"], summary["kernels"]
    lines = [f"# Device kernels of one dispatch of {summary['steps']} steps",
             "", f"{nvidia_smi_line()}; device busy {busy:.3f} ms/step over "
             f"{summary['launches_per_step']:.0f} launches/step "
             f"({len(kernels)} kernels, the top {min(TOP_OPS, len(kernels))} "
             "below)",
             "", "| # | ms/step | share of busy | launches/step | kernel |",
             "|---|---|---|---|---|"]
    for i, k in enumerate(kernels[:TOP_OPS]):
        lines.append(f"| {i + 1} | {k['ms_per_step']:.4f} | "
                     f"{k['ms_per_step'] / busy:.4f} | "
                     f"{k['launches_per_step']:g} | `{k['name'][:160]}` |")
    (out / "top_ops.md").write_text("\n".join(lines) + "\n")


def nvidia_smi_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def main(argv=None, cfg=None, n_events=N_EVENTS):
    """Parse argv (None: sys.argv), run the bench, print its JSON line (rank
    0 alone under a mesh) and return it as a dict. cfg: the workload
    (None: bench_config()), its image the event sensor's size (400x600 in
    bench_config, as bench.py sets it); n_events: the scene's events."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="the MLP kernels' mode (compute_dtype)")
    p.add_argument("--inner", type=int, default=25,
                   help="steps per dispatch (one CUDA graph, replayed)")
    p.add_argument("--chunks", type=int, default=4,
                   help="dispatches timed")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="trace one steady-state dispatch into DIR")
    p.add_argument("--mesh", type=int, default=0,
                   help="shard the step over the launch's N ranks")
    p.add_argument("--device", default=None,
                   help="card index N (default: 0, under a launcher "
                        "LOCAL_RANK) or 'cpu'")
    args = p.parse_args(argv)

    if args.device != "cpu" and not torch.cuda.is_available():
        sys.exit("bench: torch sees no CUDA card; pass --device cpu to run "
                 "the plain version on the CPU")
    requested = "cpu" if args.device == "cpu" else None
    index = int(args.device) if requested is None and args.device else 0
    device = (mesh_mod.initialize_distributed(requested)
              or cli_device(index, requested))
    try:
        mesh = mesh_mod.make_mesh(args.mesh, device) if args.mesh else None
        cfg = dataclasses.replace(cfg or bench_config(),
                                  compute_dtype=args.dtype)
        H, W = cfg.event_height, cfg.event_width
        rays_s, dt, summary = run_step_bench(
            cfg, H, W, mesh=mesh, inner=args.inner, chunks=args.chunks,
            n_events=n_events, profile_dir=args.profile, device=device)
    finally:
        mesh_mod.finalize_distributed()

    line = bench_line(cfg, rays_s, dt, mesh.size if mesh is not None else 1,
                      device.type, summary)
    if mesh is None or mesh.rank == 0:
        print(json.dumps(line), flush=True)
    return line


def bench_line(cfg, rays_s, dt, mesh_devices, platform, summary=None):
    """The JSON line of a run of `cfg` on `mesh_devices` devices that did
    `rays_s` rays/s (the mesh's) at `dt` s/iter: rays/s and the share of
    the bf16 peak a card (the peak None off the card), the mesh's rays/s,
    ms/iter and TFLOP/s, and the profiled step's device busy and launches
    (None without a profile summary)."""
    flops = workload_flops_per_iter(cfg)
    on_card = platform == "cuda"
    summary = summary or {}
    return {
        "metric": "train_rays_per_sec_per_chip",
        "value": rays_s / mesh_devices,
        "unit": "rays/s a card (fwd+bwd+opt, 192 MLP evals/ray)",
        "mesh_rays_per_sec": rays_s,
        "ms_per_iter": dt * 1e3,
        "model_flops_per_iter": flops,
        "delivered_tflops": flops / dt / 1e12,
        "mfu_vs_bf16_peak": (flops / dt / (mesh_devices * PEAK_BF16_FLOPS)
                             if on_card else None),
        "compute_dtype": cfg.compute_dtype,
        "platform": platform,
        "mesh_devices": mesh_devices,
        "card": nvidia_smi_line() if on_card else None,
        "device_busy_ms_per_step": summary.get("device_busy_ms_per_step"),
        "launches_per_step": summary.get("launches_per_step"),
    }


if __name__ == "__main__":
    main()

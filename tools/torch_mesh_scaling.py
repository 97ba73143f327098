#!/usr/bin/env python3
"""The port's train loop on 1, 2 and 4 cards of one host: tanabata at full
width through train() under torch.distributed.run.

    python3 tools/torch_mesh_scaling.py [--out FILE.json]

Needs four cards. For each world size N in WORLDS it runs `python -m
torch.distributed.run --standalone --nproc_per_node N` of this script in its
rank mode: every rank makes the same in-memory random scene (EVENTS events
from seed 0, as chip_smoke.py does) and runs train() on
configs/benerf_blender/tanabata.txt at its own widths with mesh_devices N
(N = 1: no mesh) for ITERS iterations in dispatches of CONSOLE steps (one
captured CUDA graph of the step, the all-reduce over NCCL inside it),
nothing else periodic. Rank 0 reads the run's metrics.jsonl: ms/iter and
rays/s over the console windows after the first (which holds the capture),
the loss of every iteration; and counts its K1/K2 launches and collectives.
Prints one line per N and writes (JSON, --out) every N's numbers beside the
card's name and power limit, with each N's metrics of iteration 1 against
N = 1's (relative). Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

TANABATA = REPO / "configs/benerf_blender/tanabata.txt"


WORLDS = (1, 2, 4)
ITERS, CONSOLE, EVENTS = 300, 100, 1_000_000


def _args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--rank-run", nargs=2, metavar=("N", "OUT"), default=None)
    return ap.parse_args(argv)


def _config(world, logdir):
    from benerf_tpu_torch.core.config import load_config

    return dataclasses.replace(
        load_config(str(TANABATA)), max_iter=ITERS, console_log_iter=CONSOLE,
        render_image_iter=0, render_video_iter=0, save_model_iter=0,
        logdir=logdir, mesh_devices=world)


def rank_run(args):
    """One rank of a launch: train() and, on rank 0, its numbers to OUT."""
    import torch

    from benerf_tpu_torch.data import datasets
    from benerf_tpu_torch.ops import mlp as mlp_ops
    from benerf_tpu_torch.parallel import mesh as mesh_mod
    from benerf_tpu_torch.train import loop
    from benerf_tpu_torch.train import step as step_mod

    world, out = int(args.rank_run[0]), args.rank_run[1]
    torch.backends.cuda.matmul.allow_tf32 = False
    device = mesh_mod.initialize_distributed()
    rank = int(os.environ["RANK"])
    with tempfile.TemporaryDirectory() as logdir:
        cfg = _config(world, logdir)
        scene = datasets.random_scene(cfg, EVENTS, seed=0, device=device)
        before = mlp_ops.counts(step_mod.COUNTERS)
        t0 = time.perf_counter()
        loop.train(cfg, scene, device=device)
        wall = time.perf_counter() - t0
        launches, routes, coll = mlp_ops.counts_since(before,
                                                      step_mod.COUNTERS)
        if rank == 0:
            with open(os.path.join(logdir, "0", "metrics.jsonl")) as f:
                recs = [json.loads(line) for line in f]
            steps = [r for r in recs if "train_loss" in r]
            rates = [r["rays_per_sec"] for r in recs if "rays_per_sec" in r]
            rays = (2 * cfg.sampling_event_rays + cfg.num_interpolated_pose
                    * (cfg.sampling_rgb_rays // cfg.num_interpolated_pose))
            steady = rates[1:] or rates
            res = dict(
                world=world, device=str(device), iters=len(steps),
                rays_per_iter=rays, wall_s=wall,
                rays_per_sec_windows=rates,
                rays_per_sec=statistics.median(steady),
                ms_per_iter=1e3 * rays / statistics.median(steady),
                iter1={k: v for k, v in steps[0].items() if k != "step"},
                losses=[r["train_loss"] for r in steps],
                launches_rank0={**launches, **routes},
                collectives_per_iter_rank0={
                    k: v / len(steps) for k, v in coll.items()})
            with open(out, "w") as f:
                json.dump(res, f)
    mesh_mod.finalize_distributed()


def _smi():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return "not measured (no nvidia-smi)"
    return " | ".join(line.strip() for line in out.strip().splitlines())


def main(argv=None):
    args = _args(argv)
    if args.rank_run:
        return rank_run(args)
    import torch

    if torch.cuda.device_count() < max(WORLDS):
        sys.exit(f"torch_mesh_scaling: {max(WORLDS)} ranks need as many "
                 f"cards, {torch.cuda.device_count()} visible")
    smi = _smi()
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        for n in WORLDS:
            out = os.path.join(tmp, f"world{n}.json")
            cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                   "--nproc_per_node", str(n), str(Path(__file__).resolve()),
                   "--rank-run", str(n), out]
            t0 = time.perf_counter()
            subprocess.run(cmd, check=True, cwd=REPO, timeout=1800)
            with open(out) as f:
                res = json.load(f)
            res["launch_s"] = time.perf_counter() - t0
            results.append(res)
    base = results[0]["iter1"]
    for res in results:
        res["iter1_max_rel_diff_vs_first"] = max(
            abs(v - base[k]) / max(abs(base[k]), 1e-30)
            for k, v in res["iter1"].items() if base[k] or v)
        print(f"world {res['world']}: {res['ms_per_iter']:.2f} ms/iter, "
              f"{res['rays_per_sec']:,.0f} rays/s ({res['rays_per_iter']} "
              f"rays/iter, {res['iters']} iterations, launch "
              f"{res['launch_s']:.1f} s); iteration 1 vs world "
              f"{results[0]['world']}: {res['iter1_max_rel_diff_vs_first']:.2e}"
              f"; rank 0 launches {res['launches_rank0']}, collectives/iter "
              f"{res['collectives_per_iter_rank0']} on {smi}")
    summary = {"card": smi, "results": results}
    print(json.dumps(summary))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)


if __name__ == "__main__":
    main()

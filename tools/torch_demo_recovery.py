#!/usr/bin/env python3
"""The port's recovery on the demo scene, run as a user runs it.

    python3 tools/torch_demo_recovery.py [--max-iter 10000]
                                         [--render-image-iter 500]
                                         [--out demo_recovery.json]

Writes the 80x80 demo scene with the port's writer
(`write_benerf_blender_scene(d, H=80, W=80)`, as configs/demo.txt's header
says), then runs

    python -m benerf_tpu_torch.cli.train --config configs/demo.txt \\
        --datadir D --logdir L --render_image_iter 500 [--max_iter N]

on the card (the config unchanged but for its paths, the eval period and,
if given, max_iter). Reads the run's metrics.jsonl and writes (JSON, --out)
and prints:
  - at each periodic eval: PSNR and SSIM of the mid frame against the sharp
    ground truth, the pose metrics against the writer's trajectory
    (pose_flow_rmse_px beside gt_flow_rms_px, the flow of a motionless
    estimate; ATE, RPE);
  - the blurry input's PSNR / SSIM against the sharp ground truth, and the
    pose flow of the motion-scale init (the knots the run starts from);
  - ms/iter and rays/s: the median of the loop's rays_per_sec records over
    the console windows without an eval, video or checkpoint; the run's wall
    time, the scene writer's seconds;
  - the card's name and power limit (nvidia-smi) and the torch version.
The scene, the arguments and the rate come from chip_smoke.py's demo phase
(write_demo_scene, demo_argv, train_rays_per_sec), so both run the demo the
same way. Imports nothing of JAX or of the JAX package. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


def main():
    import torch

    from benerf_tpu_torch.core.config import config_from_cli
    from benerf_tpu_torch.data import datasets
    from benerf_tpu_torch.eval import metrics, pose_metrics
    from benerf_tpu_torch.geometry import spline
    from benerf_tpu_torch.train import pose_init
    from benerf_tpu_torch.train.loop import intrinsics

    ap = argparse.ArgumentParser()
    ap.add_argument("--max-iter", type=int, default=None)
    ap.add_argument("--render-image-iter", type=int, default=500)
    ap.add_argument("--out", default="demo_recovery.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_demo_recovery: torch sees no CUDA device")
    smi = chip_smoke.nvidia_smi_line()

    with tempfile.TemporaryDirectory() as root:
        scene_dir, logdir = f"{root}/demo", f"{root}/logs"
        write_s = chip_smoke.write_demo_scene(scene_dir)
        flags = {"render_image_iter": args.render_image_iter}
        if args.max_iter:
            flags["max_iter"] = args.max_iter
        argv = chip_smoke.demo_argv(scene_dir, logdir, **flags)
        cmd = [sys.executable, "-m", "benerf_tpu_torch.cli.train", *argv]
        print(" ".join(cmd), flush=True)
        t0 = time.perf_counter()
        subprocess.run(cmd, check=True, cwd=REPO)
        run_s = time.perf_counter() - t0
        recs = chip_smoke.read_records(f"{logdir}/0/metrics.jsonl")

        cfg = config_from_cli(argv)
        scene = datasets.load_scene(scene_dir, cfg, device="cpu")
        blurry, sharp = scene.image[0], scene.imgtest[0]
        knots0, d_px = pose_init.initial_knots(cfg, scene)
        K_render = intrinsics(cfg)[2]
        n = cfg.num_interpolated_pose

        def traj(knots, us):
            return spline.interpolate_poses(
                torch.as_tensor(knots), float(us[0]), float(us[1]), n,
                cfg.traj).numpy()

        gt = traj(scene.gt_knots, scene.gt_exp_us)
        init_flow = pose_metrics.reproj_flow_error(
            traj(knots0, scene.rgb_exp_ts), gt, K_render,
            scene.gt_plane_depth, 80, 80)

    keys = ("test_mid_psnr", "test_mid_ssim", "pose_flow_rmse_px",
            "gt_flow_rms_px", "pose_ate_rmse", "pose_rpe_trans",
            "pose_rpe_rot_deg")
    evals = [{"step": r["step"], **{k: r[k] for k in keys if k in r}}
             for r in recs if "test_mid_psnr" in r]
    rays_s, ms_iter, windows = chip_smoke.train_rays_per_sec(recs, cfg)
    losses = [r["train_loss"] for r in recs if "train_loss" in r]
    out = {
        "device": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
        "command": " ".join(cmd[1:]), "iters": len(losses),
        "scene_write_s": write_s, "run_wall_s": run_s,
        "ms_per_iter": ms_iter, "rays_per_sec": rays_s,
        "rate_windows": windows,
        "blurry_input": {"psnr": metrics.psnr(blurry, sharp),
                         "ssim": metrics.ssim(blurry, sharp)},
        "motion_scale_init": {"d_px": d_px, **init_flow},
        "evals": evals, "loss_first": losses[0], "loss_last": losses[-1],
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"blurry input {out['blurry_input']['psnr']:.2f} dB; motion-scale "
          f"init flow {init_flow['flow_rmse_px']:.3f} px of "
          f"{init_flow['gt_flow_rms_px']:.3f}")
    for e in evals:
        print(f"iter {e['step']}: PSNR {e['test_mid_psnr']:.2f} dB, flow "
              f"{e['pose_flow_rmse_px']:.3f} px of {e['gt_flow_rms_px']:.3f}")
    print(f"{ms_iter:.2f} ms/iter ({rays_s:,.0f} rays/s, median of {windows} "
          f"windows) over {len(losses)} iterations; wall {run_s:.0f} s; on {smi}")
    print(json.dumps(out))


if __name__ == "__main__":
    main()

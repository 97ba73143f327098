"""Joint-recovery quality harness: the evidence BeNeRF exists to produce.

Port of benerf_tpu/eval/quality.py. The reference's deliverable is a
recovered camera trajectory plus a deblurred NeRF, evaluated in-train every
few thousand iterations (reference train.py:403-441) and offline
(test.py:111-135, metrics.py:21-100). This module writes the bundled
synthetic blur + events scene with the port's writer, trains it with the
port's train loop and records that evidence:

  - pose recovery: ATE / RPE of the recovered spline trajectory and its
    reprojection-flow error against the writer's ground-truth knots, at
    every eval;
  - deblurring: PSNR / SSIM of the rendered mid-exposure frame against the
    sharp ground truth, beside the blurry *input* image's own PSNR, the bar
    the system must beat to have deblurred anything.

CLI (writes one JSON artifact; --device cpu runs off the card):

    python -m benerf_tpu_torch.eval.quality --iters 8000 --evals 4 \\
        --workdir /tmp/quality --out quality.json [--device N]

The baseline's initial trajectory is the port's reference draw, U(0, 0.01)
from a torch generator seeded with cfg.seed on the run's device, so its
pose numbers differ from the JAX package's for the same seed; the scene,
the ground-truth samples and the blurry input's PSNR / SSIM are host numpy
and equal the JAX package's.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch

from benerf_tpu_torch import cli_device, resolve_device


def _fresh_run_dir(root: str) -> str:
    """First unused `run-NNN` subdirectory of `root`.

    Every training gets its own logdir so metrics.jsonl (opened append-mode
    by JsonlLogger) can never mix records from two runs.
    """
    os.makedirs(root, exist_ok=True)
    n = 0
    while True:
        cand = os.path.join(root, f"run-{n:03d}")
        if not os.path.exists(cand):
            os.makedirs(cand)
            return cand
        n += 1


def demo_config(datadir: str, logdir: str, iters: int, evals: int = 4,
                H: int = 80, W: int = 80, focal: float = 90.0, **overrides):
    """Config for the bundled synthetic scene (mirrors configs/demo.txt)."""
    from benerf_tpu_torch.core.config import Config

    eval_iter = max(1, iters // max(evals, 1))
    kw = dict(
        project="quality", datadir=datadir, logdir=logdir,
        dataset="BeNeRF_Blender", index=0, channels=3,
        rgb_fx=focal, rgb_fy=focal, rgb_cx=W / 2, rgb_cy=H / 2,
        rgb_width=W, rgb_height=H,
        event_fx=focal, event_fy=focal, event_cx=W / 2, event_cy=H / 2,
        event_width=W, event_height=H,
        event_threshold=0.1, event_shift_start=0, event_shift_end=0,
        accumulate_time_length=0.1, random_sampling_window=True,
        event_time_window=True,
        sampling_event_rays=1024, sampling_rgb_rays=1024,
        N_samples=64, N_importance=64, use_viewdirs=True,
        optimize_nerf=True, optimize_pose=True,
        lrate=5e-4, pose_lrate=5e-4, decay_rate=0.1, decay_rate_pose=0.1,
        console_log_iter=min(100, eval_iter),
        render_image_iter=eval_iter, render_video_iter=0,
        save_model_iter=iters, max_iter=iters,
        rgb_loss=True, event_loss=True, event_coeff_syn=0.1, rgb_coeff=1.0,
    )
    kw.update(overrides)
    return Config(**kw)


def gt_pose_samples(scene, cfg, n: int) -> np.ndarray:
    """The writer's ground-truth knots interpolated over the exposure, as
    train/loop.py periodic_eval maps them."""
    from benerf_tpu_torch.geometry import spline as spline_mod

    us = scene.gt_exp_us if scene.gt_exp_us is not None else scene.rgb_exp_ts
    return spline_mod.interpolate_poses(
        torch.as_tensor(scene.gt_knots), float(us[0]), float(us[1]), n,
        cfg.traj).numpy()


def initial_pose_error(scene, cfg, K, H, W, device=None) -> dict:
    """Pose error of the *initial* (random U(0, 0.01)) trajectory, the bar
    the optimizer must beat (reference init: model/optimize.py:22-29). The
    headline number is the gauge-fixed reprojection-flow error: a
    do-nothing trajectory scores about the ground-truth motion magnitude.
    device: where the draw is made (None: the card; raises without one)."""
    from benerf_tpu_torch.eval import pose_metrics
    from benerf_tpu_torch.train import step as step_mod
    from benerf_tpu_torch.train.loop import rgb_pose_trajectory

    state = step_mod.init_state(cfg, cfg.seed, device=device)
    n = cfg.num_interpolated_pose
    est = rgb_pose_trajectory(state.params, cfg, scene.rgb_exp_ts, n)
    gt = gt_pose_samples(scene, cfg, n)
    r = pose_metrics.rpe(est, gt)
    out = {
        "pose_ate_rmse": pose_metrics.ate_rmse(est, gt),
        "pose_rpe_trans": r["trans_rmse"],
        "pose_rpe_rot_deg": r["rot_rmse_deg"],
    }
    if scene.gt_plane_depth is not None:
        fl = pose_metrics.reproj_flow_error(
            est, gt, K, scene.gt_plane_depth, H, W
        )
        out["pose_flow_rmse_px"] = fl["flow_rmse_px"]
        out["gt_flow_rms_px"] = fl["gt_flow_rms_px"]
    return out


def run_quality(workdir: str, iters: int = 4000, evals: int = 4,
                H: int = 80, W: int = 80, focal: float = 90.0,
                seed: int = 0,
                init_from_gt: float = None, dataset: str = "BeNeRF_Blender",
                device=None, **cfg_overrides):
    """Write the scene -> train -> collect the evals. Returns the artifact
    dict (also the structure written by the CLI). device: None is the card
    (raises without one); tests pass "cpu".

    dataset selects the scene format AND loss family (the reference's three
    event-loss branches, train.py:204-296):
      BeNeRF_Blender    safe_log brightness, threshold 0.1  (syn loss)
      E2NeRF_Synthetic  lin_log brightness,  threshold 0.2  (syn loss)
      E2NeRF_Real       lin_log brightness,  threshold -1   (normalized loss)
    """
    from benerf_tpu_torch.data import datasets, synthetic
    from benerf_tpu_torch.eval import metrics as metrics_mod
    from benerf_tpu_torch.train.loop import train

    device = resolve_device(device)
    t_start = time.time()
    datadir = os.path.join(workdir, "data")
    logdir = _fresh_run_dir(os.path.join(workdir, "logs"))
    # scene-generator params must leave cfg_overrides even when the scene
    # already exists on disk (they are not Config fields)
    scene_kw = {k: cfg_overrides.pop(k) for k in
                ("target_blur_px", "threshold", "n_virtual",
                 "wall_freq_scale")
                if k in cfg_overrides}
    family = {
        "BeNeRF_Blender": dict(
            writer=lambda: synthetic.write_benerf_blender_scene(
                datadir, H=H, W=W, focal=focal, seed=seed, n_images=1,
                **scene_kw),
            cfg=dict(dataset="BeNeRF_Blender", event_threshold=0.1),
        ),
        # accumulate_time_length 0.25 == all shipped e2nerf configs
        # (reference configs/e2nerf_*/*.txt)
        "E2NeRF_Synthetic": dict(
            writer=lambda: synthetic.write_e2nerf_synthetic_scene(
                datadir, H=H, W=W, seed=seed, **scene_kw),
            cfg=dict(dataset="E2NeRF_Synthetic", event_threshold=0.2,
                     accumulate_time_length=0.25),
        ),
        "E2NeRF_Real": dict(
            writer=lambda: synthetic.write_e2nerf_real_scene(
                datadir, H=H, W=W, seed=seed, **scene_kw),
            cfg=dict(dataset="E2NeRF_Real", event_threshold=-1.0,
                     event_coeff_real=2.0, accumulate_time_length=0.25),
        ),
    }[dataset]
    if not os.path.exists(os.path.join(datadir, "scene_meta.json")):
        family["writer"]()

    fam_cfg = dict(family["cfg"])
    fam_cfg.update(cfg_overrides)
    cfg = demo_config(datadir, logdir, iters, evals, H=H, W=W, focal=focal,
                      seed=seed, **fam_cfg)
    scene = datasets.load_scene(datadir, cfg, device=device)
    if scene.imgtest is None:
        # E2NeRF_Real: the loader is faithful to the real datasets (no GT
        # images), but the writer stores the sharp frame as a sidecar:
        # inject it for metrics only (never touches training).
        scene = dataclasses.replace(
            scene,
            imgtest=datasets.load_image_stack(
                datadir, "images_test", cfg.channels == 1, 0
            ),
        )

    blurry = scene.image[0]
    sharp = scene.imgtest[0]
    K = np.array(
        [[cfg.rgb_fx, 0, cfg.rgb_cx], [0, cfg.rgb_fy, cfg.rgb_cy], [0, 0, 1]]
    )
    baseline = {
        "blurry_input_psnr": metrics_mod.psnr(blurry, sharp),
        "blurry_input_ssim": metrics_mod.ssim(blurry, sharp),
        **initial_pose_error(scene, cfg, K, H, W, device=device),
    }

    init_knots = None
    if init_from_gt is not None:
        # diagnostic: start the spline at the GT knots (init_from_gt == 0)
        # or at GT + relative perturbation (convergence-basin probe)
        g = np.load(os.path.join(datadir, "gt_trajectory.npz"))
        init_knots = np.asarray(g["knots"], np.float32)
        if init_from_gt > 0:
            rng_ = np.random.default_rng(12345)
            init_knots = init_knots + rng_.normal(
                scale=init_from_gt, size=init_knots.shape
            ).astype(np.float32) * np.abs(init_knots).mean()

    train(cfg, scene, init_knots=init_knots, device=device)

    # checkpoints: every periodic_eval record in the JSONL log
    checkpoints = []
    log_path = os.path.join(logdir, str(cfg.index), "metrics.jsonl")
    with open(log_path) as f:
        for line in f:
            rec = json.loads(line)
            if "test_mid_psnr" in rec:
                checkpoints.append({
                    k: rec[k]
                    for k in ("step", "test_mid_psnr", "test_mid_ssim",
                              "test_mid_lpips", "pose_ate_rmse",
                              "pose_rpe_trans", "pose_rpe_rot_deg",
                              "pose_flow_rmse_px", "gt_flow_rms_px")
                    if k in rec
                })

    final = checkpoints[-1] if checkpoints else {}
    scene_block = {"kind": f"synthetic_{dataset.lower()}", "dataset": dataset,
                   "H": H, "W": W, "seed": seed, "iters": iters,
                   "n_events": int(scene.events.num)}
    meta_path = os.path.join(datadir, "scene_meta.json")
    if os.path.exists(meta_path):  # generator provenance (blur calibration,
        with open(meta_path) as f:  # trajectory scales, format version)
            scene_block["generator"] = json.load(f)
    artifact = {
        "scene": scene_block,
        "config": {
            **{k: getattr(cfg, k) for k in (
                "N_samples", "N_importance", "sampling_event_rays",
                "sampling_rgb_rays", "num_interpolated_pose", "traj",
                "compute_dtype", "use_pallas", "pose_lrate_warmup",
                "pose_init", "use_barf_c2f", "fast_ray_sampling")},
            # None = reference random init; 0.0 = GT init; >0 = perturbed GT
            # (diagnostic runs, NOT recovery evidence)
            "init_from_gt": init_from_gt,
        },
        "baseline": baseline,
        "checkpoints": checkpoints,
        "passed": {
            "deblur_psnr_beats_blurry_input":
                bool(final.get("test_mid_psnr", -np.inf)
                     > baseline["blurry_input_psnr"]),
            # the recovered trajectory must explain the apparent motion
            # better than the random init (whose error ~= the full motion)
            "pose_flow_improves":
                bool(final.get("pose_flow_rmse_px", np.inf)
                     < baseline.get("pose_flow_rmse_px", np.inf) * 0.75),
        },
        "run_dir": logdir,
        "wall_s": round(time.time() - t_start, 1),
        "platform": device.type,
    }
    if not any("test_mid_lpips" in c for c in checkpoints):
        # the reference's published bar includes LPIPS (BASELINE.md): say
        # why it is absent rather than silently omitting the column
        artifact["metrics_caveat"] = (
            "LPIPS/BRISQUE omitted: pretrained weights unobtainable in this "
            "zero-egress container (eval/lpips_torch.py, eval/brisque.py are "
            "implemented and weight-gated; supply BENERF_LPIPS_WEIGHTS / "
            "BENERF_BRISQUE_MODEL to enable)"
        )
    return artifact


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--iters", type=int, default=4000)
    p.add_argument("--evals", type=int, default=4)
    p.add_argument("--size", type=int, default=80)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--workdir", type=str, required=True)
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--dataset", type=str, default="BeNeRF_Blender",
                   choices=["BeNeRF_Blender", "E2NeRF_Synthetic",
                            "E2NeRF_Real"],
                   help="scene format + event-loss family (train.py:204-296)")
    p.add_argument("--compute_dtype", type=str, default="float32")
    p.add_argument("--target_blur_px", type=float, default=None,
                   help="scene generator blur calibration (px of worst-case "
                        "image sweep per exposure); default = generator's")
    p.add_argument("--pose_lrate_warmup", type=int, default=None)
    p.add_argument("--pose_init", type=str, default=None,
                   choices=["reference", "motion_scale"],
                   help="trajectory init (see train/pose_init.py)")
    p.add_argument("--use_barf_c2f", type=str, default=None,
                   choices=["True", "False"],
                   help="BARF coarse-to-fine PE weighting")
    p.add_argument("--fast_ray_sampling", type=str, default=None,
                   choices=["True", "False"],
                   help="top-k ray subsets instead of randperm slices")
    p.add_argument("--device", type=str, default="0",
                   help="card index N (cuda:N; raises without a card) or "
                        "'cpu'")
    args = p.parse_args(argv)

    device = "cpu" if args.device == "cpu" else cli_device(int(args.device))
    extra = {}
    if args.target_blur_px is not None:
        extra["target_blur_px"] = args.target_blur_px
    if args.pose_lrate_warmup is not None:
        extra["pose_lrate_warmup"] = args.pose_lrate_warmup
    if args.pose_init is not None:
        extra["pose_init"] = args.pose_init
    if args.use_barf_c2f is not None:
        extra["use_barf_c2f"] = args.use_barf_c2f == "True"
    if args.fast_ray_sampling is not None:
        extra["fast_ray_sampling"] = args.fast_ray_sampling == "True"
    artifact = run_quality(args.workdir, iters=args.iters, evals=args.evals,
                           H=args.size, W=args.size, seed=args.seed,
                           dataset=args.dataset, device=device,
                           compute_dtype=args.compute_dtype, **extra)
    text = json.dumps(artifact, indent=2)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")


if __name__ == "__main__":
    main()

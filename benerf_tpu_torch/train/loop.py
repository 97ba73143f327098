"""The training run: load -> train -> eval -> checkpoint, as BeNeRF runs it.

Port of benerf_tpu/train/loop.py (reference train.py:20-461): the scene
from disk (or the caller's), the undistortion remaps, the trajectory init
(reference draw, loaded poses or the motion-scale estimate), resume from
the latest checkpoint, g train steps per dispatch (g the gcd of the
periodic-event intervals, as the JAX loop) with one JSONL record per
iteration, the non-finite-loss guard, the event-window overflow warning and
rays/s accounting, a profiler trace of one dispatch (with the program's
spans, and their device ms printed as one [PROFILE] line), periodic eval of the
recovered trajectory (images, KITTI poses, PSNR / SSIM / LPIPS of the mid
frame, and on synthetic scenes ATE / RPE and the reprojection-flow error
against the ground truth), the video and checkpoints.

A dispatch of g steps is train/step.py make_multi_step: on the card one
captured CUDA graph of the step, replayed g times, its stacked metrics read
back once per dispatch. A shorter tail runs single steps (make_train_step),
as the JAX loop does. Under debug_nans (torch anomaly detection, which a
graph cannot capture) every step is a single uncaptured one.

Several cards: one process per card under
`python -m torch.distributed.run --nproc_per_node N` with mesh_devices N
(or -1). Every rank loads the same scene, builds and restores the same
state and trains on its share of each step's rays (parallel/mesh.py,
train/step.py); rank 0 alone writes the run directory (config, log, evals,
video, checkpoints), and the ranks meet after each checkpoint. A mesh the
launch cannot give raises ValueError (parallel/mesh.make_mesh).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import time

import numpy as np
import torch

from benerf_tpu_torch import resolve_device
from benerf_tpu_torch.core import profiling
from benerf_tpu_torch.data import datasets, undistort
from benerf_tpu_torch.data import events as events_util
from benerf_tpu_torch.eval import frames as frames_mod
from benerf_tpu_torch.eval import io as io_mod
from benerf_tpu_torch.eval import metrics as metrics_mod
from benerf_tpu_torch.eval import pose_metrics
from benerf_tpu_torch.geometry import spline as spline_mod
from benerf_tpu_torch.parallel import mesh as mesh_mod
from benerf_tpu_torch.render import renderer as renderer_mod
from benerf_tpu_torch.train import checkpoint as ckpt_mod
from benerf_tpu_torch.train import pose_init as pose_init_mod
from benerf_tpu_torch.train import step as step_mod


def intrinsics(cfg):
    """K_rgb, K_evt, (K_render, H_render, W_render) (reference
    train.py:76-102); H_render / W_render None means the image size."""
    K_rgb = np.array(
        [[cfg.rgb_fx, 0, cfg.rgb_cx], [0, cfg.rgb_fy, cfg.rgb_cy], [0, 0, 1]],
        np.float32,
    )
    K_evt = np.array(
        [[cfg.event_fx, 0, cfg.event_cx], [0, cfg.event_fy, cfg.event_cy],
         [0, 0, 1]],
        np.float32,
    )
    if cfg.render_height == 0 and cfg.render_width == 0:
        return K_rgb, K_evt, K_rgb, None, None
    K_render = np.array(
        [[cfg.render_fx, 0, cfg.render_cx],
         [0, cfg.render_fy, cfg.render_cy], [0, 0, 1]], np.float32
    )
    return K_rgb, K_evt, K_render, cfg.render_height, cfg.render_width


def make_batch(scene, cfg, K_rgb, K_evt, device, img_remap=None,
               evt_remap=None) -> step_mod.SceneBatch:
    H, W, C = scene.image.shape[1:4]

    def dev(x):
        return None if x is None else torch.as_tensor(
            np.asarray(x, np.float32), device=device)

    return step_mod.SceneBatch(
        events=events_util.EventArrays(*(t.to(device) for t in scene.events)),
        image_flat=dev(scene.image.reshape(H * W, C)),
        rgb_exp_ts=dev(scene.rgb_exp_ts),
        K_rgb=dev(K_rgb),
        K_evt=dev(K_evt),
        img_remap=None if img_remap is None else dev(img_remap.reshape(-1, 2)),
        evt_remap=None if evt_remap is None else dev(evt_remap.reshape(-1, 2)),
    )


def _start_profiler(device):
    """A started torch.profiler of the host and, on the card, the device."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def _print_span_ms(span_ms, step):
    """The [PROFILE] line: device ms of each span of the profiled
    dispatch's last step (a name's spans summed); nothing off the card."""
    if span_ms:
        print(f"[PROFILE] iter {step} device ms by span: " + ", ".join(
            f"{k} {v:.3f}" for k, v in profiling.summed(span_ms).items()))


def _write_run_config(cfg, logdir):
    os.makedirs(logdir, exist_ok=True)
    with open(os.path.join(logdir, "args.txt"), "w") as f:
        for k in sorted(vars(cfg)):
            f.write(f"{k} = {getattr(cfg, k)}\n")
    if cfg.config and os.path.exists(cfg.config):
        with open(cfg.config, "rb") as src, open(
                os.path.join(logdir, "config.txt"), "wb") as dst:
            dst.write(src.read())


def rgb_pose_trajectory(params, cfg, rgb_exp_ts, seg_num) -> np.ndarray:
    """(seg_num, 3, 4) poses of the rgb camera over its exposure
    (reference get_pose_rgb, model/optimize.py:84-111)."""
    with torch.no_grad():
        knots = params["knots"] + params["transform"][None, :]
        return spline_mod.interpolate_poses(
            knots, float(rgb_exp_ts[0]), float(rgb_exp_ts[1]), seg_num,
            cfg.traj).cpu().numpy()


def periodic_eval(params, cfg, scene, settings_eval, K_render, H_r, W_r,
                  logdir, step, logger, device):
    """Render num_interpolated_pose frames along the recovered trajectory;
    PSNR / SSIM / LPIPS of the middle frame against the sharp GT
    (train.py:403-430) and, on synthetic scenes, the pose metrics against
    the generator's trajectory. Returns (images, results)."""
    poses = rgb_pose_trajectory(params, cfg, scene.rgb_exp_ts,
                                cfg.num_interpolated_pose)
    io_mod.save_poses_kitti(step, logdir, poses)

    imgs = []
    img_dir = os.path.join(logdir, "images_test", f"img_test_{step:06d}")
    for j, fr in enumerate(frames_mod.render_trajectory(
            params, poses, K_render, H_r, W_r, settings_eval, chunk=cfg.chunk,
            key=(cfg.seed + step,), deterministic=not cfg.sigma_noise_eval,
            device=device)):
        io_mod.save_image(os.path.join(img_dir, f"test{j:03d}.png"), fr["rgb"])
        if cfg.depth:
            disp = fr["disp"] / max(fr["disp"].max(), 1e-9)
            io_mod.save_image(os.path.join(img_dir, f"depth_{j:03d}.png"), disp)
        imgs.append(fr["rgb"])

    results = {}
    if scene.imgtest is not None:
        mid = imgs[len(imgs) // 2]
        gt = scene.imgtest[0]
        results["test_mid_psnr"] = metrics_mod.psnr(mid, gt)
        results["test_mid_ssim"] = metrics_mod.ssim(mid, gt)
        lp = metrics_mod.lpips(mid, gt, device=device)
        if lp is not None:
            results["test_mid_lpips"] = lp
        logger.write_img("test_mid_img", mid, step)
    if scene.gt_knots is not None:
        # pose recovery against the generator's ground-truth trajectory
        # (synthetic scenes only; the reference has no in-train pose metric)
        gt_us = scene.gt_exp_us if scene.gt_exp_us is not None else scene.rgb_exp_ts
        gt_poses = spline_mod.interpolate_poses(
            torch.as_tensor(scene.gt_knots), float(gt_us[0]), float(gt_us[1]),
            len(poses), cfg.traj).numpy()
        results["pose_ate_rmse"] = pose_metrics.ate_rmse(poses, gt_poses)
        r = pose_metrics.rpe(poses, gt_poses)
        results["pose_rpe_trans"] = r["trans_rmse"]
        results["pose_rpe_rot_deg"] = r["rot_rmse_deg"]
        if scene.gt_plane_depth is not None:
            fl = pose_metrics.reproj_flow_error(
                poses, gt_poses, K_render, scene.gt_plane_depth, H_r, W_r)
            results["pose_flow_rmse_px"] = fl["flow_rmse_px"]
            results["gt_flow_rms_px"] = fl["gt_flow_rms_px"]
    for k, v in results.items():
        logger.write(k, v)
    return imgs, results


def train(cfg, scene=None, init_knots=None, device=None):
    """Run a full training; returns the final TrainState.

    scene: an in-memory SceneData, or None to load cfg.datadir. init_knots:
    an optional (4, 6) se(3) knot override for the trajectory init (default:
    the reference draw, scene.ev_poses under loadpose, or the motion-scale
    estimate under pose_init = motion_scale). device: "cuda" unless given
    (under a launcher the card cuda:LOCAL_RANK); with no device and no card
    this raises.
    """
    device = mesh_mod.initialize_distributed(device) or resolve_device(device)
    mesh = mesh_mod.make_mesh(cfg.mesh_devices, device)
    lead = mesh is None or mesh.rank == 0  # writes the run directory

    logdir = os.path.join(os.path.expanduser(cfg.logdir), str(cfg.index))
    if lead:
        _write_run_config(cfg, logdir)
    logger = io_mod.JsonlLogger(
        (cfg.log_file or os.path.join(logdir, "metrics.jsonl")) if lead
        else None,
        wandb_project=cfg.project if cfg.viewer == "wandb" and lead else None,
        config=vars(cfg))

    if scene is None:
        scene = datasets.load_scene(cfg.datadir, cfg, device=device)
    H, W = scene.image.shape[1:3]
    K_rgb, K_evt, K_render, H_r, W_r = intrinsics(cfg)
    if H_r is None:
        H_r, W_r = H, W
    img_remap, evt_remap = undistort.luts_for_config(cfg)
    batch = make_batch(scene, cfg, K_rgb, K_evt, device, img_remap, evt_remap)

    if init_knots is None and cfg.loadpose:
        init_knots = scene.ev_poses
    if init_knots is None and cfg.pose_init == "motion_scale":
        init_knots, d_px = pose_init_mod.initial_knots(cfg, scene)
        print(f"[INFO] motion-scale pose init: estimated apparent motion "
              f"{d_px:.2f}px -> mean |knot| {np.abs(init_knots).mean():.4f}")
    state = step_mod.init_state(
        cfg, cfg.seed, device=device, init_knots=init_knots,
        init_transform=scene.trans if cfg.loadtrans else None,
    )
    if cfg.load_checkpoint and ckpt_mod.latest_step(logdir) is not None:
        state = ckpt_mod.restore(logdir, state, device=device)
        print(f"[INFO] resumed from step {state.step}")
    mesh_mod.replicate_tree(state.params, mesh)

    if cfg.event_time_window and cfg.event_window_cap == 0:
        cap = events_util.window_cap(scene.events.ts.cpu().numpy(),
                                     cfg.accumulate_time_length)
        cfg = dataclasses.replace(cfg, event_window_cap=cap)
        print(f"[INFO] event window cap: {cap} of {scene.events.num} events")
    settings_eval = renderer_mod.RenderSettings.from_config(cfg)
    # g steps per dispatch: the largest chunk that respects every
    # periodic-event boundary (benerf_tpu/train/loop.py)
    g = math.gcd(math.gcd(cfg.console_log_iter, cfg.render_image_iter),
                 math.gcd(cfg.render_video_iter, cfg.save_model_iter))
    g = max(1, min(g, cfg.max_iter))
    step_fn = step_mod.make_train_step(cfg, H, W, mesh)
    multi_fn = None
    if g > 1 and cfg.debug_nans:
        print("[INFO] debug_nans: anomaly detection cannot run inside a CUDA "
              "graph, so every step runs alone and uncaptured")
    elif g > 1:
        # profile_iter: the graph holds the step's spans (core/profiling.py)
        multi_fn = step_mod.make_multi_step(cfg, H, W, g, mesh,
                                            spans=cfg.profile_iter > 0)

    rays_per_iter = (  # the global rays, under a mesh too
        2 * cfg.sampling_event_rays
        + cfg.num_interpolated_pose
        * (cfg.sampling_rgb_rays // cfg.num_interpolated_pose)
    )
    # rays/s as the JAX loop logs it: wall time since the last console
    # record, so a window that holds an eval, video or checkpoint counts it
    t_last, n_since = time.time(), 0
    try:
        with torch.autograd.set_detect_anomaly(cfg.debug_nans):
            while state.step < cfg.max_iter:
                i = state.step
                n = min(g, cfg.max_iter - i)
                if n != g or multi_fn is None:
                    n = 1
                prof = None
                if lead and cfg.profile_iter > 0 and i <= cfg.profile_iter < i + n:
                    # the dispatch that crosses profile_iter under the
                    # profiler, as the JAX loop traces one scan chunk
                    prof = _start_profiler(device)
                with (profiling.recording(device) if prof is not None
                      else contextlib.nullcontext()) as spans:
                    if n > 1:
                        state, metrics = multi_fn(state, batch, cfg.seed)
                    else:
                        state, metrics = step_fn(state, batch, cfg.seed)
                i = state.step
                # the dispatch's one host sync: its stacked metrics
                host = step_mod.metrics_to_host(metrics)
                if prof is not None:
                    prof.stop()
                    _print_span_ms(multi_fn.span_ms() if n > 1
                                   else spans.device_ms(), i)
                    path = os.path.join(cfg.profile_dir,
                                        f"trace_iter{i - n + 1:06d}.json")
                    os.makedirs(cfg.profile_dir, exist_ok=True)
                    prof.export_chrome_trace(path)
                    print(f"[INFO] wrote profiler trace to {path}")
                n_since += n
                for j in range(n):
                    logger.write_record(i - n + 1 + j, {
                        "train_" + k: v[j] for k, v in host.items()})
                logger.flush()
                last = {k: float(v[-1]) for k, v in host.items()}

                bad = np.flatnonzero(~np.isfinite(host["loss"]))
                if bad.size:
                    at = i - n + 1 + int(bad[0])
                    raise FloatingPointError(
                        f"non-finite loss at iter {at}: "
                        f"{host['loss'][bad[0]]}. Re-run with debug_nans=True "
                        "to locate the faulting op (torch anomaly detection).")
                overflow = int(np.max(host.get("eta_window_overflow", 0)))
                if lead and overflow > 0:
                    print(f"[WARN] iter {i}: event window overflowed its static "
                          f"cap by {overflow} events — the ETA target dropped "
                          "events; raise event_window_cap (or 0 for the exact "
                          "full-stream path).")

                if lead and ((cfg.console_log_iter > 0
                              and i % cfg.console_log_iter == 0)
                             or i == cfg.max_iter):
                    dt = time.time() - t_last
                    rays_s = rays_per_iter * n_since / max(dt, 1e-9)
                    logger.write("rays_per_sec", rays_s)
                    print(f"[TRAIN] iter {i} loss {last['loss']:.5f} "
                          f"event {last.get('event_loss', 0.0):.5f} "
                          f"rgb {last.get('rgb_loss', 0.0):.5f} "
                          f"({rays_s:,.0f} rays/s)")
                    t_last, n_since = time.time(), 0

                if (lead and cfg.render_image_iter > 0
                        and i % cfg.render_image_iter == 0):
                    _, results = periodic_eval(
                        state.params, cfg, scene, settings_eval, K_render, H_r,
                        W_r, logdir, i, logger, device)
                    if results:
                        print(f"[EVAL] iter {i}: {results}")

                if (lead and cfg.render_video_iter > 0
                        and i % cfg.render_video_iter == 0):
                    poses = rgb_pose_trajectory(state.params, cfg,
                                                scene.rgb_exp_ts, 90)
                    io_mod.save_video(
                        os.path.join(logdir, f"{cfg.index}_spiral_{i:06d}_rgb.mp4"),
                        [fr["rgb"] for fr in frames_mod.render_trajectory(
                            state.params, poses, K_render, H_r, W_r, settings_eval,
                            chunk=cfg.chunk, device=device)])

                if cfg.save_model_iter > 0 and i % cfg.save_model_iter == 0:
                    if lead:
                        path = ckpt_mod.save(logdir, state)
                        print(f"[INFO] saved checkpoint {path}")
                    mesh_mod.barrier(mesh)

                logger.update_buffer(i)
    finally:
        logger.close()
    return state

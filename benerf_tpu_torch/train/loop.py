"""The step loop of a BeNeRF training run.

Port of the step loop of benerf_tpu/train/loop.py: per-iteration JSONL
records, the non-finite-loss guard, the event-window overflow warning and
rays/s accounting. Periodic eval, video, checkpoints, pose initialisation
from files or from the motion-scale estimate, the mesh and the dataset
loaders belong to later slices of the port; a config that asks for one of
them raises NotImplementedError instead of being quietly run without it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch

from benerf_tpu_torch import resolve_device
from benerf_tpu_torch.data import events as events_util
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


def _unported(cfg, scene):
    """Names of the features this config asks for that the port lacks."""
    asks = {
        "periodic eval (render_image_iter > 0; eval slice)":
            cfg.render_image_iter > 0,
        "video (render_video_iter > 0; eval slice)": cfg.render_video_iter > 0,
        "checkpoints (save_model_iter > 0 / load_checkpoint; checkpoint "
        "slice)": cfg.save_model_iter > 0 or cfg.load_checkpoint,
        "loadpose (pose-init slice)": cfg.loadpose,
        "pose_init=motion_scale (pose-init slice)":
            cfg.pose_init == "motion_scale",
        "a multi-device mesh (mesh_devices > 1; multi-GPU slice)":
            cfg.mesh_devices > 1,
        "profiling (profile_iter > 0)": cfg.profile_iter > 0,
        "per-term knot gradients (log_knot_grad_terms)":
            cfg.log_knot_grad_terms,
        "undistortion LUTs (nonzero rgb_dist / event_dist; data slice)":
            any(cfg.rgb_dist) or any(cfg.event_dist),
        "loading a scene from disk (scene=None; data-loader slice)":
            scene is None,
    }
    return [name for name, on in asks.items() if on]


def _write_run_config(cfg, logdir):
    os.makedirs(logdir, exist_ok=True)
    with open(os.path.join(logdir, "args.txt"), "w") as f:
        for k in sorted(vars(cfg)):
            f.write(f"{k} = {getattr(cfg, k)}\n")


def train(cfg, scene=None, init_knots=None, device=None):
    """Run the step loop for cfg.max_iter iterations; returns the final
    TrainState. scene: an in-memory SceneData. device: "cuda" unless given;
    with no device and no card this raises."""
    missing = _unported(cfg, scene)
    if missing:
        raise NotImplementedError(
            "not ported yet: " + "; ".join(missing))
    device = resolve_device(device)

    logdir = os.path.join(os.path.expanduser(cfg.logdir), str(cfg.index))
    _write_run_config(cfg, logdir)
    log_path = cfg.log_file or os.path.join(logdir, "metrics.jsonl")

    H, W = scene.image.shape[1:3]
    K_rgb, K_evt, _, _, _ = intrinsics(cfg)
    batch = make_batch(scene, cfg, K_rgb, K_evt, device)

    if cfg.event_time_window and cfg.event_window_cap == 0:
        cap = events_util.window_cap(scene.events.ts.cpu().numpy(),
                                     cfg.accumulate_time_length)
        cfg = dataclasses.replace(cfg, event_window_cap=cap)
        print(f"[INFO] event window cap: {cap} of {scene.events.num} events")

    state = step_mod.init_state(
        cfg, cfg.seed, device=device, init_knots=init_knots,
        init_transform=scene.trans if cfg.loadtrans else None,
    )
    step_fn = step_mod.make_train_step(cfg, H, W)

    rays_per_iter = (
        2 * cfg.sampling_event_rays
        + cfg.num_interpolated_pose
        * (cfg.sampling_rgb_rays // cfg.num_interpolated_pose)
    )
    t_last = time.time()
    n_since = 0
    with open(log_path, "a") as log, \
            torch.autograd.set_detect_anomaly(cfg.debug_nans):
        while state.step < cfg.max_iter:
            state, metrics = step_fn(state, batch, cfg.seed)
            i = state.step
            n_since += 1
            # one host sync per iteration: the record, the guard, the log
            last = {k: v.item() for k, v in metrics.items()}
            log.write(json.dumps(
                {"step": i, **{"train_" + k: float(v) for k, v in last.items()}}
            ) + "\n")
            log.flush()

            if not np.isfinite(last["loss"]):
                raise FloatingPointError(
                    f"non-finite loss at iter {i}: {last['loss']}. Re-run "
                    "with debug_nans=True to locate the faulting op "
                    "(torch anomaly detection).")
            overflow = int(last.get("eta_window_overflow", 0))
            if overflow > 0:
                print(f"[WARN] iter {i}: event window overflowed its static "
                      f"cap by {overflow} events — the ETA target dropped "
                      "events; raise event_window_cap (or 0 for the exact "
                      "full-stream path).")

            if ((cfg.console_log_iter > 0 and i % cfg.console_log_iter == 0)
                    or i == cfg.max_iter):
                dt = time.time() - t_last
                rays_s = rays_per_iter * n_since / max(dt, 1e-9)
                log.write(json.dumps({"step": i, "time": time.time(),
                                      "rays_per_sec": rays_s}) + "\n")
                print(f"[TRAIN] iter {i} loss {last['loss']:.5f} "
                      f"event {last.get('event_loss', 0.0):.5f} "
                      f"rgb {last.get('rgb_loss', 0.0):.5f} "
                      f"({rays_s:,.0f} rays/s)")
                t_last, n_since = time.time(), 0
    return state

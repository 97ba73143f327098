"""Inference CLI of the port: load a checkpoint, extract poses, render
images and a video.

Port of benerf_tpu/cli/test.py (reference test.py:14-135, README.md:104-129):
    python -m benerf_tpu_torch.cli.test --config cfg.txt --index 0 \\
        --extract_poses True --render_images True --render_video True \\
        [--checkpoint N] [--device N]

Loads the port's NNNNNN.ckpt.npz checkpoints, and imports the reference's
torch NNNNNN.tar checkpoints when the requested step has one (weights
converted by models/torch_compat; optimizer states are not imported).
--device N runs on the card cuda:N; without a card the run raises. Every
frame is rendered in chunks through ops/mlp.route: on the card two K1
launches a chunk (coarse and fine) and no backward kernel.
"""

from __future__ import annotations

import os

import torch

from benerf_tpu_torch import cli_device
from benerf_tpu_torch.core.config import config_from_cli
from benerf_tpu_torch.eval import frames as frames_mod
from benerf_tpu_torch.eval import io as io_mod
from benerf_tpu_torch.geometry import spline as spline_mod
from benerf_tpu_torch.models import torch_compat
from benerf_tpu_torch.render import renderer as renderer_mod
from benerf_tpu_torch.train import checkpoint as ckpt_mod
from benerf_tpu_torch.train import step as step_mod
from benerf_tpu_torch.train.loop import intrinsics


def load_params(cfg, logdir, device):
    """Checkpoint -> (params on `device`, global_step).

    Selection: the requested cfg.checkpoint if that file exists (a
    reference .tar, else the port's .ckpt.npz); otherwise the latest
    checkpoint, with a warning (the reference's test.py:96-107 hard errors
    on a missing step; here partial runs remain inspectable).
    """
    tar = os.path.join(logdir, f"{cfg.checkpoint:06d}.tar")
    if os.path.exists(tar):
        return _params_from_torch_tar(cfg, tar, device)
    template = step_mod.init_state(cfg, cfg.seed, device=device)
    step = None
    requested = os.path.join(logdir, f"{cfg.checkpoint:06d}.ckpt.npz")
    if os.path.exists(requested):
        step = cfg.checkpoint
    else:
        latest = ckpt_mod.latest_step(logdir)
        if latest is not None and latest != cfg.checkpoint:
            print(
                f"[WARN] checkpoint {cfg.checkpoint} not found under {logdir};"
                f" falling back to latest ({latest})"
            )
            step = latest
    state = ckpt_mod.restore(logdir, template, step=step, device=device)
    return state.params, int(state.step)


def _params_from_torch_tar(cfg, path, device):
    """Import a reference .tar checkpoint (test.py:98-107 layout): its
    `global_step`, its `graph` state dict and five optimizer state dicts,
    read with weights_only=True (tensors and plain containers only)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt["graph"]
    params = step_mod.build_params(cfg, cfg.seed, device=device)
    params["nerf"] = torch_compat.nerf_params_from_state_dict(
        sd, "nerf.", device=device)
    params["nerf_fine"] = torch_compat.nerf_params_from_state_dict(
        sd, "nerf_fine.", device=device)
    params["knots"] = sd["evt_knot_pose_se3.params.weight"].to(device,
                                                               copy=True)
    params["transform"] = sd["transform.params.weight"][0].to(device,
                                                               copy=True)
    # CRF tone mappers (component.py:38-149) ride along when present so
    # optimize_rgb_crf / optimize_event_crf runs import losslessly.
    if any(k.startswith("rgb_crf.mlp_gray.") for k in sd):
        params["rgb_crf"] = torch_compat.crf_params_from_state_dict(
            sd, "rgb_crf.mlp_gray.", device=device)
    if any(k.startswith("event_crf.mlp_luminance.") for k in sd):
        params["event_crf"] = torch_compat.crf_params_from_state_dict(
            sd, "event_crf.mlp_luminance.", device=device)
    return params, int(ckpt["global_step"])


def pose_trajectory(params, cfg, seg_num):
    """get_pose_rgb over the FULL unit interval (test.py:111-130 uses
    [0, 1]) -> (seg_num, 3, 4) numpy poses."""
    with torch.no_grad():
        knots = params["knots"] + params["transform"][None, :]
        return spline_mod.interpolate_poses(knots, 0.0, 1.0, seg_num,
                                            cfg.traj).cpu().numpy()


def main(argv=None, device=None):
    """Parse argv (None: sys.argv), load the checkpoint and write what the
    flags ask for under <logdir>/<index>/test_results. device: None runs on
    cuda:<--device>; tests pass "cpu"."""
    cfg = config_from_cli(argv)
    device = cli_device(cfg.device, device)
    logdir = os.path.join(os.path.expanduser(cfg.logdir), str(cfg.index))
    testdir = os.path.join(logdir, "test_results")
    os.makedirs(testdir, exist_ok=True)

    params, global_step = load_params(cfg, logdir, device)
    print(f"[INFO] loaded checkpoint at step {global_step}")

    _, _, K_render, H_r, W_r = intrinsics(cfg)
    if H_r is None:
        H_r, W_r = int(cfg.rgb_height), int(cfg.rgb_width)
    settings = renderer_mod.RenderSettings.from_config(cfg)

    if cfg.extract_poses and global_step > 0:
        poses = pose_trajectory(params, cfg, cfg.num_extract_poses)
        io_mod.save_poses_kitti(global_step, testdir, poses)
        print("[INFO] extracted poses")

    if cfg.render_images and global_step > 0:
        poses = pose_trajectory(params, cfg, cfg.num_render_images)
        img_dir = os.path.join(testdir, "image_test",
                               f"img_test_{global_step:06d}")
        for j, fr in enumerate(frames_mod.render_trajectory(
                params, poses, K_render, H_r, W_r, settings, chunk=cfg.chunk,
                device=device)):
            io_mod.save_image(os.path.join(img_dir, f"test{j:03d}.png"),
                              fr["rgb"])
            if cfg.depth:
                disp = fr["disp"] / max(fr["disp"].max(), 1e-9)
                io_mod.save_image(os.path.join(img_dir, f"depth_{j:03d}.png"),
                                  disp)
        print("[INFO] rendered images")

    if cfg.render_video and global_step > 0:
        poses = pose_trajectory(params, cfg, 90)
        frames = [fr["rgb"] for fr in frames_mod.render_trajectory(
            params, poses, K_render, H_r, W_r, settings, chunk=cfg.chunk,
            device=device)]
        io_mod.save_video(
            os.path.join(testdir,
                         f"{cfg.index}_spiral_{global_step:06d}_rgb.mp4"),
            frames)
        print("[INFO] rendered video")


if __name__ == "__main__":
    main()

"""Result IO: KITTI pose dumps, 8-bit image/video writers, JSONL metrics log.

Port of benerf_tpu/eval/io.py (reference utils/pose_utils.py:5-20: KITTI
rows = flattened 3x4, one pose per line; utils/img_utils.py:19-21 to8bit;
train.py:437-439 mp4 at 30 fps; logger/wandb_logger.py buffered scalar
logging, here a JSONL sink with optional wandb). Images are PNGs written by
data/png.py. A video is an mp4 where imageio and an mp4 backend are
installed; elsewhere its frames are written as PNGs beside the path, with a
warning, as the JAX package does without an mp4 backend.
"""

from __future__ import annotations

import json
import os
import time
import warnings
from typing import Optional

import numpy as np

from benerf_tpu_torch.data import png


def to8bit(x) -> np.ndarray:
    return (255 * np.clip(np.asarray(x), 0, 1)).astype(np.uint8)


def save_poses_kitti(step: int, logdir: str, poses) -> str:
    """Write poses_test/poses_test_{step:06d}.txt, one 3x4 row-major pose per
    line (utils/pose_utils.py:5-20)."""
    poses_dir = os.path.join(logdir, "poses_test")
    os.makedirs(poses_dir, exist_ok=True)
    path = os.path.join(poses_dir, f"poses_test_{step:06d}.txt")
    with open(path, "w") as f:
        for pose in np.asarray(poses):
            f.write(" ".join(str(float(v)) for v in pose.reshape(-1)) + "\n")
    return path


def save_image(path: str, img):
    """An image in [0, 1] as an 8-bit PNG: gray for one channel, else RGB
    or RGBA."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    png.write(path, to8bit(img).squeeze())


def save_video(path: str, frames, fps: int = 30):
    """Write an mp4 (reference: imageio.mimsave, run_nerf_helpers.py:139).

    Where imageio or its mp4 backend (ffmpeg / pyav) is not installed, the
    frames go to PNGs in `<path without .mp4>_frames/` instead, with a
    warning, so trajectory export still succeeds."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    imgs = [to8bit(f).squeeze() for f in frames]
    try:
        import imageio

        imageio.mimsave(path, imgs, fps=fps, quality=8)
    except (ValueError, ImportError) as e:
        frame_dir = os.path.splitext(path)[0] + "_frames"
        os.makedirs(frame_dir, exist_ok=True)
        for i, img in enumerate(imgs):
            png.write(os.path.join(frame_dir, f"{i:04d}.png"), img)
        warnings.warn(
            f"no video backend ({e}); wrote {len(imgs)} PNG frames to "
            f"{frame_dir}")


class JsonlLogger:
    """Buffered per-step scalar logger -> JSONL file (+ optional wandb).

    Mirrors the WandbLogger.write/update_buffer pattern
    (logger/wandb_logger.py:9-29): scalars accumulate into a step buffer,
    flushed by update_buffer()."""

    def __init__(self, path: Optional[str], wandb_project: Optional[str] = None,
                 config: Optional[dict] = None):
        self.path = path
        self._buf = {}
        self._file = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._file = open(path, "a")
        self._wandb = None
        if wandb_project and wandb_project != "None":
            try:
                import wandb
            except ImportError:
                warnings.warn("wandb is not installed; logging to JSONL only")
            else:
                self._wandb = wandb.init(project=wandb_project, config=config)

    def write(self, key: str, value):
        self._buf[key] = float(value)

    def write_record(self, step: int, scalars: dict):
        """Write one complete per-iteration record immediately (bypasses the
        buffer)."""
        rec = {"step": int(step), **{k: float(v) for k, v in scalars.items()}}
        if self._file:
            self._file.write(json.dumps(rec) + "\n")
        if self._wandb is not None:
            self._wandb.log(rec, step=step)

    def write_img(self, key: str, img, step: int):
        """Image channel (reference WandbLogger.write_img): to wandb when it
        is on; the JSONL file gets no image."""
        if self._wandb is not None:
            import wandb

            self._wandb.log({key: wandb.Image(np.asarray(img))}, step=step)

    def flush(self):
        if self._file:
            self._file.flush()

    def update_buffer(self, step: int):
        if not self._buf:
            return
        rec = {"step": int(step), "time": time.time(), **self._buf}
        if self._file:
            self._file.write(json.dumps(rec) + "\n")
            self._file.flush()
        if self._wandb is not None:
            self._wandb.log(self._buf, step=step)
        self._buf = {}

    def close(self):
        if self._file:
            self._file.close()

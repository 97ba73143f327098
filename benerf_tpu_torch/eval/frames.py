"""Full-frame rendering for eval and test, in chunks of rays.

Port of benerf_tpu/eval/frames.py (reference Graph.render_video /
render_image_test, model/nerf.py:353-390): all H*W rays of a pose, rendered
under torch.no_grad() in chunks of `chunk` rays through
renderer.render_poses_with_ray_idx, so every MLP call goes through
ops/mlp.route: on the card one K1 launch for a chunk's coarse pass and one
for its fine pass, and no backward kernel. The last chunk is not padded
(the JAX package pads it only to keep its compiled shapes static).

QUIRK (preserved): the reference's eval path keeps the stratified z
perturbation and the sigma noise on (SURVEY.md §3.2). `deterministic=True`
turns both off. In random mode each chunk's draws come from torch
Generators seeded from (key..., chunk index); torch cannot reproduce the
JAX package's jax.random streams, so random-mode renders agree with it only
in distribution.
"""

from __future__ import annotations

import numpy as np
import torch

from benerf_tpu_torch import resolve_device
from benerf_tpu_torch.core import profiling
from benerf_tpu_torch.core import rng as rng_mod
from benerf_tpu_torch.render import renderer as renderer_mod

# the renderer's random consumers of one chunk
_CONSUMERS = ("z", "pdf", "noise_c", "noise_f")


def render_image(params, pose, K, H: int, W: int, settings, chunk: int = 4096,
                 key=(0,), deterministic: bool = False, device=None):
    """Render one full frame; returns {"rgb" (H, W, C), "disp" (H, W),
    "acc" (H, W)} numpy arrays. params: {"nerf", "nerf_fine"} on `device`
    (None: the card; raises without one). key: tuple of ints seeding the
    random-mode draws. Spans (core/profiling.py): the frame (index key),
    each chunk (index (*key, chunk index)) with its draws and its
    render.fwd, and the copies to the host."""
    device = resolve_device(device)
    with profiling.span("frame", index=tuple(key)):
        pose = torch.as_tensor(np.asarray(pose), dtype=torch.float32,
                               device=device)
        K = torch.as_tensor(np.asarray(K), dtype=torch.float32, device=device)
        hw = H * W
        rgb, disp, acc = [], [], []
        with torch.no_grad():
            for i, start in enumerate(range(0, hw, chunk)):
                with profiling.span("frame.chunk", index=(*key, i)):
                    idx = torch.arange(start, min(start + chunk, hw),
                                       device=device)
                    with profiling.span("frame.draws"):
                        keys = ({} if deterministic else rng_mod.generators(
                            (*key, i), _CONSUMERS, device))
                    with profiling.span("render.fwd"):
                        ret = renderer_mod.render_poses_with_ray_idx(
                            params["nerf"], params["nerf_fine"], pose[None],
                            idx, K, H, W, settings, keys=keys)
                    rgb.append(ret["rgb_map"])
                    disp.append(ret["disp_map"])
                    acc.append(ret["acc_map"])
        with profiling.span("frame.to_host"):
            return {
                "rgb": torch.cat(rgb).cpu().numpy().reshape(H, W, -1),
                "disp": torch.cat(disp).cpu().numpy().reshape(H, W),
                "acc": torch.cat(acc).cpu().numpy().reshape(H, W),
            }


def render_trajectory(params, poses, K, H, W, settings, chunk=4096, key=(0,),
                      deterministic: bool = False, progress=None, device=None):
    """Render a sequence of poses; yields per-frame dicts (frame i's draws
    seeded from (key..., i))."""
    for i, pose in enumerate(poses):
        if progress:
            progress(i, len(poses))
        yield render_image(params, pose, K, H, W, settings, chunk,
                           key=(*key, i), deterministic=deterministic,
                           device=device)

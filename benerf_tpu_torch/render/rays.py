"""Pinhole ray generation and NDC reparameterization.

Port of benerf_tpu/render/rays.py. Camera convention (OpenGL-style, as the
reference): dir_cam = [(i - cx)/fx, -(j - cy)/fy, -1] for pixel column i,
row j; rays_d = R @ dir_cam, rays_o = t of the camera-to-world pose [R|t].
Pixel indices are integers (no half-pixel offset). An optional (H*W, 2)
undistort LUT replaces (i, j) with looked-up float coordinates.
"""

from __future__ import annotations

import torch


def rays_for_pixels(i, j, K, c2w):
    """i, j (N,) pixel columns / rows; K (3,3); c2w (N,3,4) or (3,4)
    -> rays_o, rays_d (N,3)."""
    i = i.to(c2w.dtype)
    j = j.to(c2w.dtype)
    K = K.to(c2w.dtype)
    dirs = torch.stack(
        [(i - K[0, 2]) / K[0, 0], -(j - K[1, 2]) / K[1, 1], -torch.ones_like(i)],
        dim=-1,
    )
    rays_d = torch.einsum("...ij,...j->...i", c2w[..., :3, :3], dirs)
    rays_o = c2w[..., :3, 3].expand(rays_d.shape)
    return rays_o, rays_d


def rays_from_flat_idx(ray_idx, W, K, c2w, remap=None):
    """Rays for flat pixel indices into an H*W image (j = idx // W row,
    i = idx % W column), or the remap LUT's coordinates when given."""
    if remap is not None:
        flat = remap.reshape(-1, 2)[ray_idx]
        i, j = flat[..., 0], flat[..., 1]
    else:
        j = torch.div(ray_idx, W, rounding_mode="floor")
        i = ray_idx % W
    return rays_for_pixels(i, j, K, c2w)


def ndc_rays(H, W, focal, near, rays_o, rays_d):
    """Shift rays to the near plane and project to NDC space (standard NeRF
    NDC; the reference applies it unconditionally)."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    ox, oy, oz = rays_o[..., 0], rays_o[..., 1], rays_o[..., 2]
    dx, dy, dz = rays_d[..., 0], rays_d[..., 1], rays_d[..., 2]

    o0 = -1.0 / (W / (2.0 * focal)) * ox / oz
    o1 = -1.0 / (H / (2.0 * focal)) * oy / oz
    o2 = 1.0 + 2.0 * near / oz

    d0 = -1.0 / (W / (2.0 * focal)) * (dx / dz - ox / oz)
    d1 = -1.0 / (H / (2.0 * focal)) * (dy / dz - oy / oz)
    d2 = -2.0 * near / oz

    return torch.stack([o0, o1, o2], -1), torch.stack([d0, d1, d2], -1)

"""Camera-frame construction and render-path generation (host-side numpy).

The port's copy of benerf_tpu/geometry/camera_paths.py (the port imports
nothing of the JAX package). Capability parity with the LLFF-style pose
utilities the reference carries in load_data.py:144-260,390-439 (pose
recentering, spiral and spherified render paths): the `loadpose` path and
offline visualization. Closed-form rigid-transform inverses instead of 4x4
padding + np.linalg.inv, and paths generated vectorized over the whole
angle array.

Pose convention (same as the reference / LLFF): a pose is a (3,5) block
[R | t | hwf] where R's columns are the camera x/y/z axes in world space,
z is the viewing direction, and hwf = (height, width, focal).
"""

from __future__ import annotations

import numpy as np


def _unit(v: np.ndarray, axis: int = -1) -> np.ndarray:
    return v / np.linalg.norm(v, axis=axis, keepdims=True)


def frames_from_z_up(z: np.ndarray, up: np.ndarray) -> np.ndarray:
    """Orthonormal camera frames from viewing directions and an up hint.

    z: (..., 3) viewing directions; up: (..., 3) approximate up. Returns
    (..., 3, 3) rotations whose columns are [x, y, z] with x ⟂ up-plane
    (two Gram-Schmidt cross products, broadcast over leading axes).
    """
    z = _unit(np.asarray(z, np.float64))
    x = _unit(np.cross(np.broadcast_to(up, z.shape), z))
    y = _unit(np.cross(z, x))
    return np.stack([x, y, z], axis=-1)


def average_pose(poses: np.ndarray) -> np.ndarray:
    """Mean camera: mean center, mean viewing direction, mean up.

    poses: (N, 3, >=4). Returns (3, 4) [R | t].
    """
    center = poses[:, :3, 3].mean(0)
    R = frames_from_z_up(poses[:, :3, 2].sum(0), poses[:, :3, 1].sum(0))
    return np.concatenate([R, center[:, None]], axis=1)


def recenter_poses(poses: np.ndarray) -> np.ndarray:
    """Express all poses in the frame of their average camera.

    Same contract as the reference's recenter_poses (load_data.py:181-192)
    but via the closed-form rigid inverse — for avg = (Ra, ta):
    R_i' = Raᵀ R_i, t_i' = Raᵀ (t_i − ta). Extra columns (hwf) pass through.
    """
    poses = np.asarray(poses).copy()
    avg = average_pose(poses)
    Rat = avg[:, :3].T
    poses[:, :3, :3] = Rat @ poses[:, :3, :3]
    poses[:, :3, 3] = (poses[:, :3, 3] - avg[:, 3]) @ Rat.T
    return poses


def spiral_path(
    anchor: np.ndarray,
    up: np.ndarray,
    radii: np.ndarray,
    focus_depth: float,
    z_rate: float = 0.5,
    n_rotations: int = 2,
    n_poses: int = 120,
) -> np.ndarray:
    """Spiral of n_poses cameras around an anchor pose, all looking at a
    point focus_depth in front of it (behavior spec: load_data.py:166-179).

    anchor: (3, 4+) pose (extra columns appended to every output pose);
    radii: (3,) spiral extents in the anchor's local axes.
    """
    anchor = np.asarray(anchor, np.float64)
    R, t = anchor[:3, :3], anchor[:3, 3]
    theta = np.linspace(0.0, 2.0 * np.pi * n_rotations, n_poses,
                        endpoint=False)
    # local-frame offsets, one row per pose
    local = np.stack(
        [np.cos(theta), -np.sin(theta), -np.sin(theta * z_rate)], axis=-1
    ) * np.asarray(radii)
    centers = t + local @ R.T
    target = t + R @ np.array([0.0, 0.0, -focus_depth])
    frames = frames_from_z_up(centers - target, up)
    out = np.concatenate([frames, centers[:, :, None]], axis=-1)
    if anchor.shape[1] > 4:
        extra = np.broadcast_to(anchor[:, 4:], (n_poses,) + anchor[:, 4:].shape)
        out = np.concatenate([out, extra], axis=-1)
    return out.astype(np.float32)


def rays_focus_point(origins: np.ndarray, dirs: np.ndarray) -> np.ndarray:
    """Least-squares point minimizing squared distance to a bundle of rays.

    For unit directions d, the distance projector is P_i = I − d_i d_iᵀ;
    the minimizer solves (Σ P_i) x = Σ P_i o_i.
    """
    d = _unit(np.asarray(dirs, np.float64))
    P = np.eye(3) - d[:, :, None] * d[:, None, :]
    return np.linalg.solve(P.mean(0), (P @ origins[:, :, None]).mean(0)[:, 0])


def spherify_path(poses: np.ndarray, bounds: np.ndarray, n_poses: int = 120):
    """Rebase an inward-facing capture onto the unit sphere around its focus
    point and emit a circular render path at the capture's mean height
    (behavior spec: load_data.py:194-260).

    poses: (N, 3, 5). Returns (poses_reset, path_poses, bounds) with the
    original hwf column appended to both pose sets.
    """
    poses = np.asarray(poses, np.float64)
    focus = rays_focus_point(poses[:, :3, 3], poses[:, :3, 2])

    # world frame: z along the mean camera offset from the focus point
    z_w = _unit((poses[:, :3, 3] - focus).mean(0))
    Rt = frames_from_z_up(z_w, _arbitrary_perpendicular(z_w)).T
    centers = (poses[:, :3, 3] - focus) @ Rt.T
    rots = np.einsum("ab,nbc->nac", Rt, poses[:, :3, :3])

    scale = 1.0 / np.sqrt((centers ** 2).sum(-1).mean())
    centers *= scale
    bounds = np.asarray(bounds) * scale

    # circle at the captures' mean height, radius completing the unit sphere
    zh = centers[:, 2].mean()
    r_circle = np.sqrt(max(1.0 - zh ** 2, 1e-12))
    theta = np.linspace(0.0, 2.0 * np.pi, n_poses)
    ring = np.stack(
        [r_circle * np.cos(theta), r_circle * np.sin(theta),
         np.full_like(theta, zh)], axis=-1
    )
    # The reference builds ring frames with vec0 = cross(z, up), up = -e3
    # (load_data.py:246-250); frames_from_z_up uses x = cross(up, z), so the
    # equivalent up hint here is +e3 (cross(e3, z) == cross(z, -e3)).
    ring_frames = frames_from_z_up(ring, np.array([0.0, 0.0, 1.0]))

    hwf = poses[0, :3, 4:5]
    path = np.concatenate(
        [ring_frames, ring[:, :, None],
         np.broadcast_to(hwf, (n_poses, 3, 1))], axis=-1
    )
    reset = np.concatenate(
        [rots, centers[:, :, None], np.broadcast_to(hwf, rots.shape[:1] + (3, 1))],
        axis=-1,
    )
    return reset.astype(np.float32), path.astype(np.float32), bounds


def _arbitrary_perpendicular(v: np.ndarray) -> np.ndarray:
    """A stable up-hint not parallel to v: the world axis v points along
    least (so the cross product in frames_from_z_up is well-conditioned)."""
    axis = np.argmin(np.abs(v))
    return np.eye(3)[axis]


def regenerate_pose(
    poses: np.ndarray,
    bounds: np.ndarray,
    recenter: bool = True,
    bd_factor: float = 0.75,
    spherify: bool = False,
    path_zflat: bool = False,
) -> np.ndarray:
    """Render-path set from a captured pose bundle (behavior spec:
    load_data.py:390-439): 120-pose spiral around the average camera, or a
    spherified circle; z-flat halves the count and pins the spiral height."""
    poses = np.asarray(poses, np.float64)
    if recenter:
        poses = recenter_poses(poses)
    if spherify:
        return spherify_path(poses, bounds)[1]

    anchor = np.concatenate([average_pose(poses), poses[0, :3, 4:5]], axis=1)
    up = _unit(poses[:, :3, 1].sum(0))
    near, far = bounds.min() * 0.9, bounds.max() * 5.0
    # focus plane between near and far, weighted toward near (LLFF dt=0.75)
    dt = 0.75
    focus_depth = 1.0 / ((1.0 - dt) / near + dt / far)
    radii = np.percentile(np.abs(poses[:, :3, 3]), 90, axis=0)
    n_rot, n_poses = 2, 120
    if path_zflat:
        anchor[:3, 3] -= 0.1 * near * anchor[:3, 2]
        radii[2] = 0.0
        n_rot, n_poses = 1, 60
    return spiral_path(anchor, up, radii, focus_depth,
                       z_rate=0.5, n_rotations=n_rot, n_poses=n_poses)

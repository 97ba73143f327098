"""Trajectory quality metrics: ATE / RPE and the reprojection-flow error of
the recovered spline poses.

The port's copy of benerf_tpu/eval/pose_metrics.py (numpy). The reference
only dumps KITTI files for external evaluation (utils/pose_utils.py); these
report pose recovery directly against a synthetic scene's ground-truth
trajectory. ATE and RPE align the estimate to the ground truth with a
similarity transform first (monocular NeRF trajectories are gauge-free:
arbitrary global rotation/translation/scale).
"""

from __future__ import annotations

import numpy as np


def _umeyama(src, dst):
    """Similarity transform (s, R, t) minimizing |dst - (s R src + t)|^2."""
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_s = (xs**2).sum() / len(src)
    s = np.trace(np.diag(D) @ S) / (var_s + 1e-12)
    t = mu_d - s * R @ mu_s
    return s, R, t


def align_trajectories(est, gt):
    """est, gt: (N,3,4). Returns est aligned to gt (similarity transform on
    translations, rotation applied to orientations)."""
    est = np.asarray(est)
    gt = np.asarray(gt)
    s, R, t = _umeyama(est[:, :, 3], gt[:, :, 3])
    out = est.copy()
    out[:, :, 3] = (s * (R @ est[:, :, 3].T)).T + t
    out[:, :, :3] = R @ est[:, :, :3]
    return out


def ate_rmse(est, gt, align=True):
    """Absolute trajectory error (RMSE of translation) after alignment."""
    est = np.asarray(est)
    gt = np.asarray(gt)
    if align:
        est = align_trajectories(est, gt)
    d = est[:, :, 3] - gt[:, :, 3]
    return float(np.sqrt(np.mean(np.sum(d * d, axis=-1))))


def _rot_angle(R):
    tr = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    return np.degrees(np.arccos(tr))


def _compose(A, B):
    """Rigid compose of (3,4) poses: A o B."""
    R = A[:, :3] @ B[:, :3]
    t = A[:, :3] @ B[:, 3] + A[:, 3]
    return np.concatenate([R, t[:, None]], axis=1)


def _inv(A):
    R = A[:, :3].T
    t = -R @ A[:, 3]
    return np.concatenate([R, t[:, None]], axis=1)


def reproj_flow_error(est, gt, K, plane_depth, H, W, n_grid=5):
    """Gauge-fixed pixel-space trajectory error — the recovery metric.

    ATE/RPE under similarity alignment degenerate for the short, near-straight
    trajectories of a single exposure (any two smooth arcs align closely).
    What BeNeRF must actually recover is the *apparent motion*: the warp the
    trajectory induces on the image, which is what synthesizes the blur and
    the events. So: anchor both trajectories at the mid-exposure pose (rigid
    alignment, no scale — the shared gauge), push a pixel grid at plane_depth
    through every pose pair, and measure the pixel disagreement.

    Returns {"flow_rmse_px", "gt_flow_rms_px"}: a do-nothing (constant)
    estimate scores flow_rmse_px ~= gt_flow_rms_px (the motion magnitude);
    a recovered trajectory scores far below it.
    """
    est = np.asarray(est, np.float64)
    gt = np.asarray(gt, np.float64)
    K = np.asarray(K, np.float64)
    m = len(gt) // 2
    G = _compose(gt[m], _inv(est[m]))
    est_al = np.stack([_compose(G, e) for e in est])

    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    uu, vv = np.meshgrid(
        np.linspace(0.15, 0.85, n_grid) * W,
        np.linspace(0.15, 0.85, n_grid) * H,
    )
    # camera-frame points at plane_depth through the mid GT pose (OpenGL
    # convention: x right, y up, looking down -z — render/rays.py)
    dirs = np.stack(
        [(uu - cx) / fx, -(vv - cy) / fy, -np.ones_like(uu)], axis=-1
    ).reshape(-1, 3)
    pts = gt[m][:, 3] + (dirs * plane_depth) @ gt[m][:, :3].T

    def project(P, pts):
        pc = (pts - P[:, 3]) @ P[:, :3]
        z = np.maximum(-pc[:, 2], 1e-9)
        return np.stack(
            [fx * pc[:, 0] / z + cx, -fy * pc[:, 1] / z + cy], axis=-1
        )

    base = project(gt[m], pts)
    errs, mags = [], []
    for i in range(len(gt)):
        uv_g = project(gt[i], pts)
        errs.append(np.linalg.norm(project(est_al[i], pts) - uv_g, axis=-1))
        mags.append(np.linalg.norm(uv_g - base, axis=-1))
    rms = lambda x: float(np.sqrt(np.mean(np.square(np.stack(x)))))
    return {"flow_rmse_px": rms(errs), "gt_flow_rms_px": rms(mags)}


def rpe(est, gt, delta: int = 1, align=True):
    """Relative pose error over pose pairs (i, i+delta).

    Returns dict with trans_rmse (same units as gt) and rot_rmse_deg.
    """
    est = np.asarray(est)
    gt = np.asarray(gt)
    if align:
        est = align_trajectories(est, gt)

    def rel(poses, i, j):
        Ri, ti = poses[i, :, :3], poses[i, :, 3]
        Rj, tj = poses[j, :, :3], poses[j, :, 3]
        R = Ri.T @ Rj
        t = Ri.T @ (tj - ti)
        return R, t

    terrs, rerrs = [], []
    for i in range(len(est) - delta):
        Re, te = rel(est, i, i + delta)
        Rg, tg = rel(gt, i, i + delta)
        terrs.append(np.linalg.norm(te - tg))
        rerrs.append(_rot_angle(Re.T @ Rg))
    return {
        "trans_rmse": float(np.sqrt(np.mean(np.square(terrs)))),
        "rot_rmse_deg": float(np.sqrt(np.mean(np.square(rerrs)))),
    }

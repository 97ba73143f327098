"""Kannala-Brandt fisheye undistortion lookup tables (host precompute).

The port's copy of benerf_tpu/data/undistort.py. The reference builds
per-pixel (H, W, 2) undistorted-coordinate LUTs with OpenCV once at startup
and indexes them during ray generation for TUM_VIE (reference
undistort.py:73-87,128-142; run_nerf_helpers.py:17-23). A one-time host
computation, so it stays numpy: the Kannala-Brandt model directly (Newton
inversion of theta_d = theta (1 + k1 th^2 + k2 th^4 + k3 th^6 + k4 th^8)),
with cv2.fisheye used where it is installed (a lazy import; the Newton path
runs where it is absent).
"""

from __future__ import annotations

import numpy as np


def _kb_undistort_points(pts, K, D, iters: int = 10):
    """Invert the Kannala-Brandt projection for (N,2) pixel coords."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    k1, k2, k3, k4 = D
    x = (pts[:, 0] - cx) / fx
    y = (pts[:, 1] - cy) / fy
    theta_d = np.sqrt(x * x + y * y)
    theta_d_clip = np.clip(theta_d, -np.pi / 2, np.pi / 2)

    theta = theta_d_clip.copy()
    for _ in range(iters):  # Newton: f(th) = th(1+k1 th^2+...) - theta_d
        t2 = theta * theta
        poly = 1 + k1 * t2 + k2 * t2**2 + k3 * t2**3 + k4 * t2**4
        dpoly = 1 + 3 * k1 * t2 + 5 * k2 * t2**2 + 7 * k3 * t2**3 + 9 * k4 * t2**4
        f = theta * poly - theta_d_clip
        theta = theta - f / np.maximum(dpoly, 1e-9)

    scale = np.where(theta_d > 1e-9, np.tan(theta) / np.maximum(theta_d, 1e-9), 1.0)
    return x * scale, y * scale


def undistort_lut(width: int, height: int, K, D, use_opencv: bool = True):
    """(H, W, 2) float32 LUT of undistorted pixel coordinates, re-projected
    with the same K (P=K), matching UndistortImageCoordinate /
    UndistortStreamEventsCoordinate (undistort.py:73-87,128-142)."""
    K = np.asarray(K, np.float64)
    D = np.asarray(D, np.float64)
    xs, ys = np.meshgrid(np.arange(width), np.arange(height))
    cv = None
    if use_opencv:
        try:
            import cv2 as cv
        except ImportError:
            cv = None
    if cv is not None:
        pts = np.stack((xs, ys), axis=-1).astype(np.float32)
        out = cv.fisheye.undistortPoints(
            distorted=pts, K=K, D=D.reshape(4, 1), R=np.eye(3), P=K
        )
        return out.astype(np.float32)
    flat = np.stack([xs.ravel(), ys.ravel()], axis=-1).astype(np.float64)
    xn, yn = _kb_undistort_points(flat, K, D)
    u = K[0, 0] * xn + K[0, 2]
    v = K[1, 1] * yn + K[1, 2]
    return np.stack([u, v], axis=-1).reshape(height, width, 2).astype(np.float32)


def intrinsics_matrix(fx, fy, cx, cy) -> np.ndarray:
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)


def luts_for_config(cfg):
    """(img_remap, evt_remap) for TUM_VIE configs; (None, None) otherwise.

    Mirrors train.py:66-74 / test.py:37-44.
    """
    if cfg.dataset != "TUM_VIE":
        return None, None
    K_rgb = intrinsics_matrix(cfg.rgb_fx, cfg.rgb_fy, cfg.rgb_cx, cfg.rgb_cy)
    K_evt = intrinsics_matrix(cfg.event_fx, cfg.event_fy, cfg.event_cx, cfg.event_cy)
    img = undistort_lut(int(cfg.rgb_width), int(cfg.rgb_height), K_rgb, cfg.rgb_dist)
    evt = undistort_lut(cfg.event_width, cfg.event_height, K_evt, cfg.event_dist)
    return img, evt

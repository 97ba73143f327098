"""Data-driven trajectory initialization: motion-scale-calibrated random knots.

Port of benerf_tpu/train/pose_init.py: numpy, with the spline of the
port's geometry/spline on CPU float32 tensors. The knots are drawn by numpy
from the seed, so both packages draw the same ones.

Why (ANALYSIS_pose_recovery.md): the reference initializes the spline knots
at U(0, 0.01) (model/optimize.py:22-24) — a near-zero trajectory. From
there, BOTH this framework and the torch reference fall into a degenerate
minimum where the NeRF absorbs the event signal as micro-structure and pose
gradients die (verified by the round-4 oracle + gradient attribution). The
basin of the true trajectory, however, is wide in DIRECTION and narrow in
SCALE: an init at the right order of magnitude converges even with the
direction fully randomized (DIAG_r04 variants G/I/J: 30/60/100% perturbed
GT all recover, flow 1.8 -> 0.14-0.60 px), while a near-zero init never
escapes (80k-iteration protocol run: 1.8 -> 1.58 px).

This module estimates that scale FROM THE DATA (no ground truth):

1. Apparent motion, in pixels, from brightness-constancy bookkeeping:
   an edge sweeping d pixels past a pixel fires |grad log I| * d / C events,
   so  d_px ~ C * (total |polarity|) / (total |grad log I|)  — both sums
   over the observed (blurry) image / full event stream.
2. A random rotation-dominant knot set (real exposure shake is mostly
   rotation) is rescaled so its worst-case angular sweep, projected at the
   focal length, covers d_px:  rotation flow = fx * angle, depth-free.

Off by default (pose_init="reference" keeps reference behavior); enable
with pose_init="motion_scale". This is a deliberate, documented deviation —
the reference has no counterpart and cannot recover the trajectory on
scenes of this event density (see the oracle artifacts).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from benerf_tpu_torch.data import events as events_mod
from benerf_tpu_torch.geometry import spline as spline_mod


def estimate_motion_px(eta_total: np.ndarray, image: np.ndarray,
                       event_threshold: float, eps: float = 1e-3) -> float:
    """Apparent exposure-time motion magnitude in pixels.

    Args:
      eta_total: (H, W) sum of |polarity| per event pixel over the FULL
        stream (host-side accumulate of the loaded events).
      image: (H, W, C) observed blurry image in [0, 1] (RGB camera; assumed
        geometrically close to the event camera, as in all shipped configs).
      event_threshold: contrast threshold C (use a nominal 0.1-0.2 when the
        dataset's threshold is -1/unknown).
    """
    C = abs(float(event_threshold))
    if C <= 0 or not np.isfinite(C):
        C = 0.1
    gray = image.mean(axis=-1) if image.ndim == 3 else image
    logi = np.log(np.clip(gray, eps, None))
    gy, gx = np.gradient(logi)
    grad_mag = np.hypot(gx, gy)
    total_events = float(np.abs(eta_total).sum())
    total_grad = float(grad_mag.sum())
    if total_grad <= 0 or total_events <= 0:
        return 0.0
    return C * total_events / total_grad


def _max_angle(knots: np.ndarray, n: int = 9) -> float:
    """Max geodesic angle (radians) between any pose orientation and the
    first, sampled along the spline over [0, 1]."""
    us = np.linspace(0.0, 1.0, n)
    poses = spline_mod.cubic_bspline_pose(
        torch.as_tensor(np.asarray(knots), dtype=torch.float32),
        torch.as_tensor(us, dtype=torch.float32)).numpy()
    R0 = poses[0, :, :3]
    worst = 0.0
    for p in poses[1:]:
        R = R0.T @ p[:, :3]
        c = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
        worst = max(worst, float(np.arccos(c)))
    return worst


def motion_scale_knots(seed: int, d_px: float, focal: float,
                       rot_trans_ratio: float = 5.0) -> np.ndarray:
    """(4, 6) random rotation-dominant se(3) knots whose angular sweep
    projects to ~d_px pixels at `focal` (rotation flow = focal * angle,
    independent of scene depth)."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(1, 6))
    deltas = np.cumsum(rng.normal(size=(4, 6)), axis=0)
    knots = (base + deltas).astype(np.float32)
    knots[:, 3:] /= rot_trans_ratio
    if d_px <= 0 or focal <= 0:
        return (knots * 0.01).astype(np.float32)
    target_angle = d_px / focal
    for _ in range(2):  # exp of a scaled tangent is near-linear here
        ang = _max_angle(knots)
        if ang < 1e-9:
            break
        knots = (knots * (target_angle / ang)).astype(np.float32)
    return knots


def initial_knots(cfg, scene) -> Tuple[np.ndarray, float]:
    """Motion-scale init for a loaded scene (host-side).

    Returns (knots (4,6) float32, estimated apparent motion d_px)."""
    pix = scene.events.pix_idx.cpu().numpy()
    eta = events_mod.accumulate_events_numpy(
        pix % cfg.event_width, pix // cfg.event_width,
        np.abs(scene.events.pol.cpu().numpy()),
        cfg.event_height, cfg.event_width,
    )
    d_px = estimate_motion_px(eta, scene.image[0], cfg.event_threshold)
    knots = motion_scale_knots(cfg.seed, d_px, float(cfg.rgb_fx))
    return knots, d_px

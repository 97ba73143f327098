"""BeNeRF losses: event log-brightness-difference + blur-synthesis RGB MSE.

Port of benerf_tpu/train/loss.py (reference train.py:204-331):
  event (synthetic, threshold C > 0):
      MSE( log I(t_end) - log I(t_start),  ETA * C ) * event_coeff_syn
  event (real, threshold == -1):
      MSE( normalize(dlog I), normalize(ETA) ) * event_coeff_real, the L2
      norm taken over the RAY axis;
  rgb: MSE( mean over the N virtual poses of rendered sharp rays,
            observed blurry pixels ) * rgb_coeff;
  both applied to the coarse (rgb0) and fine (rgb_map) outputs.
"""

from __future__ import annotations

import functools
import math

import torch

GRAY_WEIGHTS = (0.299, 0.587, 0.114)  # ITU-R BT.601


@functools.lru_cache(maxsize=None)
def _gray_weights(device, dtype):
    """GRAY_WEIGHTS as a tensor, made once per device and dtype: a step
    captured in a CUDA graph may not copy from the host."""
    return torch.tensor(GRAY_WEIGHTS, device=device, dtype=dtype)


def rgb_to_gray(rgb):
    """(..., 3) -> (..., 1) luma."""
    return torch.sum(rgb * _gray_weights(rgb.device, rgb.dtype), dim=-1,
                     keepdim=True)


def safe_log(x, eps: float = 1e-9):
    return torch.log(x + eps)


def lin_log(color, linlog_thres: float = 20.0):
    """Linear below threshold (on a 0..255 scale), log above."""
    c = color * 255.0
    lin_slope = math.log(linlog_thres + 1e-9) / linlog_thres
    return torch.where(c < linlog_thres, lin_slope * c, torch.log(c + 1e-9))


def brightness_log(x, dataset: str):
    """rgb2brightlog dispatch (reference utils/math_utils.py:18-23)."""
    if dataset in ("BeNeRF_Blender", "BeNeRF_Unreal"):
        return safe_log(x)
    if dataset in ("E2NeRF_Synthetic", "E2NeRF_Real"):
        return lin_log(x)
    raise ValueError(f"no brightness log map for dataset {dataset!r}")


def mse(a, b):
    return torch.mean((a - b) ** 2)


def event_loss_term(bright_start, bright_end, eta_target, *, dataset: str,
                    channels: int, event_threshold: float, coeff_syn: float,
                    coeff_real: float):
    """One event-loss term (coarse OR fine). bright_*: (R, C) rendered
    intensities at the window ends; eta_target: (R, 1)."""
    if channels == 3:
        bright_start = rgb_to_gray(bright_start)
        bright_end = rgb_to_gray(bright_end)
    diff = brightness_log(bright_end, dataset) - brightness_log(bright_start, dataset)
    if event_threshold > 0:  # synthetic
        return mse(diff, eta_target * event_threshold) * coeff_syn
    diff_n = diff / (torch.linalg.norm(diff, dim=0, keepdim=True) + 1e-9)
    tgt_n = eta_target / (torch.linalg.norm(eta_target, dim=0, keepdim=True) + 1e-9)
    return mse(diff_n, tgt_n) * coeff_real


def blur_rgb_loss_term(rgb_per_pose, target, rgb_coeff: float):
    """rgb_per_pose: (P*R, C) pose-major rendered rays; target: (R, C)."""
    R = target.shape[0]
    P = rgb_per_pose.shape[0] // R
    synth = torch.mean(rgb_per_pose.reshape(P, R, -1), dim=0)
    return mse(synth, target) * rgb_coeff

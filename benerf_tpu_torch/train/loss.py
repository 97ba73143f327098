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

Under a mesh (parallel/mesh.py) each rank holds its block of the global ray
axis and each term is its share of the global term: the mean over its rows
times its share of the rows, so the ranks' terms sum to the unsharded one
(and, at one rank, are it bit for bit). The real-data norm is over the
global ray axis: the rendered difference's through a differentiable
all-reduce, the target's from the global target every rank holds.
"""

from __future__ import annotations

import functools
import math

import torch

from benerf_tpu_torch.parallel import mesh as mesh_mod

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
                    coeff_real: float, mesh=None, eta_all=None):
    """One event-loss term (coarse OR fine). bright_*: (R, C) rendered
    intensities at the window ends; eta_target: (R, 1). Under a mesh the R
    rows are this rank's and eta_all (R_all, 1) is the global target: the
    term is this rank's share of the global one."""
    if channels == 3:
        bright_start = rgb_to_gray(bright_start)
        bright_end = rgb_to_gray(bright_end)
    diff = brightness_log(bright_end, dataset) - brightness_log(bright_start, dataset)
    if event_threshold > 0:  # synthetic
        loss = mse(diff, eta_target * event_threshold) * coeff_syn
    elif mesh is None:
        diff_n = diff / (torch.linalg.norm(diff, dim=0, keepdim=True) + 1e-9)
        tgt_n = eta_target / (torch.linalg.norm(eta_target, dim=0, keepdim=True) + 1e-9)
        loss = mse(diff_n, tgt_n) * coeff_real
    else:
        sq = mesh_mod.all_reduce_sum(torch.sum(diff * diff, dim=0, keepdim=True),
                                     mesh)
        diff_n = diff / (torch.sqrt(sq) + 1e-9)
        tgt_n = eta_target / (torch.linalg.norm(eta_all, dim=0, keepdim=True) + 1e-9)
        loss = mse(diff_n, tgt_n) * coeff_real
    return _share(loss, eta_target.shape[0],
                  None if eta_all is None else eta_all.shape[0])


def blur_rgb_loss_term(rgb_per_pose, target, rgb_coeff: float, n_all=None):
    """rgb_per_pose: (P*R, C) pose-major rendered rays; target: (R, C).
    Under a mesh the R pixels are this rank's of n_all: the term is this
    rank's share of the global one."""
    R = target.shape[0]
    P = rgb_per_pose.shape[0] // R
    synth = torch.mean(rgb_per_pose.reshape(P, R, -1), dim=0)
    return _share(mse(synth, target) * rgb_coeff, R, n_all)


def _share(loss, n, n_all):
    """A mean over n of n_all rows as its part of the mean over all: the
    mean times n / n_all (the mean itself when n_all is None)."""
    return loss if n_all is None else loss * (n / n_all)

"""Image quality metrics: MSE / PSNR / SSIM (numpy + scipy) and LPIPS
(gated on its weights).

The port's copy of benerf_tpu/eval/metrics.py; scipy is a lazy import
inside `ssim`. Reference protocol (reference metrics.py:21-100): images are
mapped from [0,1] to [-1,1] before computing. With skimage's inferred
data_range=2.0 for float input, PSNR on [-1,1] equals standard PSNR on [0,1]
(MSE and L^2 scale together); SSIM is NOT shift-invariant, so it is
evaluated on the same [-1,1] domain with data_range=2 to match the
reference's numbers.

Deviation (documented): the reference calls structural_similarity with
channel_axis=1 on (H, W, C) arrays, treating image COLUMNS as channels
(metrics.py:87); this uses channel_axis=-1 (the evident intent). SSIM
window, filter and constants otherwise replicate skimage defaults:
win_size=7, uniform filter, K1=0.01, K2=0.03, sample-covariance
normalization.
"""

from __future__ import annotations

import numpy as np


def to_pm1(x):
    return np.clip(np.asarray(x, np.float64) * 2.0 - 1.0, -1.0, 1.0)


def mse(im1, im2):
    a, b = to_pm1(im1), to_pm1(im2)
    return float(np.mean((a - b) ** 2))


def psnr(im1, im2):
    """PSNR with data_range=2 on [-1,1] == PSNR with range 1 on [0,1]."""
    m = mse(im1, im2)
    if m == 0:
        return float("inf")
    return float(10.0 * np.log10(4.0 / m))


def _ssim_single(a, b, data_range=2.0, win_size=7, K1=0.01, K2=0.03):
    """skimage-compatible single-channel SSIM (uniform filter)."""
    from scipy.ndimage import uniform_filter

    a = a.astype(np.float64)
    b = b.astype(np.float64)
    NP = win_size**2
    cov_norm = NP / (NP - 1)

    filt = lambda x: uniform_filter(x, size=win_size)
    ux, uy = filt(a), filt(b)
    uxx, uyy, uxy = filt(a * a), filt(b * b), filt(a * b)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    C1 = (K1 * data_range) ** 2
    C2 = (K2 * data_range) ** 2
    S = ((2 * ux * uy + C1) * (2 * vxy + C2)) / (
        (ux**2 + uy**2 + C1) * (vx + vy + C2)
    )
    pad = (win_size - 1) // 2
    return S[pad:-pad, pad:-pad].mean(), S


def ssim(im1, im2, full=False):
    """(H,W) or (H,W,C) SSIM on the reference's [-1,1] domain."""
    a, b = to_pm1(im1), to_pm1(im2)
    if a.ndim == 2:
        a, b = a[..., None], b[..., None]
    vals, maps = [], []
    for c in range(a.shape[-1]):
        v, m = _ssim_single(a[..., c], b[..., c])
        vals.append(v)
        maps.append(m)
    mean = float(np.mean(vals))
    if full:
        return mean, np.stack(maps, -1)
    return mean


def lpips(im1, im2, weights_path=None):
    """LPIPS (AlexNet/VGG) via the torch implementation in eval/lpips_torch.

    Requires pretrained weights on disk (zero-egress container); returns None
    with a warning if unavailable. Reference: metrics.py:36,90-99.
    """
    from benerf_tpu_torch.eval import lpips_torch

    try:
        return lpips_torch.compute(im1, im2, weights_path=weights_path)
    except FileNotFoundError as e:  # no weights on this machine
        import warnings

        warnings.warn(f"LPIPS unavailable: {e}")
        return None


def _apply_margin(im, margin):
    """Crop a fractional margin (metrics.py:67-71 semantics)."""
    h, w = im.shape[:2]
    mh = int(h * margin) + 1
    mw = int(w * margin) + 1
    return im[mh : h - mh, mw : w - mw]


def compute_img_metric(im1, im2, metric: str = "mse", margin: float = 0,
                       mask=None, **kw):
    """Reference-compatible entry point (metrics.py:21-100) incl. the
    optional fractional margin crop and pixel mask."""
    im1 = np.asarray(im1, np.float64)
    im2 = np.asarray(im2, np.float64)
    if im1.ndim == 4:  # tolerate a leading batch dim of 1
        im1, im2 = im1[0], im2[0]
    if margin > 0:
        im1 = _apply_margin(im1, margin)
        im2 = _apply_margin(im2, margin)
        if mask is not None:
            mask = _apply_margin(np.asarray(mask), margin)

    if metric in ("mse", "psnr"):
        if mask is not None:
            m = np.asarray(mask, bool)
            if m.ndim == im1.ndim - 1:
                m = m[..., None]
            a = np.where(m, im1, 0.0)
            b = np.where(m, im2, 0.0)
            value = psnr(a, b) if metric == "psnr" else mse(a, b)
            if metric == "psnr":
                # reference's pixel-count correction (metrics.py:82-85)
                h, w = im1.shape[:2]
                value -= 10 * np.log10(h * w / max(m[..., 0].sum(), 1))
            return value
        return psnr(im1, im2) if metric == "psnr" else mse(im1, im2)
    if metric == "ssim":
        if mask is not None:
            mean, smap = ssim(im1, im2, full=True)
            m = np.asarray(mask, float)
            if m.ndim == smap.ndim - 1:
                m = m[..., None]
            return float((smap * m).sum() / (m.sum() * smap.shape[-1]))
        return ssim(im1, im2)
    if metric == "lpips":
        return lpips(im1, im2, **kw)
    raise ValueError(f"metric {metric!r} not recognized")

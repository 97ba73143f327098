"""BRISQUE no-reference image quality (feature pipeline + gated scorer).

The port's copy of benerf_tpu/eval/brisque.py (host numpy; scipy imported
lazily, as in eval/metrics.py). The reference computes BRISQUE in MATLAB
(reference eval_brisque.m) for the real-capture datasets, where no sharp
ground truth exists. The features are the standard BRISQUE pipeline: MSCN
coefficients and asymmetric generalized-Gaussian fits over 2 scales -> 36
features. The score needs a trained SVR model (libsvm text format, as the
original BRISQUE release and OpenCV ship it), which cannot be downloaded
here: `score` returns None when no model file is given and
BENERF_BRISQUE_MODEL is unset or names no file, the same gate as LPIPS.
Any other error raises.
"""

from __future__ import annotations

import os

import numpy as np


def _gamma():
    from scipy.special import gamma

    return gamma


def _mscn(gray, sigma=7.0 / 6.0):
    """Mean-subtracted contrast-normalized coefficients."""
    from scipy.ndimage import gaussian_filter

    mu = gaussian_filter(gray, sigma, truncate=3.0)
    mu_sq = mu * mu
    var = gaussian_filter(gray * gray, sigma, truncate=3.0) - mu_sq
    sigma_map = np.sqrt(np.abs(var))
    return (gray - mu) / (sigma_map + 1.0)


def _aggd_fit(x):
    """Asymmetric generalized Gaussian fit -> (alpha, left_std, right_std)."""
    x = x.ravel()
    left = x[x < 0]
    right = x[x >= 0]
    lsq = np.sqrt(np.mean(left**2)) if left.size else 1e-6
    rsq = np.sqrt(np.mean(right**2)) if right.size else 1e-6
    gamma_hat = lsq / (rsq + 1e-12)
    r_hat = (np.mean(np.abs(x)) ** 2) / (np.mean(x**2) + 1e-12)
    R_hat = r_hat * (gamma_hat**3 + 1) * (gamma_hat + 1) / (
        (gamma_hat**2 + 1) ** 2
    )

    G = _gamma()
    gam = np.arange(0.2, 10.001, 0.001)
    r_gam = (G(2.0 / gam) ** 2) / (G(1.0 / gam) * G(3.0 / gam))
    alpha = gam[np.argmin((r_gam - R_hat) ** 2)]
    return alpha, lsq, rsq


def _ggd_fit(x):
    """Symmetric GGD fit -> (alpha, sigma)."""
    x = x.ravel()
    sigma_sq = np.mean(x**2)
    E = np.mean(np.abs(x))
    rho = sigma_sq / (E**2 + 1e-12)

    G = _gamma()
    gam = np.arange(0.2, 10.001, 0.001)
    rho_gam = G(1.0 / gam) * G(3.0 / gam) / (G(2.0 / gam) ** 2)
    alpha = gam[np.argmin((rho_gam - rho) ** 2)]
    return alpha, np.sqrt(sigma_sq)


def features(img) -> np.ndarray:
    """36-dim BRISQUE feature vector from an image in [0, 1] (gray or RGB)."""
    G = _gamma()
    img = np.asarray(img, np.float64)
    if img.ndim == 3:
        img = img @ np.array([0.299, 0.587, 0.114])
    img = img * 255.0

    feats = []
    for _ in range(2):
        mscn = _mscn(img)
        alpha, sigma = _ggd_fit(mscn)
        feats += [alpha, sigma**2]
        for dy, dx in ((0, 1), (1, 0), (1, 1), (1, -1)):
            shifted = np.roll(np.roll(mscn, dy, axis=0), dx, axis=1)
            a, ls, rs = _aggd_fit(mscn * shifted)
            mean = (rs - ls) * (G(2.0 / a) / G(1.0 / a))
            feats += [a, mean, ls**2, rs**2]
        img = img[::2, ::2]  # next scale
    return np.asarray(feats)


def score(img, model_path=None):
    """BRISQUE score (lower = better) via a libsvm epsilon-SVR model file,
    or None when no model file is available."""
    model_path = model_path or os.environ.get("BENERF_BRISQUE_MODEL")
    if not model_path or not os.path.exists(model_path):
        return None
    return _svr_predict(_load_libsvm_model(model_path), features(img))


def _load_libsvm_model(path):
    """Minimal libsvm model parser (epsilon_svr, rbf kernel)."""
    header = {}
    svs = []
    coefs = []
    with open(path) as f:
        lines = iter(f.read().splitlines())
        for line in lines:
            if line.startswith("SV"):
                break
            parts = line.split()
            header[parts[0]] = parts[1:]
        for line in lines:
            if not line.strip():
                continue
            parts = line.split()
            coefs.append(float(parts[0]))
            vec = {}
            for kv in parts[1:]:
                k, v = kv.split(":")
                vec[int(k)] = float(v)
            svs.append(vec)
    dim = max(max(v) for v in svs if v)
    sv_mat = np.zeros((len(svs), dim))
    for i, vec in enumerate(svs):
        for k, v in vec.items():
            sv_mat[i, k - 1] = v
    return {
        "gamma": float(header.get("gamma", [1.0])[0]),
        "rho": float(header.get("rho", [0.0])[0]),
        "coefs": np.asarray(coefs),
        "svs": sv_mat,
    }


def _svr_predict(model, x):
    d = model["svs"] - x[None, : model["svs"].shape[1]]
    k = np.exp(-model["gamma"] * np.sum(d * d, axis=1))
    return float(model["coefs"] @ k - model["rho"])

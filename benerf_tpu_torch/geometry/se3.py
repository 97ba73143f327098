"""SE(3) / SO(3) / quaternion math, numerically safe under autograd.

Port of benerf_tpu/geometry/se3.py; the reference math is the original
BeNeRF spline.py:
  - quaternions are stored xyzw;
  - exp map of a rotation vector w uses theta = |w|/2;
  - log map returns a rotation vector r with |r| = full angle;
  - V-matrix form of the se(3) exp/log.

Every branchy small-angle function uses the "double-where" trick: torch
differentiates both branches of torch.where, so the unselected branch must
compute finite values, else 0 * NaN = NaN reaches the gradient. The rgb <->
event transform starts at exactly zero, which is where x / |x| would fault.

Shapes: every function broadcasts over arbitrary leading batch dims.
"""

from __future__ import annotations

import math

import torch

EXP_EPS = 1e-9
LOG_EPS_THETA = 1e-20
LOG_EPS_W = 1e-10


def _safe(pred, x, safe_value=1.0):
    """Replace x by safe_value where pred, so the unselected branch of an
    outer torch.where computes finite values (and finite gradients)."""
    return torch.where(pred, torch.full_like(x, safe_value), x)


def safe_norm(x, dim=-1, keepdim=False):
    """L2 norm with finite (zero) gradient at x == 0."""
    return torch.sqrt(torch.sum(x * x, dim=dim, keepdim=keepdim) + 1e-30)


def skew(w):
    """(...,3) -> (...,3,3) skew-symmetric matrix."""
    w0, w1, w2 = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(w0)
    return torch.stack(
        [
            torch.stack([zero, -w2, w1], dim=-1),
            torch.stack([w2, zero, -w0], dim=-1),
            torch.stack([-w1, w0, zero], dim=-1),
        ],
        dim=-2,
    )


_TAYLOR_SWITCH = 1e-3  # theta below this -> series


def sinx_over_x(x):
    """sin(x)/x."""
    small = torch.abs(x) < _TAYLOR_SWITCH
    x2 = x * x
    series = 1.0 - x2 / 6.0 + (x2 * x2) / 120.0
    exact = torch.sin(x) / _safe(small, x)
    return torch.where(small, series, exact)


def one_minus_cos_over_x2(x):
    """(1-cos(x))/x^2."""
    small = torch.abs(x) < _TAYLOR_SWITCH
    x2 = x * x
    series = 0.5 - x2 / 24.0 + (x2 * x2) / 720.0
    exact = (1.0 - torch.cos(x)) / _safe(small, x2)
    return torch.where(small, series, exact)


def x_minus_sin_over_x3(x):
    """(x-sin(x))/x^3."""
    small = torch.abs(x) < _TAYLOR_SWITCH
    x2 = x * x
    series = 1.0 / 6.0 - x2 / 120.0 + (x2 * x2) / 5040.0
    exact = (x - torch.sin(x)) / _safe(small, x2 * x)
    return torch.where(small, series, exact)


def qmul(q1, q2):
    """Hamilton product q1 (x) q2, xyzw layout."""
    x1, y1, z1, w1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    x2, y2, z2, w2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        dim=-1,
    )


def qconj(q):
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def exp_r2q(r):
    """Rotation vector (full angle |r|) -> unit quaternion xyzw."""
    theta = 0.5 * safe_norm(r, keepdim=True)
    small = theta < EXP_EPS
    t2 = theta * theta
    lam_series = 0.5 - t2 / 12.0 + (t2 * t2) / 240.0
    lam_exact = torch.sin(theta) / (2.0 * _safe(small, theta))
    lam = torch.where(small, lam_series, lam_exact)
    qw_series = 1.0 - t2 / 2.0 + (t2 * t2) / 24.0
    qw = torch.where(small, qw_series, torch.cos(theta))
    return torch.cat([lam * r, qw], dim=-1)


def log_q2r(q):
    """Unit quaternion xyzw -> rotation vector (full angle)."""
    xyz = q[..., :3]
    w = q[..., 3:4]
    theta = safe_norm(xyz, keepdim=True)

    small_theta = theta < LOG_EPS_THETA
    small_w = torch.abs(w) < LOG_EPS_W

    theta_s = _safe(small_theta, theta)
    w_s = _safe(small_w, w)

    pi = torch.full_like(w, math.pi)
    lam_w0 = torch.where(w < 0, -pi, pi) / theta_s
    lam_series = 2.0 / w_s - 2.0 / 3.0 * (theta * theta) / (w_s * w_s * w_s)
    lam_exact = 2.0 * torch.atan(theta / w_s) / theta_s
    lam = torch.where(small_w, lam_w0,
                      torch.where(small_theta, lam_series, lam_exact))
    return lam * xyz


def q_to_R(q):
    """Unit quaternion xyzw -> (...,3,3) rotation matrix."""
    qb, qc, qd, qa = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack(
        [1 - 2 * (qc**2 + qd**2), 2 * (qb * qc - qa * qd), 2 * (qa * qc + qb * qd)],
        dim=-1,
    )
    row1 = torch.stack(
        [2 * (qb * qc + qa * qd), 1 - 2 * (qb**2 + qd**2), 2 * (qc * qd - qa * qb)],
        dim=-1,
    )
    row2 = torch.stack(
        [2 * (qb * qd - qa * qc), 2 * (qa * qb + qc * qd), 1 - 2 * (qb**2 + qc**2)],
        dim=-1,
    )
    return torch.stack([row0, row1, row2], dim=-2)


def _eye(like):
    return torch.eye(3, dtype=like.dtype, device=like.device)


def se3_to_qt(wu):
    """se(3) twist (...,6) [w|u] -> (unit quaternion (...,4), t (...,3)),
    t = V(w) u with V = I + B wx + C wx^2."""
    w, u = wu[..., :3], wu[..., 3:]
    wx = skew(w)
    theta = safe_norm(w)[..., None, None]
    V = (_eye(wu) + one_minus_cos_over_x2(theta) * wx
         + x_minus_sin_over_x3(theta) * (wx @ wx))
    t = (V @ u[..., None])[..., 0]
    return exp_r2q(w), t


def se3_to_SE3(wu):
    """se(3) twist (...,6) -> (...,3,4) pose [R|t]."""
    w, u = wu[..., :3], wu[..., 3:]
    wx = skew(w)
    theta = safe_norm(w)[..., None, None]
    eye = _eye(wu)
    wx2 = wx @ wx
    R = eye + sinx_over_x(theta) * wx + one_minus_cos_over_x2(theta) * wx2
    V = eye + one_minus_cos_over_x2(theta) * wx + x_minus_sin_over_x3(theta) * wx2
    return torch.cat([R, V @ u[..., None]], dim=-1)


def SO3_to_so3(R, eps=1e-7):
    """(...,3,3) rotation -> rotation vector."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) / 2.0, -1.0 + eps, 1.0 - eps)
    theta = torch.remainder(torch.arccos(cos_t), math.pi)[..., None, None]
    lnR = (R - R.transpose(-2, -1)) / (2.0 * sinx_over_x(theta) + 1e-8)
    return torch.stack([lnR[..., 2, 1], lnR[..., 0, 2], lnR[..., 1, 0]], dim=-1)


def SE3_to_se3(Rt, eps=1e-8):
    """(...,3,4) pose -> se(3) twist (...,6)."""
    R, t = Rt[..., :3], Rt[..., 3:]
    w = SO3_to_so3(R)
    wx = skew(w)
    theta = safe_norm(w)[..., None, None]
    A = sinx_over_x(theta)
    B = one_minus_cos_over_x2(theta)
    invV = (_eye(Rt) - 0.5 * wx
            + (1.0 - A / (2.0 * B)) / (theta**2 + eps) * (wx @ wx))
    u = (invV @ t)[..., 0]
    return torch.cat([w, u], dim=-1)

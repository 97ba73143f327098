"""Camera poses on a cumulative cubic B-spline over SE(3), and pinhole rays.

Knots are se(3) twists [w | u]: rotation vector w (full angle |w|) and
u, with translation t = V(w) u. Quaternions are xyzw. A time u in [0, 1]
spans the one segment of four knots; times of exactly 0 or 1 move inward
by 1e-6. Translation blends the knots with the uniform cubic B-spline
basis; rotation composes q0 with the exponentials of the cumulative basis
times each relative log rotation.
"""

from __future__ import annotations

import torch

SMALL = 1e-4  # below this angle the closed forms switch to their series


def _norm(x):
    return torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True) + 1e-300)


def _skew(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([z, -w[..., 2], w[..., 1]], -1),
        torch.stack([w[..., 2], z, -w[..., 0]], -1),
        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def _series_or(x, series, exact):
    small = x.abs() < SMALL
    xs = torch.where(small, torch.ones_like(x), x)
    return torch.where(small, series(x), exact(xs))


def quat_exp(r):
    """rotation vector -> unit quaternion."""
    half = 0.5 * _norm(r)
    s = _series_or(half, lambda h: 0.5 - h * h / 12.0,
                   lambda h: torch.sin(h) / (2.0 * h))
    return torch.cat([s * r, torch.cos(half)], -1)


def quat_log(q):
    """unit quaternion -> rotation vector (full angle)."""
    v, w = q[..., :3], q[..., 3:]
    n = _norm(v)
    lam = _series_or(n, lambda x: 2.0 / w - 2.0 / 3.0 * x * x / w ** 3,
                     lambda x: 2.0 * torch.atan2(x, w) / x)
    return lam * v


def quat_mul(a, b):
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    return torch.stack([aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw,
                        aw * bw - ax * bx - ay * by - az * bz], -1)


def quat_conj(q):
    return torch.cat([-q[..., :3], q[..., 3:]], -1)


def quat_to_matrix(q):
    x, y, z, w = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (w * y + x * z)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (w * x + y * z),
                     1 - 2 * (x * x + y * y)], -1)], -2)


def twist_to_qt(k):
    """se(3) twist (6,) -> (quaternion, translation V(w) u)."""
    w, u = k[:3], k[3:]
    th = _norm(w)[0]
    b = _series_or(th, lambda x: 0.5 - x * x / 24.0,
                   lambda x: (1.0 - torch.cos(x)) / (x * x))
    c = _series_or(th, lambda x: 1.0 / 6.0 - x * x / 120.0,
                   lambda x: (x - torch.sin(x)) / x ** 3)
    wx = _skew(w)
    V = torch.eye(3, dtype=k.dtype, device=k.device) + b * wx + c * (wx @ wx)
    return quat_exp(w), V @ u


def spline_poses(knots, t0, t1, n):
    """n poses (n, 3, 4) evenly over [t0, t1] of the spline of four knots
    (4, 6)."""
    u = torch.linspace(0.0, 1.0, n, dtype=knots.dtype,
                       device=knots.device) * (t1 - t0) + t0
    u = torch.where(u == 0.0, u + 1e-6, u)
    u = torch.where(u == 1.0, u - 1e-6, u)[:, None]
    qs, ts = zip(*(twist_to_qt(knots[i]) for i in range(4)))
    u2, u3 = u * u, u * u * u
    trans = ((1 - 3 * u + 3 * u2 - u3) * ts[0] + (4 - 6 * u2 + 3 * u3) * ts[1]
             + (1 + 3 * u + 3 * u2 - 3 * u3) * ts[2] + u3 * ts[3]) / 6.0
    cum = [(5 + 3 * u - 3 * u2 + u3) / 6.0, (1 + 3 * u + 3 * u2 - 2 * u3) / 6.0,
           u3 / 6.0]
    q = qs[0].expand(n, 4)
    for i in range(3):
        rel = quat_log(quat_mul(quat_conj(qs[i]), qs[i + 1]))
        q = quat_mul(q, quat_exp(cum[i] * rel))
    return torch.cat([quat_to_matrix(q), trans[..., None]], -1)


def pixel_rays(flat_idx, W, K, c2w):
    """World rays (origins, directions) of flat pixel indices (row-major,
    no half-pixel offset) seen from per-ray poses c2w (N, 3, 4)."""
    j = torch.div(flat_idx, W, rounding_mode="floor").to(c2w.dtype)
    i = (flat_idx % W).to(c2w.dtype)
    K = K.to(c2w.dtype)
    d_cam = torch.stack([(i - K[0, 2]) / K[0, 0], -(j - K[1, 2]) / K[1, 1],
                         -torch.ones_like(i)], -1)
    d = torch.einsum("nij,nj->ni", c2w[:, :, :3], d_cam)
    return c2w[:, :, 3].expand(d.shape), d


def to_ndc(H, W, focal, o, d, near=1.0):
    """Rays moved to the near plane and projected to normalized device
    coordinates."""
    t = -(near + o[:, 2]) / d[:, 2]
    o = o + t[:, None] * d
    ax, ay = -2.0 * focal / W, -2.0 * focal / H
    o_ndc = torch.stack([ax * o[:, 0] / o[:, 2], ay * o[:, 1] / o[:, 2],
                         1.0 + 2.0 * near / o[:, 2]], -1)
    d_ndc = torch.stack([ax * (d[:, 0] / d[:, 2] - o[:, 0] / o[:, 2]),
                         ay * (d[:, 1] / d[:, 2] - o[:, 1] / o[:, 2]),
                         -2.0 * near / o[:, 2]], -1)
    return o_ndc, d_ndc

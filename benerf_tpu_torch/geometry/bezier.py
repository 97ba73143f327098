"""Cubic Bezier SE(3) trajectory (alternative to the B-spline).

Port of benerf_tpu/geometry/bezier.py. The reference ships bezier.py as an
alternative trajectory representation (reference bezier.py:7-73), not
wired into its train/test scripts but part of the capability surface.
Control points are se(3) twists; the curve interpolates rotation by
blending the *quaternion-log* relative rotations with Bernstein weights.

Deviation (documented, as in the JAX package): the reference's dead bezier
code has two evident bugs. It weights all three relative rotations with the
same Bernstein column (bezier.py:57-59) and returns the *knot* translations
instead of the interpolated ones (bezier.py:71). This implements the
evident intent: full Bernstein blend for translation and per-segment
weights for rotation. Gradients reach the knots through autograd.
"""

from __future__ import annotations

import torch

from benerf_tpu_torch.geometry import se3 as se3m


def bernstein3(u):
    """Cubic Bernstein basis, (T, 1) each."""
    u = u[..., None]
    b0 = (1 - u) ** 3
    b1 = 3 * u * (1 - u) ** 2
    b2 = 3 * u**2 * (1 - u)
    b3 = u**3
    return b0, b1, b2, b3


def cubic_bezier_pose(knots, u):
    """(4, 6) se(3) control points, (T,) times in [0, 1] -> (T, 3, 4) poses.

    Translation: Bernstein blend of the V(w)u translations. Rotation:
    q(u) = q0 (x) exp( sum_i B_i(u) log(q0^-1 q_i) ), blended in q0's
    tangent space (the de-Casteljau-free closed form the reference uses).
    """
    u = torch.as_tensor(u, dtype=knots.dtype, device=knots.device)
    u = torch.clamp(u, 1e-6, 1.0 - 1e-6)
    qs, ts = [], []
    for i in range(4):
        q, t = se3m.se3_to_qt(knots[i])
        qs.append(q)
        ts.append(t)

    b0, b1, b2, b3 = bernstein3(u)
    trans = b0 * ts[0] + b1 * ts[1] + b2 * ts[2] + b3 * ts[3]

    r = torch.zeros(u.shape + (3,), dtype=knots.dtype, device=knots.device)
    for i, bi in zip(range(1, 4), (b1, b2, b3)):
        rel = se3m.log_q2r(se3m.qmul(se3m.qconj(qs[0]), qs[i]))
        r = r + bi * rel
    q = se3m.qmul(qs[0].expand(r.shape[:-1] + (4,)), se3m.exp_r2q(r))
    R = se3m.q_to_R(q)
    return torch.cat([R, trans[..., None]], dim=-1)

"""Cumulative cubic B-spline (and linear) camera trajectories on SE(3).

Port of benerf_tpu/geometry/spline.py (reference spline.py:247-331):
  - 4 control knots given as se(3) twists; a sample time u in [0,1] spans the
    single spline segment;
  - translation is blended with the uniform cubic B-spline basis;
  - rotation uses the cumulative basis on relative rotations
        q(u) = q0 (x) exp(c1(u) log(q0^-1 q1)) (x) exp(c2(u) log(q1^-1 q2))
                  (x) exp(c3(u) log(q2^-1 q3));
  - sample times exactly 0 / 1 are nudged inward by 1e-6.
"""

from __future__ import annotations

import torch

from benerf_tpu_torch.geometry import se3 as se3m


def _nudge_endpoints(u):
    """Move samples at exactly 0 or 1 inward by 1e-6."""
    u = torch.where(u == 0.0, u + 1e-6, u)
    return torch.where(u == 1.0, u - 1e-6, u)


def cubic_bspline_pose(knots, u):
    """knots (4, 6) se(3) control knots, u (T,) in [0, 1] -> (T, 3, 4)."""
    u = _nudge_endpoints(u)[..., None]  # (T,1)

    q0, t0 = se3m.se3_to_qt(knots[0])
    q1, t1 = se3m.se3_to_qt(knots[1])
    q2, t2 = se3m.se3_to_qt(knots[2])
    q3, t3 = se3m.se3_to_qt(knots[3])

    uu = u * u
    uuu = uu * u
    s = 1.0 / 6.0

    c0 = s - 0.5 * u + 0.5 * uu - s * uuu
    c1 = 4.0 * s - uu + 0.5 * uuu
    c2 = s + 0.5 * u + 0.5 * uu - 0.5 * uuu
    c3 = s * uuu
    trans = c0 * t0 + c1 * t1 + c2 * t2 + c3 * t3  # (T,3)

    c1r = 5.0 * s + 0.5 * u - 0.5 * uu + s * uuu
    c2r = s + 0.5 * u + 0.5 * uu - 2.0 * s * uuu
    c3r = s * uuu

    r01 = se3m.log_q2r(se3m.qmul(se3m.qconj(q0), q1)) * c1r  # (T,3)
    r12 = se3m.log_q2r(se3m.qmul(se3m.qconj(q1), q2)) * c2r
    r23 = se3m.log_q2r(se3m.qmul(se3m.qconj(q2), q3)) * c3r

    q = se3m.qmul(
        q0.expand(r01.shape[:-1] + (4,)),
        se3m.qmul(se3m.exp_r2q(r01),
                  se3m.qmul(se3m.exp_r2q(r12), se3m.exp_r2q(r23))),
    )
    R = se3m.q_to_R(q)  # (T,3,3)
    return torch.cat([R, trans[..., None]], dim=-1)


def linear_pose(knot_start, knot_end, u):
    """SE(3) linear interpolation (slerp rotation + lerp translation)."""
    u = _nudge_endpoints(u)[..., None]  # (T,1)
    q_a, t_a = se3m.se3_to_qt(knot_start)
    q_b, t_b = se3m.se3_to_qt(knot_end)
    trans = (1.0 - u) * t_a + u * t_b
    r = u * se3m.log_q2r(se3m.qmul(se3m.qconj(q_a), q_b))
    q = se3m.qmul(q_a.expand(r.shape[:-1] + (4,)), se3m.exp_r2q(r))
    R = se3m.q_to_R(q)
    return torch.cat([R, trans[..., None]], dim=-1)


def interpolate_poses(knots, t_start, t_end, num, traj="spline"):
    """`num` poses evenly over [t_start, t_end] on the unit spline segment
    (reference Graph.get_pose_evt / get_pose_rgb). t_start / t_end: floats
    or 0-d tensors."""
    ts = (torch.linspace(0.0, 1.0, num, dtype=knots.dtype, device=knots.device)
          * (t_end - t_start) + t_start)
    if traj == "linear":
        return linear_pose(knots[0], knots[3], ts)
    if traj == "spline":
        return cubic_bspline_pose(knots, ts)
    raise ValueError(f"unknown traj {traj!r}")

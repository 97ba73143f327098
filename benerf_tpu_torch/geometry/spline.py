"""Cumulative cubic B-spline (and linear) camera trajectories on SE(3).

Port of benerf_tpu/geometry/spline.py (reference spline.py:247-331):
  - 4 control knots given as se(3) twists; a sample time u in [0,1] spans the
    single spline segment;
  - translation is blended with the uniform cubic B-spline basis;
  - rotation uses the cumulative basis on relative rotations
        q(u) = q0 (x) exp(c1(u) log(q0^-1 q1)) (x) exp(c2(u) log(q1^-1 q2))
                  (x) exp(c3(u) log(q2^-1 q3));
  - sample times exactly 0 / 1 are nudged inward by 1e-6.

`spline_poses` evaluates the poses of several knot sets in one pass (the
train step's event and rgb poses): each of its operations covers every knot
or every pose at once, and the Hamilton product and the rotation matrix are
contractions with constant tables, so a step's forward and backward launch a
few hundred small kernels instead of a few thousand.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from benerf_tpu_torch.geometry import se3 as se3m

_S = 1.0 / 6.0
# Coefficients of 1, u, u^2, u^3 (rows) in the translation basis c0..c3 and
# the rotation's cumulative basis c1..c3 (columns).
_BASIS = (
    (_S, 4.0 * _S, _S, 0.0, 5.0 * _S, _S, 0.0),
    (-0.5, 0.0, 0.5, 0.0, 0.5, 0.5, 0.0),
    (0.5, -1.0, 0.5, 0.0, -0.5, 0.5, 0.0),
    (-_S, 0.5, -0.5, _S, _S, -2.0 * _S, _S),
)


class _Tables(NamedTuple):
    basis: torch.Tensor          # (4, 7) _BASIS
    hamilton: torch.Tensor       # (4, 4, 4): (a (x) b)_c = sum_ij a_i b_j H_ijc
    hamilton_conj: torch.Tensor  # (4, 4, 4): conj(a) (x) b
    rotation: torch.Tensor       # (4, 4, 3, 3): q_to_R(q) = I + sum_kl q_k q_l M_kl
    eye: torch.Tensor            # (3, 3)


@functools.lru_cache(maxsize=None)
def _tables(device, dtype):
    """The constant tables, made once per device and dtype from se3's own
    functions at basis quaternions (every entry 0, +-1 or +-2): a step
    captured in a CUDA graph may not copy from the host."""
    e = torch.eye(4, dtype=torch.float64)
    eye = torch.eye(3, dtype=torch.float64)

    def quad(q):  # q_to_R(q) = I + quad(q), quad quadratic in q
        return se3m.q_to_R(q) - eye

    # M_kl for k <= l only: each entry of R then sums the same two products
    # that q_to_R sums, so the contraction rounds as q_to_R does
    rotation = torch.zeros(4, 4, 3, 3, dtype=torch.float64)
    for k in range(4):
        rotation[k, k] = quad(e[k])
        for l in range(k + 1, 4):
            rotation[k, l] = quad(e[k] + e[l]) - quad(e[k]) - quad(e[l])
    t = _Tables(torch.tensor(_BASIS, dtype=torch.float64),
                se3m.qmul(e[:, None], e[None, :]),
                se3m.qmul(se3m.qconj(e)[:, None], e[None, :]),
                rotation, eye)
    return _Tables(*(x.to(device=device, dtype=dtype) for x in t))


def _qmul(a, b, table):
    """Hamilton product of quaternions a (..., 4) and b (..., 4) by its
    table, rounded as se3m.qmul rounds: each a_i b_j term alone (one
    nonzero j per i and component), then the terms summed in the order
    w, x, y, z of a's components."""
    terms = (a[..., :, None, None] * b[..., None, :, None] * table).sum(-2)
    x, y, z, w = terms.unbind(-2)
    return ((w + x) + y) + z


def _q_to_R(q, tables):
    """se3m.q_to_R as one contraction: (..., 4) -> (..., 3, 3)."""
    qq = q[..., :, None, None, None] * q[..., None, :, None, None]
    return tables.eye + (qq * tables.rotation).sum((-4, -3))


def _se3_to_qt(wu):
    """se3m.se3_to_qt with t = V(w) u as u + B (w x u) + C (w x (w x u)),
    the same B and C: no skew matrices."""
    w, u = wu[..., :3], wu[..., 3:]
    theta = se3m.safe_norm(w, keepdim=True)
    wxu = torch.linalg.cross(w, u)
    t = (u + se3m.one_minus_cos_over_x2(theta) * wxu
         + se3m.x_minus_sin_over_x3(theta) * torch.linalg.cross(w, wxu))
    return se3m.exp_r2q(w), t


def _nudge_endpoints(u):
    """Move samples at exactly 0 or 1 inward by 1e-6."""
    u = torch.where(u == 0.0, u + 1e-6, u)
    return torch.where(u == 1.0, u - 1e-6, u)


def spline_poses(knot_sets, u, set_idx):
    """Poses on S cubic splines in one pass.

    knot_sets (S, 4, 6) se(3) control knots; u (P,) sample times in [0, 1];
    set_idx (P,) the knot set of each sample -> (P, 3, 4) poses [R|t].
    """
    tables = _tables(knot_sets.device, knot_sets.dtype)
    S = knot_sets.shape[0]
    u = _nudge_endpoints(u)
    onehot = (set_idx[:, None] == torch.arange(S, device=set_idx.device)).to(u.dtype)
    # each coefficient's terms in 1, u, u*u, u*u*u, summed in that order:
    # rounded as the one-coefficient-at-a-time formulas round it
    uu = u * u
    powers = torch.stack([torch.ones_like(u), u, uu, uu * u], dim=1)
    c0, c1, c2, c3 = (powers[:, :, None] * tables.basis).unbind(1)
    basis = ((c0 + c1) + c2) + c3
    weights = onehot[:, :, None] * basis[:, None, :]  # (P, S, 7)

    q, t = _se3_to_qt(knot_sets)  # (S, 4, 4), (S, 4, 3)
    logs = se3m.log_q2r(_qmul(q[:, :3], q[:, 1:], tables.hamilton_conj))
    trans = (weights[..., :4, None] * t).sum((1, 2))  # (P, 3)
    rots = se3m.exp_r2q((weights[..., 4:, None] * logs).sum(1))  # (P, 3, 4)
    q0 = (onehot[..., None] * q[:, 0]).sum(1)  # (P, 4)

    e1, e2, e3 = rots.unbind(1)
    h = tables.hamilton
    q = _qmul(q0, _qmul(e1, _qmul(e2, e3, h), h), h)
    return torch.cat([_q_to_R(q, tables), trans[..., None]], dim=-1)


def cubic_bspline_pose(knots, u):
    """knots (4, 6) se(3) control knots, u (T,) in [0, 1] -> (T, 3, 4)."""
    set_idx = torch.zeros(u.shape[0], dtype=torch.long, device=u.device)
    return spline_poses(knots[None], u, set_idx)


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


def interpolate_pose_sets(knot_sets, spans, nums, traj="spline"):
    """nums[i] poses evenly over spans[i] = (t_start, t_end) on knot set
    knot_sets[i] (S, 4, 6), every set in one spline pass -> a list of
    (nums[i], 3, 4) poses (reference Graph.get_pose_evt / get_pose_rgb).
    t_start / t_end: floats or 0-d tensors."""
    ts = [torch.linspace(0.0, 1.0, n, dtype=knot_sets.dtype, device=knot_sets.device)
          * (t_end - t_start) + t_start for (t_start, t_end), n in zip(spans, nums)]
    if traj == "linear":
        return [linear_pose(k[0], k[3], u) for k, u in zip(knot_sets, ts)]
    if traj != "spline":
        raise ValueError(f"unknown traj {traj!r}")
    set_idx = torch.cat([torch.full((n,), i, dtype=torch.long, device=knot_sets.device)
                         for i, n in enumerate(nums)])
    return list(spline_poses(knot_sets, torch.cat(ts), set_idx).split(list(nums)))


def interpolate_poses(knots, t_start, t_end, num, traj="spline"):
    """`num` poses evenly over [t_start, t_end] on the unit spline segment
    (reference Graph.get_pose_evt / get_pose_rgb). t_start / t_end: floats
    or 0-d tensors."""
    return interpolate_pose_sets(knots[None], [(t_start, t_end)], [num], traj)[0]

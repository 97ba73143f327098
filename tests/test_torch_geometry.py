"""PyTorch port's SE(3) math and spline trajectories vs the JAX package and
the golden fixtures of the original PyTorch BeNeRF.

Inputs are made with numpy from a seed and handed to both sides. Values are
held at the JAX suite's tolerances (tests/test_se3.py, tests/test_spline.py);
gradients of a scalar of the poses w.r.t. the knots are compared against
jax.grad, including at the zero se(3) transform the train state starts at.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benerf_tpu.geometry import se3 as jse3
from benerf_tpu.geometry import spline as jspline
from benerf_tpu_torch.geometry import se3 as tse3
from benerf_tpu_torch.geometry import spline as tspline


def _t(x):
    return torch.as_tensor(np.array(x))


def _rotvecs(seed, n=40, scale=0.8):
    rng = np.random.default_rng(seed)
    r = rng.normal(scale=scale, size=(n, 3)).astype(np.float32)
    r[:3] = [[0.0, 0.0, 0.0], [1e-12, 0.0, 0.0], [0.0, 2e-4, -1e-4]]
    return r


def _unit_quats(seed, n=40):
    q = np.random.default_rng(seed).normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q[0] = [0.0, 0.0, 0.0, 1.0]
    return q


def _twists(seed, n=40, scale=0.6):
    wu = np.random.default_rng(seed).normal(scale=scale, size=(n, 6))
    wu = wu.astype(np.float32)
    wu[0] = 0.0
    wu[1, :3] = [1e-5, -2e-5, 0.0]
    return wu


def _poses(seed, n=20):
    return np.asarray(jse3.se3_to_SE3(jnp.asarray(_twists(seed, n)[2:])))


CASES = {
    "exp_r2q": (jse3.exp_r2q, tse3.exp_r2q, lambda: _rotvecs(0), 1e-6),
    "log_q2r": (jse3.log_q2r, tse3.log_q2r, lambda: _unit_quats(1), 1e-5),
    "q_to_R": (jse3.q_to_R, tse3.q_to_R, lambda: _unit_quats(2), 1e-6),
    "se3_to_SE3": (jse3.se3_to_SE3, tse3.se3_to_SE3, lambda: _twists(3), 1e-5),
    "SE3_to_se3": (jse3.SE3_to_se3, tse3.SE3_to_se3, lambda: _poses(4), 1e-4),
    "skew": (jse3.skew, tse3.skew, lambda: _rotvecs(5), 0.0),
}


@pytest.mark.parametrize("name", list(CASES))
def test_se3_functions_match_jax(name):
    jfn, tfn, make, atol = CASES[name]
    x = make()
    want = np.asarray(jfn(jnp.asarray(x)))
    got = tfn(_t(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def test_se3_to_qt_and_qmul_match_jax():
    wu = _twists(6)
    qj, tj = jse3.se3_to_qt(jnp.asarray(wu))
    qt, tt = tse3.se3_to_qt(_t(wu))
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=0, atol=1e-5)
    q1, q2 = _unit_quats(7), _unit_quats(8)
    np.testing.assert_allclose(
        tse3.qmul(_t(q1), tse3.qconj(_t(q2))).numpy(),
        np.asarray(jse3.qmul(jnp.asarray(q1), jse3.qconj(jnp.asarray(q2)))),
        rtol=0, atol=1e-6)


def test_golden_se3(golden):
    """The golden values the JAX suite holds its se3 to, at its tolerances."""
    q = tse3.exp_r2q(_t(golden["rotvecs"])).numpy()
    np.testing.assert_allclose(q, golden["exp_r2q"], rtol=0, atol=1e-6)
    r = tse3.log_q2r(_t(golden["exp_r2q"])).numpy()
    np.testing.assert_allclose(r, golden["log_q2r"], rtol=0, atol=1e-6)
    Rt = tse3.se3_to_SE3(_t(golden["se3_twists"])).numpy()
    np.testing.assert_allclose(Rt, golden["se3_to_SE3"], rtol=0, atol=1e-5)
    tiny = tse3.se3_to_SE3(_t(golden["se3_twists_tiny"])).numpy()
    np.testing.assert_allclose(tiny, golden["se3_to_SE3_tiny"], rtol=0, atol=1e-7)
    wu = tse3.SE3_to_se3(_t(golden["se3_to_SE3"])).numpy()
    np.testing.assert_allclose(wu, golden["SE3_to_se3"], rtol=0, atol=1e-4)


def test_golden_splines(golden):
    ts = _t(golden["spline_ts"])
    for knots, want in (("spline_knots", "spline_poses"),
                        ("spline_knots_big", "spline_poses_big")):
        got = tspline.cubic_bspline_pose(_t(golden[knots]), ts).numpy()
        np.testing.assert_allclose(got, golden[want], rtol=0, atol=1e-5)
    k = _t(golden["spline_knots"])
    got = tspline.linear_pose(k[0], k[3], ts).numpy()
    np.testing.assert_allclose(got, golden["linear_poses"], rtol=0, atol=1e-5)


def test_grads_finite_at_zero():
    """The rgb<->event transform starts at exactly zero: x/|x| there would
    put NaN into the gradient if either torch.where branch faulted."""
    for fn, x in ((tse3.exp_r2q, torch.zeros(1, 3)),
                  (tse3.se3_to_SE3, torch.zeros(6)),
                  (tse3.se3_to_qt, torch.zeros(6)),
                  (tse3.log_q2r, torch.tensor([0.0, 0.0, 0.0, 1.0]))):
        x = x.clone().requires_grad_(True)
        out = fn(x)
        out = sum(o.sum() for o in out) if isinstance(out, tuple) else out.sum()
        (g,) = torch.autograd.grad(out, x)
        assert torch.isfinite(g).all(), fn.__name__


@pytest.mark.parametrize("traj", ["spline", "linear"])
@pytest.mark.parametrize("knot_scale", [0.0, 0.01, 0.4])
def test_interpolate_poses_and_grads_match_jax(traj, knot_scale):
    """Poses and d sum(poses^2 + poses) / d knots, for zero, small and large
    knots; the rgb branch's knots + transform with transform = 0 included."""
    rng = np.random.default_rng(int(knot_scale * 100) + len(traj))
    knots = (rng.normal(size=(4, 6)) * knot_scale).astype(np.float32)
    t0, t1 = 0.0, 1.0  # the endpoint nudge on both ends

    def jloss(k, tr):
        p = jspline.interpolate_poses(k + tr[None, :], t0, t1, 7, traj)
        return jnp.sum(p * p + p), p

    (_, pj), (gkj, gtj) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(knots), jnp.zeros(6))
    k = _t(knots).requires_grad_(True)
    tr = torch.zeros(6, requires_grad=True)
    pt = tspline.interpolate_poses(k + tr[None, :], t0, t1, 7, traj)
    gk, gt = torch.autograd.grad(torch.sum(pt * pt + pt), (k, tr))

    assert pt.shape == (7, 3, 4)
    np.testing.assert_allclose(pt.detach().numpy(), np.asarray(pj), rtol=0, atol=1e-5)
    for got, want in ((gk, gkj), (gt, gtj)):
        assert torch.isfinite(got).all()
        want = np.asarray(want)
        scale = max(np.abs(want).max(), 1.0)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-5 * scale)


def test_identity_knots_give_identity_pose():
    poses = tspline.cubic_bspline_pose(torch.zeros(4, 6),
                                       torch.tensor([0.25, 0.5, 0.9]))
    eye = torch.cat([torch.eye(3), torch.zeros(3, 1)], -1).expand(3, 3, 4)
    torch.testing.assert_close(poses, eye, rtol=0, atol=1e-6)


def test_float64_spline_keeps_dtype():
    """Given float64 knots the port's spline computes in float64, and agrees
    with the float32 JAX spline to f32 rounding."""
    knots = np.random.default_rng(9).normal(scale=0.3, size=(4, 6))
    ts = np.linspace(0.0, 1.0, 5)
    p64 = tspline.cubic_bspline_pose(_t(knots), _t(ts))
    assert p64.dtype == torch.float64
    want = np.asarray(jspline.cubic_bspline_pose(
        jnp.asarray(knots, jnp.float32), jnp.asarray(ts, jnp.float32)))
    np.testing.assert_allclose(p64.numpy(), want, rtol=0, atol=1e-5)

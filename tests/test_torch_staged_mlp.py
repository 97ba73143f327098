"""The port's staged MLP op (ops/staged_mlp.py, the counterpart of the JAX
K3/K4 pair) and its MLP dispatcher (ops/mlp.py) against the JAX package.

- staged_nerf_mlp on the CPU (the plain version) vs JAX
  pallas_mlp.fused_nerf_mlp in Pallas interpret mode and vs nerf.apply, for
  view encodings other than 27 rows and C up to 8; tolerances as
  tests/test_pallas.py: forward atol 1e-4, gradients 3e-4 * max(scale, 1);
- the op's card path in Python (per-ray view bias, packing, the autograd
  Function) with the kernel launches replaced by a plain computation on the
  packed weights, since CUDA kernels have no CPU mode;
- ops.mlp.route vs the decision of benerf_tpu/ops/mlp.py:67-82 over a grid
  of architectures;
- the train step's loss and every gradient vs JAX make_loss_fn with a view
  encoding of L = 6 and caller-built MLPs;
- the repairs: init_state refuses to guess a device, and the staged op
  refuses an encoding width that the JAX kernel misreads.
Inputs are made with numpy from a seed; JAX parameters cross over through
bridge.params_from_numpy.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_golden_grad as gg
import test_torch_step as ts

from benerf_tpu.models import nerf as jnerf
from benerf_tpu.ops import pallas_mlp, pallas_mlp_t
from benerf_tpu.train import step as jstep
from benerf_tpu_torch.models import bridge
from benerf_tpu_torch.models import embedder as temb
from benerf_tpu_torch.models import nerf as tnerf
from benerf_tpu_torch.ops import fused_mlp, staged_mlp
from benerf_tpu_torch.ops import mlp as tmlp
from benerf_tpu_torch.train import step as tstep

FWD_ATOL = 1e-4
GRAD_TOL = 3e-4


@pytest.fixture
def interpret_mode():
    pallas_mlp.INTERPRET = True
    yield
    pallas_mlp.INTERPRET = False


def _inputs(R, S, C, views_ch, seed):
    rng = np.random.default_rng(seed)
    params = jax.tree.map(np.asarray, jnerf.init_params(
        jax.random.PRNGKey(seed), input_ch_views=views_ch, channels=C))
    # small nonzero biases so every bias gradient is exercised
    params = jax.tree.map(
        lambda a: (a + rng.uniform(-0.05, 0.05, a.shape)).astype(np.float32)
        if a.ndim == 1 else a, params)
    pts = rng.uniform(-1.0, 1.0, (R, S, 3)).astype(np.float32)
    vd = rng.normal(size=(R, 3))
    vd = (vd / np.linalg.norm(vd, axis=-1, keepdims=True)).astype(np.float32)
    return params, pts, vd, (views_ch - 3) // 6


def _jax_grads(fn, params, pts, vd, Lv):
    def loss(p, x, d):
        return jnp.sum(jnp.sin(fn(p, x, d, num_freqs_views=Lv)))

    gp, gx, gd = jax.grad(loss, argnums=(0, 1, 2))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(pts), jnp.asarray(vd))
    return [np.asarray(g) for g in bridge.tree_leaves(gp)] + [
        np.asarray(gx), np.asarray(gd)]


def _port_grads(fn, params, pts, vd, Lv):
    tp = bridge.params_from_numpy(params)
    leaves = [t.requires_grad_(True) for t in bridge.tree_leaves(tp)]
    x = torch.tensor(pts, requires_grad=True)
    v = torch.tensor(vd, requires_grad=True)
    out = fn(tp, x, v, num_freqs_views=Lv)
    grads = torch.autograd.grad(torch.sum(torch.sin(out)), leaves + [x, v])
    return [g.detach().numpy() for g in grads]


def _assert_grads_close(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        scale = max(np.abs(b).max(), 1.0)
        err = np.abs(a - b).max()
        assert err <= GRAD_TOL * scale, f"grad {b.shape}: {err} vs scale {scale}"


# R = 13 rays: 13 * S points never fill the JAX kernel's 512-point tiles
@pytest.mark.parametrize("views_ch,C,S", [(15, 1, 64), (39, 3, 128),
                                          (39, 8, 192), (15, 8, 128)])
def test_staged_forward_matches_jax(views_ch, C, S, interpret_mode):
    params, pts, vd, Lv = _inputs(13, S, C, views_ch, seed=views_ch + C + S)
    jp = jax.tree.map(jnp.asarray, params)
    want = np.asarray(jnerf.apply(jp, jnp.asarray(pts), jnp.asarray(vd),
                                  num_freqs_views=Lv))
    k3 = np.asarray(pallas_mlp.fused_nerf_mlp(jp, jnp.asarray(pts),
                                              jnp.asarray(vd),
                                              num_freqs_views=Lv))
    got = staged_mlp.staged_nerf_mlp(
        bridge.params_from_numpy(params), torch.as_tensor(pts),
        torch.as_tensor(vd), num_freqs_views=Lv).numpy()
    assert got.shape == want.shape == (13, S, C + 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_ATOL)
    np.testing.assert_allclose(got, k3, rtol=0, atol=FWD_ATOL)


# A ReLU input within fp32 rounding of 0 takes its side by the order of the
# sums before it, and its point's gradient then differs by design. Measured
# at 13 x 192 points (views_ch 39): fp32 ReLU inputs deviate from float64 by
# up to 7.5e-7, and one views-layer input of -6.25e-8 in float64 comes out
# +2.05e-8 in fp32 in both the port's and JAX's plain nerf.apply (their d
# pts sit 2.4321e-2 x scale from float64 to 1e-8 of each other, w0 3.2e-4),
# while the JAX kernel's summation order keeps it negative (5.8e-7). The
# gradient test therefore draws its points away from such ties.
RELU_TIE = 1e-5


def _min_relu_input(params, pts, vd, Lv):
    """Per point, the smallest |ReLU input| of nerf.apply in float64
    (trunk and views layer)."""
    p = bridge.tree_map(lambda t: t.double(), bridge.params_from_numpy(params))
    x = torch.as_tensor(pts, dtype=torch.float64).reshape(-1, 3)
    pe = temb.positional_encoding(x, 10)
    h, mins = pe, []
    for layer in p["pts"]:
        t = (pe @ layer["w_pe"] + h @ layer["w_h"] if "w_pe" in layer
             else h @ layer["w"]) + layer["b"]
        mins.append(t.abs().min(dim=1).values)
        h = torch.relu(t)
    f = h @ p["feature"]["w"] + p["feature"]["b"]
    vpe = temb.positional_encoding(torch.as_tensor(vd, dtype=torch.float64), Lv)
    t = (f @ p["views"]["w_feat"] + p["views"]["b"]
         + (vpe @ p["views"]["w_pe"]).repeat_interleave(pts.shape[1], dim=0))
    mins.append(t.abs().min(dim=1).values)
    return torch.stack(mins).min(dim=0).values.numpy().reshape(pts.shape[:2])


def _away_from_relu_ties(params, pts, vd, Lv, seed):
    """pts with every point whose float64 ReLU inputs come within RELU_TIE
    of 0 drawn again."""
    rng = np.random.default_rng(seed)
    pts = pts.copy()
    for _ in range(20):
        tie = _min_relu_input(params, pts, vd, Lv) < RELU_TIE
        if not tie.any():
            return pts
        pts[tie] = rng.uniform(-1.0, 1.0, (int(tie.sum()), 3)).astype(np.float32)
    raise AssertionError("could not draw points away from ReLU ties")


@pytest.mark.parametrize("views_ch,C,S", [(39, 3, 192), (15, 8, 64)])
def test_staged_gradients_match_jax(views_ch, C, S, interpret_mode):
    """Against the JAX kernel and against the same function in float64, on
    points away from ReLU ties (RELU_TIE). JAX's plain nerf.apply is held to
    the bound at 13 x 64; at 13 x 192 its fp32 gradients on XLA:CPU sat up
    to 3.2e-4 x scale (w0) and 2.4e-2 (d pts) from float64 at a tie."""
    params, pts, vd, Lv = _inputs(13, S, C, views_ch, seed=S)
    pts = _away_from_relu_ties(params, pts, vd, Lv, seed=S + 1)
    got = _port_grads(staged_mlp.staged_nerf_mlp, params, pts, vd, Lv)
    _assert_grads_close(got, _jax_grads(pallas_mlp.fused_nerf_mlp, params,
                                        pts, vd, Lv))
    f64 = jax.tree.map(lambda a: a.astype(np.float64), (params, pts, vd))
    _assert_grads_close(got, _port_grads(tnerf.apply, *f64, Lv))
    if S == 64:
        _assert_grads_close(got, _jax_grads(jnerf.apply, params, pts, vd, Lv))


# ---- the card path's Python, kernels replaced by plain math ---------------


def _packed_forward(packed, pts, vb, S, C):
    """What K3 computes, from the packed vector it reads."""
    w = fused_mlp.unpack(packed, C, view_pe=False)
    pe = temb.positional_encoding(pts, 10)
    h = torch.relu(pe @ w["w0"] + w["b"][0])
    for l in range(1, 8):
        t = h @ w["wh"][l - 1] + w["b"][l]
        if l == 5:
            t = t + pe @ w["w5pe"]
        h = torch.relu(t)
    f = h @ w["wf"] + w["bf"]
    hv = torch.relu(f @ w["wfv"] + vb.repeat_interleave(S, dim=0))
    return torch.cat([hv @ w["wrgb"] + w["brgb"], h @ w["wa"] + w["ba"]], -1)


def _packed_backward(packed, pts, vb, g, S, C, splits):
    """What K4 returns: (d packed, d pts, d vb per ray)."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (packed, pts, vb)]
        out = _packed_forward(*ins, S, C)
        return torch.autograd.grad(out, ins, g)


@pytest.mark.parametrize("C,S", [(3, 37), (8, 64)])
def test_staged_card_path_wiring(C, S, monkeypatch):
    """The per-ray view bias, the packing without the view-encoding
    entries and the autograd Function route every gradient to its
    parameter, the points and the viewdirs."""
    monkeypatch.setattr(staged_mlp, "launch_fwd", _packed_forward)
    monkeypatch.setattr(staged_mlp, "launch_bwd", _packed_backward)
    params, pts, vd, Lv = _inputs(3, S, C, 39, seed=C)

    def card_path(p, x, v, num_freqs_views):
        return staged_mlp._staged(p, x, v, num_freqs_views, splits=1)

    want = _port_grads(tnerf.apply, params, pts, vd, Lv)
    _assert_grads_close(_port_grads(card_path, params, pts, vd, Lv), want)


@pytest.mark.parametrize("C", [1, 8])
def test_staged_packed_layout(C):
    params, _, _, _ = _inputs(1, 1, C, 39, seed=C)
    tp = bridge.params_from_numpy(params)
    packed = fused_mlp.pack_params(tp, view_pe=False)
    offs = fused_mlp._offsets(fused_mlp._layout(C, view_pe=False))
    assert packed.numel() == offs[-1]
    full = fused_mlp._offsets(fused_mlp._layout(C))
    assert offs[-1] == full[-1] - 27 * 128 - 128
    assert all(o % 4 == 0 for o in offs[:10])
    v = fused_mlp.unpack(packed, C, view_pe=False)
    assert v["wvpe"].numel() == v["bv"].numel() == 0
    np.testing.assert_array_equal(v["wfv"], tp["views"]["w_feat"])
    np.testing.assert_array_equal(v["bf"], tp["feature"]["b"])
    np.testing.assert_array_equal(v["wa"], tp["alpha"]["w"])
    np.testing.assert_array_equal(v["wrgb"], tp["rgb"]["w"])
    np.testing.assert_array_equal(v["brgb"], tp["rgb"]["b"])
    tl = fused_mlp._tlayout(C, view_pe=False)
    toffs = fused_mlp._offsets(tl)
    tvec = fused_mlp.pack_transposed(packed, C, view_pe=False)
    assert tvec.numel() == toffs[-1] and all(o % 4 == 0 for o in toffs)
    tv = {name: fused_mlp.deinterleave(tvec[toffs[i]:toffs[i + 1]].view(shape))
          for i, (name, shape) in enumerate(tl)}
    np.testing.assert_array_equal(tv["wfvT"], v["wfv"].t())
    np.testing.assert_array_equal(tv["waT"], v["wa"].t())
    np.testing.assert_array_equal(tv["wrgbT"], v["wrgb"].t())


# ---- the route table --------------------------------------------------------


def _jax_route(params, pts, viewdirs, num_freqs, num_freqs_views,
               barf_weights):
    """benerf_tpu/ops/mlp.py:67-82 on a Pallas backend, with its own
    predicates."""
    if viewdirs is None:
        return "plain"
    if (pallas_mlp_t.supports(params, pts)
            and num_freqs == 10 and num_freqs_views == 4):
        return "fused"
    if barf_weights is None and pallas_mlp.supports(params, pts):
        return "staged"
    return "plain"


@pytest.mark.parametrize("use_viewdirs", [True, False])
@pytest.mark.parametrize("depth", [8, 4])
@pytest.mark.parametrize("width", [256, 128])
def test_route_matches_the_jax_dispatcher(width, depth, use_viewdirs):
    pts = np.zeros((2, 8, 3), np.float32)
    routes = set()
    for views_ch in (27, 15, 39):
        for C in (1, 3, 8):
            shapes = jax.eval_shape(lambda: jnerf.init_params(
                jax.random.PRNGKey(0), depth=depth, width=width,
                input_ch_views=views_ch, channels=C,
                use_viewdirs=use_viewdirs))
            jparams = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
            tparams = bridge.params_from_numpy(jparams)
            vd = np.zeros((2, 3), np.float32) if use_viewdirs else None
            Lv = (views_ch - 3) // 6
            for barf in (False, True):
                bw = np.ones(10, np.float32) if barf else None
                want = _jax_route(jparams, pts, vd, 10, Lv, bw)
                got = tmlp.route(tparams, vd, 10, Lv, barf)
                assert got == want, (views_ch, C, barf, got, want)
                routes.add(got)
    if (width, depth, use_viewdirs) == (256, 8, True):
        assert routes == {"fused", "staged", "plain"}
    else:
        assert routes == {"plain"}


def test_cpu_tensors_take_the_plain_version_on_every_route():
    params, pts, vd, Lv = _inputs(2, 8, 3, 39, seed=4)
    tp = bridge.params_from_numpy(params)
    assert tmlp.route(tp, torch.as_tensor(vd), 10, Lv, False) == "staged"
    plain_before = tmlp.ROUTES["plain"]
    got = tmlp.mlp_forward(tp, torch.as_tensor(pts), torch.as_tensor(vd),
                           num_freqs_views=Lv)
    want = tnerf.apply(tp, torch.as_tensor(pts), torch.as_tensor(vd),
                       num_freqs_views=Lv)
    assert torch.equal(got, want)
    assert tmlp.ROUTES["plain"] == plain_before  # counts card calls only


# ---- the slice: the train step with a view encoding of L = 6 ---------------


def _l6_nerfs(jparams, C, seed):
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    return {**jparams,
            "nerf": jnerf.init_params(k1, input_ch_views=39, channels=C),
            "nerf_fine": jnerf.init_params(k2, input_ch_views=39, channels=C)}


# (golden case, rtol of the loss terms, gradient bound as relative RMS per
# leaf): ~4-7x the measured distance between the two fp32 results (loss
# 1.4e-6 / 5.9e-6, worst leaf 1.3e-3 / 2.5e-3), as test_torch_step's
# LOSS_CASES set theirs
L6_CASES = {"real_color": ("real_color", 1e-5, 5e-3),
            "synthetic_gray": ("synthetic_gray", 3e-5, 1e-2)}


@pytest.mark.parametrize("name", list(L6_CASES))
def test_loss_fn_with_view_encoding_l6_matches_jax(name):
    case, loss_rtol, grad_rel = L6_CASES[name]
    jcfg = dataclasses.replace(gg.build_cfg(case), multires_views=6)
    C = jcfg.channels
    rng = np.random.default_rng(6)
    knots = (rng.normal(size=(4, 6)) * 0.05).astype(np.float32)
    jparams, jbatch = ts._jax_side(jcfg, 7, C, knots, np.zeros(6, np.float32))
    jparams = _l6_nerfs(jparams, C, seed=len(name))
    assert jparams["nerf"]["views"]["w_pe"].shape == (39, 128)
    draws = ts._draws_np(rng, jcfg)

    jloss_fn, _ = jstep.make_loss_fn(jcfg, ts.H_RGB, ts.W_RGB)
    (jtotal, jm), jgrads = jax.jit(jax.value_and_grad(jloss_fn, has_aux=True))(
        jparams, jbatch, ts._to(draws, jnp.asarray), jnp.asarray(0, jnp.int32))

    tparams, tbatch = ts._port_side(jparams, 7, C)
    tcfg = ts._port_cfg(jcfg)
    assert tmlp.route(tparams["nerf"], torch.zeros(1, 3), tcfg.multires,
                      tcfg.multires_views, False) == "staged"
    tloss_fn, _ = tstep.make_loss_fn(tcfg, ts.H_RGB, ts.W_RGB)
    ttotal, tm, tgrads = ts._port_value_and_grad(
        tloss_fn, tparams, tbatch,
        ts._to(draws, lambda a: torch.as_tensor(np.array(a))), 0)

    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=loss_rtol,
                                   err_msg=k)
    np.testing.assert_allclose(float(ttotal), float(jtotal), rtol=loss_rtol)
    want = bridge.tree_leaves(ts._np_tree(jgrads))
    got = [g.numpy() for g in bridge.tree_leaves(tgrads)]
    assert len(got) == len(want)
    for a, w in zip(got, want):
        assert a.shape == w.shape and np.all(np.isfinite(a))
        assert ts._rms(a - w) <= grad_rel * max(ts._rms(w), 1e-30), (
            w.shape, ts._rms(a - w), ts._rms(w))


# ---- the repairs --------------------------------------------------------------


def test_init_state_without_device_raises_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ts._tiny_train_cfg(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tstep.init_state(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tstep.build_params(cfg)
    params = tstep.build_params(cfg, device="cpu")
    assert params["knots"].device.type == "cpu"
    assert tstep.init_state(cfg, params=params).step == 0


def test_staged_op_refuses_an_encoding_the_jax_kernel_misreads(interpret_mode):
    """With num_freqs = 6 the 39-wide encoding meets w0's 63 rows: the JAX
    kernel pads it by one column and its 64-wide block reads past it,
    returning an array where nerf.apply raises; the port raises."""
    params, pts, vd, _ = _inputs(2, 64, 3, 27, seed=0)
    jp = jax.tree.map(jnp.asarray, params)
    out = pallas_mlp.fused_nerf_mlp(jp, jnp.asarray(pts), jnp.asarray(vd),
                                    num_freqs=6)
    assert out.shape == (2, 64, 4)
    with pytest.raises(TypeError):
        jnerf.apply(jp, jnp.asarray(pts), jnp.asarray(vd), num_freqs=6)
    tp = bridge.params_from_numpy(params)
    with pytest.raises(ValueError, match="num_freqs=6"):
        staged_mlp.staged_nerf_mlp(tp, torch.as_tensor(pts),
                                   torch.as_tensor(vd), num_freqs=6)
    with pytest.raises(ValueError):
        fused_mlp.fused_nerf_mlp(tp, torch.as_tensor(pts), torch.as_tensor(vd),
                                 num_freqs=6)

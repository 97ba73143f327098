"""The port's staged MLP op (ops/staged_mlp.py, the counterpart of the JAX
K3/K4 pair) and its MLP dispatcher (ops/mlp.py) against the JAX package.

- staged_nerf_mlp on the CPU (the plain version) vs JAX
  pallas_mlp.fused_nerf_mlp in Pallas interpret mode and vs nerf.apply, for
  view encodings other than 27 rows and C up to 8; tolerances as
  tests/test_pallas.py: forward atol 1e-4, gradients 3e-4 * max(scale, 1);
- K3/K4's arithmetic, emulated in both modes (tests/test_torch_tc_mlp.py's
  emulation with the per-ray view bias), against the JAX package: TF32X3
  against fp32 nerf.apply and float64, BF16 against the JAX kernel's bf16
  mode in interpret mode, forward and gradients;
- the op's card path in Python (per-ray view bias, packing, the autograd
  Function) in both modes, with the kernel launches replaced by that
  emulation, since CUDA kernels have no CPU mode; K3/K4's packed layout;
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
import test_torch_tc_mlp as tc

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
    tp = bridge.params_from_numpy(params, device="cpu")
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
        bridge.params_from_numpy(params, device="cpu"), torch.as_tensor(pts),
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
    p = bridge.tree_map(lambda t: t.double(), bridge.params_from_numpy(params, device="cpu"))
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


# ---- the kernels' arithmetic, emulated; the card path's Python -------------


def _emulated_staged(compute_dtype):
    """The staged op as K3/K4 compute it (tc.emulated_forward with the
    per-ray view bias), straight from the parameter dict: (p, x (R, S, 3),
    v (R, 3), num_freqs_views) -> raw (R, S, C+1)."""
    def fn(p, x, v, num_freqs_views):
        R, S, _ = x.shape
        C = p["rgb"]["w"].shape[1]
        vb = staged_mlp.view_bias(p, v, num_freqs_views, compute_dtype)
        w = fused_mlp.unpack(fused_mlp.pack_params(p, view_pe=False), C,
                             view_pe=False)
        out = tc.emulated_forward(w, x.reshape(-1, 3), None, torch.ones(14),
                                  tc.MODES[compute_dtype],
                                  vb.repeat_interleave(S, dim=0))
        return out.reshape(R, S, C + 1)
    return fn


# forward and gradients; TF32X3 against JAX fp32 at FWD_ATOL / GRAD_TOL and
# against float64 at F64_TOL x scale; BF16 against the JAX kernel's bf16
# mode (interpret mode) at test_pallas's test_bfloat16_mode bounds: forward
# 2e-2 x scale, gradients 0.15 relative RMS per leaf. Measured on these
# inputs: TF32X3 2.8e-7 (forward) and 6.6e-7 (worst gradient) x scale from
# float64; BF16 3.9e-3 x scale and 0.024 RMS from the JAX kernel's bf16 mode
F64_TOL = 1e-5
BF16_FWD = 2e-2
BF16_GRAD_RMS = 0.15


def _rms(a):
    return float(np.sqrt(np.mean(np.square(a, dtype=np.float64))))


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_emulated_staged_network_matches_jax(compute_dtype, interpret_mode):
    """The staged network with K3/K4's layer products (TF32X3 or BF16) and
    a 39-row view encoding, against the JAX package from the same numpy
    inputs, on points away from ReLU ties."""
    params, pts, vd, Lv = _inputs(13, 64, 3, 39, seed=11)
    pts = _away_from_relu_ties(params, pts, vd, Lv, seed=12)
    emu = _emulated_staged(compute_dtype)
    tp = bridge.params_from_numpy(params, device="cpu")
    got = emu(tp, torch.as_tensor(pts), torch.as_tensor(vd), Lv).numpy()
    got_g = _port_grads(emu, params, pts, vd, Lv)
    jp = jax.tree.map(jnp.asarray, params)
    if compute_dtype == "float32":
        want = np.asarray(jnerf.apply(jp, jnp.asarray(pts), jnp.asarray(vd),
                                      num_freqs_views=Lv))
        np.testing.assert_allclose(got, want, rtol=0, atol=FWD_ATOL)
        _assert_grads_close(got_g, _jax_grads(jnerf.apply, params, pts, vd, Lv))
        f64 = jax.tree.map(lambda a: a.astype(np.float64), (params, pts, vd))
        want64 = tnerf.apply(bridge.params_from_numpy(f64[0], device="cpu"),
                             torch.as_tensor(f64[1]), torch.as_tensor(f64[2]),
                             num_freqs_views=Lv).numpy()
        assert np.abs(got - want64).max() <= F64_TOL * max(np.abs(want64).max(), 1.0)
        for a, b in zip(got_g, _port_grads(tnerf.apply, *f64, Lv)):
            assert np.abs(a - b).max() <= F64_TOL * max(np.abs(b).max(), 1.0)
        return
    def kernel(p, x, d, num_freqs_views):
        return pallas_mlp.fused_nerf_mlp(p, x, d, num_freqs_views=num_freqs_views,
                                         compute_dtype="bfloat16")
    want = np.asarray(kernel(jp, jnp.asarray(pts), jnp.asarray(vd), Lv))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=BF16_FWD * max(np.abs(want).max(), 1.0))
    for a, b in zip(got_g, _jax_grads(kernel, params, pts, vd, Lv)):
        assert a.shape == b.shape
        assert _rms(a - b) <= BF16_GRAD_RMS * max(_rms(b), 1e-6)


def _launch_fwd(seen, preps):
    def launch(packed, pts, vb, S, C, compute_dtype="float32", *, prep):
        seen.append(("fwd", compute_dtype))
        preps.append(prep)
        w = fused_mlp.unpack(packed, C, view_pe=False)
        return tc.emulated_forward(w, pts, None, torch.ones(14),
                                   tc.MODES[compute_dtype],
                                   vb.repeat_interleave(S, dim=0))
    return launch


def _launch_bwd(seen, preps):
    """What K4 returns: (d packed, d pts, d vb per ray)."""
    def launch(packed, pts, vb, g, S, C, splits=32, compute_dtype="float32", *,
               prep):
        seen.append(("bwd", compute_dtype))
        preps.append(prep)
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(True) for t in (packed, pts, vb)]
            w = fused_mlp.unpack(ins[0], C, view_pe=False)
            out = tc.emulated_forward(w, ins[1], None, torch.ones(14),
                                      tc.MODES[compute_dtype],
                                      ins[2].repeat_interleave(S, dim=0))
            return torch.autograd.grad(out, ins, g)
    return launch


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C,S", [(3, 37), (8, 64)])
def test_staged_card_path_wiring(C, S, compute_dtype, monkeypatch):
    """The per-ray view bias, the packing without the view-encoding
    entries and the autograd Function route every gradient to its
    parameter, the points and the viewdirs where autograd through the same
    arithmetic on the parameters sends it, and pass the mode to both
    launches; K4 gets the buffer of wgmma weight copies (without the
    view-encoding weights) that K3's launch filled."""
    seen, preps = [], []
    monkeypatch.setattr(staged_mlp, "launch_fwd", _launch_fwd(seen, preps))
    monkeypatch.setattr(staged_mlp, "launch_bwd", _launch_bwd(seen, preps))
    params, pts, vd, Lv = _inputs(3, S, C, 39, seed=C)

    def card_path(p, x, v, num_freqs_views):
        return staged_mlp._staged(p, x, v, num_freqs_views, 1, compute_dtype)

    got = _port_grads(card_path, params, pts, vd, Lv)
    assert seen == [("fwd", compute_dtype), ("bwd", compute_dtype)]
    assert preps[0] is preps[1]
    assert preps[0].shape == (fused_mlp.prep_table(False, compute_dtype)[1],
                              fused_mlp.PREP_KS[compute_dtype])
    want = _port_grads(_emulated_staged(compute_dtype), params, pts, vd, Lv)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1e-5 * max(np.abs(b).max(), 1.0)


@pytest.mark.parametrize("C", [1, 8])
def test_staged_packed_layout(C):
    """K3/K4's packed vector: K1's layout without the view-encoding entries,
    columns in natural order, every matrix the products stage 16-byte
    aligned, unpack inverting pack; the weights and their gradient share
    it."""
    params, _, _, _ = _inputs(1, 1, C, 39, seed=C)
    tp = bridge.params_from_numpy(params, device="cpu")
    packed = fused_mlp.pack_params(tp, view_pe=False)
    offs = fused_mlp._offsets(fused_mlp._layout(C, view_pe=False))
    assert packed.numel() == offs[-1]
    full = fused_mlp._offsets(fused_mlp._layout(C))
    assert offs[-1] == full[-1] - 27 * 128 - 128
    assert all(o % 4 == 0 for o in offs[:10])
    v = fused_mlp.unpack(packed, C, view_pe=False)
    assert v["wvpe"].numel() == v["bv"].numel() == 0
    raw = packed[offs[4]:offs[4] + 256 * 128].view(256, 128)
    np.testing.assert_array_equal(raw, tp["views"]["w_feat"])
    np.testing.assert_array_equal(v["w0"], tp["pts"][0]["w"])
    np.testing.assert_array_equal(v["wh"][4], tp["pts"][5]["w_h"])
    np.testing.assert_array_equal(v["w5pe"], tp["pts"][5]["w_pe"])
    np.testing.assert_array_equal(v["bf"], tp["feature"]["b"])
    np.testing.assert_array_equal(v["wa"], tp["alpha"]["w"])
    np.testing.assert_array_equal(v["wrgb"], tp["rgb"]["w"])
    np.testing.assert_array_equal(v["brgb"], tp["rgb"]["b"])
    # a flat gradient in the same layout reaches each parameter
    leaves = [t.requires_grad_(True) for t in bridge.tree_leaves(tp)]
    flat = torch.arange(packed.numel(), dtype=torch.float32)
    grads = dict(zip(map(id, leaves), torch.autograd.grad(
        fused_mlp.pack_params(tp, view_pe=False), leaves, flat,
        allow_unused=True)))
    g = grads[id(tp["rgb"]["w"])]
    np.testing.assert_array_equal(g.reshape(-1), flat[offs[11]:offs[12]])
    assert grads[id(tp["views"]["w_pe"])] is None


# ---- the route table --------------------------------------------------------


def _jax_route(params, pts, viewdirs, num_freqs, num_freqs_views,
               barf_weights, use_pallas, mesh=False):
    """benerf_tpu/ops/mlp.py:67-82 on a Pallas backend, with its own
    predicates; with `mesh`, its mlp_forward_families over several families
    under a mesh (:239-247, :310-326): the fused kernel where `kernel_ok`,
    else jnp."""
    if not use_pallas or viewdirs is None:
        return "plain"
    if (pallas_mlp_t.supports(params, pts)
            and num_freqs == 10 and num_freqs_views == 4):
        return "fused"
    if mesh:
        return "plain"
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
            tparams = bridge.params_from_numpy(jparams, device="cpu")
            vd = np.zeros((2, 3), np.float32) if use_viewdirs else None
            Lv = (views_ch - 3) // 6
            for barf in (False, True):
                bw = np.ones(10, np.float32) if barf else None
                for use_pallas in (True, False):
                    for mesh in (False, True):
                        want = _jax_route(jparams, pts, vd, 10, Lv, bw,
                                          use_pallas, mesh)
                        got = tmlp.route(tparams, vd, 10, Lv, barf,
                                         use_pallas, mesh)
                        assert got == want, (views_ch, C, barf, use_pallas,
                                             mesh, got, want)
                        routes.add(got)
    if (width, depth, use_viewdirs) == (256, 8, True):
        assert routes == {"fused", "staged", "plain"}
    else:
        assert routes == {"plain"}


def test_cpu_tensors_take_the_plain_version_on_every_route():
    params, pts, vd, Lv = _inputs(2, 8, 3, 39, seed=4)
    tp = bridge.params_from_numpy(params, device="cpu")
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
    tp = bridge.params_from_numpy(params, device="cpu")
    with pytest.raises(ValueError, match="num_freqs=6"):
        staged_mlp.staged_nerf_mlp(tp, torch.as_tensor(pts),
                                   torch.as_tensor(vd), num_freqs=6)
    with pytest.raises(ValueError):
        fused_mlp.fused_nerf_mlp(tp, torch.as_tensor(pts), torch.as_tensor(vd),
                                 num_freqs=6)

"""PyTorch port's NeRF MLP vs the JAX package: the plain version
(models/nerf.apply), the CPU route of ops/fused_mlp and ops/mlp, the weight
packing the CUDA kernels read, and the parameter bridge.

Inputs are made with numpy from a seed and handed to both sides; the JAX
parameters cross over through bridge.params_from_numpy. The JAX kernel runs
in Pallas interpret mode, as tests/test_pallas_t.py runs it.
Tolerances as tests/test_pallas_t.py: forward atol 2e-4, gradients atol
5e-4 * max(scale, 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benerf_tpu.models import embedder as jemb
from benerf_tpu.models import nerf as jnerf
from benerf_tpu.ops import pallas_mlp_t
from benerf_tpu_torch.models import bridge
from benerf_tpu_torch.models import nerf as tnerf
from benerf_tpu_torch.ops import fused_mlp, mlp_kernels
from benerf_tpu_torch.ops import mlp as tmlp


@pytest.fixture
def interpret_mode():
    pallas_mlp_t.INTERPRET = True
    yield
    pallas_mlp_t.INTERPRET = False


def _inputs(R, S, C, seed, barf):
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        np.asarray, jnerf.init_params(jax.random.PRNGKey(seed), channels=C))
    # small nonzero biases so every bias gradient is exercised
    params = jax.tree.map(
        lambda a: (a + rng.uniform(-0.05, 0.05, a.shape)).astype(np.float32)
        if a.ndim == 1 else a, params)
    pts = rng.uniform(-1.0, 1.0, (R, S, 3)).astype(np.float32)
    vd = rng.normal(size=(R, 3))
    vd = (vd / np.linalg.norm(vd, axis=-1, keepdims=True)).astype(np.float32)
    bw = bwv = None
    if barf:
        bw = np.asarray(jemb.barf_c2f_weights(1000, 8000, 10, 0.1, 0.5), np.float32)
        bwv = np.asarray(jemb.barf_c2f_weights(1000, 8000, 4, 0.1, 0.5), np.float32)
    return params, pts, vd, bw, bwv


def _t(x):
    return None if x is None else torch.as_tensor(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


def _port_grads(fn, params_np, pts, vd, bw, bwv):
    params = bridge.params_from_numpy(params_np, device="cpu")
    leaves = bridge.tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    x, v = torch.tensor(pts, requires_grad=True), torch.tensor(vd, requires_grad=True)
    out = fn(params, x, v, barf_weights=_t(bw), barf_weights_views=_t(bwv))
    grads = torch.autograd.grad(torch.sum(torch.sin(out)), leaves + [x, v])
    return [g.numpy() for g in grads]


def _jax_grads(fn, params_np, pts, vd, bw, bwv):
    def loss(p, x, d):
        return jnp.sum(jnp.sin(fn(p, x, d, barf_weights=_j(bw),
                                  barf_weights_views=_j(bwv))))

    gp, gx, gd = jax.grad(loss, argnums=(0, 1, 2))(
        jax.tree.map(jnp.asarray, params_np), jnp.asarray(pts), jnp.asarray(vd))
    return [np.asarray(g) for g in bridge.tree_leaves(gp)] + [
        np.asarray(gx), np.asarray(gd)]


def _assert_grads_close(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        scale = max(np.abs(b).max(), 1.0)
        err = np.abs(a - b).max()
        assert err <= 5e-4 * scale, f"grad {b.shape}: {err} vs scale {scale}"


@pytest.mark.parametrize("barf", [False, True])
@pytest.mark.parametrize("S", [64, 128])
@pytest.mark.parametrize("C", [1, 3])
def test_forward_matches_jax(C, S, barf):
    # R * S = 5 * S does not divide the JAX kernel's 1024-point tile
    params, pts, vd, bw, bwv = _inputs(5, S, C, seed=C + S, barf=barf)
    want = np.asarray(jnerf.apply(jax.tree.map(jnp.asarray, params),
                                  jnp.asarray(pts), jnp.asarray(vd),
                                  barf_weights=_j(bw), barf_weights_views=_j(bwv)))
    tp = bridge.params_from_numpy(params, device="cpu")
    for fn in (tnerf.apply, fused_mlp.fused_nerf_mlp, tmlp.mlp_forward):
        got = fn(tp, torch.as_tensor(pts), torch.as_tensor(vd),
                 barf_weights=_t(bw), barf_weights_views=_t(bwv)).numpy()
        assert got.shape == (5, S, C + 1)
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)


@pytest.mark.parametrize("C,S,barf", [(3, 64, False), (1, 128, True)])
def test_forward_matches_pallas_kernel(C, S, barf, interpret_mode):
    params, pts, vd, bw, bwv = _inputs(3, S, C, seed=7, barf=barf)
    want = np.asarray(pallas_mlp_t.fused_nerf_mlp(
        jax.tree.map(jnp.asarray, params), jnp.asarray(pts), jnp.asarray(vd),
        barf_weights=_j(bw), barf_weights_views=_j(bwv)))
    got = fused_mlp.fused_nerf_mlp(
        bridge.params_from_numpy(params, device="cpu"), torch.as_tensor(pts),
        torch.as_tensor(vd), barf_weights=_t(bw), barf_weights_views=_t(bwv))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-4)


@pytest.mark.parametrize("C,S,barf", [(3, 64, False), (1, 128, True), (3, 37, True)])
def test_gradients_match_jax(C, S, barf):
    inputs = _inputs(4, S, C, seed=11, barf=barf)
    want = _jax_grads(jnerf.apply, *inputs)
    for fn in (tnerf.apply, fused_mlp.fused_nerf_mlp):
        _assert_grads_close(_port_grads(fn, *inputs), want)


def test_gradients_match_pallas_kernel(interpret_mode):
    """Tail-tile regression shape of test_bwd_tile_not_dividing_fwd_pad:
    16 x 64 = 1024 points, the JAX backward tile 768 does not divide it."""
    inputs = _inputs(16, 64, 3, seed=3, barf=True)
    want = _jax_grads(pallas_mlp_t.fused_nerf_mlp, *inputs)
    got = _port_grads(fused_mlp.fused_nerf_mlp, *inputs)
    _assert_grads_close(got, want)
    assert np.abs(got[-2].reshape(-1, 3)[800:]).sum() > 0  # the tail's points


def test_mlp_forward_families_is_one_call_split():
    params, pts, vd, _, _ = _inputs(6, 64, 3, seed=5, barf=False)
    tp = bridge.params_from_numpy(params, device="cpu")
    p, v = torch.as_tensor(pts), torch.as_tensor(vd)
    outs = tmlp.mlp_forward_families(tp, [(p[:2], v[:2]), (p[2:], v[2:])])
    whole = tmlp.mlp_forward(tp, p, v)
    assert [o.shape[0] for o in outs] == [2, 4]
    np.testing.assert_array_equal(torch.cat(outs).numpy(), whole.numpy())


def test_bfloat16_plain_path_runs_on_cpu():
    params, pts, vd, _, _ = _inputs(2, 64, 3, seed=1, barf=False)
    tp = bridge.params_from_numpy(params, device="cpu")
    f32 = tmlp.mlp_forward(tp, torch.as_tensor(pts), torch.as_tensor(vd))
    bf16 = tmlp.mlp_forward(tp, torch.as_tensor(pts), torch.as_tensor(vd),
                            compute_dtype="bfloat16")
    assert bf16.dtype == torch.float32
    scale = f32.abs().max().item()
    assert torch.allclose(f32, bf16, atol=2e-2 * scale)
    assert not torch.equal(f32, bf16)


def test_bridge_round_trip():
    params, _, _, _, _ = _inputs(1, 1, 3, seed=0, barf=False)
    tp = bridge.params_from_numpy(params, device="cpu")
    assert isinstance(tp["pts"], list) and set(tp) == set(params)
    back = bridge.params_to_numpy(tp)
    flat_a, flat_b = bridge.tree_leaves(params), bridge.tree_leaves(back)
    assert len(flat_a) == len(flat_b) == 26
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # tree_unflatten inverts tree_leaves
    again = bridge.tree_unflatten(tp, bridge.tree_leaves(tp))
    for a, b in zip(bridge.tree_leaves(again), bridge.tree_leaves(tp)):
        assert a is b


@pytest.mark.parametrize("C", [1, 3])
def test_packed_layouts(C):
    """The flat vectors the kernels read: each matrix row-major in its
    (fan_in, fan_out) orientation with its columns in natural order,
    packing inverts through unpack, and K3/K4's vector (view_pe=False) is
    K1/K2's without the view-encoding weights and bias."""
    params, _, _, _, _ = _inputs(1, 1, C, seed=C, barf=False)
    tp = bridge.params_from_numpy(params, device="cpu")
    packed = mlp_kernels.pack_params(tp)
    v = mlp_kernels.unpack(packed, C)
    assert packed.numel() == mlp_kernels.packed_size(C)
    assert all(o % 4 == 0 for o in mlp_kernels.offsets(mlp_kernels.layout(C))[:10])
    np.testing.assert_array_equal(v["w0"], tp["pts"][0]["w"])
    np.testing.assert_array_equal(v["wh"][4], tp["pts"][5]["w_h"])
    np.testing.assert_array_equal(v["wh"][5], tp["pts"][6]["w"])
    np.testing.assert_array_equal(v["w5pe"], tp["pts"][5]["w_pe"])
    np.testing.assert_array_equal(v["b"][7], tp["pts"][7]["b"])
    np.testing.assert_array_equal(v["wvpe"], tp["views"]["w_pe"])
    np.testing.assert_array_equal(v["wa"], tp["alpha"]["w"])
    np.testing.assert_array_equal(v["wrgb"], tp["rgb"]["w"])
    np.testing.assert_array_equal(v["brgb"], tp["rgb"]["b"])
    raw = packed[:63 * 256].view(63, 256)
    np.testing.assert_array_equal(raw[:, 5 + 32 * 3], tp["pts"][0]["w"][:, 5 + 32 * 3])
    staged = mlp_kernels.pack_params(tp, view_pe=False)
    offs = mlp_kernels.offsets(mlp_kernels.layout(C))
    cut = torch.cat([packed[:offs[5]], packed[offs[6]:offs[8]], packed[offs[9]:]])
    assert torch.equal(staged, cut)


def test_supports_predicate():
    params, _, _, _, _ = _inputs(1, 1, 3, seed=0, barf=False)
    tp = bridge.params_from_numpy(params, device="cpu")
    assert fused_mlp.supports(tp)
    assert not fused_mlp.supports({k: v for k, v in tp.items() if k != "views"})
    narrow = bridge.params_from_numpy(jax.tree.map(
        np.asarray, jnerf.init_params(jax.random.PRNGKey(0), width=64)), device="cpu")
    assert not fused_mlp.supports(narrow)

"""The port's CUDA kernels K1/K2 (both modes) and K3/K4 on the card, against
the plain PyTorch version (models/nerf.apply), and the MLP dispatcher's
card routes. CUDA kernels have no CPU mode: every test here
carries the `cuda` marker and skips without a card. Imports no JAX, so it
also runs where JAX is not installed (the repository's conftest imports
JAX; skip it there):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

chip_smoke.py holds the kernels to the same bounds at the training shapes.
"""

import pytest
import torch

from benerf_tpu_torch.models import bridge, embedder, nerf
from benerf_tpu_torch.ops import fused_mlp, staged_mlp
from benerf_tpu_torch.ops import mlp as mlp_ops

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = tf32


def _inputs(R, S, C, barf, seed=0, width=256, views_ch=27):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    params = nerf.init_params(g, width=width, channels=C,
                              input_ch_views=views_ch, device="cuda")
    params = bridge.tree_map(lambda t: t + 0.05 * torch.rand(
        t.shape, generator=g, device="cuda") if t.ndim == 1 else t, params)
    pts = torch.rand((R, S, 3), generator=g, device="cuda") * 2 - 1
    vd = torch.nn.functional.normalize(
        torch.randn((R, 3), generator=g, device="cuda"), dim=-1)
    kw = {}
    if barf:
        kw = dict(barf_weights=embedder.barf_c2f_weights(
                      1000, 8000, 10, 0.1, 0.5, device="cuda"),
                  barf_weights_views=embedder.barf_c2f_weights(
                      1000, 8000, 4, 0.1, 0.5, device="cuda"))
    return params, pts, vd, kw


@pytest.mark.parametrize("R,S", [(3, 37), (5, 64)])
@pytest.mark.parametrize("C,barf", [(1, True), (3, False), (7, True)])
def test_kernels_match_plain_at_a_ragged_size(card, C, barf, R, S):
    """K1/K2 in fp32 mode (TF32X3). 3 x 37 = 111 points leave a ragged last
    tile: its outputs and its gradients must not be dropped; 5 x 64 fills
    five tiles. C = 7 is the widest K1/K2 take (C + 1 <= 8)."""
    params, pts, vd, kw = _inputs(R, S, C, barf)
    leaves = [t.requires_grad_(True) for t in bridge.tree_leaves(params)]
    x, v = pts.requires_grad_(True), vd.requires_grad_(True)
    before = dict(fused_mlp.LAUNCHES)
    out_k = fused_mlp.fused_nerf_mlp(params, x, v, **kw)
    grads_k = torch.autograd.grad(torch.sin(out_k).sum(), leaves + [x, v])
    assert fused_mlp.LAUNCHES["fused_mlp_fwd"] == before["fused_mlp_fwd"] + 1
    assert fused_mlp.LAUNCHES["fused_mlp_bwd"] == before["fused_mlp_bwd"] + 1
    out_p = nerf.apply(params, x, v, **kw)
    grads_p = torch.autograd.grad(torch.sin(out_p).sum(), leaves + [x, v])
    scale = max(out_p.abs().max().item(), 1.0)
    torch.testing.assert_close(out_k, out_p, rtol=0, atol=2e-4 * scale)
    for a, b in zip(grads_k, grads_p):
        scale = max(b.abs().max().item(), 1.0)
        torch.testing.assert_close(a, b, rtol=0, atol=5e-4 * scale)
    assert grads_k[-2][-1].abs().sum() > 0  # the ragged tile's points


def _grads(fn, params, x, v, **kw):
    leaves = [t.detach().requires_grad_(True) for t in bridge.tree_leaves(params)]
    p = bridge.tree_unflatten(params, leaves)
    xg, vg = x.detach().requires_grad_(True), v.detach().requires_grad_(True)
    return torch.autograd.grad(torch.sin(fn(p, xg, vg, **kw)).sum(), leaves + [xg, vg])


def _dist(got, want):
    """Worst max|a - b| / max(|b|, 1) over gradient pairs."""
    return max(float((a.double() - b).abs().max()) / max(float(b.abs().max()), 1.0)
               for a, b in zip(got, want))


@pytest.mark.parametrize("R,S", [(3, 37), (5, 64)])
@pytest.mark.parametrize("C,barf", [(1, True), (3, False), (7, True)])
def test_bf16_kernels_match_plain_at_a_ragged_size(card, C, barf, R, S):
    """K1/K2 in bf16 mode: the forward within test_bfloat16_mode's 2e-2 x
    scale of nerf.apply with bf16 operands; gradients finite, and no
    farther from a float64 run than twice the plain bf16 version's
    distance (chip_smoke.py's BF16_GRAD_FACTOR)."""
    params, pts, vd, kw = _inputs(R, S, C, barf)
    before = dict(fused_mlp.LAUNCHES)
    with torch.no_grad():
        out_k = fused_mlp.fused_nerf_mlp(params, pts, vd, compute_dtype="bfloat16", **kw)
        out_p = nerf.apply(params, pts, vd, compute_dtype=torch.bfloat16, **kw)
    scale = max(out_p.abs().max().item(), 1.0)
    torch.testing.assert_close(out_k, out_p, rtol=0, atol=2e-2 * scale)
    gk = _grads(fused_mlp.fused_nerf_mlp, params, pts, vd, compute_dtype="bfloat16", **kw)
    assert fused_mlp.LAUNCHES["fused_mlp_fwd_bf16"] == before["fused_mlp_fwd_bf16"] + 2
    assert fused_mlp.LAUNCHES["fused_mlp_bwd_bf16"] == before["fused_mlp_bwd_bf16"] + 1
    assert fused_mlp.LAUNCHES["fused_mlp_fwd"] == before["fused_mlp_fwd"]
    gp = _grads(nerf.apply, params, pts, vd, compute_dtype=torch.bfloat16, **kw)
    g64 = _grads(nerf.apply, bridge.tree_map(lambda t: t.double(), params),
                 pts.double(), vd.double(), **{k: t.double() for k, t in kw.items()})
    assert all(bool(torch.isfinite(g).all()) for g in gk)
    assert _dist(gk[:-2], g64[:-2]) <= 2.0 * _dist(gp[:-2], g64[:-2])
    assert gk[-2][-1].abs().sum() > 0  # the last tile's points


@pytest.mark.parametrize("a,b", [(1, 13), (7, 32)])
def test_weight_gradients_do_not_depend_on_the_split_count(card, a, b):
    params, pts, vd, _ = _inputs(40, 64, 3, False, seed=1)
    leaves = [t.requires_grad_(True) for t in bridge.tree_leaves(params)]

    def grads(splits):
        out = fused_mlp.fused_nerf_mlp(params, pts, vd, splits=splits)
        return torch.autograd.grad(torch.sin(out).sum(), leaves)

    for x, y in zip(grads(a), grads(b)):
        scale = max(y.abs().max().item(), 1.0)
        torch.testing.assert_close(x, y, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("C", [1, 3, 8])
def test_staged_kernels_match_plain_at_a_ragged_size(card, C):
    """K3/K4 with a view encoding of L = 6 at 3 x 37 points: a ray's
    samples straddle tiles and the last tile is ragged."""
    params, pts, vd, _ = _inputs(3, 37, C, False, seed=C, views_ch=39)
    leaves = [t.requires_grad_(True) for t in bridge.tree_leaves(params)]
    x, v = pts.requires_grad_(True), vd.requires_grad_(True)
    before = dict(staged_mlp.LAUNCHES)
    out_k = staged_mlp.staged_nerf_mlp(params, x, v, num_freqs_views=6)
    grads_k = torch.autograd.grad(torch.sin(out_k).sum(), leaves + [x, v])
    assert staged_mlp.LAUNCHES["staged_mlp_fwd"] == before["staged_mlp_fwd"] + 1
    assert staged_mlp.LAUNCHES["staged_mlp_bwd"] == before["staged_mlp_bwd"] + 1
    out_p = nerf.apply(params, x, v, num_freqs_views=6)
    grads_p = torch.autograd.grad(torch.sin(out_p).sum(), leaves + [x, v])
    scale = max(out_p.abs().max().item(), 1.0)
    torch.testing.assert_close(out_k, out_p, rtol=0, atol=2e-4 * scale)
    for a, b in zip(grads_k, grads_p):
        scale = max(b.abs().max().item(), 1.0)
        torch.testing.assert_close(a, b, rtol=0, atol=5e-4 * scale)
    assert grads_k[-2][-1].abs().sum() > 0  # the ragged tile's points


def test_staged_weight_gradients_do_not_depend_on_the_split_count(card):
    params, pts, vd, _ = _inputs(40, 64, 3, False, seed=1, views_ch=39)
    leaves = [t.requires_grad_(True) for t in bridge.tree_leaves(params)]

    def grads(splits):
        out = staged_mlp.staged_nerf_mlp(params, pts, vd, num_freqs_views=6,
                                         splits=splits)
        return torch.autograd.grad(torch.sin(out).sum(), leaves)

    for a, b in zip(grads(1), grads(13)):
        scale = max(b.abs().max().item(), 1.0)
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * scale)


def test_card_path_raises_where_the_kernel_does_not_apply(card):
    """A kernel route or the plain route where the JAX package has no
    kernel; bf16 runs K1/K2 in their bf16 mode on the fused route and raises
    on the staged one; an encoding that does not match w0 raises."""
    params, pts, vd, _ = _inputs(2, 8, 3, False)
    before = fused_mlp.LAUNCHES["fused_mlp_fwd_bf16"]
    out = mlp_ops.mlp_forward(params, pts, vd, compute_dtype="bfloat16")
    assert fused_mlp.LAUNCHES["fused_mlp_fwd_bf16"] == before + 1
    torch.testing.assert_close(
        out, nerf.apply(params, pts, vd, compute_dtype=torch.bfloat16), rtol=0,
        atol=2e-2 * max(out.abs().max().item(), 1.0))
    l6, _, _, _ = _inputs(2, 8, 3, False, views_ch=39)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mlp_ops.mlp_forward(l6, pts, vd, num_freqs_views=6, compute_dtype="bfloat16")
    with pytest.raises(ValueError):
        mlp_ops.mlp_forward(params, pts, vd, num_freqs=6)
    narrow, pts, vd, _ = _inputs(2, 8, 3, False, width=64)
    kernels = dict(fused_mlp.LAUNCHES, **staged_mlp.LAUNCHES)
    plain = mlp_ops.ROUTES["plain"]
    out = mlp_ops.mlp_forward(narrow, pts, vd)
    assert out.shape == (2, 8, 4)
    assert mlp_ops.ROUTES["plain"] == plain + 1
    assert dict(fused_mlp.LAUNCHES, **staged_mlp.LAUNCHES) == kernels

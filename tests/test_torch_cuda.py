"""The port's CUDA kernels K1/K2 on the card, against the plain PyTorch
version (models/nerf.apply). CUDA kernels have no CPU mode: every test here
carries the `cuda` marker and skips without a card. Imports no JAX, so it
also runs where JAX is not installed (the repository's conftest imports
JAX; skip it there):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

chip_smoke.py holds the kernels to the same bounds at the training shapes.
"""

import pytest
import torch

from benerf_tpu_torch.models import bridge, embedder, nerf
from benerf_tpu_torch.ops import fused_mlp
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


def _inputs(R, S, C, barf, seed=0, width=256):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    params = nerf.init_params(g, width=width, channels=C, device="cuda")
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


@pytest.mark.parametrize("C,barf", [(1, True), (3, False)])
def test_kernels_match_plain_at_a_ragged_size(card, C, barf):
    """3 x 37 = 111 points leave a ragged last tile: its outputs and its
    gradients must not be dropped."""
    params, pts, vd, kw = _inputs(3, 37, C, barf)
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


def test_weight_gradients_do_not_depend_on_the_split_count(card):
    params, pts, vd, _ = _inputs(40, 64, 3, False, seed=1)
    leaves = [t.requires_grad_(True) for t in bridge.tree_leaves(params)]

    def grads(splits):
        out = fused_mlp.fused_nerf_mlp(params, pts, vd, splits=splits)
        return torch.autograd.grad(torch.sin(out).sum(), leaves)

    for a, b in zip(grads(1), grads(13)):
        scale = max(b.abs().max().item(), 1.0)
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * scale)


def test_card_path_raises_where_the_kernel_does_not_apply(card):
    """No quiet fallback to the plain version on the card."""
    params, pts, vd, _ = _inputs(2, 8, 3, False)
    with pytest.raises(NotImplementedError):
        mlp_ops.mlp_forward(params, pts, vd, compute_dtype="bfloat16")
    with pytest.raises(NotImplementedError):
        mlp_ops.mlp_forward(params, pts, vd, num_freqs=6)
    narrow, pts, vd, _ = _inputs(2, 8, 3, False, width=64)
    with pytest.raises(NotImplementedError):
        mlp_ops.mlp_forward(narrow, pts, vd)

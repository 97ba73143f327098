"""The port's CUDA kernels K1/K2 and K3/K4 (both modes) on the card, against
the plain PyTorch version (models/nerf.apply), also at ragged sizes through
chip_smoke.py's own checks and tolerances, the weights' wgmma copies bit for
bit against their plain version, their weight-gradient pass
alone against the float64 product of its scratch, the MLP dispatcher's
card routes (use_pallas off included), and the train step captured in a
CUDA graph (train/step.py make_multi_step): equal to the uncaptured steps,
counted per replay, checkpointed and resumed, and under a one-rank NCCL
mesh equal to the unmeshed capture; cli/test.py and cli/evaluate.py on the
card, and LPIPS on the card by default. CUDA kernels have no CPU mode:
every test here
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


@pytest.mark.parametrize("R,S", [(3, 37), (5, 64)])
@pytest.mark.parametrize("C", [1, 3, 8, 127])
def test_staged_kernels_match_plain_at_a_ragged_size(card, C, R, S):
    """K3/K4 in fp32 mode (TF32X3) with a view encoding of L = 6. At 3 x 37
    a ray's samples straddle tiles and the last tile is ragged; C = 127 is
    the widest head space they take (C + 1 <= 128)."""
    params, pts, vd, _ = _inputs(R, S, C, False, seed=C, views_ch=39)
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
    assert grads_k[-2][-1].abs().sum() > 0  # the last tile's points


@pytest.mark.parametrize("R,S", [(3, 37), (5, 64)])
@pytest.mark.parametrize("C", [1, 3, 8, 127])
def test_staged_bf16_kernels_match_plain_at_a_ragged_size(card, C, R, S):
    """K3/K4 in bf16 mode, held as K1/K2's bf16 mode is: the forward within
    2e-2 x scale of nerf.apply with bf16 operands; gradients finite and no
    farther from a float64 run than twice the plain bf16 version's
    distance."""
    params, pts, vd, _ = _inputs(R, S, C, False, seed=C, views_ch=39)
    kw = dict(num_freqs_views=6)
    before = dict(staged_mlp.LAUNCHES)
    with torch.no_grad():
        out_k = staged_mlp.staged_nerf_mlp(params, pts, vd, compute_dtype="bfloat16", **kw)
        out_p = nerf.apply(params, pts, vd, compute_dtype=torch.bfloat16, **kw)
    scale = max(out_p.abs().max().item(), 1.0)
    torch.testing.assert_close(out_k, out_p, rtol=0, atol=2e-2 * scale)
    gk = _grads(staged_mlp.staged_nerf_mlp, params, pts, vd, compute_dtype="bfloat16", **kw)
    assert staged_mlp.LAUNCHES["staged_mlp_fwd_bf16"] == before["staged_mlp_fwd_bf16"] + 2
    assert staged_mlp.LAUNCHES["staged_mlp_bwd_bf16"] == before["staged_mlp_bwd_bf16"] + 1
    assert staged_mlp.LAUNCHES["staged_mlp_fwd"] == before["staged_mlp_fwd"]
    gp = _grads(nerf.apply, params, pts, vd, compute_dtype=torch.bfloat16, **kw)
    g64 = _grads(nerf.apply, bridge.tree_map(lambda t: t.double(), params),
                 pts.double(), vd.double(), **kw)
    assert all(bool(torch.isfinite(g).all()) for g in gk)
    assert _dist(gk[:-2], g64[:-2]) <= 2.0 * _dist(gp[:-2], g64[:-2])
    assert gk[-2][-1].abs().sum() > 0  # the last tile's points


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


def _filled_scratch(view_pe, n, C=3, seed=0):
    if view_pe:
        n_pad, x_scr, d_scr = fused_mlp.bwd_scratch(n, "cuda")
    else:
        n_pad, x_scr, d_scr, _ = staged_mlp.bwd_scratch(n, C, "cuda")
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return n_pad, x_scr.normal_(generator=g), d_scr.normal_(generator=g)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("view_pe", [True, False], ids=["K2", "K4"])
@pytest.mark.parametrize("n", [111, 320, 4000])
def test_weight_gradient_pass_matches_float64(card, n, view_pe, compute_dtype):
    """The TMA + wgmma weight-gradient pass alone, K2's and K4's job tables,
    against the float64 product of the same scratch (bf16 mode: of its
    bf16-rounded operands), every job within chip_smoke.py's WGRAD_TOL
    (1e-5) x max |ref|, at split counts that leave chunks empty (111 points
    at 32 splits), ragged or whole."""
    C = 3
    n_pad, x_scr, d_scr = _filled_scratch(view_pe, n, C)
    ref = fused_mlp.wgrad_plain(x_scr, d_scr, n_pad, C, view_pe, compute_dtype)
    for splits in (1, 7, 32):
        got = fused_mlp.run_wgrad(x_scr, d_scr, n_pad, C, splits, compute_dtype,
                                  view_pe)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(got).all())
        for name, off, size in fused_mlp.wgrad_ranges(C, view_pe):
            a, b = got[off:off + size].double(), ref[off:off + size]
            assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max()), name


# ---- the wgmma layer products (csrc/wgmma_layer.cuh) at ragged sizes -------
#
# chip_smoke.py's checks, with its tolerances unchanged (FWD_TOL 2e-4,
# GRAD_TOL 5e-4 x scale with at most KINK_FRAC 1e-3 of the per-point
# gradient elements past it, and in bf16 mode the gradients' distance to
# float64 between 0.3x and 2x the plain bf16 version's). (R, S): n = 1, 63
# (one partial tile), 65 (rays of 13 samples straddle the first tile's end)
# and 200 (not a multiple of 128; rays of 25 straddle tiles); and the size
# of a rank's share of the training path's 3,055 rays on a two-rank mesh
# (1,527 and 1,528 rays of 64 coarse / 128 fine samples).
RAGGED = [(1, 1), (7, 9), (5, 13), (8, 25)]
RAGGED_IDS = ["n1", "n63", "n65", "n200"]
MESH_SHARE = [(1527, 64), (1528, 128)]


def _smoke():
    import chip_smoke

    return chip_smoke


@pytest.mark.parametrize("R,S", RAGGED + MESH_SHARE,
                         ids=RAGGED_IDS + ["mesh_coarse", "mesh_fine"])
@pytest.mark.parametrize("C", [1, 3, 7])
def test_fused_kernels_at_ragged_sizes_with_barf(card, R, S, C):
    """K1/K2 in fp32 mode (TF32X3), BARF band weights on."""
    cs = _smoke()
    cs.check_fwd(torch, "K1/K2", R, S, C, True)
    cs.check_bwd(torch, "K1/K2", R, S, C, True)


def _bf16_one_point_launches(which, C, barf, points=16, seed=0):
    """The bf16 band at n = 1: `points` single points under the same weights,
    each through its own launch (a one-point tile), held together. A single
    point's distance to float64 is set by the bf16 rounding of a handful of
    values: over 20 seeds the kernel's ratio to the plain bf16 version's
    ran from 0.02 to 10, and the mma.sync kernels' was the same to two digits
    (PERF.md), so the band is held on the sum of their weight gradients
    and on their per-point gradients together (a 16-point batch's
    statistics), each forward at BF16_FWD_TOL on its own."""
    cs = _smoke()
    op, views_ch, kw = cs._pair(which)
    params, pts, vd, bw, bwv = cs._inputs(torch, points, 1, C, seed, barf, views_ch)
    barf_kw = cs._barf_kw(bw, bwv)
    kw = {**kw, **barf_kw}
    kw64 = {**kw, **{k: v.double() for k, v in barf_kw.items()}}
    runs = {"kernel": [], "plain": [], "f64": []}
    for i in range(points):
        x, v = pts[i:i + 1], vd[i:i + 1]
        with torch.no_grad():
            out_k = op(params, x, v, compute_dtype="bfloat16", **kw)
            out_p = nerf.apply(params, x, v, compute_dtype=torch.bfloat16, **kw)
        err, scale = cs._max_err(out_k, out_p)
        assert err <= cs.BF16_FWD_TOL * scale, (i, err)
        runs["kernel"].append(cs._grads(torch, op, params, x, v,
                                        compute_dtype="bfloat16", **kw))
        runs["plain"].append(cs._grads(torch, nerf.apply, params, x, v,
                                       compute_dtype=torch.bfloat16, **kw))
        runs["f64"].append(cs._grads(torch, nerf.apply, cs._f64(torch, params),
                                     x.double(), v.double(), **kw64))
    n_w = len(runs["f64"][0]) - 2
    pooled = {k: [sum(r[j] for r in rs) for j in range(n_w)]
              + [torch.cat([r[j] for r in rs]) for j in (n_w, n_w + 1)]
              for k, rs in runs.items()}
    gk, gp, g64 = pooled["kernel"], pooled["plain"], pooled["f64"]
    assert all(bool(torch.isfinite(g).all()) for g in gk)
    wk, wp = cs._dist(gk[:n_w], g64[:n_w]), cs._dist(gp[:n_w], g64[:n_w])
    pk = max(cs._rms_rel(a, b) for a, b in zip(gk[n_w:], g64[n_w:]))
    pp = max(cs._rms_rel(a, b) for a, b in zip(gp[n_w:], g64[n_w:]))
    lo, hi = cs.BF16_GRAD_FLOOR, cs.BF16_GRAD_FACTOR
    assert lo * wp <= wk <= hi * wp, (wk, wp)
    assert lo * pp <= pk <= hi * pp, (pk, pp)


@pytest.mark.parametrize("R,S", RAGGED, ids=RAGGED_IDS)
@pytest.mark.parametrize("C", [1, 3, 7])
def test_fused_bf16_kernels_at_ragged_sizes_with_barf(card, R, S, C):
    """K1/K2 in bf16 mode, BARF band weights on (n = 1: sixteen one-point
    launches held together, `_bf16_one_point_launches`)."""
    if R * S == 1:
        _bf16_one_point_launches("K1/K2", C, True)
    else:
        _smoke().check_bf16(torch, "K1/K2", R, S, C, True)


@pytest.mark.parametrize("R,S", RAGGED, ids=RAGGED_IDS)
@pytest.mark.parametrize("C", [1, 3, 8, 127])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_staged_kernels_at_ragged_sizes(card, R, S, C, compute_dtype):
    """K3/K4 (view encoding L = 6) in both modes; C = 127 fills the head
    space (bf16 at n = 1: as K1/K2's)."""
    cs = _smoke()
    if compute_dtype == "float32":
        cs.check_fwd(torch, "K3/K4", R, S, C, False)
        cs.check_bwd(torch, "K3/K4", R, S, C, False)
    elif R * S == 1:
        _bf16_one_point_launches("K3/K4", C, False)
    else:
        cs.check_bf16(torch, "K3/K4", R, S, C, False)


@pytest.mark.parametrize("view_pe", [True, False], ids=["K1K2", "K3K4"])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_weight_copies_equal_their_plain_version(card, view_pe, compute_dtype):
    """The weights' wgmma copies (prep_kernel, inside every K1 / K3 launch)
    bit for bit against fused_mlp.prepare_weights_plain; K1's launch leaves
    the same copies in the buffer it is given."""
    params, pts, vd, _ = _inputs(2, 8, 3, False, views_ch=27 if view_pe else 39)
    packed = fused_mlp.pack_params(params, view_pe=view_pe).contiguous()
    got = fused_mlp.prepare_weights(packed, 3, view_pe, compute_dtype)
    want = fused_mlp.prepare_weights_plain(packed, view_pe, compute_dtype)
    assert got.dtype == want.dtype and torch.equal(got, want)
    if view_pe:
        prep = fused_mlp.prep_buffer(True, compute_dtype, "cuda")
        fused_mlp.launch_fwd(packed, pts.reshape(-1, 3).contiguous(), vd,
                             fused_mlp.band_weights(None, None, "cuda"), 8, 3,
                             compute_dtype, prep=prep)
        assert torch.equal(prep, want)


def test_lpips_runs_on_the_card_unless_asked_for_the_cpu(card, tmp_path,
                                                         monkeypatch):
    """eval/metrics.lpips, compute_img_metric(..., "lpips") and
    lpips_torch.compute without a device put the network on the card;
    device="cpu" puts it on the CPU."""
    import numpy as np

    from benerf_tpu_torch.eval import lpips_torch
    from benerf_tpu_torch.eval import metrics

    torch.save({}, tmp_path / "empty.pth")
    torch.manual_seed(0)
    torch.save(lpips_torch._build(str(tmp_path / "empty.pth")).state_dict(),
               tmp_path / "lpips.pth")
    monkeypatch.setenv("BENERF_LPIPS_WEIGHTS", str(tmp_path / "lpips.pth"))
    monkeypatch.setattr(lpips_torch, "_MODEL", None)
    rng = np.random.default_rng(0)
    a, b = rng.random((32, 40, 3)), rng.random((32, 40, 3))
    for call in (lambda **kw: metrics.lpips(a, b, **kw),
                 lambda **kw: metrics.compute_img_metric(a, b, "lpips", **kw),
                 lambda **kw: lpips_torch.compute(a, b, **kw)):
        assert call() is not None
        assert next(lpips_torch._MODEL.parameters()).device.type == "cuda"
        call(device="cpu")
        assert next(lpips_torch._MODEL.parameters()).device.type == "cpu"


def test_card_path_raises_where_the_kernel_does_not_apply(card):
    """A kernel route or the plain route where the JAX package has no
    kernel; bf16 runs K1/K2 and K3/K4 in their bf16 mode; an encoding that
    does not match w0 raises."""
    params, pts, vd, _ = _inputs(2, 8, 3, False)
    before = fused_mlp.LAUNCHES["fused_mlp_fwd_bf16"]
    out = mlp_ops.mlp_forward(params, pts, vd, compute_dtype="bfloat16")
    assert fused_mlp.LAUNCHES["fused_mlp_fwd_bf16"] == before + 1
    torch.testing.assert_close(
        out, nerf.apply(params, pts, vd, compute_dtype=torch.bfloat16), rtol=0,
        atol=2e-2 * max(out.abs().max().item(), 1.0))
    l6, _, _, _ = _inputs(2, 8, 3, False, views_ch=39)
    before = staged_mlp.LAUNCHES["staged_mlp_fwd_bf16"]
    out = mlp_ops.mlp_forward(l6, pts, vd, num_freqs_views=6, compute_dtype="bfloat16")
    assert staged_mlp.LAUNCHES["staged_mlp_fwd_bf16"] == before + 1
    torch.testing.assert_close(
        out, nerf.apply(l6, pts, vd, num_freqs_views=6, compute_dtype=torch.bfloat16),
        rtol=0, atol=2e-2 * max(out.abs().max().item(), 1.0))
    with pytest.raises(ValueError):
        mlp_ops.mlp_forward(params, pts, vd, num_freqs=6)
    narrow, pts, vd, _ = _inputs(2, 8, 3, False, width=64)
    kernels = dict(fused_mlp.LAUNCHES, **staged_mlp.LAUNCHES)
    plain = mlp_ops.ROUTES["plain"]
    out = mlp_ops.mlp_forward(narrow, pts, vd)
    assert out.shape == (2, 8, 4)
    assert mlp_ops.ROUTES["plain"] == plain + 1
    assert dict(fused_mlp.LAUNCHES, **staged_mlp.LAUNCHES) == kernels


def test_use_pallas_off_sends_card_calls_to_the_plain_route(card):
    """use_pallas = False (the JAX package's flag) runs nerf.apply on the
    card, counted in ROUTES["plain"], and launches no kernel, for both the
    fused and the staged architecture; RenderSettings carries the flag."""
    from benerf_tpu_torch.core.config import Config
    from benerf_tpu_torch.render import renderer

    assert not renderer.RenderSettings.from_config(Config(use_pallas=False)).use_pallas
    params, pts, vd, _ = _inputs(2, 8, 3, False)
    l6, _, _, _ = _inputs(2, 8, 3, False, views_ch=39)
    kernels = dict(fused_mlp.LAUNCHES, **staged_mlp.LAUNCHES)
    plain = mlp_ops.ROUTES["plain"]
    out = mlp_ops.mlp_forward(params, pts, vd, use_pallas=False)
    out6 = mlp_ops.mlp_forward(l6, pts, vd, num_freqs_views=6, use_pallas=False)
    assert mlp_ops.ROUTES["plain"] == plain + 2
    assert dict(fused_mlp.LAUNCHES, **staged_mlp.LAUNCHES) == kernels
    torch.testing.assert_close(out, nerf.apply(params, pts, vd), rtol=0, atol=0)
    torch.testing.assert_close(out6, nerf.apply(l6, pts, vd, num_freqs_views=6),
                               rtol=0, atol=0)


# ---- the captured train step (train/step.py make_multi_step) ---------------


def _small_run(fast_ray_sampling=True, views_ch=27):
    """A small BeNeRF step on the card with the 8x256 MLPs (so the kernels
    run): configs/demo.txt at 40x40, 64 event + 38 rgb rays, 16 + 16
    samples, on a random scene of 4,000 events -> (cfg, batch, make_state).
    views_ch 39: both MLPs built with a view encoding of L = 6 (K3/K4)."""
    import dataclasses
    import pathlib

    from benerf_tpu_torch.core.config import load_config
    from benerf_tpu_torch.data import datasets
    from benerf_tpu_torch.data import events as events_mod
    from benerf_tpu_torch.train import loop
    from benerf_tpu_torch.train import step as step_mod

    cfg = load_config(str(pathlib.Path(__file__).resolve().parents[1]
                          / "configs" / "demo.txt"))
    cams = {f"{c}_{k}": v for c in ("rgb", "event") for k, v in (
        ("height", 40), ("width", 40), ("fx", 50.0), ("fy", 50.0),
        ("cx", 20.0), ("cy", 20.0))}
    cfg = dataclasses.replace(
        cfg, sampling_event_rays=64, sampling_rgb_rays=38, N_samples=16,
        N_importance=16, fast_ray_sampling=fast_ray_sampling,
        multires_views=(views_ch - 3) // 6, optimize_trans=True, **cams)
    scene = datasets.random_scene(cfg, 4000, seed=1, device="cuda")
    cfg = dataclasses.replace(cfg, event_window_cap=events_mod.window_cap(
        scene.events.ts.cpu().numpy(), cfg.accumulate_time_length))
    batch = loop.make_batch(scene, cfg, *loop.intrinsics(cfg)[:2], "cuda")

    def make_state():
        params = step_mod.build_params(cfg, cfg.seed, device="cuda")
        if views_ch != 27:
            g = torch.Generator(device="cuda")
            g.manual_seed(cfg.seed + 1)
            for name in ("nerf", "nerf_fine"):
                params[name] = bridge.tree_map(
                    lambda t: t.requires_grad_(True),
                    nerf.init_params(g, input_ch_views=views_ch,
                                     channels=cfg.channels, device="cuda"))
        return step_mod.init_state(cfg, cfg.seed, device="cuda", params=params)

    return cfg, batch, make_state


def _state_tensors(state):
    out = [t.detach().clone() for t in bridge.tree_leaves(state.params)]
    for g in state.optimizer.param_groups:
        for t in g["params"]:
            st = state.optimizer.state[t]
            out += [st[k].clone() for k in ("exp_avg", "exp_avg_sq", "step")]
    return out


@pytest.mark.parametrize("fast,views_ch", [(True, 27), (False, 27), (True, 39)],
                         ids=["topk_K1K2", "randperm_K1K2", "topk_K3K4"])
def test_captured_dispatch_equals_uncaptured_steps(card, fast, views_ch):
    """Two dispatches of 4 (warm-up, capture and 3 replays; then 4 replays)
    against 8 make_train_step calls from an equal state: every metric,
    parameter and Adam tensor bit for bit (the step's scatters add integer
    polarities, exact in any order). Adam's step lives on the card."""
    from benerf_tpu_torch.train import step as step_mod

    cfg, batch, make_state = _small_run(fast, views_ch)
    multi_fn = step_mod.make_multi_step(cfg, 40, 40, 4)
    step_fn = step_mod.make_train_step(cfg, 40, 40)
    a, b = make_state(), make_state()
    captured = step_mod.GRAPHS["captured"]
    for _ in range(2):
        a, stacked = multi_fn(a, batch, cfg.seed)
        rows = []
        for _ in range(4):
            b, m = step_fn(b, batch, cfg.seed)
            rows.append(m)
        for k, v in stacked.items():
            assert torch.equal(v, torch.stack([r[k] for r in rows])), k
    assert a.step == b.step == 8
    assert step_mod.GRAPHS["captured"] == captured + 1
    assert a.optimizer.state[a.params["knots"]]["step"].device.type == "cuda"
    for x, y in zip(_state_tensors(a), _state_tensors(b)):
        assert torch.equal(x, y)


def test_launch_counters_count_replays(card):
    """2 launches of K1 and of K2 per iteration whether the step ran
    eagerly or as a replay of its graph; the capture itself counts none."""
    from benerf_tpu_torch.train import step as step_mod

    cfg, batch, make_state = _small_run()
    multi_fn = step_mod.make_multi_step(cfg, 40, 40, 4)
    state = make_state()
    before, graphs = mlp_ops.counts(), dict(step_mod.GRAPHS)
    for _ in range(3):
        state, _ = multi_fn(state, batch, cfg.seed)
    fused, staged, routes = mlp_ops.counts_since(before)
    assert fused == {"fused_mlp_fwd": 24, "fused_mlp_bwd": 24,
                     "fused_mlp_fwd_bf16": 0, "fused_mlp_bwd_bf16": 0}
    assert set(staged.values()) == {0} and routes == {"plain": 0}
    assert step_mod.GRAPHS == {"captured": graphs["captured"] + 1,
                               "replayed": graphs["replayed"] + 11}


def test_card_checkpoint_resumes_on_the_card_and_the_cpu(card, tmp_path):
    """A checkpoint of a run in dispatches of 4 on the card (Adam's step on
    the card) restores onto the card and resumes bit for bit equal to the
    uninterrupted run; onto the CPU it restores Adam's step on the CPU."""
    from benerf_tpu_torch.train import checkpoint as ckpt
    from benerf_tpu_torch.train import step as step_mod

    cfg, batch, make_state = _small_run()
    multi_fn = step_mod.make_multi_step(cfg, 40, 40, 4)
    state, _ = multi_fn(make_state(), batch, cfg.seed)
    ckpt.save(str(tmp_path), state)
    state, want = multi_fn(state, batch, cfg.seed)

    restored = ckpt.restore(str(tmp_path), make_state(), device="cuda")
    assert restored.step == 4
    restored, got = step_mod.make_multi_step(cfg, 40, 40, 4)(
        restored, batch, cfg.seed)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for x, y in zip(_state_tensors(restored), _state_tensors(state)):
        assert torch.equal(x, y)

    template = step_mod.init_state(cfg, cfg.seed, device="cpu")
    on_cpu = ckpt.restore(str(tmp_path), template, device="cpu")
    st = on_cpu.optimizer.state[on_cpu.params["knots"]]["step"]
    assert st.device.type == "cpu" and float(st) == 4.0
    assert not on_cpu.optimizer.param_groups[0]["capturable"]


@pytest.fixture
def nccl_mesh(card):
    """A one-rank NCCL RayMesh on the card (a process group of world size 1
    on a free localhost port), left again after the test."""
    import socket

    import torch.distributed as dist

    from benerf_tpu_torch.parallel import mesh as mesh_mod

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0,
                            device_id=torch.device("cuda", 0))
    yield mesh_mod.mesh_of_group()
    dist.destroy_process_group()


@pytest.mark.parametrize("views_ch", [27, 39], ids=["K1K2", "L6_plain"])
def test_one_rank_nccl_capture_equals_the_unmeshed_capture(nccl_mesh, views_ch):
    """Two dispatches of 4 under a one-rank NCCL mesh (its all-reduce
    captured in the graph) against the unmeshed dispatches from an equal
    state: every metric, parameter and Adam tensor bit for bit. One
    all-reduce per step, replays included. Under a mesh the L = 6 MLPs take
    the plain route (the JAX package's shard_map region has no staged
    kernel): 2 plain calls a step, no K3/K4, equal to the unmeshed run
    with use_pallas off."""
    import dataclasses

    from benerf_tpu_torch.parallel import mesh as mesh_mod
    from benerf_tpu_torch.train import step as step_mod

    cfg, batch, make_state = _small_run(views_ch=views_ch)
    plain = step_mod.make_multi_step(
        cfg if views_ch == 27 else dataclasses.replace(cfg, use_pallas=False),
        40, 40, 4)
    meshed = step_mod.make_multi_step(cfg, 40, 40, 4, mesh=nccl_mesh)
    a, b = make_state(), make_state()
    before, coll = mlp_ops.counts(), dict(mesh_mod.COLLECTIVES)
    for _ in range(2):
        a, ma = meshed(a, batch, cfg.seed)
        b, mb = plain(b, batch, cfg.seed)
        for k in mb:
            assert torch.equal(ma[k], mb[k]), k
    for x, y in zip(_state_tensors(a), _state_tensors(b)):
        assert torch.equal(x, y)
    assert mesh_mod.COLLECTIVES["all_reduce"] - coll["all_reduce"] == 8
    fused, staged, routes = mlp_ops.counts_since(before)
    if views_ch == 27:
        assert fused["fused_mlp_fwd"] == fused["fused_mlp_bwd"] == 32
        assert routes == {"plain": 0}
    else:
        assert set(staged.values()) == {0}
        assert routes == {"plain": 32}  # 8 steps x 2 calls, in both runs


def _cli_test_argv(logdir, *extra):
    """configs/demo.txt at _small_run's 40x40 cameras and 16 + 16 samples
    (one chunk of cfg.chunk = 4,096 rays a frame)."""
    import pathlib

    argv = ["--config", str(pathlib.Path(__file__).resolve().parents[1]
                            / "configs" / "demo.txt"),
            "--logdir", str(logdir), "--N_samples", "16", "--N_importance", "16"]
    for c in ("rgb", "event"):
        argv += [f"--{c}_height", "40", f"--{c}_width", "40", f"--{c}_fx", "50",
                 f"--{c}_fy", "50", f"--{c}_cx", "20", f"--{c}_cy", "20"]
    return argv + list(extra)


def test_cli_test_renders_a_card_run_through_k1(card, tmp_path):
    """cli/test.py on the checkpoint of a short run on the card (one
    dispatch of 4 steps): KITTI poses, 19 images and the 90 video frames,
    rendered through K1 alone: 2 launches a chunk (one chunk a frame), no
    K2, no other kernel, no plain route."""
    import numpy as np

    from benerf_tpu_torch.cli import test as cli_test
    from benerf_tpu_torch.train import checkpoint as ckpt
    from benerf_tpu_torch.train import step as step_mod

    cfg, batch, make_state = _small_run()
    state, _ = step_mod.make_multi_step(cfg, 40, 40, 4)(make_state(), batch,
                                                        cfg.seed)
    ckpt.save(str(tmp_path / "0"), state)
    before = mlp_ops.counts()
    # optimize_trans as in _small_run: restore's template has its Adam group
    cli_test.main(_cli_test_argv(tmp_path, "--checkpoint", "4",
                                 "--optimize_trans", "True",
                                 "--extract_poses", "True", "--render_images",
                                 "True", "--render_video", "True"))
    fused, staged, routes = mlp_ops.counts_since(before)
    assert fused == {"fused_mlp_fwd": 2 * (19 + 90), "fused_mlp_bwd": 0,
                     "fused_mlp_fwd_bf16": 0, "fused_mlp_bwd_bf16": 0}
    assert set(staged.values()) == {0} and routes == {"plain": 0}
    out = tmp_path / "0" / "test_results"
    poses = np.loadtxt(out / "poses_test" / "poses_test_000004.txt")
    assert poses.shape == (19, 12) and np.all(np.isfinite(poses))
    assert len(list((out / "image_test" / "img_test_000004").glob("test*.png"))) == 19
    frames = list((out / "0_spiral_000004_rgb_frames").glob("*.png"))
    assert (out / "0_spiral_000004_rgb.mp4").is_file() or len(frames) == 90


def test_reference_tar_imports_onto_the_card(card, tmp_path):
    """A .tar that torch.save wrote in the reference's layout (graph,
    global_step, five optimizer state dicts) loads with weights_only=True
    onto the card, equal to its import on the CPU, and renders through K1."""
    from benerf_tpu_torch.cli import test as cli_test
    from benerf_tpu_torch.core.config import config_from_cli
    from benerf_tpu_torch.eval import frames
    from benerf_tpu_torch.render import renderer

    gen = torch.Generator().manual_seed(0)

    def lin(prefix, o, i):
        sd[prefix + ".weight"] = torch.randn(o, i, generator=gen) * (2 / i) ** 0.5
        sd[prefix + ".bias"] = torch.randn(o, generator=gen) * 0.01

    sd = {}
    for net in ("nerf", "nerf_fine"):
        for i in range(8):
            lin(f"{net}.pts_linears.{i}", 256, 63 if i == 0 else 256 + 63 * (i == 5))
        for name, (o, i) in {"feature_linear": (256, 256), "alpha_linear": (1, 256),
                             "rgb_linear": (3, 128),
                             "views_linears.0": (128, 256 + 27)}.items():
            lin(f"{net}.{name}", o, i)
    sd["evt_knot_pose_se3.params.weight"] = torch.randn(4, 6, generator=gen) * 0.02
    sd["transform.params.weight"] = torch.zeros(1, 6)
    for crf in ("rgb_crf.mlp_gray", "event_crf.mlp_luminance"):
        for j, (o, i) in enumerate([(128, 1), (1, 128)]):
            lin(f"{crf}.{2 * j}", o, i)
    ckpt = {"global_step": 200000, "graph": sd}
    for name in ("nerf", "pose", "trans", "rgb_crf", "event_crf"):
        p = torch.nn.Parameter(torch.randn(5, generator=gen))
        opt = torch.optim.Adam([p], lr=5e-4)
        p.grad = torch.ones(5)
        opt.step()
        ckpt[f"optimizer_{name}_state_dict"] = opt.state_dict()
    torch.save(ckpt, tmp_path / "200000.tar")

    cfg = config_from_cli(_cli_test_argv(tmp_path, "--checkpoint", "200000"))
    on_card, step = cli_test.load_params(cfg, str(tmp_path), torch.device("cuda"))
    on_cpu, _ = cli_test.load_params(cfg, str(tmp_path), torch.device("cpu"))
    assert step == 200000
    for a, b in zip(bridge.tree_leaves(on_card), bridge.tree_leaves(on_cpu)):
        assert a.device.type == "cuda" and torch.equal(a.cpu(), b)
    before = mlp_ops.counts()
    poses = cli_test.pose_trajectory(on_card, cfg, 2)
    fr = list(frames.render_trajectory(
        on_card, poses, cli_test.intrinsics(cfg)[2], 40, 40,
        renderer.RenderSettings.from_config(cfg), chunk=cfg.chunk,
        device=torch.device("cuda")))
    fused, _, routes = mlp_ops.counts_since(before)
    assert fused["fused_mlp_fwd"] == 4 and fused["fused_mlp_bwd"] == 0
    assert routes == {"plain": 0}
    assert all(f["rgb"].shape == (40, 40, 3) for f in fr)
    assert all(bool(torch.isfinite(torch.as_tensor(f["rgb"])).all()) for f in fr)


def test_evaluate_runs_lpips_on_the_card(card, tmp_path, monkeypatch):
    """cli/evaluate.py with LPIPS weights on disk: the network runs on the
    card (cuDNN's TF32 off) and gives the CPU's summary within 1e-4
    relative; PSNR / SSIM are host numpy and equal."""
    import numpy as np

    from benerf_tpu_torch.cli import evaluate
    from benerf_tpu_torch.data import png
    from benerf_tpu_torch.eval import lpips_torch

    rng = np.random.default_rng(0)
    for name, noise in (("res", 0.05), ("gt", 0.0)):
        (tmp_path / name).mkdir()
        base = np.random.default_rng(1).random((32, 40, 3))
        for i in range(2):
            img = np.clip(base + noise * rng.normal(size=base.shape), 0, 1)
            png.write(str(tmp_path / name / f"{i:03d}.png"),
                      (255 * img).astype(np.uint8))
    torch.save({}, tmp_path / "empty.pth")
    torch.manual_seed(0)
    sd = lpips_torch._build(str(tmp_path / "empty.pth")).state_dict()
    torch.save({k: v.abs() if k.startswith("lins.") else v  # as trained heads
                for k, v in sd.items()}, tmp_path / "lpips.pth")
    monkeypatch.setenv("BENERF_LPIPS_WEIGHTS", str(tmp_path / "lpips.pth"))
    monkeypatch.setattr(lpips_torch, "_MODEL", None)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    dirs = (str(tmp_path / "res"), str(tmp_path / "gt"))
    on_card = evaluate.evaluate(*dirs)
    assert next(lpips_torch._MODEL.parameters()).device.type == "cuda"
    on_cpu = evaluate.evaluate(*dirs, device="cpu")
    assert on_card.keys() == on_cpu.keys() == {"psnr", "ssim", "lpips"}
    assert on_card["psnr"] == on_cpu["psnr"] and on_card["ssim"] == on_cpu["ssim"]
    assert on_card["lpips"] == pytest.approx(on_cpu["lpips"], rel=1e-4)

"""The kernels' tensor-core modes (csrc/tc_common.cuh) and the fused op's
card path, on the CPU.

- a plain torch emulation of the kernels' layer products: TF32X3 (operands
  split into a cvt.rna TF32 big part and the remainder, which the tensor
  core reads with its low 13 bits dropped; three products, small*small
  dropped) and BF16 (operands rounded to bf16, fp32
  accumulation); through the 8x256 trunk 3xTF32 stays within ~1e-6 x scale
  of float64, where one TF32 product does not;
- the emulated network in both modes against the JAX package (nerf.apply in
  fp32, the Pallas kernel's bf16 mode in interpret mode), from the same
  numpy inputs;
- the packed layout K1-K4 read (natural column order), against the
  offsets formula of csrc/fused_mlp_common.cuh;
- the card path's Python (packing, band weights, the autograd Function) in
  both modes, with the launches replaced by the emulation, since CUDA
  kernels have no CPU mode;
- the route of compute_dtype on the card: "bfloat16" reaches K1/K2 and
  K3/K4 with its mode.
The staged network's emulation (K3/K4) is held to the JAX package in
tests/test_torch_staged_mlp.py.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benerf_tpu.models import nerf as jnerf
from benerf_tpu.ops import pallas_mlp_t
from benerf_tpu_torch.models import bridge
from benerf_tpu_torch.models import embedder as temb
from benerf_tpu_torch.models import nerf as tnerf
from benerf_tpu_torch.ops import fused_mlp, mlp_kernels, staged_mlp
from benerf_tpu_torch.ops import mlp as tmlp

MODES = {"float32": "tf32x3", "bfloat16": "bf16"}


# ---- the emulation ------------------------------------------------------------


def tf32_rna(x):
    """float32 -> the nearest TF32 value, ties away from zero: cvt.rna.tf32.f32
    (the low 13 mantissa bits rounded off). Differentiable as the identity
    (x + (r - x) is exactly r), so autograd runs through the emulation."""
    b = x.detach().contiguous().view(torch.int32)
    return x + (((b + 0x1000) & -0x2000).view(torch.float32) - x).detach()


def tf32_trunc(x):
    """What a TF32 mma reads of an fp32 operand: its low 13 mantissa bits
    dropped. Differentiable as the identity, as tf32_rna."""
    b = x.detach().contiguous().view(torch.int32)
    return x + ((b & -0x2000).view(torch.float32) - x).detach()


def bf16_rn(x):
    """float32 -> nearest bf16 value, ties to even: cvt.rn.bf16x2.f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def mm(a, w, mode):
    """a (n, I) @ w (I, O) as the kernels' tensor-core products compute it, fp32
    accumulation; mode "tf32" is one TF32 product (not a kernel mode)."""
    if mode == "tf32x3":
        ab, wb = tf32_rna(a), tf32_rna(w)
        asm, wsm = tf32_trunc(a - ab), tf32_trunc(w - wb)
        return asm @ wb + ab @ wsm + ab @ wb
    if mode == "tf32":
        return tf32_rna(a) @ tf32_rna(w)
    if mode == "bf16":
        return bf16_rn(a) @ bf16_rn(w)
    return a @ w


def emulated_forward(w, pts, vd_pt, band, mode, vb_pt=None):
    """K1 on unpacked weights `w` (mlp_kernels.unpack): points (n, 3), per-point
    viewdirs (n, 3), band (14,); products in `mode`, heads in fp32 as the
    kernels' CUDA-core heads. K3 with `vb_pt`, its per-ray view bias
    repeated per point (n, 128): the views layer adds it in place of the
    view-encoding product and its bias (vd_pt unused; band all ones)."""
    pe = temb.positional_encoding(pts, 10, include_input=False)
    pe = torch.cat([pts, temb.apply_barf_weights(pe, band[:10], include_input=False)], -1)
    if vb_pt is None:
        vpe = temb.positional_encoding(vd_pt, 4, include_input=False)
        vpe = torch.cat([vd_pt, temb.apply_barf_weights(vpe, band[10:],
                                                        include_input=False)], -1)
        vb_pt = mm(vpe, w["wvpe"], mode) + w["bv"]
    h = torch.relu(mm(pe, w["w0"], mode) + w["b"][0])
    for l in range(1, 8):
        t = mm(h, w["wh"][l - 1], mode) + w["b"][l]
        if l == 5:
            t = t + mm(pe, w["w5pe"], mode)
        h = torch.relu(t)
    f = mm(h, w["wf"], mode) + w["bf"]
    hv = torch.relu(mm(f, w["wfv"], mode) + vb_pt)
    return torch.cat([hv @ w["wrgb"] + w["brgb"], h @ w["wa"] + w["ba"]], -1)


def _inputs(R, S, C, seed, barf=False):
    rng = np.random.default_rng(seed)
    params = jax.tree.map(np.asarray, jnerf.init_params(
        jax.random.PRNGKey(seed), channels=C))
    params = jax.tree.map(
        lambda a: (a + rng.uniform(-0.05, 0.05, a.shape)).astype(np.float32)
        if a.ndim == 1 else a, params)
    pts = rng.uniform(-1.0, 1.0, (R, S, 3)).astype(np.float32)
    vd = rng.normal(size=(R, 3))
    vd = (vd / np.linalg.norm(vd, axis=-1, keepdims=True)).astype(np.float32)
    band = (np.concatenate([np.linspace(1.0, 0.0, 10), np.linspace(1.0, 0.25, 4)])
            if barf else np.ones(14)).astype(np.float32)
    return params, pts, vd, band


def _rel(a, b):
    return float((a.double() - b.double()).abs().max()
                 / max(float(b.abs().max()), 1.0))


# ---- the products -----------------------------------------------------------


def test_tf32_split_is_cvt_rna():
    one = 1.0
    x = torch.tensor([one + 2 ** -11, -(one + 2 ** -11), one + 2 ** -12,
                      one + 3 * 2 ** -12, -7.25], dtype=torch.float32)
    want = torch.tensor([one + 2 ** -10, -(one + 2 ** -10), one, one + 2 ** -10,
                         -7.25], dtype=torch.float32)
    got = tf32_rna(x)
    assert torch.equal(got, want)  # ties away from zero, either sign
    assert (tf32_rna(got).view(torch.int32) & 0x1FFF).eq(0).all()
    r = torch.randn(4096, generator=torch.Generator().manual_seed(0))
    big = tf32_rna(r)
    small = tf32_trunc(r - big)
    # big + small (as the tensor core reads it) holds x to 2^-21 relative;
    # big alone to 2^-11
    assert ((big + small - r).abs() <= 2 ** -21 * r.abs()).all()
    assert ((big - r).abs() <= 2 ** -11 * r.abs()).all()
    assert not ((big - r).abs() <= 2 ** -14 * r.abs()).all()


def _trunk(x, ws, mode, dtype=torch.float32):
    h = x.to(dtype)
    for w in ws:
        h = torch.relu(mm(h, w.to(dtype), mode))
    return h


def test_tf32x3_holds_float64_through_the_trunk_where_one_tf32_pass_does_not():
    """Eight 256-wide ReLU layers (Xavier weights, 64 points): the kernels'
    TF32X3 product stays within 1e-6 x scale of float64 at every layer, as
    plain fp32 does; one TF32 product is ~1e-3 off, past the fp32 gate of
    chip_smoke.py (FWD_TOL 2e-4)."""
    rng = np.random.default_rng(0)
    a = np.sqrt(6.0 / 512)
    ws = [torch.tensor(rng.uniform(-a, a, (256, 256)), dtype=torch.float32)
          for _ in range(8)]
    x = torch.tensor(rng.normal(size=(64, 256)), dtype=torch.float32)
    ref = _trunk(x.double(), ws, "fp64", torch.float64)
    err = {m: _rel(_trunk(x, ws, m), ref) for m in ("fp32", "tf32x3", "tf32", "bf16")}
    assert err["fp32"] < 1e-6
    assert err["tf32x3"] < 1e-6
    assert err["tf32"] > 2e-4 and err["tf32"] > 100 * err["tf32x3"]
    assert 1e-3 < err["bf16"] < 2e-2


@pytest.mark.parametrize("compute_dtype", list(MODES))
def test_emulated_network_matches_jax(compute_dtype):
    """The network as the kernels compute it, against the JAX package on the
    same inputs: TF32X3 against fp32 nerf.apply at test_pallas_t's forward
    bound (2e-4) and against float64 at 1e-5; BF16 against the Pallas
    kernel's bf16 mode (interpret mode) at test_bfloat16_mode's 2e-2 x
    scale."""
    params, pts, vd, band = _inputs(4, 64, 3, seed=1)
    w = mlp_kernels.unpack(mlp_kernels.pack_params(bridge.params_from_numpy(params, device="cpu")), 3)
    x = torch.as_tensor(pts).reshape(-1, 3)
    v = torch.as_tensor(vd).repeat_interleave(64, dim=0)
    got = emulated_forward(w, x, v, torch.as_tensor(band), MODES[compute_dtype])
    jp = jax.tree.map(jnp.asarray, params)
    if compute_dtype == "float32":
        want = np.asarray(jnerf.apply(jp, jnp.asarray(pts), jnp.asarray(vd)))
        np.testing.assert_allclose(got.numpy().reshape(want.shape), want,
                                   rtol=0, atol=2e-4)
        f64 = tnerf.apply(bridge.tree_map(lambda t: t.double(),
                                          bridge.params_from_numpy(params, device="cpu")),
                          torch.as_tensor(pts).double(), torch.as_tensor(vd).double())
        assert _rel(got.reshape(f64.shape), f64) < 1e-5
    else:
        pallas_mlp_t.INTERPRET = True
        try:
            want = np.asarray(pallas_mlp_t.fused_nerf_mlp(
                jp, jnp.asarray(pts), jnp.asarray(vd), compute_dtype="bfloat16"))
        finally:
            pallas_mlp_t.INTERPRET = False
        scale = np.abs(want).max()
        np.testing.assert_allclose(got.numpy().reshape(want.shape), want,
                                   rtol=0, atol=2e-2 * scale)
        # and the port's own plain bf16 version, which K1/K2 are held to on
        # the card
        plain = tnerf.apply(bridge.params_from_numpy(params, device="cpu"), torch.as_tensor(pts),
                            torch.as_tensor(vd), compute_dtype=torch.bfloat16)
        assert _rel(got.reshape(plain.shape), plain) < 2e-2


# ---- the packed layout -------------------------------------------------------


def _c_offsets(C):
    """fmlp::offsets(C) of csrc/fused_mlp_common.cuh, transcribed."""
    o = {"w0": 0}
    o["wh"] = o["w0"] + 63 * 256
    o["w5pe"] = o["wh"] + 7 * 256 * 256
    o["wf"] = o["w5pe"] + 63 * 256
    o["wfv"] = o["wf"] + 256 * 256
    o["wvpe"] = o["wfv"] + 256 * 128
    o["b"] = o["wvpe"] + 27 * 128
    o["bf"] = o["b"] + 8 * 256
    o["bv"] = o["bf"] + 256
    o["wa"] = o["bv"] + 128
    o["ba"] = o["wa"] + 256
    o["wrgb"] = o["ba"] + 1
    o["brgb"] = o["wrgb"] + 128 * C
    o["total"] = o["brgb"] + C
    return list(o.values())


# the matrices the tensor-core products stage with cp.async
_STAGED = ("w0", "wh", "w5pe", "wf", "wfv", "wvpe")


@pytest.mark.parametrize("C", [1, 3, 7])
def test_natural_layout_round_trip(C):
    """The packed vector of K1/K2: columns in natural order, offsets as the
    kernels compute them, every matrix the products stage 16-byte aligned
    with rows of a multiple of 4 floats (cp.async copies 16 bytes), and
    unpack inverts pack."""
    params, _, _, _ = _inputs(1, 1, C, seed=C)
    tp = bridge.params_from_numpy(params, device="cpu")
    packed = mlp_kernels.pack_params(tp)
    offs = mlp_kernels.offsets(mlp_kernels.layout(C))
    assert offs == _c_offsets(C) and packed.numel() == offs[-1]
    names = [n for n, _ in mlp_kernels.layout(C)]
    for name, shape in mlp_kernels.layout(C):
        if name in _STAGED:
            assert offs[names.index(name)] % 4 == 0 and shape[-1] % 4 == 0
    raw = packed[:63 * 256].view(63, 256)
    assert torch.equal(raw, tp["pts"][0]["w"])
    v = mlp_kernels.unpack(packed, C)
    assert torch.equal(v["wh"][4], tp["pts"][5]["w_h"])
    assert torch.equal(v["w5pe"], tp["pts"][5]["w_pe"])
    assert torch.equal(v["wfv"], tp["views"]["w_feat"])
    assert torch.equal(v["wvpe"], tp["views"]["w_pe"])
    assert torch.equal(v["bv"], tp["views"]["b"])
    assert torch.equal(v["wrgb"], tp["rgb"]["w"])
    again = mlp_kernels.pack_params(bridge.tree_unflatten(tp, [
        t for t in bridge.tree_leaves(tp)]))
    assert torch.equal(again, packed)
    # K3/K4's packing is the same vector without the view-encoding entries
    staged = mlp_kernels.unpack(mlp_kernels.pack_params(tp, view_pe=False), C,
                              view_pe=False)
    assert all(torch.equal(staged[k], v[k]) for k in v if k not in ("wvpe", "bv"))
    assert staged["wvpe"].numel() == staged["bv"].numel() == 0


# ---- the card path's Python -----------------------------------------------------


def _launch_fwd(seen, preps, kepts=None):
    def launch(pair, packed, pts, vd, band, S, C, compute_dtype="float32", *,
               prep, kept=None):
        assert pair is mlp_kernels.FUSED
        seen.append(("fwd", compute_dtype))
        preps.append(prep)
        if kepts is not None:
            kepts.append(kept)
        w = mlp_kernels.unpack(packed, C)
        return emulated_forward(w, pts, vd.repeat_interleave(S, dim=0), band,
                                MODES[compute_dtype])
    return launch


def _launch_bwd(seen, preps, kepts=None):
    """What K2's launch returns: (d packed, d pts, d viewdirs per ray)."""
    def launch(pair, packed, pts, vd, band, g, S, C, compute_dtype="float32",
               *, prep, kept=None):
        assert pair is mlp_kernels.FUSED
        seen.append(("bwd", compute_dtype))
        preps.append(prep)
        if kepts is not None:
            kepts.append(kept)
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(True) for t in (packed, pts, vd)]
            w = mlp_kernels.unpack(ins[0], C)
            out = emulated_forward(w, ins[1], ins[2].repeat_interleave(S, dim=0),
                                   band, MODES[compute_dtype])
            return torch.autograd.grad(out, ins, g)
    return launch


@pytest.mark.parametrize("compute_dtype", list(MODES))
@pytest.mark.parametrize("C,S,barf", [(3, 37, False), (1, 64, True)])
def test_fused_card_path_wiring(compute_dtype, C, S, barf, monkeypatch):
    """Packing in natural column order, the band weights and the autograd
    Function route every gradient (each parameter, the points, the per-ray
    viewdirs) where autograd through the same arithmetic on the parameters
    sends it, and pass the mode to both launches; K2 gets the buffer of
    wgmma weight copies that K1's launch filled, and the forward it kept."""
    seen, preps, kepts = [], [], []
    monkeypatch.setattr(mlp_kernels, "launch_fwd", _launch_fwd(seen, preps, kepts))
    monkeypatch.setattr(mlp_kernels, "launch_bwd", _launch_bwd(seen, preps, kepts))
    params, pts, vd, band = _inputs(3, S, C, seed=C + S, barf=barf)
    bw, bwv = ((torch.as_tensor(band[:10]), torch.as_tensor(band[10:]))
               if barf else (None, None))

    def grads(fn):
        tp = bridge.params_from_numpy(params, device="cpu")
        leaves = [t.requires_grad_(True) for t in bridge.tree_leaves(tp)]
        x = torch.tensor(pts, requires_grad=True)
        v = torch.tensor(vd, requires_grad=True)
        out = fn(tp, x, v)
        assert out.shape == (3, S, C + 1)
        return torch.autograd.grad(torch.sin(out).sum(), leaves + [x, v])

    def card_path(tp, x, v):
        return fused_mlp._fused(tp, x, v, bw, bwv, compute_dtype)

    def direct(tp, x, v):
        w = {"w0": tp["pts"][0]["w"],
             "wh": torch.stack([tp["pts"][l]["w_h" if l == 5 else "w"]
                                for l in range(1, 8)]),
             "w5pe": tp["pts"][5]["w_pe"], "wf": tp["feature"]["w"],
             "wfv": tp["views"]["w_feat"], "wvpe": tp["views"]["w_pe"],
             "b": torch.stack([tp["pts"][l]["b"] for l in range(8)]),
             "bf": tp["feature"]["b"], "bv": tp["views"]["b"],
             "wa": tp["alpha"]["w"], "ba": tp["alpha"]["b"],
             "wrgb": tp["rgb"]["w"], "brgb": tp["rgb"]["b"]}
        out = emulated_forward(w, x.reshape(-1, 3), v.repeat_interleave(S, dim=0),
                               torch.as_tensor(band), MODES[compute_dtype])
        return out.reshape(3, S, C + 1)

    got, want = grads(card_path), grads(direct)
    assert seen == [("fwd", compute_dtype), ("bwd", compute_dtype)]
    assert preps[0] is preps[1]
    assert preps[0].shape == (mlp_kernels.prep_table(True, compute_dtype)[1],
                              mlp_kernels.PREP_KS[compute_dtype])
    assert kepts[0] is not None
    assert all(a is b for a, b in zip(kepts[0], kepts[1]) if isinstance(a, torch.Tensor))
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert _rel(a, b) < 1e-5


@pytest.mark.parametrize("compute_dtype", list(MODES))
@pytest.mark.parametrize("case", ["recorded", "no_grad", "no_input_needs_grad",
                                  "staged"])
def test_k1_keeps_its_forward_only_where_autograd_records_the_call(
        case, compute_dtype, monkeypatch):
    """KernelMLP through `kernel_mlp`, its launches replaced: K1 is handed a
    kept forward (`kept_scratch` of the call's points in the mode's format)
    only where autograd records the call, grad on and an input that needs a
    gradient; K3 never. K2's launch gets the very tensors K1 filled."""
    calls = []

    def fwd(pair, packed, pts, ray, band, S, C, compute_dtype="float32", *,
            prep, kept=None):
        calls.append(("fwd", kept))
        return torch.zeros((pts.shape[0], C + 1))

    def bwd(pair, packed, pts, ray, band, g, S, C, compute_dtype="float32", *,
            prep, kept=None):
        calls.append(("bwd", kept))
        return torch.zeros_like(packed), torch.zeros_like(pts), torch.zeros_like(ray)

    monkeypatch.setattr(mlp_kernels, "launch_fwd", fwd)
    monkeypatch.setattr(mlp_kernels, "launch_bwd", bwd)
    pair = mlp_kernels.STAGED if case == "staged" else mlp_kernels.FUSED
    n, S, C = 111, 37, 3
    packed = torch.zeros(mlp_kernels.packed_size(C, pair.view_pe),
                         requires_grad=case != "no_input_needs_grad")
    pts, ray = torch.zeros(n, 3), torch.zeros(n // S, pair.ray_width)
    band = torch.ones(14) if pair.view_pe else None
    with torch.set_grad_enabled(case != "no_grad"):
        out = mlp_kernels.kernel_mlp(pair, packed, pts, ray, band, S, C,
                                     compute_dtype)
    kept = calls[0][1]
    if case != "recorded":
        assert kept is None
        if out.requires_grad:
            out.sum().backward()
            assert calls[1] == ("bwd", None)
        return
    n_pad = 2 * mlp_kernels.TILE
    sizes = mlp_kernels.scratch_sizes(n_pad, C, True, compute_dtype)
    assert (kept.n_pad, kept.compute_dtype, kept.d) == (n_pad, compute_dtype, None)
    assert kept.x.numel() == sizes.x
    assert kept.signs.shape == (2, mlp_kernels.SIGN_WORDS)
    assert kept.side is None if compute_dtype == "float32" else kept.side.numel() == sizes.side
    out.sum().backward()
    got = calls[1][1]
    assert calls[1][0] == "bwd" and got.x is kept.x and got.signs is kept.signs
    assert got.side is kept.side and got.n_pad == n_pad


def test_compute_dtype_routes_on_the_card(monkeypatch):
    """On a CUDA tensor, either compute_dtype goes to K1/K2 and to K3/K4
    with its mode; an unknown one raises."""
    calls = []
    monkeypatch.setattr(fused_mlp, "fused_nerf_mlp",
                        lambda *a, **k: calls.append(("fused", k["compute_dtype"])))
    monkeypatch.setattr(staged_mlp, "staged_nerf_mlp",
                        lambda *a, **k: calls.append(("staged", k["compute_dtype"])))
    card = types.SimpleNamespace(device=torch.device("cuda"))
    std = bridge.params_from_numpy(_inputs(1, 1, 3, seed=0)[0], device="cpu")
    l6 = bridge.params_from_numpy(jax.tree.map(np.asarray, jnerf.init_params(
        jax.random.PRNGKey(0), input_ch_views=39)), device="cpu")
    vd = torch.zeros(1, 3)
    for cd in MODES:
        tmlp.mlp_forward(std, card, vd, compute_dtype=cd)
        tmlp.mlp_forward(l6, card, vd, num_freqs_views=6, compute_dtype=cd)
    assert calls == [("fused", "float32"), ("staged", "float32"),
                     ("fused", "bfloat16"), ("staged", "bfloat16")]
    with pytest.raises(ValueError, match="compute_dtype"):
        mlp_kernels.launch_fwd(mlp_kernels.FUSED, None, None, None, None, 1, 3,
                               compute_dtype="float16", prep=None)
    with pytest.raises(ValueError, match="compute_dtype"):
        mlp_kernels.launch_fwd(mlp_kernels.STAGED, None, None, None, None, 1, 3,
                               compute_dtype="float16", prep=None)

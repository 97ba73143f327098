"""The weights' wgmma copies that K1-K4 read (csrc/wgmma_layer.cuh
`prep_kernel`), through their plain version `fused_mlp.prepare_weights_plain`,
on the CPU:

- the layout (`fused_mlp.prep_table`): every matrix of the packed vector
  once per orientation, stages of KS rows, no gaps;
- TF32X3: each stage's big part carries the bits of cvt.rna.tf32.f32
  (checked against an independent nearest-tie-away rounding), big + small
  is W exactly, and big + small as the tensor core reads it (low 13 bits
  dropped) holds W to 2^-21 relative;
- BF16: the values rounded to nearest even;
- both copies (W^T for the forward, W for the data gradients) round-trip
  to `pack_params`, zero past each matrix's rows;
- the network through those copies, with every product summed as the
  kernels do (a fresh fp32 accumulator per 16 contraction rows in TF32X3,
  one ring stage, and per 64 in BF16, two, added to a running fp32 sum),
  against the JAX package: fp32 nerf.apply at the forward bound (2e-4), the Pallas kernel's
  bf16 mode (interpret mode) at 2e-2 x scale;
- `prepare_weights`, prep_kernel's wrapper, refuses CPU tensors, and every
  launch that reads the copies takes them from its caller.
CUDA kernels have no CPU mode: the card compares prep_kernel with this plain
version bit for bit (chip_smoke.py, tests/test_torch_cuda.py).
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benerf_tpu.models import nerf as jnerf
from benerf_tpu.ops import pallas_mlp_t
from benerf_tpu_torch.models import bridge
from benerf_tpu_torch.models import embedder as temb
from benerf_tpu_torch.ops import fused_mlp, staged_mlp

torch.set_num_threads(1)

MODES = ("float32", "bfloat16")
VIEW_PE = (True, False)


def _packed(C, view_pe, seed=0):
    rng = np.random.default_rng(seed)
    n = fused_mlp._offsets(fused_mlp._layout(C, view_pe))[-1]
    return torch.tensor(rng.normal(size=n) * 0.1, dtype=torch.float32)


def _unstage(buf, entry, compute_dtype):
    """B (N, K) of one table entry from the buffer: (big, small) in
    "float32", (bf16 values,) in "bfloat16"."""
    _, _, row0, N, K, _, _, _ = entry
    ks, parts = fused_mlp.PREP_KS[compute_dtype], fused_mlp.PREP_PARTS[compute_dtype]
    rows = buf[row0:row0 + K // ks * parts * N].reshape(K // ks, parts, N, ks)
    return tuple(rows[:, q].permute(1, 0, 2).reshape(N, K) for q in range(parts))


def _matrices(packed, C, view_pe):
    """name -> W (I, O) from the packed vector, as the table names them."""
    w = fused_mlp.unpack(packed, C, view_pe)
    out = {"w0": w["w0"], "w5pe": w["w5pe"], "wf": w["wf"], "wfv": w["wfv"]}
    out.update({f"wh{l}": w["wh"][l - 1] for l in range(1, 8)})
    if view_pe:
        out["wvpe"] = w["wvpe"]
    return out


def _rna_reference(x):
    """float32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero, from the two TF32 neighbours in float64."""
    x64 = x.double()
    b = x.view(torch.int32)
    lo = (b & -0x2000).view(torch.float32).double()           # toward zero
    hi = ((b & -0x2000) + 0x2000).view(torch.float32).double()  # away
    d_lo, d_hi = (x64 - lo).abs(), (hi - x64).abs()
    return torch.where(d_hi <= d_lo, hi, lo).float()


def _trunc(x):
    """What a TF32 product reads of an fp32 operand."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


@pytest.mark.parametrize("view_pe", VIEW_PE)
@pytest.mark.parametrize("compute_dtype", MODES)
def test_table_covers_every_matrix_once_per_orientation(view_pe, compute_dtype):
    table, rows = fused_mlp.prep_table(view_pe, compute_dtype)
    names = [e[0] for e in table]
    mats = ["w0"] + [f"wh{l}" for l in range(1, 8)] + ["w5pe", "wf", "wfv"]
    mats += ["wvpe"] if view_pe else []
    assert names == mats + mats
    assert [e[1] for e in table] == ["fwd"] * len(mats) + ["bwd"] * len(mats)
    ks, parts = fused_mlp.PREP_KS[compute_dtype], fused_mlp.PREP_PARTS[compute_dtype]
    row = 0
    for name, orient, row0, N, K, src, I, O in table:
        assert row0 == row
        assert (N, K) == ((O, -(-I // 32) * 32) if orient == "fwd"
                          else (-(-I // 32) * 32, O))
        assert K % ks == 0 and N % 32 == 0
        row += K // ks * parts * N
    assert rows == row
    buf = fused_mlp.prepare_weights_plain(_packed(3, view_pe), view_pe, compute_dtype)
    assert buf.shape == (rows, ks) and buf.element_size() * ks == 64
    assert buf.dtype == fused_mlp.PREP_DTYPE[compute_dtype]


@pytest.mark.parametrize("view_pe", VIEW_PE)
def test_big_carries_the_cvt_rna_bits(view_pe):
    packed = _packed(3, view_pe, seed=1)
    # ties in both signs and values either side of a TF32 step
    packed[:6] = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -12,
                               1 + 3 * 2 ** -12, -7.25, 0.0])
    buf = fused_mlp.prepare_weights_plain(packed, view_pe, "float32")
    table, _ = fused_mlp.prep_table(view_pe, "float32")
    mats = _matrices(packed, 3, view_pe)
    for entry in table:
        big, _ = _unstage(buf, entry, "float32")
        W = mats[entry[0]]
        want = W.t() if entry[1] == "fwd" else W
        got = big[:want.shape[0], :want.shape[1]]
        assert torch.equal(got, _rna_reference(want.contiguous())), entry[:2]
        assert (big.view(torch.int32) & 0x1FFF).eq(0).all()
    w0 = mats["w0"].reshape(-1)[:6]
    assert torch.equal(_rna_reference(w0), torch.tensor(
        [1 + 2 ** -10, -(1 + 2 ** -10), 1.0, 1 + 2 ** -10, -7.25, 0.0]))


@pytest.mark.parametrize("view_pe", VIEW_PE)
def test_big_plus_small_gives_w_back(view_pe):
    packed = _packed(3, view_pe, seed=2)
    buf = fused_mlp.prepare_weights_plain(packed, view_pe, "float32")
    table, _ = fused_mlp.prep_table(view_pe, "float32")
    mats = _matrices(packed, 3, view_pe)
    for entry in table:
        big, small = _unstage(buf, entry, "float32")
        W = mats[entry[0]]
        want = (W.t() if entry[1] == "fwd" else W).double()
        I, J = want.shape
        assert torch.equal((big + small)[:I, :J].double(), want)  # exact
        read = (big.double() + _trunc(small).double())[:I, :J]
        assert ((read - want).abs() <= 2 ** -21 * want.abs()).all()
        assert not ((big.double()[:I, :J] - want).abs()
                    <= 2 ** -14 * want.abs()).all()  # small is needed


@pytest.mark.parametrize("view_pe", VIEW_PE)
@pytest.mark.parametrize("compute_dtype", MODES)
def test_copies_round_trip_to_pack_params(view_pe, compute_dtype):
    """Each fwd entry holds W^T and each bwd entry W, zero past I, so both
    orientations give back the packed vector's matrices."""
    packed = _packed(3, view_pe, seed=3)
    buf = fused_mlp.prepare_weights_plain(packed, view_pe, compute_dtype)
    table, _ = fused_mlp.prep_table(view_pe, compute_dtype)
    mats = _matrices(packed, 3, view_pe)
    seen = set()
    for entry in table:
        name, orient, _, N, K, src, I, O = entry
        B = sum(p.float() for p in _unstage(buf, entry, compute_dtype))
        W = B[:, :I].t() if orient == "fwd" else B[:I]
        want = packed[src:src + I * O].reshape(I, O)
        assert torch.equal(want, mats[name])
        if compute_dtype == "bfloat16":
            want = want.to(torch.bfloat16).float()
        assert torch.equal(W, want), (name, orient)
        pad = B[:, I:] if orient == "fwd" else B[I:]
        assert pad.eq(0).all()
        seen.add((name, orient))
    assert len(seen) == len(table)


@pytest.mark.parametrize("compute_dtype", MODES)
def test_prepare_weights_needs_the_card(compute_dtype):
    """prep_kernel's wrapper refuses CPU tensors (its plain version is
    prepare_weights_plain), and every launch that reads the copies takes
    them from its caller: K2/K4 and their tile passes read K1/K3's and
    never make them again."""
    packed = _packed(7, True, seed=4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fused_mlp.prepare_weights(packed, 7, True, compute_dtype)
    for fn in (fused_mlp.launch_fwd, fused_mlp.launch_bwd, fused_mlp.run_tile,
               staged_mlp.launch_fwd, staged_mlp.launch_bwd, staged_mlp.run_tile):
        prep = inspect.signature(fn).parameters["prep"]
        assert prep.default is inspect.Parameter.empty, fn.__qualname__


# ---- the network through the copies, stage by stage ---------------------------


# contraction rows a fresh accumulator sums (wl::Cfg KS x GROUP)
PROMOTE = {"float32": 16, "bfloat16": 64}


def _product(a, entry, buf, compute_dtype):
    """a (n, K) @ B^T over one table entry as the kernels sum it: per
    PROMOTE columns a fresh fp32 product (TF32X3: trunc(a_small) big + a_big
    trunc(small) + a_big big, a split as cvt.rna; BF16: bf16 operands),
    added in fp32 to the running sum."""
    ks = PROMOTE[compute_dtype]
    parts = _unstage(buf, entry, compute_dtype)
    K = entry[4]
    a = torch.nn.functional.pad(a, (0, K - a.shape[1]))
    acc = torch.zeros(a.shape[0], entry[3])
    for s in range(0, K, ks):
        x = a[:, s:s + ks]
        if compute_dtype == "float32":
            big, small = (p[:, s:s + ks] for p in parts)
            xb = fused_mlp.tf32_big(x)
            part = _trunc(x - xb) @ big.t() + xb @ _trunc(small).t() + xb @ big.t()
        else:
            part = (x.to(torch.bfloat16).float()
                    @ parts[0][:, s:s + ks].float().t())
        acc = acc + part
    return acc


def _staged_forward(packed, buf, pts, vd_pt, band, C, compute_dtype):
    table, _ = fused_mlp.prep_table(True, compute_dtype)
    fwd = {e[0]: e for e in table if e[1] == "fwd"}
    w = fused_mlp.unpack(packed, C)
    mm = lambda a, name: _product(a, fwd[name], buf, compute_dtype)  # noqa: E731
    pe = temb.positional_encoding(pts, 10, include_input=False)
    pe = torch.cat([pts, temb.apply_barf_weights(pe, band[:10], include_input=False)], -1)
    vpe = temb.positional_encoding(vd_pt, 4, include_input=False)
    vpe = torch.cat([vd_pt, temb.apply_barf_weights(vpe, band[10:], include_input=False)], -1)
    h = torch.relu(mm(pe, "w0") + w["b"][0])
    for l in range(1, 8):
        t = mm(h, f"wh{l}") + w["b"][l]
        if l == 5:
            t = t + mm(pe, "w5pe")
        h = torch.relu(t)
    f = mm(h, "wf") + w["bf"]
    hv = torch.relu(mm(f, "wfv") + mm(vpe, "wvpe") + w["bv"])
    return torch.cat([hv @ w["wrgb"] + w["brgb"], h @ w["wa"] + w["ba"]], -1)


@pytest.mark.parametrize("compute_dtype", MODES)
def test_network_through_the_staged_copies_matches_jax(compute_dtype):
    """K1 as the kernels compute it from the prepared copies, stage by
    stage, against the JAX package on the same numpy inputs: TF32X3 against
    fp32 nerf.apply at the forward bound (2e-4), BF16 against the Pallas
    kernel's bf16 mode (interpret mode) at 2e-2 x scale."""
    rng = np.random.default_rng(5)
    params = jax.tree.map(np.asarray, jnerf.init_params(jax.random.PRNGKey(5),
                                                        channels=3))
    params = jax.tree.map(
        lambda a: (a + rng.uniform(-0.05, 0.05, a.shape)).astype(np.float32)
        if a.ndim == 1 else a, params)
    pts = rng.uniform(-1.0, 1.0, (2, 32, 3)).astype(np.float32)
    vd = rng.normal(size=(2, 3))
    vd = (vd / np.linalg.norm(vd, axis=-1, keepdims=True)).astype(np.float32)
    packed = fused_mlp.pack_params(bridge.params_from_numpy(params, device="cpu"))
    buf = fused_mlp.prepare_weights_plain(packed, True, compute_dtype)
    got = _staged_forward(packed, buf, torch.as_tensor(pts).reshape(-1, 3),
                          torch.as_tensor(vd).repeat_interleave(32, dim=0),
                          torch.ones(14), 3, compute_dtype)
    jp = jax.tree.map(jnp.asarray, params)
    if compute_dtype == "float32":
        want = np.asarray(jnerf.apply(jp, jnp.asarray(pts), jnp.asarray(vd)))
        np.testing.assert_allclose(got.numpy().reshape(want.shape), want,
                                   rtol=0, atol=2e-4)
    else:
        pallas_mlp_t.INTERPRET = True
        try:
            want = np.asarray(pallas_mlp_t.fused_nerf_mlp(
                jp, jnp.asarray(pts), jnp.asarray(vd), compute_dtype="bfloat16"))
        finally:
            pallas_mlp_t.INTERPRET = False
        scale = max(float(np.abs(want).max()), 1.0)
        np.testing.assert_allclose(got.numpy().reshape(want.shape), want,
                                   rtol=0, atol=2e-2 * scale)

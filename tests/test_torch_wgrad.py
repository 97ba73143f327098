"""The weight-gradient pass of K2/K4 (csrc/wgrad_wgmma.cuh and
csrc/fused_mlp_bwd_common.cuh), on the CPU.

- a plain torch emulation of the pass's arithmetic: the point axis cut into
  `splits` chunks whose ends are multiples of the stage (32 points, BF16's
  128, as fmlp::weight_gradients cuts it); each stage's product in the
  kernel's mode into a fresh fp32 sum, added to the chunk's running fp32
  sum (the promotion every stage); the chunk partials summed in chunk order
  (reduce_kernel). TF32X3: big = cvt.rna(x), written back to the stage;
  small = x - big, which the tensor core reads with its low 13 bits
  dropped; small*big + big*small + big*big. BF16: operands rounded to bf16
  (rn). The sums of D's rows (the biases) and the thin jobs (the 1- and
  C-column heads and their biases) stay fp32: in TF32X3 each stage's sum
  of D's fp32 rows, in BF16 the tile pass's sums of each 64-point tile,
  added per chunk in tile order;
- on a contraction 12,288 points deep, TF32X3 holds float64 to WGRAD_GATE x
  scale at every split count, where one TF32 product misses it by two
  orders of magnitude; BF16 holds the float64 product of its bf16-rounded
  operands to the same gate;
- applied to the scratch of a small NeRF (the activations X and the
  pre-activation gradients D of sum(sin(out)), rows as fmlp::Scratch, by
  the job table `mlp_kernels.wgrad_jobs`), the emulation and the pass's plain
  version (`run_wgrad` on CPU tensors) give the JAX package's weight
  gradients (jax.grad of benerf_tpu nerf.apply), for K2's table and K4's;
- the job table covers the packed gradient vector once;
- BF16's scratch format (csrc/fused_mlp_bwd_common.cuh: the products' rows
  as bf16, fp32 side rows, tile sums of D), built from an fp32 scratch by
  `mlp_kernels.bf16_scratch_plain`, gives the pass's plain version the same
  float64 products bit for bit as the fp32 scratch with bf16 operands, the
  same heads, and the biases to the rounding of a reordered fp32 sum; its
  sizes are the library's mirror `scratch_sizes`.
The card tests (tests/test_torch_cuda.py) hold the kernel itself to the
float64 product.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_staged_mlp as sm
import test_torch_tc_mlp as tc

from benerf_tpu.models import nerf as jnerf
from benerf_tpu_torch.models import bridge
from benerf_tpu_torch.models import embedder as temb
from benerf_tpu_torch.ops import mlp_kernels

KS = 32                # points a stage (wg::KS)
B_KS = 128             # BF16's points a stage (wg::B_KS)
DEEP = 12_288          # ~ a chunk at the fine call and splits = 32
# TF32X3 (and BF16 against its rounded operands) vs float64, x max |ref|:
# the emulation sits at 2e-7 to 6e-7 for 1 to 32 splits; one TF32 product at
# 2.8e-4
WGRAD_GATE = 2e-6


# ---- the emulation ------------------------------------------------------------


def _chunks(n_pad, splits, ks=KS):
    chunk = -(-n_pad // splits)
    chunk = -(-chunk // ks) * ks
    return [(z * chunk, min(z * chunk + chunk, n_pad)) for z in range(splits)]


def _stage_products(xs, ds, mode):
    """Per stage: xs (stages, I, 32) times ds (stages, O, 32)^T in fp32."""
    dt = ds.transpose(1, 2)
    if mode == "tf32x3":
        xb, db = tc.tf32_rna(xs), tc.tf32_rna(dt)
        return (tc.tf32_trunc(xs - xb) @ db + xb @ tc.tf32_trunc(dt - db)
                + xb @ db)
    if mode == "tf32":  # one TF32 product: not a mode of the kernel
        return tc.tf32_rna(xs) @ tc.tf32_rna(dt)
    if mode == "bf16":
        return tc.bf16_rn(xs) @ tc.bf16_rn(dt)
    return xs @ dt


def emulate_product(x, d, mode, splits):
    """x (I, n_pad) @ d (O, n_pad)^T as the pass computes it, fp32: BF16
    in stages (and chunks) of B_KS points, the others of KS."""
    I, O = x.shape[0], d.shape[0]
    ks = B_KS if mode == "bf16" else KS
    out = torch.zeros(I, O)
    for k0, k1 in _chunks(x.shape[1], splits, ks):
        acc = torch.zeros(I, O)
        if k1 > k0:
            xs = x[:, k0:k1].reshape(I, -1, ks).transpose(0, 1)
            ds = d[:, k0:k1].reshape(O, -1, ks).transpose(0, 1)
            for part in _stage_products(xs, ds, mode):
                acc += part
        out += acc
    return out


def emulate_tile_bias(d, splits):
    """BF16's bias of D rows d (O, n_pad): each 64-point tile's fp32 sum
    (the tile pass), the tiles that start in a chunk added in tile order,
    the chunks in chunk order (reduce_kernel)."""
    tp = mlp_kernels.TILE
    tiles = d.reshape(d.shape[0], -1, tp).sum(-1)
    out = torch.zeros(d.shape[0])
    for k0, k1 in _chunks(d.shape[1], splits, B_KS):
        acc = torch.zeros(d.shape[0])
        for t in range(-(-k0 // tp), -(-k1 // tp)):
            acc += tiles[:, t]
        out += acc
    return out


def emulate_pass(X, D, C, view_pe, mode, splits):
    """The packed weight gradient from a scratch X, D ([row][point]) by the
    job table: the matrix products in `mode`, the thin jobs in fp32."""
    products, thin = mlp_kernels.wgrad_jobs(C, view_pe)
    out = torch.zeros(mlp_kernels.packed_size(C, view_pe))
    for q, (_, x0, I, d0, O, off, bias) in enumerate(products + thin):
        d = D[d0:d0 + O]
        if bias >= 0 and mode == "bf16":  # the tile pass's sums
            out[bias:bias + O] = emulate_tile_bias(d, splits)
        elif bias >= 0:  # summed in fp32 while the kernel splits D
            out[bias:bias + O] = emulate_product(
                torch.ones_like(d[:1]), d, "fp32", splits).reshape(-1)
        x = X[x0:x0 + I] if x0 >= 0 else torch.ones_like(d[:1])
        out[off:off + I * O] = emulate_product(
            x, d, mode if q < len(products) else "fp32", splits).reshape(-1)
    return out


def _rel(a, b):
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


# ---- a deep contraction -----------------------------------------------------------


def _deep_operands():
    """ReLU activations (64 rows) and pre-activation-gradient-like rows
    (128), DEEP points."""
    rng = np.random.default_rng(0)
    x = np.maximum(rng.normal(size=(64, DEEP)), 0.0)
    d = rng.normal(size=(128, DEEP)) * 1e-3
    return (torch.tensor(x, dtype=torch.float32),
            torch.tensor(d, dtype=torch.float32))


@pytest.mark.parametrize("splits", [1, 7, 32])
def test_tf32x3_pass_holds_float64_where_one_tf32_pass_does_not(splits):
    x, d = _deep_operands()
    ref = x.double() @ d.double().t()
    got = _rel(emulate_product(x, d, "tf32x3", splits), ref)
    one = _rel(emulate_product(x, d, "tf32", splits), ref)
    assert got <= WGRAD_GATE
    assert one > 100 * WGRAD_GATE


@pytest.mark.parametrize("splits", [1, 7, 32])
def test_bf16_pass_is_the_product_of_bf16_operands(splits):
    """fp32 accumulation, promoted every stage, adds nothing visible to the
    rounding of the operands: within WGRAD_GATE of the float64 product of
    the bf16-rounded operands, and at bf16 distance (below 1e-2, above
    WGRAD_GATE) from the float64 product of the fp32 ones."""
    x, d = _deep_operands()
    got = emulate_product(x, d, "bf16", splits)
    rounded = tc.bf16_rn(x).double() @ tc.bf16_rn(d).double().t()
    assert _rel(got, rounded) <= WGRAD_GATE
    assert 100 * WGRAD_GATE < _rel(got, x.double() @ d.double().t()) < 1e-2


# ---- a small NeRF's scratch against jax.grad ---------------------------------------


def _scratch(params, pts, vd, view_pe):
    """X and D of the backward scratch for sum(sin(out)) of the port's fp32
    network on these points, rows as fmlp::Scratch (K2's with view_pe, else
    K4's), zero past n: (X, D, n_pad)."""
    p = bridge.tree_map(lambda t: t.requires_grad_(True),
                        bridge.params_from_numpy(params, device="cpu"))
    S = pts.shape[1]
    x = torch.as_tensor(pts).reshape(-1, 3)
    n = x.shape[0]
    n_pad = -(-n // mlp_kernels.TILE) * mlp_kernels.TILE
    pe = temb.positional_encoding(x, 10)
    vpe = temb.positional_encoding(torch.as_tensor(vd), 4).repeat_interleave(S, 0)
    h, hs, pres = pe, [], []
    for layer in p["pts"]:
        t = (pe @ layer["w_pe"] + h @ layer["w_h"] if "w_pe" in layer
             else h @ layer["w"]) + layer["b"]
        pres.append(t)
        h = torch.relu(t)
        hs.append(h)
    f = h @ p["feature"]["w"] + p["feature"]["b"]
    pre_v = f @ p["views"]["w_feat"] + vpe @ p["views"]["w_pe"] + p["views"]["b"]
    hv = torch.relu(pre_v)
    out = torch.cat([hv @ p["rgb"]["w"] + p["rgb"]["b"],
                     h @ p["alpha"]["w"] + p["alpha"]["b"]], -1)
    C = out.shape[1] - 1
    inner = pres + [f, pre_v, out]
    grads = torch.autograd.grad(torch.sin(out).sum(), inner)
    x_rows = [(0, pe)] + [(mlp_kernels.X_H + l * 256, hs[l]) for l in range(8)]
    x_rows += [(mlp_kernels.X_F, f)]
    x_hv = mlp_kernels.X_VPE
    if view_pe:
        x_rows.append((mlp_kernels.X_VPE, vpe))
        x_hv += 32
    x_rows.append((x_hv, hv))
    d_rows = [(l * 256, grads[l]) for l in range(8)]
    d_rows += [(mlp_kernels.D_F, grads[8]), (mlp_kernels.D_HV, grads[9]),
               (mlp_kernels.D_G, grads[10])]
    X = torch.zeros(x_hv + 128, n_pad)
    D = torch.zeros(mlp_kernels.D_G + C + 1, n_pad)
    for M, rows in ((X, x_rows), (D, d_rows)):
        for r0, t in rows:
            M[r0:r0 + t.shape[1], :n] = t.detach().t()
    return X, D, n_pad


@pytest.fixture(scope="module")
def small_nerf():
    """A standard NeRF (C = 3) at 4 x 32 points away from ReLU ties, and
    jax.grad of sum(sin(nerf.apply)) w.r.t. its parameters."""
    params, pts, vd, _ = tc._inputs(4, 32, 3, seed=11)
    pts = sm._away_from_relu_ties(params, pts, vd, 4, seed=12)
    jp = jax.tree.map(jnp.asarray, params)
    g = jax.grad(lambda q: jnp.sum(jnp.sin(jnerf.apply(
        q, jnp.asarray(pts), jnp.asarray(vd)))))(jp)
    return params, pts, vd, jax.tree.map(np.asarray, g)


# emulated pass vs jax.grad, x max |gradient| of each packed entry: TF32X3
# at test_pallas_t's gradient bound for fp32 kernels; BF16 at
# test_bfloat16_mode's 2e-2
NERF_TOL = {"tf32x3": 1e-5, "bf16": 2e-2}


@pytest.mark.parametrize("view_pe", [True, False], ids=["K2", "K4"])
@pytest.mark.parametrize("mode", list(NERF_TOL))
def test_emulated_pass_gives_the_jax_weight_gradients(small_nerf, mode, view_pe):
    params, pts, vd, jgrads = small_nerf
    X, D, n_pad = _scratch(params, pts, vd, view_pe)
    want = mlp_kernels.pack_params(bridge.params_from_numpy(jgrads, device="cpu"),
                                 view_pe=view_pe)
    got = emulate_pass(X, D, 3, view_pe, mode, splits=3)
    layout = mlp_kernels.layout(3, view_pe)
    offs = mlp_kernels.offsets(layout)
    for q, (name, _) in enumerate(layout):
        a, b = got[offs[q]:offs[q + 1]], want[offs[q]:offs[q + 1]]
        if b.numel():
            assert _rel(a, b) <= NERF_TOL[mode], name
    # the pass's plain version, the CPU path of run_wgrad: on the fp32
    # scratch, and in bf16 on the bf16 format of it
    scr = mlp_kernels.Scratch(n_pad, "float32", X.reshape(-1), D.reshape(-1))
    if mode == "bf16":
        scr = mlp_kernels.bf16_scratch_plain(scr, 3, view_pe)
    plain = mlp_kernels.run_wgrad(scr, 3, view_pe=view_pe)
    assert plain.dtype == torch.float32 and plain.shape == want.shape
    for q, (name, _) in enumerate(layout):
        a, b = plain[offs[q]:offs[q + 1]], want[offs[q]:offs[q + 1]]
        if b.numel():
            assert _rel(a, b) <= NERF_TOL[mode], name


@pytest.mark.parametrize("view_pe,C", [(True, 1), (True, 7), (False, 3),
                                       (False, 127)])
def test_job_table_covers_the_packed_vector_once(view_pe, C):
    """Every entry of the packed gradient comes from exactly one job, the
    products' rows lie inside the scratch, and K4's table is K2's without
    wvpe."""
    products, thin = mlp_kernels.wgrad_jobs(C, view_pe)
    total = mlp_kernels.packed_size(C, view_pe)
    hits = torch.zeros(total, dtype=torch.int64)
    for _, off, size in mlp_kernels.wgrad_ranges(C, view_pe):
        hits[off:off + size] += 1
    assert bool((hits == 1).all())
    x_rows = mlp_kernels.X_VPE + (32 if view_pe else 0) + 128
    assert all(x0 >= -1 and d0 >= 0 for _, x0, _, d0, *_ in products + thin)
    assert all(x0 + I <= x_rows and d0 + O <= mlp_kernels.D_G
               for _, x0, I, d0, O, *_ in products)
    assert len(products) == (12 if view_pe else 11)
    k2 = [j[:5] for j in mlp_kernels.wgrad_jobs(C, True)[0]]
    assert [j[:5] for j in products] == k2[:len(products)]


# ---- BF16's scratch format ---------------------------------------------------------


def _random_scratch(view_pe, C, tiles=5, seed=3):
    """An fp32 scratch of normal numbers, K2's rows (view_pe) or K4's."""
    n_pad = tiles * mlp_kernels.TILE
    sizes = mlp_kernels.scratch_sizes(n_pad, C, view_pe)
    g = torch.Generator().manual_seed(seed)
    return mlp_kernels.Scratch(n_pad, "float32",
                             torch.randn(sizes[0], generator=g),
                             torch.randn(sizes[1], generator=g))


# the biases from fp32 tile sums against float64 sums of the fp32 rows, x the
# range's largest entry: the tile sums' rounding to fp32 (2^-24 each)
BIAS_TOL = 1e-6


@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("view_pe", [True, False], ids=["K2", "K4"])
def test_bf16_scratch_gives_the_pass_of_the_fp32_scratch_in_bf16(view_pe, C):
    """wgrad_plain on the bf16 format of a random fp32 scratch against
    wgrad_plain on that scratch with bf16 operands: every product bit for
    bit in float64, the heads too (their fp32 rows are copies), each bias
    within BIAS_TOL of its range's largest entry."""
    scr = _random_scratch(view_pe, C)
    ref = mlp_kernels.wgrad_plain(scr, C, view_pe, "bfloat16")
    b16 = mlp_kernels.bf16_scratch_plain(scr, C, view_pe)
    got = mlp_kernels.wgrad_plain(b16, C, view_pe)
    products, thin = mlp_kernels.wgrad_jobs(C, view_pe)
    for name, _, I, _, O, off, bias in products + thin:
        assert torch.equal(got[off:off + I * O], ref[off:off + I * O]), name
        if bias >= 0:
            a, b = got[bias:bias + O], ref[bias:bias + O]
            assert float((a - b).abs().max()) <= BIAS_TOL * float(b.abs().max()), name
    # and the plain version refuses fp32 operands of a bf16 scratch
    with pytest.raises(ValueError):
        mlp_kernels.wgrad_plain(b16, C, view_pe, "float32")


@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("view_pe", [True, False], ids=["K2", "K4"])
def test_bf16_scratch_has_the_library_sizes(view_pe, C):
    """The plain bf16 format fills the sizes of `scratch_sizes` (the
    library's, checked at load) with the row map its job table reads: the
    thin jobs' side rows hold h7, hv and the cotangent of the fp32 scratch
    (K2's cotangent in its own gside rows), K4's d vb rows its D_HV rows;
    bf16 rows are the fp32 ones rounded, in blocks of a tile's 64 points."""
    scr = _random_scratch(view_pe, C)
    n_pad = scr.n_pad
    b16 = mlp_kernels.bf16_scratch_plain(scr, C, view_pe)
    sizes = mlp_kernels.scratch_sizes(n_pad, C, view_pe, "bfloat16")
    assert (b16.x.numel(), b16.d.numel(), b16.side.numel(), b16.bsum.numel()) == sizes[:4]
    assert b16.x.dtype == b16.d.dtype == torch.bfloat16
    X, D, side = scr.x.view(-1, n_pad), scr.d.view(-1, n_pad), b16.side.view(-1, n_pad)
    dside = side
    if view_pe:
        assert b16.gside.numel() == sizes.gside
        dside = b16.gside.view(-1, n_pad)
    _, thin = mlp_kernels.wgrad_jobs(C, view_pe)
    _, thin_b = mlp_kernels.wgrad_jobs(C, view_pe, "bfloat16")
    for (name, x0, I, d0, O, *_), (_, xb, _, db, *_) in zip(thin, thin_b):
        assert torch.equal(dside[db:db + O], D[d0:d0 + O]), name
        if x0 >= 0:
            assert torch.equal(side[xb:xb + I], X[x0:x0 + I]), name
    if not view_pe:
        assert sizes.dvb == mlp_kernels.SIDE_DHV
        assert torch.equal(side[sizes.dvb:sizes.dvb + 128],
                           D[mlp_kernels.D_HV:mlp_kernels.D_G])
    rows = mlp_kernels.x_rows_bf16(view_pe)
    assert torch.equal(b16.rows("x"), X[:rows].to(torch.bfloat16))
    assert torch.equal(b16.rows("d"), D[:mlp_kernels.D_G].to(torch.bfloat16))
    # tile-blocked: a tile's 64 points of a row, then its next row
    t = mlp_kernels.TILE
    assert torch.equal(b16.x[t:2 * t], X[1, :t].to(torch.bfloat16))
    assert torch.equal(b16.x[rows * t:rows * t + t], X[0, t:2 * t].to(torch.bfloat16))
    products, _ = mlp_kernels.wgrad_jobs(C, view_pe, "bfloat16")
    assert all(x0 + I <= rows and d0 + O <= mlp_kernels.BIAS_ROWS
               for _, x0, I, d0, O, *_ in products)


@pytest.mark.parametrize("view_pe,fp32,bf16", [(True, 19_872 + 272, 11_384 + 272),
                                               (False, 19_728, 11_816)],
                         ids=["K2", "K4"])
def test_bf16_scratch_bytes_a_point(view_pe, fp32, bf16):
    """At C = 3: K2's fp32 scratch 19,872 B a point, its bf16 format 11,384
    (-43%), each with the 272 B of sign words K1 keeps for it; K4's 19,728
    and 11,816 (its signs stay in shared memory)."""
    n_pad = 6110 * mlp_kernels.TILE
    assert mlp_kernels.scratch_bytes(n_pad, 3, view_pe) == fp32 * n_pad
    assert mlp_kernels.scratch_bytes(n_pad, 3, view_pe, "bfloat16") == bf16 * n_pad


@pytest.mark.parametrize("compute_dtype,whole,kept",
                         [("float32", 19_872, 10_384), ("bfloat16", 11_384, 6_608)])
@pytest.mark.parametrize("C", [1, 3, 7])
def test_k2_scratch_splits_into_what_k1_keeps_and_the_backward_part(
        compute_dtype, whole, kept, C):
    """K2's scratch in two parts: what K1 keeps when autograd records its
    call (`mlp_kernels.KEPT`: X's rows, bf16's h7 and hv rows, 272 B of
    ReLU sign words a point) and what the backward allocates (D, bf16's
    cotangent rows and tile sums). Together they are the bytes the backward
    alone held before K1 kept its forward, 19,872 / 11,384 B a point at
    C = 3, and the sign words; the kept part does not depend on C."""
    n_pad = 6110 * mlp_kernels.TILE
    sizes = mlp_kernels.scratch_sizes(n_pad, C, True, compute_dtype)
    assert sizes.signs * 4 == 272 * n_pad == mlp_kernels.SIGN_WORDS * 4 * n_pad // 64
    k = mlp_kernels.scratch_bytes(n_pad, C, True, compute_dtype, "kept")
    b = mlp_kernels.scratch_bytes(n_pad, C, True, compute_dtype, "backward")
    assert k == kept * n_pad
    assert k + b == mlp_kernels.scratch_bytes(n_pad, C, True, compute_dtype)
    assert k + b == (whole + 272) * n_pad
    small = 3 * mlp_kernels.TILE
    kept_part = mlp_kernels.kept_scratch(small - 5, "cpu", compute_dtype)
    assert kept_part.n_pad == small and kept_part.d is None
    assert kept_part.nbytes() == mlp_kernels.scratch_bytes(small, C, True,
                                                         compute_dtype, "kept")
    assert kept_part.x.dtype == (torch.float32 if compute_dtype == "float32"
                                 else torch.bfloat16)
    assert (kept_part.side is None) == (compute_dtype == "float32")

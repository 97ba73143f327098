"""The weight-gradient pass of K2/K4 (csrc/wgrad_wgmma.cuh and
csrc/fused_mlp_bwd_common.cuh), on the CPU.

- a plain torch emulation of the pass's arithmetic: the point axis cut into
  `splits` chunks whose ends are multiples of the 32-point stage (as
  fmlp::weight_gradients cuts it); each stage's product in the kernel's
  mode into a fresh fp32 sum, added to the chunk's running fp32 sum (the
  promotion every stage); the chunk partials summed in chunk order
  (reduce_kernel). TF32X3: big = cvt.rna(x), written back to the stage;
  small = x - big, which the tensor core reads with its low 13 bits
  dropped; small*big + big*small + big*big. BF16: operands rounded to bf16
  (rn). The sums of D's rows (the biases) and the thin jobs (the 1- and
  C-column heads and their biases) stay fp32;
- on a contraction 12,288 points deep, TF32X3 holds float64 to WGRAD_GATE x
  scale at every split count, where one TF32 product misses it by two
  orders of magnitude; BF16 holds the float64 product of its bf16-rounded
  operands to the same gate;
- applied to the scratch of a small NeRF (the activations X and the
  pre-activation gradients D of sum(sin(out)), rows as fmlp::Scratch, by
  the job table `fused_mlp.wgrad_jobs`), the emulation and the pass's plain
  version (`run_wgrad` on CPU tensors) give the JAX package's weight
  gradients (jax.grad of benerf_tpu nerf.apply), for K2's table and K4's;
- the job table covers the packed gradient vector once.
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
from benerf_tpu_torch.ops import fused_mlp

KS = 32                # points a stage (wg::KS)
DEEP = 12_288          # ~ a chunk at the fine call and splits = 32
# TF32X3 (and BF16 against its rounded operands) vs float64, x max |ref|:
# the emulation sits at 2e-7 to 6e-7 for 1 to 32 splits; one TF32 product at
# 2.8e-4
WGRAD_GATE = 2e-6


# ---- the emulation ------------------------------------------------------------


def _chunks(n_pad, splits):
    chunk = -(-n_pad // splits)
    chunk = -(-chunk // KS) * KS
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
    """x (I, n_pad) @ d (O, n_pad)^T as the pass computes it, fp32."""
    I, O = x.shape[0], d.shape[0]
    out = torch.zeros(I, O)
    for k0, k1 in _chunks(x.shape[1], splits):
        acc = torch.zeros(I, O)
        if k1 > k0:
            xs = x[:, k0:k1].reshape(I, -1, KS).transpose(0, 1)
            ds = d[:, k0:k1].reshape(O, -1, KS).transpose(0, 1)
            for part in _stage_products(xs, ds, mode):
                acc += part
        out += acc
    return out


def emulate_pass(X, D, C, view_pe, mode, splits):
    """The packed weight gradient from a scratch X, D ([row][point]) by the
    job table: the matrix products in `mode`, the thin jobs in fp32."""
    products, thin = fused_mlp.wgrad_jobs(C, view_pe)
    out = torch.zeros(fused_mlp._offsets(fused_mlp._layout(C, view_pe))[-1])
    for q, (_, x0, I, d0, O, off, bias) in enumerate(products + thin):
        d = D[d0:d0 + O]
        if bias >= 0:  # summed in fp32 while the kernel splits D
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
    n_pad = -(-n // fused_mlp.TILE) * fused_mlp.TILE
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
    x_rows = [(0, pe)] + [(fused_mlp.X_H + l * 256, hs[l]) for l in range(8)]
    x_rows += [(fused_mlp.X_F, f)]
    x_hv = fused_mlp.X_VPE
    if view_pe:
        x_rows.append((fused_mlp.X_VPE, vpe))
        x_hv += 32
    x_rows.append((x_hv, hv))
    d_rows = [(l * 256, grads[l]) for l in range(8)]
    d_rows += [(fused_mlp.D_F, grads[8]), (fused_mlp.D_HV, grads[9]),
               (fused_mlp.D_G, grads[10])]
    X = torch.zeros(x_hv + 128, n_pad)
    D = torch.zeros(fused_mlp.D_G + C + 1, n_pad)
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
    want = fused_mlp.pack_params(bridge.params_from_numpy(jgrads, device="cpu"),
                                 view_pe=view_pe)
    got = emulate_pass(X, D, 3, view_pe, mode, splits=3)
    layout = fused_mlp._layout(3, view_pe)
    offs = fused_mlp._offsets(layout)
    for q, (name, _) in enumerate(layout):
        a, b = got[offs[q]:offs[q + 1]], want[offs[q]:offs[q + 1]]
        if b.numel():
            assert _rel(a, b) <= NERF_TOL[mode], name
    if mode == "tf32x3":  # the pass's plain version, the CPU path of run_wgrad
        plain = fused_mlp.run_wgrad(X.reshape(-1), D.reshape(-1), n_pad, 3,
                                    view_pe=view_pe)
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
    products, thin = fused_mlp.wgrad_jobs(C, view_pe)
    total = fused_mlp._offsets(fused_mlp._layout(C, view_pe))[-1]
    hits = torch.zeros(total, dtype=torch.int64)
    for _, off, size in fused_mlp.wgrad_ranges(C, view_pe):
        hits[off:off + size] += 1
    assert bool((hits == 1).all())
    x_rows = fused_mlp.X_VPE + (32 if view_pe else 0) + 128
    assert all(x0 >= -1 and d0 >= 0 for _, x0, _, d0, *_ in products + thin)
    assert all(x0 + I <= x_rows and d0 + O <= fused_mlp.D_G
               for _, x0, I, d0, O, *_ in products)
    assert len(products) == (12 if view_pe else 11)
    k2 = [j[:5] for j in fused_mlp.wgrad_jobs(C, True)[0]]
    assert [j[:5] for j in products] == k2[:len(products)]

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (benerf_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, in order; any failure raises and exits non-zero (no phase catches
an exception):
  1. environment: torch / CUDA versions, the card's name and power limit,
     and the build of every kernel (K1-K4) from benerf_tpu_torch/csrc with
     nvcc;
  2. K1/K2 against their plain PyTorch version on the card, at the shapes
     of the training path (coarse n = 3,055 x 64 = 195,520 points, fine
     n = 3,055 x 128 = 391,040) and at a ragged n with BARF on and off,
     C in {1, 3, 7} (C + 1 = 8 fills every head row): in fp32 mode (TF32X3) against fp32 nerf.apply, in bf16
     mode against nerf.apply with bf16 operands and float64 (check_*_bf16);
     K2 also rerun with another split count; CUDA-event times of kernel,
     plain version, both bounds, and of K2's weight-gradient pass beside
     torch.matmul of the same products;
  3. the tanabata slice: the config at full width (400x600, 1024 event +
     1024 rgb rays over 19 poses, 64+64 samples, 8x256 MLPs) trained for
     ITERS iterations on a scene made in memory from a seed, with the launch
     counters showing every MLP call went through K1/K2 in fp32 mode and
     none through K3/K4 or the plain route;
  4. the same slice with compute_dtype = "bfloat16" for BF16_ITERS
     iterations, every MLP call through K1/K2 in bf16 mode;
  5. K3/K4 against their plain version (a view encoding of L = 6, 39 rows)
     at both training n and at ragged n, C in {1, 3, 8}; K4 at two split
     counts; times beside the bound;
  6. the L = 6 slice: tanabata with multires_views = 6 and caller-built
     MLPs, L6_ITERS train steps through make_train_step on the same scene,
     every MLP call through K3/K4;
  7. the card routes: a width-128 MLP and one without viewdirs take the
     plain route (as in the JAX package); bf16 runs K1/K2 on the fused
     route and raises on the staged one;
  8. the results: a {"kernels": [...]} line, the nvidia-smi line, and last
     {"ok": true, "device": {...}}.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

TANABATA = Path(__file__).resolve().parent / "configs/benerf_blender/tanabata.txt"
ITERS = 25
BF16_ITERS = 10
LOG_EVERY = 5
L6_ITERS = 16                # of which the first L6_WARMUP are not timed
L6_WARMUP = 4
N_EVENTS = 1_000_000
RAYS = 3055                  # 2 x 1024 event rays + 19 x 53 rgb rays
FWD_TOL = 2e-4               # x max(output scale, 1)
GRAD_TOL = 5e-4              # x max(leaf scale, 1)
KINK_FRAC = 1e-3             # per-point gradient elements allowed past tol
BF16_FWD_TOL = 2e-2          # x max(output scale, 1), as test_bfloat16_mode
# bf16 mode's gradients: their distance to float64 at most BF16_GRAD_FACTOR
# and at least BF16_GRAD_FLOOR times the plain version's with bf16 operands
# (measured 0.74-1.52x on an H100 at the shapes phase 2 checks, PERF.md); the
# floor fails a kernel that ignores the mode: fp32 operands sit ~1e-3x as far
BF16_GRAD_FACTOR = 2.0
BF16_GRAD_FLOOR = 0.3
FP32_PEAK = 67e12            # H100 SXM fp32 outside the tensor cores
TC_PEAK = {"float32": 495e12 / 3,   # TF32X3: three TF32 products a FLOP
           "bfloat16": 989e12}      # dense bf16
MODE_NAME = {"float32": "tf32x3", "bfloat16": "bf16"}
HBM_BYTES_S = 3.35e12        # H100 SXM HBM3
# K2's fp32 scratch a point, each way: a cost of its two-pass design, not of
# the function, so outside its bound (reported as scratch_floor_ms)
K2_SCRATCH_B = (2528 + 2440) * 4
# (I, O) of the matrix products of K2's weight-gradient pass: w0, wh x 7,
# w5pe, wf, wfv, wvpe
WGRAD_SHAPES = ([(63, 256)] + [(256, 256)] * 7 + [(63, 256), (256, 256),
                                                   (256, 128), (27, 128)])


def flops_fwd_per_point(depth=8, width=256, input_ch=63, views_ch=27,
                        channels=3):
    """Matrix-product FLOP of one MLP point evaluation (2 per multiply-add);
    views_ch=0 for K3, whose view-encoding product runs outside."""
    f = input_ch * width + (depth - 2) * width * width
    f += (width + input_ch) * width + width * width + width
    f += (width + views_ch) * (width // 2) + (width // 2) * channels
    return 2 * f


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def _inputs(torch, R, S, C, seed, barf, views_ch=27):
    from benerf_tpu_torch.models import bridge, embedder, nerf

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    params = nerf.init_params(g, channels=C, input_ch_views=views_ch,
                              device="cuda")
    # small nonzero biases so every bias gradient is exercised
    params = bridge.tree_map(lambda t: t + (torch.rand(
        t.shape, generator=g, device="cuda") - 0.5) * 0.1 if t.ndim == 1
        else t, params)
    pts = torch.rand((R, S, 3), generator=g, device="cuda") * 2.0 - 1.0
    vd = torch.randn((R, 3), generator=g, device="cuda")
    vd = vd / torch.linalg.norm(vd, dim=-1, keepdim=True)
    bw = bwv = None
    if barf:
        bw = embedder.barf_c2f_weights(1000, 8000, 10, 0.1, 0.5, device="cuda")
        bwv = embedder.barf_c2f_weights(1000, 8000, 4, 0.1, 0.5, device="cuda")
    return params, pts, vd, bw, bwv


def _max_err(a, b):
    return float((a - b).abs().max()), max(float(b.abs().max()), 1.0)


def _pair(which):
    """(op, view-encoding rows, kwargs) of kernel pair "K1/K2" or "K3/K4"."""
    from benerf_tpu_torch.ops import fused_mlp, staged_mlp

    if which == "K1/K2":
        return fused_mlp.fused_nerf_mlp, 27, {}
    return staged_mlp.staged_nerf_mlp, 39, {"num_freqs_views": 6}


def _barf_kw(bw, bwv):
    return {} if bw is None else {"barf_weights": bw, "barf_weights_views": bwv}


def check_fwd(torch, which, R, S, C, barf, seed=0):
    """K1 or K3 (fp32) vs nerf.apply on the card -> (max abs err, scale)."""
    from benerf_tpu_torch.models import nerf

    op, views_ch, kw = _pair(which)
    params, pts, vd, bw, bwv = _inputs(torch, R, S, C, seed, barf, views_ch)
    kw = {**kw, **_barf_kw(bw, bwv)}
    with torch.no_grad():
        out_k = op(params, pts, vd, **kw)
        out_p = nerf.apply(params, pts, vd, **kw)
    torch.cuda.synchronize()
    err, scale = _max_err(out_k, out_p)
    name = which.split("/")[0]
    print(f"  {name} R={R} S={S} C={C} barf={barf}: max abs err {err:.3e} "
          f"(tol {FWD_TOL * scale:.3e})")
    if not err <= FWD_TOL * scale:
        raise AssertionError(f"{name} disagrees with the plain version: {err}")
    return err, scale


def _grads(torch, fn, params, pts, vd, **kw):
    from benerf_tpu_torch.models import bridge

    leaves = [t.detach().requires_grad_(True) for t in bridge.tree_leaves(params)]
    p = bridge.tree_unflatten(params, leaves)
    x = pts.detach().requires_grad_(True)
    v = vd.detach().requires_grad_(True)
    loss = torch.sum(torch.sin(fn(p, x, v, **kw)))
    return torch.autograd.grad(loss, leaves + [x, v])


def check_bwd(torch, which, R, S, C, barf, seed=0, splits=None):
    """K2 or K4 vs autograd through nerf.apply: gradients of sum(sin(out))
    w.r.t. every weight, pts and viewdirs.

    Every element of every weight gradient must be within GRAD_TOL x
    max(scale, 1). Per-point gradients (d pts, and d viewdir, a sum over the
    ray's samples) are held to the same bound, except that at most a
    fraction KINK_FRAC of their elements may fall outside it: where a ReLU
    input lies within rounding of 0, the two fp32 forwards may take opposite
    sides of the kink and that point's gradient then differs by design.
    Returns (worst weight err, worst weight err / scale, per-point elements
    outside the bound, gradients)."""
    from benerf_tpu_torch.models import nerf

    op, views_ch, kw = _pair(which)
    name = which.split("/")[1]
    params, pts, vd, bw, bwv = _inputs(torch, R, S, C, seed, barf, views_ch)
    kw = {**kw, **_barf_kw(bw, bwv)}
    gk = _grads(torch, op, params, pts, vd, **kw,
                **({} if splits is None else {"splits": splits}))
    gp = _grads(torch, nerf.apply, params, pts, vd, **kw)
    torch.cuda.synchronize()
    n_w = len(gp) - 2
    worst_err, worst_rel = 0.0, 0.0
    for a, b in zip(gk[:n_w], gp[:n_w]):
        err, scale = _max_err(a, b)
        worst_err, worst_rel = max(worst_err, err), max(worst_rel, err / scale)
        if not err <= GRAD_TOL * scale:
            raise AssertionError(
                f"{name} weight gradient of shape {tuple(b.shape)} disagrees: "
                f"{err} (scale {scale})")
    outside = []
    for a, b in zip(gk[n_w:], gp[n_w:]):
        scale = max(float(b.abs().max()), 1.0)
        n_out = int(((a - b).abs() > GRAD_TOL * scale).sum())
        outside.append(n_out)
        if n_out > KINK_FRAC * b.numel():
            raise AssertionError(
                f"{name} per-point gradient of shape {tuple(b.shape)}: {n_out} "
                f"of {b.numel()} elements outside {GRAD_TOL} x {scale}")
    print(f"  {name} R={R} S={S} C={C} barf={barf}: weight grads max abs err "
          f"{worst_err:.3e}, worst err/scale {worst_rel:.3e} (tol "
          f"{GRAD_TOL:.1e}); d pts / d viewdirs elements outside tol: "
          f"{outside[0]} of {gp[-2].numel()} / {outside[1]} of {gp[-1].numel()}")
    return worst_err, worst_rel, sum(outside), gk


def _f64(torch, tree):
    from benerf_tpu_torch.models import bridge

    return bridge.tree_map(lambda t: t.double(), tree)


def _dist(a_list, b_list):
    """Worst max|a - b| / max(|b|, 1) over a list of tensor pairs."""
    return max(_max_err(a.double(), b.double())[0] / _max_err(a, b)[1]
               for a, b in zip(a_list, b_list))


def _rms_rel(a, b):
    return float((a.double() - b.double()).pow(2).mean().sqrt()
                 / b.double().pow(2).mean().sqrt().clamp_min(1e-30))


def check_bf16(torch, R, S, C, barf, seed=0):
    """K1/K2 in bf16 mode. Forward: vs nerf.apply with bf16 operands within
    BF16_FWD_TOL x scale. Gradients of sum(sin(out)): finite; the weight
    gradients' worst err/scale and the per-point gradients' RMS error, each
    against a float64 run of nerf.apply, between BF16_GRAD_FLOOR and
    BF16_GRAD_FACTOR times the plain bf16 version's. -> (fwd err/scale, weight-grad distances to f64
    (kernel, plain), per-point RMS distances (kernel, plain))."""
    from benerf_tpu_torch.models import nerf
    from benerf_tpu_torch.ops import fused_mlp

    params, pts, vd, bw, bwv = _inputs(torch, R, S, C, seed, barf)
    kw = _barf_kw(bw, bwv)
    with torch.no_grad():
        out_k = fused_mlp.fused_nerf_mlp(params, pts, vd, compute_dtype="bfloat16",
                                         **kw)
        out_p = nerf.apply(params, pts, vd, compute_dtype=torch.bfloat16, **kw)
    err, scale = _max_err(out_k, out_p)
    gk = _grads(torch, fused_mlp.fused_nerf_mlp, params, pts, vd,
                compute_dtype="bfloat16", **kw)
    gp = _grads(torch, nerf.apply, params, pts, vd,
                compute_dtype=torch.bfloat16, **kw)
    g64 = _grads(torch, nerf.apply, _f64(torch, params), pts.double(),
                 vd.double(), **{k: v.double() for k, v in kw.items()})
    torch.cuda.synchronize()
    n_w = len(g64) - 2
    wk, wp = _dist(gk[:n_w], g64[:n_w]), _dist(gp[:n_w], g64[:n_w])
    pk = max(_rms_rel(a, b) for a, b in zip(gk[n_w:], g64[n_w:]))
    pp = max(_rms_rel(a, b) for a, b in zip(gp[n_w:], g64[n_w:]))
    print(f"  K1/K2 bf16 R={R} S={S} C={C} barf={barf}: fwd err/scale "
          f"{err / scale:.3e} (tol {BF16_FWD_TOL}); to float64: weight grads "
          f"{wk:.3e} (plain bf16 {wp:.3e}), per-point RMS {pk:.3e} (plain "
          f"{pp:.3e}); factor limits [{BF16_GRAD_FLOOR}, {BF16_GRAD_FACTOR}]")
    if not err <= BF16_FWD_TOL * scale:
        raise AssertionError(f"K1 bf16 disagrees with the plain version: {err}")
    if not all(bool(torch.isfinite(g).all()) for g in gk):
        raise AssertionError("K2 bf16: non-finite gradients")
    if not (BF16_GRAD_FLOOR * wp <= wk <= BF16_GRAD_FACTOR * wp
            and BF16_GRAD_FLOOR * pp <= pk <= BF16_GRAD_FACTOR * pp):
        raise AssertionError(f"K2 bf16 gradients' distance to float64 not that "
                             f"of bf16 operands: {wk} vs {wp}, {pk} vs {pp}")
    wabs = max(float((a.double() - b).abs().max())
               for a, b in zip(gk[:n_w], g64[:n_w]))
    return dict(fwd_err=err, fwd_rel=err / scale, wgrad_abs_vs_f64=wabs,
                wgrad_vs_f64=wk, plain_wgrad_vs_f64=wp, points_rms_vs_f64=pk,
                plain_points_rms_vs_f64=pp)


def check_splits(torch, which, g_default, tol):
    """The backward kernel at 7 splits against `g_default` (its default
    split count) on the fine shape: weight gradients within tol x scale,
    per-point gradients bitwise equal (they do not pass the reduction)."""
    name = which.split("/")[1]
    g7 = check_bwd(torch, which, RAYS, 128, 3, False, seed=2, splits=7)[3]
    worst = max(_max_err(a, b)[0] / _max_err(a, b)[1]
                for a, b in zip(g7[:-2], g_default[:-2]))
    same_points = all(torch.equal(a, b) for a, b in zip(g7[-2:], g_default[-2:]))
    print(f"  {name} splits 7 vs 32: weight grads worst diff/scale {worst:.3e}; "
          f"per-point grads bitwise equal: {same_points}")
    if not (worst <= tol and same_points):
        raise AssertionError(f"{name} depends on the split count: {worst}")


def time_ms(torch, fn, iters=12, warmup=2):
    """Median CUDA-event time of fn() over `iters` runs after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def time_kernels(torch, S, C=3, compute_dtype="float32"):
    """(K1 ms, plain fwd ms, K2 ms, plain fwd+bwd ms) at n = RAYS * S in the
    kernels' mode for `compute_dtype`; the plain version runs in it too."""
    from benerf_tpu_torch.models import bridge, nerf
    from benerf_tpu_torch.ops import fused_mlp

    params, pts, vd, _, _ = _inputs(torch, RAYS, S, C, 1, False)
    n = RAYS * S
    cd = None if compute_dtype == "float32" else torch.bfloat16
    packed = fused_mlp.pack_params(params, interleaved=False).contiguous()
    band = fused_mlp.band_weights(None, None, "cuda")
    x = pts.reshape(n, 3).contiguous()
    g = torch.randn((n, C + 1), device="cuda")
    # the plain version's backward also yields d pts and d viewdirs, as K2
    wrt = [t.requires_grad_(True) for t in bridge.tree_leaves(params)]
    wrt += [pts.requires_grad_(True), vd.requires_grad_(True)]

    def plain_fwd():
        with torch.no_grad():
            nerf.apply(params, pts, vd, compute_dtype=cd)

    def plain_fwd_bwd():
        out = nerf.apply(params, pts, vd, compute_dtype=cd).reshape(n, C + 1)
        torch.autograd.grad(out, wrt, g)

    k1 = time_ms(torch, lambda: fused_mlp.launch_fwd(packed, x, vd, band, S, C,
                                                     compute_dtype))
    k2 = time_ms(torch, lambda: fused_mlp.launch_bwd(
        packed, x, vd, band, g, S, C, compute_dtype=compute_dtype))
    p1 = time_ms(torch, plain_fwd)
    p2 = time_ms(torch, plain_fwd_bwd)
    return k1, p1, k2, p2


def time_wgrad(torch, S, C=3, compute_dtype="float32"):
    """(K2's weight-gradient pass ms, torch.matmul of the same 12 products
    ms in fp32, the same in TF32) at n = RAYS * S. The pass runs alone on a
    scratch of random numbers (its work does not depend on the values);
    torch.matmul is the yardstick only: the port never calls it."""
    from benerf_tpu_torch.ops import fused_mlp

    n = RAYS * S
    n_pad, x_scr, d_scr = fused_mlp.bwd_scratch(n, "cuda")
    x_scr.normal_()
    d_scr.normal_()
    k = time_ms(torch, lambda: fused_mlp.run_wgrad(x_scr, d_scr, n_pad, C,
                                                   compute_dtype=compute_dtype))
    del x_scr, d_scr
    xs = torch.randn((sum(i for i, _ in WGRAD_SHAPES), n), device="cuda")
    ds = torch.randn((sum(o for _, o in WGRAD_SHAPES), n), device="cuda")
    pairs, i0, o0 = [], 0, 0
    for i, o in WGRAD_SHAPES:
        pairs.append((xs[i0:i0 + i], ds[o0:o0 + o]))
        i0, o0 = i0 + i, o0 + o

    def library():
        for a, b in pairs:
            torch.matmul(a, b.t())

    tf32 = torch.backends.cuda.matmul.allow_tf32
    times = []
    for allow in (False, True):
        torch.backends.cuda.matmul.allow_tf32 = allow
        times.append(time_ms(torch, library))
    torch.backends.cuda.matmul.allow_tf32 = tf32
    return k, times[0], times[1]


def time_staged_kernels(torch, S, C=3):
    """(K3 ms, plain fwd ms, K4 ms, plain fwd+bwd ms) at n = RAYS * S, view
    encoding L = 6; the per-ray view bias is made outside, as on the path."""
    from benerf_tpu_torch.models import bridge, embedder, nerf
    from benerf_tpu_torch.ops import fused_mlp, staged_mlp

    params, pts, vd, _, _ = _inputs(torch, RAYS, S, C, 1, False, views_ch=39)
    n = RAYS * S
    packed = fused_mlp.pack_params(params, view_pe=False).contiguous()
    vb = (embedder.positional_encoding(vd, 6) @ params["views"]["w_pe"]
          + params["views"]["b"]).contiguous()
    x = pts.reshape(n, 3).contiguous()
    g = torch.randn((n, C + 1), device="cuda")
    wrt = [t.requires_grad_(True) for t in bridge.tree_leaves(params)]
    wrt += [pts.requires_grad_(True), vd.requires_grad_(True)]

    def plain_fwd():
        with torch.no_grad():
            nerf.apply(params, pts, vd, num_freqs_views=6)

    def plain_fwd_bwd():
        out = nerf.apply(params, pts, vd, num_freqs_views=6).reshape(n, C + 1)
        torch.autograd.grad(out, wrt, g)

    k3 = time_ms(torch, lambda: staged_mlp.launch_fwd(packed, x, vb, S, C))
    k4 = time_ms(torch, lambda: staged_mlp.launch_bwd(packed, x, vb, g, S, C))
    p1 = time_ms(torch, plain_fwd)
    p2 = time_ms(torch, plain_fwd_bwd)
    return k3, p1, k4, p2


def reset_counts():
    """Every kernel's launch count and the plain route's count to 0."""
    from benerf_tpu_torch.ops import fused_mlp, mlp, staged_mlp

    for d in (fused_mlp.LAUNCHES, staged_mlp.LAUNCHES, mlp.ROUTES):
        for k in d:
            d[k] = 0


def counts():
    from benerf_tpu_torch.ops import fused_mlp, mlp, staged_mlp

    return {**fused_mlp.LAUNCHES, **staged_mlp.LAUNCHES,
            "plain_route": mlp.ROUTES["plain"]}


def expect_counts(got, iters, kernels):
    """2 launches per iteration of each kernel in `kernels` (one coarse and
    one fine MLP call per step), none of any other, no plain route."""
    want = {k: 2 * iters if k in kernels else 0 for k in got}
    if got != want:
        raise AssertionError(f"launch counts {got}, expected {want}")


def run_slice(torch, scene, iters=ITERS, compute_dtype="float32"):
    """tanabata at full width for `iters` iterations through the train loop
    with the MLPs in `compute_dtype` -> (ms/iter, rays/s, launch counts,
    wall s)."""
    from benerf_tpu_torch.core.config import load_config
    from benerf_tpu_torch.ops import fused_mlp
    from benerf_tpu_torch.train import loop

    cfg = dataclasses.replace(load_config(str(TANABATA)),
                              compute_dtype=compute_dtype)
    rays_per_iter = (2 * cfg.sampling_event_rays + cfg.num_interpolated_pose
                     * (cfg.sampling_rgb_rays // cfg.num_interpolated_pose))
    assert rays_per_iter == RAYS, rays_per_iter

    with tempfile.TemporaryDirectory() as logdir:
        cfg = dataclasses.replace(
            cfg, render_image_iter=0, save_model_iter=0, render_video_iter=0,
            max_iter=iters, console_log_iter=LOG_EVERY, logdir=logdir)
        reset_counts()
        t0 = time.perf_counter()
        loop.train(cfg, scene, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counts()
        with open(f"{logdir}/0/metrics.jsonl") as f:
            recs = [json.loads(line) for line in f]
    losses = [r["train_loss"] for r in recs if "train_loss" in r]
    rates = [r["rays_per_sec"] for r in recs if "rays_per_sec" in r]
    if len(losses) != iters or not all(np.isfinite(losses)):
        raise AssertionError(f"losses not all finite: {losses}")
    expect_counts(launches, iters, tuple(fused_mlp.launch_key(k, compute_dtype)
                                         for k in ("fused_mlp_fwd", "fused_mlp_bwd")))
    steady = rates[-1]  # the last LOG_EVERY iterations
    print(f"  {iters} iterations in {wall:.2f} s; losses {losses[0]:.5f} -> "
          f"{losses[-1]:.5f}; launches {launches}")
    return 1e3 * RAYS / steady, steady, launches, wall


def run_l6_slice(torch, scene):
    """tanabata with multires_views = 6: both NeRFs built by the caller with
    39 view-encoding rows, L6_ITERS steps of make_train_step (one host sync
    per step, as the train loop) -> (ms/iter, rays/s, launch counts,
    losses)."""
    from benerf_tpu_torch.core.config import load_config
    from benerf_tpu_torch.data import events as events_util
    from benerf_tpu_torch.models import bridge, nerf
    from benerf_tpu_torch.train import loop
    from benerf_tpu_torch.train import step as step_mod

    cfg = dataclasses.replace(load_config(str(TANABATA)), multires_views=6)
    if cfg.event_time_window and cfg.event_window_cap == 0:  # as loop.train
        cfg = dataclasses.replace(cfg, event_window_cap=events_util.window_cap(
            scene.events.ts.cpu().numpy(), cfg.accumulate_time_length))
    H, W = scene.image.shape[1:3]
    K_rgb, K_evt, _, _, _ = loop.intrinsics(cfg)
    batch = loop.make_batch(scene, cfg, K_rgb, K_evt, "cuda")
    params = step_mod.build_params(cfg, cfg.seed, device="cuda")
    g = torch.Generator(device="cuda")
    g.manual_seed(cfg.seed + 1)
    for name in ("nerf", "nerf_fine"):
        params[name] = bridge.tree_map(
            lambda t: t.requires_grad_(True),
            nerf.init_params(g, input_ch_views=39, channels=cfg.channels,
                             device="cuda"))
    state = step_mod.init_state(cfg, cfg.seed, device="cuda", params=params)
    step_fn = step_mod.make_train_step(cfg, H, W)

    losses = []
    reset_counts()
    for i in range(L6_ITERS):
        if i == L6_WARMUP:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state, metrics = step_fn(state, batch, cfg.seed)
        losses.append(metrics["loss"].item())
    torch.cuda.synchronize()
    ms_iter = 1e3 * (time.perf_counter() - t0) / (L6_ITERS - L6_WARMUP)
    launches = counts()
    if not all(np.isfinite(losses)):
        raise AssertionError(f"losses not all finite: {losses}")
    expect_counts(launches, L6_ITERS, ("staged_mlp_fwd", "staged_mlp_bwd"))
    print(f"  {L6_ITERS} iterations; losses {losses[0]:.5f} -> {losses[-1]:.5f}; "
          f"launches {launches}")
    return ms_iter, 1e3 * RAYS / ms_iter, launches, losses


def _raises(exc, fn):
    """Whether fn() raises `exc` (any other exception propagates)."""
    try:
        fn()
    except exc:
        return True
    return False


def check_routes(torch):
    """Routes on the card: the plain route where the JAX package has no
    kernel (counted, no kernel launched); bf16 on the fused route launches
    K1 in bf16 mode, on the staged route it raises."""
    from benerf_tpu_torch.models import nerf
    from benerf_tpu_torch.ops import mlp

    g = torch.Generator(device="cuda")
    g.manual_seed(5)
    pts = torch.rand((4, 16, 3), generator=g, device="cuda") * 2.0 - 1.0
    vd = torch.nn.functional.normalize(
        torch.randn((4, 3), generator=g, device="cuda"), dim=-1)
    narrow = nerf.init_params(g, width=128, device="cuda")
    no_views = nerf.init_params(g, use_viewdirs=False, device="cuda")
    reset_counts()
    outs = [mlp.mlp_forward(narrow, pts, vd), mlp.mlp_forward(no_views, pts, None)]
    got = counts()
    want = {k: 2 if k == "plain_route" else 0 for k in got}
    if got != want or not all(o.shape == (4, 16, 4) and bool(torch.isfinite(o).all())
                              for o in outs):
        raise AssertionError(f"plain route: counts {got}, expected {want}")
    standard = nerf.init_params(g, device="cuda")
    l6 = nerf.init_params(g, input_ch_views=39, device="cuda")
    reset_counts()
    out = mlp.mlp_forward(standard, pts, vd, compute_dtype="bfloat16")
    bf = counts()
    want = {k: 1 if k == "fused_mlp_fwd_bf16" else 0 for k in bf}
    if bf != want or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"bf16 on the fused route: counts {bf}, expected {want}")
    print(f"  fused route: bf16 runs K1 in bf16 mode, counts {bf}")
    if not _raises(NotImplementedError, lambda: mlp.mlp_forward(
            l6, pts, vd, compute_dtype="bfloat16", num_freqs_views=6)):
        raise AssertionError("bf16 on the staged route did not raise")
    print("  staged route: bf16 raises NotImplementedError")
    print(f"  width 128 and no viewdirs: plain route, counts {got}")


def _bound(flops, peak, nbytes):
    """(bound ms, "operations" or "bytes")."""
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def _per_n_fused(torch, compute_dtype, C=3):
    """K1/K2 in one mode at both training n: times, plain times, bounds.
    Forward bytes: pts, viewdirs, outputs, weights; backward adds the
    cotangent, d pts, d viewdir per point and the weight gradients.
    Operations: 1x (K1) and 3x (K2) the forward's FLOP, at the tensor-core
    rate of the mode (TC_PEAK) for the bound and at FP32_PEAK for the
    CUDA-core bound beside it. K2's fp32 scratch, written and read back
    (K2_SCRATCH_B a point each way), is its design's own floor
    (bwd_scratch_floor_ms), not part of the bound. K2's weight-gradient pass
    is timed alone too, beside torch.matmul of its products (its
    `library_ms`); its bound counts the scratch, which is its input."""
    from benerf_tpu_torch.ops import fused_mlp

    flops_pt = flops_fwd_per_point()
    weights = fused_mlp._offsets(fused_mlp._layout(C))[-1]
    peak = TC_PEAK[compute_dtype]
    out = {}
    for S in (64, 128):
        n = RAYS * S
        n_pad = -(-n // fused_mlp.TILE) * fused_mlp.TILE
        kf, pf, kb, pb = time_kernels(torch, S, C, compute_dtype)
        kw, lib32, lib_tf32 = time_wgrad(torch, S, C, compute_dtype)
        bytes_f = (n * (3 + C + 1) + RAYS * 3 + weights) * 4
        bytes_b = bytes_f + (n * (C + 1 + 3 + 3) + weights) * 4
        flops = flops_pt * n
        wflops = 2 * n * sum(i * o for i, o in WGRAD_SHAPES)
        d = dict(fwd_ms=kf, fwd_plain_ms=pf, bwd_ms=kb, bwd_plain_ms=pb,
                 fwd_fp32_core_bound_ms=flops / FP32_PEAK * 1e3,
                 bwd_fp32_core_bound_ms=3 * flops / FP32_PEAK * 1e3,
                 wgrad_ms=kw, wgrad_library_fp32_ms=lib32,
                 wgrad_library_tf32_ms=lib_tf32,
                 bwd_scratch_floor_ms=2 * K2_SCRATCH_B * n_pad / HBM_BYTES_S * 1e3)
        d["fwd_bound_ms"], d["fwd_bound_by"] = _bound(flops, peak, bytes_f)
        d["bwd_bound_ms"], d["bwd_bound_by"] = _bound(3 * flops, peak, bytes_b)
        d["wgrad_bound_ms"], d["wgrad_bound_by"] = _bound(
            wflops, peak, K2_SCRATCH_B * n_pad + weights * 4)
        out[n] = d
        print(f"  {MODE_NAME[compute_dtype]} n={n}: K1 {kf:.3f} ms (plain {pf:.3f}, "
              f"bound {d['fwd_bound_ms']:.3f}, fp32-core bound "
              f"{d['fwd_fp32_core_bound_ms']:.3f}); K2 {kb:.3f} ms (plain "
              f"fwd+bwd {pb:.3f}, bound {d['bwd_bound_ms']:.3f} "
              f"{d['bwd_bound_by']}, fp32-core {d['bwd_fp32_core_bound_ms']:.3f}, "
              f"scratch floor {d['bwd_scratch_floor_ms']:.3f}); "
              f"its weight-gradient pass {kw:.3f} ms (bound "
              f"{d['wgrad_bound_ms']:.3f}; torch.matmul fp32 {lib32:.3f}, "
              f"TF32 {lib_tf32:.3f})")
    return out


def _per_n_staged(torch, C=3):
    """K3/K4 at both training n: forward bytes are pts, the per-ray view
    bias, the outputs and the weights; backward adds the cotangent, d pts,
    the bias gradient and the weight gradients. K3 and K4's tile pass are
    fp32 on CUDA cores; K4's weight gradients run on the tensor cores in
    TF32X3: K4's bound is 2x the forward's FLOP at FP32_PEAK plus 1x at the
    TF32X3 rate."""
    from benerf_tpu_torch.ops import fused_mlp

    flops_pt = flops_fwd_per_point(views_ch=0)
    weights = fused_mlp._offsets(fused_mlp._layout(C, view_pe=False))[-1]
    out = {}
    for S in (64, 128):
        n = RAYS * S
        kf, pf, kb, pb = time_staged_kernels(torch, S, C)
        view = RAYS * 128
        bytes_f = (n * (3 + C + 1) + view + weights) * 4
        bytes_b = bytes_f + (n * (C + 1 + 3) + view + weights) * 4
        flops = flops_pt * n
        d = dict(fwd_ms=kf, fwd_plain_ms=pf, bwd_ms=kb, bwd_plain_ms=pb,
                 fwd_fp32_core_bound_ms=flops / FP32_PEAK * 1e3,
                 bwd_fp32_core_bound_ms=3 * flops / FP32_PEAK * 1e3)
        d["fwd_bound_ms"], d["fwd_bound_by"] = _bound(flops, FP32_PEAK, bytes_f)
        t_ops = 2 * flops / FP32_PEAK + flops / TC_PEAK["float32"]
        t_bytes = bytes_b / HBM_BYTES_S
        d["bwd_bound_ms"] = max(t_ops, t_bytes) * 1e3
        d["bwd_bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
        out[n] = d
        print(f"  n={n}: fwd {kf:.3f} ms (plain {pf:.3f}, bound "
              f"{d['fwd_bound_ms']:.3f}), bwd {kb:.3f} ms (plain fwd+bwd "
              f"{pb:.3f}, bound {d['bwd_bound_ms']:.3f})")
    return out


def _kernel_line(name, source, replaces, mode, launches, errs, tol, per_n,
                 side, **extra):
    fine = RAYS * 128
    d = per_n[fine]
    return dict(
        name=name, route="cuda", source=source, replaces=replaces, mode=mode,
        launches=launches, max_abs_err=max(e for e, _ in errs.values()),
        max_err_over_scale=max(r for _, r in errs.values()), tolerance=tol,
        ms=d[f"{side}_ms"], plain_ms=d[f"{side}_plain_ms"],
        bound_ms=d[f"{side}_bound_ms"], bound_by=d[f"{side}_bound_by"],
        fp32_core_bound_ms=d[f"{side}_fp32_core_bound_ms"], library_ms=None,
        library_note="no single PyTorch call computes this function",
        per_call={str(n): {k: v for k, v in dd.items() if k.startswith(side)}
                  for n, dd in per_n.items()}, **extra)


def _wgrad_line(per_n):
    """K2's weight-gradient pass, a part of K2's entry: its time beside
    torch.matmul of the same products (library_ms: fp32, TF32)."""
    return {str(n): {k: v for k, v in d.items() if k.startswith("wgrad")}
            for n, d in per_n.items()}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        sys.exit(2)
    from benerf_tpu_torch.core.config import load_config
    from benerf_tpu_torch.data import datasets
    from benerf_tpu_torch.ops import fused_mlp

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. environment + build
    smi = nvidia_smi_line()
    print(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} | {smi}")
    build_s = fused_mlp.build()
    print(f"    kernel build {build_s:.1f} s")
    for name, log in fused_mlp.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {name}: {line.strip()}")

    # 2. K1/K2 vs plain, at the path's shapes, both modes
    print("[2] K1/K2 vs plain PyTorch (fp32 mode: TF32X3 vs fp32, TF32 off)")
    k1_err = {RAYS * S: check_fwd(torch, "K1/K2", RAYS, S, 3, False)
              for S in (64, 128)}
    # 5 x 64 fills whole 64-point tiles; 3 x 37 = 111 leaves a ragged tile
    for R, S in ((5, 64), (3, 37)):
        for C in (1, 3, 7):
            for barf in (False, True):
                check_fwd(torch, "K1/K2", R, S, C, barf)
    k2_err, k2_outside = {}, {}
    for S, seed in ((64, 0), (128, 2)):
        err, rel, k2_outside[RAYS * S], g32 = check_bwd(
            torch, "K1/K2", RAYS, S, 3, False, seed=seed)
        k2_err[RAYS * S] = (err, rel)
    for R, S in ((5, 64), (3, 37)):
        for C in (1, 3, 7):
            check_bwd(torch, "K1/K2", R, S, C, True)
    check_bwd(torch, "K1/K2", 3, 37, 3, False)
    # split-count independence on the fine shape: splits 32 (default) vs 7
    check_splits(torch, "K1/K2", g32, 1e-4)
    print("    bf16 mode vs nerf.apply with bf16 operands and vs float64")
    bf = {RAYS * S: check_bf16(torch, RAYS, S, 3, False) for S in (64, 128)}
    for R, S in ((5, 64), (3, 37)):
        for C in (1, 3, 7):
            check_bf16(torch, R, S, C, True)
    k12 = {cd: _per_n_fused(torch, cd) for cd in ("float32", "bfloat16")}

    # 3. the tanabata slice, fp32 mode
    print(f"[3] tanabata, full width, {ITERS} iterations, fp32 mode")
    scene = datasets.random_scene(load_config(str(TANABATA)), N_EVENTS, seed=0,
                                  device="cuda")
    ms_iter, rays_s, launches, _ = run_slice(torch, scene)
    print(f"  steady state: {ms_iter:.2f} ms/iter, {rays_s:,.0f} rays/s "
          f"({RAYS} rays/iter) on {smi}")

    # 4. the tanabata slice, bf16 mode
    print(f"[4] tanabata, full width, {BF16_ITERS} iterations, "
          "compute_dtype = bfloat16")
    bf_ms, bf_rays_s, bf_launches, _ = run_slice(torch, scene, BF16_ITERS,
                                                 "bfloat16")
    print(f"  last {LOG_EVERY} iterations: {bf_ms:.2f} ms/iter, "
          f"{bf_rays_s:,.0f} rays/s on {smi}")

    # 5. K3/K4 vs plain, view encoding L = 6
    print("[5] K3/K4 vs plain PyTorch (fp32, TF32 off, view encoding L = 6)")
    k3_err = {RAYS * S: check_fwd(torch, "K3/K4", RAYS, S, 3, False)
              for S in (64, 128)}
    for R, S in ((5, 64), (3, 37)):
        for C in (1, 3, 8):
            check_fwd(torch, "K3/K4", R, S, C, False)
    k4_err, k4_outside = {}, {}
    for S, seed in ((64, 0), (128, 2)):
        err, rel, k4_outside[RAYS * S], g32 = check_bwd(
            torch, "K3/K4", RAYS, S, 3, False, seed=seed)
        k4_err[RAYS * S] = (err, rel)
    for R, S in ((5, 64), (3, 37)):
        for C in (1, 3, 8):
            check_bwd(torch, "K3/K4", R, S, C, False)
    check_splits(torch, "K3/K4", g32, 1e-5)
    k34 = _per_n_staged(torch)

    # 6. the L = 6 slice
    print(f"[6] tanabata, multires_views = 6, full width, {L6_ITERS} iterations")
    l6_ms, l6_rays_s, l6_launches, _ = run_l6_slice(torch, scene)
    print(f"  steady state: {l6_ms:.2f} ms/iter, {l6_rays_s:,.0f} rays/s "
          f"({RAYS} rays/iter, last {L6_ITERS - L6_WARMUP} iterations) on {smi}")

    # 7. routes on the card
    print("[7] MLP routes on the card")
    check_routes(torch)

    # 8. results
    fwd_tol = f"{FWD_TOL} x max(|plain|, 1)"
    bwd_tol = (f"{GRAD_TOL} x max(|plain grad|, 1) per gradient; per-point "
               f"grads: at most {KINK_FRAC} of elements past it (ReLU kinks)")
    bf_fwd_tol = f"{BF16_FWD_TOL} x max(|plain with bf16 operands|, 1)"
    bf_bwd_tol = (f"distance to float64 (weight grads: worst err/scale; "
                  f"per-point: RMS) between {BF16_GRAD_FLOOR} and "
                  f"{BF16_GRAD_FACTOR} x the plain version's with bf16 "
                  "operands; max_abs_err vs float64")
    k1_err = {n: (e, e / s) for n, (e, s) in k1_err.items()}
    k3_err = {n: (e, e / s) for n, (e, s) in k3_err.items()}
    k1_bf = {n: (d["fwd_err"], d["fwd_rel"]) for n, d in bf.items()}
    k2_bf = {n: (d["wgrad_abs_vs_f64"], d["wgrad_vs_f64"]) for n, d in bf.items()}
    scratch = {"scratch_floor_ms": k12["float32"][RAYS * 128]["bwd_scratch_floor_ms"]}
    fwd_src, bwd_src = ("benerf_tpu_torch/csrc/fused_mlp_fwd.cu",
                        "benerf_tpu_torch/csrc/fused_mlp_bwd.cu")
    k1_rep = "benerf_tpu/ops/pallas_mlp_t.py:244 _fwd_kernel_t"
    k2_rep = "benerf_tpu/ops/pallas_mlp_t.py:257 _bwd_kernel_t"
    kernels = [
        _kernel_line("K1 fused_mlp_fwd", fwd_src, k1_rep, "tf32x3",
                     launches["fused_mlp_fwd"], k1_err, fwd_tol, k12["float32"],
                     "fwd"),
        _kernel_line("K1 fused_mlp_fwd", fwd_src, k1_rep, "bf16",
                     bf_launches["fused_mlp_fwd_bf16"], k1_bf, bf_fwd_tol,
                     k12["bfloat16"], "fwd"),
        _kernel_line("K2 fused_mlp_bwd", bwd_src, k2_rep, "tf32x3",
                     launches["fused_mlp_bwd"], k2_err, bwd_tol, k12["float32"],
                     "bwd",
                     pointwise_outside_tol={str(n): v for n, v in k2_outside.items()},
                     weight_gradient_pass=_wgrad_line(k12["float32"]), **scratch),
        _kernel_line("K2 fused_mlp_bwd", bwd_src, k2_rep, "bf16",
                     bf_launches["fused_mlp_bwd_bf16"], k2_bf, bf_bwd_tol,
                     k12["bfloat16"], "bwd", bf16_vs_float64={str(n): d for n, d in bf.items()},
                     weight_gradient_pass=_wgrad_line(k12["bfloat16"]), **scratch),
        _kernel_line("K3 staged_mlp_fwd", "benerf_tpu_torch/csrc/staged_mlp_fwd.cu",
                     "benerf_tpu/ops/pallas_mlp.py:155 _fwd_kernel", "fp32",
                     l6_launches["staged_mlp_fwd"], k3_err, fwd_tol, k34, "fwd"),
        _kernel_line("K4 staged_mlp_bwd", "benerf_tpu_torch/csrc/staged_mlp_bwd.cu",
                     "benerf_tpu/ops/pallas_mlp.py:174 _bwd_kernel",
                     "fp32 tile pass, tf32x3 weight gradients",
                     l6_launches["staged_mlp_bwd"], k4_err, bwd_tol, k34, "bwd",
                     pointwise_outside_tol={str(n): v for n, v in k4_outside.items()}),
    ]
    print(json.dumps({"kernels": kernels, "slices": {
        "tanabata": {"ms_per_iter": ms_iter, "rays_per_sec": rays_s,
                     "iters": ITERS, "launches": launches},
        "tanabata_bf16": {"ms_per_iter": bf_ms, "rays_per_sec": bf_rays_s,
                          "iters": BF16_ITERS, "launches": bf_launches},
        "tanabata_multires_views_6": {
            "ms_per_iter": l6_ms, "rays_per_sec": l6_rays_s,
            "iters": L6_ITERS, "launches": l6_launches}}}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

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
     C in {1, 3}; K2 also rerun with another split count; CUDA-event times
     of kernel, plain version and bound;
  3. the tanabata slice: the config at full width (400x600, 1024 event +
     1024 rgb rays over 19 poses, 64+64 samples, 8x256 MLPs) trained for
     ITERS iterations on a scene made in memory from a seed, with the launch
     counters showing every MLP call went through K1/K2 and none through
     K3/K4 or the plain route;
  4. K3/K4 against their plain version (a view encoding of L = 6, 39 rows)
     at both training n and at ragged n, C in {1, 3, 8}; K4 at two split
     counts; times beside the bound;
  5. the L = 6 slice: tanabata with multires_views = 6 and caller-built
     MLPs, L6_ITERS train steps through make_train_step on the same scene,
     every MLP call through K3/K4;
  6. the card routes: a width-128 MLP and one without viewdirs take the
     plain route (as in the JAX package); bf16 raises on both kernel routes;
  7. the results: a {"kernels": [...]} line, the nvidia-smi line, and last
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
LOG_EVERY = 5
L6_ITERS = 24                # of which the first L6_WARMUP are not timed
L6_WARMUP = 4
N_EVENTS = 1_000_000
RAYS = 3055                  # 2 x 1024 event rays + 19 x 53 rgb rays
FWD_TOL = 2e-4               # x max(output scale, 1)
GRAD_TOL = 5e-4              # x max(leaf scale, 1)
KINK_FRAC = 1e-3             # per-point gradient elements allowed past tol
FP32_PEAK = 67e12            # H100 SXM fp32 outside the tensor cores
HBM_BYTES_S = 3.35e12        # H100 SXM HBM3


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
    """K1 or K3 vs nerf.apply on the card -> (max abs err, scale)."""
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


def time_kernels(torch, S, C=3):
    """(K1 ms, plain fwd ms, K2 ms, plain fwd+bwd ms) at n = RAYS * S."""
    from benerf_tpu_torch.models import bridge, nerf
    from benerf_tpu_torch.ops import fused_mlp

    params, pts, vd, _, _ = _inputs(torch, RAYS, S, C, 1, False)
    n = RAYS * S
    packed = fused_mlp.pack_params(params).contiguous()
    band = fused_mlp.band_weights(None, None, "cuda")
    x = pts.reshape(n, 3).contiguous()
    g = torch.randn((n, C + 1), device="cuda")
    # the plain version's backward also yields d pts and d viewdirs, as K2
    wrt = [t.requires_grad_(True) for t in bridge.tree_leaves(params)]
    wrt += [pts.requires_grad_(True), vd.requires_grad_(True)]

    def plain_fwd():
        with torch.no_grad():
            nerf.apply(params, pts, vd)

    def plain_fwd_bwd():
        out = nerf.apply(params, pts, vd).reshape(n, C + 1)
        torch.autograd.grad(out, wrt, g)

    k1 = time_ms(torch, lambda: fused_mlp.launch_fwd(packed, x, vd, band, S, C))
    k2 = time_ms(torch, lambda: fused_mlp.launch_bwd(packed, x, vd, band, g, S, C))
    p1 = time_ms(torch, plain_fwd)
    p2 = time_ms(torch, plain_fwd_bwd)
    return k1, p1, k2, p2


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


def run_slice(torch, scene):
    """tanabata at full width for ITERS iterations through the train loop
    -> (ms/iter, rays/s, launch counts, wall s)."""
    from benerf_tpu_torch.core.config import load_config
    from benerf_tpu_torch.train import loop

    cfg = load_config(str(TANABATA))
    rays_per_iter = (2 * cfg.sampling_event_rays + cfg.num_interpolated_pose
                     * (cfg.sampling_rgb_rays // cfg.num_interpolated_pose))
    assert rays_per_iter == RAYS, rays_per_iter

    with tempfile.TemporaryDirectory() as logdir:
        cfg = dataclasses.replace(
            cfg, render_image_iter=0, save_model_iter=0, render_video_iter=0,
            max_iter=ITERS, console_log_iter=LOG_EVERY, logdir=logdir)
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
    if len(losses) != ITERS or not all(np.isfinite(losses)):
        raise AssertionError(f"losses not all finite: {losses}")
    expect_counts(launches, ITERS, ("fused_mlp_fwd", "fused_mlp_bwd"))
    steady = rates[-1]  # the last LOG_EVERY iterations
    print(f"  {ITERS} iterations in {wall:.2f} s; losses {losses[0]:.5f} -> "
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
    kernel (counted, no kernel launched), and bf16 raising on both kernel
    routes."""
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
    for params, kw in ((standard, {}), (l6, {"num_freqs_views": 6})):
        route = mlp.route(params, vd, 10, kw.get("num_freqs_views", 4), False)
        if not _raises(NotImplementedError, lambda: mlp.mlp_forward(
                params, pts, vd, compute_dtype="bfloat16", **kw)):
            raise AssertionError(f"bf16 on the {route} route did not raise")
        print(f"  {route} route: bf16 raises NotImplementedError")
    print(f"  width 128 and no viewdirs: plain route, counts {got}")


def _per_n(torch, timer, flops_pt, weights, C=3, vb=False):
    """Times and bounds of a kernel pair at both training n: forward bytes
    are pts, the view input (viewdirs, or the per-ray bias for K3), the
    outputs and the weights; backward adds the cotangent, d pts, the view
    input's gradient and the weight gradients."""
    out = {}
    for S in (64, 128):
        n = RAYS * S
        kf, pf, kb, pb = timer(torch, S)
        view = RAYS * (128 if vb else 3)
        bytes_f = (n * (3 + C + 1) + view + weights) * 4
        bytes_b = bytes_f + (n * (C + 1 + 3) + view + weights) * 4
        flops = flops_pt * n
        out[n] = dict(
            fwd_ms=kf, fwd_plain_ms=pf, bwd_ms=kb, bwd_plain_ms=pb,
            fwd_bound_ms=max(flops / FP32_PEAK, bytes_f / HBM_BYTES_S) * 1e3,
            bwd_bound_ms=max(3 * flops / FP32_PEAK, bytes_b / HBM_BYTES_S) * 1e3)
        print(f"  n={n}: fwd {kf:.3f} ms (plain {pf:.3f}, bound "
              f"{out[n]['fwd_bound_ms']:.3f}), bwd {kb:.3f} ms (plain fwd+bwd "
              f"{pb:.3f}, bound {out[n]['bwd_bound_ms']:.3f})")
    return out


def _kernel_line(name, source, replaces, launches, errs, tol, per_n, side,
                 **extra):
    fine = RAYS * 128
    return dict(
        name=name, route="cuda", source=source, replaces=replaces,
        launches=launches, max_abs_err=max(e for e, _ in errs.values()),
        max_err_over_scale=max(r for _, r in errs.values()), tolerance=tol,
        ms=per_n[fine][f"{side}_ms"], plain_ms=per_n[fine][f"{side}_plain_ms"],
        bound_ms=per_n[fine][f"{side}_bound_ms"], bound_by="operations",
        library_ms=None,
        library_note="no single PyTorch call computes this function",
        fp32_peak_flops=FP32_PEAK,
        per_call={str(n): {k: v for k, v in d.items() if k.startswith(side)}
                  for n, d in per_n.items()}, **extra)


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

    # 2. K1/K2 vs plain, at the path's shapes
    print("[2] K1/K2 vs plain PyTorch (fp32, TF32 off)")
    k1_err = {RAYS * S: check_fwd(torch, "K1/K2", RAYS, S, 3, False)
              for S in (64, 128)}
    # 5 x 64 fills whole 64-point tiles; 3 x 37 = 111 leaves a ragged tile
    for R, S in ((5, 64), (3, 37)):
        for C in (1, 3):
            for barf in (False, True):
                check_fwd(torch, "K1/K2", R, S, C, barf)
    k2_err, k2_outside = {}, {}
    for S, seed in ((64, 0), (128, 2)):
        err, rel, k2_outside[RAYS * S], g32 = check_bwd(
            torch, "K1/K2", RAYS, S, 3, False, seed=seed)
        k2_err[RAYS * S] = (err, rel)
    for R, S in ((5, 64), (3, 37)):
        for C in (1, 3):
            check_bwd(torch, "K1/K2", R, S, C, True)
    check_bwd(torch, "K1/K2", 3, 37, 3, False)
    # split-count independence on the fine shape: splits 32 (default) vs 7
    check_splits(torch, "K1/K2", g32, 1e-4)
    k12 = _per_n(torch, time_kernels, flops_fwd_per_point(), 595_844)

    # 3. the tanabata slice
    print(f"[3] tanabata, full width, {ITERS} iterations")
    scene = datasets.random_scene(load_config(str(TANABATA)), N_EVENTS, seed=0,
                                  device="cuda")
    ms_iter, rays_s, launches, _ = run_slice(torch, scene)
    print(f"  steady state: {ms_iter:.2f} ms/iter, {rays_s:,.0f} rays/s "
          f"({RAYS} rays/iter) on {smi}")

    # 4. K3/K4 vs plain, view encoding L = 6
    print("[4] K3/K4 vs plain PyTorch (fp32, TF32 off, view encoding L = 6)")
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
    staged_weights = fused_mlp._offsets(fused_mlp._layout(3, view_pe=False))[-1]
    k34 = _per_n(torch, time_staged_kernels, flops_fwd_per_point(views_ch=0),
                 staged_weights, vb=True)

    # 5. the L = 6 slice
    print(f"[5] tanabata, multires_views = 6, full width, {L6_ITERS} iterations")
    l6_ms, l6_rays_s, l6_launches, _ = run_l6_slice(torch, scene)
    print(f"  steady state: {l6_ms:.2f} ms/iter, {l6_rays_s:,.0f} rays/s "
          f"({RAYS} rays/iter, last {L6_ITERS - L6_WARMUP} iterations) on {smi}")

    # 6. routes on the card
    print("[6] MLP routes on the card")
    check_routes(torch)

    # 7. results
    fwd_tol = f"{FWD_TOL} x max(|plain|, 1)"
    bwd_tol = (f"{GRAD_TOL} x max(|plain grad|, 1) per gradient; per-point "
               f"grads: at most {KINK_FRAC} of elements past it (ReLU kinks)")
    k1_err = {n: (e, e / s) for n, (e, s) in k1_err.items()}
    k3_err = {n: (e, e / s) for n, (e, s) in k3_err.items()}
    kernels = [
        _kernel_line("K1 fused_mlp_fwd", "benerf_tpu_torch/csrc/fused_mlp_fwd.cu",
                     "benerf_tpu/ops/pallas_mlp_t.py:244 _fwd_kernel_t",
                     launches["fused_mlp_fwd"], k1_err, fwd_tol, k12, "fwd"),
        _kernel_line("K2 fused_mlp_bwd", "benerf_tpu_torch/csrc/fused_mlp_bwd.cu",
                     "benerf_tpu/ops/pallas_mlp_t.py:257 _bwd_kernel_t",
                     launches["fused_mlp_bwd"], k2_err, bwd_tol, k12, "bwd",
                     pointwise_outside_tol={str(n): v for n, v in k2_outside.items()}),
        _kernel_line("K3 staged_mlp_fwd", "benerf_tpu_torch/csrc/staged_mlp_fwd.cu",
                     "benerf_tpu/ops/pallas_mlp.py:155 _fwd_kernel",
                     l6_launches["staged_mlp_fwd"], k3_err, fwd_tol, k34, "fwd"),
        _kernel_line("K4 staged_mlp_bwd", "benerf_tpu_torch/csrc/staged_mlp_bwd.cu",
                     "benerf_tpu/ops/pallas_mlp.py:174 _bwd_kernel",
                     l6_launches["staged_mlp_bwd"], k4_err, bwd_tol, k34, "bwd",
                     pointwise_outside_tol={str(n): v for n, v in k4_outside.items()}),
    ]
    print(json.dumps({"kernels": kernels, "slices": {
        "tanabata": {"ms_per_iter": ms_iter, "rays_per_sec": rays_s,
                     "iters": ITERS, "launches": launches},
        "tanabata_multires_views_6": {
            "ms_per_iter": l6_ms, "rays_per_sec": l6_rays_s,
            "iters": L6_ITERS, "launches": l6_launches}}}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

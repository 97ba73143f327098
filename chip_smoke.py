#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (benerf_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, in order; any failure raises and exits non-zero:
  1. environment: torch / CUDA versions, the card's name and power limit,
     and the build of every kernel from benerf_tpu_torch/csrc with nvcc;
  2. each kernel against its plain PyTorch version on the card, at the
     shapes of the training path (coarse n = 3,055 x 64 = 195,520 points,
     fine n = 3,055 x 128 = 391,040) and at a ragged n with BARF on and off,
     C in {1, 3}; K2 also rerun with another split count; CUDA-event times
     of kernel, plain version and bound;
  3. the slice: the tanabata config at full width (400x600, 1024 event +
     1024 rgb rays over 19 poses, 64+64 samples, 8x256 MLPs) trained for
     ITERS iterations on a scene made in memory from a seed, with the launch
     counters showing every MLP call went through K1/K2;
  4. the results: a {"kernels": [...]} line, the nvidia-smi line, and last
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
N_EVENTS = 1_000_000
RAYS = 3055                  # 2 x 1024 event rays + 19 x 53 rgb rays
FWD_TOL = 2e-4               # x max(output scale, 1)
GRAD_TOL = 5e-4              # x max(leaf scale, 1)
KINK_FRAC = 1e-3             # per-point gradient elements allowed past tol
FP32_PEAK = 67e12            # H100 SXM fp32 outside the tensor cores
HBM_BYTES_S = 3.35e12        # H100 SXM HBM3


def flops_fwd_per_point(depth=8, width=256, input_ch=63, views_ch=27,
                        channels=3):
    """Matrix-product FLOP of one MLP point evaluation (2 per multiply-add)."""
    f = input_ch * width + (depth - 2) * width * width
    f += (width + input_ch) * width + width * width + width
    f += (width + views_ch) * (width // 2) + (width // 2) * channels
    return 2 * f


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def _inputs(torch, R, S, C, seed, barf):
    from benerf_tpu_torch.models import bridge, embedder, nerf

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    params = nerf.init_params(g, channels=C, device="cuda")
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


def check_k1(torch, R, S, C, barf, seed=0):
    """K1 vs nerf.apply on the card -> (max abs err, scale)."""
    from benerf_tpu_torch.models import nerf
    from benerf_tpu_torch.ops import fused_mlp

    params, pts, vd, bw, bwv = _inputs(torch, R, S, C, seed, barf)
    with torch.no_grad():
        out_k = fused_mlp.fused_nerf_mlp(params, pts, vd, barf_weights=bw,
                                         barf_weights_views=bwv)
        out_p = nerf.apply(params, pts, vd, barf_weights=bw,
                           barf_weights_views=bwv)
    torch.cuda.synchronize()
    err, scale = _max_err(out_k, out_p)
    print(f"  K1 R={R} S={S} C={C} barf={barf}: max abs err {err:.3e} "
          f"(tol {FWD_TOL * scale:.3e})")
    if not err <= FWD_TOL * scale:
        raise AssertionError(f"K1 disagrees with the plain version: {err}")
    return err, scale


def _grads(torch, fn, params, pts, vd, bw, bwv, **kw):
    from benerf_tpu_torch.models import bridge

    leaves = [t.detach().requires_grad_(True) for t in bridge.tree_leaves(params)]
    p = bridge.tree_unflatten(params, leaves)
    x = pts.detach().requires_grad_(True)
    v = vd.detach().requires_grad_(True)
    loss = torch.sum(torch.sin(fn(p, x, v, barf_weights=bw,
                                  barf_weights_views=bwv, **kw)))
    return torch.autograd.grad(loss, leaves + [x, v])


def check_k2(torch, R, S, C, barf, seed=0, splits=None):
    """K2 vs autograd through nerf.apply: gradients of sum(sin(out)) w.r.t.
    every weight, pts and viewdirs.

    Every element of every weight gradient must be within GRAD_TOL x
    max(scale, 1). Per-point gradients (d pts, and d viewdir, a sum over the
    ray's samples) are held to the same bound, except that at most a
    fraction KINK_FRAC of their elements may fall outside it: where a ReLU
    input lies within rounding of 0, the two fp32 forwards may take opposite
    sides of the kink and that point's gradient then differs by design.
    Returns (worst weight err, worst weight err / scale, per-point elements
    outside the bound, gradients)."""
    from benerf_tpu_torch.models import nerf
    from benerf_tpu_torch.ops import fused_mlp

    params, pts, vd, bw, bwv = _inputs(torch, R, S, C, seed, barf)
    kw = {} if splits is None else {"splits": splits}
    gk = _grads(torch, fused_mlp.fused_nerf_mlp, params, pts, vd, bw, bwv, **kw)
    gp = _grads(torch, nerf.apply, params, pts, vd, bw, bwv)
    torch.cuda.synchronize()
    n_w = len(gp) - 2
    worst_err, worst_rel = 0.0, 0.0
    for a, b in zip(gk[:n_w], gp[:n_w]):
        err, scale = _max_err(a, b)
        worst_err, worst_rel = max(worst_err, err), max(worst_rel, err / scale)
        if not err <= GRAD_TOL * scale:
            raise AssertionError(
                f"K2 weight gradient of shape {tuple(b.shape)} disagrees: "
                f"{err} (scale {scale})")
    outside = []
    for a, b in zip(gk[n_w:], gp[n_w:]):
        scale = max(float(b.abs().max()), 1.0)
        n_out = int(((a - b).abs() > GRAD_TOL * scale).sum())
        outside.append(n_out)
        if n_out > KINK_FRAC * b.numel():
            raise AssertionError(
                f"K2 per-point gradient of shape {tuple(b.shape)}: {n_out} of "
                f"{b.numel()} elements outside {GRAD_TOL} x {scale}")
    print(f"  K2 R={R} S={S} C={C} barf={barf}: weight grads max abs err "
          f"{worst_err:.3e}, worst err/scale {worst_rel:.3e} (tol "
          f"{GRAD_TOL:.1e}); d pts / d viewdirs elements outside tol: "
          f"{outside[0]} of {gp[-2].numel()} / {outside[1]} of {gp[-1].numel()}")
    return worst_err, worst_rel, sum(outside), gk


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


def run_slice(torch):
    """tanabata at full width for ITERS iterations -> (ms/iter, rays/s)."""
    from benerf_tpu_torch.core.config import load_config
    from benerf_tpu_torch.data import datasets
    from benerf_tpu_torch.ops import fused_mlp
    from benerf_tpu_torch.train import loop

    cfg = load_config(str(TANABATA))
    scene = datasets.random_scene(cfg, N_EVENTS, seed=0, device="cuda")
    rays_per_iter = (2 * cfg.sampling_event_rays + cfg.num_interpolated_pose
                     * (cfg.sampling_rgb_rays // cfg.num_interpolated_pose))
    assert rays_per_iter == RAYS, rays_per_iter

    with tempfile.TemporaryDirectory() as logdir:
        cfg = dataclasses.replace(
            cfg, render_image_iter=0, save_model_iter=0, render_video_iter=0,
            max_iter=ITERS, console_log_iter=LOG_EVERY, logdir=logdir)
        for k in fused_mlp.LAUNCHES:
            fused_mlp.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        loop.train(cfg, scene, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(fused_mlp.LAUNCHES)
        with open(f"{logdir}/0/metrics.jsonl") as f:
            recs = [json.loads(line) for line in f]
    losses = [r["train_loss"] for r in recs if "train_loss" in r]
    rates = [r["rays_per_sec"] for r in recs if "rays_per_sec" in r]
    if len(losses) != ITERS or not all(np.isfinite(losses)):
        raise AssertionError(f"losses not all finite: {losses}")
    for k, v in launches.items():
        if v != 2 * ITERS:
            raise AssertionError(f"{k}: {v} launches in {ITERS} iterations, "
                                 f"expected {2 * ITERS}")
    steady = rates[-1]  # the last LOG_EVERY iterations
    print(f"  {ITERS} iterations in {wall:.2f} s; losses {losses[0]:.5f} -> "
          f"{losses[-1]:.5f}; launches {launches}")
    return 1e3 * RAYS / steady, steady, launches, wall


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        sys.exit(2)
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

    # 2. kernels vs plain, at the path's shapes
    print("[2] kernels vs plain PyTorch (fp32, TF32 off)")
    k1_err, k1_rel = {}, {}
    for S in (64, 128):
        err, scale = check_k1(torch, RAYS, S, 3, False)
        k1_err[RAYS * S], k1_rel[RAYS * S] = err, err / scale
    # 5 x 64 fills whole 64-point tiles; 3 x 37 = 111 leaves a ragged tile
    for R, S in ((5, 64), (3, 37)):
        for C in (1, 3):
            for barf in (False, True):
                check_k1(torch, R, S, C, barf)
    k2_err, k2_rel, k2_outside = {}, {}, {}
    for S, seed in ((64, 0), (128, 2)):
        n = RAYS * S
        k2_err[n], k2_rel[n], k2_outside[n], g32 = check_k2(
            torch, RAYS, S, 3, False, seed=seed)
    for R, S in ((5, 64), (3, 37)):
        for C in (1, 3):
            check_k2(torch, R, S, C, True)
    check_k2(torch, 3, 37, 3, False)
    # split-count independence on the fine shape: splits 32 (default) vs 7
    g7 = check_k2(torch, RAYS, 128, 3, False, seed=2, splits=7)[3]
    worst = max(_max_err(a, b)[0] / _max_err(a, b)[1]
                for a, b in zip(g7[:-2], g32[:-2]))
    same_points = all(torch.equal(a, b) for a, b in zip(g7[-2:], g32[-2:]))
    print(f"  K2 splits 7 vs 32: weight grads worst diff/scale {worst:.3e}; "
          f"per-point grads bitwise equal: {same_points}")
    if not (worst <= 1e-4 and same_points):
        raise AssertionError(f"K2 depends on the split count: {worst}")

    per_n = {}
    for S in (64, 128):
        n = RAYS * S
        k1, p1, k2, p2 = time_kernels(torch, S)
        flops = flops_fwd_per_point() * n
        bytes1 = n * (3 + 4) * 4 + RAYS * 3 * 4 + 595_844 * 4
        bytes2 = bytes1 + n * (4 + 6) * 4 + 595_844 * 4
        per_n[n] = dict(
            k1_ms=k1, k1_plain_ms=p1, k2_ms=k2, k2_plain_ms=p2,
            k1_bound_ms=max(flops / FP32_PEAK, bytes1 / HBM_BYTES_S) * 1e3,
            k2_bound_ms=max(3 * flops / FP32_PEAK, bytes2 / HBM_BYTES_S) * 1e3)
        print(f"  n={n}: K1 {k1:.3f} ms (plain {p1:.3f}), K2 {k2:.3f} ms "
              f"(plain fwd+bwd {p2:.3f})")

    # 3. the slice
    print(f"[3] tanabata, full width, {ITERS} iterations")
    ms_iter, rays_s, launches, _ = run_slice(torch)
    print(f"  steady state: {ms_iter:.2f} ms/iter, {rays_s:,.0f} rays/s "
          f"({RAYS} rays/iter) on {smi}")

    # 4. results
    fine = RAYS * 128
    common = dict(route="cuda", bound_by="operations", library_ms=None,
                  library_note="no single PyTorch call computes this function",
                  fp32_peak_flops=FP32_PEAK)
    kernels = [
        dict(name="K1 fused_mlp_fwd", source="benerf_tpu_torch/csrc/fused_mlp_fwd.cu",
             replaces="benerf_tpu/ops/pallas_mlp_t.py:244 _fwd_kernel_t",
             launches=launches["fused_mlp_fwd"], max_abs_err=max(k1_err.values()),
             max_err_over_scale=max(k1_rel.values()),
             tolerance=f"{FWD_TOL} x max(|plain|, 1)",
             ms=per_n[fine]["k1_ms"], plain_ms=per_n[fine]["k1_plain_ms"],
             bound_ms=per_n[fine]["k1_bound_ms"],
             per_call={str(n): {k: v for k, v in d.items() if k.startswith("k1")}
                       for n, d in per_n.items()}, **common),
        dict(name="K2 fused_mlp_bwd", source="benerf_tpu_torch/csrc/fused_mlp_bwd.cu",
             replaces="benerf_tpu/ops/pallas_mlp_t.py:257 _bwd_kernel_t",
             launches=launches["fused_mlp_bwd"], max_abs_err=max(k2_err.values()),
             max_err_over_scale=max(k2_rel.values()),
             tolerance=f"{GRAD_TOL} x max(|plain grad|, 1) per gradient; "
                       f"per-point grads: at most {KINK_FRAC} of elements "
                       "past it (ReLU kinks)",
             pointwise_outside_tol={str(n): v for n, v in k2_outside.items()},
             ms=per_n[fine]["k2_ms"], plain_ms=per_n[fine]["k2_plain_ms"],
             bound_ms=per_n[fine]["k2_bound_ms"],
             per_call={str(n): {k: v for k, v in d.items() if k.startswith("k2")}
                       for n, d in per_n.items()}, **common),
    ]
    print(json.dumps({"kernels": kernels, "slice": {
        "ms_per_iter": ms_iter, "rays_per_sec": rays_s, "iters": ITERS}}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

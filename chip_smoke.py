#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (benerf_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, in order; any failure raises and exits non-zero (no phase catches
an exception):
  1. environment: torch / CUDA versions, the card's name and power limit,
     and the build of every kernel (K1-K4) from benerf_tpu_torch/csrc with
     nvcc, its -Xptxas -v register and spill lines printed; fails if a
     kernel spills;
  2. the weights' wgmma copies that every K1 / K3 launch writes first
     (csrc/wgmma_layer.cuh prep_kernel) bit for bit against their plain
     version, both tables and modes, timed; K1/K2 against their plain
     PyTorch version on the card, at the shapes
     of the training path (coarse n = 3,055 x 64 = 195,520 points, fine
     n = 3,055 x 128 = 391,040) and at a ragged n with BARF on and off,
     C in {1, 3, 7} (C + 1 = 8 fills every head row): in fp32 mode (TF32X3) against fp32 nerf.apply, in bf16
     mode against nerf.apply with bf16 operands and float64 (check_*_bf16);
     K1 as the train path launches it, keeping its forward for K2, at both
     training n, C = 3 and C = 1 (the gray configs' head), and in both
     modes: its output against nerf.apply, its X rows against the plain
     activations, its sign words against its activations (check_kept); K2
     (both modes) also at C = 1 with BARF off, at a ragged and both training
     n, and rerun with another split count; K2's weight-gradient pass
     alone (csrc/wgrad_wgmma.cuh) against the float64 product of the same
     scratch, both modes, splits 32 and 7, at both training n and 3 x 37;
     CUDA-event times of kernel, plain version, both bounds, of the
     tile pass alone (time_tile_pass) beside its bound, and of the
     weight-gradient pass beside torch.matmul of the same products;
  3. the tanabata slice: the config at full width (400x600, 1024 event +
     1024 rgb rays over 19 poses, 64+64 samples, 8x256 MLPs) trained for
     ITERS iterations on a scene made in memory from a seed through
     train(), in dispatches of LOG_EVERY steps (one CUDA graph of the step,
     captured once and replayed), with the launch counters showing every
     MLP call went through K1/K2 in fp32 mode and none through K3/K4 or the
     plain route, replays included;
  4. the same slice with compute_dtype = "bfloat16" for BF16_ITERS
     iterations, every MLP call through K1/K2 in bf16 mode;
  5. K3/K4 against their plain version (a view encoding of L = 6, 39 rows)
     at both training n and at ragged n, C in {1, 3, 8, 127} (C + 1 = 128
     fills the head space), as phase 2 holds K1/K2: fp32 mode (TF32X3)
     against fp32 nerf.apply, bf16 mode against nerf.apply with bf16
     operands and float64; K4 at two split counts; K4's weight-gradient
     pass (K4's job table) against float64 as in phase 2; times of both
     modes beside their bounds, the tile pass alone too;
  6. the L = 6 slice: tanabata with multires_views = 6 and caller-built
     MLPs, L6_WARMUP single steps (make_train_step) on the same scene, then
     dispatches of L6_G steps (make_multi_step, one captured graph), every
     MLP call through K3/K4 in fp32 mode, replays included;
  7. the same L = 6 slice with compute_dtype = "bfloat16" for BF16_ITERS
     steps, every MLP call through K3/K4 in bf16 mode;
  8. the card routes: a width-128 MLP and one without viewdirs take the
     plain route (as in the JAX package); bf16 runs K1 on the fused route
     and K3 on the staged one, each in its bf16 mode;
  9. configs/demo.txt as a user runs it: the 80x80 scene written by the
     port's writer (seconds printed), `benerf_tpu_torch.cli.train.main` on
     the card for DEMO_ITERS iterations with periodic eval and checkpoints
     at DEMO_ITERS / 2 and DEMO_ITERS and the video at DEMO_ITERS (so
     dispatches of 50 steps, one graph captured, DEMO_ITERS - 1 replays),
     then resumed from the last checkpoint for DEMO_RESUME more (single
     steps: fewer than a dispatch remain); the launch
     counters show K1/K2 in fp32 mode on every train MLP call, K1 alone on
     every eval chunk, no K3/K4 and no plain route; the run directory holds
     args.txt, config.txt, finite eval metrics (PSNR, SSIM, ATE, pose
     flow), the KITTI poses, the eval PNGs, the video and both
     checkpoints, and the checkpoint equals the state it saved; one
     periodic eval timed alone; K1 held against nerf.apply at the eval
     chunks' shapes (a full chunk of EVAL_RAYS rays and the frame's last
     2,304, x 64 and x 128 points), and timed at the full chunk's;
  10. the captured dispatch against the uncaptured steps: from one state
     and one seed, CMP_DISPATCHES dispatches of CMP_G steps through
     make_multi_step against as many make_train_step calls, on tanabata
     fp32 (K1/K2) and on the L = 6 slice (K3/K4): every loss and metric and
     every parameter and Adam tensor held bit for bit; then one more
     dispatch of each timed (ms/iter, one host read per dispatch against
     one per step) and the card's peak memory of each;
  11. inference and evaluation on phase 9's run directory:
     `benerf_tpu_torch.cli.test.main` from the checkpoint at DEMO_ITERS
     (KITTI poses, the images and the 90-frame video; K1 alone, 2 launches
     a chunk of every frame, no K2/K3/K4, no plain route), then
     `cli.evaluate.evaluate` of the evals at DEMO_ITERS / 2 against those at
     DEMO_ITERS, equal to eval/metrics over the same decoded PNGs; each timed;
  12. the quality gates: `eval.quality.run_quality` on the card at the two
     configurations of the JAX package's slow recovery tests (32x32; a 35%
     perturbed ground-truth init for 220 iterations, the motion-scale init
     for 400), held to those tests' bounds, K1/K2 counted (2 launches per
     iteration and kernel plus the evals' K1, one graph captured per run),
     BRISQUE features of the final mid frame; timed; then K1 and K2 held
     against the plain version at the shapes this phase gave them (a step's
     351 rays and an eval frame's 1,024, x 16 coarse and x 32 fine points);
  13. the mesh on one card (NCCL takes one rank per card): (a) tanabata fp32
     under a one-rank NCCL RayMesh built here, CMP_DISPATCHES dispatches of
     CMP_G steps with the all-reduce captured in the graph, against phase
     10's unmeshed captured dispatch from the same state and seed, bit for
     bit, collectives per step and K1/K2 counted, both timed; (b) two
     processes (this script with --mesh-rank, importing torch and the port
     only) as a two-rank gloo mesh on the card, MESH_STEPS steps of
     tanabata and of configs/e2nerf_real/lego.txt (the real-data event
     loss's global norms) at full width, fp32 mode, against the same steps
     in this process: the ranks' parameters bit-equal, K1/K2 twice a step
     on each rank; step 1's loss and metrics at rtol 1e-5, its gradients
     at GRAD_TOL and the parameters after it at MESH_PARAM_TOL; the later
     steps at the drift limits MESH_DRIFT_REL / MESH_DRIFT_PARAM, which a
     witness (the same steps in this process with every sum over rays in
     another order) must stay within and each planted fault of MESH_FAULTS
     (run by the same two ranks) must exceed;
  14. the bench entry point and its step breakdown: `cli.bench.main` in
     both modes (BENCH_INNER steps a dispatch, BENCH_CHUNKS dispatches
     timed; the fp32 run with --profile into a temporary directory), each
     JSON line printed and checked (its model FLOP equal to bench.py's
     count, the card line), K1/K2 at 2 launches a step in each mode, replays
     included, no K3/K4 and no plain route, one graph captured per mode,
     the loss finite; top_ops.md names the fmlp:: kernels; then
     tools/torch_perf_breakdown.py at BREAKDOWN_REPS reps in fp32 mode, its
     table printed, its production rows at least BREAKDOWN_SHARE of the
     device busy of the fp32 bench's profiled step;
  15. the results: a {"kernels": [...]} line, the nvidia-smi line, and last
     {"ok": true, "device": {...}}.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

TANABATA = Path(__file__).resolve().parent / "configs/benerf_blender/tanabata.txt"
DEMO = Path(__file__).resolve().parent / "configs/demo.txt"
# phase 13(b): the synthetic event loss, then the real-data one (L2 norms
# over the global ray axis)
MESH_CONFIGS = {
    "tanabata": TANABATA,
    "e2nerf_real_lego": Path(__file__).resolve().parent
    / "configs/e2nerf_real/lego.txt"}
MESH_STEPS = 3               # phase 13(b): steps of each rank and of the card
MESH_PARAM_TOL = 1e-5        # x max(|p|, 1) after step 1, as test_sharding
# steps 2 and later: the largest relative metric difference, and the
# parameters after the last step x max(|p|, 1); between the witness's
# reading and the planted faults' (PERF.md, phase 13(b))
MESH_DRIFT_REL = 2e-2
MESH_DRIFT_PARAM = 1e-3
MESH_FAULTS = ("stale_draws", "rank0_rows")  # planted: see patched()
DEMO_ITERS = 300             # evals and checkpoints at DEMO_ITERS / 2 and DEMO_ITERS
DEMO_RESUME = 20             # iterations after resuming at DEMO_ITERS
EVAL_RAYS = 4096             # rays of one eval chunk (cfg.chunk)
DEMO_PIXELS = 80 * 80        # configs/demo.txt: rays of one eval frame
ITERS = 25
BF16_ITERS = 10
LOG_EVERY = 5
L6_ITERS = 16                # L6_WARMUP single steps, then dispatches of L6_G;
L6_WARMUP = 4                # the first dispatch (it captures) is not timed
L6_G = 4
CMP_G = 10                   # phase 10: steps per dispatch, dispatches held
CMP_DISPATCHES = 2           # bit for bit, then one more timed
BENCH_INNER = 25             # phase 14: steps a dispatch, dispatches timed
BENCH_CHUNKS = 2
BENCH_FLOPS = 2_088_416_378_880  # bench.py's model FLOP a bench iteration
BREAKDOWN_REPS = 5
BREAKDOWN_SHARE = 0.8        # production rows' device ms / the step's busy
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
# the weight-gradient pass alone against the float64 product of the same
# scratch (bf16 mode: of its bf16-rounded operands), per job, x max |ref|:
# its TF32X3 (or bf16-operand) products with fp32 sums promoted every 32
# points sit at ~1e-6 (tests/test_torch_wgrad.py); one TF32 product at ~3e-4
WGRAD_TOL = 1e-5
# (R, S) of the bf16 scratch checks (check_tile_sums): n = 1, 63, 65, 200
# (ragged tiles), and the training path's two calls
SCRATCH_SHAPES = [(1, 1), (7, 9), (5, 13), (8, 25), (3055, 64), (3055, 128)]


def flops_fwd_per_point(depth=8, width=256, input_ch=63, views_ch=27,
                        channels=3):
    """Matrix-product FLOP of one MLP point evaluation (2 per multiply-add);
    views_ch=0 for K3, whose view-encoding product runs outside."""
    f = input_ch * width + (depth - 2) * width * width
    f += (width + input_ch) * width + width * width + width
    f += (width + views_ch) * (width // 2) + (width // 2) * channels
    return 2 * f


def kernel_spills(build_log):
    """{(library, kernel): spill bytes} of every kernel that ptxas reports
    spilling (-Xptxas -v), from the build's output."""
    out = {}
    for name, log in build_log.items():
        entry = None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line
            elif "spill stores" in line:
                stores = int(line.split("bytes spill stores")[0].split(",")[-1])
                if stores:
                    out[(name, entry)] = stores
    return out


def check_weight_copies(torch):
    """The weights' wgmma copies (csrc/wgmma_layer.cuh prep_kernel, run
    inside every K1 and K3 launch) against their plain version,
    mlp_kernels.prepare_weights_plain, bit for bit: K1/K2's and K3/K4's
    tables, both modes, on the training path's weights -> {table/mode:
    {"bits_differing", "ms", "plain_ms"}}."""
    from benerf_tpu_torch.ops import mlp_kernels

    out = {}
    for view_pe in (True, False):
        params, _, _, _, _ = _inputs(torch, 1, 1, 3, 5, False,
                                     views_ch=27 if view_pe else 39)
        packed = mlp_kernels.pack_params(params, view_pe=view_pe).contiguous()
        for cd in ("float32", "bfloat16"):
            got = mlp_kernels.prepare_weights(packed, 3, view_pe, cd)
            want = mlp_kernels.prepare_weights_plain(packed, view_pe, cd)
            bits = torch.int16 if cd == "bfloat16" else torch.int32
            bad = int((got.view(bits) != want.view(bits)).sum())
            key = f"{'K1/K2' if view_pe else 'K3/K4'} {MODE_NAME[cd]}"
            out[key] = {
                "bits_differing": bad,
                "ms": time_ms(torch, lambda: mlp_kernels.prepare_weights(
                    packed, 3, view_pe, cd)),
                "plain_ms": time_ms(torch, lambda: mlp_kernels.prepare_weights_plain(
                    packed, view_pe, cd))}
            print(f"  weight copies {key}: {bad} of {got.numel()} values differ "
                  f"from the plain version; {out[key]['ms']:.4f} ms (plain "
                  f"{out[key]['plain_ms']:.4f})")
            if bad:
                raise AssertionError(f"weight copies {key} differ from the plain "
                                     f"version in {bad} values")
    return out


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
    """K1 or K3 (fp32 mode) vs nerf.apply on the card -> (max abs err,
    scale)."""
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


def plain_activations(torch, params, pts, vd, compute_dtype):
    """The forward's activations as K2's scratch holds them, float64
    [row][point] in the rows of mlp_kernels (X_PE: pe and a zero row, X_H +
    256 l: h_l, X_F: f, X_VPE: vpe and zero rows, then hv); bfloat16: every
    product on bf16-rounded operands, as the kernels' bf16 mode."""
    from benerf_tpu_torch.models import embedder

    S = pts.shape[1]
    x = pts.reshape(-1, 3).double()
    v = vd.double().repeat_interleave(S, dim=0)

    def mm(a, w):
        if compute_dtype == "bfloat16":
            a, w = (t.to(torch.bfloat16) for t in (a, w))
        return a.double() @ w.double()

    pe = embedder.positional_encoding(x, 10)
    vpe = embedder.positional_encoding(v, 4)
    h, hs = pe, []
    for layer in params["pts"]:
        if "w_pe" in layer:
            h = mm(pe, layer["w_pe"]) + mm(h, layer["w_h"]) + layer["b"].double()
        else:
            h = mm(h, layer["w"]) + layer["b"].double()
        h = torch.relu(h)
        hs.append(h)
    f = mm(h, params["feature"]["w"]) + params["feature"]["b"].double()
    hv = torch.relu(mm(f, params["views"]["w_feat"]) + mm(vpe, params["views"]["w_pe"])
                    + params["views"]["b"].double())
    pad = torch.nn.functional.pad
    return torch.cat([pad(pe, (0, 1)), *hs, f, pad(vpe, (0, 5)), hv], 1).t()


def kept_signs(torch, kept):
    """The kept ReLU sign words as activations > 0: (h_0..h_7 (8, n_pad,
    256), hv (n_pad, 128)) bool, decoded by the accumulator layout of
    csrc/wgmma_layer.cuh (thread t's accumulator i of an N-wide layer sits
    at point (t % 128) / 32 * 16 + (t % 32) / 4 + 8 ((i >> 1) & 1), feature
    (t / 128) N / 2 + 8 (i >> 2) + 2 (t % 4) + (i & 1); its bit i % 32 of
    word i / 32 of the layer's)."""
    from benerf_tpu_torch.ops import mlp_kernels

    tiles = kept.signs.shape[0]
    words = kept.signs.view(tiles, 2 * mlp_kernels.DEPTH + 1, 256).long() & 0xffffffff
    t = torch.arange(256, device=words.device)[:, None]

    def layer(first, N):
        tt, i = torch.broadcast_tensors(t, torch.arange(N // 4, device=words.device))
        point = (tt % 128) // 32 * 16 + (tt % 32) // 4 + 8 * ((i >> 1) & 1)
        feat = (tt // 128) * (N // 2) + 8 * (i >> 2) + 2 * (tt % 4) + (i & 1)
        bit = ((words[:, first + i // 32, tt] >> (i % 32)) & 1).bool()
        out = torch.zeros((tiles, mlp_kernels.TILE, N), dtype=torch.bool,
                          device=words.device)
        out[:, point, feat] = bit
        return out.reshape(tiles * mlp_kernels.TILE, N)

    return (torch.stack([layer(2 * l, 256) for l in range(mlp_kernels.DEPTH)]),
            layer(2 * mlp_kernels.DEPTH, 128))


def check_kept(torch, R, S, C, compute_dtype, seed=0):
    """K1 as the train path launches it, keeping its forward for K2. The
    recorded call (grad on, every input needing a gradient) moves the kept
    counter once and matches nerf.apply within FWD_TOL x scale (bfloat16:
    BF16_FWD_TOL of the plain version on bf16 operands); the keeping launch
    and the one that keeps nothing give its result bit for bit; the kept X
    rows are the plain forward's activations within the same tolerance x
    max(|activation|, 1) (bfloat16: the fp32 h7 rows round to the bf16
    ones); the sign words are the kept activations > 0, bit for bit, over
    every point of every tile; the keeping launch writes every X row, side
    row and sign word of all n_pad points (NaN and all-ones sentinels
    before it; a second keeping launch over zeroed sign words writes the
    same words and the same result). -> dict of the errors."""
    from benerf_tpu_torch.models import bridge, nerf
    from benerf_tpu_torch.ops import fused_mlp, mlp_kernels as mk

    bf = compute_dtype == "bfloat16"
    tol = BF16_FWD_TOL if bf else FWD_TOL
    plain_kw = {"compute_dtype": torch.bfloat16} if bf else {}
    key = "fused_mlp_fwd_kept" + ("_bf16" if bf else "")
    params, pts, vd, _, _ = _inputs(torch, R, S, C, seed, False)
    n = R * S
    leaves = [t.detach().requires_grad_(True) for t in bridge.tree_leaves(params)]
    before = mk.LAUNCHES[key]
    out_r = fused_mlp.fused_nerf_mlp(
        bridge.tree_unflatten(params, leaves), pts.requires_grad_(True),
        vd.requires_grad_(True), compute_dtype=compute_dtype)
    if mk.LAUNCHES[key] != before + 1:
        raise AssertionError(f"the recorded call moved {key} by "
                             f"{mk.LAUNCHES[key] - before}, not 1")
    out_r = out_r.detach().reshape(n, C + 1)
    pts, vd = pts.detach(), vd.detach()
    with torch.no_grad():
        out_p = nerf.apply(params, pts, vd, **plain_kw).reshape(n, C + 1)
        packed = mk.pack_params(params).contiguous()
        band = fused_mlp.band_weights(None, None, "cuda")
        x = pts.reshape(n, 3).contiguous()
        prep = mk.prep_buffer(True, compute_dtype, "cuda")
        kept = mk.kept_scratch(n, "cuda", compute_dtype)
        # sentinels: NaN rows, all-ones sign words; a second keeping launch
        # over zeroed sign words must write the same words
        for t in (kept.x, kept.side):
            if t is not None:
                t.fill_(float("nan"))
        kept.signs.fill_(-1)
        out_k = mk.launch_fwd(mk.FUSED, packed, x, vd, band, S, C, compute_dtype,
                              prep=prep, kept=kept)
        signs_k = kept.signs.clone()
        kept.signs.zero_()
        out_k2 = mk.launch_fwd(mk.FUSED, packed, x, vd, band, S, C, compute_dtype,
                               prep=prep, kept=kept)
        out_0 = mk.launch_fwd(mk.FUSED, packed, x, vd, band, S, C, compute_dtype,
                              prep=prep)
        want = plain_activations(torch, params, pts, vd, compute_dtype)
    torch.cuda.synchronize()
    left = {k: int(torch.isnan(t).sum()) for k, t in (("x", kept.x), ("side", kept.side))
            if t is not None}
    if any(left.values()) or not torch.equal(kept.signs, signs_k):
        raise AssertionError(f"K1 keeping ({compute_dtype}, {kept.n_pad // mk.TILE} "
                             f"tiles) left sentinels: NaN {left}, sign words "
                             f"{int((kept.signs != signs_k).sum())}")
    err, scale = _max_err(out_r, out_p)
    if not err <= tol * scale:
        raise AssertionError(f"K1 keeping its forward ({compute_dtype}) "
                             f"disagrees with the plain version: {err}")
    if not (torch.equal(out_k, out_r) and torch.equal(out_k2, out_r)
            and torch.equal(out_0, out_r)):
        raise AssertionError("K1's keeping launch, the one that keeps nothing "
                             "and the recorded call differ")
    X = kept.rows("x")
    rows = X.shape[0]
    wscale = max(float(want.abs().max()), 1.0)
    x_err = max(float((X[r:r + 256, :n].double() - want[r:min(r + 256, rows)])
                      .abs().max()) for r in range(0, rows, 256))
    h7 = mk.X_H + (mk.DEPTH - 1) * mk.WIDTH
    if bf:
        side = kept.side.view(-1, kept.n_pad)
        if not torch.equal(side[:mk.SIDE_HV].to(torch.bfloat16), X[h7:mk.X_F]):
            raise AssertionError("K1's fp32 h7 rows do not round to its bf16 ones")
        hv = side[mk.SIDE_HV:mk.SIDE_KEPT]
        x_err = max(x_err, float((hv[:, :n].double() - want[rows:]).abs().max()))
    else:
        hv = X[mk.X_VPE + 32:]
    del want
    if not x_err <= tol * wscale:
        raise AssertionError(f"K1's kept X rows ({compute_dtype}) disagree with "
                             f"the plain activations: {x_err} (scale {wscale})")
    sh, shv = kept_signs(torch, kept)
    h = X[mk.X_H:mk.X_F].view(mk.DEPTH, mk.WIDTH, -1)
    if not (torch.equal(sh, h.transpose(1, 2) > 0) and torch.equal(shv, hv.t() > 0)):
        raise AssertionError(f"K1's sign words ({compute_dtype}) are not its "
                             "kept activations > 0")
    print(f"  K1 keeping {MODE_NAME[compute_dtype]} R={R} S={S} C={C}: recorded "
          f"call max abs err {err:.3e} (tol {tol * scale:.3e}); kept X rows "
          f"{x_err:.3e} (tol {tol * wscale:.3e}); sign words = kept "
          "activations > 0")
    return dict(max_abs_err=err, max_err_over_scale=err / scale,
                x_rows_max_abs_err=x_err, x_rows_err_over_scale=x_err / wscale,
                signs_equal=True)


def _grads(torch, fn, params, pts, vd, **kw):
    from benerf_tpu_torch.models import bridge

    leaves = [t.detach().requires_grad_(True) for t in bridge.tree_leaves(params)]
    p = bridge.tree_unflatten(params, leaves)
    x = pts.detach().requires_grad_(True)
    v = vd.detach().requires_grad_(True)
    loss = torch.sum(torch.sin(fn(p, x, v, **kw)))
    return torch.autograd.grad(loss, leaves + [x, v])


def check_bwd(torch, which, R, S, C, barf, seed=0):
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
    gk = _grads(torch, op, params, pts, vd, **kw)
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


def check_bf16(torch, which, R, S, C, barf, seed=0):
    """K1/K2 or K3/K4 in bf16 mode. Forward: vs nerf.apply with bf16 operands within
    BF16_FWD_TOL x scale. Gradients of sum(sin(out)): finite; the weight
    gradients' worst err/scale and the per-point gradients' RMS error, each
    against a float64 run of nerf.apply, between BF16_GRAD_FLOOR and
    BF16_GRAD_FACTOR times the plain bf16 version's. -> (fwd err/scale, weight-grad distances to f64
    (kernel, plain), per-point RMS distances (kernel, plain))."""
    from benerf_tpu_torch.models import nerf

    op, views_ch, kw = _pair(which)
    fwd, bwd = which.split("/")
    params, pts, vd, bw, bwv = _inputs(torch, R, S, C, seed, barf, views_ch)
    barf_kw = _barf_kw(bw, bwv)
    kw = {**kw, **barf_kw}
    with torch.no_grad():
        out_k = op(params, pts, vd, compute_dtype="bfloat16", **kw)
        out_p = nerf.apply(params, pts, vd, compute_dtype=torch.bfloat16, **kw)
    err, scale = _max_err(out_k, out_p)
    gk = _grads(torch, op, params, pts, vd, compute_dtype="bfloat16", **kw)
    gp = _grads(torch, nerf.apply, params, pts, vd,
                compute_dtype=torch.bfloat16, **kw)
    g64 = _grads(torch, nerf.apply, _f64(torch, params), pts.double(),
                 vd.double(), **{**kw, **{k: v.double() for k, v in barf_kw.items()}})
    torch.cuda.synchronize()
    n_w = len(g64) - 2
    wk, wp = _dist(gk[:n_w], g64[:n_w]), _dist(gp[:n_w], g64[:n_w])
    pk = max(_rms_rel(a, b) for a, b in zip(gk[n_w:], g64[n_w:]))
    pp = max(_rms_rel(a, b) for a, b in zip(gp[n_w:], g64[n_w:]))
    print(f"  {which} bf16 R={R} S={S} C={C} barf={barf}: fwd err/scale "
          f"{err / scale:.3e} (tol {BF16_FWD_TOL}); to float64: weight grads "
          f"{wk:.3e} (plain bf16 {wp:.3e}), per-point RMS {pk:.3e} (plain "
          f"{pp:.3e}); factor limits [{BF16_GRAD_FLOOR}, {BF16_GRAD_FACTOR}]")
    if not err <= BF16_FWD_TOL * scale:
        raise AssertionError(f"{fwd} bf16 disagrees with the plain version: {err}")
    if not all(bool(torch.isfinite(g).all()) for g in gk):
        raise AssertionError(f"{bwd} bf16: non-finite gradients")
    if not (BF16_GRAD_FLOOR * wp <= wk <= BF16_GRAD_FACTOR * wp
            and BF16_GRAD_FLOOR * pp <= pk <= BF16_GRAD_FACTOR * pp):
        raise AssertionError(f"{bwd} bf16 gradients' distance to float64 not that "
                             f"of bf16 operands: {wk} vs {wp}, {pk} vs {pp}")
    wabs = max(float((a.double() - b).abs().max())
               for a, b in zip(gk[:n_w], g64[:n_w]))
    return dict(fwd_err=err, fwd_rel=err / scale, wgrad_abs_vs_f64=wabs,
                wgrad_vs_f64=wk, plain_wgrad_vs_f64=wp, points_rms_vs_f64=pk,
                plain_points_rms_vs_f64=pp)


def check_splits(torch, which, tol, R=RAYS, S=128, counts=(32, 7), seed=2):
    """The backward kernel (K2 or K4, fp32 mode, C = 3) launched at each
    split count of `counts` on the same inputs and cotangent (that of
    sum(sin(out))): its weight gradients, leaf by leaf, within tol x scale
    of the first count's; d pts and d of the per-ray input bitwise equal
    (they do not pass the reduction)."""
    from benerf_tpu_torch.ops import fused_mlp, mlp_kernels, staged_mlp

    name = which.split("/")[1]
    pair = mlp_kernels.FUSED if which == "K1/K2" else mlp_kernels.STAGED
    params, pts, vd, _, _ = _inputs(torch, R, S, 3, seed, False,
                                    views_ch=27 if pair.view_pe else 39)
    packed = mlp_kernels.pack_params(params, pair.view_pe).detach().contiguous()
    x = pts.reshape(R * S, 3).contiguous()
    if pair.view_pe:
        ray, band = vd, fused_mlp.band_weights(None, None, "cuda")
    else:
        with torch.no_grad():
            ray, band = staged_mlp.view_bias(params, vd, 6).contiguous(), None
    prep = mlp_kernels.prep_buffer(pair.view_pe, "float32", "cuda")
    kept = mlp_kernels.kept_scratch(R * S, "cuda") if pair.view_pe else None
    g = torch.cos(mlp_kernels.launch_fwd(pair, packed, x, ray, band, S, 3,
                                         prep=prep, kept=kept))
    runs = [mlp_kernels.launch_bwd(pair, packed, x, ray, band, g, S, 3,
                                   prep=prep, kept=kept, splits=n) for n in counts]

    def leaves(dpacked):
        """The weight gradient by parameter leaf (wh and b stack a layer
        each)."""
        entries = mlp_kernels.unpack(dpacked, 3, pair.view_pe).items()
        return [t for k, v in entries
                for t in (v.unbind(0) if k in ("wh", "b") else (v,)) if t.numel()]

    want = leaves(runs[0][0])
    worst, same_points = 0.0, True
    for run in runs[1:]:
        worst = max([worst] + [_max_err(a, b)[0] / _max_err(a, b)[1]
                               for a, b in zip(leaves(run[0]), want)])
        same_points &= all(torch.equal(a, b) for a, b in zip(run[1:], runs[0][1:]))
    print(f"  {name} splits {counts[1:]} vs {counts[0]}: weight grads worst "
          f"diff/scale {worst:.3e}; per-point grads bitwise equal: {same_points}")
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
    """(K1 ms, plain fwd ms, K2 ms, plain fwd+bwd ms, K1 keeping ms) at n =
    RAYS * S in the kernels' mode for `compute_dtype`; the plain version
    runs in it too. K1 keeps nothing (no_grad's launch); K1 keeping writes
    its forward for K2 (a recorded call's launch), and K2 runs on it."""
    from benerf_tpu_torch.models import bridge, nerf
    from benerf_tpu_torch.ops import fused_mlp, mlp_kernels

    params, pts, vd, _, _ = _inputs(torch, RAYS, S, C, 1, False)
    n = RAYS * S
    cd = None if compute_dtype == "float32" else torch.bfloat16
    packed = mlp_kernels.pack_params(params).contiguous()
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

    # K1's launch writes the weights' wgmma copies that K2 reads, as on the
    # path
    prep = mlp_kernels.prep_buffer(True, compute_dtype, "cuda")
    fused = mlp_kernels.FUSED
    k1 = time_ms(torch, lambda: mlp_kernels.launch_fwd(
        fused, packed, x, vd, band, S, C, compute_dtype, prep=prep))
    kept = mlp_kernels.kept_scratch(n, "cuda", compute_dtype)
    kk = time_ms(torch, lambda: mlp_kernels.launch_fwd(
        fused, packed, x, vd, band, S, C, compute_dtype, prep=prep, kept=kept))
    k2 = time_ms(torch, lambda: mlp_kernels.launch_bwd(
        fused, packed, x, vd, band, g, S, C, compute_dtype, prep=prep, kept=kept))
    p1 = time_ms(torch, plain_fwd)
    p2 = time_ms(torch, plain_fwd_bwd)
    return k1, p1, k2, p2, kk


def time_eval_k1(torch, C=3):
    """K1 in fp32 mode (TF32X3) at the eval chunk's shapes, n = EVAL_RAYS x
    64 (coarse) and x 128 (fine), no grad: {n: times and bound}. Bytes and
    operations as _per_n_fused counts them for the forward."""
    from benerf_tpu_torch.models import nerf
    from benerf_tpu_torch.ops import fused_mlp, mlp_kernels

    weights = mlp_kernels.packed_size(C)
    out = {}
    for S in (64, 128):
        params, pts, vd, _, _ = _inputs(torch, EVAL_RAYS, S, C, 4, False)
        n = EVAL_RAYS * S
        packed = mlp_kernels.pack_params(params).contiguous()
        band = fused_mlp.band_weights(None, None, "cuda")
        x = pts.reshape(n, 3).contiguous()

        def plain():
            with torch.no_grad():
                nerf.apply(params, pts, vd)

        prep = mlp_kernels.prep_buffer(True, "float32", "cuda")
        d = dict(fwd_ms=time_ms(torch, lambda: mlp_kernels.launch_fwd(
            mlp_kernels.FUSED, packed, x, vd, band, S, C, "float32", prep=prep)),
            fwd_plain_ms=time_ms(torch, plain))
        d["fwd_bound_ms"], d["fwd_bound_by"] = _bound(
            flops_fwd_per_point() * n, TC_PEAK["float32"],
            (n * (3 + C + 1) + EVAL_RAYS * 3 + weights) * 4)
        out[n] = d
        print(f"  eval chunk n={n}: K1 {d['fwd_ms']:.3f} ms (plain "
              f"{d['fwd_plain_ms']:.3f}, bound {d['fwd_bound_ms']:.3f} "
              f"{d['fwd_bound_by']})")
    return out


def time_tile_pass(torch, S, C=3, compute_dtype="float32", view_pe=True):
    """The tile pass (pass (a) of K2, with view_pe, else of K4) alone at n =
    RAYS * S, ms: its C entry (fused_mlp_tile / staged_mlp_tile) on the
    weights' wgmma copies a forward launch wrote (K2's: on the forward that
    launch kept). K4 runs with a view encoding of L = 6, as on its path."""
    from benerf_tpu_torch.ops import fused_mlp, mlp_kernels, staged_mlp

    params, pts, vd, _, _ = _inputs(torch, RAYS, S, C, 1, False,
                                    views_ch=27 if view_pe else 39)
    n = RAYS * S
    packed = mlp_kernels.pack_params(params, view_pe=view_pe).contiguous()
    x = pts.reshape(n, 3).contiguous()
    g = torch.randn((n, C + 1), device="cuda")
    prep = mlp_kernels.prepare_weights(packed, C, view_pe, compute_dtype)
    if view_pe:
        band = fused_mlp.band_weights(None, None, "cuda")
        kept = mlp_kernels.kept_scratch(n, "cuda", compute_dtype)
        mlp_kernels.launch_fwd(mlp_kernels.FUSED, packed, x, vd, band, S, C,
                               compute_dtype, prep=prep, kept=kept)
        return time_ms(torch, lambda: mlp_kernels.run_tile(
            mlp_kernels.FUSED, packed, x, vd, band, g, S, C, compute_dtype,
            prep=prep, kept=kept))
    with torch.no_grad():
        vb = staged_mlp.view_bias(params, vd, 6, compute_dtype).contiguous()
    return time_ms(torch, lambda: mlp_kernels.run_tile(
        mlp_kernels.STAGED, packed, x, vb, None, g, S, C, compute_dtype,
        prep=prep))


def wgrad_scratch(torch, view_pe, n, C=3, seed=3):
    """A float32 backward scratch (mlp_kernels.Scratch) for n points (K2's
    rows with view_pe, else K4's), filled with normal numbers. The pass's
    work does not depend on the values."""
    from benerf_tpu_torch.ops import mlp_kernels

    kept = mlp_kernels.kept_scratch(n, "cuda") if view_pe else None
    scr = mlp_kernels.bwd_scratch(mlp_kernels.PAIRS[view_pe], n, C, "cuda",
                                  kept=kept)
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    scr.x.normal_(generator=g)
    scr.d.normal_(generator=g)
    return scr


def check_wgrad(torch, view_pe, n, C=3):
    """The weight-gradient pass alone (K2's job table with view_pe, else
    K4's) at n points, both modes, splits 32 and 7, against
    mlp_kernels.wgrad_plain of an fp32 scratch of normal numbers: its float64
    product (bf16 mode: the pass runs on the bf16 format of that scratch,
    mlp_kernels.bf16_scratch_plain, against the float64 product of its
    bf16-rounded operands; its biases against the float64 sums of the fp32
    D rows), within WGRAD_TOL x max |ref| for every job -> {mode:
    {"splits_32": worst err/scale, "splits_7": ..., "max_abs_err": ...,
    and in bf16 mode "vs_fp32_operands": distance to the float64 product of
    the unrounded scratch}}."""
    from benerf_tpu_torch.ops import mlp_kernels

    name = "K2" if view_pe else "K4"
    scr32 = wgrad_scratch(torch, view_pe, n, C)
    ranges = mlp_kernels.wgrad_ranges(C, view_pe)

    def worst(got, ref):
        rel, err = 0.0, 0.0
        for _, off, size in ranges:
            a, b = got[off:off + size].double(), ref[off:off + size]
            e = float((a - b).abs().max())
            err, rel = max(err, e), max(rel, e / max(float(b.abs().max()), 1e-30))
        return rel, err

    out = {}
    for cd in ("float32", "bfloat16"):
        ref = mlp_kernels.wgrad_plain(scr32, C, view_pe, cd)
        scr = scr32 if cd == "float32" else mlp_kernels.bf16_scratch_plain(scr32, C, view_pe)
        r = {}
        for splits in (32, 7):
            got = mlp_kernels.run_wgrad(scr, C, splits, view_pe)
            torch.cuda.synchronize()
            rel, err = worst(got, ref)
            if not (bool(torch.isfinite(got).all()) and rel <= WGRAD_TOL):
                raise AssertionError(f"{name} weight-gradient pass ({cd}, splits "
                                     f"{splits}, n={n}) off float64: {rel}")
            r[f"splits_{splits}"] = rel
            r["max_abs_err"] = max(r.get("max_abs_err", 0.0), err)
        if cd == "bfloat16":
            r["vs_fp32_operands"] = worst(got, mlp_kernels.wgrad_plain(
                scr32, C, view_pe))[0]
        out[MODE_NAME[cd]] = r
        print(f"  {name} weight-gradient pass {MODE_NAME[cd]} n={n}: vs float64 "
              f"worst err/scale {r['splits_32']:.3e} (splits 32), "
              f"{r['splits_7']:.3e} (7)"
              + (f"; bf16 vs fp32 operands {r['vs_fp32_operands']:.3e}"
                 if cd == "bfloat16" else "") + f" (tol {WGRAD_TOL})")
    return out


def check_tile_sums(torch, view_pe, R, S, C=3):
    """K2's (view_pe; on the forward K1 kept) or K4's tile pass in bf16 mode
    at R x S points: the scratch beside its bf16 rows
    (csrc/fused_mlp_bwd_common.cuh). Its fp32 rows are what the bf16 rows
    round: h7 (and K4's d vb per point) to the
    bit, the cotangent equal to the input, zero past n; each tile sum of a
    D row (a bias's partial, summed from the fp32 values) is within
    (2^-8 + 2^-18) x sum |d| of the float64 sum of that tile's bf16 row:
    rounding to bf16 moves an element by at most half an ulp, 2^-8 of its
    rounded value (8 significant bits), and 64 fp32 adds at most 2^-18 of
    sum |d|; zero in padding -> {"tile_sum_gap_over_bound": worst,
    "points": n}."""
    from benerf_tpu_torch.ops import fused_mlp, mlp_kernels, staged_mlp

    params, pts, vd, _, _ = _inputs(torch, R, S, C, 5, False,
                                    views_ch=27 if view_pe else 39)
    n = R * S
    packed = mlp_kernels.pack_params(params, view_pe=view_pe).contiguous()
    x = pts.reshape(n, 3).contiguous()
    g = torch.randn((n, C + 1), device="cuda")
    prep = mlp_kernels.prepare_weights(packed, C, view_pe, "bfloat16")
    if view_pe:
        band = fused_mlp.band_weights(None, None, "cuda")
        kept = mlp_kernels.kept_scratch(n, "cuda", "bfloat16")
        mlp_kernels.launch_fwd(mlp_kernels.FUSED, packed, x, vd, band, S, C,
                               "bfloat16", prep=prep, kept=kept)
        scr = mlp_kernels.run_tile(mlp_kernels.FUSED, packed, x, vd, band, g, S,
                                   C, "bfloat16", prep=prep, kept=kept)[0]
    else:
        with torch.no_grad():
            vb = staged_mlp.view_bias(params, vd, 6, "bfloat16").contiguous()
        scr = mlp_kernels.run_tile(mlp_kernels.STAGED, packed, x, vb, None, g, S,
                                   C, "bfloat16", prep=prep)[0]
    torch.cuda.synchronize()
    n_pad = scr.n_pad
    X, D = scr.rows("x"), scr.rows("d")
    side = scr.side.view(-1, n_pad)
    h7 = mlp_kernels.X_H + (mlp_kernels.DEPTH - 1) * mlp_kernels.WIDTH
    pairs = [("h7", side[mlp_kernels.SIDE_H7:mlp_kernels.SIDE_HV], X[h7:mlp_kernels.X_F])]
    if not view_pe:
        pairs.append(("d vb", side[mlp_kernels.SIDE_DHV:mlp_kernels.SIDE_DHV + 128],
                      D[mlp_kernels.D_HV:mlp_kernels.D_G]))
    for name, fp32, bf in pairs:
        if not torch.equal(fp32.to(torch.bfloat16), bf):
            raise AssertionError(f"{'K2' if view_pe else 'K4'} bf16 scratch: the fp32 "
                                 f"{name} rows do not round to its bf16 rows")
    g0 = mlp_kernels.side_g(view_pe)
    want_g = torch.zeros((C + 1, n_pad), device="cuda")
    want_g[:, :n] = g.t()
    gside = scr.gside.view(-1, n_pad) if view_pe else side
    if not torch.equal(gside[g0:g0 + C + 1], want_g):
        raise AssertionError("bf16 scratch: the cotangent rows differ from the input")
    rows = D.double().view(mlp_kernels.BIAS_ROWS, n_pad // mlp_kernels.TILE, mlp_kernels.TILE)
    ref, bound = rows.sum(-1).t(), (2.0 ** -8 + 2.0 ** -18) * rows.abs().sum(-1).t()
    gap = (scr.bsum.double() - ref).abs()
    worst = float((gap / bound.clamp_min(1e-30)).max())
    if not (bool(torch.isfinite(scr.bsum).all()) and bool((gap <= bound).all())):
        raise AssertionError(f"{'K2' if view_pe else 'K4'} tile sums off their bf16 "
                             f"rows at {R}x{S}: worst gap / bound {worst}")
    print(f"  {'K2' if view_pe else 'K4'} bf16 tile pass {R}x{S}: fp32 rows round to "
          f"the bf16 ones; tile sums at {worst:.4f} of their bound")
    return {"tile_sum_gap_over_bound": worst, "points": n}


def time_wgrad(torch, S, C=3, compute_dtype="float32", view_pe=True):
    """(the weight-gradient pass ms, torch.matmul of the same products ms in
    fp32, the same in TF32, the same on bf16 operands) at n = RAYS * S, K2's
    job table with view_pe, else K4's. The pass runs alone on a scratch of
    random numbers, in the mode's format; torch.matmul is the yardstick
    only: the port never calls it."""
    from benerf_tpu_torch.ops import mlp_kernels

    n = RAYS * S
    scr = wgrad_scratch(torch, view_pe, n, C)
    if compute_dtype == "bfloat16":
        scr = mlp_kernels.bf16_scratch_plain(scr, C, view_pe)
    k = time_ms(torch, lambda: mlp_kernels.run_wgrad(scr, C, view_pe=view_pe))
    del scr
    shapes = [(j[2], j[4]) for j in mlp_kernels.wgrad_jobs(C, view_pe)[0]]
    xs = torch.randn((sum(i for i, _ in shapes), n), device="cuda")
    ds = torch.randn((sum(o for _, o in shapes), n), device="cuda")
    pairs, i0, o0 = [], 0, 0
    for i, o in shapes:
        pairs.append((xs[i0:i0 + i], ds[o0:o0 + o]))
        i0, o0 = i0 + i, o0 + o

    def library(ps):
        for a, b in ps:
            torch.matmul(a, b.t())

    tf32 = torch.backends.cuda.matmul.allow_tf32
    times = []
    for allow in (False, True):
        torch.backends.cuda.matmul.allow_tf32 = allow
        times.append(time_ms(torch, lambda: library(pairs)))
    torch.backends.cuda.matmul.allow_tf32 = tf32
    del xs, ds
    bf = [(a.to(torch.bfloat16), b.to(torch.bfloat16)) for a, b in pairs]
    times.append(time_ms(torch, lambda: library(bf)))
    return k, times[0], times[1], times[2]


def _wgrad_per_n(torch, per, n, C, compute_dtype, view_pe, peak, weights):
    """Time the weight-gradient pass at n = RAYS * S into `per` (the
    wgrad_* keys): pass and library times, the operation bound (its matrix
    products at the mode's tensor-core rate) and the byte bound (its
    scratch read once, its gradients written once)."""
    from benerf_tpu_torch.ops import mlp_kernels

    S = n // RAYS
    n_pad = -(-n // mlp_kernels.TILE) * mlp_kernels.TILE
    kw, lib32, lib_tf32, lib_bf16 = time_wgrad(torch, S, C, compute_dtype, view_pe)
    products = mlp_kernels.wgrad_jobs(C, view_pe)[0]
    wflops = 2 * n * sum(j[2] * j[4] for j in products)
    wbytes = mlp_kernels.scratch_bytes(n_pad, C, view_pe, compute_dtype) + weights * 4
    per.update(wgrad_ms=kw, wgrad_library_fp32_ms=lib32,
               wgrad_library_tf32_ms=lib_tf32,
               wgrad_ops_bound_ms=wflops / peak * 1e3,
               wgrad_bytes_bound_ms=wbytes / HBM_BYTES_S * 1e3)
    if compute_dtype == "bfloat16":
        per["wgrad_library_bf16_operands_ms"] = lib_bf16
    per["wgrad_bound_ms"], per["wgrad_bound_by"] = _bound(wflops, peak, wbytes)
    return (f"weight-gradient pass {kw:.3f} ms (bound {per['wgrad_bound_ms']:.3f} "
            f"{per['wgrad_bound_by']}; torch.matmul fp32 {lib32:.3f}, TF32 "
            f"{lib_tf32:.3f}, bf16 operands {lib_bf16:.3f})")


def _tile_per_n(torch, per, n, C, compute_dtype, view_pe, peak, flops):
    """Time the tile pass (pass (a) of K2 or K4) at n = RAYS * S into `per`
    (the tile_* keys): its time and its bound, the larger of its products at
    the mode's tensor-core rate and its bytes. K2's: the data gradients
    (1x the forward's products), the backward's part of the scratch
    written once and the sign words read once (K1 kept the forward); K4's:
    the forward again, then the data gradients (2x), the scratch written
    once."""
    from benerf_tpu_torch.ops import mlp_kernels

    S = n // RAYS
    n_pad = -(-n // mlp_kernels.TILE) * mlp_kernels.TILE
    t = time_tile_pass(torch, S, C, compute_dtype, view_pe)
    per["tile_ms"] = t
    if view_pe:
        nbytes = (mlp_kernels.scratch_bytes(n_pad, C, True, compute_dtype, "backward")
                  + mlp_kernels.scratch_sizes(n_pad, C, True, compute_dtype).signs * 4)
    else:
        nbytes = mlp_kernels.scratch_bytes(n_pad, C, False, compute_dtype)
    per["tile_bound_ms"], per["tile_bound_by"] = _bound(
        (1 if view_pe else 2) * flops, peak, nbytes)
    return (f"tile pass {t:.3f} ms (bound {per['tile_bound_ms']:.3f} "
            f"{per['tile_bound_by']})")


def time_staged_kernels(torch, S, C=3, compute_dtype="float32"):
    """(K3 ms, plain fwd ms, K4 ms, plain fwd+bwd ms) at n = RAYS * S, view
    encoding L = 6, in the kernels' mode for `compute_dtype`; the plain
    version runs in it too. The per-ray view bias is made outside, as on
    the path."""
    from benerf_tpu_torch.models import bridge, nerf
    from benerf_tpu_torch.ops import mlp_kernels, staged_mlp

    params, pts, vd, _, _ = _inputs(torch, RAYS, S, C, 1, False, views_ch=39)
    n = RAYS * S
    cd = None if compute_dtype == "float32" else torch.bfloat16
    packed = mlp_kernels.pack_params(params, view_pe=False).contiguous()
    with torch.no_grad():
        vb = staged_mlp.view_bias(params, vd, 6, compute_dtype).contiguous()
    x = pts.reshape(n, 3).contiguous()
    g = torch.randn((n, C + 1), device="cuda")
    wrt = [t.requires_grad_(True) for t in bridge.tree_leaves(params)]
    wrt += [pts.requires_grad_(True), vd.requires_grad_(True)]

    def plain_fwd():
        with torch.no_grad():
            nerf.apply(params, pts, vd, num_freqs_views=6, compute_dtype=cd)

    def plain_fwd_bwd():
        out = nerf.apply(params, pts, vd, num_freqs_views=6,
                         compute_dtype=cd).reshape(n, C + 1)
        torch.autograd.grad(out, wrt, g)

    prep = mlp_kernels.prep_buffer(False, compute_dtype, "cuda")
    staged = mlp_kernels.STAGED
    k3 = time_ms(torch, lambda: mlp_kernels.launch_fwd(
        staged, packed, x, vb, None, S, C, compute_dtype, prep=prep))
    k4 = time_ms(torch, lambda: mlp_kernels.launch_bwd(
        staged, packed, x, vb, None, g, S, C, compute_dtype, prep=prep))
    p1 = time_ms(torch, plain_fwd)
    p2 = time_ms(torch, plain_fwd_bwd)
    return k3, p1, k4, p2


def reset_counts():
    """Every kernel's launch count and the plain route's count to 0."""
    from benerf_tpu_torch.ops import mlp, mlp_kernels

    for d in (mlp_kernels.LAUNCHES, mlp.ROUTES):
        for k in d:
            d[k] = 0


def counts():
    from benerf_tpu_torch.ops import mlp, mlp_kernels

    return {**mlp_kernels.LAUNCHES, "plain_route": mlp.ROUTES["plain"]}


def launch_keys(pair, compute_dtype):
    """The keys of mlp_kernels.LAUNCHES of a pair's two kernels ("fused_mlp"
    or "staged_mlp") in compute_dtype, on the train path: with K1/K2 the
    count of K1 launches that kept their forward for K2."""
    sfx = "" if compute_dtype == "float32" else "_bf16"
    kept = (f"{pair}_fwd_kept{sfx}",) if pair == "fused_mlp" else ()
    return (f"{pair}_fwd{sfx}", f"{pair}_bwd{sfx}", *kept)


def expect_counts(got, iters, kernels):
    """2 launches per iteration of each kernel in `kernels` (one coarse and
    one fine MLP call per step), none of any other, no plain route."""
    want = {k: 2 * iters if k in kernels else 0 for k in got}
    if got != want:
        raise AssertionError(f"launch counts {got}, expected {want}")


def expect_graphs(before, captured, replayed):
    """step.GRAPHS gained `captured` captures and `replayed` replays since
    `before` (a copy of it)."""
    from benerf_tpu_torch.train import step as step_mod

    got = {k: step_mod.GRAPHS[k] - before[k] for k in before}
    want = {"captured": captured, "replayed": replayed}
    if got != want:
        raise AssertionError(f"CUDA graphs of the step: {got}, expected {want}")


def run_slice(torch, scene, iters=ITERS, compute_dtype="float32"):
    """tanabata at full width for `iters` iterations through the train loop
    (console records every LOG_EVERY steps, nothing else periodic, so
    dispatches of LOG_EVERY: one graph captured, iters - 1 replays) with the
    MLPs in `compute_dtype` -> (ms/iter, rays/s, launch counts, wall s)."""
    from benerf_tpu_torch.core.config import load_config
    from benerf_tpu_torch.train import loop
    from benerf_tpu_torch.train import step as step_mod

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
        graphs = dict(step_mod.GRAPHS)
        t0 = time.perf_counter()
        loop.train(cfg, scene, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counts()
        expect_graphs(graphs, 1, iters - 1)
        with open(f"{logdir}/0/metrics.jsonl") as f:
            recs = [json.loads(line) for line in f]
    losses = [r["train_loss"] for r in recs if "train_loss" in r]
    rates = [r["rays_per_sec"] for r in recs if "rays_per_sec" in r]
    if len(losses) != iters or not all(np.isfinite(losses)):
        raise AssertionError(f"losses not all finite: {losses}")
    expect_counts(launches, iters, launch_keys("fused_mlp", compute_dtype))
    steady = rates[-1]  # the last LOG_EVERY iterations
    print(f"  {iters} iterations in {wall:.2f} s; losses {losses[0]:.5f} -> "
          f"{losses[-1]:.5f}; launches {launches}")
    return 1e3 * RAYS / steady, steady, launches, wall


def slice_setup(torch, scene, compute_dtype="float32", multires_views=6,
                config=TANABATA):
    """tanabata (or `config`) with a view encoding of `multires_views`
    frequencies: the config (window cap as loop.train sets it), the batch,
    H, W and a maker of the step-0 state; at L != 4 both NeRFs are built by
    the caller (39 view rows at L = 6: build_params makes 27, as in the JAX
    package)."""
    from benerf_tpu_torch.core.config import load_config
    from benerf_tpu_torch.data import events as events_util
    from benerf_tpu_torch.models import bridge, nerf
    from benerf_tpu_torch.train import loop
    from benerf_tpu_torch.train import step as step_mod

    cfg = dataclasses.replace(load_config(str(config)),
                              multires_views=multires_views,
                              compute_dtype=compute_dtype)
    if cfg.event_time_window and cfg.event_window_cap == 0:  # as loop.train
        cfg = dataclasses.replace(cfg, event_window_cap=events_util.window_cap(
            scene.events.ts.cpu().numpy(), cfg.accumulate_time_length))
    H, W = scene.image.shape[1:3]
    K_rgb, K_evt, _, _, _ = loop.intrinsics(cfg)
    batch = loop.make_batch(scene, cfg, K_rgb, K_evt, "cuda")

    def make_state():
        params = step_mod.build_params(cfg, cfg.seed, device="cuda")
        g = torch.Generator(device="cuda")
        g.manual_seed(cfg.seed + 1)
        for name in ("nerf", "nerf_fine") if multires_views != 4 else ():
            params[name] = bridge.tree_map(
                lambda t: t.requires_grad_(True),
                nerf.init_params(g, input_ch_views=3 + 6 * multires_views,
                                 channels=cfg.channels, device="cuda"))
        return step_mod.init_state(cfg, cfg.seed, device="cuda", params=params)

    return cfg, batch, H, W, make_state


def run_l6_slice(torch, scene, iters=L6_ITERS, compute_dtype="float32",
                 warmup=L6_WARMUP):
    """tanabata with multires_views = 6: `warmup` single steps of
    make_train_step, then dispatches of L6_G steps of make_multi_step (one
    graph of the step captured, replayed), one host read per dispatch, the
    MLPs in `compute_dtype`; the dispatches after the first are timed ->
    (ms/iter, rays/s, launch counts, losses)."""
    from benerf_tpu_torch.train import step as step_mod

    if (iters - warmup) % L6_G or (iters - warmup) // L6_G < 2:
        raise ValueError(f"{iters} - {warmup} iterations: not two or more "
                         f"dispatches of {L6_G}")
    cfg, batch, H, W, make_state = slice_setup(torch, scene, compute_dtype)
    state = make_state()
    step_fn = step_mod.make_train_step(cfg, H, W)
    multi_fn = step_mod.make_multi_step(cfg, H, W, L6_G)

    losses = []
    reset_counts()
    graphs = dict(step_mod.GRAPHS)
    for _ in range(warmup):
        state, metrics = step_fn(state, batch, cfg.seed)
        losses += step_mod.metrics_to_host(metrics)["loss"].tolist()
    for d in range((iters - warmup) // L6_G):
        if d == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state, metrics = multi_fn(state, batch, cfg.seed)
        losses += step_mod.metrics_to_host(metrics)["loss"].tolist()
    torch.cuda.synchronize()
    ms_iter = 1e3 * (time.perf_counter() - t0) / (iters - warmup - L6_G)
    launches = counts()
    if len(losses) != iters or not all(np.isfinite(losses)):
        raise AssertionError(f"losses not all finite: {losses}")
    expect_counts(launches, iters, launch_keys("staged_mlp", compute_dtype))
    expect_graphs(graphs, 1, iters - warmup - 1)
    print(f"  {iters} iterations ({warmup} single, then dispatches of {L6_G}); "
          f"losses {losses[0]:.5f} -> {losses[-1]:.5f}; launches {launches}")
    return ms_iter, 1e3 * RAYS / ms_iter, launches, losses


def state_tensors(state):
    """Every parameter and Adam tensor of a TrainState."""
    from benerf_tpu_torch.models import bridge

    out = [t.detach() for t in bridge.tree_leaves(state.params)]
    for g in state.optimizer.param_groups:
        out += [state.optimizer.state[t][k] for t in g["params"]
                for k in ("exp_avg", "exp_avg_sq", "step")]
    return out


def check_capture(torch, scene, multires_views, smi):
    """The captured dispatch against the uncaptured steps, from one state
    and one seed: CMP_DISPATCHES dispatches of CMP_G steps through
    make_multi_step (warm-up step, capture, replays) and as many
    make_train_step calls on an equal state. Every metric of every step,
    every parameter and every Adam tensor must be bit for bit equal. Then
    one more dispatch of each, timed: ms/iter with one host read of the
    stacked metrics per dispatch (captured) and one per step (uncaptured).
    -> measurements, with the card's peak allocated memory of each run."""
    from benerf_tpu_torch.train import step as step_mod

    cfg, batch, H, W, make_state = slice_setup(
        torch, scene, multires_views=multires_views)
    step_fn = step_mod.make_train_step(cfg, H, W)

    def uncaptured(state, batch, seed):
        rows = []
        for _ in range(CMP_G):
            state, m = step_fn(state, batch, seed)
            rows.append(m)
            step_mod.metrics_to_host(m)  # the old loop's host read per step
        return state, {k: torch.stack([r[k] for r in rows]) for k in rows[0]}

    runs = {}
    for name in ("uncaptured", "captured"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fn = (uncaptured if name == "uncaptured"
              else step_mod.make_multi_step(cfg, H, W, CMP_G))
        state, stacked = make_state(), []
        for _ in range(CMP_DISPATCHES):
            state, m = fn(state, batch, cfg.seed)
            step_mod.metrics_to_host(m)
            stacked.append(m)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = fn(state, batch, cfg.seed)
        step_mod.metrics_to_host(m)
        ms = 1e3 * (time.perf_counter() - t0) / CMP_G
        runs[name] = dict(state=state, metrics=stacked, ms=ms,
                          peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                          reserved_gb=torch.cuda.max_memory_reserved() / 1e9)
        del fn
    a, b = runs["captured"], runs["uncaptured"]
    metric_diff = max(float((x[k].double() - y[k].double()).abs().max())
                      for x, y in zip(a["metrics"], b["metrics"]) for k in x)
    same_metrics = all(torch.equal(x[k], y[k])
                       for x, y in zip(a["metrics"], b["metrics"]) for k in x)
    ta, tb = state_tensors(a["state"]), state_tensors(b["state"])
    state_diff = max(float((x.double() - y.double()).abs().max())
                     for x, y in zip(ta, tb))
    same_state = all(torch.equal(x, y) for x, y in zip(ta, tb))
    losses = [float(v) for m in a["metrics"] for v in m["loss"]]
    out = dict(multires_views=multires_views, dispatch=CMP_G,
               steps_held=CMP_G * CMP_DISPATCHES,
               bit_equal_metrics=same_metrics, bit_equal_state=same_state,
               max_abs_diff_metrics=metric_diff, max_abs_diff_state=state_diff,
               captured_ms_per_iter=a["ms"], uncaptured_ms_per_iter=b["ms"],
               captured_peak_allocated_gb=a["peak_gb"],
               uncaptured_peak_allocated_gb=b["peak_gb"],
               captured_peak_reserved_gb=a["reserved_gb"],
               uncaptured_peak_reserved_gb=b["reserved_gb"],
               losses=[losses[0], losses[-1]])
    print(f"  L = {multires_views}: {CMP_G * CMP_DISPATCHES} steps, captured "
          f"vs uncaptured bit-equal: metrics {same_metrics}, params and Adam "
          f"{same_state} (max abs diff {metric_diff:.3e} / {state_diff:.3e}); "
          f"ms/iter captured {a['ms']:.2f}, uncaptured {b['ms']:.2f}; peak "
          f"allocated {a['peak_gb']:.2f} / {b['peak_gb']:.2f} GB, reserved "
          f"{a['reserved_gb']:.2f} / {b['reserved_gb']:.2f} GB; on {smi}")
    if not (same_metrics and same_state and all(np.isfinite(losses))):
        raise AssertionError(f"the captured dispatch differs from the "
                             f"uncaptured steps: {out}")
    return out


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def check_nccl_one_rank(torch, scene, smi, phase10_ms):
    """Phase 13(a): tanabata fp32 under a one-rank NCCL RayMesh (a process
    group of world size 1, built in this process and passed to
    make_multi_step as a JAX Mesh of one device may be) against the unmeshed
    captured dispatch, from one state and seed: CMP_DISPATCHES dispatches of
    CMP_G steps, the all-reduce captured in the graph; every metric,
    parameter and Adam tensor bit for bit (each loss term under a mesh is
    its mean times its share of the rows, x 1.0 at one rank). Then two
    more dispatches of each, timed in turns (unmeshed, meshed, meshed,
    unmeshed), after which the states are held equal again. ->
    measurements."""
    import torch.distributed as dist

    from benerf_tpu_torch.parallel import mesh as mesh_mod
    from benerf_tpu_torch.train import step as step_mod

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0,
                            device_id=torch.device("cuda", 0))
    mesh = mesh_mod.mesh_of_group()
    cfg, batch, H, W, make_state = slice_setup(torch, scene, multires_views=4)

    runs = {}
    for name, m in (("unmeshed", None), ("meshed", mesh)):
        fn = step_mod.make_multi_step(cfg, H, W, CMP_G, mesh=m)
        state, stacked = make_state(), []
        reset_counts()
        coll = dict(mesh_mod.COLLECTIVES)
        for _ in range(CMP_DISPATCHES):
            state, metrics = fn(state, batch, cfg.seed)
            step_mod.metrics_to_host(metrics)
            stacked.append(metrics)
        steps = CMP_G * CMP_DISPATCHES
        runs[name] = dict(
            fn=fn, state=state, metrics=stacked, ms=[], launches=counts(),
            collectives_per_step={k: (mesh_mod.COLLECTIVES[k] - coll[k]) / steps
                                  for k in coll})
    # one more dispatch of each, timed in turns: unmeshed, meshed, meshed,
    # unmeshed
    for name in ("unmeshed", "meshed", "meshed", "unmeshed"):
        run = runs[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run["state"], metrics = run["fn"](run["state"], batch, cfg.seed)
        step_mod.metrics_to_host(metrics)
        run["ms"].append(1e3 * (time.perf_counter() - t0) / CMP_G)
    for run in runs.values():
        del run["fn"]
    dist.destroy_process_group()
    a, b = runs["meshed"], runs["unmeshed"]
    same_metrics = all(torch.equal(x[k], y[k])
                       for x, y in zip(a["metrics"], b["metrics"]) for k in x)
    # after the held dispatches and two timed ones each
    ta, tb = state_tensors(a["state"]), state_tensors(b["state"])
    state_diff = max(float((x.double() - y.double()).abs().max())
                     for x, y in zip(ta, tb))
    same_state = all(torch.equal(x, y) for x, y in zip(ta, tb))
    out = dict(steps_held=CMP_G * CMP_DISPATCHES, dispatch=CMP_G,
               bit_equal_metrics=same_metrics, bit_equal_state=same_state,
               max_abs_diff_state=state_diff,
               collectives_per_step=a["collectives_per_step"],
               launches=a["launches"], meshed_ms_per_iter=a["ms"],
               unmeshed_ms_per_iter=b["ms"], phase10_ms_per_iter=phase10_ms)
    print(f"  one-rank NCCL mesh vs unmeshed, {out['steps_held']} captured "
          f"steps: bit-equal metrics {same_metrics}, params and Adam "
          f"{same_state}; collectives/step {a['collectives_per_step']}; "
          f"launches {a['launches']}; ms/iter in turns meshed {a['ms']}, "
          f"unmeshed {b['ms']} (phase 10 {phase10_ms:.2f}) on {smi}")
    expect_counts(a["launches"], CMP_G * CMP_DISPATCHES,
                  launch_keys("fused_mlp", "float32"))
    if not (same_metrics and same_state
            and a["collectives_per_step"]["all_reduce"] == 1):
        raise AssertionError(f"the one-rank NCCL mesh differs from the "
                             f"unmeshed dispatch: {out}")
    return out


def mesh_steps(torch, config, mesh):
    """MESH_STEPS single steps (make_train_step, under `mesh` or alone) of
    `config` at full width, fp32 mode, on random_scene's events from seed 0
    -> every step's metrics, step 1's gradients, the parameters after step
    1 and after the last, the launch counts, the first step's s and ms/step
    over the others (host clock, uncaptured)."""
    from benerf_tpu_torch.core.config import load_config
    from benerf_tpu_torch.data import datasets
    from benerf_tpu_torch.models import bridge
    from benerf_tpu_torch.train import step as step_mod

    scene = datasets.random_scene(load_config(str(config)), N_EVENTS, seed=0,
                                  device="cuda")
    cfg, batch, H, W, make_state = slice_setup(torch, scene, multires_views=4,
                                               config=config)
    state = make_state()
    step_fn = step_mod.make_train_step(cfg, H, W, mesh)

    def params():
        return [t.detach().cpu().numpy() for t in bridge.tree_leaves(state.params)]

    out, rows, times = {}, [], []
    reset_counts()
    for i in range(MESH_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch, cfg.seed)
        rows.append({k: float(v[0]) for k, v in
                     step_mod.metrics_to_host(metrics).items()})
        times.append(time.perf_counter() - t0)
        if i == 0:
            out["grads1"] = [np.zeros(tuple(t.shape), np.float32)
                             if t.grad is None else t.grad.cpu().numpy()
                             for t in bridge.tree_leaves(state.params)]
            out["params1"] = params()
    return dict(out, metrics=rows, launches=counts(), params=params(),
                first_step_s=times[0],
                ms_per_step=1e3 * statistics.mean(times[1:]))


@contextlib.contextmanager
def patched(kind):
    """Phase 13(b)'s changes to the port, undone on exit. The witness
    "permuted_rays": under a one-rank mesh, shard_rows keeps all of each
    family's pixels and their per-row draws in one fixed permuted order (one
    permutation per pixel count), so the step computes the same function
    with every sum over rays in another order. Two planted faults, which
    change only steps 2 and later: "stale_draws", every step draws from the
    generators of the run's first step; "rank0_rows", from step 2 on every
    rank renders its own pixels with rank 0's per-row draws (stratification,
    fine-sample and noise uniforms). None changes nothing."""
    import torch

    from benerf_tpu_torch.core import rng
    from benerf_tpu_torch.parallel import mesh as mesh_mod

    generators0, shard_rows0 = rng.step_generators, mesh_mod.shard_rows
    steps, perms = [], {}

    def step_generators(seed, step, device, out=None):
        steps.append(step)
        if kind == "stale_draws":
            step = steps[0]
        return generators0(seed, step, device, out)

    def shard_rows(x, mesh, dim=0):
        mine = shard_rows0(x, mesh, dim)
        if kind == "permuted_rays":
            n = x.shape[dim]
            if n not in perms:
                perms[n] = torch.randperm(
                    n, generator=torch.Generator().manual_seed(n))
            return x.index_select(dim, perms[n].to(x.device))
        if kind == "rank0_rows" and dim == 1 and len(steps) > 1:
            return shard_rows0(x, dataclasses.replace(mesh, rank=0), dim) \
                .narrow(dim, 0, mine.shape[dim])
        return mine

    if kind is not None:
        rng.step_generators, mesh_mod.shard_rows = step_generators, shard_rows
    try:
        yield
    finally:
        rng.step_generators, mesh_mod.shard_rows = generators0, shard_rows0


def run_mesh_rank(rank, port, out_path):
    """Phase 13(b)'s child process: rank `rank` of a two-rank gloo mesh on
    card 0; mesh_steps on every MESH_CONFIGS config, then again with each
    MESH_FAULTS fault planted, pickled to out_path."""
    import pickle

    import torch
    import torch.distributed as dist

    from benerf_tpu_torch.ops import mlp_kernels
    from benerf_tpu_torch.parallel import mesh as mesh_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mlp_kernels.build()  # the parent built it: loads
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    mesh = mesh_mod.mesh_of_group(device=torch.device("cuda", 0))
    out = {"collectives": {}, "faults": {}}
    for name, config in MESH_CONFIGS.items():
        before = dict(mesh_mod.COLLECTIVES)
        out[name] = mesh_steps(torch, config, mesh)
        out["collectives"][name] = {
            k: (mesh_mod.COLLECTIVES[k] - before[k]) / MESH_STEPS
            for k in before}
        for fault in MESH_FAULTS:
            with patched(fault):
                out["faults"][name, fault] = mesh_steps(torch, config, mesh)
    dist.destroy_process_group()
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
    print(f"rank {rank}: done, collectives {out['collectives']}")


def witness_steps(torch):
    """Phase 13(b)'s witness: mesh_steps of every MESH_CONFIGS config in
    this process under a one-rank gloo mesh with its rays permuted
    (patched("permuted_rays")): the steps alone computes, every sum over
    rays in another order."""
    import torch.distributed as dist

    from benerf_tpu_torch.parallel import mesh as mesh_mod

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    mesh = mesh_mod.mesh_of_group(device=torch.device("cuda", 0))
    out = {}
    for name, config in MESH_CONFIGS.items():
        with patched("permuted_rays"):
            out[name] = mesh_steps(torch, config, mesh)
    dist.destroy_process_group()
    return out


def _err_over_scale(got, want):
    """max over leaves of max |got - want| / max(max |want|, 1)."""
    return max(float(np.abs(a - b).max(initial=0.0))
               / max(float(np.abs(b).max(initial=0.0)), 1.0)
               for a, b in zip(got, want))


def _distances(run, ref):
    """mesh_steps `run` against `ref`: every step's largest relative metric
    difference, step 1's gradients and the parameters after step 1 and after
    the last (each as max err / max(leaf scale, 1))."""
    rel = [max(abs(x[k] - y[k]) / max(abs(y[k]), 1e-30)
               for k in y if y[k] != 0 or x[k] != 0)
           for x, y in zip(run["metrics"], ref["metrics"])]
    return dict(
        metrics_max_rel_diff_by_step=rel,
        grads_step1=_err_over_scale(run["grads1"], ref["grads1"]),
        params_step1=_err_over_scale(run["params1"], ref["params1"]),
        params_last=_err_over_scale(run["params"], ref["params"]))


def _step1_ok(d):
    return (d["metrics_max_rel_diff_by_step"][0] <= 1e-5
            and d["grads_step1"] <= GRAD_TOL
            and d["params_step1"] <= MESH_PARAM_TOL)


def _later_ok(d):
    """Steps 2 and later within the drift limits."""
    return (max(d["metrics_max_rel_diff_by_step"][1:]) <= MESH_DRIFT_REL
            and d["params_last"] <= MESH_DRIFT_PARAM)


def check_two_ranks_gloo(torch, smi):
    """Phase 13(b): MESH_STEPS steps of each MESH_CONFIGS config at full
    width, fp32 mode, first alone in this process, then in two processes
    (each importing torch and the port only) that share the card as a
    two-rank gloo mesh (NCCL takes one rank per card), from the same state.
    Held: K1/K2 twice a step on each rank; the ranks' parameters bit-equal
    after step 1 and after the last; step 1 against the card alone: loss
    and metrics at rtol 1e-5, every gradient within GRAD_TOL x max(|g|, 1),
    the parameters after it within MESH_PARAM_TOL x max(|p|, 1), as
    tests/test_sharding.py holds the JAX mesh's one step.

    From step 2 on, Adam's m/sqrt(v) on gradient elements near its eps turns
    fp32 rounding into parameter differences, so steps 2 and later are held
    at the drift limits MESH_DRIFT_REL (metrics) and MESH_DRIFT_PARAM
    (parameters after the last step), which the run itself checks from both
    sides: the witness (witness_steps: alone with every sum over rays in
    another order, no other change) must stay within step 1's tolerances
    and the drift limits, and each planted fault of MESH_FAULTS, run by the
    same two ranks, must exceed a drift limit. ms/step of two processes
    time-slicing one card, gloo staging through the host: a record, not a
    speed number. -> measurements."""
    import pickle

    alone = {name: mesh_steps(torch, config, None)
             for name, config in MESH_CONFIGS.items()}
    witness = witness_steps(torch)
    port = _free_port()
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.pkl") for r in range(2)]
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--mesh-rank", str(r),
             str(port), outs[r]], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(2)]
        try:
            logs = [p.communicate(timeout=600)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise AssertionError(f"mesh rank {r} failed:\n{log[-4000:]}")
        ranks = []
        for path in outs:
            with open(path, "rb") as f:
                ranks.append(pickle.load(f))
    result, failed = {}, []
    for name in MESH_CONFIGS:
        a, b, ref = ranks[0][name], ranks[1][name], alone[name]
        bit_equal = all(np.array_equal(x, y) for key in ("params1", "params")
                        for x, y in zip(a[key], b[key]))
        d, w = _distances(a, ref), _distances(witness[name], ref)
        faults = {f: _distances(ranks[0]["faults"][name, f], ref)
                  for f in MESH_FAULTS}
        r = dict(
            ranks_params_bit_equal=bit_equal, **d, witness=w,
            faults={f: dict(v, caught=not _later_ok(v))
                    for f, v in faults.items()},
            losses=[m["loss"] for m in a["metrics"]],
            launches_rank0=a["launches"], launches_rank1=b["launches"],
            launches_witness=witness[name]["launches"],
            collectives_rank0=ranks[0]["collectives"][name],
            first_step_s_ranks=[a["first_step_s"], b["first_step_s"]],
            first_step_s_alone=ref["first_step_s"],
            ms_per_step_ranks=[a["ms_per_step"], b["ms_per_step"]],
            ms_per_step_alone=ref["ms_per_step"])
        result[name] = r

        def later(v):
            return (f"metrics rel {max(v['metrics_max_rel_diff_by_step'][1:]):.2e}"
                    f", params {v['params_last']:.2e} x scale")

        rel = d["metrics_max_rel_diff_by_step"]
        print(f"  {name}: ranks' params bit-equal {bit_equal}; step 1 vs "
              f"alone: metrics rel {rel[0]:.2e} (tol 1e-5), grads "
              f"{d['grads_step1']:.2e} x scale (tol {GRAD_TOL}), params "
              f"{d['params_step1']:.2e} x scale (tol {MESH_PARAM_TOL}); "
              f"steps 2-{MESH_STEPS} (limits {MESH_DRIFT_REL} / "
              f"{MESH_DRIFT_PARAM}): two ranks {later(d)}; witness (rays "
              f"permuted, alone; step 1 metrics rel "
              f"{w['metrics_max_rel_diff_by_step'][0]:.2e}, grads "
              f"{w['grads_step1']:.2e}) {later(w)}; "
              + "; ".join(f"planted {f}: {later(v)}, caught "
                          f"{r['faults'][f]['caught']}"
                          for f, v in faults.items())
              + f"; collectives/rank {r['collectives_rank0']}; launches/rank "
              f"{a['launches']}; ms/step after the first: two ranks "
              f"{a['ms_per_step']:.1f} / {b['ms_per_step']:.1f}, alone "
              f"{ref['ms_per_step']:.1f} on {smi}")
        for launches in (a["launches"], b["launches"],
                         witness[name]["launches"]):
            expect_counts(launches, MESH_STEPS, launch_keys("fused_mlp", "float32"))
        if not (bit_equal and _step1_ok(d) and _later_ok(d) and _step1_ok(w)
                and _later_ok(w)
                and all(v["caught"] for v in r["faults"].values())):
            failed.append(name)
    if failed:
        raise AssertionError(f"two gloo ranks differ from one card, or the "
                             f"drift limits do not separate the witness from "
                             f"the planted faults: "
                             f"{ {k: result[k] for k in failed} }")
    return result


def read_records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def write_demo_scene(scene_dir):
    """The 80x80 demo scene, written by the port's writer as
    configs/demo.txt's header says -> seconds it took."""
    from benerf_tpu_torch.data import synthetic

    t0 = time.perf_counter()
    synthetic.write_benerf_blender_scene(scene_dir, H=80, W=80)
    return time.perf_counter() - t0


def demo_argv(scene_dir, logdir, **flags):
    """CLI arguments of configs/demo.txt, unchanged but for its paths and
    `flags` (name -> value)."""
    argv = ["--config", str(DEMO), "--datadir", scene_dir, "--logdir", logdir]
    for k, v in flags.items():
        argv += [f"--{k}", str(v)]
    return argv


def train_rays_per_sec(recs, cfg):
    """Median of the loop's rays_per_sec records over the console windows
    that hold train steps alone -> (rays/s, ms/iter, windows). A record at step b covers the steps after
    the one before it, a; the eval, video and checkpoint of a step s run
    after its record, so a window holds them for every s in [a, b). Step 0,
    a run's start and a resume (at a checkpoint) are such s, so no window
    holds a warm-up."""
    periods = [p for p in (cfg.render_image_iter, cfg.render_video_iter,
                           cfg.save_model_iter) if p > 0]
    rates, a = [], 0
    for r in recs:
        if "rays_per_sec" in r:
            if not any(s % p == 0 for s in range(a, r["step"]) for p in periods):
                rates.append(r["rays_per_sec"])
            a = r["step"]
    if not rates:
        raise AssertionError("no console window holds train steps alone")
    rays_s = statistics.median(rates)
    rays = 2 * cfg.sampling_event_rays + cfg.num_interpolated_pose * (
        cfg.sampling_rgb_rays // cfg.num_interpolated_pose)
    return rays_s, 1e3 * rays / rays_s, len(rates)


def run_demo(torch, smi, root, device=None):
    """configs/demo.txt through the CLI, as a user runs it: the scene written
    by the port's writer (80x80, as the config's header says), DEMO_ITERS
    iterations with evals and checkpoints at DEMO_ITERS / 2 and DEMO_ITERS
    and the video at DEMO_ITERS, then resumed for DEMO_RESUME iterations;
    then one periodic eval of the final state timed alone. Checks the launch
    counts (K1/K2 in fp32 mode on every train MLP call, K1 alone on every
    eval chunk, no K3/K4, no plain route), the run directory and the
    resumed state -> {measurements, launch counts per path}. The scene and
    the run directory stay under `root` (phase 11 reads them). device: None
    runs where the CLI puts a run, the card."""
    from benerf_tpu_torch.cli import train as cli
    from benerf_tpu_torch.core.config import config_from_cli
    from benerf_tpu_torch.data import datasets
    from benerf_tpu_torch.eval import io as io_mod
    from benerf_tpu_torch.models import bridge
    from benerf_tpu_torch.render import renderer
    from benerf_tpu_torch.train import checkpoint, loop
    from benerf_tpu_torch.train import step as step_mod

    fwd, bwd, kept = launch_keys("fused_mlp", "float32")
    scene_dir = f"{root}/demo"
    write_s = write_demo_scene(scene_dir)
    print(f"  scene written by the port's writer in {write_s:.1f} s")
    argv = demo_argv(scene_dir, f"{root}/logs", max_iter=DEMO_ITERS,
                     render_image_iter=DEMO_ITERS // 2,
                     save_model_iter=DEMO_ITERS // 2,
                     render_video_iter=DEMO_ITERS)
    cfg = config_from_cli(argv)
    run = Path(root) / "logs" / "0"
    chunks = -(-DEMO_PIXELS // cfg.chunk)
    eval_k1 = cfg.num_interpolated_pose * chunks * 2
    video_k1 = 90 * chunks * 2

    reset_counts()
    graphs = dict(step_mod.GRAPHS)
    t0 = time.perf_counter()
    state = cli.main(argv, device=device)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    run_counts = counts()
    # dispatches of gcd(100, 150, 300, 150) = 50 steps: one capture
    expect_graphs(graphs, 1, DEMO_ITERS - 1)
    want = {k: 0 for k in run_counts}
    want[fwd] = 2 * DEMO_ITERS + 2 * eval_k1 + video_k1
    want[bwd] = want[kept] = 2 * DEMO_ITERS
    if run_counts != want:
        raise AssertionError(f"demo run: counts {run_counts}, expected {want}")

    reset_counts()
    graphs = dict(step_mod.GRAPHS)
    resumed = cli.main(argv + ["--load_checkpoint", "True", "--max_iter",
                               str(DEMO_ITERS + DEMO_RESUME)], device=device)
    torch.cuda.synchronize()
    resume_counts = counts()
    expect_graphs(graphs, 0, 0)  # 20 < 50 steps left: single steps
    want = {k: 2 * DEMO_RESUME if k in (fwd, bwd, kept) else 0
            for k in resume_counts}
    if resume_counts != want or resumed.step != DEMO_ITERS + DEMO_RESUME:
        raise AssertionError(f"resume: counts {resume_counts}, expected "
                             f"{want}; step {resumed.step}")

    # the checkpoint the resume started from holds the first run's state
    dev = device or "cuda"
    saved = checkpoint.restore(str(run), step_mod.init_state(
        cfg, cfg.seed + 1, device=dev), step=DEMO_ITERS, device=dev)
    pairs = list(zip(bridge.tree_leaves(saved.params),
                     bridge.tree_leaves(state.params)))
    for g_s, g_r in zip(saved.optimizer.param_groups,
                        state.optimizer.param_groups):
        for a, b in zip(g_s["params"], g_r["params"]):
            sa, sb = saved.optimizer.state[a], state.optimizer.state[b]
            pairs += [(sa[k], sb[k]) for k in ("exp_avg", "exp_avg_sq", "step")]
    if saved.step != DEMO_ITERS or not all(torch.equal(a, b) for a, b in pairs):
        raise AssertionError("the checkpoint differs from the state it saved")

    recs = read_records(run / "metrics.jsonl")
    steps = [r["step"] for r in recs if "train_loss" in r]
    if steps != list(range(1, DEMO_ITERS + DEMO_RESUME + 1)):
        raise AssertionError(f"train records at steps {steps[:3]}...{steps[-3:]}")
    if not all(np.isfinite(r["train_loss"]) for r in recs if "train_loss" in r):
        raise AssertionError("a non-finite train loss")
    evals = [r for r in recs if "test_mid_psnr" in r]
    keys = ("test_mid_psnr", "test_mid_ssim", "pose_ate_rmse",
            "pose_flow_rmse_px", "gt_flow_rms_px")
    if ([r["step"] for r in evals] != [DEMO_ITERS // 2, DEMO_ITERS]
            or not all(np.isfinite(r[k]) for r in evals for k in keys)):
        raise AssertionError(f"eval records {evals}")
    if (run / "config.txt").read_bytes() != DEMO.read_bytes() or not (
            run / "args.txt").is_file():
        raise AssertionError("run directory: config.txt or args.txt")
    for step in (DEMO_ITERS // 2, DEMO_ITERS):
        poses = np.loadtxt(run / "poses_test" / f"poses_test_{step:06d}.txt")
        pngs = list((run / "images_test" / f"img_test_{step:06d}").glob(
            "test*.png"))
        n = cfg.num_interpolated_pose
        if poses.shape != (n, 12) or len(pngs) != n:
            raise AssertionError(
                f"eval files at {step}: {poses.shape}, {len(pngs)} images")
    video = run / f"0_spiral_{DEMO_ITERS:06d}_rgb.mp4"
    frames = list((run / f"0_spiral_{DEMO_ITERS:06d}_rgb_frames").glob("*.png"))
    if not video.is_file() and len(frames) != 90:
        raise AssertionError(f"video: no mp4 and {len(frames)} frames")
    ckpts = sorted(p.name for p in run.glob("*.ckpt.npz"))
    if ckpts != [f"{DEMO_ITERS // 2:06d}.ckpt.npz", f"{DEMO_ITERS:06d}.ckpt.npz"]:
        raise AssertionError(f"checkpoints {ckpts}")

    # one periodic eval of the resumed state, timed alone
    scene = datasets.load_scene(scene_dir, cfg, device=dev)
    K_render = loop.intrinsics(cfg)[2]
    logger = io_mod.JsonlLogger(None)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, results = loop.periodic_eval(
        resumed.params, cfg, scene, renderer.RenderSettings.from_config(cfg),
        K_render, 80, 80, f"{root}/eval", DEMO_ITERS + DEMO_RESUME, logger,
        dev)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    eval_counts = counts()
    want = {k: eval_k1 if k == fwd else 0 for k in eval_counts}
    if eval_counts != want or not np.isfinite(results["test_mid_psnr"]):
        raise AssertionError(f"eval: counts {eval_counts}, expected {want}")

    rays_s, ms_iter, windows = train_rays_per_sec(recs, cfg)
    out = dict(write_s=write_s, run_s=run_s, rays_per_sec=rays_s,
               ms_per_iter=ms_iter, rate_windows=windows,
               eval_s=eval_s,
               evals={r["step"]: {k: r[k] for k in keys} for r in evals},
               final_eval=results)
    print(f"  {DEMO_ITERS} + {DEMO_RESUME} iterations: {out['ms_per_iter']:.2f} "
          f"ms/iter, {rays_s:,.0f} rays/s (median of {windows} console windows "
          f"without eval, video or checkpoint); run {run_s:.1f} s; "
          f"one periodic eval ({cfg.num_interpolated_pose} frames) {eval_s:.2f} s; "
          f"on {smi}")
    for step, r in out["evals"].items():
        print(f"  eval at {step}: PSNR {r['test_mid_psnr']:.2f} dB, SSIM "
              f"{r['test_mid_ssim']:.4f}, pose flow {r['pose_flow_rmse_px']:.3f} "
              f"px of {r['gt_flow_rms_px']:.3f}, ATE {r['pose_ate_rmse']:.2e}")
    print(f"  launches: run {run_counts}, resume {resume_counts}, one eval "
          f"{eval_counts}")
    return out, {"demo_run": run_counts, "demo_resume": resume_counts,
                 "demo_periodic_eval": eval_counts}


def run_inference(torch, root, smi):
    """Phase 11: the inference and evaluation CLIs on phase 9's run
    directory under `root`. cli.test.main from the checkpoint at DEMO_ITERS
    (KITTI poses, num_render_images images, the 90-frame video) with the
    launch counts checked: K1 alone, 2 a chunk of every frame; then
    cli.evaluate.evaluate of the periodic eval images at DEMO_ITERS / 2
    against those at DEMO_ITERS, equal to eval/metrics over the same
    decoded PNGs -> (measurements, K1 launches)."""
    from benerf_tpu_torch.cli import evaluate as cli_evaluate
    from benerf_tpu_torch.cli import test as cli_test
    from benerf_tpu_torch.core.config import config_from_cli
    from benerf_tpu_torch.data import png
    from benerf_tpu_torch.eval import metrics

    argv = demo_argv(f"{root}/demo", f"{root}/logs", checkpoint=DEMO_ITERS,
                     extract_poses=True, render_images=True, render_video=True)
    cfg = config_from_cli(argv)
    chunks = -(-DEMO_PIXELS // cfg.chunk)
    want = {k: 0 for k in counts()}
    want["fused_mlp_fwd"] = (cfg.num_render_images + 90) * chunks * 2
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cli_test.main(argv)
    torch.cuda.synchronize()
    test_s = time.perf_counter() - t0
    got = counts()
    if got != want:
        raise AssertionError(f"cli.test: counts {got}, expected {want}")
    out = Path(root) / "logs" / "0" / "test_results"
    poses = np.loadtxt(out / "poses_test" / f"poses_test_{DEMO_ITERS:06d}.txt")
    pngs = list((out / "image_test" / f"img_test_{DEMO_ITERS:06d}").glob("test*.png"))
    frames = list((out / f"0_spiral_{DEMO_ITERS:06d}_rgb_frames").glob("*.png"))
    video = out / f"0_spiral_{DEMO_ITERS:06d}_rgb.mp4"
    if (poses.shape != (cfg.num_extract_poses, 12) or not np.all(np.isfinite(poses))
            or len(pngs) != cfg.num_render_images
            or not (video.is_file() or len(frames) == 90)):
        raise AssertionError(f"cli.test files: poses {poses.shape}, {len(pngs)} "
                             f"images, {len(frames)} video frames")

    run = Path(root) / "logs" / "0" / "images_test"
    res, gt = (run / f"img_test_{s:06d}" for s in (DEMO_ITERS // 2, DEMO_ITERS))
    t0 = time.perf_counter()
    summary = cli_evaluate.evaluate(str(res), str(gt))
    evaluate_s = time.perf_counter() - t0

    def decoded(d):
        return [png.read(str(f)) / 255.0 for f in sorted(d.glob("*.png"))]

    pairs = list(zip(decoded(res), decoded(gt)))
    ref = {"psnr": float(np.mean([metrics.psnr(a, b) for a, b in pairs])),
           "ssim": float(np.mean([metrics.ssim(a, b) for a, b in pairs]))}
    if (len(pairs) != cfg.num_interpolated_pose
            or {k: summary[k] for k in ref} != ref
            or not all(np.isfinite(v) for v in summary.values())):
        raise AssertionError(f"cli.evaluate: {summary}, eval/metrics {ref} over "
                             f"{len(pairs)} pairs")
    print(f"  cli.test from the checkpoint at {DEMO_ITERS}: {test_s:.2f} s for "
          f"{cfg.num_extract_poses} poses, {cfg.num_render_images} images and "
          f"90 video frames; launches {got}")
    print(f"  cli.evaluate, evals at {DEMO_ITERS // 2} vs {DEMO_ITERS} "
          f"({len(pairs)} pairs): {summary} in {evaluate_s:.2f} s, equal to "
          f"eval/metrics; on {smi}")
    return (dict(test_s=test_s, evaluate_s=evaluate_s, evaluate=summary),
            got["fused_mlp_fwd"])


def run_quality_gates(torch, smi):
    """Phase 12: eval/quality.run_quality on the card at the two
    configurations of the JAX package's slow recovery tests
    (tests/test_train.py test_pose_recovery_regression and
    test_motion_scale_recovery_gate), use_pallas at its default so the
    kernels run, held to those tests' bounds; the K1/K2 launches and the
    captured graphs counted; BRISQUE features of the final mid frame; K1
    and K2 against the plain version at this phase's shapes ->
    ({name: summary}, {name: launches}, K1 errors, K2 errors, K2 per-point
    elements outside the bound), the errors keyed by "R x S"."""
    from benerf_tpu_torch.data import png
    from benerf_tpu_torch.eval import brisque, quality
    from benerf_tpu_torch.train import step as step_mod

    small = dict(evals=2, H=32, W=32, seed=0, target_blur_px=6.0,
                 sampling_event_rays=128, sampling_rgb_rays=95,
                 num_interpolated_pose=5, N_samples=16, N_importance=16)
    runs = {"gt_init_0.35": dict(iters=220, init_from_gt=0.35,
                                 console_log_iter=110),
            "motion_scale": dict(iters=400, pose_init="motion_scale",
                                 console_log_iter=200)}
    out, launches = {}, {}
    with tempfile.TemporaryDirectory() as root:  # one scene, a run-NNN each
        for name, kw in runs.items():
            iters = kw["iters"]
            reset_counts()
            graphs = dict(step_mod.GRAPHS)
            art = quality.run_quality(root, **small, **kw)
            got = counts()
            expect_graphs(graphs, 1, iters - 1)
            evals_k1 = small["evals"] * small["num_interpolated_pose"] * 2
            want = {k: 0 for k in got}
            want["fused_mlp_fwd"] = 2 * iters + evals_k1
            want["fused_mlp_bwd"] = want["fused_mlp_fwd_kept"] = 2 * iters
            if got != want:
                raise AssertionError(f"quality {name}: counts {got}, expected {want}")
            first, final = art["checkpoints"][0], art["checkpoints"][-1]
            gt_motion = art["baseline"]["gt_flow_rms_px"]
            flow = final["pose_flow_rmse_px"]
            print(f"  {name}: {iters} iterations in {art['wall_s']} s; pose flow "
                  f"{art['baseline']['pose_flow_rmse_px']:.3f} (init) -> "
                  f"{first['pose_flow_rmse_px']:.3f} -> {flow:.3f} px of "
                  f"{gt_motion:.3f}; PSNR {first['test_mid_psnr']:.2f} -> "
                  f"{final['test_mid_psnr']:.2f} dB (blurry input "
                  f"{art['baseline']['blurry_input_psnr']:.2f}); gates "
                  f"{art['passed']}; launches {got}")
            # the bounds of the JAX package's slow tests
            if name == "gt_init_0.35":
                ok = np.isfinite(flow) and flow < 0.25 * gt_motion
            else:
                ok = (flow < 0.65 * gt_motion and final["test_mid_psnr"]
                      > first["test_mid_psnr"] + 3.0)
            if not ok:
                raise AssertionError(f"quality {name}: first {first}, final "
                                     f"{final}, gt motion {gt_motion}")
            mid = (Path(art["run_dir"]) / "0" / "images_test"
                   / f"img_test_{iters:06d}"
                   / f"test{small['num_interpolated_pose'] // 2:03d}.png")
            img = png.read(str(mid)) / 255.0
            feats = brisque.features(img)
            score = brisque.score(img)
            no_model = "BENERF_BRISQUE_MODEL" not in os.environ
            if (feats.shape != (36,) or not np.all(np.isfinite(feats))
                    or (no_model and score is not None)):
                raise AssertionError(f"BRISQUE: {feats}, score {score}")
            print(f"  BRISQUE features of the final mid frame: "
                  f"{np.array2string(feats, precision=4, max_line_width=200)}; "
                  f"score {score}")
            out[name] = dict(wall_s=art["wall_s"], baseline=art["baseline"],
                             checkpoints=art["checkpoints"], passed=art["passed"],
                             brisque_features=feats.tolist(), brisque_score=score)
            launches[f"quality_{name}"] = got
    print(f"  on {smi}")
    # the shapes K1/K2 saw above: a step renders both ray families in one
    # coarse and one fine pass; an eval frame (H x W <= cfg.chunk) is one
    # chunk, forward only
    P = small["num_interpolated_pose"]
    step_rays = (2 * small["sampling_event_rays"]
                 + small["sampling_rgb_rays"] // P * P)
    samples = (small["N_samples"], small["N_samples"] + small["N_importance"])
    print(f"  K1/K2 vs plain at this phase's shapes: {step_rays} rays a step, "
          f"{small['H'] * small['W']} an eval frame, x {samples} points")
    k1_err, k2_err, k2_outside = {}, {}, {}
    for S in samples:
        for R in (step_rays, small["H"] * small["W"]):
            e, scale = check_fwd(torch, "K1/K2", R, S, 3, False)
            k1_err[f"{R}x{S}"] = (e, e / scale)
        e, rel, k2_outside[f"{step_rays}x{S}"], _ = check_bwd(
            torch, "K1/K2", step_rays, S, 3, False)
        k2_err[f"{step_rays}x{S}"] = (e, rel)
    return out, launches, k1_err, k2_err, k2_outside


def run_bench(torch, smi):
    """Phase 14: the bench entry point in both modes, then the breakdown
    tool in fp32 mode -> ({mode: the bench's line, launches, steps, wall s},
    the breakdown's result)."""
    from benerf_tpu_torch.cli import bench
    from benerf_tpu_torch.train import step as step_mod

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tools"))
    import torch_perf_breakdown

    out = {}
    with tempfile.TemporaryDirectory() as prof_dir:
        for cd in ("float32", "bfloat16"):
            argv = ["--dtype", cd, "--inner", str(BENCH_INNER),
                    "--chunks", str(BENCH_CHUNKS)]
            # the untimed dispatch, the profiled one (fp32), the timed ones
            dispatches = 1 + BENCH_CHUNKS
            if cd == "float32":
                argv += ["--profile", prof_dir]
                dispatches += 1
            steps = BENCH_INNER * dispatches
            reset_counts()
            graphs = dict(step_mod.GRAPHS)
            t0 = time.perf_counter()
            line = bench.main(argv)
            wall = time.perf_counter() - t0
            launches = counts()
            expect_counts(launches, steps, launch_keys("fused_mlp", cd))
            expect_graphs(graphs, 1, steps - 1)
            if (line["model_flops_per_iter"] != BENCH_FLOPS
                    or line["card"] != smi or line["platform"] != "cuda"
                    or line["compute_dtype"] != cd
                    or not np.isfinite(line["value"])):
                raise AssertionError(f"bench line {line}")
            out[cd] = {**line, "launches": launches, "steps": steps,
                       "wall_s": wall}
            print(f"  {cd}: {line['ms_per_iter']:.2f} ms/iter, "
                  f"{line['value']:,.0f} rays/s, {line['delivered_tflops']:.2f}"
                  f" TFLOP/s, mfu_vs_bf16_peak {line['mfu_vs_bf16_peak']:.4f};"
                  f" {steps} steps, launches {launches}, {wall:.1f} s")
        top = (Path(prof_dir) / "top_ops.md").read_text()
        if ("fmlp::" not in top
                or not (Path(prof_dir) / "trace.json").stat().st_size):
            raise AssertionError(f"--profile: no fmlp:: kernel in top_ops.md "
                                 f"or no trace:\n{top}")
        out["top_ops_md"] = top.splitlines()[:14]
    t0 = time.perf_counter()
    # STEP_MEASURED: the fp32 bench's profiled step
    breakdown = torch_perf_breakdown.main(["--reps", str(BREAKDOWN_REPS)],
                                          step=out["float32"])
    breakdown["wall_s"] = time.perf_counter() - t0
    if not breakdown["device_share_of_step"] >= BREAKDOWN_SHARE:
        raise AssertionError(
            f"the breakdown's production rows cover "
            f"{breakdown['device_share_of_step']:.3f} of the step's device "
            f"busy, under {BREAKDOWN_SHARE}")
    return out, breakdown


def check_routes(torch):
    """Routes on the card: the plain route where the JAX package has no
    kernel (counted, no kernel launched); bf16 launches K1 in bf16 mode on
    the fused route and K3 in bf16 mode on the staged one."""
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
    reset_counts()
    out = mlp.mlp_forward(l6, pts, vd, compute_dtype="bfloat16", num_freqs_views=6)
    bf = counts()
    want = {k: 1 if k == "staged_mlp_fwd_bf16" else 0 for k in bf}
    if bf != want or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"bf16 on the staged route: counts {bf}, expected {want}")
    print(f"  staged route: bf16 runs K3 in bf16 mode, counts {bf}")
    print(f"  width 128 and no viewdirs: plain route, counts {got}")


def _bound(flops, peak, nbytes):
    """(bound ms, "operations" or "bytes")."""
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def _per_n_fused(torch, compute_dtype, C=3):
    """K1/K2 in one mode at both training n: times, plain times, bounds.
    Forward bytes: pts, viewdirs, outputs, weights; backward adds the
    cotangent, d pts, d viewdir per point and the weight gradients.
    Operations: 1x (K1) and 2x (K2: the data and the weight gradients, on
    the forward K1 kept) the forward's FLOP, at the tensor-core rate of the
    mode (TC_PEAK) for the bound and at FP32_PEAK for the CUDA-core bound
    beside it. K1 keeping its forward (fwd_kept_*, the train path's launch)
    writes the kept part of K2's scratch besides. K2's scratch, its own part
    written and read back and K1's read (mlp_kernels.scratch_bytes), is its
    design's own floor (bwd_scratch_floor_ms), not part of the bound. K2's
    weight-gradient pass is timed alone too, beside torch.matmul of its
    products (its `library_ms`); its byte bound counts the scratch, which is
    its input."""
    from benerf_tpu_torch.ops import mlp_kernels

    flops_pt = flops_fwd_per_point()
    weights = mlp_kernels.packed_size(C)
    peak = TC_PEAK[compute_dtype]
    out = {}
    for S in (64, 128):
        n = RAYS * S
        n_pad = -(-n // mlp_kernels.TILE) * mlp_kernels.TILE
        kf, pf, kb, pb, kk = time_kernels(torch, S, C, compute_dtype)
        bytes_f = (n * (3 + C + 1) + RAYS * 3 + weights) * 4
        bytes_b = bytes_f + (n * (C + 1 + 3 + 3) + weights) * 4
        kept = mlp_kernels.scratch_bytes(n_pad, C, True, compute_dtype, "kept")
        own = mlp_kernels.scratch_bytes(n_pad, C, True, compute_dtype, "backward")
        flops = flops_pt * n
        d = dict(fwd_ms=kf, fwd_plain_ms=pf, bwd_ms=kb, bwd_plain_ms=pb,
                 fwd_kept_ms=kk,
                 fwd_fp32_core_bound_ms=flops / FP32_PEAK * 1e3,
                 bwd_fp32_core_bound_ms=2 * flops / FP32_PEAK * 1e3,
                 bwd_scratch_floor_ms=(2 * own + kept) / HBM_BYTES_S * 1e3)
        d["fwd_bound_ms"], d["fwd_bound_by"] = _bound(flops, peak, bytes_f)
        d["fwd_kept_bound_ms"], d["fwd_kept_bound_by"] = _bound(
            flops, peak, bytes_f + kept)
        d["bwd_bound_ms"], d["bwd_bound_by"] = _bound(2 * flops, peak, bytes_b)
        wline = _wgrad_per_n(torch, d, n, C, compute_dtype, True, peak, weights)
        tline = _tile_per_n(torch, d, n, C, compute_dtype, True, peak, flops)
        out[n] = d
        print(f"  {MODE_NAME[compute_dtype]} n={n}: K1 {kf:.3f} ms (plain {pf:.3f}, "
              f"bound {d['fwd_bound_ms']:.3f}, fp32-core bound "
              f"{d['fwd_fp32_core_bound_ms']:.3f}), keeping its forward "
              f"{kk:.3f} (bound {d['fwd_kept_bound_ms']:.3f} "
              f"{d['fwd_kept_bound_by']}); K2 on it {kb:.3f} ms (plain "
              f"fwd+bwd {pb:.3f}, bound {d['bwd_bound_ms']:.3f} "
              f"{d['bwd_bound_by']}, fp32-core {d['bwd_fp32_core_bound_ms']:.3f}, "
              f"scratch floor {d['bwd_scratch_floor_ms']:.3f}); its {tline}; its "
              f"{wline}")
    return out


def _per_n_staged(torch, compute_dtype, C=3):
    """K3/K4 in one mode at both training n: times, plain times, bounds.
    Forward bytes are pts, the per-ray view bias, the outputs and the
    weights; backward adds the cotangent, d pts, the bias gradient and the
    weight gradients. Operations: 1x (K3) and 3x (K4) the forward's FLOP,
    at the tensor-core rate of the mode, with the fp32 CUDA-core bound
    beside it. K4's scratch (mlp_kernels.scratch_bytes each way) is its
    design's own floor (bwd_scratch_floor_ms), as K2's; its weight-gradient
    pass (K4's job table) is timed alone as K2's."""
    from benerf_tpu_torch.ops import mlp_kernels

    flops_pt = flops_fwd_per_point(views_ch=0)
    weights = mlp_kernels.packed_size(C, view_pe=False)
    peak = TC_PEAK[compute_dtype]
    out = {}
    for S in (64, 128):
        n = RAYS * S
        n_pad = -(-n // mlp_kernels.TILE) * mlp_kernels.TILE
        kf, pf, kb, pb = time_staged_kernels(torch, S, C, compute_dtype)
        view = RAYS * 128
        bytes_f = (n * (3 + C + 1) + view + weights) * 4
        bytes_b = bytes_f + (n * (C + 1 + 3) + view + weights) * 4
        flops = flops_pt * n
        d = dict(fwd_ms=kf, fwd_plain_ms=pf, bwd_ms=kb, bwd_plain_ms=pb,
                 fwd_fp32_core_bound_ms=flops / FP32_PEAK * 1e3,
                 bwd_fp32_core_bound_ms=3 * flops / FP32_PEAK * 1e3,
                 bwd_scratch_floor_ms=2 * mlp_kernels.scratch_bytes(
                     n_pad, C, False, compute_dtype) / HBM_BYTES_S * 1e3)
        d["fwd_bound_ms"], d["fwd_bound_by"] = _bound(flops, peak, bytes_f)
        d["bwd_bound_ms"], d["bwd_bound_by"] = _bound(3 * flops, peak, bytes_b)
        wline = _wgrad_per_n(torch, d, n, C, compute_dtype, False, peak, weights)
        tline = _tile_per_n(torch, d, n, C, compute_dtype, False, peak, flops)
        out[n] = d
        print(f"  {MODE_NAME[compute_dtype]} n={n}: K3 {kf:.3f} ms (plain "
              f"{pf:.3f}, bound {d['fwd_bound_ms']:.3f}, fp32-core bound "
              f"{d['fwd_fp32_core_bound_ms']:.3f}); K4 {kb:.3f} ms (plain "
              f"fwd+bwd {pb:.3f}, bound {d['bwd_bound_ms']:.3f} "
              f"{d['bwd_bound_by']}, fp32-core {d['bwd_fp32_core_bound_ms']:.3f}, "
              f"scratch floor {d['bwd_scratch_floor_ms']:.3f}); its {tline}; its "
              f"{wline}")
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


def _tile_line(per_n):
    """The tile pass of a K2 or K4 entry (pass (a), csrc/wgmma_layer.cuh
    through fused_mlp_bwd_common.cuh `tile_pass`) timed alone: per training
    n its time and bound."""
    return dict(
        source="benerf_tpu_torch/csrc/fused_mlp_bwd_common.cuh",
        per_call={str(n): {k: v for k, v in d.items() if k.startswith("tile")}
                  for n, d in per_n.items()})


def _wgrad_line(per_n, vs_f64, mode):
    """The weight-gradient pass of a K2 or K4 entry (csrc/wgrad_wgmma.cuh):
    per training n its time, operation and byte bounds beside torch.matmul
    of the same products (fp32, TF32, and in bf16 mode on bf16 operands),
    and its distance to the float64 product of the same scratch (at the
    ragged n too, splits 32 and 7)."""
    return dict(
        source="benerf_tpu_torch/csrc/wgrad_wgmma.cuh",
        per_call={str(n): {k: v for k, v in d.items() if k.startswith("wgrad")}
                  for n, d in per_n.items()},
        vs_float64={str(n): d[mode] for n, d in vs_f64.items()},
        vs_float64_tolerance=f"{WGRAD_TOL} x max(|float64 product|) per job")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        sys.exit(2)
    from benerf_tpu_torch.core.config import load_config
    from benerf_tpu_torch.data import datasets
    from benerf_tpu_torch.ops import mlp_kernels

    t_main = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. environment + build
    smi = nvidia_smi_line()
    print(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} | {smi}")
    build_s = mlp_kernels.build()
    print(f"    kernel build {build_s:.1f} s")
    for name, log in mlp_kernels.BUILD_LOG.items():
        for line in log.splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(f"    {name}: {line.strip()}")
    spills = kernel_spills(mlp_kernels.BUILD_LOG)
    if spills:
        raise AssertionError(f"kernels spill registers: {spills}")

    # 2. K1/K2 vs plain, at the path's shapes, both modes
    print("[2] the weights' wgmma copies vs their plain version; K1/K2 vs "
          "plain PyTorch (fp32 mode: TF32X3 vs fp32, TF32 off)")
    prep = check_weight_copies(torch)
    k1_err = {RAYS * S: check_fwd(torch, "K1/K2", RAYS, S, 3, False)
              for S in (64, 128)}
    # 5 x 64 fills whole 64-point tiles; 3 x 37 = 111 leaves a ragged tile
    for R, S in ((5, 64), (3, 37)):
        for C in (1, 3, 7):
            for barf in (False, True):
                check_fwd(torch, "K1/K2", R, S, C, barf)
    k2_err, k2_outside = {}, {}
    for S, seed in ((64, 0), (128, 2)):
        err, rel, k2_outside[RAYS * S], _ = check_bwd(
            torch, "K1/K2", RAYS, S, 3, False, seed=seed)
        k2_err[RAYS * S] = (err, rel)
    for R, S in ((5, 64), (3, 37)):
        for C in (1, 3, 7):
            check_bwd(torch, "K1/K2", R, S, C, True)
    for C in (1, 3):  # BARF off, as the shipped configs train (gray: C = 1)
        check_bwd(torch, "K1/K2", 3, 37, C, False)
    for S in (64, 128):  # the gray configs' head at the training shapes
        check_bwd(torch, "K1/K2", RAYS, S, 1, False, seed=S)
    # split-count independence on the fine shape: splits 32 (default) vs 7
    check_splits(torch, "K1/K2", 1e-4)
    print("    K2's weight-gradient pass alone vs float64 of the same scratch")
    wg2 = {n: check_wgrad(torch, True, n) for n in (RAYS * 64, RAYS * 128, 3 * 37)}
    print("    K2's tile pass in bf16 mode: its scratch's fp32 rows and tile sums")
    tile_sums = {"float32": None, "bfloat16": {
        f"{R}x{S}": check_tile_sums(torch, True, R, S) for R, S in SCRATCH_SHAPES}}
    print("    bf16 mode vs nerf.apply with bf16 operands and vs float64")
    bf = {RAYS * S: check_bf16(torch, "K1/K2", RAYS, S, 3, False)
          for S in (64, 128)}
    for R, S in ((5, 64), (3, 37)):
        for C in (1, 3, 7):
            check_bf16(torch, "K1/K2", R, S, C, True)
    for R, S in ((3, 37), (RAYS, 64), (RAYS, 128)):
        check_bf16(torch, "K1/K2", R, S, 1, False)
    print("    K1 keeping its forward (the train path's launch) vs nerf.apply, "
          "its X rows and sign words vs the plain activations")
    k1_kept = {cd: {f"{RAYS * S} C={C}": check_kept(torch, RAYS, S, C, cd, seed=S)
                    for C in (3, 1) for S in (64, 128)}
               for cd in ("float32", "bfloat16")}
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

    # 5. K3/K4 vs plain, view encoding L = 6, both modes
    print("[5] K3/K4 vs plain PyTorch (view encoding L = 6; fp32 mode: "
          "TF32X3 vs fp32, TF32 off)")
    k3_err = {RAYS * S: check_fwd(torch, "K3/K4", RAYS, S, 3, False)
              for S in (64, 128)}
    for R, S in ((5, 64), (3, 37)):
        for C in (1, 3, 8, 127):
            check_fwd(torch, "K3/K4", R, S, C, False)
    k4_err, k4_outside = {}, {}
    for S, seed in ((64, 0), (128, 2)):
        err, rel, k4_outside[RAYS * S], _ = check_bwd(
            torch, "K3/K4", RAYS, S, 3, False, seed=seed)
        k4_err[RAYS * S] = (err, rel)
    for R, S in ((5, 64), (3, 37)):
        for C in (1, 3, 8, 127):
            check_bwd(torch, "K3/K4", R, S, C, False)
    check_splits(torch, "K3/K4", 1e-5)
    print("    K4's weight-gradient pass alone vs float64 of the same scratch")
    wg4 = {n: check_wgrad(torch, False, n) for n in (RAYS * 64, RAYS * 128, 3 * 37)}
    print("    K4's tile pass in bf16 mode: its scratch's fp32 rows and tile sums")
    tile_sums4 = {"float32": None, "bfloat16": {
        f"{R}x{S}": check_tile_sums(torch, False, R, S) for R, S in SCRATCH_SHAPES}}
    print("    bf16 mode vs nerf.apply with bf16 operands and vs float64")
    bf34 = {RAYS * S: check_bf16(torch, "K3/K4", RAYS, S, 3, False)
            for S in (64, 128)}
    for R, S in ((5, 64), (3, 37)):
        for C in (1, 3, 8, 127):
            check_bf16(torch, "K3/K4", R, S, C, False)
    k34 = {cd: _per_n_staged(torch, cd) for cd in ("float32", "bfloat16")}

    # 6. the L = 6 slice, fp32 mode
    print(f"[6] tanabata, multires_views = 6, full width, {L6_ITERS} iterations")
    l6_ms, l6_rays_s, l6_launches, _ = run_l6_slice(torch, scene)
    print(f"  captured dispatches: {l6_ms:.2f} ms/iter, {l6_rays_s:,.0f} rays/s "
          f"({RAYS} rays/iter, last {L6_ITERS - L6_WARMUP - L6_G} iterations) "
          f"on {smi}")

    # 7. the L = 6 slice, bf16 mode
    print(f"[7] tanabata, multires_views = 6, full width, {BF16_ITERS} "
          "iterations, compute_dtype = bfloat16")
    l6bf_ms, l6bf_rays_s, l6bf_launches, _ = run_l6_slice(
        torch, scene, BF16_ITERS, "bfloat16", warmup=BF16_ITERS - 2 * L6_G)
    print(f"  captured dispatches: {l6bf_ms:.2f} ms/iter, {l6bf_rays_s:,.0f} "
          f"rays/s (last {L6_G} iterations) on {smi}")

    # 8. routes on the card
    print("[8] MLP routes on the card")
    check_routes(torch)

    # 9. configs/demo.txt through the CLI: train, eval, save, resume
    print(f"[9] configs/demo.txt through benerf_tpu_torch.cli.train, "
          f"{DEMO_ITERS} + {DEMO_RESUME} iterations, fp32 mode")
    demo_root = tempfile.TemporaryDirectory()  # phase 11 reads its run
    demo, demo_launches = run_demo(torch, smi, demo_root.name)
    print("  K1 vs plain at the eval chunks' shapes (a full chunk and the "
          "frame's last, partial one)")
    k1_eval_err = {R * S: check_fwd(torch, "K1/K2", R, S, 3, False)
                   for R in (EVAL_RAYS, DEMO_PIXELS - EVAL_RAYS)
                   for S in (64, 128)}
    k1_eval = time_eval_k1(torch)

    # 10. the captured dispatch against the uncaptured steps
    print(f"[10] captured dispatch vs uncaptured steps, {CMP_DISPATCHES} x "
          f"{CMP_G} steps from one state and seed, then one dispatch timed")
    capture = {"tanabata": check_capture(torch, scene, 4, smi),
               "tanabata_multires_views_6": check_capture(torch, scene, 6, smi)}

    # 11. cli.test and cli.evaluate on phase 9's run directory
    print(f"[11] benerf_tpu_torch.cli.test from phase 9's checkpoint at "
          f"{DEMO_ITERS}, then cli.evaluate of its evals")
    t0 = time.perf_counter()
    inference, test_k1 = run_inference(torch, demo_root.name, smi)
    demo_root.cleanup()
    print(f"  phase 11: {time.perf_counter() - t0:.1f} s")

    # 12. the quality gates on the card through K1/K2
    print("[12] eval.quality.run_quality at the JAX package's two slow-test "
          "configurations, through K1/K2")
    t0 = time.perf_counter()
    gates, gate_launches, k1_q_err, k2_q_err, k2_q_outside = \
        run_quality_gates(torch, smi)
    gates_s = time.perf_counter() - t0
    print(f"  phase 12: {gates_s:.1f} s")

    # 13. the mesh on one card: one NCCL rank captured, two gloo ranks
    print(f"[13] the mesh on one card: (a) one NCCL rank, {CMP_DISPATCHES} x "
          f"{CMP_G} captured steps vs unmeshed; (b) two gloo ranks, "
          f"{MESH_STEPS} steps vs one process")
    t0 = time.perf_counter()
    mesh = {"one_rank_nccl_tanabata": check_nccl_one_rank(
        torch, scene, smi, capture["tanabata"]["captured_ms_per_iter"])}
    mesh["two_ranks_gloo"] = check_two_ranks_gloo(torch, smi)
    mesh["wall_s"] = time.perf_counter() - t0
    print(f"  phase 13: {mesh['wall_s']:.1f} s")

    # 14. the bench entry point and its step breakdown
    print(f"[14] benerf_tpu_torch.cli.bench in both modes ({BENCH_INNER} x "
          f"{BENCH_CHUNKS} timed steps), then tools/torch_perf_breakdown.py")
    t0 = time.perf_counter()
    bench_lines, breakdown = run_bench(torch, smi)
    print(f"  phase 14: {time.perf_counter() - t0:.1f} s")
    print(f"chip_smoke: {time.perf_counter() - t_main:.1f} s")

    # 15. results
    fwd_tol = f"{FWD_TOL} x max(|plain|, 1)"
    bwd_tol = (f"{GRAD_TOL} x max(|plain grad|, 1) per gradient; per-point "
               f"grads: at most {KINK_FRAC} of elements past it (ReLU kinks)")
    bf_fwd_tol = f"{BF16_FWD_TOL} x max(|plain with bf16 operands|, 1)"
    bf_bwd_tol = (f"distance to float64 (weight grads: worst err/scale; "
                  f"per-point: RMS) between {BF16_GRAD_FLOOR} and "
                  f"{BF16_GRAD_FACTOR} x the plain version's with bf16 "
                  "operands; max_abs_err vs float64")
    k1_eval_err = {n: (e, e / s) for n, (e, s) in k1_eval_err.items()}
    k1_err = {**{n: (e, e / s) for n, (e, s) in k1_err.items()}, **k1_eval_err,
              **k1_q_err}
    k2_err = {**k2_err, **k2_q_err}
    k2_outside = {**k2_outside, **k2_q_outside}
    k3_err = {n: (e, e / s) for n, (e, s) in k3_err.items()}
    k1_bf = {n: (d["fwd_err"], d["fwd_rel"]) for n, d in bf.items()}
    # the keeping launch's errors count in its mode's K1 line too
    for cd, errs in (("float32", k1_err), ("bfloat16", k1_bf)):
        errs.update({f"kept {n}": (d["max_abs_err"], d["max_err_over_scale"])
                     for n, d in k1_kept[cd].items()})
    k2_bf = {n: (d["wgrad_abs_vs_f64"], d["wgrad_vs_f64"]) for n, d in bf.items()}
    k3_bf = {n: (d["fwd_err"], d["fwd_rel"]) for n, d in bf34.items()}
    k4_bf = {n: (d["wgrad_abs_vs_f64"], d["wgrad_vs_f64"]) for n, d in bf34.items()}
    scratch = {cd: {"scratch_floor_ms": k12[cd][RAYS * 128]["bwd_scratch_floor_ms"],
                    "scratch_bytes_per_point": mlp_kernels.scratch_bytes(
                        mlp_kernels.TILE, 3, True, cd) / mlp_kernels.TILE,
                    "tile_sums": tile_sums[cd]}
               for cd in ("float32", "bfloat16")}
    scratch4 = {cd: {"scratch_floor_ms": k34[cd][RAYS * 128]["bwd_scratch_floor_ms"],
                     "scratch_bytes_per_point": mlp_kernels.scratch_bytes(
                         mlp_kernels.TILE, 3, False, cd) / mlp_kernels.TILE,
                     "tile_sums": tile_sums4[cd]}
                for cd in ("float32", "bfloat16")}
    fwd_src, bwd_src = ("benerf_tpu_torch/csrc/fused_mlp_fwd.cu",
                        "benerf_tpu_torch/csrc/fused_mlp_bwd.cu")
    k1_rep = "benerf_tpu/ops/pallas_mlp_t.py:244 _fwd_kernel_t"
    k2_rep = "benerf_tpu/ops/pallas_mlp_t.py:257 _bwd_kernel_t"
    k3_src, k4_src = ("benerf_tpu_torch/csrc/staged_mlp_fwd.cu",
                      "benerf_tpu_torch/csrc/staged_mlp_bwd.cu")
    k3_rep = "benerf_tpu/ops/pallas_mlp.py:155 _fwd_kernel"
    k4_rep = "benerf_tpu/ops/pallas_mlp.py:174 _bwd_kernel"
    path_launches = {**demo_launches, **gate_launches}
    gloo = mesh["two_ranks_gloo"]
    path_launches.update(
        mesh_nccl_one_rank=mesh["one_rank_nccl_tanabata"]["launches"],
        **{f"mesh_gloo_{name}_rank{r}": gloo[name][f"launches_rank{r}"]
           for name in MESH_CONFIGS for r in (0, 1)})
    path_launches["bench"] = bench_lines["float32"]["launches"]
    k1_paths = {"tanabata": launches["fused_mlp_fwd"],
                **{k: v["fused_mlp_fwd"] for k, v in path_launches.items()},
                "cli_test": test_k1}
    k2_paths = {"tanabata": launches["fused_mlp_bwd"],
                **{k: v["fused_mlp_bwd"] for k, v in path_launches.items()}}
    # K1 launches that kept their forward: K2's count on every train path,
    # none in cli.test (run_inference holds every other count at 0)
    kept_paths = {"tanabata": launches["fused_mlp_fwd_kept"],
                  **{k: v["fused_mlp_fwd_kept"] for k, v in path_launches.items()},
                  "cli_test": 0}
    bf_paths = {"tanabata_bf16": bf_launches,
                "bench_bf16": bench_lines["bfloat16"]["launches"]}
    kernels = [
        _kernel_line("K1 fused_mlp_fwd", fwd_src, k1_rep, "tf32x3",
                     sum(k1_paths.values()), k1_err, fwd_tol, k12["float32"],
                     "fwd", launches_by_path=k1_paths,
                     kept_launches_by_path=kept_paths,
                     kept_forward={str(n): d for n, d in k1_kept["float32"].items()},
                     eval_chunk={str(n): {
                         **k1_eval.get(n, {}), "max_abs_err": e,
                         "max_err_over_scale": r}
                         for n, (e, r) in k1_eval_err.items()},
                     quality_shapes={k: {"max_abs_err": e, "max_err_over_scale": r}
                                     for k, (e, r) in k1_q_err.items()},
                     weight_copies=prep["K1/K2 tf32x3"]),
        _kernel_line("K1 fused_mlp_fwd", fwd_src, k1_rep, "bf16",
                     sum(v["fused_mlp_fwd_bf16"] for v in bf_paths.values()),
                     k1_bf, bf_fwd_tol, k12["bfloat16"], "fwd",
                     launches_by_path={k: v["fused_mlp_fwd_bf16"]
                                       for k, v in bf_paths.items()},
                     kept_launches_by_path={k: v["fused_mlp_fwd_kept_bf16"]
                                            for k, v in bf_paths.items()},
                     kept_forward={str(n): d for n, d in k1_kept["bfloat16"].items()},
                     weight_copies=prep["K1/K2 bf16"]),
        _kernel_line("K2 fused_mlp_bwd", bwd_src, k2_rep, "tf32x3",
                     sum(k2_paths.values()), k2_err, bwd_tol, k12["float32"],
                     "bwd", launches_by_path=k2_paths,
                     pointwise_outside_tol={str(n): v for n, v in k2_outside.items()},
                     quality_shapes={k: {"max_abs_err": e, "max_err_over_scale": r}
                                     for k, (e, r) in k2_q_err.items()},
                     weight_gradient_pass=_wgrad_line(k12["float32"], wg2, "tf32x3"),
                     tile_pass=_tile_line(k12["float32"]), **scratch["float32"]),
        _kernel_line("K2 fused_mlp_bwd", bwd_src, k2_rep, "bf16",
                     sum(v["fused_mlp_bwd_bf16"] for v in bf_paths.values()),
                     k2_bf, bf_bwd_tol, k12["bfloat16"], "bwd",
                     launches_by_path={k: v["fused_mlp_bwd_bf16"]
                                       for k, v in bf_paths.items()},
                     bf16_vs_float64={str(n): d for n, d in bf.items()},
                     weight_gradient_pass=_wgrad_line(k12["bfloat16"], wg2, "bf16"),
                     tile_pass=_tile_line(k12["bfloat16"]), **scratch["bfloat16"]),
        _kernel_line("K3 staged_mlp_fwd", k3_src, k3_rep, "tf32x3",
                     l6_launches["staged_mlp_fwd"], k3_err, fwd_tol,
                     k34["float32"], "fwd", weight_copies=prep["K3/K4 tf32x3"]),
        _kernel_line("K3 staged_mlp_fwd", k3_src, k3_rep, "bf16",
                     l6bf_launches["staged_mlp_fwd_bf16"], k3_bf, bf_fwd_tol,
                     k34["bfloat16"], "fwd", weight_copies=prep["K3/K4 bf16"]),
        _kernel_line("K4 staged_mlp_bwd", k4_src, k4_rep, "tf32x3",
                     l6_launches["staged_mlp_bwd"], k4_err, bwd_tol,
                     k34["float32"], "bwd",
                     pointwise_outside_tol={str(n): v for n, v in k4_outside.items()},
                     weight_gradient_pass=_wgrad_line(k34["float32"], wg4, "tf32x3"),
                     tile_pass=_tile_line(k34["float32"]), **scratch4["float32"]),
        _kernel_line("K4 staged_mlp_bwd", k4_src, k4_rep, "bf16",
                     l6bf_launches["staged_mlp_bwd_bf16"], k4_bf, bf_bwd_tol,
                     k34["bfloat16"], "bwd",
                     bf16_vs_float64={str(n): d for n, d in bf34.items()},
                     weight_gradient_pass=_wgrad_line(k34["bfloat16"], wg4, "bf16"),
                     tile_pass=_tile_line(k34["bfloat16"]), **scratch4["bfloat16"]),
    ]
    print(json.dumps({"kernels": kernels, "slices": {
        "tanabata": {"ms_per_iter": ms_iter, "rays_per_sec": rays_s,
                     "iters": ITERS, "launches": launches},
        "tanabata_bf16": {"ms_per_iter": bf_ms, "rays_per_sec": bf_rays_s,
                          "iters": BF16_ITERS, "launches": bf_launches},
        "tanabata_multires_views_6": {
            "ms_per_iter": l6_ms, "rays_per_sec": l6_rays_s,
            "iters": L6_ITERS, "launches": l6_launches},
        "tanabata_multires_views_6_bf16": {
            "ms_per_iter": l6bf_ms, "rays_per_sec": l6bf_rays_s,
            "iters": BF16_ITERS, "launches": l6bf_launches},
        "demo_cli": {**demo, "iters": DEMO_ITERS, "resumed_iters": DEMO_RESUME,
                     "launches": demo_launches},
        "cli_test_evaluate": {**inference, "k1_launches": test_k1},
        "quality_gates": {"wall_s": gates_s, "runs": gates,
                          "launches": gate_launches}},
        "captured_vs_uncaptured": capture, "mesh": mesh,
        "bench": bench_lines, "breakdown": breakdown}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:  # phase 13(b)'s child processes
        run_mesh_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    else:
        main()

"""Staged NeRF MLP on the card: kernels K3 (forward) and K4 (backward).

Port of benerf_tpu/ops/pallas_mlp.py. The TPU pair `_fwd_kernel` /
`_bwd_kernel` becomes two hand-written CUDA C++ kernels for Hopper,
csrc/staged_mlp_fwd.cu (K3) and csrc/staged_mlp_bwd.cu (K4), built and
loaded as K1/K2 are (ops/fused_mlp.py) and tied together by a
torch.autograd.Function. Each .cu file's header says what bounds it and how
its design answers that.

Contract of `staged_nerf_mlp` (the JAX function's): the standard 8x256
trunk with viewdirs, any view-encoding width, C + 1 <= 128, no BARF,
compute_dtype "float32" or "bfloat16"; pts (R, S, 3), viewdirs (R, 3) ->
raw (R, S, C+1).
  - CPU tensors take the plain PyTorch version, models/nerf.apply (bf16
    operands for "bfloat16");
  - CUDA float32 tensors launch the kernels, on wgmma as K1/K2 (K3's
    launch writes the weights' wgmma copies without the view-encoding
    weights, `fused_mlp.prep_table(view_pe=False)`, which K4 reads):
    "float32" in their TF32X3 mode, "bfloat16" in their BF16 mode (bf16
    operands, fp32 accumulation, as the JAX kernel);
  - anything outside the contract raises ValueError on either device,
    including a point encoding whose width does not match w0's 63 rows
    (the JAX kernel pads the encoding by 64 - 63 columns whatever its
    width, reads past a narrower one and returns numbers there).

As in the JAX function, the view branch's own input is a plain product
outside the kernels: vb = vpe @ views.w_pe + views.b, one (128,) row per
ray, so autograd carries its gradient to views.w_pe, views.b and the
viewdirs. In bf16 mode its operands are rounded to bf16 with fp32
accumulation, as K1 treats its view-encoding product (the JAX function
rounds the finished vb instead; both sit well inside the bf16 bounds,
tests/test_torch_tc_mlp.py). The kernels read vb per ray (the JAX kernel
reads a per-point copy). The packing holds the JAX `pack_params` groups
(w0, wh, w5pe, b, wa, wf, bf, wfv, wrgb and the head bias hb as ba, brgb)
in K1's layout without the view-encoding entries:
`fused_mlp.pack_params(params, view_pe=False)`.
"""

from __future__ import annotations

import torch

from benerf_tpu_torch.core import profiling
from benerf_tpu_torch.models import embedder
from benerf_tpu_torch.models import nerf as nerf_mod
from benerf_tpu_torch.ops import fused_mlp
from benerf_tpu_torch.ops.fused_mlp import (DEFAULT_SPLITS, DEPTH, HEAD,
                                            SCRATCH_BYTES, SKIP_LAYER, TILE,
                                            WIDTH, _check, _layout, _lib,
                                            _mode, _offsets, _ptr,
                                            _scratch_report, _stream,
                                            alloc_scratch, check_prep,
                                            launch_key, prep_buffer)

# launches on the card, one per wrapper call that launched its kernel(s),
# by mode as fused_mlp.LAUNCHES
LAUNCHES = {"staged_mlp_fwd": 0, "staged_mlp_bwd": 0,
            "staged_mlp_fwd_bf16": 0, "staged_mlp_bwd_bf16": 0}


def supports(params) -> bool:
    """Standard BeNeRF trunk with viewdirs, any view-encoding width,
    C + 1 <= 128 (pallas_mlp.supports)."""
    try:
        if "views" not in params or len(params["pts"]) != DEPTH:
            return False
        return (tuple(params["pts"][0]["w"].shape) == (63, WIDTH)
                and "w_pe" in params["pts"][SKIP_LAYER]
                and tuple(params["views"]["w_feat"].shape) == (WIDTH, HEAD)
                and params["rgb"]["w"].shape[1] + 1 <= HEAD)
    except (KeyError, IndexError, TypeError):
        return False


def launch_fwd(packed, pts, vb, S, C, compute_dtype="float32", *, prep):
    """K3: pts (n, 3), per-ray view bias vb (n / S, 128) -> raw (n, C+1).
    The launch also writes the weights' wgmma copies into `prep` (a
    `fused_mlp.prep_buffer`), which K4 reads."""
    mode = _mode(compute_dtype)
    n = pts.shape[0]
    if n == 0 or n % S:
        raise ValueError(f"point count {n} is not a positive multiple of S={S}")
    if not 1 <= C < HEAD:
        raise ValueError(f"K3 takes 1 <= C < {HEAD} channels, got {C}")
    _check("packed", packed, (_offsets(_layout(C, False))[-1],))
    _check("pts", pts, (n, 3))
    _check("vb", vb, (n // S, HEAD))
    check_prep(prep, False, compute_dtype)
    lib = _lib("staged_mlp_fwd")
    out = torch.empty((n, C + 1), device=pts.device, dtype=torch.float32)
    rc = lib.staged_mlp_fwd(_ptr(pts), _ptr(vb), n, S, _ptr(packed),
                            _ptr(prep), C, _ptr(out), mode, _stream())
    if rc:
        raise RuntimeError(f"staged_mlp_fwd: CUDA error {rc}")
    LAUNCHES[launch_key("staged_mlp_fwd", compute_dtype)] += 1
    return out


def bwd_scratch(n, C, device, compute_dtype="float32"):
    """K4's scratch for n points and C channels in the format of
    compute_dtype, sized by the library: (a `fused_mlp.Scratch`, the first
    of the 128 rows of d vb per point: of its d in "float32", of its side
    in "bfloat16")."""
    n_pad = -(-n // TILE) * TILE
    sizes = _scratch_report(_lib("staged_mlp_bwd").staged_mlp_bwd_scratch,
                            False, C, compute_dtype, n_pad)
    return alloc_scratch(n_pad, sizes, compute_dtype, device), sizes[4]


def dvb_rows(scr, dvb_row):
    """The (128, n_pad) rows of d vb per point in a K4 scratch."""
    rows = scr.d if scr.side is None else scr.side
    return rows.view(-1, scr.n_pad)[dvb_row:dvb_row + HEAD]


def _bwd_args(packed, pts, vb, g, S, C, compute_dtype, prep):
    """Check K4's inputs; -> (mode, prep, n, scratch, first d vb row,
    dpts)."""
    mode = _mode(compute_dtype)
    n = pts.shape[0]
    _check("packed", packed, (_offsets(_layout(C, False))[-1],))
    _check("pts", pts, (n, 3))
    _check("vb", vb, (n // S, HEAD))
    _check("cotangent", g, (n, C + 1))
    check_prep(prep, False, compute_dtype)
    scr, dvb_row = bwd_scratch(n, C, pts.device, compute_dtype)
    return mode, prep, n, scr, dvb_row, torch.empty((n, 3), device=pts.device)


def launch_bwd(packed, pts, vb, g, S, C, splits=DEFAULT_SPLITS,
               compute_dtype="float32", *, prep):
    """K4: cotangent g (n, C+1) -> (d packed, d pts (n, 3), d vb (n / S,
    128)); prep: the weights' wgmma copies K3's launch wrote."""
    if splits < 1:
        raise ValueError(f"splits must be >= 1, got {splits}")
    mode, prep, n, scr, dvb_row, dpts = _bwd_args(
        packed, pts, vb, g, S, C, compute_dtype, prep)
    lib = _lib("staged_mlp_bwd")
    part = torch.empty((splits, packed.numel()), device=pts.device)
    dpacked = torch.empty_like(packed)
    rc = lib.staged_mlp_bwd(
        _ptr(pts), _ptr(vb), n, S, _ptr(packed), _ptr(prep), _ptr(g), C,
        scr.n_pad, _ptr(scr.x), _ptr(scr.d), _ptr(scr.side), _ptr(scr.bsum),
        _ptr(dpts), _ptr(part), splits, _ptr(dpacked), mode, _stream())
    if rc:
        raise RuntimeError(f"staged_mlp_bwd: CUDA error {rc}")
    key = launch_key("staged_mlp_bwd", compute_dtype)
    LAUNCHES[key] += 1
    SCRATCH_BYTES[key] += scr.nbytes()
    # K4 leaves d vb per point in the scratch's rows [dvb_row, +128) (fp32
    # in both formats); a ray's bias is broadcast over its S samples: sum
    # them
    R = n // S
    dvb_pt = dvb_rows(scr, dvb_row)[:, :n]
    dvb = dvb_pt.unflatten(1, (R, S)).sum(dim=2).t()
    return dpacked, dpts, dvb


def run_tile(packed, pts, vb, g, S, C, compute_dtype="float32", *, prep):
    """K4's tile pass alone (pass (a), for timing it apart; not counted: the
    main path runs it inside K4) -> (its `fused_mlp.Scratch`, d pts)."""
    mode, prep, n, scr, _, dpts = _bwd_args(
        packed, pts, vb, g, S, C, compute_dtype, prep)
    rc = _lib("staged_mlp_bwd").staged_mlp_tile(
        _ptr(pts), _ptr(vb), n, S, _ptr(packed), _ptr(prep), _ptr(g), C,
        scr.n_pad, _ptr(scr.x), _ptr(scr.d), _ptr(scr.side), _ptr(scr.bsum),
        _ptr(dpts), mode, _stream())
    if rc:
        raise RuntimeError(f"staged_mlp_tile: CUDA error {rc}")
    return scr, dpts


class _StagedMLP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, packed, pts, vb, S, C, splits, compute_dtype):
        prep = prep_buffer(False, compute_dtype, pts.device)
        out = launch_fwd(packed, pts, vb, S, C, compute_dtype, prep=prep)
        ctx.save_for_backward(packed, pts, vb, prep)
        ctx.S, ctx.C, ctx.splits, ctx.cd = S, C, splits, compute_dtype
        return out

    @staticmethod
    def backward(ctx, g):
        packed, pts, vb, prep = ctx.saved_tensors
        with profiling.span("mlp.bwd"):
            dpacked, dpts, dvb = launch_bwd(packed, pts, vb, g.contiguous(),
                                            ctx.S, ctx.C, ctx.splits, ctx.cd,
                                            prep=prep)
        return dpacked, dpts, dvb, None, None, None, None


def staged_nerf_mlp(params, pts, viewdirs, *, num_freqs=10, num_freqs_views=4,
                    splits=DEFAULT_SPLITS, compute_dtype="float32"):
    """Drop-in replacement for models.nerf.apply on the standard trunk with
    viewdirs, any view encoding, no BARF. pts: (R, S, 3); viewdirs: (R, 3).
    On the CPU this is the plain version, nerf.apply."""
    _mode(compute_dtype)
    if viewdirs is None or not supports(params):
        raise ValueError("staged_nerf_mlp takes the 8x256 trunk with viewdirs "
                         f"and C + 1 <= {HEAD}; ops/mlp.route picks the "
                         "implementation for anything else")
    rows = params["pts"][0]["w"].shape[0]
    if 3 + 6 * num_freqs != rows:
        raise ValueError(
            f"num_freqs={num_freqs} encodes {3 + 6 * num_freqs} channels but "
            f"w0 has {rows} rows")
    if pts.device.type == "cpu":
        return nerf_mod.apply(
            params, pts, viewdirs, num_freqs=num_freqs,
            num_freqs_views=num_freqs_views,
            compute_dtype=None if compute_dtype == "float32" else torch.bfloat16)
    return _staged(params, pts, viewdirs, num_freqs_views, splits, compute_dtype)


def view_bias(params, viewdirs, num_freqs_views, compute_dtype="float32"):
    """The per-ray view bias vb (R, 128) = vpe @ views.w_pe + views.b, the
    product's operands rounded to bf16 in bf16 mode (fp32 accumulation)."""
    vpe = embedder.positional_encoding(viewdirs, num_freqs_views)
    w = params["views"]["w_pe"]
    if compute_dtype == "bfloat16":
        vpe, w = (t.to(torch.bfloat16).to(torch.float32) for t in (vpe, w))
    return vpe @ w + params["views"]["b"]


def _staged(params, pts, viewdirs, num_freqs_views, splits, compute_dtype):
    """The card path: the per-ray view bias, the packing, K3 and (through
    autograd) K4."""
    R, S, _ = pts.shape
    C = params["rgb"]["w"].shape[1]
    vb = view_bias(params, viewdirs, num_freqs_views, compute_dtype)
    packed = fused_mlp.pack_params(params, view_pe=False)
    out = _StagedMLP.apply(packed, pts.reshape(R * S, 3).contiguous(),
                           vb.contiguous(), S, C, splits, compute_dtype)
    return out.view(R, S, C + 1)

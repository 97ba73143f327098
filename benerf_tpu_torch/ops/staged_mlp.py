"""Staged NeRF MLP on the card: kernels K3 (forward) and K4 (backward).

Port of benerf_tpu/ops/pallas_mlp.py. The TPU pair `_fwd_kernel` /
`_bwd_kernel` becomes two hand-written CUDA C++ kernels for Hopper,
csrc/staged_mlp_fwd.cu (K3) and csrc/staged_mlp_bwd.cu (K4), built and
loaded as K1/K2 are (ops/fused_mlp.py) and tied together by a
torch.autograd.Function. Each .cu file's header says what bounds it and how
its design answers that.

Contract of `staged_nerf_mlp` (the JAX function's): the standard 8x256
trunk with viewdirs, any view-encoding width, C + 1 <= 128, no BARF;
pts (R, S, 3), viewdirs (R, 3) -> raw (R, S, C+1).
  - CPU tensors take the plain PyTorch version, models/nerf.apply;
  - CUDA float32 tensors launch the kernels;
  - anything outside the contract raises ValueError on either device,
    including a point encoding whose width does not match w0's 63 rows
    (the JAX kernel pads the encoding by 64 - 63 columns whatever its
    width, reads past a narrower one and returns numbers there).

As in the JAX function, the view branch's own input is a plain product
outside the kernels: vb = vpe @ views.w_pe + views.b, one (128,) row per
ray, so autograd carries its gradient to views.w_pe, views.b and the
viewdirs. The kernels read vb per ray (the JAX kernel reads a per-point
copy). The packing holds the JAX `pack_params` groups (w0, wh, w5pe, b, wa,
wf, bf, wfv, wrgb and the head bias hb as ba, brgb) in K1's layout without
the view-encoding entries: `fused_mlp.pack_params(params, view_pe=False)`.
"""

from __future__ import annotations

import ctypes

import torch

from benerf_tpu_torch.models import embedder
from benerf_tpu_torch.models import nerf as nerf_mod
from benerf_tpu_torch.ops import fused_mlp
from benerf_tpu_torch.ops.fused_mlp import (DEFAULT_SPLITS, DEPTH, HEAD,
                                            SKIP_LAYER, TILE, WIDTH, _check,
                                            _layout, _lib, _offsets, _ptr,
                                            _stream)

# launches on the card, one per wrapper call that launched its kernel(s)
LAUNCHES = {"staged_mlp_fwd": 0, "staged_mlp_bwd": 0}


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


def launch_fwd(packed, pts, vb, S, C):
    """K3: pts (n, 3), per-ray view bias vb (n / S, 128) -> raw (n, C+1)."""
    n = pts.shape[0]
    if n == 0 or n % S:
        raise ValueError(f"point count {n} is not a positive multiple of S={S}")
    if not 1 <= C < HEAD:
        raise ValueError(f"K3 takes 1 <= C < {HEAD} channels, got {C}")
    _check("packed", packed, (_offsets(_layout(C, False))[-1],))
    _check("pts", pts, (n, 3))
    _check("vb", vb, (n // S, HEAD))
    lib = _lib("staged_mlp_fwd")
    out = torch.empty((n, C + 1), device=pts.device, dtype=torch.float32)
    rc = lib.staged_mlp_fwd(_ptr(pts), _ptr(vb), n, S, _ptr(packed), C,
                            _ptr(out), _stream())
    if rc:
        raise RuntimeError(f"staged_mlp_fwd: CUDA error {rc}")
    LAUNCHES["staged_mlp_fwd"] += 1
    return out


def launch_bwd(packed, pts, vb, g, S, C, splits=DEFAULT_SPLITS):
    """K4: cotangent g (n, C+1) -> (d packed, d pts (n, 3), d vb (n / S,
    128))."""
    n = pts.shape[0]
    R = n // S
    _check("packed", packed, (_offsets(_layout(C, False))[-1],))
    _check("pts", pts, (n, 3))
    _check("vb", vb, (R, HEAD))
    _check("cotangent", g, (n, C + 1))
    if splits < 1:
        raise ValueError(f"splits must be >= 1, got {splits}")
    lib = _lib("staged_mlp_bwd")
    dev = pts.device
    n_pad = -(-n // TILE) * TILE
    sizes = (ctypes.c_int64 * 3)()
    lib.staged_mlp_bwd_scratch(n_pad, C, sizes)
    ptr_ = fused_mlp.pack_transposed(packed, C, view_pe=False).contiguous()
    x_scr = torch.empty(sizes[0], device=dev)
    d_scr = torch.empty(sizes[1], device=dev)
    part = torch.empty((splits, packed.numel()), device=dev)
    dpacked = torch.empty_like(packed)
    dpts = torch.empty((n, 3), device=dev)
    rc = lib.staged_mlp_bwd(
        _ptr(pts), _ptr(vb), n, S, _ptr(packed), _ptr(ptr_), _ptr(g), C, n_pad,
        _ptr(x_scr), _ptr(d_scr), _ptr(dpts), _ptr(part), splits,
        _ptr(dpacked), _stream())
    if rc:
        raise RuntimeError(f"staged_mlp_bwd: CUDA error {rc}")
    LAUNCHES["staged_mlp_bwd"] += 1
    # K4 leaves d vb per point in the scratch's rows [sizes[2], +128); a
    # ray's bias is broadcast over its S samples: sum them
    dvb_pt = d_scr.view(-1, n_pad)[sizes[2]:sizes[2] + HEAD, :n]
    dvb = dvb_pt.unflatten(1, (R, S)).sum(dim=2).t()
    return dpacked, dpts, dvb


class _StagedMLP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, packed, pts, vb, S, C, splits):
        ctx.save_for_backward(packed, pts, vb)
        ctx.S, ctx.C, ctx.splits = S, C, splits
        return launch_fwd(packed, pts, vb, S, C)

    @staticmethod
    def backward(ctx, g):
        packed, pts, vb = ctx.saved_tensors
        dpacked, dpts, dvb = launch_bwd(packed, pts, vb, g.contiguous(), ctx.S,
                                        ctx.C, ctx.splits)
        return dpacked, dpts, dvb, None, None, None


def staged_nerf_mlp(params, pts, viewdirs, *, num_freqs=10, num_freqs_views=4,
                    splits=DEFAULT_SPLITS):
    """Drop-in replacement for models.nerf.apply on the standard trunk with
    viewdirs, any view encoding, no BARF. pts: (R, S, 3); viewdirs: (R, 3).
    On the CPU this is the plain version, nerf.apply."""
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
        return nerf_mod.apply(params, pts, viewdirs, num_freqs=num_freqs,
                              num_freqs_views=num_freqs_views)
    return _staged(params, pts, viewdirs, num_freqs_views, splits)


def _staged(params, pts, viewdirs, num_freqs_views, splits):
    """The card path: the per-ray view bias, the packing, K3 and (through
    autograd) K4."""
    R, S, _ = pts.shape
    C = params["rgb"]["w"].shape[1]
    vpe = embedder.positional_encoding(viewdirs, num_freqs_views)
    vb = vpe @ params["views"]["w_pe"] + params["views"]["b"]  # (R, 128)
    packed = fused_mlp.pack_params(params, view_pe=False)
    out = _StagedMLP.apply(packed, pts.reshape(R * S, 3).contiguous(),
                           vb.contiguous(), S, C, splits)
    return out.view(R, S, C + 1)

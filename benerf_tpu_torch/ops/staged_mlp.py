"""Staged NeRF MLP on the card: kernels K3 (forward) and K4 (backward).

Port of benerf_tpu/ops/pallas_mlp.py. The TPU pair `_fwd_kernel` /
`_bwd_kernel` becomes two hand-written CUDA C++ kernels for Hopper,
csrc/staged_mlp_fwd.cu (K3) and csrc/staged_mlp_bwd.cu (K4), built,
loaded, launched and tied together by a torch.autograd.Function with K1/K2
in ops/mlp_kernels.py. Each .cu file's header says what bounds it and how
its design answers that.

Contract of `staged_nerf_mlp` (the JAX function's): the standard 8x256
trunk with viewdirs, any view-encoding width, C + 1 <= 128, no BARF,
compute_dtype "float32" or "bfloat16"; pts (R, S, 3), viewdirs (R, 3) ->
raw (R, S, C+1).
  - CPU tensors take the plain PyTorch version, models/nerf.apply (bf16
    operands for "bfloat16");
  - CUDA float32 tensors launch the kernels, on wgmma as K1/K2 (K3's
    launch writes the weights' wgmma copies without the view-encoding
    weights, `mlp_kernels.prep_table(view_pe=False)`, which K4 reads):
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
`mlp_kernels.pack_params(params, view_pe=False)`.
"""

from __future__ import annotations

import torch

from benerf_tpu_torch.models import embedder
from benerf_tpu_torch.models import nerf as nerf_mod
from benerf_tpu_torch.ops import mlp_kernels
from benerf_tpu_torch.ops.mlp_kernels import HEAD


def supports(params) -> bool:
    """Standard BeNeRF trunk with viewdirs, any view-encoding width,
    C + 1 <= 128 (pallas_mlp.supports)."""
    return mlp_kernels.supports(params, mlp_kernels.STAGED)


def staged_nerf_mlp(params, pts, viewdirs, *, num_freqs=10, num_freqs_views=4,
                    compute_dtype="float32"):
    """Drop-in replacement for models.nerf.apply on the standard trunk with
    viewdirs, any view encoding, no BARF. pts: (R, S, 3); viewdirs: (R, 3).
    On the CPU this is the plain version, nerf.apply."""
    mlp_kernels.mode_of(compute_dtype)
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
    return _staged(params, pts, viewdirs, num_freqs_views, compute_dtype)


def view_bias(params, viewdirs, num_freqs_views, compute_dtype="float32"):
    """The per-ray view bias vb (R, 128) = vpe @ views.w_pe + views.b, the
    product's operands rounded to bf16 in bf16 mode (fp32 accumulation)."""
    vpe = embedder.positional_encoding(viewdirs, num_freqs_views)
    w = params["views"]["w_pe"]
    if compute_dtype == "bfloat16":
        vpe, w = (t.to(torch.bfloat16).to(torch.float32) for t in (vpe, w))
    return vpe @ w + params["views"]["b"]


def _staged(params, pts, viewdirs, num_freqs_views, compute_dtype):
    """The card path: the per-ray view bias, the packing, K3 and (through
    autograd) K4."""
    R, S, _ = pts.shape
    C = params["rgb"]["w"].shape[1]
    vb = view_bias(params, viewdirs, num_freqs_views, compute_dtype)
    out = mlp_kernels.kernel_mlp(
        mlp_kernels.STAGED, mlp_kernels.pack_params(params, view_pe=False),
        pts.reshape(R * S, 3).contiguous(), vb.contiguous(), None, S, C,
        compute_dtype)
    return out.view(R, S, C + 1)

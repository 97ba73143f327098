"""Fused NeRF MLP on the card: kernels K1 (forward) and K2 (backward).

Port of benerf_tpu/ops/pallas_mlp_t.py. The TPU pair `_fwd_kernel_t` /
`_bwd_kernel_t` becomes two hand-written CUDA C++ kernels for Hopper,
csrc/fused_mlp_fwd.cu (K1) and csrc/fused_mlp_bwd.cu (K2), whose layer
products run as wgmma on weights that TMA brings into shared memory
(csrc/wgmma_layer.cuh). Their build, load, launches and the formats they
share with Python live in ops/mlp_kernels.py, with K3/K4's.

Contract of `fused_nerf_mlp` (same as the JAX function): standard
architecture, viewdirs on, L = 10 / 4 frequencies, optional BARF band
weights, compute_dtype "float32" or "bfloat16"; pts (R, S, 3), viewdirs
(R, 3) -> raw (R, S, C+1).
  - CPU tensors take the plain PyTorch version, models/nerf.apply (bf16
    operands for "bfloat16");
  - CUDA float32 tensors launch the kernels: "float32" in their TF32X3
    mode (three TF32 products a step, fp32-level accuracy), "bfloat16" in
    their BF16 mode (bf16 operands, fp32 accumulation, as the JAX kernel);
  - anything outside the contract raises ValueError on either device;
    ops/mlp.route sends only what the kernels take here.
"""

from __future__ import annotations

import torch

from benerf_tpu_torch.models import nerf as nerf_mod
from benerf_tpu_torch.ops import mlp_kernels
from benerf_tpu_torch.ops.mlp_kernels import L_PTS, L_VIEWS


def supports(params) -> bool:
    """Standard BeNeRF architecture (pallas_mlp_t.supports)."""
    return mlp_kernels.supports(params, mlp_kernels.FUSED)


def band_weights(barf_weights, barf_weights_views, device):
    """(14,) per-band encoding multipliers: the BARF weights, ones when off."""
    w = (torch.ones(L_PTS, device=device) if barf_weights is None
         else barf_weights.to(device=device, dtype=torch.float32))
    wv = (torch.ones(L_VIEWS, device=device) if barf_weights_views is None
          else barf_weights_views.to(device=device, dtype=torch.float32))
    return torch.cat([w.reshape(-1), wv.reshape(-1)]).contiguous()


def fused_nerf_mlp(params, pts, viewdirs, *, num_freqs=10, num_freqs_views=4,
                   barf_weights=None, barf_weights_views=None,
                   compute_dtype="float32"):
    """Drop-in replacement for models.nerf.apply (standard architecture,
    viewdirs on, optional BARF band weights). pts: (R, S, 3); viewdirs:
    (R, 3). On the CPU this is the plain version, nerf.apply."""
    mlp_kernels.mode_of(compute_dtype)
    if (viewdirs is None or not supports(params)
            or (num_freqs, num_freqs_views) != (L_PTS, L_VIEWS)):
        raise ValueError(
            "fused_nerf_mlp takes the 8x256 MLP with viewdirs, 27 view-"
            f"encoding rows, C + 1 <= 8 and 10/4 frequencies (got "
            f"{num_freqs}/{num_freqs_views}); ops/mlp.route picks the "
            "implementation for anything else")
    if pts.device.type == "cpu":
        return nerf_mod.apply(
            params, pts, viewdirs, num_freqs=num_freqs,
            num_freqs_views=num_freqs_views, barf_weights=barf_weights,
            barf_weights_views=barf_weights_views,
            compute_dtype=None if compute_dtype == "float32" else torch.bfloat16)
    return _fused(params, pts, viewdirs, barf_weights, barf_weights_views,
                  compute_dtype)


def _fused(params, pts, viewdirs, barf_weights, barf_weights_views,
           compute_dtype):
    """The card path: the packing, the band weights, K1 and (through
    autograd) K2."""
    R, S, _ = pts.shape
    C = params["rgb"]["w"].shape[1]
    out = mlp_kernels.kernel_mlp(
        mlp_kernels.FUSED, mlp_kernels.pack_params(params),
        pts.reshape(R * S, 3).contiguous(), viewdirs.contiguous(),
        band_weights(barf_weights, barf_weights_views, pts.device), S, C,
        compute_dtype)
    return out.view(R, S, C + 1)

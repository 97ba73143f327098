"""MLP evaluation dispatcher: fused CUDA kernels on the card, plain PyTorch
on the CPU.

Port of benerf_tpu/ops/mlp.py without a mesh. Routes:
  - a CUDA tensor on the standard architecture (10/4 frequencies, viewdirs
    on, float32) goes to the fused kernels K1/K2 (ops/fused_mlp.py);
  - a CPU tensor goes to models/nerf.apply;
  - a CUDA tensor the fused kernel cannot take raises. The JAX package
    falls back to its staged kernel K3/K4 there (benerf_tpu/ops/mlp.py);
    that kernel is not ported yet, and the port never runs the plain
    version on the card in its place.
"""

from __future__ import annotations

import torch

from benerf_tpu_torch.models import nerf as nerf_model
from benerf_tpu_torch.ops import fused_mlp


def mlp_forward(
    params,
    pts,
    viewdirs,
    *,
    num_freqs: int = 10,
    num_freqs_views: int = 4,
    barf_weights=None,
    barf_weights_views=None,
    compute_dtype: str = "float32",
):
    """Evaluate the NeRF MLP on (R, S, 3) points. See models.nerf.apply."""
    if pts.device.type == "cuda":
        if compute_dtype != "float32":
            raise NotImplementedError(
                f"compute_dtype={compute_dtype!r} on the card: the fused "
                "kernels are fp32 only; the bf16 mode comes with their "
                "tensor-core version")
        return fused_mlp.fused_nerf_mlp(
            params, pts, viewdirs, num_freqs=num_freqs,
            num_freqs_views=num_freqs_views, barf_weights=barf_weights,
            barf_weights_views=barf_weights_views,
        )
    cd = None if compute_dtype == "float32" else torch.bfloat16
    return nerf_model.apply(
        params, pts, viewdirs,
        num_freqs=num_freqs, num_freqs_views=num_freqs_views,
        barf_weights=barf_weights, barf_weights_views=barf_weights_views,
        compute_dtype=cd,
    )


def mlp_forward_families(params, families, **kw):
    """Evaluate the MLP on several ray families with ONE call (one kernel
    launch on the card): concatenate along the ray axis, split after.

    families: list of (pts (R_i, S, 3), viewdirs (R_i, 3) or None).
    Returns a list of (R_i, S, C+1) raw outputs.
    """
    pts = torch.cat([f[0] for f in families], dim=0)
    vd = (None if families[0][1] is None
          else torch.cat([f[1] for f in families], dim=0))
    raw = mlp_forward(params, pts, vd, **kw)
    return list(torch.split(raw, [f[0].shape[0] for f in families], dim=0))

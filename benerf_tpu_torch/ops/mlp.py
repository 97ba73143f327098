"""MLP evaluation dispatcher: the CUDA kernels on the card where the JAX
package runs its Pallas kernels, plain PyTorch everywhere else.

Port of benerf_tpu/ops/mlp.py without a mesh. On the card `route` decides,
from shapes and flags alone and in the JAX package's order (its
ops/mlp.py:67-82):
  - "fused": K1/K2 (ops/fused_mlp.py), the standard architecture at 10/4
    frequencies, BARF allowed, compute_dtype "float32" or "bfloat16";
  - "staged": K3/K4 (ops/staged_mlp.py), the standard trunk with any view
    encoding, BARF off, fp32 only: compute_dtype "bfloat16" raises
    NotImplementedError there until K3/K4 move onto the tensor cores
    (ROADMAP Queue 1);
  - "plain": models/nerf.apply, every other architecture (other widths or
    depths, no viewdirs, BARF with a view encoding other than 27 rows),
    where the JAX package runs plain XLA too; counted in ROUTES["plain"].
A CPU tensor always takes models/nerf.apply. A kernel that fails to build
or launch raises: nothing falls back.
"""

from __future__ import annotations

import torch

from benerf_tpu_torch.models import nerf as nerf_model
from benerf_tpu_torch.ops import fused_mlp, staged_mlp

# card calls that took the plain route (the kernels count their launches)
ROUTES = {"plain": 0}


def route(params, viewdirs, num_freqs, num_freqs_views, barf_on) -> str:
    """"fused", "staged" or "plain": the implementation of the MLP on the
    card, as benerf_tpu/ops/mlp.py picks its kernel."""
    if viewdirs is None:
        return "plain"
    if fused_mlp.supports(params) and (num_freqs, num_freqs_views) == (10, 4):
        return "fused"
    if not barf_on and staged_mlp.supports(params):
        return "staged"
    return "plain"


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
        which = route(params, viewdirs, num_freqs, num_freqs_views,
                      barf_weights is not None or barf_weights_views is not None)
        if which == "fused":
            return fused_mlp.fused_nerf_mlp(
                params, pts, viewdirs, num_freqs=num_freqs,
                num_freqs_views=num_freqs_views, barf_weights=barf_weights,
                barf_weights_views=barf_weights_views,
                compute_dtype=compute_dtype,
            )
        if which == "staged":
            if compute_dtype != "float32":
                raise NotImplementedError(
                    f"compute_dtype={compute_dtype!r} on the staged route: "
                    "K3/K4 are fp32 on CUDA cores; their bf16 mode comes "
                    "with their move onto the tensor cores (ROADMAP Queue 1 "
                    "item 1)")
            return staged_mlp.staged_nerf_mlp(
                params, pts, viewdirs, num_freqs=num_freqs,
                num_freqs_views=num_freqs_views,
            )
        ROUTES["plain"] += 1
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

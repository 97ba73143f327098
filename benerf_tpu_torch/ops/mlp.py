"""MLP evaluation dispatcher: the CUDA kernels on the card where the JAX
package runs its Pallas kernels, plain PyTorch everywhere else.

Port of benerf_tpu/ops/mlp.py. On the card `route` decides, from shapes
and flags alone and in the JAX package's order (its ops/mlp.py:67-82):
  - "fused": K1/K2 (ops/fused_mlp.py), the standard architecture at 10/4
    frequencies, BARF allowed, compute_dtype "float32" or "bfloat16";
  - "staged": K3/K4 (ops/staged_mlp.py), the standard trunk with any view
    encoding, BARF off, compute_dtype "float32" or "bfloat16";
  - "plain": models/nerf.apply, every other architecture (other widths or
    depths, no viewdirs, BARF with a view encoding other than 27 rows) and
    every call with use_pallas off, where the JAX package runs plain XLA
    too; counted in ROUTES["plain"].
Under a mesh (parallel/mesh.py) each rank evaluates its share of the rays;
a call over several families there takes K1/K2 or the plain route, never
K3/K4, as the JAX package's shard_map region runs its fused kernel or plain
jnp (its ops/mlp.py:239-247, `kernel_ok`).
A CPU tensor always takes models/nerf.apply. A kernel that fails to build
or launch raises: nothing falls back.
"""

from __future__ import annotations

import torch

from benerf_tpu_torch.core import profiling
from benerf_tpu_torch.models import nerf as nerf_model
from benerf_tpu_torch.ops import fused_mlp, mlp_kernels, staged_mlp

# card calls that took the plain route (the kernels count their launches)
ROUTES = {"plain": 0}
# every launch and route counter of the card path. The launches count on the
# host (mlp_kernels.call), which a CUDA graph's replay does not pass through:
# train/step.py counts what a captured step launched (counts_since) and adds
# it at each replay (add_counts), so the counters count launches on the card
# whether a graph replays them or not.
COUNTERS = (mlp_kernels.LAUNCHES, ROUTES)


def counts(counters=COUNTERS):
    """A copy of every counter of `counters`."""
    return [dict(c) for c in counters]


def counts_since(before, counters=COUNTERS):
    """What each counter gained since `before` (a `counts()`)."""
    return [{k: c[k] - b[k] for k in c} for c, b in zip(counters, before)]


def add_counts(delta, times=1, counters=COUNTERS):
    """Add `times` x `delta` (a `counts_since`) to the counters."""
    for c, d in zip(counters, delta):
        for k, v in d.items():
            c[k] += v * times


def route(params, viewdirs, num_freqs, num_freqs_views, barf_on,
          use_pallas=True, mesh=False) -> str:
    """"fused", "staged" or "plain": the implementation of the MLP on the
    card, as benerf_tpu/ops/mlp.py picks its kernel. mesh: the call
    evaluates several ray families under a mesh, where there is no staged
    route."""
    if not use_pallas or viewdirs is None:
        return "plain"
    if fused_mlp.supports(params) and (num_freqs, num_freqs_views) == (10, 4):
        return "fused"
    if not mesh and not barf_on and staged_mlp.supports(params):
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
    use_pallas: bool = True,
    compute_dtype: str = "float32",
    mesh: bool = False,
):
    """Evaluate the NeRF MLP on (R, S, 3) points. See models.nerf.apply.
    use_pallas: the JAX package's flag; off, every card call takes the
    plain route. mesh: as in `route`. The call is the span mlp.fwd (the
    kernels' backward records mlp.bwd)."""
    with profiling.span("mlp.fwd"):
        if pts.device.type == "cuda":
            barf_on = (barf_weights is not None
                       or barf_weights_views is not None)
            which = route(params, viewdirs, num_freqs, num_freqs_views,
                          barf_on, use_pallas, mesh)
            if which == "fused":
                return fused_mlp.fused_nerf_mlp(
                    params, pts, viewdirs, num_freqs=num_freqs,
                    num_freqs_views=num_freqs_views, barf_weights=barf_weights,
                    barf_weights_views=barf_weights_views,
                    compute_dtype=compute_dtype,
                )
            if which == "staged":
                return staged_mlp.staged_nerf_mlp(
                    params, pts, viewdirs, num_freqs=num_freqs,
                    num_freqs_views=num_freqs_views,
                    compute_dtype=compute_dtype,
                )
            ROUTES["plain"] += 1
        cd = None if compute_dtype == "float32" else torch.bfloat16
        return nerf_model.apply(
            params, pts, viewdirs,
            num_freqs=num_freqs, num_freqs_views=num_freqs_views,
            barf_weights=barf_weights, barf_weights_views=barf_weights_views,
            compute_dtype=cd,
        )


def mlp_forward_families(params, families, mesh=None, **kw):
    """Evaluate the MLP on several ray families with ONE call (one kernel
    launch on the card): concatenate along the ray axis, split after.

    families: list of (pts (R_i, S, 3), viewdirs (R_i, 3) or None), under a
    mesh this rank's rows of each (the JAX package concatenates the local
    shards inside its shard_map region). Returns a list of (R_i, S, C+1)
    raw outputs.
    """
    pts = torch.cat([f[0] for f in families], dim=0)
    vd = (None if families[0][1] is None
          else torch.cat([f[1] for f in families], dim=0))
    raw = mlp_forward(params, pts, vd,
                      mesh=mesh is not None and len(families) > 1, **kw)
    return list(torch.split(raw, [f[0].shape[0] for f in families], dim=0))

"""Layer readings for the per-layer readers: the MLP's share of its
roofline from the traced window's kernels, and the spline's poses called
alone, timed by the device's busy time under the profiler (tracing.py).
"""

from __future__ import annotations

import sys

import torch

from benchmark import counts, tracing

# a forward MLP launch: the weights' wgmma copies (wl::prep_kernel), then K1
FORWARD = ("fmlp::fwd_kernel", "wl::prep_kernel")


def _forward(name) -> bool:
    return any(k in name for k in FORWARD)


def _backward(name) -> bool:
    return "fmlp::" in name and not _forward(name)


def mlp_roofline(ctx, calls, backward: bool):
    """Share (%) of the least time of the MLP calls [(rays, samples)] that
    one step (or frame) of the traced window makes through ops/mlp.py,
    over the device time of the MLP's kernels in the window's trace per
    step: the forward's (each K1 launch with the weights' copies it first
    writes) or the backward's (every other fmlp:: kernel: K2's tile pass,
    its weight-gradient passes and their sums; the work counted as twice
    the forward's, recomputation not counted). None where the trace holds
    none of them, or launches that the steps do not share evenly."""
    prof = ctx.profile
    if prof is None:
        return None
    match = _backward if backward else _forward
    mine = [(name, n, s) for name, n, s in prof.kernels if match(name)]
    if not mine:
        return None
    if any(n % ctx.steps for _, n, _ in mine):
        print(f"probe: the MLP's kernels over {ctx.steps} traced steps: "
              + ", ".join(f"{name[:40]} x{n}" for name, n, _ in mine),
              file=sys.stderr)
        return None
    c, prec = ctx.conf["config"], ctx.precision
    per_point = counts.mlp_flops_per_point(
        depth=c["netdepth"], width=c["netwidth"], channels=c["channels"])
    least = 0.0
    for rays, samples in calls:
        n = rays * samples
        if backward:
            least += counts.least_seconds(
                2 * n * per_point, counts.mlp_bwd_bytes(c, n, rays), prec)[0]
        else:
            least += counts.least_seconds(
                n * per_point, counts.mlp_fwd_bytes(c, n, rays), prec)[0]
    return 100.0 * least / (sum(s for _, _, s in mine) / ctx.steps)


def spline_ms(ctx, reps: int = 5):
    """Device ms of one step's poses (2 at the event window's ends, P over
    the exposure), forward and backward, as the step calls the spline."""
    from benerf_tpu_torch.geometry import spline as spline_mod

    if ctx.device.type != "cuda":
        return None
    state, batch = ctx.objects["state"], ctx.objects["batch"]
    knots = state.params["knots"].detach().clone().requires_grad_(True)
    transform = state.params["transform"].detach().clone().requires_grad_(True)
    low = torch.tensor(0.37, device=ctx.device)
    L, P, traj = (ctx.cfg.accumulate_time_length, ctx.cfg.num_interpolated_pose,
                  ctx.cfg.traj)

    def call():
        e = spline_mod.interpolate_poses(knots, low, low + L, 2, traj)
        r = spline_mod.interpolate_poses(knots + transform[None, :],
                                         batch.rgb_exp_ts[0],
                                         batch.rgb_exp_ts[1], P, traj)
        torch.autograd.backward([e, r], [torch.ones_like(e), torch.ones_like(r)])

    t, _ = tracing.device_seconds(call, ctx.device, reps)
    return None if t is None else t * 1e3

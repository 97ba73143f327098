"""Roofline share (%) of the step's two MLP forwards (ops/mlp.py
mlp_forward: coarse at 64 and fine at 128 points a ray of the step's
rays), by the device time of their kernels in the traced dispatch."""

from benchmark import counts, probes


def read(ctx):
    c = ctx.conf["config"]
    rays = counts.rays_per_step(c)
    return probes.mlp_roofline(
        ctx, [(rays, c["N_samples"]), (rays, c["N_samples"] + c["N_importance"])],
        backward=False)

"""Roofline share (%) of the backward of the step's two MLP calls (the
work counted as twice the forward's, recomputation not counted), by the
device time of its kernels in the traced dispatch."""

from benchmark import counts, probes


def read(ctx):
    c = ctx.conf["config"]
    rays = counts.rays_per_step(c)
    return probes.mlp_roofline(
        ctx, [(rays, c["N_samples"]), (rays, c["N_samples"] + c["N_importance"])],
        backward=True)

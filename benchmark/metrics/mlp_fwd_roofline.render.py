"""Roofline share (%) of a frame's MLP calls (ops/mlp.py mlp_forward, two
a chunk of rays: 64 coarse and 128 fine points a ray), by the device time
of their kernels in the traced frame."""

from benchmark import probes


def read(ctx):
    c, o = ctx.conf["config"], ctx.objects
    rays, chunk = o["H"] * o["W"], o["chunk"]
    chunks = [min(chunk, rays - i) for i in range(0, rays, chunk)]
    return probes.mlp_roofline(
        ctx, [(r, s) for r in chunks
              for s in (c["N_samples"], c["N_samples"] + c["N_importance"])],
        backward=False)

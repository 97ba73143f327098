"""Share (%) of the chip's peak (benchmark/counts.py, in the configuration's
precision) that a frame's MLP work delivers over the window: forward FLOP
of a frame / frame_ms / peak."""

from benchmark import counts


def read(ctx):
    if ctx.device.type != "cuda":
        return None
    o = ctx.objects
    flops = counts.frame_flops(ctx.conf["config"], o["H"], o["W"])
    sec = ctx.e2e["frame_ms"] * 1e-3 * ctx.chips
    return 100.0 * flops / sec / counts.PEAK_FLOPS[ctx.precision]

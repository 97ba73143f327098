"""Share (%) of the chips' peak (benchmark/counts.py, in the configuration's
precision) that the step's MLP work (forward + backward) delivers over the
window: FLOP a step / (iter_ms x chips) / peak."""

from benchmark import counts


def read(ctx):
    if ctx.device.type != "cuda":
        return None
    flops = counts.train_flops_per_step(ctx.conf["config"])
    sec = ctx.e2e["iter_ms"] * 1e-3 * ctx.chips
    return 100.0 * flops / sec / counts.PEAK_FLOPS[ctx.precision]

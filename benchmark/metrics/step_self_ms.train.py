"""Device ms a step of the train step's own work in the captured step:
the program's span `step` less the spline's (spline.fwd, spline.bwd) and
the MLP's (every mlp.fwd and mlp.bwd): draws, event window, the renderer
around the MLP, losses, grad norms, Adam and the metrics row, gaps
included (benchmark/spans.py)."""

from benchmark import spans

CHILDREN = ("spline.fwd", "spline.bwd", "mlp.fwd", "mlp.bwd")


def read(ctx):
    ms = spans.train_span_ms(ctx)
    return None if ms is None else spans.self_ms(ms, "step", CHILDREN)

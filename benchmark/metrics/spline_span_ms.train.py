"""Device ms a step of the spline (geometry/spline.py) in the captured
step: the program's spans spline.fwd (both interpolate_poses calls) and
spline.bwd (from the poses' gradients to the knots'), gaps between their
launches included (benchmark/spans.py)."""

from benchmark import spans


def read(ctx):
    ms = spans.train_span_ms(ctx)
    if ms is None or "spline.fwd" not in ms or "spline.bwd" not in ms:
        return None
    return sum(ms["spline.fwd"]) + sum(ms["spline.bwd"])

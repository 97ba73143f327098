"""Device ms a frame of the renderer's own work: the program's span
`frame` (eval/frames.py render_image) less every mlp.fwd (K1): sampling,
pdf, compositing, the chunks' draws and the copies to the host, gaps
included (benchmark/spans.py)."""

from benchmark import spans


def read(ctx):
    ms = spans.frame_span_ms(ctx)
    return None if ms is None else spans.self_ms(ms, "frame", ("mlp.fwd",))

"""Device ms of the spline (geometry/spline.py) a step: the 2 event poses
and the P rgb poses, forward and backward, called alone at the cell's
shapes."""

from benchmark import probes


def read(ctx):
    return probes.spline_ms(ctx)

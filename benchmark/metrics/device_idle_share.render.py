"""Share (%) of the traced frame's wall time in which the device ran
nothing: 1 - busy / wall."""


def read(ctx):
    p = ctx.profile
    if p is None or p.launches == 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.wall_s)

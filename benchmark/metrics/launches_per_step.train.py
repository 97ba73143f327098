"""Device launches a train step: every kernel and copy of the traced
dispatch over its steps (train/step.py make_multi_step)."""


def read(ctx):
    if ctx.profile is None or ctx.profile.launches == 0:
        return None
    return ctx.profile.launches / ctx.steps

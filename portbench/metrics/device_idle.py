"""Share of the traced stretch in which no operation ran on the device
(profiler timeline: the union of kernel, copy and set intervals)."""


def read(ctx):
    tr = ctx.run.trace
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)

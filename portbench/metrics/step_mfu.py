"""The whole step's share of the device's bf16 dense peak: the model
FLOPs of the window's steps (``portbench.counts``: the rows each step
ran, at their positions) over the window's seconds times the peak."""

from portbench import counts


def read(ctx):
    run = ctx.run
    if ctx.peaks is None or run.window_s <= 0 or not run.step_positions:
        return None
    flops = sum(counts.step_flops(ctx.dims, p) for p in run.step_positions)
    return 100.0 * flops / (run.window_s * ctx.peaks["bf16_flop_s"])

"""The fixed engine's captured step: the window's seconds over the steps
it replayed (host clock over whole batches, each ending synchronised)."""


def read(ctx):
    run = ctx.run
    if not run.step_positions:
        return None
    return 1e3 * run.window_s / len(run.step_positions)

"""Tokens generated in the window over the window's seconds (host
clock); the window holds the prefill steps too."""


def read(ctx):
    run = ctx.run
    if run.window_s <= 0 or not run.gen_tokens:
        return None
    return run.gen_tokens / run.window_s

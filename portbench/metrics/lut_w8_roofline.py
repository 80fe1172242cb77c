"""The W8A8 LUT kernel's share of its roofline: the sum of the bounds of
the LUT products the traced steps launched (``portbench.counts``: the
shapes a step launches, from the configuration, at 8-bit codes) over the
device seconds of those launches (``lut_mma_kernel<..., true>`` in the
profiler)."""

from portbench import counts


def read(ctx):
    tr = ctx.run.trace
    if tr is None or ctx.peaks is None:
        return None
    n, secs = tr.launches("lut_mma_kernel", "true")
    if n == 0 or secs <= 0:
        return None
    per_step = len(counts.lut_products(ctx.dims, ctx.run.rows_per_step))
    if n != tr.steps * per_step:
        raise RuntimeError(f"{n} LUT launches traced in {tr.steps} steps of "
                           f"{per_step}")
    bound = tr.steps * counts.lut_step_bound_s(ctx.dims, ctx.run.rows_per_step,
                                               ctx.peaks, bits=8)
    return 100.0 * bound / secs

"""Share of the traced section in which no kernel, copy or fill ran on the
device (the union of their intervals over the section's host time), %."""


def read(ctx):
    if ctx.mode != "infer" or not ctx.trace or ctx.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"])

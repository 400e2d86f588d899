"""Device ms a step of the program's ``backward`` profiler range in the traced
section: the kernels whose launch falls inside the range."""


def read(ctx):
    return ctx.range_ms("backward") if ctx.mode == "train" else None

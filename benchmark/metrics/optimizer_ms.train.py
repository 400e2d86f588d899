"""Device ms a step of the program's ``optimizer`` profiler range in the traced
section: the kernels whose launch falls inside the range."""


def read(ctx):
    return ctx.range_ms("optimizer") if ctx.mode == "train" else None

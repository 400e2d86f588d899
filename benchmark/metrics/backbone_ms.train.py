"""Device ms a step of the program's ``backbone`` profiler range in the traced
section: the kernels whose launch falls inside the range (ResNet and FPN)."""


def read(ctx):
    return ctx.range_ms("backbone") if ctx.mode == "train" else None

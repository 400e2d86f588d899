"""Device ms a step of the program's ``roi_heads`` profiler range in the traced
section: the kernels whose launch falls inside the range (sampling, RoIAlign, box head, losses or post-processing)."""


def read(ctx):
    return ctx.range_ms("roi_heads") if ctx.mode == "train" else None

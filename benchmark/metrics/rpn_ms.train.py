"""Device ms a step of the program's ``rpn`` profiler range in the traced
section: the kernels whose launch falls inside the range (RPN head, anchor matching, top-k and NMS)."""


def read(ctx):
    return ctx.range_ms("rpn") if ctx.mode == "train" else None

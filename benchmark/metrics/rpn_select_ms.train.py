"""Stream ms a step of the program's span ``rpn.select`` in the traced section:
the RPN's per-level sort, gather, decode, clip, pad and stack."""
from benchmark import spans


def read(ctx):
    return spans.stream_ms_per_step(ctx, "rpn.select") if ctx.mode == "train" else None

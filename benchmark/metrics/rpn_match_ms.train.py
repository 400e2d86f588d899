"""Stream ms a step of the program's span ``rpn.match`` in the traced section: the
RPN's IoU of every anchor with the padded gt slots, the matcher and the
sampling, all images (from its timing events at entry and exit)."""
from benchmark import spans


def read(ctx):
    return spans.stream_ms_per_step(ctx, "rpn.match") if ctx.mode == "train" else None

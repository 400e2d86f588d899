"""Stream ms a batch of the program's span ``rpn.nms`` in the traced section:
the per-level IoU matrix, the NMS fixpoint with its host reads, and the
image's top-k, idle between rounds included."""
from benchmark import spans


def read(ctx):
    return spans.stream_ms_per_step(ctx, "rpn.nms") if ctx.mode == "infer" else None

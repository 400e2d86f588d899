"""Rounds a batch of the RPN's NMS fixpoint (the counter ``nms.rounds`` under
the span ``rpn.nms``), each one host read of the stream."""
from benchmark import spans


def read(ctx):
    return spans.count_per_step(ctx, "rpn.nms", "nms.rounds") if ctx.mode == "infer" else None

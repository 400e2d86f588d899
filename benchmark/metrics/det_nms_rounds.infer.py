"""Rounds a batch of the detections' NMS fixpoint (the counter ``nms.rounds``
under the span ``roi_heads.nms``), each one host read of the stream."""
from benchmark import spans


def read(ctx):
    return spans.count_per_step(ctx, "roi_heads.nms", "nms.rounds") if ctx.mode == "infer" else None

"""Stream ms a batch of the program's span ``roi_heads.nms`` in the traced
section: the detections' per-class NMS (with its host reads) and top 100."""
from benchmark import spans


def read(ctx):
    return spans.stream_ms_per_step(ctx, "roi_heads.nms") if ctx.mode == "infer" else None

"""Stream ms a step of the program's span ``roi_heads.mask`` in the traced
section: the mask branch's forward (the P=14 pool of every sampled slot,
the mask head, the gt crops and the loss)."""
from benchmark import spans


def read(ctx):
    return spans.stream_ms_per_step(ctx, "roi_heads.mask") if ctx.mode == "train" else None

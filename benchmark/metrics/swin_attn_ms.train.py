"""Stream ms a step of the program's span ``swin.attention`` in the traced
section: every Swin block's attention branch forward, from ``norm1``
through its residual add (pad, roll, window partition, qkv, scores, bias
table, shift mask, softmax, AV, projection, reverse, roll back, crop)."""
from benchmark import spans


def read(ctx):
    return spans.stream_ms_per_step(ctx, "swin.attention") if ctx.mode == "train" else None

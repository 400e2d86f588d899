"""Stream ms a step of the program's span ``swin.mlp`` in the traced
section: every Swin block's MLP branch forward, from ``norm2`` through its
residual add."""
from benchmark import spans


def read(ctx):
    return spans.stream_ms_per_step(ctx, "swin.mlp") if ctx.mode == "train" else None

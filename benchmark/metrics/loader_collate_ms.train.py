"""Host ms a step of the program's span ``loader.collate`` in the traced
section: stacking the batch's canvases and gt arrays."""
from benchmark import spans


def read(ctx):
    return spans.host_ms_per_step(ctx, "loader.collate") if ctx.mode == "train" else None

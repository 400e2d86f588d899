"""Host ms an image of the program's span ``loader.augment`` in the traced
section: a loader worker's crop, resize, flip, jitter, float32 canvas fill
and gt arrays."""
from benchmark import spans


def read(ctx):
    return spans.host_ms_per_call("loader.augment") if ctx.mode == "train" else None

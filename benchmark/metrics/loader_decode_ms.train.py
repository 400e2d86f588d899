"""Host ms an image of the program's span ``loader.decode`` in the traced
section: a loader worker's JPEG decode (PIL or the native decoder)."""
from benchmark import spans


def read(ctx):
    return spans.host_ms_per_call("loader.decode") if ctx.mode == "train" else None

"""Host ms a step of the program's span ``loader.wait`` in the traced section:
the loader's consumer waiting on its workers' next example."""
from benchmark import spans


def read(ctx):
    return spans.host_ms_per_step(ctx, "loader.wait") if ctx.mode == "train" else None

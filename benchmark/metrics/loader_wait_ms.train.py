"""Mean ms a step of the window waited in ``next()`` on the program's train
loader (the benchmark's own span around the call)."""


def read(ctx):
    waits = ctx.window.get("loader_waits")
    if ctx.mode != "train" or not waits:
        return None
    return 1e3 * sum(waits) / len(waits)

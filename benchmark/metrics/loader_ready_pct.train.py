"""Share in % of the traced section's takes from the program's train loader
(its span ``loader.take``) that found a finished batch already waiting (the
counter ``loader.ready`` under it)."""
from benchmark import spans


def read(ctx):
    if ctx.mode != "train":
        return None
    entry = spans.totals().get("loader.take")
    if not entry or entry["calls"] <= 0:
        return None
    return 100.0 * entry["counts"].get("loader.ready", 0) / entry["calls"]

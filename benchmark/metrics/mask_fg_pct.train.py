"""Share in % of the slots the mask branch pooled in the traced section
(the counter ``mask.slots`` under the span ``roi_heads.mask``) that were
foreground (its counter ``mask.fg_slots``): the rest is work on slots the
loss masks off."""
from benchmark import spans


def read(ctx):
    if ctx.mode != "train":
        return None
    entry = spans.totals().get("roi_heads.mask")
    if not entry or not entry["counts"].get("mask.slots"):
        return None
    return 100.0 * entry["counts"].get("mask.fg_slots", 0) / entry["counts"]["mask.slots"]

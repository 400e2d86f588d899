"""The Swin attention branches' forward: the least time the card could take
for the traced section's (``benchmark.counts_swin.attention_least_ms`` of
each traced step's batch and canvas, which `drivers/train_swin_mask.py` keeps under
``kernel_least_ms["swin.attention"]``) over the stream ms of the program's
span ``swin.attention``, %."""
from benchmark import spans


def read(ctx):
    least = ctx.kernel_least_ms.get("swin.attention")
    entry = spans.totals().get("swin.attention")
    if ctx.mode != "train" or not least or not entry or not entry["stream_ms"]:
        return None
    return 100.0 * least / entry["stream_ms"]

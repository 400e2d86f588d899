"""K2 (the serving pool): the least time the card could take for the traced section's
calls (``benchmark.counts.k2_bound`` on each call's taps) over the
device time of the kernel's events in the trace, %."""

KERNEL = {"call": "lvc_tpu_torch.ops.roi_align:roi_align_paired", "events": ["roi_align_rows_kernel"],
          "counts": "benchmark.counts:K2"}


def read(ctx):
    if ctx.mode != "infer":
        return None
    return ctx.roofline_pct(KERNEL)

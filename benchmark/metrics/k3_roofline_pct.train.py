"""K3 (the training pool's backward: its range and gradient kernels): the least time the card could take for the traced section's
calls (``benchmark.counts.k3_bound`` on each call's taps) over the
device time of the kernel's events in the trace, %."""

KERNEL = {"call": "lvc_tpu_torch.ops.roi_align:roi_align_paired_bwd",
          "events": ["box_ranges_kernel", "roi_align_paired_bwd_kernel"], "counts": "benchmark.counts:K3"}


def read(ctx):
    if ctx.mode != "train":
        return None
    return ctx.roofline_pct(KERNEL)

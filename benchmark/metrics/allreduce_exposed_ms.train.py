"""Device ms a step of the NCCL kernels not overlapped by any other kernel
of their card, the mean over the ranks, in the traced section."""


def read(ctx):
    if ctx.mode != "train" or not ctx.trace or ctx.trace.get("nccl_exposed_ms") is None:
        return None
    return ctx.trace["nccl_exposed_ms"] / ctx.traced_steps

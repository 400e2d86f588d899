"""Model FLOPs of the steps completed in the untraced window
(``benchmark.counts.model_flops`` from the configuration's shapes and each
batch's canvas) over the window's seconds times the peak of the precision
the products run in (bf16 989 TFLOP/s under AMP, TF32 495 TFLOP/s for a
float32 model), of every card the cell uses, %."""


def read(ctx):
    if ctx.mode != "train" or ctx.window["seconds"] <= 0:
        return None
    return 100.0 * ctx.window["flops"] / (ctx.window["seconds"] * ctx.window["peak_flops"])

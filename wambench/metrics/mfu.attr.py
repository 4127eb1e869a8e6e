"""The model's share of the chip's dense TF32 peak over the traced
stretch: the model FLOPs the stretch's attributions need (2 x the
multiply-adds of every convolution, dense layer and attention product,
forward and input-gradient backward, counted from the shapes) over the
stretch's time and 495 TFLOP/s, in %."""


def read(ctx):
    flops = ctx.facts["model_flops_per_item"] * ctx.window.traced_items
    if not flops or ctx.capture.window_s <= 0:
        return None
    return 100.0 * flops / ctx.capture.window_s / ctx.roofline.TF32_FLOPS_PER_S

"""CUDA kernel launches an evaluated image: the kernels of the traced
stretch over the images it explained and scored."""


def read(ctx):
    if not ctx.capture.kernels or not ctx.window.traced_items:
        return None
    return len(ctx.capture.kernels) / ctx.window.traced_items

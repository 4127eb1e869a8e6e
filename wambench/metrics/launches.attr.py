"""CUDA kernel launches an attribution: the kernels of the traced stretch
over the attributions it completed (the host's dispatch work)."""


def read(ctx):
    if not ctx.capture.kernels or not ctx.window.traced_items:
        return None
    return len(ctx.capture.kernels) / ctx.window.traced_items

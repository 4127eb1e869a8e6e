"""K3's share of its roofline over the traced stretch: the least time of
the stretch's collapsed syntheses and their adjoints
(`wambench.roofline.k3_bound_s`) over the device time of the
``forward_kernel`` and ``backward_kernel`` launches, in %."""


def read(ctx):
    evs = [e for e in ctx.capture.kernels
           if "forward_kernel" in e.name or "backward_kernel" in e.name]
    t = ctx.capture.busy_s(evs)
    if t <= 0:
        return None
    return 100.0 * ctx.facts["k3_bound_s_per_call"] * ctx.window.traced_calls / t

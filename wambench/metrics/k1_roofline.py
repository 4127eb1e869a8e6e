"""K1's share of its roofline over the traced stretch: the least time of
the stretch's analysis levels (`wambench.roofline.k1_bound_s`: the bytes
each level must move at 3.35 TB/s, or its float32 work at 67 TFLOP/s,
whichever is larger) over the device time of the ``band2_kernel``
launches, in %. K2 shares that kernel template; the reader returns nothing
when the package counted a K2 launch in the stretch."""

import sys


def read(ctx):
    if ctx.window.traced_launches.get("synth2", 0):
        print("k1_roofline: K2 launched in the stretch; band2_kernel time is not K1's alone",
              file=sys.stderr)
        return None
    evs = [e for e in ctx.capture.kernels if "band2_kernel" in e.name]
    t = ctx.capture.busy_s(evs)
    if t <= 0:
        return None
    return 100.0 * ctx.facts["k1_bound_s_per_call"] * ctx.window.traced_calls / t

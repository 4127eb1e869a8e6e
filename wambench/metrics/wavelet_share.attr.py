"""The 2D transforms' share of the card's busy time over the traced
stretch: device time launched inside the package's ``wam_analysis`` and
``wam_synth`` ranges, or by its transform kernels (K1 ``band2_kernel``,
K3 ``forward_kernel`` / ``backward_kernel``, whose backward launches run
outside those ranges), over all device time, in %."""

TOKENS = ("wam_analysis", "wam_synth", "band2_kernel", "forward_kernel", "backward_kernel")


def read(ctx):
    cap = ctx.capture
    busy = cap.busy_s()
    if busy <= 0:
        return None
    mine = [e for e in cap.device if any(ctx.trace.under(e, t) for t in TOKENS)]
    return 100.0 * cap.busy_s(mine) / busy

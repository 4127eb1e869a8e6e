"""The share of the traced stretch in which no kernel, copy or memset ran
on the card, in %."""


def read(ctx):
    if not ctx.capture.device or ctx.capture.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.capture.busy_s() / ctx.capture.window_s)

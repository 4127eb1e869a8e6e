"""The evaluators' host share: the host seconds inside the package's
``fan.dispatch`` spans (enqueueing a metric's fan step) over the traced
stretch's host-clock seconds, in %."""


def read(ctx):
    spans = [s for s in ctx.window.traced_spans if s["name"] == "fan.dispatch"]
    if not spans or ctx.window.traced_host_s <= 0:
        return None
    return 100.0 * sum(s["t1"] - s["t0"] for s in spans) / ctx.window.traced_host_s

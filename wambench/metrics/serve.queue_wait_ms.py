"""The mean queue wait of the requests answered in the traced stretch: the
package's ``queue_wait`` spans (submit to the batch's dispatch), in ms."""


def read(ctx):
    waits = [s["t1"] - s["t0"] for s in ctx.window.traced_spans if s["name"] == "queue_wait"]
    if not waits:
        return None
    return 1e3 * sum(waits) / len(waits)

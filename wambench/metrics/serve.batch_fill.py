"""Requests a dispatched batch, the mean over the batches that completed in
the traced stretch: the ``n_real`` of the package's per-request
``service`` spans, one value a batch (its requests share the span's
start)."""


def read(ctx):
    batches = {}
    for s in ctx.window.traced_spans:
        if s["name"] == "service" and "n_real" in s["attrs"]:
            batches[s["t0"]] = s["attrs"]["n_real"]
    if not batches:
        return None
    return sum(batches.values()) / len(batches)

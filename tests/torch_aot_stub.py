"""A recording stand-in for the compiled-step cache's dispatcher
(`wam_tpu_torch.pipeline.aot.cached_entry`): the compiled entries' tests
that check which programs an entry makes, without paying for the compile,
run each step through it eagerly and read the keys it was asked for."""


def record_aot_keys(monkeypatch) -> list:
    """Patch `pipeline.aot.cached_entry` for the test; returns the list the
    keys of the dispatchers it makes are appended to."""
    from wam_tpu_torch.pipeline import aot

    keys: list = []

    def cached_entry(unit, key, **kw):
        keys.append(key)

        def entry(*args):
            return unit(*args)

        entry.fns = {}
        return entry

    monkeypatch.setattr(aot, "cached_entry", cached_entry)
    return keys

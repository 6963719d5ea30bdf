"""The plan's finalize a request, mean ms over the window, as
``TreeEngine.drain_stage_timings()`` gives it."""


def read(records, cfg):
    ms, calls = records.get("stages", {}).get("finalize", (0.0, 0))
    return ms / calls if calls else None

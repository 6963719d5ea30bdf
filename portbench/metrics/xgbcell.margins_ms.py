"""A margin model's finalize a request, mean ms over the window: the signed
view of the merged partials, the base add and the argmax, the ``margins``
stage that ``TreeEngine.drain_stage_timings()`` gives.  A program without
that stage reads nothing."""


def read(records, cfg):
    ms, calls = records.get("stages", {}).get("margins", (0.0, 0))
    return ms / calls if calls else None

"""The micro-batcher's mean queue wait a request over the window: the
``queue`` stage of ``Gateway.stats()``, differenced across the window."""


def read(records, cfg):
    c = records.get("counters", {})
    return c["queue_ms"] / c["queue_count"] if c.get("queue_count") else None

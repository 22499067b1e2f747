"""stream.drain_ms (ms): the stream's own StageTimers "drain" a batch
over the traced window (the wait for the result, the report loop)."""


def read(w):
    t = w.context.get("timers")
    if t is None or not t.counts.get("drain"):
        return None
    return 1e3 * t.totals["drain"] / t.counts["drain"]

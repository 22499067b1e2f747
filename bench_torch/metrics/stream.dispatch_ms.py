"""stream.dispatch_ms (ms): the stream's own StageTimers "dispatch" a
batch over the traced window (the feed, the staging copy, the launch)."""


def read(w):
    t = w.context.get("timers")
    if t is None or not t.counts.get("dispatch"):
        return None
    return 1e3 * t.totals["dispatch"] / t.counts["dispatch"]

"""Requests completed in the window over `ModelEntry.dispatch` calls: the
mean batch the micro-batching hands the device, padding left out."""


def read(r):
    calls = r.spans.counters.get("dispatch_calls", 0)
    if not calls or "requests" not in r.facts:
        return None
    return r.facts["requests"] / calls

"""The median host milliseconds of one request's `unstage_result`
call in the window (serve/engine.py), as the batching front calls it."""
import statistics


def read(r):
    d = r.spans.durations("unstage")
    return 1e3 * statistics.median(d) if d else None

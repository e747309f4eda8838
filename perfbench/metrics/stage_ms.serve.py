"""The median host milliseconds of one request's `stage_request`
call in the window (serve/engine.py), as the batching front calls it."""
import statistics


def read(r):
    d = r.spans.durations("stage")
    return 1e3 * statistics.median(d) if d else None

"""The share of an untraced step in which the card runs nothing: one minus
the device's busy time per step, the union of every kernel's, copy's and
memset's intervals in the traced steps over their number, over the
window's wall time per step. The profiler slows the host's enqueue, so
the traced steps' own wall time would read the tracer's cost as idle."""
from perfbench import counts


def read(r):
    f = r.facts
    if r.slice is None or not r.device_events() or not f.get("traced_steps"):
        return None
    busy_per_step = r.busy_s() / f["traced_steps"]
    return 100.0 - counts.percent(busy_per_step, f["window_s"] / f["steps"])

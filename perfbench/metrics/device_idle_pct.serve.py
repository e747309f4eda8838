"""The share of the traced slice in which no kernel, copy or memset runs
on the card: one minus the union of their intervals over the slice."""
from perfbench import counts


def read(r):
    if r.slice is None or not r.device_events():
        return None
    return 100.0 - counts.percent(r.busy_s(), r.slice.window_s)

"""Kernel milliseconds per optimizer step: the sum of every kernel's
duration in the traced steps, over their number."""


def read(r):
    if r.slice is None or not r.facts.get("traced_steps"):
        return None
    kernels = r.device_events(("kernel",))
    if not kernels:
        return None
    return 1e3 * sum(e.end - e.start for e in kernels) / r.facts["traced_steps"]

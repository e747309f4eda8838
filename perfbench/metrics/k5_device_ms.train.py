"""K5's device milliseconds per profiled optimizer step: the summed
durations of its kernel, found in the trace by its function name, over
the traced steps."""

NAME = "relpos_attention_kernel"


def read(r):
    if r.slice is None or not r.facts.get("traced_steps"):
        return None
    kernels = [e for e in r.device_events(("kernel",)) if NAME in e.name]
    if not kernels:
        return None
    return 1e3 * sum(e.end - e.start for e in kernels) / r.facts["traced_steps"]

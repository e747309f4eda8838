"""K5's share of its roofline in the traced slice: the bounds of the K5
calls the device trace holds (`counts.bound_s` of `configs/<builder>.py`
`k5_counts` at the cell's shapes, a forward's calls in their fixed mix of
windowed and global ones) over K5's device time there. Calls and time are
read from the trace by the kernel's function name, not by wrapping its
launcher, which a replayed CUDA graph never calls."""
from perfbench import counts

NAME = "relpos_attention_kernel"


def read(r):
    f = r.facts
    if r.slice is None or not f.get("k5_calls_per_forward"):
        return None
    kernels = [e for e in r.device_events(("kernel",)) if NAME in e.name]
    seconds = sum(e.end - e.start for e in kernels)
    if not kernels or seconds <= 0:
        return None
    bound = len(kernels) * f["k5_bound_s_per_forward"] / f["k5_calls_per_forward"]
    return counts.percent(bound, seconds)

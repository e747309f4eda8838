"""The served forward's share of the card's bf16 peak in the traced slice:
the analytic forward FLOPs of the real rows fetched in the slice (padding
left out), over the union of the kernels' intervals there."""
from perfbench import counts


def read(r):
    if r.slice is None or "forward_flops_per_image" not in r.facts:
        return None
    t0, t1 = r.slice.t0, r.slice.t1
    rows = sum(n for k, t, n, _ in r.spans.launches if k == "rows" and t0 <= t < t1)
    busy = r.busy_s(("kernel",))
    if not rows or busy <= 0:
        return None
    return counts.percent(rows * r.facts["forward_flops_per_image"] / busy,
                          counts.PEAK_BF16_FLOPS)

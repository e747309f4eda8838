"""The train step's share of the card's bf16 peak: the configuration's
analytic FLOPs of every image of every step in the measured window, over
the window's wall time (`counts.py`, `configs/<builder>.py`
`train_flops`). The window runs untraced in a `--trace 1` run too: the
profiled steps come after it."""
from perfbench import counts


def read(r):
    f = r.facts
    if "train_flops_per_image" not in f:
        return None
    rate = f["steps"] * f["images_per_step"] * f["train_flops_per_image"] / f["window_s"]
    return counts.percent(rate, counts.PEAK_BF16_FLOPS)

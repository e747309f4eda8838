"""K4's share of its roofline in the traced slice: the sum of its calls'
bounds (`counts.py`, from each call's shapes) over the device time of its
kernels."""


def read(r):
    return r.roofline_pct("k4")

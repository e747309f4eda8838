"""The readings of the program's train-step spans (`spans_probe.py`) on
synthetic span logs and a synthetic device slice: the per-phase median
over steps, None where the log cannot give it, `train.step`'s self time,
and idle gaps put down to the innermost open span."""
import dataclasses
from typing import List, Optional

import pytest

from perfbench import spans_probe, tracing


@dataclasses.dataclass
class S:
    name: str
    start: float
    end: float
    parent: Optional[int]
    step: int
    micro: Optional[int] = None


@dataclasses.dataclass
class Log:
    spans: List[S]


def _step(step, t0, forward, accum=2, backward=0.002):
    """One step's spans from t0: per micro-batch a forward of `forward[i]`
    seconds, a 1 ms loss and a backward, then a 1 ms update; 1 ms of self
    time before the first micro-batch."""
    top = S("train.step", t0, 0.0, None, step)
    out, at = [top], t0 + 0.001
    for i in range(accum):
        for name, d in (("train.forward", forward[i]), ("train.loss", 0.001),
                        ("train.backward", backward)):
            out.append(S(name, at, at + d, None, step, i))
            at += d
    out.append(S("train.update", at, at + 0.001, None, step))
    top.end = at + 0.001
    return out


def _log(*steps):
    spans = []
    for st in steps:
        base = len(spans)
        for s in st:
            if s.name != "train.step":
                s.parent = base
            spans.append(s)
    return Log(spans)


def test_phase_ms_is_the_median_over_steps_of_each_steps_sum():
    log = _log(_step(0, 0.0, [0.010, 0.020]), _step(1, 1.0, [0.040, 0.050]),
               _step(2, 2.0, [0.005, 0.005]))
    assert spans_probe.phase_ms(log.spans, "train.forward", 2, 3) == pytest.approx(30.0)
    assert spans_probe.phase_ms(log.spans, "train.loss", 2, 3) == pytest.approx(2.0)
    assert spans_probe.phase_ms(log.spans, "train.backward", 2, 3) == pytest.approx(4.0)
    assert spans_probe.phase_ms(log.spans, "train.update", 2, 3) == pytest.approx(1.0)
    assert spans_probe.self_ms(log) == pytest.approx(1.0)


@pytest.mark.parametrize("case", ["no log", "fewer steps", "forward count"])
def test_phase_ms_is_none_where_the_log_cannot_give_it(case):
    log = _log(_step(0, 0.0, [0.01, 0.01]), _step(1, 1.0, [0.01, 0.01]))
    if case == "no log":
        spans = None
    elif case == "fewer steps":
        spans = log.spans
    else:  # step 1 ran three micro-batches
        spans = _log(_step(0, 0.0, [0.01, 0.01]), _step(1, 1.0, [0.01] * 3, accum=3),
                     _step(2, 2.0, [0.01, 0.01])).spans
    steps = 3
    assert spans_probe.phase_ms(spans, "train.forward", 2, steps) is None


def test_idle_gaps_go_to_the_innermost_open_span_or_outside():
    log = _log(_step(0, 0.0, [0.010, 0.010], backward=0.010))
    # forward 0 in [0.001, 0.011), loss [0.011, 0.012), backward [0.012, 0.022), ...
    dslice = tracing.DeviceSlice("cpu")
    dslice.t0, dslice.t1 = -0.004, 0.050
    dslice.events = [tracing.DeviceEvent("k", "kernel", s, e)
                     for s, e in ((-0.002, 0.003), (0.009, 0.0125), (0.016, 0.060))]
    idle = spans_probe.idle_by_span(log, dslice, steps=2)
    # [-4, -2) ms outside; [3, 9) ms under forward 0; [12.5, 16) ms under backward 0
    assert idle == {"train.forward": pytest.approx(3.0), "train.backward": pytest.approx(1.75),
                    "outside": pytest.approx(1.0)}
    assert list(idle) == ["train.forward", "train.backward", "outside"]
    assert spans_probe.innermost(log, 0.0005) == "train.step"
    assert spans_probe.innermost(log, 1.0) == "outside"

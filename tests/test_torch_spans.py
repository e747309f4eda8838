"""The spans inside the port's train step (utils/profiling.py `span`,
`record_spans`, `trace_context`; train/steps.py `train_step`): off, the
step makes no span and enters no profiler range; on, it records one
`train.step` holding each micro-batch's forward, loss and backward and
one update, on the calling thread and under the step's number, and
changes no number the step computes."""
import glob
import json
import threading

import pytest
import torch

from image_segmentation_tpu_torch.losses import DiceCELoss
from image_segmentation_tpu_torch.models.unet import UNet
from image_segmentation_tpu_torch.train.state import TrainState, make_adamw
from image_segmentation_tpu_torch.train.steps import train_step
from image_segmentation_tpu_torch.utils import profiling

torch.set_num_threads(1)

PHASES = ("train.forward", "train.loss", "train.backward")


def _state(seed=0):
    torch.manual_seed(seed)
    model = UNet(base=4).to(memory_format=torch.channels_last)
    return TrainState(model, *make_adamw(model.parameters()))


def _batch(seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(4, 32, 32, 3, generator=g), torch.randint(0, 4, (4, 32, 32), generator=g)


@pytest.fixture(autouse=True)
def spans_off():
    assert profiling.SPANS is None
    yield
    profiling.SPANS = None


def test_spans_off_make_no_span_and_enter_no_profiler_range(monkeypatch):
    assert profiling.span("train.step") is profiling.span("x", micro=1) is profiling._OFF

    def refused(*a, **k):
        raise AssertionError("a span was made with spans off")

    monkeypatch.setattr(profiling, "Span", refused)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        train_step(_state(), DiceCELoss(), *_batch(), accum_steps=2)
    names = {e.name for e in prof.events()}
    assert any("conv" in n for n in names)  # the step's ops were recorded
    assert not [n for n in names if n.startswith("train.")]


def test_spans_on_nest_each_micro_batch_under_its_step():
    st = _state()
    st.step = 5
    with profiling.record_spans() as log:
        train_step(st, DiceCELoss(), *_batch(), accum_steps=2)
    assert profiling.SPANS is None and st.step == 6
    names = [s.name for s in log.spans]
    assert {n: names.count(n) for n in names} == {
        "train.step": 1, "train.forward": 2, "train.loss": 2, "train.backward": 2,
        "train.update": 1}
    top = log.spans[0]
    assert top.name == "train.step" and top.parent is None and top.micro is None
    for s in log.spans[1:]:
        assert s.parent == 0 and top.start <= s.start <= s.end <= top.end
    for s in log.spans:
        assert s.step == 5 and s.thread == threading.get_ident()
    for name in PHASES:
        assert [s.micro for s in log.spans if s.name == name] == [0, 1]
    assert log.spans[-1].name == "train.update" and log.spans[-1].micro is None
    # the phases follow one another in the order the step runs them
    assert names[1:] == list(PHASES) * 2 + ["train.update"]
    assert all(a.end <= b.start for a, b in zip(log.spans[1:], log.spans[2:]))


def test_spans_on_change_no_number():
    loss_fn = DiceCELoss()
    off, on = _state(), _state()
    losses = {"off": [], "on": []}
    for i in range(2):
        losses["off"].append(train_step(off, loss_fn, *_batch(i), accum_steps=2))
        with profiling.record_spans() as log:
            losses["on"].append(train_step(on, loss_fn, *_batch(i), accum_steps=2))
        assert len(log.spans) == 8
    for a, b in zip(losses["off"], losses["on"]):
        assert torch.equal(a, b)
    want, got = off.model.state_dict(), on.model.state_dict()
    assert set(want) == set(got) and any("running_var" in k for k in want)
    for k in want:
        assert torch.equal(want[k], got[k]), k


def test_trace_context_writes_the_phases_as_profiler_ranges(tmp_path):
    st = _state()
    with profiling.trace_context(str(tmp_path)):
        assert profiling.SPANS is not None
        train_step(st, DiceCELoss(), *_batch(), accum_steps=2)
    assert profiling.SPANS is None
    traces = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        ranges = [e["name"] for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    assert ranges.count("train.step") == 1
    assert ranges.count("train.forward") == ranges.count("train.backward") == 2


def test_record_spans_gives_a_fresh_log_and_puts_back_the_one_before():
    with profiling.record_spans() as outer:
        with profiling.span("a", step=3):
            with profiling.record_spans() as inner:
                assert profiling.SPANS is inner and inner is not outer
                with profiling.span("b"):
                    pass
            assert profiling.SPANS is outer
            with profiling.span("c", micro=7):
                pass
    assert profiling.SPANS is None
    assert [(s.name, s.parent, s.step, s.micro) for s in outer.spans] == [
        ("a", None, 3, None), ("c", 0, 3, 7)]
    assert [(s.name, s.parent, s.step) for s in inner.spans] == [("b", None, None)]


def test_each_thread_nests_its_spans_on_its_own_stack():
    seen = threading.Event()
    go = threading.Event()

    def other():
        with profiling.span("worker", step=9):
            seen.set()
            go.wait(10)
            with profiling.span("worker.inner"):
                pass

    with profiling.record_spans() as log:
        with profiling.span("main", step=1):
            t = threading.Thread(target=other)
            t.start()
            assert seen.wait(10)
            with profiling.span("main.inner"):
                go.set()
            t.join(10)
            assert not t.is_alive()
    by = {s.name: s for s in log.spans}
    idx = {s.name: i for i, s in enumerate(log.spans)}
    assert by["main.inner"].parent == idx["main"] and by["main.inner"].step == 1
    assert by["worker.inner"].parent == idx["worker"] and by["worker.inner"].step == 9
    assert by["worker"].parent is None and by["worker"].thread != by["main"].thread


def test_a_step_that_raises_closes_its_spans():
    st = _state()
    x, y = _batch()
    x[1, 3, 4, 0] = float("nan")
    profiling.enable_nan_checks()
    try:
        with profiling.record_spans() as log:
            with pytest.raises(FloatingPointError, match="micro-batch 0"):
                train_step(st, DiceCELoss(), x, y, accum_steps=2)
            assert log._stack() == []
    finally:
        profiling.enable_nan_checks(False)
    assert [s.name for s in log.spans] == ["train.step", "train.forward", "train.loss"]
    assert all(s.end is not None and s.end >= s.start for s in log.spans)

"""The harness's own machinery on the CPU: discovery by name, the seeded
schedule, latency from the due time, the percentiles, the device-interval
arithmetic and the result line."""
import json
import os
import re
import threading
import time

import numpy as np
import pytest

from perfbench import harness, tracing
from perfbench.kinds import serve_open

BENCH = harness.read_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


EXTRA = harness.read_json(os.path.join(os.path.dirname(__file__), "extra_cells.json"))


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"] + EXTRA["workloads"]])
def test_every_cell_finds_its_files_by_name(workload, bench_path):
    cell = harness.load_cell(workload, bench_path)
    assert cell.kind.run and cell.builder.port and cell.builder.reference
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert callable(harness.metric_reader(m["name"]))


def test_names_units_and_keys_keep_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics + BENCH["workloads"] + BENCH["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) for m in metrics)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert 1 <= len(w["why"]) <= 200 and w["chips"] in (1, 4)
        assert os.path.exists(os.path.join(harness.HERE, "traffic", w["traffic"] + ".json"))
    for c in BENCH["configs"]:
        assert os.path.exists(os.path.join(harness.ROOT, c["file"]))
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert len(json.dumps(BENCH)) < 64 * 1024


def _traffic(**kw):
    t = harness.read_json(os.path.join(harness.HERE, "traffic", "pet_poisson_r160.json"))
    return dict(t, sizes={"mix": "oxford_iiit_pet", "scale": 0.1}, **kw)


def test_schedule_repeats_exactly_for_a_seed_and_keeps_the_work_across_seeds():
    a = serve_open.Schedule(_traffic(), 2.0, 2**31 + 9, "cpu")
    b = serve_open.Schedule(_traffic(), 2.0, 2**31 + 9, "cpu")
    c = serve_open.Schedule(_traffic(), 2.0, 7, "cpu")
    assert np.array_equal(a.due, b.due) and a.sizes == b.sizes
    assert all(np.array_equal(x, y) for x, y in zip(a.pixels, b.pixels))
    assert len(a) == round(160 * 2.0) and a.due[-1] == pytest.approx(2.0)
    assert sorted(np.diff(a.due, prepend=0)) == pytest.approx(sorted(np.diff(c.due, prepend=0)))
    assert sorted(a.sizes) == sorted(c.sizes) and a.sizes != c.sizes
    assert a.sample(1, 5) == b.sample(1, 5) and len(set(a.sample(1, 5))) == 5
    assert a.sample(1, 5)[0] == int(np.argmax([h * w for h, w in a.sizes]))


class _Stalling:
    """A served path whose first request stalls; one client at a time."""

    def __init__(self, stall):
        self.stall, self.lock = stall, threading.Lock()

    def segment(self, rid, image):
        with self.lock:
            time.sleep(self.stall if rid == 0 else 0.001)
        if rid == 3:
            raise RuntimeError("refused")
        return np.zeros(image.shape[:2], np.uint8)


def test_latency_counts_from_the_due_time_under_a_stall():
    sched = serve_open.Schedule(_traffic(rate_per_s=50.0), 0.2, 3, "cpu")  # 10 requests
    t0, done, results, late = serve_open.open_loop(_Stalling(0.3), sched, clients=4)
    lat, failed = serve_open._latencies(sched, t0, done, results)
    assert failed == 1 and lat[3] == serve_open.WAIT_AFTER_CLOSE_S
    # every request due during the stall waited for it: its latency runs from its due time
    for i in range(1, len(sched)):
        if i != 3:
            assert lat[i] >= 0.3 - sched.due[i] - 0.005
    assert max(late) < 0.05  # the generator itself kept its schedule


def test_p95_is_over_all_requests_with_failures_as_misses():
    lat = np.concatenate([np.full(95, 0.010), np.full(5, serve_open.WAIT_AFTER_CLOSE_S)])
    assert harness.percentile(lat, 50) == pytest.approx(0.010)
    assert harness.percentile(lat, 95) > 0.010
    assert harness.percentile(lat, 94) == pytest.approx(0.010)


def test_idle_share_is_a_union_of_intervals_not_a_sum():
    busy = [(0.0, 2.0), (1.0, 3.0), (2.5, 4.0), (6.0, 7.0)]
    assert tracing.union(busy) == [(0.0, 4.0), (6.0, 7.0)]
    assert tracing.gaps(busy, 0.0, 10.0) == [(4.0, 6.0), (7.0, 10.0)]
    sp = tracing.Spans(True)
    dslice = tracing.DeviceSlice("cpu")
    dslice.t0, dslice.t1 = 0.0, 10.0
    dslice.events = [tracing.DeviceEvent("void conv3x3_kernel(x)", "kernel", s, e)
                     for s, e in busy]
    r = tracing.Reading(sp, dslice, {})
    assert r.busy_s() == pytest.approx(5.0)
    assert harness.metric_reader("device_idle_pct.serve")(r) == pytest.approx(50.0)
    # the train share holds the traced steps' busy time against an untraced step's wall time
    r.facts.update(traced_steps=2, steps=50, window_s=500.0)  # 10 s a step, 2.5 s busy
    assert harness.metric_reader("device_idle_pct.train")(r) == pytest.approx(75.0)
    sp.items.append(("stage", 1, 3.5, 6.5))
    assert r.breakdown()["idle_gaps"][0] == ["no span", pytest.approx(3.0)]
    assert r.breakdown()["idle_gaps"][1] == ["stage", pytest.approx(2.0)]


def test_roofline_scales_the_bounds_to_the_calls_the_trace_holds():
    sp = tracing.Spans(True)
    for t in (1.0, 2.0, 3.0):
        sp.launches.append(("k3", t, 0.0, 3.35e12 * 1e-3))  # 1 ms bound each
    dslice = tracing.DeviceSlice("cpu")
    dslice.t0, dslice.t1 = 0.0, 10.0
    dslice.events = [tracing.DeviceEvent("void attention_kernel<4>(x)", "kernel", t, t + 0.004)
                     for t in (1.0, 2.0)]  # one record lost: two calls seen
    r = tracing.Reading(sp, dslice, {})
    assert r.roofline_pct("k3") == pytest.approx(25.0)
    assert r.roofline_pct("k1") is None


def test_result_line_keys_and_checks_last():
    cell = harness.load_cell("unet64_train_b64")
    out = harness.Outcome({"train_images_per_s": 400.0, "setup_s": 20.0}, 10, 0,
                          [harness.Check("loss_rel", 0.001, 0.01)], 123)
    dev = {"platform": "gpu", "kind": "x", "count": 1, "memory_peak_bytes": 123}
    line = harness.result_line(cell, out, False, dev)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True
    assert set(line["metrics"]) == {"train_images_per_s", "setup_s"}
    out.checks.append(harness.Check("grad1_rel", 0.5, None))
    assert harness.result_line(cell, out, False, dev)["correct"] is False


def test_a_cells_host_threads_are_set_before_torch_loads(monkeypatch, bench_path):
    from perfbench import run

    monkeypatch.setattr(os, "environ", dict(os.environ, OMP_NUM_THREADS="8"))
    run._environment("unet64_serve_poisson", bench_path)
    assert os.environ["OMP_NUM_THREADS"] == "1"
    assert os.environ["TRITON_CACHE_DIR"].startswith(harness.ROOT)
    monkeypatch.setattr(os, "environ", dict(os.environ, OMP_NUM_THREADS="8"))
    run._environment("unet64_train_b64")  # the train mix states none: left as it is
    assert os.environ["OMP_NUM_THREADS"] == "8"


def test_a_lost_marker_aligns_the_slice_by_its_first_work(tmp_path):
    """Without the marker kernel's record the slice's first device work is
    taken to start at t0: the busy share still comes out right."""
    trace = {"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 1000.0, "dur": 2e6},
        {"ph": "X", "cat": "gpu_memcpy", "name": "b", "ts": 3e6 + 1000.0, "dur": 1e6},
        {"ph": "X", "cat": "cpu_op", "name": "c", "ts": 0.0, "dur": 9e6}]}

    class Prof:
        def export_chrome_trace(self, path):
            with open(path, "w") as f:
                json.dump(trace, f)

    dslice = tracing.DeviceSlice("cpu")
    dslice.t0, dslice.t1, dslice._prof = 50.0, 55.0, Prof()
    dslice.finish()
    assert not dslice.aligned_by_marker
    assert [(e.name, e.start) for e in dslice.events] == [("a", 50.0), ("b", 53.0)]
    assert tracing.Reading(tracing.Spans(True), dslice, {}).busy_s() == pytest.approx(3.0)

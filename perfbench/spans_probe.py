"""The program's train-step spans (`utils.profiling.record_spans`) read on
the card, in the cell unet64_train_b64, outside the benchmark's runs:

    python3 perfbench/spans_probe.py --seed <n>

After set-up as the cell's (seeded weights and set, the checked and
warm-up steps) it runs, in turn:
  * an untraced window of WINDOW_S seconds, spans off (`step_ms`);
  * a spans pass of SPAN_STEPS steps, spans on, no profiler and none of
    the benchmark's wrappers: host ms a step per phase (the median over
    the pass's steps of each step's summed durations of one span name),
    `pass_step_ms` and the median self time of `train.step`;
  * ROUNDS pairs of SPAN_STEPS-step blocks, spans off and on in turns,
    and an empty span's host microseconds off and on: the spans' cost;
  * `trace_steps` steps under `tracing.DeviceSlice`, spans on in a second
    log, their batches gathered before the slice starts: the clock check
    (the marker's alignment, and no device event before the first
    `train.step` opens) and the slice's idle ms a step by the innermost
    program span open at each gap's midpoint, or `outside`.

Prints one JSON object. Exits 3 without a CUDA card. The functions that
read the logs take what the benchmark's readers would (`phase_ms`,
`self_ms`, `idle_by_span`).
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from typing import Dict, Optional  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKLOAD = "unet64_train_b64"
WINDOW_S = 20.0
SPAN_STEPS = 10
ROUNDS = 8
PHASES = {"train.forward": "host_forward_ms.train", "train.loss": "host_loss_ms.train",
          "train.backward": "host_backward_ms.train", "train.update": "host_update_ms.train"}


def step_sums(spans, accum: int, steps: int) -> Optional[Dict[int, Dict[str, float]]]:
    """{step: {span name: summed seconds}} of the spans' steps, or None when
    there are no spans, they hold fewer than `steps` steps, or a step ran
    another number of `train.forward` spans than `accum`."""
    if spans is None:
        return None
    sums: Dict[int, Dict[str, float]] = {}
    forwards: Dict[int, int] = {}
    for s in spans:
        d = sums.setdefault(s.step, {})
        d[s.name] = d.get(s.name, 0.0) + (s.end - s.start)
        forwards[s.step] = forwards.get(s.step, 0) + (s.name == "train.forward")
    if len(sums) < steps or any(n != accum for n in forwards.values()):
        return None
    return sums


def phase_ms(spans, name: str, accum: int, steps: int) -> Optional[float]:
    """Median over the spans' steps of each step's summed ms of `name`."""
    sums = step_sums(spans, accum, steps)
    if sums is None:
        return None
    return 1e3 * statistics.median(d.get(name, 0.0) for d in sums.values())


def self_ms(log) -> Optional[float]:
    """Median self time of `train.step`: its duration less its children's."""
    kids: Dict[int, float] = {}
    for s in log.spans:
        if s.parent is not None:
            kids[s.parent] = kids.get(s.parent, 0.0) + (s.end - s.start)
    own = [(s.end - s.start) - kids.get(i, 0.0) for i, s in enumerate(log.spans)
           if s.name == "train.step"]
    return 1e3 * statistics.median(own) if own else None


def innermost(log, t: float) -> str:
    """The latest-opened span open at time t, in any thread, or 'outside'."""
    best = None
    for s in log.spans:
        if s.start <= t < s.end and (best is None or s.start > best.start):
            best = s
    return best.name if best else "outside"


def idle_by_span(log, dslice, steps: int) -> Dict[str, float]:
    """The slice's idle ms a step, by the innermost program span open at
    each gap's midpoint (`tracing.gaps` over every device event)."""
    from perfbench import tracing

    busy = [(e.start, e.end) for e in dslice.events]
    idle: Dict[str, float] = {}
    for a, b in tracing.gaps(busy, dslice.t0, dslice.t1):
        k = innermost(log, 0.5 * (a + b))
        idle[k] = idle.get(k, 0.0) + 1e3 * (b - a) / steps
    return dict(sorted(idle.items(), key=lambda kv: -kv[1]))


def span_us(n: int = 100000) -> Dict[str, float]:
    """Host microseconds of one empty span with spans off and on (no
    profiler recording): the spans' own cost, apart from the host's drift."""
    from image_segmentation_tpu_torch.utils.profiling import record_spans, span

    def loop():
        t0 = time.perf_counter()
        for _ in range(n):
            with span("train.forward", micro=0):
                pass
        return 1e6 * (time.perf_counter() - t0) / n

    off = loop()
    with record_spans():
        return {"off": off, "on": loop()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, required=True)
    args = p.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from perfbench import run as pb_run

    pb_run._environment(WORKLOAD)
    import torch

    if not torch.cuda.is_available():
        print("spans_probe: no CUDA card", file=sys.stderr)
        return 3
    from image_segmentation_tpu_torch.losses import DiceCELoss
    from image_segmentation_tpu_torch.train.loop import train_device_budget
    from image_segmentation_tpu_torch.train.state import (
        TrainState,
        freeze_,
        make_adamw,
        trainable_parameters,
    )
    from image_segmentation_tpu_torch.train.steps import (
        ResidentTrainSet,
        resident_plan,
        train_step,
    )
    from image_segmentation_tpu_torch.utils.profiling import record_spans
    from perfbench import harness, tracing

    cell = harness.load_cell(WORKLOAD)
    kind, cfg, tr, spec = cell.kind, cell.cfg, cell.traffic, cell.builder
    device = torch.device("cuda")
    sync = lambda: torch.cuda.synchronize(device)  # noqa: E731
    model = harness.build(spec, cfg, device, harness.make_weights(spec, cfg, args.seed, device),
                          "port")
    freeze_(model, spec.FROZEN)
    opt, sched = make_adamw(trainable_parameters(model, spec.FROZEN),
                            learning_rate=cfg["learning_rate"], weight_decay=cfg["weight_decay"])
    state = TrainState(model, opt, sched)
    loss_fn = DiceCELoss(class_weights=tuple(cfg["class_weights"]),
                         smooth_dice=cfg["dice_smooth"])
    images, labels = kind.make_set(cfg, tr, args.seed, device)
    plan = resident_plan(images.nbytes, train_device_budget(device))
    data = ResidentTrainSet(images, labels, device, quantize=plan == "uint8")
    batch, accum = tr["micro_batch"] * tr["accum_steps"], tr["accum_steps"]
    orders = kind.epoch_orders(args.seed, tr["set_size"], batch)

    def feed():
        for order in orders:
            idx = torch.from_numpy(order).to(device)
            for s in range(len(order)):
                yield data.batch(idx[s])

    batches = feed()

    def steps(n):
        for _ in range(n):
            train_step(state, loss_fn, *next(batches), accum_steps=accum)

    def timed(n):
        sync()
        t0 = time.perf_counter()
        steps(n)
        sync()
        return 1e3 * (time.perf_counter() - t0) / n

    steps(tr["checked_steps"] + tr["warmup_steps"])
    out = {"card": pb_run._card(), "torch": torch.__version__, "seed": args.seed,
           "setup_s": time.perf_counter() - T_START}
    sync()
    n, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < WINDOW_S:
        steps(1)
        n += 1
    sync()
    out.update(step_ms=1e3 * (time.perf_counter() - t0) / n, window_steps=n)

    with record_spans() as log:
        out["pass_step_ms"] = timed(SPAN_STEPS)
    for name, metric in PHASES.items():
        out[metric] = phase_ms(log.spans, name, accum, SPAN_STEPS)
    out["step_span_ms"] = phase_ms(log.spans, "train.step", accum, SPAN_STEPS)
    out["step_self_ms"] = self_ms(log)
    out["spans_per_step"] = len(log.spans) / SPAN_STEPS
    out["span_us"] = span_us()
    out["spans_ms_per_step"] = (1e-3 * out["spans_per_step"]
                                * (out["span_us"]["on"] - out["span_us"]["off"]))

    blocks = {"off": [], "on": []}
    for r in range(ROUNDS):
        for which in (("off", "on") if r % 2 == 0 else ("on", "off")):
            if which == "on":
                with record_spans():
                    blocks[which].append(timed(SPAN_STEPS))
            else:
                blocks[which].append(timed(SPAN_STEPS))
    out["blocks_step_ms"] = blocks

    trace_steps = tr["trace_steps"]
    dslice = tracing.DeviceSlice(device)
    with record_spans() as slog:
        dslice.prime()
        steps(tr["warmup_steps"])
        ahead = [next(batches) for _ in range(trace_steps)]
        dslice.start()
        for x, y in ahead:
            train_step(state, loss_fn, x, y, accum_steps=accum)
        dslice.stop()
    dslice.finish()
    reading = tracing.Reading(tracing.Spans(False), dslice, {})
    events = reading.device_events()
    traced = [s for s in slog.spans if s.start >= dslice.t0]
    first = min(s.start for s in traced if s.name == "train.step")
    out.update(
        aligned_by_marker=dslice.aligned_by_marker,
        first_event_after_first_step_ms=1e3 * (min(e.start for e in events) - first),
        events_before_first_step=sum(1 for e in events if e.start < first),
        traced_step_ms=1e3 * dslice.window_s / trace_steps,
        kernel_ms_per_step=1e3 * sum(e.end - e.start for e in reading.device_events(
            ("kernel",))) / trace_steps,
        busy_ms_per_step=1e3 * reading.busy_s() / trace_steps,
        idle_ms_by_program_span=idle_by_span(slog, dslice, trace_steps),
        traced_phase_ms={name: phase_ms(traced, name, accum, trace_steps)
                         for name in list(PHASES) + ["train.step"]})
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

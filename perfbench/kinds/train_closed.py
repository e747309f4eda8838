"""A closed loop of optimizer steps: `train_step` calls back to back on a
device-resident train set, reshuffled from the seed every epoch.

Set-up builds one train state (model, AdamW, step count) from the seeded
weights, drives it through its first `checked_steps` steps on the
window's own feed, reads what the check needs from them, warms up, and
hands the same state to the window. The window runs steps until
`seconds` have passed and ends with a synchronise; its rate is every
image of every step over the whole window.

The check (`perfbench/reference/train.py` in float32 with TF32 off, from
the same weights and rows) compares every checked micro-batch's loss (the
root mean square of their relative gaps), the first gradient as AdamW got
it (its first moment after one step, over 1 - b1) by the median leaf's
gap of norms, and each leaf's change over the checked steps, BatchNorm
statistics included, by the worst leaf's. PERF.md gives why the loss and
the gradient are not read by their worst step and leaf. Leaves whose reference gradient is under
a thousandth of the median leaf's (a conv bias before a train-mode
BatchNorm, whose gradient is nought but for rounding) are left out of the
gradient and the change: what they read is rounding alone.

Traffic keys: set_size, micro_batch, accum_steps, checked_steps,
warmup_steps, trace_steps.
"""
from __future__ import annotations

import gc
import math
import time
from typing import Dict, Optional

import numpy as np
import torch

from perfbench import harness
from perfbench.reference import ops as ref_ops
from perfbench.reference import train as ref_train
from perfbench.tracing import DeviceSlice, Reading, Spans, wrap_kernel_launches

FAULTS = ("unchanged", "half_batch")


def make_set(cfg: dict, traffic: dict, seed: int, device):
    """(images (N, S, S, 3) float32 in [0, 1], labels (N, S, S) int32) on
    the host, drawn on `device` from the seed."""
    n, s = traffic["set_size"], cfg["image_size"]
    g = harness.torch_generator(seed, harness.DATA, device)
    images = torch.rand((n, s, s, 3), generator=g, device=device)
    labels = torch.randint(0, cfg["num_classes"], (n, s, s), generator=g, device=device,
                           dtype=torch.int32)
    return images.cpu().numpy(), labels.cpu().numpy()


def epoch_orders(seed: int, n: int, batch: int):
    """Index matrices (steps, batch), one per epoch, from the seed."""
    rng = harness.np_rng(seed, harness.ORDER)
    steps = n // batch
    while True:
        yield rng.permutation(n)[:steps * batch].reshape(steps, batch)


def _leaves(model: torch.nn.Module, trained) -> Dict[str, torch.Tensor]:
    out = {n: p for n, p in model.named_parameters() if id(p) in trained}
    out.update({n: b for n, b in model.named_buffers() if n.endswith(("running_mean",
                                                                     "running_var"))})
    return out


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def loss_gaps(prog_losses, ref_losses) -> Dict[str, float]:
    """The micro-batch losses' relative gaps: their root mean square over
    every checked micro-batch, and the largest gap of a step's mean. A step
    that ran another number of micro-batches than the reference reads inf."""
    if [len(p) for p in prog_losses] != [len(r) for r in ref_losses]:
        return {"rms": math.inf, "step_mean": math.inf}
    gaps = [(a - b) / b for p, r in zip(prog_losses, ref_losses) for a, b in zip(p, r)]
    means = [abs(np.mean(p) - np.mean(r)) / abs(np.mean(r))
             for p, r in zip(prog_losses, ref_losses)]
    return {"rms": math.sqrt(float(np.mean(np.square(gaps)))), "step_mean": max(means)}


def compare(prog: dict, ref: dict, detail: Optional[dict] = None) -> Dict[str, float]:
    """The three numbers: the micro-batch losses, the first gradient by its
    median leaf, the change by its worst leaf; `detail` gets the readings
    of the step means and of the worst gradient leaf, and where they were."""
    loss = loss_gaps(prog["losses"], ref["losses"])
    grads = ref["grad"]
    med = float(np.median(list(grads.values())))
    moving = lambda k: k not in grads or grads[k] >= 1e-3 * med  # noqa: E731
    grad = harness.norm_gap(prog["grad"], grads, moving)
    change = harness.norm_gap(prog["change"], ref["change"], moving)
    med_gap = lambda p, r: float(np.median([abs(p[k] - r[k]) / max(r[k], 1e-30)  # noqa: E731
                                            for k in r if moving(k)]))
    if detail is not None:
        detail.update(loss_step_mean_rel=loss["step_mean"], grad1_worst_rel=grad[0],
                      grad_leaf=grad[1], change_leaf=change[1],
                      left_out=len([k for k in grads if not moving(k)]))
    return {"loss_rms_rel": loss["rms"], "grad1_median_rel": med_gap(prog["grad"], grads),
            "change_rel": change[0]}


def _train_step_of(fault: Optional[str]):
    from image_segmentation_tpu_torch.train.steps import train_step

    if fault is None:
        return train_step
    if fault == "unchanged":  # the loss is computed, the state is put back
        def step(state, loss_fn, x, y, accum_steps=1):
            keep = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
            loss = train_step(state, loss_fn, x, y, accum_steps=accum_steps)
            state.model.load_state_dict(keep)
            return loss
        return step
    if fault == "half_batch":  # the first half of the micro-batches, their mean
        def step(state, loss_fn, x, y, accum_steps=1):
            half = y.shape[0] // 2
            return train_step(state, loss_fn, x[:half], y[:half],
                              accum_steps=max(1, accum_steps // 2))
        return step
    raise ValueError(f"unknown fault {fault!r}; known: {FAULTS}")


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        fault: Optional[str] = None, window: bool = True) -> harness.Outcome:
    from image_segmentation_tpu_torch.losses import DiceCELoss
    from image_segmentation_tpu_torch.train.loop import train_device_budget
    from image_segmentation_tpu_torch.train.state import (
        TrainState,
        freeze_,
        make_adamw,
        trainable_parameters,
    )
    from image_segmentation_tpu_torch.train.steps import ResidentTrainSet, resident_plan

    cfg, tr, builder = cell.cfg, cell.traffic, cell.builder
    device = torch.device(device)
    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    spans = Spans(trace)
    train_step = _train_step_of(fault)

    phases = {"start": time.perf_counter() - t_start}
    model = harness.build(builder, cfg, device, harness.make_weights(builder, cfg, seed, device),
                          "port")
    freeze_(model, builder.FROZEN)
    trained = trainable_parameters(model, builder.FROZEN)
    opt, sched = make_adamw(trained, learning_rate=cfg["learning_rate"],
                            weight_decay=cfg["weight_decay"])
    state = TrainState(model, opt, sched)
    loss_fn = DiceCELoss(class_weights=tuple(cfg["class_weights"]),
                         smooth_dice=cfg["dice_smooth"])
    images, labels = make_set(cfg, tr, seed, device)
    plan = resident_plan(images.nbytes, train_device_budget(device))
    if plan == "stream":
        raise RuntimeError("the train set does not fit the device budget")
    phases["model"] = time.perf_counter() - t_start
    data = ResidentTrainSet(images, labels, device, quantize=plan == "uint8")
    phases["data"] = time.perf_counter() - t_start
    batch, accum = tr["micro_batch"] * tr["accum_steps"], tr["accum_steps"]
    orders = epoch_orders(seed, tr["set_size"], batch)

    def feed():
        for order in orders:
            idx = torch.from_numpy(order).to(device)
            for s in range(len(order)):
                with spans.span("gather"):
                    yield data.batch(idx[s])

    batches = feed()

    # the checked steps, through the window's own call and feed
    ids = {id(p) for p in trained}
    leaves = _leaves(model, ids)
    start = {k: v.detach().clone() for k, v in leaves.items()}
    losses, grad = [], None

    def recorded(*a):  # the same loss; its value kept for the check
        loss = loss_fn(*a)
        step_losses.append(loss.detach())
        return loss

    for s in range(tr["checked_steps"]):
        x, y = next(batches)
        step_losses = []
        train_step(state, recorded, x, y, accum_steps=accum)
        losses.append([float(v) for v in step_losses])
        if s == 0:
            grad = _norms({n: opt.state[p]["exp_avg"] / (1 - 0.9)
                           for n, p in model.named_parameters()
                           if id(p) in ids and p in opt.state})
    change = _norms({k: leaves[k].detach() - start[k] for k in leaves})
    del start
    prog = {"losses": losses, "grad": grad, "change": change}
    phases["checked_steps"] = time.perf_counter() - t_start

    outcome = harness.Outcome({}, 0, 0, [], 0)
    if window:
        for _ in range(tr["warmup_steps"]):
            train_step(state, loss_fn, *next(batches), accum_steps=accum)
        reading = _window(cell, state, loss_fn, batches, accum, batch, seconds, trace, spans,
                          device, sync, t_start, train_step, outcome)
        outcome.reading = reading
    if cuda:
        outcome.memory_peak_bytes = int(torch.cuda.max_memory_allocated(device))
    del state, model, opt, data, batches, leaves, trained
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = reference(cell, seed, device, images, labels, tr["checked_steps"])
    outcome.detail = dict(outcome.detail or {}, setup_phases_s=phases)
    outcome.checks = harness.checks_from(compare(prog, ref, outcome.detail),
                                         cfg["limits"].get("train", {}))
    return outcome


def _window(cell, state, loss_fn, batches, accum, batch, seconds, trace, spans, device, sync,
            t_start, train_step, outcome) -> Optional[Reading]:
    """The measured window, untraced in every run; with `trace`, then the
    traced slice: the instrumentation put in, `warmup_steps` steps, then
    `trace_steps` steps under the profiler. The rate and `train_mfu` come
    from the window alone, so the tracer's cost moves neither."""
    sync()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start
    steps, marks = 0, []
    t0 = time.perf_counter()
    while True:
        train_step(state, loss_fn, *next(batches), accum_steps=accum)
        steps += 1
        marks.append(time.perf_counter())
        if marks[-1] - t0 >= seconds:
            break
    sync()
    window_s = time.perf_counter() - t0
    outcome.e2e = {"train_images_per_s": steps * batch / window_s, "setup_s": setup_s}
    outcome.attempted = steps
    quarters = np.searchsorted(np.asarray(marks) - t0, np.linspace(0, window_s, 5)[1:4])
    outcome.detail = {"steps_by_quarter": np.diff(quarters, prepend=0, append=steps).tolist()}
    if not trace:
        return None
    restore = wrap_kernel_launches(spans)
    opt_step = state.optimizer.step

    def step_with_span(*a, **k):
        with spans.span("optimizer"):
            return opt_step(*a, **k)

    state.optimizer.step = step_with_span
    fwd = {}
    hooks = [state.model.register_forward_pre_hook(
                 lambda m, a: fwd.__setitem__("t", time.perf_counter())),
             state.model.register_forward_hook(lambda m, a, o: spans.items.append(
                 ("forward", 0, fwd["t"], time.perf_counter())))]

    def traced_loss(*a):
        with spans.span("loss"):
            return loss_fn(*a)

    def traced_step():
        x, y = next(batches)
        with spans.span("train_step"):
            train_step(state, traced_loss, x, y, accum_steps=accum)

    dslice = DeviceSlice(device)
    dslice.prime()
    for _ in range(cell.traffic["warmup_steps"]):
        traced_step()
    dslice.start()
    for _ in range(cell.traffic["trace_steps"]):
        traced_step()
    dslice.stop()
    for h in hooks:
        h.remove()
    del state.optimizer.step
    restore()
    dslice.finish()
    facts = {"steps": steps, "window_s": window_s, "images_per_step": batch,
             "traced_steps": cell.traffic["trace_steps"],
             "train_flops_per_image": cell.builder.train_flops(cell.cfg)}
    outcome.detail.update(step_ms=1e3 * window_s / steps,
                          traced_step_ms=1e3 * dslice.window_s / cell.traffic["trace_steps"],
                          aligned_by_marker=dslice.aligned_by_marker)
    return Reading(spans, dslice, facts)


def reference(cell, seed: int, device, images: np.ndarray, labels: np.ndarray, steps: int,
              ops=None) -> dict:
    """The plain reference's checked steps on the same weights and rows:
    {"losses", "grad": first-gradient norms, "change": change norms}."""
    cfg, tr, builder = cell.cfg, cell.traffic, cell.builder
    batch = tr["micro_batch"] * tr["accum_steps"]
    with ref_ops.fp32_context():
        weights = harness.make_weights(builder, cfg, seed, device)
        model = harness.build(builder, cfg, device, weights, "reference", ops)
        del weights
        params = ref_train.trainable(model, builder.FROZEN)
        leaves = dict(params)
        leaves.update({n: b for n, b in model.named_buffers()
                       if n.endswith(("running_mean", "running_var"))})
        start = {k: v.detach().clone() for k, v in leaves.items()}
        opt = ref_train.AdamW(list(params.values()), cfg["learning_rate"], cfg["weight_decay"])
        order = next(epoch_orders(seed, tr["set_size"], batch))
        losses, grad = [], None
        for s in range(steps):
            idx = order[s]
            x = torch.from_numpy(images[idx]).to(device)
            y = torch.from_numpy(labels[idx]).to(device)
            loss, grads = ref_train.train_step(model, opt, x, y, tr["accum_steps"],
                                               cfg["class_weights"], cfg["dice_smooth"])
            losses.append(loss)
            if s == 0:
                grad = _norms(grads)
        change = _norms({k: leaves[k].detach() - start[k] for k in leaves})
    return {"losses": losses, "grad": grad, "change": change}


def control(cell, seed: int, device) -> Dict[str, float]:
    """The check's numbers with the reference in float8 in the program's place."""
    tr = cell.traffic
    images, labels = make_set(cell.cfg, tr, seed, device)
    ref = reference(cell, seed, device, images, labels, tr["checked_steps"])
    low = reference(cell, seed, device, images, labels, tr["checked_steps"],
                    ops=ref_ops.control_ops())
    detail = {}
    values = compare(low, ref, detail)
    return dict(values, detail=detail)

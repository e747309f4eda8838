"""A closed loop of optimizer steps of a click-prompted model (Segment
Anything, `configs/sam_vitb.py`): `train_step` calls back to back on a
device-resident set of images, label maps and one click an image,
reshuffled from the seed every epoch.

The set is Pet-like and made on the card in uint8, chunk by chunk, never
whole in float32 (11.6 GB of 1024 px images and 3.9 GB of labels at
3,680 images, where float32 images alone would be 46 GB): uniform random
pixels; a label map with one pet, an ellipse of cat or dog (ids 1 or 2,
centre within the middle 60% of the side, semi-axes 10 to 35% of it)
inside a boundary ring (id 3) on background (0); and one positive click,
drawn uniformly among the pet's pixels. `ResidentTrainSet` holds the
uint8 arrays and the float32 clicks, which it gathers with the same
indices and never quantises; a step batch is ((images, clicks), labels).

Set-up, the checked steps, the window, the traced slice and its wrapper
spans are `train_closed`'s (its `_window`); the facts `train_mfu`,
`step_device_ms.train` and `device_idle_pct.train` read come from there
under the same names. Under `--trace 1` the kind adds what the K5
readers read, K5's bound per forward at the cell's shapes
(`k5_bound_s_per_forward`, `configs/<builder>.py` `k5_bound_s`) and its
calls per forward, and, for the record (the run's `detail`), the
program's `sam.*` counts of one eager forward times the accumulation,
K5's `LAUNCHES` per step over the window and the slice, and the replayed
and eager micro-batches of one step under the program's spans.

The check is `train_closed`'s three numbers (`compare`) against
`perfbench/reference/sam.py` in float32 with TF32 off, on the same
weights and gathered rows: the checked micro-batches' losses, the first
gradient by its median leaf, each leaf's change. An image's lowest-loss
mask is a discontinuous choice: where its two lowest masks' losses lie
within `TIE` of each other, bf16 rounding orders them either way, and
three images of 64 trained on another mask moved the median leaf's gradient
by 4% on one seed. So the reference backpropagates the program's mask where
that mask's float32 loss is within `TIE` of the lowest, and its own
elsewhere (`tie_choice`); the loss it reports is always its lowest
mask's. `detail` gives how many images the two sides chose a different
mask for (`choice_differs`, of `choice_images`) and how many of those
the reference followed (`choice_followed`). Leaves whose reference
gradient is under a thousandth of the median leaf's (the two box-corner
point embeddings, which one click never reaches) are left out.

Traffic keys: set_size, micro_batch, accum_steps, clicks_per_image (1),
checked_steps, warmup_steps, trace_steps.
"""
from __future__ import annotations

import gc
import time
from typing import Dict, Optional

import numpy as np
import torch

from perfbench import harness
from perfbench.kinds import train_closed
from perfbench.kinds.train_closed import _leaves, _norms, _window, compare, epoch_orders
from perfbench.reference import ops as ref_ops
from perfbench.reference import sam as ref_sam
from perfbench.reference import train as ref_train
from perfbench.tracing import Spans

FAULTS = train_closed.FAULTS
CHUNK = 64  # images made at a time
# An image's masks whose float32 losses lie within this share of its
# lowest are a tie for the check: each mask's bf16 loss lies within 1.6%
# of its float32 one on the card, so rounding can swap two masks up to
# about 3% apart, while a mask other than the lowest lies a median 19% or
# more above it (PERF.md, the SAM check's limits).
TIE = 0.05


def make_set(cfg: dict, traffic: dict, seed: int, device):
    """(images (N, S, S, 3) uint8, labels (N, S, S) uint8, clicks (N, 1, 3)
    float32 (x, y, 1) in pixels), on `device`, drawn there from the seed
    chunk by chunk (module docstring)."""
    if traffic["clicks_per_image"] != 1:
        raise ValueError("one click an image is built")
    n, s = traffic["set_size"], cfg["image_size"]
    g = harness.torch_generator(seed, harness.DATA, device)
    images = torch.empty((n, s, s, 3), dtype=torch.uint8, device=device)
    labels = torch.empty((n, s, s), dtype=torch.uint8, device=device)
    clicks = torch.ones((n, 1, 3), dtype=torch.float32, device=device)
    axis = torch.arange(s, device=device, dtype=torch.float32)
    for i in range(0, n, CHUNK):
        m = min(CHUNK, n - i)
        images[i:i + m] = torch.randint(0, 256, (m, s, s, 3), generator=g, device=device,
                                        dtype=torch.uint8)
        p = torch.rand((m, 5), generator=g, device=device)
        cy, cx = s * (0.2 + 0.6 * p[:, 0]), s * (0.2 + 0.6 * p[:, 1])
        ry, rx = s * (0.1 + 0.25 * p[:, 2]), s * (0.1 + 0.25 * p[:, 3])
        pet = 1 + (p[:, 4] < 0.5).to(torch.uint8)
        r = (((axis[None, :, None] - cy[:, None, None]) / ry[:, None, None]) ** 2
             + ((axis[None, None, :] - cx[:, None, None]) / rx[:, None, None]) ** 2)
        lab = torch.where(r <= 1.0, pet[:, None, None], torch.zeros_like(pet)[:, None, None])
        lab = torch.where((r > 1.0) & (r <= 1.3), torch.full_like(lab, 3), lab)
        labels[i:i + m] = lab
        inside = (r <= 1.0).reshape(m, -1)
        cum = inside.cumsum(1)
        total = cum[:, -1:]
        want = (torch.rand((m, 1), generator=g, device=device) * total).floor().long() + 1
        idx = torch.searchsorted(cum, torch.minimum(want, total))[:, 0]
        clicks[i:i + m, 0, 0] = (idx % s).float()
        clicks[i:i + m, 0, 1] = (idx // s).float()
        del r, lab, inside, cum
    return images, labels, clicks


def _train_step_of(fault: Optional[str]):
    """`train_closed`'s steps and faults, `half_batch` cutting each of the
    step's inputs (the images and the clicks)."""
    if fault != "half_batch":
        return train_closed._train_step_of(fault)
    from image_segmentation_tpu_torch.train.steps import train_step

    def step(state, loss_fn, x, y, accum_steps=1):
        half = y.shape[0] // 2
        return train_step(state, loss_fn, tuple(t[:half] for t in x), y[:half],
                          accum_steps=max(1, accum_steps // 2))
    return step


def _loss_args(cfg: dict) -> tuple:
    return cfg["focal_weight"], cfg["focal_alpha"], cfg["focal_gamma"]


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        fault: Optional[str] = None, window: bool = True) -> harness.Outcome:
    from image_segmentation_tpu_torch.losses import SamLoss
    from image_segmentation_tpu_torch.ops.kernels import relpos_attention
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
    loss_fn = SamLoss(*_loss_args(cfg))
    phases["model"] = time.perf_counter() - t_start
    images, labels, clicks = make_set(cfg, tr, seed, device)
    if resident_plan(4 * images.numel(), train_device_budget(device)) == "stream":
        raise RuntimeError("the train set does not fit the device budget as uint8")
    data = ResidentTrainSet(images, labels, device, quantize=True, prompts=clicks)
    del images, labels, clicks
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
    losses, grad, choices = [], None, []

    def recorded(*a):  # the same loss; its value and choice kept for the check
        loss = loss_fn(*a)
        step_losses.append(loss.detach())
        choices.append(loss_fn.choice)
        return loss

    for s in range(tr["checked_steps"]):
        x, y = next(batches)
        step_losses = []
        train_step(state, recorded, x, y, accum_steps=accum)
        losses.append([float(v) for v in step_losses])
        if s == 0:
            grad = {n: opt.state[p]["exp_avg"] / (1 - 0.9)
                    for n, p in model.named_parameters() if id(p) in ids and p in opt.state}
    change = _norms({k: leaves[k].detach() - start[k] for k in leaves})
    del start
    prog = {"losses": losses, "grad": _norms(grad), "grad_t": grad, "change": change,
            "choices": torch.cat(choices).cpu() if choices else None}
    phases["checked_steps"] = time.perf_counter() - t_start

    outcome = harness.Outcome({}, 0, 0, [], 0)
    if window:
        for _ in range(tr["warmup_steps"]):
            train_step(state, loss_fn, *next(batches), accum_steps=accum)
        launches = relpos_attention.LAUNCHES
        reading = _window(cell, state, loss_fn, batches, accum, batch, seconds, trace, spans,
                          device, sync, t_start, train_step, outcome)
        if reading is not None:
            steps = reading.facts["steps"] + tr["warmup_steps"] + tr["trace_steps"]
            k5_per_step = (relpos_attention.LAUNCHES - launches) / steps
            reading.facts.update(_facts(cell, state, loss_fn, batches, accum, train_step))
            reading.facts["k5_launches_per_step"] = k5_per_step
            outcome.detail.update({k: v for k, v in reading.facts.items()
                                   if k.startswith(("k5_", "sam.", "train."))})
        outcome.reading = reading
    if cuda:
        outcome.memory_peak_bytes = int(torch.cuda.max_memory_allocated(device))
    del state, model, opt, batches, leaves, trained
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = reference(cell, seed, device, data, tr["checked_steps"], follow=prog["choices"])
    del data
    outcome.detail = dict(outcome.detail or {}, setup_phases_s=phases)
    outcome.checks = harness.checks_from(check(prog, ref, outcome.detail),
                                         cfg["limits"].get("train", {}))
    _count_choices(prog, ref, outcome.detail)
    return outcome


def _facts(cell, state, loss_fn, batches, accum, train_step) -> Dict[str, float]:
    """What the K5 readers read, and the program's counts (module docstring)."""
    from image_segmentation_tpu_torch.utils import profiling

    cfg, micro = cell.cfg, cell.traffic["micro_batch"]
    facts = {"k5_bound_s_per_forward": cell.builder.k5_bound_s(cfg, micro),
             "k5_calls_per_forward": len(cell.builder.k5_calls(cfg, micro))}
    (x, c), y = next(batches)
    with profiling.record_spans() as log, torch.no_grad():
        state.model(x[:micro], c[:micro])
    facts.update({k: v * accum for k, v in log.counts.items() if k.startswith("sam.")})
    with profiling.record_spans() as log:
        train_step(state, loss_fn, (x, c), y, accum_steps=accum)
    facts.update({k: log.counts.get(k, 0) for k in ("train.replays",
                                                    "train.eager_micro_batches")})
    return facts


def check(prog: dict, ref: dict, detail: Optional[dict] = None) -> Dict[str, float]:
    """`compare`'s three numbers and `grad1_diff_rel`: over the leaves that
    `compare` reads, the median of the distance between the two first
    gradients over the reference's norm. `grad1_median_rel` compares the
    norms alone, which rounding noise moves only to second order."""
    values = compare(prog, ref, detail)
    norms = ref["grad"]
    med = float(np.median(list(norms.values())))
    values["grad1_diff_rel"] = float(np.median([
        float(torch.linalg.vector_norm((prog["grad_t"].get(k, torch.zeros_like(g)) - g).double()))
        / norms[k] for k, g in ref["grad_t"].items() if norms[k] >= 1e-3 * med]))
    return values


def _count_choices(prog: dict, ref: dict, detail: dict) -> None:
    a, b = prog.get("choices"), ref.get("choices")
    if a is not None and b is not None and a.shape == b.shape:
        detail.update(choice_differs=int((a != b).sum()), choice_images=int(a.numel()),
                      choice_followed=ref["followed"])


def tie_choice(per_mask: torch.Tensor, follow: Optional[torch.Tensor]) -> torch.Tensor:
    """The mask each image backpropagates: its lowest-loss one, or the one
    `follow` names where that mask's loss is within `TIE` of the lowest."""
    own = per_mask.argmin(dim=1)
    if follow is None:
        return own
    near = per_mask.gather(1, follow[:, None])[:, 0] <= per_mask.min(dim=1).values * (1 + TIE)
    return torch.where(near, follow, own)


def reference(cell, seed: int, device, data, steps: int, ops=None,
              follow: Optional[torch.Tensor] = None) -> dict:
    """The plain reference's checked steps on the same weights and gathered
    rows: {"losses", "grad": first-gradient norms, "grad_t": the first
    gradient, "change": change norms, "choices": each image's lowest-loss
    mask, "followed": the images that backpropagated `follow`'s mask in
    place of that one}. `follow` is the
    other side's choices, image by image in the same order (`tie_choice`;
    ignored unless it covers every image); each loss is the lowest
    mask's, whatever was followed."""
    cfg, tr, builder = cell.cfg, cell.traffic, cell.builder
    batch, accum = tr["micro_batch"] * tr["accum_steps"], tr["accum_steps"]
    if follow is not None and follow.numel() != steps * batch:
        follow = None
    picks = iter(follow.split(tr["micro_batch"])) if follow is not None else None
    followed = 0
    with ref_ops.fp32_context():
        weights = harness.make_weights(builder, cfg, seed, device)
        model = harness.build(builder, cfg, device, weights, "reference", ops)
        del weights
        params = ref_train.trainable(model, builder.FROZEN)
        leaves = dict(params)
        start = {k: v.detach().clone() for k, v in leaves.items()}
        opt = ref_train.AdamW(list(params.values()), cfg["learning_rate"], cfg["weight_decay"])
        order = next(epoch_orders(seed, tr["set_size"], batch))
        losses, grad, choices = [], None, []
        names = list(params)
        for s in range(steps):
            (x, c), y = data.batch(torch.from_numpy(order[s]).to(device))
            for p in params.values():
                p.grad = None
            micro = y.shape[0] // accum
            step_losses = []
            for i in range(accum):
                rows = slice(i * micro, (i + 1) * micro)
                per_mask, iou_term = ref_sam.mask_losses(*model(x[rows], c[rows]), y[rows],
                                                         *_loss_args(cfg))
                values = per_mask.detach()
                own = values.argmin(dim=1)
                pick = tie_choice(values, next(picks).to(device) if picks is not None else None)
                (per_mask.gather(1, pick[:, None]).mean() + iou_term).backward()
                step_losses.append((values.gather(1, own[:, None]).mean() + iou_term).item())
                choices.append(own)
                followed += int((pick != own).sum())
            grads = [p.grad / accum if p.grad is not None else torch.zeros_like(p)
                     for p in params.values()]
            opt.step(grads)
            losses.append(step_losses)
            if s == 0:
                grad = dict(zip(names, grads))
            del x, c, y
        change = _norms({k: leaves[k].detach() - start[k] for k in leaves})
    return {"losses": losses, "grad": _norms(grad), "grad_t": grad, "change": change,
            "choices": torch.cat(choices).cpu(), "followed": followed}


def control(cell, seed: int, device, seconds: Optional[float] = None) -> Dict[str, float]:
    """The check's numbers with the reference in float8 in the program's
    place (`seconds`, which a serve kind's control takes, is not used)."""
    from image_segmentation_tpu_torch.train.steps import ResidentTrainSet

    tr = cell.traffic
    images, labels, clicks = make_set(cell.cfg, tr, seed, device)
    data = ResidentTrainSet(images, labels, device, quantize=True, prompts=clicks)
    del images, labels, clicks
    low = reference(cell, seed, device, data, tr["checked_steps"], ops=ref_ops.control_ops())
    ref = reference(cell, seed, device, data, tr["checked_steps"], follow=low["choices"])
    detail = {}
    values = check(low, ref, detail)
    _count_choices(low, ref, detail)
    return dict(values, detail=detail)

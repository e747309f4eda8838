"""Training orchestration: `fit` and the original-resolution `evaluate`.

Counterpart of image_segmentation_tpu/train/loop.py (fit :650-1009,
evaluate :328-444, _evaluate_device :82-178), as the reference engine
(utils/training.py) runs it:
  * a train epoch is the shuffled step batches of a device-resident (or
    streamed) train set through `train_step` (accumulation inside,
    train/steps.py);
  * an eval epoch is the original-resolution protocol, on the device
    (train/fast_eval.py, canvas-size buckets) or on the host in float64;
  * a per-epoch metrics file, the best-val-mIoU checkpoint with its
    weights-only copy, a `_last` copy every `checkpoint_every` epochs,
    and resume (utils/training.py:453-618).

Where the port departs from the JAX loop, it does what that loop meant:
  * resume replays the shuffle generator (seeded as loop.py:853) to its
    epoch, so a resumed run trains on the batches the uninterrupted run
    would have (JAX reseeds with seed + start_epoch);
  * `history["stopped_early"]` is written before the history is saved
    (JAX sets it after the save, loop.py:961, so it never reached the
    file);
  * the checkpoints hold the state `eval_state_fn` gives, the one that
    was validated (JAX saves the trained `state`, loop.py:972-990, which
    in a cached-feature ClipUNet run is the decoder alone).

`fit(augment_fn=...)` augments each step batch on the device with draws
from a CPU generator seeded `seed * 100003 + epoch` per epoch (JAX seeds its
`aug_key` so, loop.py:861): a resumed run draws what the uninterrupted
run would have. `fit_reconstruction` and `evaluate_reconstruction` are
the autoencoder's stage 1 (loop.py:1012-1158): MSE against the input,
the original-size reconstruction MSE, a best-val-loss checkpoint.

The train set's device budget is `ISTPU_TRAIN_DEVICE_CACHE_MB`, read at
call time as JAX reads it (loop.py:801,1080); unset, it follows the
device (`train_device_budget`). Inside the budget the set is uploaded
once (float32, or uint8 past it: `resident_plan`, JAX
`_resident_plan('auto', ...)`, the only policy a JAX caller takes); past
it in every allowed dtype, each step batch is
gathered on the host under the same shuffle and streamed to the device
(`train.steps.StreamedTrainSet`, JAX `_stream_batches`). The val set's
budget is `ISTPU_EVAL_DEVICE_CACHE_MB` (`eval_device_budget`, the same
default rule; JAX loop.py:222-240): past it the device eval streams each
batch's inputs, metas and label canvases from the host, and the
confusion still accumulates on the device.

Across processes, `fit(axis=...)` (given by
train/multihost_loop.py's `fit_multihost`) steps each process on its
rows of each step batch, and the device eval (`evaluate(axis=...)`) has
each process evaluate its columns of every eval batch.

Not ported: the TPU dispatch chunking (`_dispatch_epoch_chunked`).
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import signal
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from image_segmentation_tpu_torch.data.loader import (
    MaterializedDataset,
    epoch_order,
    eval_batches,
)
from image_segmentation_tpu_torch.losses import DiceCELoss, DiceNLLLoss
from image_segmentation_tpu_torch.metrics import MetricsHistory
from image_segmentation_tpu_torch.ops import geometry as G
from image_segmentation_tpu_torch.parallel.mesh import DataAxis, any_process
from image_segmentation_tpu_torch.parallel.multihost import (
    process_local_batch_columns,
    replicate_for_processes,
    replicate_result,
)
from image_segmentation_tpu_torch.train import checkpoint as ckpt
from image_segmentation_tpu_torch.train import fast_eval
from image_segmentation_tpu_torch.train.state import TrainState
from image_segmentation_tpu_torch.train.steps import (
    ResidentTrainSet,
    StreamedTrainSet,
    eval_forward,
    local_step_rows,
    resident_plan,
    stream_rows,
    train_step,
)

# The variables that set the train and val sets' device budgets, in MB,
# and their default on a device that is not a CUDA card (JAX's default,
# loop.py:222,801, sized for a TPU's HBM).
BUDGET_ENV = "ISTPU_TRAIN_DEVICE_CACHE_MB"
EVAL_BUDGET_ENV = "ISTPU_EVAL_DEVICE_CACHE_MB"
CPU_DEVICE_BUDGET_MB = 4096
# The eval protocol's (B, Hc, Wc, C + 1) f32 canvases per batch stay under
# this (JAX loop.py:209-214); the batch halves until they do.
EVAL_BATCH_BYTES = 2**31


@dataclasses.dataclass
class FitResult:
    state: TrainState
    history: Dict[str, list]
    best: Dict[str, float]


def _history_new() -> Dict[str, list]:
    return {"train_loss": [], "val_loss": [], "val_dice": [], "val_iou": [],
            "val_acc": [], "val_per_class_iou": [], "epoch_time_s": []}


def _save_history(save_dir: str, name: str, history: Dict[str, list]) -> None:
    """The per-epoch metrics file (reference utils/training.py:557-562)."""
    os.makedirs(os.path.join(save_dir, "metrics"), exist_ok=True)
    with open(os.path.join(save_dir, "metrics", name + ".json"), "w") as f:
        json.dump(ckpt._jsonable(history), f)


def _device_of(state: TrainState) -> torch.device:
    return next(state.model.parameters()).device


def _device_budget(env: str, device) -> int:
    mb = os.environ.get(env, "")
    if mb:
        return int(float(mb) * 2**20)
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory // 4
    return CPU_DEVICE_BUDGET_MB << 20


def train_device_budget(device) -> int:
    """Bytes of `device` memory the resident train set may take: the
    `ISTPU_TRAIN_DEVICE_CACHE_MB` variable when it is set, read at each
    call as JAX's fit reads it; else, on a CUDA card, a quarter of its
    memory (`total_memory` // 4: 20 GB of an 80 GB H100), and elsewhere
    4096 MB, as in JAX. Past the budget the set is held as uint8, and past
    four times it the set streams from the host (`resident_plan`)."""
    return _device_budget(BUDGET_ENV, device)


def eval_device_budget(device) -> int:
    """Bytes of `device` memory the device eval may hold a val set (or one
    canvas bucket of it) in: inputs and label canvases. The
    `ISTPU_EVAL_DEVICE_CACHE_MB` variable when it is set, read at each
    call; else the rule of `train_device_budget`. Past it the eval
    streams each batch from the host."""
    return _device_budget(EVAL_BUDGET_ENV, device)


def _train_set(train_data: MaterializedDataset, device, *, reconstruction: bool,
               verbose: bool):
    """The train set on the device as `resident_plan` says: float32, or
    uint8 (images and heatmaps in [0, 1], labels), kept on the dataset
    object for later fits on the same device; or left in host memory and
    streamed per step batch (`StreamedTrainSet`). A reconstruction set
    holds its images only. A set of packed ViT features is float32 or
    streamed: uint8 in [0, 1] would destroy them (train/feature_cache.py)."""
    has_heat = train_data.has_heatmaps and not reconstruction
    labels = None if reconstruction else train_data.labels
    heatmaps = train_data.heatmaps if has_heat else None
    f32_bytes = (train_data.images.nbytes + (0 if labels is None else labels.nbytes)
                 + (0 if heatmaps is None else heatmaps.nbytes))
    budget = train_device_budget(device)
    plan = resident_plan(f32_bytes, budget, quantizable=not train_data.packed_features)
    if plan == "stream":
        train_data.device_train_cache = None
        if verbose:
            print(f"[fit] streaming the train set per batch from host memory "
                  f"({f32_bytes / 2**20:.0f} MB float32, past the {budget / 2**20:.0f} MB device budget; {BUDGET_ENV} sets it)")
        return StreamedTrainSet(train_data.images, labels, device, heatmaps=heatmaps)
    quantize = plan == "uint8"
    key = (device, quantize, reconstruction)
    cached = train_data.device_train_cache
    if cached is None or cached[0] != key:
        if quantize and verbose:
            print(f"[fit] uint8 device residency ({f32_bytes / 2**20:.0f} MB float32, "
                  f"{budget / 2**20:.0f} MB budget)")
        train_data.device_train_cache = (key, ResidentTrainSet(
            train_data.images, labels, device, quantize, heatmaps=heatmaps))
    return train_data.device_train_cache[1]


def _metas_on(metas: G.ResizeMeta, device) -> dict:
    return {f: torch.from_numpy(np.asarray(v).astype(np.int64)).to(device)
            for f, v in metas._asdict().items() if f != "scale"}


def _bucket_views(val_data: MaterializedDataset):
    """The canvas-size buckets of a val set of 16 or more images, built
    once ([] when one canvas is best)."""
    if val_data.bucket_views is None:
        plan = fast_eval.plan_size_buckets(val_data.orig_labels)
        val_data.bucket_views = [] if len(plan) == 1 else [
            MaterializedDataset(
                images=val_data.images[idx], labels=val_data.labels[idx],
                metas=G.ResizeMeta(*(np.asarray(f)[idx] for f in val_data.metas)),
                heatmaps=val_data.heatmaps[idx] if val_data.has_heatmaps else None,
                orig_labels=[val_data.orig_labels[i] for i in idx])
            for idx in plan]
    return val_data.bucket_views


def _eval_one_canvas(model, val_data: MaterializedDataset, *, loss_fn, num_classes: int,
                     batch_size: int, verbose: bool, axis: Optional[DataAxis] = None):
    """The device protocol over one packed canvas (the whole set or one
    bucket). Within `eval_device_budget` the set goes to the device once
    and each batch is gathered there; past it each batch's inputs, metas
    and label canvases stream from the host (`stream_rows`). Returns
    (confusion (C, C) int64 tensor, losses (n,) tensor), on the device.

    Over a data `axis` of W processes (JAX multihost_loop.py
    `_evaluate_multihost` :64-160) the eval batch is a multiple of W, each
    process evaluates its block of columns of every batch, and the
    per-image losses are gathered back into the set's order; the
    confusion returned is this process's part."""
    device = next(model.parameters()).device
    if val_data.label_canvases is None:
        val_data.label_canvases = fast_eval.pack_label_canvases(val_data.orig_labels)
    canvases = val_data.label_canvases
    inputs = (val_data.images,) + ((val_data.heatmaps,) if val_data.has_heatmaps else ())
    n = len(val_data)
    hc, wc = canvases.shape[1:]
    world = 1 if axis is None else axis.size
    # each process's columns of a batch stay under the buffer limit, and the
    # batch stays a multiple of the processes (JAX multihost_loop.py:86-92)
    k = max(1, batch_size // world)
    while k > 1 and k * hc * wc * (num_classes + 1) * 4 > EVAL_BATCH_BYTES:
        k //= 2
    batch_size = k * world
    cols = np.arange(k) if axis is None else process_local_batch_columns(batch_size, axis)
    starts = range(0, n, batch_size)
    nbytes = sum(x.nbytes for x in inputs) + canvases.nbytes
    budget = eval_device_budget(device)
    if nbytes <= budget:
        if val_data.device_eval_cache is None or val_data.device_eval_cache[0] != device:
            val_data.device_eval_cache = (device, (
                tuple(torch.from_numpy(x).to(device) for x in inputs),
                _metas_on(val_data.metas, device),
                torch.from_numpy(canvases).to(device)))
        dev_inputs, dev_metas, dev_canvases = val_data.device_eval_cache[1]

        dev_cols = torch.from_numpy(cols).to(device)

        def batches():
            for start in starts:
                # the tail batch repeats its last index
                ii = (dev_cols + start).clamp(max=n - 1)
                yield (tuple(x.index_select(0, ii) for x in dev_inputs),
                       {k: v.index_select(0, ii) for k, v in dev_metas.items()},
                       dev_canvases.index_select(0, ii))
    else:
        val_data.device_eval_cache = None
        if verbose:
            print(f"  val: streaming {n} images per batch ({nbytes / 2**20:.0f} MB past the "
                  f"{budget / 2**20:.0f} MB device budget; {EVAL_BUDGET_ENV} sets it)")
        fields = [f for f in G.ResizeMeta._fields if f != "scale"]
        arrays = (*inputs, canvases, *(np.asarray(getattr(val_data.metas, f)) for f in fields))
        rows = (np.minimum(cols + start, n - 1) for start in starts)

        def batches():
            k = len(inputs)
            for b in stream_rows(arrays, rows, device):
                yield b[:k], {f: v.long() for f, v in zip(fields, b[k + 1:])}, b[k]

    conf = torch.zeros((num_classes, num_classes), dtype=torch.int64, device=device)
    losses = []
    real_cols = torch.from_numpy(cols).to(device)
    for start, (x, metas, canv) in zip(starts, batches()):
        # `real` masks the tail batch's repeats
        real = real_cols + start < n
        scores = eval_forward(model, *x)
        with torch.no_grad():
            bconf, blosses = fast_eval.eval_batch(scores, metas, canv, real, num_classes,
                                                  loss_fn)
        conf += bconf
        losses.append(blosses)
    losses = torch.stack(losses)[None]
    if axis is not None:
        losses = replicate_result(losses)
    # (batches, W, k) is the set's order; the tail's repeats are cut
    return conf, losses.transpose(0, 1).reshape(-1)[:n]


def _evaluate_device(state: TrainState, val_data: MaterializedDataset, *, loss_cfg,
                     num_classes: int, agg: MetricsHistory, batch_size: int = 8,
                     verbose: bool = True, axis: Optional[DataAxis] = None):
    """The device protocol (train/fast_eval.py) over canvas-size buckets
    when the set has 16 or more images, else one canvas; over a data
    `axis`, the processes' confusions summed (integer counts, so the
    buckets and the split change nothing)."""
    agg.reset()
    loss_fn = fast_eval.make_masked_loss(loss_cfg) if loss_cfg is not None else None
    views = _bucket_views(val_data) if len(val_data) >= 16 else []
    if views and verbose:
        print(f"  val: {len(views)} canvas buckets {[len(v) for v in views]}")
    parts = [_eval_one_canvas(state.model, v, loss_fn=loss_fn, num_classes=num_classes,
                              batch_size=batch_size, verbose=verbose, axis=axis)
             for v in (views or [val_data])]
    conf = sum(c for c, _ in parts)
    if axis is not None and axis.size > 1:
        dist.all_reduce(conf)
    agg.accumulate_confusion(conf)  # the one host fetch
    losses = torch.cat([l for _, l in parts]).cpu().numpy()
    return _finish(agg, float(losses.mean()) if loss_fn is not None else float("nan"),
                   verbose)


def _finish(agg: MetricsHistory, val_loss: float, verbose: bool) -> dict:
    dice, iou, acc = agg.compute_epoch_metrics()
    per_iou = np.asarray(agg.get_last_per_class_iou())
    if verbose:
        print(f"  val: loss={val_loss:.4f} acc={acc:.4f} dice={dice:.4f} "
              f"miou={iou:.4f} per-class IoU={np.round(per_iou, 4).tolist()}")
    return {"loss": val_loss, "dice": dice, "iou": iou, "acc": acc, "per_class_iou": per_iou}


def evaluate(state: TrainState, val_data: MaterializedDataset, *,
             host_loss_fn: Optional[Callable] = None, num_classes: int = 4,
             eval_ignore_index: Optional[int] = 3, batch_size: int = 8,
             agg: Optional[MetricsHistory] = None, verbose: bool = True,
             protocol: str = "auto", loss_cfg=None, axis: Optional[DataAxis] = None):
    """Original-resolution evaluation (reference utils/training.py:67-121),
    by one of two implementations of the same protocol:
      * 'device': inverse geometry, argmax, masked loss and confusion on
        the device on static canvases (train/fast_eval.py); the val loss
        comes from `loss_cfg`, a loss dataclass;
      * 'host': the device forward, then per image the float32 host
        inverse and the float64 loss (`host_loss_fn(scores, label)`) and
        confusion; the exactness reference.
    'auto' is 'device' when a `loss_cfg` is given or no loss is wanted,
    else 'host'. The model runs in eval mode without autograd, so a UNet
    built with kernels runs K1 on CUDA. Over a data `axis` of processes
    (the device protocol only) each process evaluates its columns of each
    batch and every process returns the same metrics."""
    if val_data.orig_labels is None:
        raise ValueError("materialize the val data with keep_orig_labels=True")
    if protocol == "auto":
        protocol = "device" if (loss_cfg is not None or host_loss_fn is None) else "host"
    if agg is None:
        agg = MetricsHistory(num_classes, ignore_index=eval_ignore_index)
    if protocol == "device":
        if loss_cfg is None and host_loss_fn is not None:
            raise ValueError(
                "protocol='device' computes the val loss from `loss_cfg` (a loss "
                "dataclass, e.g. DiceCELoss(...)); host_loss_fn is only usable by "
                "protocol='host'. Pass loss_cfg=, or protocol='host'.")
        return _evaluate_device(state, val_data, loss_cfg=loss_cfg, num_classes=num_classes,
                                agg=agg, batch_size=batch_size, verbose=verbose, axis=axis)
    if protocol != "host":
        raise ValueError(f"protocol {protocol!r} not in ('auto', 'device', 'host')")
    if axis is not None and axis.size > 1:
        raise ValueError("the host protocol runs in one process; across processes use "
                         "protocol='device'")
    agg.reset()
    device = _device_of(state)
    losses = []

    def one_image(scores, meta, label):
        inv = G.invert_resize_padding_np(scores, meta, method="linear")
        loss = host_loss_fn(inv, label) if host_loss_fn is not None else None
        idx = label.astype(np.int64) * num_classes + inv.argmax(axis=-1)
        return loss, np.bincount(idx.reshape(-1), minlength=num_classes ** 2
                                 ).reshape(num_classes, num_classes)

    # per-image host work in a small pool (numpy releases the GIL); the
    # float64 accumulation stays in this thread
    with ThreadPoolExecutor(max_workers=4) as pool:
        for inputs, _, metas, origs, count in eval_batches(val_data, batch_size):
            out = eval_forward(state.model, *(torch.from_numpy(x).to(device) for x in inputs))
            out = out.float().cpu().numpy()
            for loss, conf in pool.map(one_image, out[:count], G.metas_to_list(metas)[:count],
                                       origs[:count]):
                if loss is not None:
                    losses.append(loss)
                agg.accumulate_confusion(conf)
    return _finish(agg, float(np.mean(losses)) if losses else float("nan"), verbose)


def fit(
    state: TrainState,
    train_data: MaterializedDataset,
    val_data: MaterializedDataset,
    *,
    loss_fn: Callable,
    epochs: int,
    batch_size: int,
    accum_steps: int = 1,
    save_dir: str,
    name: str,
    host_loss_fn: Optional[Callable] = None,
    num_classes: int = 4,
    eval_ignore_index: Optional[int] = 3,
    eval_batch_size: Optional[int] = None,
    resume: bool = False,
    seed: int = 0,
    notes: str = "",
    verbose: bool = True,
    eval_state_fn: Optional[Callable[[TrainState], TrainState]] = None,
    eval_protocol: str = "auto",
    eval_loss_cfg=None,
    checkpoint_every: int = 1,
    early_stop_patience: Optional[int] = None,
    augment_fn: Optional[Callable] = None,
    metrics_logger=None,
    axis: Optional[DataAxis] = None,
) -> FitResult:
    """Train with per-epoch original-resolution validation and
    best-val-mIoU checkpointing (reference utils/training.py:453-618).

    `batch_size` is the step batch (micro-batch × `accum_steps`).
    `checkpoint_every` sets the `_last` checkpoint's cadence in epochs
    (an epoch with a new best always saves, to `name`, `name_last` and
    `MO_name`). `eval_state_fn(state)` gives the state to evaluate, and
    the one each checkpoint holds and a resume restores into: for a
    cached-feature ClipUNet run, whose step trains the decoder-only view,
    the whole ClipUNet with the same optimizer. (JAX's fit evaluates
    `eval_state_fn(state)` but saves `state`, so the checkpoints of its
    cached-feature runs hold the decoder alone, which its `--evaluate`
    cannot load into a ClipUNet, and from which `--clipunet-checkpoint`
    grafts no ViT.)
    `early_stop_patience=N` stops after N epochs without a val-mIoU gain
    and records the epoch in history['stopped_early']. `augment_fn(images,
    labels, generator)` (e.g. `ops.augment.random_augment_batch`, with the
    epoch's CPU generator) transforms every step batch before its
    micro-batch split, resident or streamed (`_train_set`). SIGTERM and SIGINT
    stop the run after the current epoch, with its checkpoint written.
    `metrics_logger` (e.g. `utils.tb.TensorBoardLogger`) gets one
    `log(epoch, scalars)` each epoch under JAX's names (loop.py:925-934).
    Returns once every checkpoint is on disk.

    Over a data `axis` (`train.multihost_loop.fit_multihost` gives it),
    every process runs this with the same arguments and data: the same
    shuffle and augmentation draws, each process's rows of every step
    batch (`local_step_rows`), the eval split by columns; process 0 alone
    writes the history, the checkpoints and the logger's events, and a
    stop requested on any process stops all of them at the same epoch.
    Every process returns once the files are on disk."""
    if eval_loss_cfg is None and host_loss_fn is None and isinstance(
            loss_fn, (DiceCELoss, DiceNLLLoss)):
        # the val loss defaults to the train loss under the eval contract
        # (eval ignore index, the tight Dice smooth), as run.py wires it
        eval_loss_cfg = dataclasses.replace(loss_fn, ignore_index=eval_ignore_index,
                                            smooth_dice=1e-5)
    lead = axis is None or axis.rank == 0
    if lead:
        os.makedirs(save_dir, exist_ok=True)
    ckpt_path = os.path.join(save_dir, name)
    last_path = os.path.join(save_dir, name + "_last")
    weights_path = os.path.join(save_dir, "MO_" + name)
    device = _device_of(state)

    history = _history_new()
    best = {"dice": -1.0, "miou": -1.0, "loss": float("inf")}
    start_epoch = 0
    if resume:
        # prefer the per-epoch `_last` checkpoint, else the best one (the
        # reference's resume, utils/training.py:502-544)
        source = last_path if os.path.isdir(last_path) else ckpt_path
        if os.path.isdir(source):
            target = eval_state_fn(state) if eval_state_fn is not None else state
            _, meta = ckpt.restore_checkpoint(source, target)
            state.step = target.step
            start_epoch = int(meta.get("epoch", 0)) + 1
            best.update(meta.get("best", {}))
            saved = meta.get("history", {})
            for k in list(history) + ["stopped_early"]:
                if k in saved:
                    history[k] = list(saved[k])
            if verbose:
                print(f"Resumed {name} from {os.path.basename(source)} at epoch "
                      f"{start_epoch} (best miou {best['miou']:.4f})")
    if axis is not None:
        replicate_for_processes(state.model, axis)

    n = len(train_data)
    nsteps = n // batch_size
    if nsteps == 0:
        raise ValueError(f"epoch produced zero training batches: dataset size {n} < "
                         f"batch_size {batch_size} (drop_last needs one full batch)")
    if augment_fn is not None and train_data.has_heatmaps:
        # JAX's words (loop.py:781-790)
        raise ValueError(
            "augment_fn is not supported for prompt (heatmap) datasets; "
            "generate augmented prompt triplets offline instead "
            "(data.prompts.generate_prompt_dataset over an augmented "
            "dataset, reference utils/augmentation.ipynb cell 23)")
    train_set = _train_set(train_data, device, reconstruction=False, verbose=verbose)
    rows = None if axis is None else local_step_rows(batch_size, accum_steps, axis)
    if rows is not None and augment_fn is not None:
        augment_fn = functools.partial(augment_fn, rows=rows, total=batch_size)

    # the shuffle, seeded as the JAX loop seeds a fresh run, replayed to the
    # epoch a resumed run starts at
    rng = np.random.default_rng(seed)
    for _ in range(start_epoch):
        rng.permutation(n)
    agg = MetricsHistory(num_classes, ignore_index=eval_ignore_index)
    epochs_since_improve = 0
    writer = ckpt.CheckpointWriter()

    stop = {"flag": False}

    def _request_stop(signum, frame):
        stop["flag"] = True
        print(f"[fit] signal {signum} received — will checkpoint and stop after this epoch")

    prev_handlers = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            prev_handlers[sig] = signal.signal(sig, _request_stop)
        except ValueError:  # not the main thread
            break
    try:
        for epoch in range(start_epoch, epochs):
            t0 = time.time()
            if verbose:
                print(f"Epoch {epoch + 1}/{epochs} [{name}]")
            aug_gen = None if augment_fn is None else torch.Generator().manual_seed(
                seed * 100003 + epoch)
            order = epoch_order(rng, n, batch_size)
            losses = torch.stack([
                train_step(state, loss_fn, *batch, accum_steps, augment_fn, aug_gen)
                for batch in train_set.batches(order if rows is None else order[:, rows])])
            train_loss = float(losses.mean())
            if verbose:
                print(f"  train: loss={train_loss:.4f}")

            eval_state = eval_state_fn(state) if eval_state_fn is not None else state
            val = evaluate(eval_state, val_data, host_loss_fn=host_loss_fn,
                           num_classes=num_classes, eval_ignore_index=eval_ignore_index,
                           batch_size=eval_batch_size or batch_size, agg=agg,
                           verbose=verbose, protocol=eval_protocol, loss_cfg=eval_loss_cfg,
                           axis=axis)
            history["train_loss"].append(train_loss)
            history["val_loss"].append(val["loss"])
            history["val_dice"].append(val["dice"])
            history["val_iou"].append(val["iou"])
            history["val_acc"].append(val["acc"])
            history["val_per_class_iou"].append(val["per_class_iou"])
            history["epoch_time_s"].append(time.time() - t0)

            # no valid class at all: fall back to the val loss, so the run
            # still saves a best checkpoint
            improved = (val["loss"] < best["loss"] if np.isnan(val["iou"])
                        else val["iou"] > best["miou"])
            if improved:
                best = {"dice": val["dice"], "miou": val["iou"], "loss": val["loss"]}
                epochs_since_improve = 0
            else:
                epochs_since_improve += 1
            if early_stop_patience is not None and epochs_since_improve >= early_stop_patience:
                stop["flag"] = True
                history["stopped_early"] = [epoch + 1]
                if verbose:
                    print(f"[fit] early stop: no val-mIoU improvement in "
                          f"{epochs_since_improve} epochs (best {best['miou']:.4f})")
            if axis is not None:
                stop["flag"] = any_process(stop["flag"], device)
            if lead:
                _save_history(save_dir, name, history)
                if metrics_logger is not None:
                    metrics_logger.log(epoch + 1, {
                        "train/loss": train_loss, "val/loss": val["loss"],
                        "val/dice": val["dice"], "val/miou": val["iou"], "val/acc": val["acc"],
                        "val/per_class_iou": val["per_class_iou"],
                        "time/epoch_s": history["epoch_time_s"][-1]})

            last_due = ((epoch + 1) % max(1, checkpoint_every) == 0
                        or epoch == epochs - 1 or stop["flag"])
            if improved and lead:
                ckpt.save_checkpoint_async(
                    writer, ckpt_path, eval_state, epoch=epoch, best=best, history=history,
                    notes=notes,
                    params_only_path=weights_path,
                    extra_paths=(last_path,), slot="best")
                if verbose:
                    print(f"  saved checkpoint (new best miou {val['iou']:.4f})")
            elif last_due and lead:
                ckpt.save_checkpoint_async(writer, last_path, eval_state, epoch=epoch, best=best,
                                           history=history, notes=notes, slot="last")
            if stop["flag"]:
                if verbose:
                    print(f"[fit] stopping after epoch {epoch + 1} on request")
                break
        writer.wait()
        if axis is not None:
            dist.barrier()
    except BaseException:
        # surface a failed save without masking the active exception
        try:
            writer.wait()
        except Exception as save_err:
            print(f"[fit] async save also failed: {save_err!r}")
        raise
    finally:
        for sig, h in prev_handlers.items():
            signal.signal(sig, h)
    return FitResult(state=state, history=history, best=best)


def evaluate_reconstruction(state: TrainState, val_data: MaterializedDataset, *,
                            originals: list, batch_size: int = 8,
                            verbose: bool = True) -> float:
    """Reconstruction eval at the original resolution (reference
    utils/training.py:202-239): each reconstruction is inverted to its
    image's own size on the host, and the MSE is taken against the
    untouched image truncated to 3 channels (JAX loop.py:1032). Returns
    the mean of the per-image MSEs."""
    device = _device_of(state)
    losses = []
    for inputs, _, metas, _, count in eval_batches(val_data, batch_size):
        out = eval_forward(state.model, torch.from_numpy(inputs[0]).to(device))
        out = out.float().cpu().numpy()
        metas_list = G.metas_to_list(metas)
        base = len(losses)
        for i in range(count):
            inv = G.invert_resize_padding_np(out[i], metas_list[i], method="linear")
            orig = originals[base + i][:, :, :3]
            losses.append(float(((inv - orig) ** 2).mean()))
    val = float(np.mean(losses))
    if verbose:
        print(f"  val recon mse={val:.6f}")
    return val


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def fit_reconstruction(
    state: TrainState,
    train_data: MaterializedDataset,
    val_data: MaterializedDataset,
    *,
    originals: list,
    epochs: int,
    batch_size: int,
    accum_steps: int = 1,
    save_dir: str,
    name: str,
    resume: bool = False,
    seed: int = 0,
    verbose: bool = True,
    metrics_logger=None,
) -> FitResult:
    """Autoencoder stage 1 (reference autoencoder.ipynb cell 0; JAX
    loop.py:1041-1158): MSE of the reconstruction against the resized
    input, from a device-resident (or, past the budget, streamed) set
    whose one image buffer is input and target; the original-resolution
    val MSE each epoch; a checkpoint at `save_dir/name` whenever the val
    MSE falls (no `_last`, no `MO_`), and resume from it. As in JAX, the shuffle is seeded `seed + start_epoch`
    and an epoch is max(1, n // batch_size) steps. `originals` are the
    raw val images at their own sizes. `metrics_logger` gets JAX's
    train/mse, val/mse and time/epoch_s each epoch (loop.py:1143-1148)."""
    os.makedirs(save_dir, exist_ok=True)
    ckpt_path = os.path.join(save_dir, name)
    device = _device_of(state)
    history = {"train_loss": [], "val_loss": [], "epoch_time_s": []}
    best = {"loss": float("inf")}
    start_epoch = 0
    if resume and os.path.isdir(ckpt_path):
        state, meta = ckpt.restore_checkpoint(ckpt_path, state)
        start_epoch = int(meta.get("epoch", 0)) + 1
        best.update(meta.get("best", {}))
        for k in history:
            if k in meta.get("history", {}):
                history[k] = list(meta["history"][k])

    train_set = _train_set(train_data, device, reconstruction=True, verbose=verbose)
    n = len(train_data)
    nsteps = max(1, n // batch_size)
    rng = np.random.default_rng(seed + start_epoch)
    writer = ckpt.CheckpointWriter()
    try:
        for epoch in range(start_epoch, epochs):
            t0 = time.time()
            if verbose:
                print(f"Epoch {epoch + 1}/{epochs} [{name}]")
            order = rng.permutation(n)[: nsteps * batch_size].reshape(nsteps, -1)
            losses = torch.stack([train_step(state, mse_loss, *batch, accum_steps)
                                  for batch in train_set.batches(order)])
            train_loss = float(losses.mean())
            if verbose:
                print(f"  train: mse={train_loss:.6f}")
            val_loss = evaluate_reconstruction(state, val_data, originals=originals,
                                               batch_size=batch_size, verbose=verbose)
            history["train_loss"].append(train_loss)
            history["val_loss"].append(val_loss)
            history["epoch_time_s"].append(time.time() - t0)
            _save_history(save_dir, name, history)
            if metrics_logger is not None:
                metrics_logger.log(epoch + 1, {"train/mse": train_loss, "val/mse": val_loss,
                                               "time/epoch_s": history["epoch_time_s"][-1]})
            if val_loss < best["loss"]:
                best = {"loss": val_loss}
                ckpt.save_checkpoint_async(writer, ckpt_path, state, epoch=epoch, best=best,
                                           history=history, slot="best")
                if verbose:
                    print(f"  saved checkpoint (new best val mse {val_loss:.6f})")
        writer.wait()
    except BaseException:
        try:
            writer.wait()
        except Exception as save_err:
            print(f"[fit] async save also failed: {save_err!r}")
        raise
    return FitResult(state=state, history=history, best=best)

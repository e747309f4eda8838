"""Training orchestration: `fit` and the original-resolution `evaluate`.

Counterpart of image_segmentation_tpu/train/loop.py (fit :650-1009,
evaluate :328-444, _evaluate_device :82-178), as the reference engine
(utils/training.py) runs it:
  * a train epoch is the shuffled step batches of a device-resident train
    set through `train_step` (accumulation inside, train/steps.py);
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
    file).
Not ported: the TPU dispatch chunking (`_dispatch_epoch_chunked`), the
per-batch streaming train path (a train set that fits the device budget
in no dtype is refused), `fit_reconstruction`, meshes and multihost.
"""
from __future__ import annotations

import dataclasses
import json
import os
import signal
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Optional

import numpy as np
import torch

from image_segmentation_tpu_torch.data.loader import (
    MaterializedDataset,
    epoch_order,
    eval_batches,
)
from image_segmentation_tpu_torch.losses import DiceCELoss, DiceNLLLoss
from image_segmentation_tpu_torch.metrics import MetricsHistory
from image_segmentation_tpu_torch.ops import geometry as G
from image_segmentation_tpu_torch.train import checkpoint as ckpt
from image_segmentation_tpu_torch.train import fast_eval
from image_segmentation_tpu_torch.train.state import TrainState
from image_segmentation_tpu_torch.train.steps import (
    ResidentTrainSet,
    eval_forward,
    resident_plan,
    train_step,
)

# Device memory the resident train set may take (the JAX default of
# ISTPU_TRAIN_DEVICE_CACHE_MB); past it the set is held as uint8.
TRAIN_DEVICE_BUDGET = 4096 << 20
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
                     batch_size: int):
    """The device protocol over one packed canvas (the whole set or one
    bucket). The set goes to the device once; each batch is gathered
    there. Returns (confusion (C, C) int64 tensor, losses (n,) tensor)."""
    device = next(model.parameters()).device
    if val_data.label_canvases is None:
        val_data.label_canvases = fast_eval.pack_label_canvases(val_data.orig_labels)
    canvases = val_data.label_canvases
    if val_data.device_eval_cache is None or val_data.device_eval_cache[0] != device:
        inputs = (val_data.images,) + ((val_data.heatmaps,) if val_data.has_heatmaps else ())
        val_data.device_eval_cache = (device, (
            tuple(torch.from_numpy(x).to(device) for x in inputs),
            _metas_on(val_data.metas, device),
            torch.from_numpy(canvases).to(device)))
    dev_inputs, dev_metas, dev_canvases = val_data.device_eval_cache[1]

    n = len(val_data)
    hc, wc = canvases.shape[1:]
    while batch_size > 1 and batch_size * hc * wc * (num_classes + 1) * 4 > EVAL_BATCH_BYTES:
        batch_size //= 2
    conf = torch.zeros((num_classes, num_classes), dtype=torch.int64, device=device)
    losses = []
    for start in range(0, n, batch_size):
        # the tail batch repeats its last index; `real` masks the repeats
        pos = torch.arange(start, start + batch_size, device=device)
        ii = pos.clamp(max=n - 1)
        scores = eval_forward(model, *(x.index_select(0, ii) for x in dev_inputs))
        with torch.no_grad():
            bconf, blosses = fast_eval.eval_batch(
                scores, {k: v.index_select(0, ii) for k, v in dev_metas.items()},
                dev_canvases.index_select(0, ii), pos < n, num_classes, loss_fn)
        conf += bconf
        losses.append(blosses[: min(batch_size, n - start)])
    return conf, torch.cat(losses)


def _evaluate_device(state: TrainState, val_data: MaterializedDataset, *, loss_cfg,
                     num_classes: int, agg: MetricsHistory, batch_size: int = 8,
                     verbose: bool = True):
    """The device protocol (train/fast_eval.py) over canvas-size buckets
    when the set has 16 or more images, else one canvas."""
    agg.reset()
    loss_fn = fast_eval.make_masked_loss(loss_cfg) if loss_cfg is not None else None
    views = _bucket_views(val_data) if len(val_data) >= 16 else []
    if views and verbose:
        print(f"  val: {len(views)} canvas buckets {[len(v) for v in views]}")
    parts = [_eval_one_canvas(state.model, v, loss_fn=loss_fn, num_classes=num_classes,
                              batch_size=batch_size) for v in (views or [val_data])]
    agg.accumulate_confusion(sum(c for c, _ in parts))  # the one host fetch
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
             protocol: str = "auto", loss_cfg=None):
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
    built with kernels runs K1 on CUDA."""
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
                                agg=agg, batch_size=batch_size, verbose=verbose)
    if protocol != "host":
        raise ValueError(f"protocol {protocol!r} not in ('auto', 'device', 'host')")
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
) -> FitResult:
    """Train with per-epoch original-resolution validation and
    best-val-mIoU checkpointing (reference utils/training.py:453-618).

    `batch_size` is the step batch (micro-batch × `accum_steps`).
    `checkpoint_every` sets the `_last` checkpoint's cadence in epochs
    (an epoch with a new best always saves, to `name`, `name_last` and
    `MO_name`). `eval_state_fn(state)` gives the state to evaluate.
    `early_stop_patience=N` stops after N epochs without a val-mIoU gain
    and records the epoch in history['stopped_early']. SIGTERM and SIGINT
    stop the run after the current epoch, with its checkpoint written.
    Returns once every checkpoint is on disk."""
    if eval_loss_cfg is None and host_loss_fn is None and isinstance(
            loss_fn, (DiceCELoss, DiceNLLLoss)):
        # the val loss defaults to the train loss under the eval contract
        # (eval ignore index, the tight Dice smooth), as run.py wires it
        eval_loss_cfg = dataclasses.replace(loss_fn, ignore_index=eval_ignore_index,
                                            smooth_dice=1e-5)
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
            state, meta = ckpt.restore_checkpoint(source, state)
            start_epoch = int(meta.get("epoch", 0)) + 1
            best.update(meta.get("best", {}))
            saved = meta.get("history", {})
            for k in list(history) + ["stopped_early"]:
                if k in saved:
                    history[k] = list(saved[k])
            if verbose:
                print(f"Resumed {name} from {os.path.basename(source)} at epoch "
                      f"{start_epoch} (best miou {best['miou']:.4f})")

    n = len(train_data)
    nsteps = n // batch_size
    if nsteps == 0:
        raise ValueError(f"epoch produced zero training batches: dataset size {n} < "
                         f"batch_size {batch_size} (drop_last needs one full batch)")
    if train_data.has_heatmaps:
        raise NotImplementedError("prompt (heatmap) training is not ported yet")
    f32_bytes = train_data.images.nbytes + train_data.labels.nbytes
    fits, quantize = resident_plan(f32_bytes, TRAIN_DEVICE_BUDGET)
    if not fits:
        raise ValueError(f"train set of {f32_bytes} bytes (float32) does not fit the "
                         f"device budget of {TRAIN_DEVICE_BUDGET} bytes even as uint8")
    cached = train_data.device_train_cache
    if cached is None or cached[0] != (device, quantize):
        if quantize and verbose:
            print(f"[fit] uint8 device residency ({f32_bytes / 2**20:.0f} MB float32 > "
                  f"{TRAIN_DEVICE_BUDGET / 2**20:.0f} MB budget)")
        train_data.device_train_cache = ((device, quantize), ResidentTrainSet(
            train_data.images, train_data.labels, device, quantize))
    resident = train_data.device_train_cache[1]

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
            idx_mat = torch.from_numpy(epoch_order(rng, n, batch_size)).to(device)
            losses = torch.stack([
                train_step(state, loss_fn, *resident.batch(idx_mat[s]), accum_steps)
                for s in range(nsteps)])
            train_loss = float(losses.mean())
            if verbose:
                print(f"  train: loss={train_loss:.4f}")

            val = evaluate(eval_state_fn(state) if eval_state_fn is not None else state,
                           val_data, host_loss_fn=host_loss_fn, num_classes=num_classes,
                           eval_ignore_index=eval_ignore_index,
                           batch_size=eval_batch_size or batch_size, agg=agg,
                           verbose=verbose, protocol=eval_protocol, loss_cfg=eval_loss_cfg)
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
            _save_history(save_dir, name, history)

            last_due = ((epoch + 1) % max(1, checkpoint_every) == 0
                        or epoch == epochs - 1 or stop["flag"])
            if improved:
                ckpt.save_checkpoint_async(
                    writer, ckpt_path, state, epoch=epoch, best=best, history=history,
                    notes=notes,
                    params_only_path=weights_path,
                    extra_paths=(last_path,), slot="best")
                if verbose:
                    print(f"  saved checkpoint (new best miou {val['iou']:.4f})")
            elif last_due:
                ckpt.save_checkpoint_async(writer, last_path, state, epoch=epoch, best=best,
                                           history=history, notes=notes, slot="last")
            if stop["flag"]:
                if verbose:
                    print(f"[fit] stopping after epoch {epoch + 1} on request")
                break
        writer.wait()
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

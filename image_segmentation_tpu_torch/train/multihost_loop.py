"""Training across processes: `fit` over a data axis of processes.

Counterpart of image_segmentation_tpu/train/multihost_loop.py
(`fit_multihost` :177, `_evaluate_multihost` :64). Every process calls
`fit_multihost` with the same arguments and the same materialised data,
and each drives its own device (parallel/mesh.py). What JAX's loop does,
the port's `fit` does over the axis (train/loop.py):

  * the same state on every process, checked after any resume
    (`parallel.multihost.replicate_for_processes`);
  * one shared-seed shuffle (drop-last) and the augmentation draws of
    single-process `fit`, so the batch schedule is the single-process
    one; each process trains on its share of every micro-batch
    (`train.steps.local_step_rows`), with BatchNorm statistics and losses
    over the whole micro-batch and the gradients summed once a step;
  * the device-resident or streamed train set of each process under
    `fit`'s budgets (each process holds the whole set, as each JAX
    process holds the whole materialised set on its host);
  * JAX's `_evaluate_multihost` is `loop.evaluate(axis=...)`: each process
    evaluates its block of columns of every eval batch (K1 in the UNet
    family's and the prompt model's eval forward on CUDA), in batches that
    stay a multiple of the processes under the per-batch buffer limit; the
    int64 confusion is summed and the per-image losses are gathered, so
    every process holds the same metrics;
  * process 0 alone writes `name`, `name_last`, `MO_name`, the metrics
    file and the logger's events, and every process returns once they are
    on disk; `resume` restores every process from the shared directory.

Where it departs from JAX's loop:
  * `early_stop_patience` is honoured (JAX's `run.py:664` does not pass
    it, and its `fit_multihost` has no such argument, so
    `--early-stop-patience` is dropped under `--multihost` without a
    word);
  * a resume replays the shuffle generator to its epoch, as the port's
    `fit` does (JAX reseeds with seed + start_epoch, :264), so a resumed
    run equals the single-process resumed run;
  * a micro-batch that does not divide over the processes is refused
    (JAX reshards it).
"""
from __future__ import annotations

from typing import Callable, Optional

from image_segmentation_tpu_torch.data.loader import MaterializedDataset
from image_segmentation_tpu_torch.parallel.mesh import get_mesh
from image_segmentation_tpu_torch.train.loop import FitResult, fit
from image_segmentation_tpu_torch.train.state import TrainState


def fit_multihost(
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
    num_classes: int = 4,
    eval_ignore_index: Optional[int] = 3,
    eval_batch_size: Optional[int] = None,
    eval_loss_cfg=None,
    seed: int = 0,
    notes: str = "",
    verbose: bool = True,
    resume: bool = False,
    augment_fn: Optional[Callable] = None,
    metrics_logger=None,
    checkpoint_every: int = 1,
    early_stop_patience: Optional[int] = None,
) -> FitResult:
    """Train with per-epoch distributed validation and best-val-mIoU
    checkpointing across the processes of the initialised group (module
    docstring). `batch_size` is the global step batch (micro-batch ×
    `accum_steps`); the micro-batch must divide over the processes. The
    data axis is the group's, on the device of `state`'s model. Only
    process 0 prints, logs and writes."""
    axis = get_mesh(next(state.model.parameters()).device.type)
    return fit(state, train_data, val_data, loss_fn=loss_fn, epochs=epochs,
               batch_size=batch_size, accum_steps=accum_steps, save_dir=save_dir, name=name,
               num_classes=num_classes, eval_ignore_index=eval_ignore_index,
               eval_batch_size=eval_batch_size, resume=resume, seed=seed, notes=notes,
               verbose=verbose and axis.rank == 0, eval_protocol="device",
               eval_loss_cfg=eval_loss_cfg, checkpoint_every=checkpoint_every,
               early_stop_patience=early_stop_patience, augment_fn=augment_fn,
               metrics_logger=metrics_logger if axis.rank == 0 else None, axis=axis)

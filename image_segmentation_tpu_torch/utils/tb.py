"""TensorBoard metrics logging for training runs.

Counterpart of image_segmentation_tpu/utils/tb.py (`TensorBoardLogger`
:24, `maybe_logger` :62): one scalar event per epoch metric through
tensorboardX, a few host floats an epoch, off the training path. As in
JAX, a logger asked for where tensorboardX is not installed raises an
ImportError that says so; nothing else needs the package.

    logger = TensorBoardLogger(logdir)          # or run.py --tensorboard
    fit(..., metrics_logger=logger)
    logger.close()
"""
from __future__ import annotations

import os
from typing import Mapping, Optional

import numpy as np


class TensorBoardLogger:
    """Per-epoch scalar logging to a TensorBoard event file."""

    def __init__(self, logdir: str):
        try:
            import tensorboardX
        except ImportError as e:
            raise ImportError(
                "TensorBoard logging needs the tensorboardX package "
                "(pip install tensorboardX) or drop --tensorboard") from e
        os.makedirs(logdir, exist_ok=True)
        self.logdir = logdir
        self._writer = tensorboardX.SummaryWriter(logdir)

    def log(self, step: int, scalars: Mapping[str, object]) -> None:
        """One step's scalars. An array value (per-class IoU) fans out to
        one tag per element; NaNs are written as they are."""
        for tag, value in scalars.items():
            arr = np.asarray(value)
            if arr.ndim == 0:
                self._writer.add_scalar(tag, float(arr), step)
            else:
                for i, v in enumerate(arr.ravel().tolist()):
                    self._writer.add_scalar(f"{tag}_{i}", float(v), step)

    def flush(self) -> None:
        self._writer.flush()

    def close(self) -> None:
        self._writer.close()


def maybe_logger(logdir: Optional[str]) -> Optional[TensorBoardLogger]:
    """A logger at `logdir`, or None when it is None."""
    return TensorBoardLogger(logdir) if logdir else None

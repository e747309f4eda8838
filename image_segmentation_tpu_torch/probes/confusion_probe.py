"""Confusion-count formulations on eval-protocol shapes.

Counterpart of the JAX repository's benchmarks/confusion_probe.py. The
original-resolution eval protocol (train/fast_eval.py) counts a (C, C)
confusion matrix per image over the static label canvas, where FILL
(255) marks the pixels outside the image. Formulations that give equal
counts:

  bincount   label·C + pred per valid pixel (the invalid ones to a bin
             past C·C), `torch.bincount`, the last bin cut;
  matmul     the one-hot product one-hot(label)ᵀ · one-hot(pred) per
             image in float32, the invalid rows zeroed (the JAX
             package's `confusion_counts_masked`), summed as integers;
  scatter    what the port's eval runs: per-image int64 scatter-adds
             (metrics/confusion.py `confusion_counts_per_image`).

The probe asserts that the three give equal counts, then times them in
interleaved turns (`--iters` synchronised calls each, `--repeat` turns):
the median ms a dispatch and its spread.

    python -m image_segmentation_tpu_torch.probes.confusion_probe [--batch 16]
        [--canvas 512] [--classes 4] [--device cpu]

The CPU runs 4 canvases of 64 px.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from image_segmentation_tpu_torch.metrics.confusion import confusion_counts_per_image
from image_segmentation_tpu_torch.probes import cli_device, interleaved, stamp

FILL = 255
FILL_SHARE = 0.15  # the share of FILL pixels, like a real canvas's tail


def inputs(batch: int, canvas: int, classes: int, device, seed: int = 0):
    """(labels with FILL, predictions, valid mask) as the JAX probe draws
    them from `seed`, int64 on `device`."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, classes, (batch, canvas, canvas))
    labels = np.where(rng.uniform(size=(batch, canvas, canvas)) < FILL_SHARE, FILL, labels)
    preds = rng.integers(0, classes, (batch, canvas, canvas))
    labels, preds = (torch.from_numpy(a).to(device) for a in (labels, preds))
    return labels, preds, labels != FILL


def via_bincount(labels, preds, valid, classes: int) -> torch.Tensor:
    idx = torch.where(valid, labels.clamp(0, classes - 1) * classes + preds, classes * classes)
    return torch.bincount(idx.reshape(-1), minlength=classes * classes + 1)[:-1].view(
        classes, classes)


def via_matmul(labels, preds, valid, classes: int) -> torch.Tensor:
    b = labels.shape[0]
    t = torch.nn.functional.one_hot(labels.clamp(0, classes - 1).reshape(b, -1), classes)
    t = t.float() * valid.reshape(b, -1, 1).float()
    p = torch.nn.functional.one_hot(preds.reshape(b, -1), classes).float()
    return torch.bmm(t.transpose(1, 2), p).long().sum(0)


def via_scatter(labels, preds, valid, classes: int) -> torch.Tensor:
    # FILL lies outside [0, C), so the count drops it as the eval's does
    return confusion_counts_per_image(preds, labels, classes).sum(0)


FORMULATIONS = {"bincount": via_bincount, "matmul": via_matmul, "scatter": via_scatter}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="python -m image_segmentation_tpu_torch.probes.confusion_probe")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--canvas", type=int, default=512)
    p.add_argument("--classes", type=int, default=4)
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--repeat", type=int, default=3)
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = p.parse_args(argv)
    device = cli_device(args.device)
    on_card = device.type == "cuda"
    b, h, c = (args.batch, args.canvas, args.classes) if on_card else (4, 64, args.classes)

    labels, preds, valid = inputs(b, h, c, device)
    counts = {name: fn(labels, preds, valid, c).cpu() for name, fn in FORMULATIONS.items()}
    want = counts["bincount"]
    equal = all(torch.equal(v, want) for v in counts.values())
    if not equal:
        raise AssertionError(f"formulations disagree: { {k: v.tolist() for k, v in counts.items()} }")

    times = interleaved({name: (lambda fn=fn: fn(labels, preds, valid, c))
                         for name, fn in FORMULATIONS.items()}, args.iters, args.repeat, device)
    rows = []
    for name, t in times.items():
        rows.append(stamp({"metric": f"confusion_{name}_ms_per_dispatch", "value": t.ms,
                           "unit": "ms", "spread_ms": [t.min_ms, t.max_ms], "shape": [b, h, h],
                           "classes": c}, device))
        print(json.dumps(rows[-1]), flush=True)
    summary = {"summary": "confusion_probe",
               "speedup_matmul_over_bincount": times["bincount"].ms / times["matmul"].ms,
               "speedup_scatter_over_bincount": times["bincount"].ms / times["scatter"].ms,
               "counts_equal": equal, "pixels_counted": int(want.sum())}
    print(json.dumps(summary), flush=True)
    return {"rows": rows, **summary}


if __name__ == "__main__":
    main()

"""Robustness sweep: 8 perturbation families × 10 severities.

Counterpart of the JAX repository's benchmarks/robustness.py, the
reference report's robustness evaluation (PDF §4.1, Fig. 6): each
perturbation applied at increasing severity to a materialised eval set,
mean Dice at original resolution per (perturbation, severity).

Perturbations (the report's families, on [0, 1] float images):
  gaussian_noise, salt_pepper, blur, contrast_down, brightness_up,
  brightness_down, occlusion, pixelate

Image i at severity s draws from `default_rng(seed * 1_000_003 + s *
10_007 + i)`, so the worker count cannot change a curve.

Library:
  from image_segmentation_tpu_torch.studies.robustness import robustness_sweep
  curves = robustness_sweep(forward, val_data, device="cuda")       # host path
  curves = robustness_sweep(None, val_data, state=TrainState(model))  # device path

CLI: quick-train a UNet on the synthetic task, then sweep it (the sizes
follow --device: base 32 at 256 px on the card, base 8 at 64 px for a
few steps on the CPU):
  python -m image_segmentation_tpu_torch.studies.robustness [--steps N]
      [--images N] [--device cpu]
"""
from __future__ import annotations

import concurrent.futures
import os
from typing import Callable, Dict, List

import numpy as np
import torch

from image_segmentation_tpu_torch.metrics import MetricsHistory
from image_segmentation_tpu_torch.ops import geometry as G
from image_segmentation_tpu_torch.studies import cli_device


def _noise(img, sev, rng):
    return np.clip(img + rng.normal(0, 0.04 * sev, img.shape), 0, 1)


def _salt_pepper(img, sev, rng):
    out = img.copy()
    p = 0.02 * sev
    m = rng.random(img.shape[:2])
    out[m < p / 2] = 0.0
    out[(m >= p / 2) & (m < p)] = 1.0
    return out


def _blur(img, sev, rng):
    from scipy.ndimage import gaussian_filter

    return gaussian_filter(img, sigma=(0.5 * sev, 0.5 * sev, 0))


def _contrast_down(img, sev, rng):
    alpha = 1.0 - 0.095 * sev
    return np.clip(0.5 + alpha * (img - 0.5), 0, 1)


def _brightness_up(img, sev, rng):
    return np.clip(img + 0.08 * sev, 0, 1)


def _brightness_down(img, sev, rng):
    return np.clip(img - 0.08 * sev, 0, 1)


def _occlusion(img, sev, rng):
    out = img.copy()
    h, w = img.shape[:2]
    side = int(min(h, w) * 0.05 * sev)
    if side > 0:
        y = rng.integers(0, h - side + 1)
        x = rng.integers(0, w - side + 1)
        out[y:y + side, x:x + side] = 0.0
    return out


def _pixelate(img, sev, rng):
    h, w = img.shape[:2]
    f = max(1, int(1 + sev))
    small = G.resize_nearest_np(img, (max(1, h // f), max(1, w // f)))
    return G.resize_nearest_np(small, (h, w))


PERTURBATIONS: Dict[str, Callable] = {
    "gaussian_noise": _noise,
    "salt_pepper": _salt_pepper,
    "blur": _blur,
    "contrast_down": _contrast_down,
    "brightness_up": _brightness_up,
    "brightness_down": _brightness_down,
    "occlusion": _occlusion,
    "pixelate": _pixelate,
}


def robustness_sweep(
    forward,
    val_data,
    *,
    num_classes: int = 4,
    eval_ignore_index: int = 3,
    severities: List[int] = list(range(1, 11)),
    seed: int = 0,
    batch_size: int = 8,
    verbose: bool = True,
    workers: int = 0,
    state=None,
    transfer_u8: bool = True,
    families=None,
    device=None,
) -> Dict[str, List[float]]:
    """Mean Dice per (perturbation, severity) on a materialised eval set
    (`val_data` with orig_labels kept). Perturbations apply to the staged
    fixed-size inputs; predictions are scored at original resolution.

    Two scoring paths, the same protocol:

    * host path (`forward(images) -> scores`, images an (N, T, T, 3) f32
      tensor on `device`, default cuda): every batch of a severity is
      enqueued, then the scores come back and each image's inverse
      geometry and confusion run on worker threads, merged in float64.
    * device path (`state=`, a TrainState whose model is evaluated): the
      train/fast_eval.py protocol, forward, canvas inverse, argmax and
      confusion on the model's device; a batch returns one (C, C) matrix.
      The perturbed images travel as uint8 (a quarter of the bytes; the
      precision an image on disk has) and are divided by 255 on the
      device, or as float32 with `transfer_u8=False`. The last batch
      repeats its last image up to the batch, which is at most the set's
      size (JAX pads to `batch_size` itself; the counts are the same).
    """
    from image_segmentation_tpu_torch.train.fast_eval import eval_batch, pack_label_canvases
    from image_segmentation_tpu_torch.train.steps import eval_forward

    workers = workers or min(8, os.cpu_count() or 4)
    results: Dict[str, List[float]] = {}
    n = len(val_data)
    metas = G.metas_to_list(val_data.metas)

    if state is not None:
        batch_size = min(batch_size, n)
        model = state.model
        device = next(model.parameters()).device
        labels_dev = torch.from_numpy(pack_label_canvases(val_data.orig_labels)).to(device)
        metas_dev = {f: torch.from_numpy(np.asarray(v).astype(np.int64)).to(device)
                     for f, v in val_data.metas._asdict().items() if f != "scale"}
    else:
        device = torch.device(device or "cuda")

    def img_confusion(scores_j, i):
        inv = G.invert_resize_padding_np(scores_j, metas[i])
        pred = inv.argmax(axis=-1)
        label = np.asarray(val_data.orig_labels[i]).reshape(pred.shape)
        idx = label.astype(np.int64) * num_classes + pred.astype(np.int64)
        return np.bincount(idx.reshape(-1), minlength=num_classes**2
                           ).reshape(num_classes, num_classes)

    chosen = {k: PERTURBATIONS[k] for k in (families or PERTURBATIONS)}
    with concurrent.futures.ThreadPoolExecutor(workers) as pool:
        for name, fn in chosen.items():
            dices = []
            for sev in severities:
                agg = MetricsHistory(num_classes, ignore_index=eval_ignore_index)

                def perturb(i, _fn=fn, _sev=sev):
                    r = np.random.default_rng(seed * 1_000_003 + _sev * 10_007 + i)
                    return _fn(val_data.images[i], _sev, r)

                if state is not None:
                    # batch index windows; the tail repeats its last index
                    confs = []
                    for start in range(0, n, batch_size):
                        idx = list(range(start, min(start + batch_size, n)))
                        real = torch.zeros((batch_size,), dtype=torch.bool)
                        real[: len(idx)] = True
                        idx += [idx[-1]] * (batch_size - len(idx))
                        imgs = np.stack(list(pool.map(perturb, idx))).astype(np.float32)
                        if transfer_u8:
                            imgs = np.clip(np.round(imgs * 255.0), 0, 255).astype(np.uint8)
                        x = torch.from_numpy(imgs).to(device)
                        if transfer_u8:
                            x = x.float() / 255.0
                        sel = torch.as_tensor(idx, device=device)
                        scores = eval_forward(model, x)
                        with torch.no_grad():
                            conf, _ = eval_batch(
                                scores, {k: v[sel] for k, v in metas_dev.items()},
                                labels_dev[sel], real.to(device), num_classes)
                        confs.append(conf)  # (C, C) on the device, fetched below
                    for conf in confs:
                        agg.accumulate_confusion(conf)
                else:
                    pending = []  # (device scores, idx), fetched after all are enqueued
                    for start in range(0, n, batch_size):
                        idx = list(range(start, min(start + batch_size, n)))
                        imgs = np.stack(list(pool.map(perturb, idx))).astype(np.float32)
                        pending.append((forward(torch.from_numpy(imgs).to(device)), idx))
                    conf_futures = []
                    for scores_dev, idx in pending:
                        scores = scores_dev.float().cpu().numpy()
                        conf_futures += [pool.submit(img_confusion, scores[j], i)
                                         for j, i in enumerate(idx)]
                    agg.accumulate_confusion(sum(f.result() for f in conf_futures))
                dice, _, _ = agg.compute_epoch_metrics()
                dices.append(dice)
            results[name] = dices
            if verbose:
                print(f"{name}: " + " ".join(f"{d:.3f}" for d in dices), flush=True)
    return results


def main(argv=None):
    """Quick-train a UNet on the synthetic task, then sweep: the report's
    robustness artifact (8 perturbations × 10 severities, mean Dice each)
    from a model that has learned the task."""
    import argparse
    import json

    from image_segmentation_tpu_torch.losses import DiceCELoss
    from image_segmentation_tpu_torch.models.unet import UNet
    from image_segmentation_tpu_torch.run import synthetic_materialized
    from image_segmentation_tpu_torch.train.state import TrainState, make_adamw
    from image_segmentation_tpu_torch.train.steps import train_step

    p = argparse.ArgumentParser(prog="python -m image_segmentation_tpu_torch.studies.robustness")
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--images", type=int, default=64)
    p.add_argument("--val-images", type=int, default=32)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs small sizes)")
    args = p.parse_args(argv)
    device = cli_device(args.device)

    on_card = device.type == "cuda"
    side = 256 if on_card else 64
    base = 32 if on_card else 8
    steps = args.steps if on_card else 4
    n_tr = args.images if on_card else 8
    n_va = args.val_images if on_card else 4

    train = synthetic_materialized(n_tr, side, seed=0)
    val = synthetic_materialized(n_va, side, seed=1, keep_orig_labels=True)
    model = UNet(num_classes=4, base=base, dtype=torch.bfloat16 if on_card else torch.float32,
                 use_kernels=on_card)
    model.init_weights(torch.Generator().manual_seed(0))
    model = model.to(device=device, memory_format=torch.channels_last)
    state = TrainState(model, make_adamw(model.parameters(), learning_rate=1e-3)[0])
    loss_fn = DiceCELoss(ignore_index=3)
    imgs = torch.from_numpy(train.images).to(device)
    labs = torch.from_numpy(train.labels).long().to(device)
    rng = np.random.default_rng(0)
    for _ in range(steps):
        ii = torch.from_numpy(rng.integers(0, n_tr, (args.batch,))).to(device)
        loss = train_step(state, loss_fn, imgs[ii], labs[ii])
    print(f"trained {steps} steps, final loss {float(loss):.4f}")

    from image_segmentation_tpu_torch.train.steps import eval_forward

    results = robustness_sweep(lambda x: eval_forward(model, x).float(), val, num_classes=4,
                               device=device)
    print(json.dumps({
        "metric": "robustness_mean_dice_by_perturbation",
        "clean_dice_floor_check": "severity curves should decay from the "
                                  "clean-trained level",
        "results": {k: [round(d, 4) for d in v] for k, v in results.items()},
    }))
    return results


if __name__ == "__main__":
    main()

"""BatchNorm regime: micro-batch-2 statistics against full-batch ones.

Counterpart of the JAX repository's benchmarks/bn_regime.py. The
reference computes BatchNorm's batch statistics over micro-batches of two
(batch_size 2 with accumulation 32 for an optimizer batch of 64;
reference utils/training.py:49-56); the port's fast path steps at batch
128 with one batch's statistics. Its `train_step` reproduces the
reference's semantics with `accum_steps` (each micro-batch's forward in
train mode, the running statistics updated in order). This study
measures whether the regime moves quality, on the ablations' hard
synthetic set (small low-contrast objects, class imbalance, boundary
rings), three arms of --seeds seeds each through `fit`:

  reference_bn   batch 64, accum_steps 32: statistics over micro-batch 2,
                 the optimizer on the mean of 32 gradients (the reference)
  batch64_bn     batch 64, accum_steps 1: statistics over all 64, the same
                 optimizer schedule; with reference_bn it isolates the
                 statistics regime
  production_bn  batch 128, accum_steps 1: the fast path (half the
                 optimizer steps an epoch at the same learning rate)

Weighted Dice + CE (FullWeight), the original-resolution eval protocol
each epoch (on the card through K1). One JSON line per (arm, seed) under
JAX's keys (plus the optimizer steps an epoch), then a summary with each
arm's mean and spread and the reference − batch64 and reference −
production deltas.

The card runs --images at 256 px, UNet --base in bf16; the CPU runs JAX's
CPU sizes: 32 images at 64 px, base 8, float32, 2 epochs, the arms at
batch 16 (accum 8) and 32 so that micro-batches stay 2.

    python -m image_segmentation_tpu_torch.studies.bn_regime [--images 256]
        [--epochs 24] [--seeds 3] [--base 32] [--out FILE] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import tempfile
from typing import Optional

import numpy as np
import torch

from image_segmentation_tpu_torch.studies import cli_device, device_kind
from image_segmentation_tpu_torch.studies.ablations import NUM_CLASSES, _dataset, _weights

METRICS = ("best_dice", "best_miou", "final_dice", "final_miou")


def arms(on_card: bool):
    """(name, step batch, accum_steps) of the three arms: the reference's
    effective batch of 64 on the card, scaled down on the CPU so that the
    micro-batches stay 2."""
    b_ref, accum_ref, b_prod = (64, 32, 128) if on_card else (16, 8, 32)
    return [("reference_bn", b_ref, accum_ref), ("batch64_bn", b_ref, 1),
            ("production_bn", b_prod, 1)]


def run_arm(arm, train, val, loss, epochs, batch, accum, base, dtype, seed, device,
            init: Optional[dict] = None) -> dict:
    """One arm and seed through `fit`: a UNet seeded `seed` (or holding the
    state dict `init`), AdamW at lr 1e-3. Returns JAX's row."""
    from image_segmentation_tpu_torch.models.unet import UNet
    from image_segmentation_tpu_torch.train.loop import fit
    from image_segmentation_tpu_torch.train.state import TrainState, make_adamw

    device = torch.device(device)
    model = UNet(num_classes=NUM_CLASSES, base=base, dtype=dtype,
                 use_kernels=device.type == "cuda")
    model.init_weights(torch.Generator().manual_seed(seed))
    if init is not None:
        model.load_state_dict(init)
    model = model.to(device=device, memory_format=torch.channels_last)
    opt, _ = make_adamw(model.parameters(), learning_rate=1e-3)
    with tempfile.TemporaryDirectory() as d:
        res = fit(TrainState(model, opt), train, val, loss_fn=loss, epochs=epochs,
                  batch_size=batch, accum_steps=accum, save_dir=d, name="bn", seed=seed,
                  eval_loss_cfg=loss, verbose=False)
    h = res.history
    et = h["epoch_time_s"]
    row = {"arm": arm, "seed": seed, "batch": batch, "accum_steps": accum,
           "micro_batch": batch // accum, "steps_per_epoch": len(train) // batch,
           "best_dice": float(res.best["dice"]), "best_miou": float(res.best["miou"]),
           "final_dice": float(h["val_dice"][-1]), "final_miou": float(h["val_iou"][-1]),
           "steady_epoch_s": float(np.median(et[1:]) if len(et) > 2 else et[-1])}
    print(json.dumps(row), flush=True)
    return row


def summarize(rows, images: int, epochs: int, base: int, size: int, arm_names) -> dict:
    summary = {"metric": "bn_regime_quality", "task": "hard_synthetic", "images": images,
               "epochs": epochs, "base": base, "size": size, "arms": {}}
    for arm in arm_names:
        rs = [r for r in rows if r["arm"] == arm]
        summary["arms"][arm] = {k: {"mean": float(np.mean([r[k] for r in rs])),
                                    "std": float(np.std([r[k] for r in rs])),
                                    "values": [r[k] for r in rs]} for k in METRICS}
    a = summary["arms"]
    for other in ("batch64", "production"):
        summary[f"delta_reference_minus_{other}"] = {
            k: a["reference_bn"][k]["mean"] - a[f"{other}_bn"][k]["mean"]
            for k in ("best_dice", "best_miou")}
    return summary


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="python -m image_segmentation_tpu_torch.studies.bn_regime")
    p.add_argument("--images", type=int, default=256)
    p.add_argument("--epochs", type=int, default=24)
    p.add_argument("--seeds", type=int, default=3)
    p.add_argument("--base", type=int, default=32)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = p.parse_args(argv)
    from image_segmentation_tpu_torch.losses import DiceCELoss

    device = cli_device(args.device)
    on_card = device.type == "cuda"
    dtype = torch.bfloat16 if on_card else torch.float32
    n = args.images if on_card else 32
    epochs = args.epochs if on_card else 2
    base = args.base if on_card else 8
    size = 256 if on_card else 64

    train = _dataset(n, size, seed=0)
    val = _dataset(max(32, n // 4), size, seed=100, keep_orig=True)
    loss = DiceCELoss(class_weights=_weights(train, "full"))
    plan = arms(on_card)
    rows = [run_arm(arm, train, val, loss, epochs, batch, accum, base, dtype, seed, device)
            for arm, batch, accum in plan for seed in range(args.seeds)]
    summary = summarize(rows, n, epochs, base, size, [a for a, _, _ in plan])
    summary["device"] = device_kind(device)
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "summary": summary}, f, indent=1)
    return {"rows": rows, "summary": summary}


if __name__ == "__main__":
    main()

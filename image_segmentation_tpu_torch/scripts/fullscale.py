"""The converged-run script: pseudo-Pet tree → both UNet rows trained to
convergence → the 8 × 10 robustness sweep of both best checkpoints.

Counterpart of the JAX repository's scripts/fullscale_r5.py. The
reference's published table comes from converged runs: 100 epochs at
effective batch 64 on the full Pet training split (reference
utils/training.py:453-618; PDF §3.3). This script produces that receipt
end to end:

  1. a pseudo-Pet source tree (studies/robustness_pipeline.make_pet_source:
     learnable variable-size JPEG scenes in the download layout), by
     default 3,700 source images, ~2,590 train after the 0.15/0.15 split;
  2. scripts/prepare_oxford_pet.py → {Train,Val,Test}/{color,label};
  3. scripts/reproduce_reference.py rows unet_aug (offline 8-augmenter
     materialisation) and unet_noaug at the 100-epoch effective-batch-64
     schedule, with an early stop at converged val mIoU
     (--early-stop-patience; --patience 0 runs the whole schedule);
  4. each row's per-epoch series (wall seconds, val mIoU and Dice, train
     loss, the early stop) from its metrics file;
  5. the 8-perturbation × 10-severity sweep of both best checkpoints on
     the Test split (PDF §4.1), on the device path
     (studies/robustness.robustness_sweep(state=...), uint8 transport).

A second invocation with the same --workdir resumes: the tree is reused,
and when {workdir}/table.json exists the training rows are too, and only
the sweep runs again.

  python -m image_segmentation_tpu_torch.scripts.fullscale \
      [--workdir runs/fullscale] [--images 3700] [--epochs 100] [--out f.json]
  ... --images 12 --epochs 1 --target-size 32 --batch 2 --device cpu  # small

Left out of JAX's script: the chunk-dispatch record (train/loop.py's
CHUNK_LOG and ISTPU_LOG_CHUNKS), since the port's loop has no dispatch
chunking, so the JSON has no `chunk_dispatch`; and the
ISTPU_TRAIN_DEVICE_CACHE_MB=6500 default, a figure for a 16 GB TPU: unset,
the port's train-set budget is a quarter of the card. The output goes to
{workdir}/fullscale.json unless --out says otherwise.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np

from image_segmentation_tpu_torch.studies import cli_device, device_kind


def _epoch_series(runs_dir: str, row: str, config_name: str) -> dict:
    """The row's per-epoch history from its metrics file."""
    with open(os.path.join(runs_dir, row, "metrics", config_name + ".json")) as f:
        h = json.load(f)
    return {
        "epoch_time_s": [round(float(t), 2) for t in h["epoch_time_s"]],
        "val_miou": [round(float(v), 4) for v in h["val_iou"]],
        "val_dice": [round(float(v), 4) for v in h["val_dice"]],
        "train_loss": [round(float(v), 4) for v in h["train_loss"]],
        "stopped_early": [int(v) for v in h.get("stopped_early", [])],
    }


def _first(val, m: int):
    """The first m images of a materialised set."""
    from image_segmentation_tpu_torch.ops import geometry as G

    return dataclasses.replace(
        val, images=val.images[:m], labels=val.labels[:m],
        metas=G.ResizeMeta(*(np.asarray(f)[:m] for f in val.metas)),
        orig_labels=val.orig_labels[:m])


def main(argv=None) -> dict:
    from image_segmentation_tpu_torch.scripts import reproduce_reference as repro
    from image_segmentation_tpu_torch.studies.robustness import robustness_sweep
    from image_segmentation_tpu_torch.studies.robustness_pipeline import (
        load_row_model,
        materialize_test_split,
        prepare_tree,
    )
    from image_segmentation_tpu_torch.train.state import TrainState

    p = argparse.ArgumentParser(prog="python -m image_segmentation_tpu_torch.scripts.fullscale")
    p.add_argument("--images", type=int, default=3700,
                   help="pseudo-Pet source size (0.15/0.15 split → ~0.7·N train)")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--patience", type=int, default=12,
                   help="early-stop patience in epochs (0 = the whole schedule)")
    p.add_argument("--batch", type=int, default=32,
                   help="the micro-batch; config.py keeps the reference's effective "
                        "batch 64 (accumulation 64 // batch)")
    p.add_argument("--target-size", type=int, default=256)
    p.add_argument("--workdir", default=os.path.join("runs", "fullscale"))
    p.add_argument("--rows", default="unet_aug,unet_noaug")
    p.add_argument("--skip-robustness", action="store_true")
    p.add_argument("--sweep-families", default=None,
                   help="comma-separated subset of the 8 perturbation families "
                        "(default: all)")
    p.add_argument("--sweep-images", type=int, default=0,
                   help="sweep only the first N Test images (0 = all)")
    p.add_argument("--device", default="cuda",
                   help="torch device for the runs and the sweep (default cuda)")
    p.add_argument("--out", default=None, help="default {workdir}/fullscale.json")
    args = p.parse_args(argv)
    device = cli_device(args.device)

    t_all = time.time()
    work = args.workdir
    tree = prepare_tree(work, args.images)
    runs = os.path.join(work, "runs")
    table_path = os.path.join(work, "table.json")
    resumed = os.path.exists(table_path)
    t_train = time.time()
    if resumed:
        with open(table_path) as f:
            table = json.load(f)["rows"]
        print(f"[fullscale] resuming from {table_path} (training rows reused)")
    else:
        table = repro.main([
            "--data-root", tree, "--save-dir", runs, "--rows", args.rows,
            "--epochs", str(args.epochs), "--batch-size", str(args.batch),
            "--target-size", str(args.target_size), "--offline-aug",
            "--device", args.device,
            *(["--early-stop-patience", str(args.patience)] if args.patience else []),
            "--json-out", table_path,
        ])
    train_s = time.time() - t_train

    rows = [r.strip() for r in args.rows.split(",")]
    # the config name is the row name for the UNet rows
    series = {row: _epoch_series(runs, row, row) for row in rows}
    curves, gaps = {}, {}
    if not args.skip_robustness and set(rows) >= {"unet_aug", "unet_noaug"}:
        val = materialize_test_split(tree, args.target_size)
        if args.sweep_images and args.sweep_images < len(val):
            val = _first(val, args.sweep_images)
            print(f"[fullscale] sweep restricted to the first {args.sweep_images} Test images")
        fams = [f.strip() for f in args.sweep_families.split(",")] if args.sweep_families \
            else None
        for row in ("unet_aug", "unet_noaug"):
            # the device protocol: only a (C, C) matrix comes back per batch
            state = TrainState(load_row_model(runs, row, device))
            print(f"[fullscale] robustness sweep: {row}", flush=True)
            curves[row] = robustness_sweep(None, val, num_classes=4, state=state,
                                           batch_size=64, families=fams)
        mean_aug = {k: float(np.mean(v)) for k, v in curves["unet_aug"].items()}
        mean_no = {k: float(np.mean(v)) for k, v in curves["unet_noaug"].items()}
        gaps = {k: round(mean_aug[k] - mean_no[k], 4) for k in mean_aug}

    out = {
        "device": device_kind(device),
        "config": {
            "source_images": args.images,
            "epochs_budget": args.epochs,
            "early_stop_patience": args.patience,
            "micro_batch": args.batch,
            "effective_batch": 64,  # config.py: accumulation 64 // micro
            "target_size": args.target_size,
            "offline_aug": True,
            "sweep_images": args.sweep_images or "all",
            "sweep_protocol": "device (fast_eval canvas confusion), uint8 transport",
            "resumed_training": resumed,
        },
        "table": table,
        "reference_table": {r: repro.REFERENCE_TABLE[r][1:] for r in rows
                            if r in repro.REFERENCE_TABLE},
        "epoch_series": series,
        "robustness_mean_dice_gap_aug_minus_noaug": gaps,
        "robustness_aug_wins": sum(1 for g in gaps.values() if g > 0),
        "robustness_curves": {r: {k: [round(d, 4) for d in v] for k, v in cv.items()}
                              for r, cv in curves.items()},
        "train_wall_s": round(train_s, 1),
        "total_wall_s": round(time.time() - t_all, 1),
    }
    path = args.out or os.path.join(work, "fullscale.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"[fullscale] wrote {path}")
    print(json.dumps({k: out[k] for k in (
        "table", "robustness_mean_dice_gap_aug_minus_noaug", "robustness_aug_wins",
        "train_wall_s")}, indent=1, default=str))
    return out


if __name__ == "__main__":
    main()

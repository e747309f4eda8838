"""Experiment runner CLI: train or evaluate a config on one device.

Counterpart of image_segmentation_tpu/run.py (the reference notebooks'
cell-0 "main": datasets, model, loss, AdamW, accumulation, start()).
Only `unet_noaug` trains in the port so far; the JAX package's other
configs are refused as not ported yet.

  python -m image_segmentation_tpu_torch.run --config unet_noaug \
      --data-root /data/pet --save-dir runs/ [--epochs N] [--batch-size N]
  python -m image_segmentation_tpu_torch.run --config unet_noaug --synthetic 64 \
      --epochs 2 --target-size 64 --device cpu   # no dataset needed
  python -m image_segmentation_tpu_torch.run --config unet_noaug --synthetic 64 \
      --evaluate runs/MO_unet_noaug --split Val

Data layout: {root}/{split}/{color,label}/ (class-id PNG labels with the
255 boundary sentinel). `--device` is cuda by default and the run refuses
to start without a card; the CPU is an explicit `--device cpu`. On CUDA
the model computes in bfloat16 with float32 parameters, and its eval
forwards run K1.
"""
from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch

# the JAX package's configs whose training is not in the port yet
NOT_PORTED = ("unet_aug", "recon_ae", "autoencoder", "clipunet", "clipunet_noskips",
              "prompt")
# flags of JAX run.py paths the port does not have yet
REFUSED_FLAGS = ("multihost", "cache_features", "init_weights", "pretrained_encoder",
                 "clip_weights", "tensorboard", "profile_dir")


def _synthetic_items(n: int, seed: int = 0):
    """The JAX runner's synthetic task (run.py:22-37): noise images of
    120-259 px with one class-coloured box and a boundary column."""
    rng = np.random.default_rng(seed)
    items = []
    for i in range(n):
        h = int(rng.integers(120, 260))
        w = int(rng.integers(120, 260))
        img = rng.uniform(0, 0.3, (h, w, 3)).astype(np.float32)
        label = np.zeros((h, w), np.int32)
        cls = 1 + (i % 2)
        label[h // 4: 3 * h // 4, w // 2:] = cls
        img[h // 4: 3 * h // 4, w // 2:, cls - 1] += 0.6
        label[:, w // 2 - 1: w // 2 + 1] = 255
        items.append((img, label))
    return items


def synthetic_materialized(n: int, target_size: int, seed: int = 0,
                           keep_orig_labels: bool = False):
    """Synthetic items, boundary-remapped and materialised."""
    from image_segmentation_tpu_torch.data.dataset import ArrayDataset
    from image_segmentation_tpu_torch.data.labels import target_remap
    from image_segmentation_tpu_torch.data.loader import materialize

    items = [(img, target_remap(lab)) for img, lab in _synthetic_items(n, seed)]
    return materialize(ArrayDataset(items), target_size, keep_orig_labels=keep_orig_labels)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m image_segmentation_tpu_torch.run")
    p.add_argument("--config", required=True)
    p.add_argument("--data-root", default=None)
    p.add_argument("--save-dir", default="runs")
    p.add_argument("--synthetic", type=int, default=0,
                   help="train on N synthetic images instead of real data")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None, help="the micro-batch")
    p.add_argument("--target-size", type=int, default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--lr-schedule", default=None, choices=["constant", "cosine"])
    p.add_argument("--warmup-steps", type=int, default=None)
    p.add_argument("--early-stop-patience", type=int, default=None, metavar="N")
    p.add_argument("--ckpt-every", type=int, default=1,
                   help="'_last' checkpoint cadence in epochs (a new best always saves)")
    p.add_argument("--eval-protocol", default="device", choices=["device", "host"])
    p.add_argument("--evaluate", default=None, metavar="CKPT",
                   help="evaluate a checkpoint of this port (a full checkpoint "
                        "directory or an MO_ directory) on --split instead of training")
    p.add_argument("--split", default="Test",
                   help="split for --evaluate; with --synthetic, 'Val' is the set fit "
                        "validated on and anything else a held-out synthetic set")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain versions)")
    for flag in REFUSED_FLAGS:
        p.add_argument("--" + flag.replace("_", "-"), default=None, nargs="?",
                       const=True, help="not ported yet (refused)")
    return p


def main(argv=None):
    args = _parser().parse_args(argv)
    refused = [f for f in REFUSED_FLAGS if getattr(args, f) is not None]
    if refused:
        raise SystemExit("not ported yet, refused: " + ", ".join(
            "--" + f.replace("_", "-") for f in refused))
    if args.config in NOT_PORTED:
        raise SystemExit(f"config {args.config!r}: training is not ported yet "
                         f"(the port trains 'unet_noaug')")
    if args.config != "unet_noaug":
        raise SystemExit(f"unknown config {args.config!r}; have ['unet_noaug']")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available "
                         f"(pass --device cpu to run on the CPU)")
    if not args.synthetic and not args.data_root:
        raise SystemExit("--data-root or --synthetic required")

    from image_segmentation_tpu_torch import config as C
    from image_segmentation_tpu_torch.data.dataset import ArrayDataset, SegmentationDataset
    from image_segmentation_tpu_torch.data.labels import target_remap
    from image_segmentation_tpu_torch.data.loader import materialize
    from image_segmentation_tpu_torch.losses.host import dice_ce_loss_np
    from image_segmentation_tpu_torch.train import checkpoint as ckpt
    from image_segmentation_tpu_torch.train.loop import evaluate, fit
    from image_segmentation_tpu_torch.train.state import TrainState

    cfg = C.UNET_NOAUG
    overrides = {k: v for k, v in (("epochs", args.epochs), ("batch_size", args.batch_size),
                                   ("target_size", args.target_size),
                                   ("lr_schedule", args.lr_schedule),
                                   ("warmup_steps", args.warmup_steps)) if v is not None}
    cfg = dataclasses.replace(cfg, **overrides)
    print(f"[run] config={cfg.name} device={device}"
          + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))

    eval_only = args.evaluate is not None
    if args.synthetic:
        n_val = max(4, args.synthetic // 4)
        # 'Val' is the set fit() validated on; any other split is held out
        val_seed = cfg.seed + (1 if not eval_only or args.split == "Val" else 2)
        train_raw = None if eval_only else ArrayDataset(_synthetic_items(args.synthetic,
                                                                         cfg.seed))
        val_raw = ArrayDataset(_synthetic_items(n_val, val_seed))
    else:
        mk = lambda split: SegmentationDataset(os.path.join(args.data_root, split, "color"),
                                               os.path.join(args.data_root, split, "label"),
                                               target_transform=target_remap)
        train_raw, val_raw = (None, mk(args.split)) if eval_only else (mk("Train"), mk("Val"))
    for ds in (train_raw, val_raw):
        if isinstance(ds, ArrayDataset):
            ds.map_labels(target_remap)
    n_train = 0 if eval_only else len(train_raw)
    print(f"[run] materialising {n_train} train / {len(val_raw)} "
          f"{'eval' if eval_only else 'val'} items at {cfg.target_size}px …")
    train_data = None if eval_only else materialize(train_raw, cfg.target_size)
    val_data = materialize(val_raw, cfg.target_size, keep_orig_labels=True)

    model = C.build_model(cfg, device, torch.Generator().manual_seed(cfg.seed))
    loss_fn = C.build_loss(cfg)
    val_loss_fn = C.build_val_loss(cfg)
    host_loss = lambda lg, lb: dice_ce_loss_np(lg, lb, val_loss_fn)  # noqa: E731

    if eval_only:
        model.load_state_dict(ckpt.load_model_state(args.evaluate, device))
        print(f"[run] evaluating {args.evaluate} on {args.split} ({len(val_raw)} images, "
              f"protocol={args.eval_protocol}) …")
        res = evaluate(TrainState(model), val_data, host_loss_fn=host_loss,
                       num_classes=cfg.num_classes, eval_ignore_index=cfg.eval_ignore_index,
                       batch_size=cfg.batch_size, protocol=args.eval_protocol,
                       loss_cfg=val_loss_fn if args.eval_protocol == "device" else None)
        print(f"[run] {args.split} eval: loss={res['loss']:.4f} acc={res['acc']:.4f} "
              f"dice={res['dice']:.4f} miou={res['iou']:.4f}")
        return res

    # fit takes the step batch (the reference's effective batch of 64) and
    # splits it into accum micro-batches; tiny sets shrink both
    micro = min(cfg.batch_size, len(train_data))
    if micro < cfg.batch_size:
        print(f"[run] dataset smaller than batch size; using batch {micro}")
    accum = max(1, min(cfg.accum_steps, len(train_data) // micro))
    # the decay horizon in optimizer steps (one per effective batch)
    total_steps = cfg.epochs * max(1, len(train_data) // (cfg.batch_size * cfg.accum_steps))
    opt, sched = C.build_optimizer(cfg, model, total_steps=total_steps)
    state = TrainState(model=model, optimizer=opt, scheduler=sched)
    result = fit(
        state, train_data, val_data, loss_fn=loss_fn, epochs=cfg.epochs,
        batch_size=micro * accum, accum_steps=accum, save_dir=args.save_dir,
        name=cfg.name, host_loss_fn=host_loss, num_classes=cfg.num_classes,
        eval_ignore_index=cfg.eval_ignore_index, eval_batch_size=cfg.batch_size,
        resume=args.resume, seed=cfg.seed, eval_protocol=args.eval_protocol,
        eval_loss_cfg=val_loss_fn, checkpoint_every=args.ckpt_every,
        early_stop_patience=args.early_stop_patience)
    print(f"[run] done: best {result.best}")
    return result


if __name__ == "__main__":
    main()

"""Experiment runner CLI: train or evaluate a config on one device, or
train it across processes (`--multihost`).

Counterpart of image_segmentation_tpu/run.py (the reference notebooks'
cell-0 "main": datasets, model, loss, AdamW, accumulation, start()).
The port trains all seven of the JAX package's configs: `unet_noaug`,
`unet_aug`, the two-stage autoencoder (`recon_ae`, then `autoencoder`),
`clipunet`, `clipunet_noskips` and `prompt`.

  python -m image_segmentation_tpu_torch.run --config unet_noaug \
      --data-root /data/pet --save-dir runs/ [--epochs N] [--batch-size N]
  python -m image_segmentation_tpu_torch.run --config unet_aug --synthetic 64 \
      --epochs 2 --target-size 64 --device cpu   # online augmentation
  python -m image_segmentation_tpu_torch.run --config unet_aug --offline-aug ...
  python -m image_segmentation_tpu_torch.run --config recon_ae --synthetic 64 ...
  python -m image_segmentation_tpu_torch.run --config autoencoder --synthetic 64 \
      --pretrained-encoder runs/recon_ae ...   # encoder transferred and frozen
  python -m image_segmentation_tpu_torch.run --config unet_noaug --synthetic 64 \
      --evaluate runs/MO_unet_noaug --split Val
  python -m image_segmentation_tpu_torch.run --config clipunet --synthetic 16 \
      --smoke-vit --device cpu [--cache-features] [--clip-weights clip.npz]
  python -m image_segmentation_tpu_torch.run --config prompt --synthetic 16 \
      --smoke-vit --device cpu --clipunet-checkpoint runs/MO_clipunet

Data layout: {root}/{split}/{color,label}/ (class-id PNG labels with the
255 boundary sentinel). `--device` is cuda by default and the run refuses
to start without a card; the CPU is an explicit `--device cpu`. On CUDA
the model computes in bfloat16 with float32 parameters, and a UNet's
eval forwards run K1.

Augmentation (`unet_aug`, or `--augment on`): online by default, on the
device, one augmenter or none per sample of every step batch
(ops/augment.py; every family but the prompt, JAX run.py:543-548); with
`--offline-aug` the train set is expanded once on the host before the
label remap (data/augment.py). `recon_ae` trains with Adam (no weight
decay) on the MSE against the input and checkpoints the best val MSE;
`autoencoder --pretrained-encoder CKPT` takes its encoder (parameters and
BN statistics), frozen out of the optimizer when the config's
`freeze_encoder` is set. The frozen encoder still runs in train mode, so
its BN statistics move, as JAX's mutable batch_stats do.

The CLIP family (JAX run.py:355-382, 484-611): the ViT is frozen out of
AdamW (`vision_model` for the ClipUNets; the whole `clip` branch for a
frozen prompt model, else `clip.vision_model`). `--clip-weights NPZ`
loads a converted CLIP ViT (utils/convert_clip_weights.py) into
`vision_model` (or `clip.vision_model`); `prompt --clipunet-checkpoint
CKPT` grafts a trained ClipUNet into the `clip` branch (parameters and BN
statistics). `--cache-features` (`clipunet` with a frozen encoder and no
online augmentation; ignored with a note otherwise, as JAX ignores it)
encodes the train set through the frozen ViT once and trains the decoder
alone on the features; validation and every checkpoint use the whole
ClipUNet, so `--evaluate` and `--clipunet-checkpoint` read its `MO_`.
The prompt config trains on prompt triplets (data/prompts.py: train
seeded `seed`, val `seed + 1`), Dice + NLL on probabilities.
`--smoke-vit` shrinks the ViT to JAX's smoke geometry (hidden 64, 4
layers, 4 heads, MLP 128) for the CPU; its head dim 16 is not one K3
takes, so it refuses `--device cuda`.

Data parallelism across processes (JAX run.py:148-158, :623-690):
`--multihost` brings up a torch.distributed group, one process per
device, and trains with `train.multihost_loop.fit_multihost`. Launch one
identical command per process:

  for r in 0 1; do python -m image_segmentation_tpu_torch.run --config unet_noaug \
      --synthetic 16 --device cpu --multihost --coordinator 127.0.0.1:29500 \
      --num-processes 2 --process-id $r & done; wait

(or under torchrun, which sets the group's environment). The backend is
gloo on the CPU, NCCL when each process of a host has a card of its own,
and gloo when processes share a card; every process prints it first.
Process 0 alone prints the epoch lines and writes the checkpoints, the
metrics file, the TensorBoard events and the trace. As in JAX, `--evaluate`,
`recon_ae`, `--cache-features` and `--eval-protocol host` are refused
under `--multihost`; unlike JAX, `--early-stop-patience` is honoured
there. A process of the port drives one device, so `--max-devices`
(JAX's cap on the devices of one process's mesh) takes 0 or 1.
`--platform cpu|gpu|cuda` is JAX's name for `--device`.
`--tensorboard DIR` writes per-epoch scalars under DIR/<config name>
(needs tensorboardX), `--profile-dir DIR` a torch.profiler trace of the
fit, and `--nan-checks` raises at the first non-finite loss or gradient
of a train step.
"""
from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch

# the configs the port trains: all of the JAX package's
TRAINED = ("unet_noaug", "unet_aug", "recon_ae", "autoencoder", "clipunet",
           "clipunet_noskips", "prompt")
CLIP_CONFIGS = ("clipunet", "clipunet_noskips", "prompt")
# JAX's --platform values and the device each names
PLATFORMS = {"cpu": "cpu", "gpu": "cuda", "cuda": "cuda"}


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
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; cpu runs the plain versions)")
    p.add_argument("--platform", default=None,
                   help="JAX's platform flag, mapped onto --device: cpu, or gpu/cuda")
    p.add_argument("--augment", default=None, choices=["on", "off"],
                   help="override the config's augmentation flag")
    p.add_argument("--offline-aug", action="store_true",
                   help="with augmentation on: expand the train set offline on the host "
                        "instead of augmenting each step batch on the device")
    p.add_argument("--init-weights", default=None, metavar="CKPT",
                   help="initialise parameters and BN statistics from a checkpoint of "
                        "this port (full or MO_), then train")
    p.add_argument("--pretrained-encoder", default=None, metavar="CKPT",
                   help="autoencoder: take the encoder of a recon_ae checkpoint")
    p.add_argument("--clip-weights", default=None, metavar="NPZ",
                   help="CLIP configs: load a converted CLIP ViT .npz (the file "
                        "utils/convert_clip_weights.py writes) into the ViT")
    p.add_argument("--clipunet-checkpoint", default=None, metavar="CKPT",
                   help="prompt: graft a trained ClipUNet checkpoint of this port "
                        "(full or MO_) into the clip branch")
    p.add_argument("--cache-features", action="store_true",
                   help="clipunet: encode the train set through the frozen ViT once "
                        "and train the decoder alone on the features")
    p.add_argument("--smoke-vit", action="store_true",
                   help="CLIP configs: JAX's smoke ViT (hidden 64, 4 layers, 4 heads, "
                        "MLP 128) and a narrow decoder, for the CPU")
    p.add_argument("--tensorboard", default=None, metavar="DIR",
                   help="per-epoch TensorBoard scalars under DIR/<config name> (needs "
                        "tensorboardX); process 0 only under --multihost")
    p.add_argument("--profile-dir", default=None, metavar="DIR",
                   help="a torch.profiler trace of the fit under DIR; process 0 only "
                        "under --multihost")
    p.add_argument("--nan-checks", action="store_true",
                   help="raise at the first non-finite loss or gradient of a train step")
    p.add_argument("--max-devices", type=int, default=0,
                   help="JAX's cap on one process's data-parallel devices; a process of "
                        "the port drives one device, so 0 or 1 (use --multihost for more)")
    p.add_argument("--multihost", action="store_true",
                   help="train across processes, one device each (fit_multihost); launch "
                        "one identical command per process")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="--multihost: process 0's store (or a tcp:// or file:// URL)")
    p.add_argument("--num-processes", type=int, default=0)
    p.add_argument("--process-id", type=int, default=-1)
    return p


def _check_checkpoint(flag: str, path: str) -> None:
    from image_segmentation_tpu_torch.train import checkpoint as ckpt

    if not any(os.path.exists(os.path.join(path, f)) for f in (ckpt.WEIGHTS_FILE,
                                                               ckpt.STATE_FILE)):
        raise SystemExit(f"{flag} {path}: not a checkpoint of this port (no "
                         f"{ckpt.WEIGHTS_FILE} or {ckpt.STATE_FILE} there)")


def _device_arg(args) -> str:
    """--device, or the device --platform names (JAX run.py:144)."""
    if args.platform is None:
        return args.device or "cuda"
    if args.platform not in PLATFORMS:
        raise SystemExit(f"--platform {args.platform}: the port runs on cpu or gpu/cuda; "
                         f"pick the torch device with --device")
    if args.device is not None and torch.device(args.device).type != PLATFORMS[args.platform]:
        raise SystemExit(f"--platform {args.platform} and --device {args.device} disagree")
    return args.device or PLATFORMS[args.platform]


def _multihost_refusals(args, cfg) -> None:
    """JAX's refusals under --multihost (run.py:229-236, :551-555, :649-659)."""
    if args.evaluate is not None or cfg.model == "recon":
        raise SystemExit("[run] --evaluate and recon configs are single-process; drop "
                         "--multihost (multi-process covers the fit pipelines)")
    blockers = (["--cache-features"] if args.cache_features else []) + (
        ["--eval-protocol host"] if args.eval_protocol != "device" else [])
    if blockers:
        raise SystemExit("[run] not supported with --multihost: " + "; ".join(blockers))


def _bring_up(args, device: torch.device):
    """The process group of --multihost and this process's data axis."""
    import torch.distributed as dist

    from image_segmentation_tpu_torch.parallel.mesh import get_mesh, init_distributed
    from image_segmentation_tpu_torch.parallel.multihost import initialize_multihost

    if args.coordinator:
        if args.num_processes < 1 or args.process_id < 0:
            raise SystemExit("--coordinator needs --num-processes and --process-id")
        initialize_multihost(args.coordinator, args.num_processes, args.process_id,
                             device.type)
    elif not init_distributed(device.type):
        raise SystemExit("--multihost needs --coordinator HOST:PORT, --num-processes and "
                         "--process-id (or a launcher's MASTER_ADDR, WORLD_SIZE and RANK)")
    axis = get_mesh(device.type)
    print(f"[run] multihost: process {axis.rank}/{axis.size}, backend "
          f"{dist.get_backend()}, device {axis.device}", flush=True)
    return axis


def main(argv=None):
    args = _parser().parse_args(argv)
    if args.config not in TRAINED:
        raise SystemExit(f"unknown config {args.config!r}; have {list(TRAINED)}")
    device = torch.device(_device_arg(args))
    if args.max_devices > 1:
        raise SystemExit(f"--max-devices {args.max_devices}: a process of the port drives "
                         f"one device; run {args.max_devices} processes with --multihost")
    from image_segmentation_tpu_torch import config as C

    if args.multihost:
        _multihost_refusals(args, C.CONFIGS[args.config])
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available "
                         f"(pass --device cpu to run on the CPU)")
    if args.smoke_vit and device.type == "cuda":
        raise SystemExit("--smoke-vit: its head dim 16 is not one the attention kernel "
                         "takes (64); run it with --device cpu")
    if not args.synthetic and not args.data_root:
        raise SystemExit("--data-root or --synthetic required")
    for flag in ("init_weights", "pretrained_encoder", "clipunet_checkpoint"):
        if getattr(args, flag) is not None:
            _check_checkpoint("--" + flag.replace("_", "-"), getattr(args, flag))
    if args.clip_weights is not None and not os.path.isfile(args.clip_weights):
        raise SystemExit(f"--clip-weights {args.clip_weights}: no such file")
    axis = _bring_up(args, device) if args.multihost else None
    if axis is not None:
        device = axis.device
    try:
        return _main(args, device, axis)
    finally:
        if axis is not None:
            import torch.distributed as dist

            dist.destroy_process_group()


def _main(args, device: torch.device, axis):
    from image_segmentation_tpu_torch import config as C
    from image_segmentation_tpu_torch.data.dataset import ArrayDataset, SegmentationDataset
    from image_segmentation_tpu_torch.data.labels import target_remap
    from image_segmentation_tpu_torch.data.loader import materialize

    cfg = C.CONFIGS[args.config]
    overrides = {k: v for k, v in (("epochs", args.epochs), ("batch_size", args.batch_size),
                                   ("target_size", args.target_size),
                                   ("lr_schedule", args.lr_schedule),
                                   ("warmup_steps", args.warmup_steps)) if v is not None}
    if args.augment is not None:
        overrides["augment"] = args.augment == "on"
    if args.offline_aug:
        overrides["augment_online"] = False
    cfg = dataclasses.replace(cfg, **overrides)
    if args.nan_checks:
        from image_segmentation_tpu_torch.utils.profiling import enable_nan_checks

        enable_nan_checks()
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
                                               os.path.join(args.data_root, split, "label"))
        train_raw, val_raw = (None, mk(args.split)) if eval_only else (mk("Train"), mk("Val"))
    if cfg.augment and not cfg.augment_online and not eval_only:
        from image_segmentation_tpu_torch.data.augment import generate_augmented_dataset

        print("[run] materialising offline augmentation …")
        train_raw = generate_augmented_dataset(train_raw, seed=cfg.seed, size=cfg.target_size)
    if cfg.model == "prompt":
        from image_segmentation_tpu_torch.data.prompts import generate_prompt_dataset

        # triplets from the raw labels (the prompt remap happens there)
        train_raw = None if eval_only else generate_prompt_dataset(train_raw, seed=cfg.seed)
        val_raw = generate_prompt_dataset(val_raw, seed=cfg.seed + 1)
    for ds in () if cfg.model == "prompt" else (train_raw, val_raw):
        # in place: a full-scale offline set is ~23k samples, and a remapped
        # copy would double host memory
        if isinstance(ds, SegmentationDataset):
            ds.target_transform = target_remap
        elif isinstance(ds, ArrayDataset):
            ds.map_labels(target_remap)
    n_train = 0 if eval_only else len(train_raw)
    print(f"[run] materialising {n_train} train / {len(val_raw)} "
          f"{'eval' if eval_only else 'val'} items at {cfg.target_size}px …")
    train_data = None if eval_only else materialize(train_raw, cfg.target_size)
    val_data = materialize(val_raw, cfg.target_size, keep_orig_labels=True)
    model = C.build_model(cfg, device, torch.Generator().manual_seed(cfg.seed),
                          **(_smoke_vit_overrides(cfg) if args.smoke_vit else {}))
    if cfg.model == "recon":
        return _run_reconstruction(args, cfg, model, device, train_data, val_data, val_raw)
    return _run_segmentation(args, cfg, model, device, train_data, val_data, len(val_raw),
                             axis)


def _tb_logger(args, cfg):
    """--tensorboard DIR: a TensorBoardLogger at DIR/<config name>, else None."""
    from image_segmentation_tpu_torch.utils.tb import maybe_logger

    return maybe_logger(args.tensorboard and os.path.join(args.tensorboard, cfg.name))


def _smoke_vit_overrides(cfg) -> dict:
    """JAX run.py:355-382: a ViT of hidden 64, 4 layers, 4 heads, MLP 128 at
    the target size, skips (1, 2, 3, 4), decoder channels max(8, 64 >> i)
    over the four doublings from the 16 px patch grid, and a selection UNet
    of base 8 for the prompt model."""
    from image_segmentation_tpu_torch.models.clip_vit import ClipViTConfig

    if cfg.model not in CLIP_CONFIGS:
        return {}
    vit = ClipViTConfig(image_size=cfg.target_size, patch_size=16, hidden_size=64,
                        num_layers=4, num_heads=4, mlp_dim=128)
    out = dict(vit=vit, decoder_channels=tuple(max(8, 64 >> i) for i in range(5)))
    if cfg.model != "clipunet_noskips":
        out["skip_indices"] = (1, 2, 3, 4)
    if cfg.model == "prompt":
        out["unet_base"] = 8
    return out


def _run_reconstruction(args, cfg, model, device, train_data, val_data, val_raw):
    """Stage 1 of the autoencoder (JAX run.py:300-350)."""
    from image_segmentation_tpu_torch.train import checkpoint as ckpt
    from image_segmentation_tpu_torch.train.loop import (
        evaluate_reconstruction,
        fit_reconstruction,
    )
    from image_segmentation_tpu_torch.train.state import TrainState, make_adamw
    from image_segmentation_tpu_torch.utils.profiling import trace_context

    originals = [np.asarray(val_raw[i][0]) for i in range(len(val_raw))]
    if args.evaluate is not None:
        model.load_state_dict(ckpt.load_model_state(args.evaluate, device))
        print(f"[run] evaluating {args.evaluate} on {args.split} ({len(val_raw)} images) …")
        mse = evaluate_reconstruction(TrainState(model), val_data, originals=originals,
                                      batch_size=cfg.batch_size)
        print(f"[run] {args.split} eval: mse={mse:.6f}")
        return {"loss": mse}
    # the reference's stage 1 is Adam with no weight decay, lr 1e-3
    opt, _ = make_adamw(model.parameters(), learning_rate=cfg.learning_rate, weight_decay=0.0)
    accum = max(1, min(cfg.accum_steps, len(train_data) // cfg.batch_size))
    tb = _tb_logger(args, cfg)
    try:
        with trace_context(args.profile_dir):
            result = fit_reconstruction(
                TrainState(model, opt), train_data, val_data, originals=originals,
                epochs=cfg.epochs, batch_size=cfg.batch_size * accum, accum_steps=accum,
                save_dir=args.save_dir, name=cfg.name, resume=args.resume, seed=cfg.seed,
                metrics_logger=tb)
    finally:
        if tb is not None:
            tb.close()
    print(f"[run] done: best {result.best}")
    return result


def _run_segmentation(args, cfg, model, device, train_data, val_data, n_val: int, axis=None):
    from image_segmentation_tpu_torch import config as C
    from image_segmentation_tpu_torch.losses.host import dice_ce_loss_np, dice_nll_loss_np
    from image_segmentation_tpu_torch.train import checkpoint as ckpt
    from image_segmentation_tpu_torch.train.loop import evaluate, fit
    from image_segmentation_tpu_torch.train.multihost_loop import fit_multihost
    from image_segmentation_tpu_torch.train.state import TrainState, freeze_
    from image_segmentation_tpu_torch.utils.profiling import trace_context

    loss_fn = C.build_loss(cfg)
    val_loss_fn = C.build_val_loss(cfg)
    host_np = dice_nll_loss_np if cfg.model == "prompt" else dice_ce_loss_np
    host_loss = lambda lg, lb: host_np(lg, lb, val_loss_fn)  # noqa: E731

    if args.evaluate is not None:
        model.load_state_dict(ckpt.load_model_state(args.evaluate, device))
        print(f"[run] evaluating {args.evaluate} on {args.split} ({n_val} images, "
              f"protocol={args.eval_protocol}) …")
        res = evaluate(TrainState(model), val_data, host_loss_fn=host_loss,
                       num_classes=cfg.num_classes, eval_ignore_index=cfg.eval_ignore_index,
                       batch_size=cfg.batch_size, protocol=args.eval_protocol,
                       loss_cfg=val_loss_fn if args.eval_protocol == "device" else None)
        print(f"[run] {args.split} eval: loss={res['loss']:.4f} acc={res['acc']:.4f} "
              f"dice={res['dice']:.4f} miou={res['iou']:.4f}")
        return res

    if args.init_weights:
        model.load_state_dict(ckpt.load_model_state(args.init_weights, device))
        print(f"[run] initialised weights from {args.init_weights}")
    frozen = ()
    if cfg.model == "autoencoder" and args.pretrained_encoder:
        ckpt.load_subtree(args.pretrained_encoder, model, "encoder", "encoder")
        print("[run] loaded pretrained AE encoder (params + BN stats)")
        if cfg.freeze_encoder:
            frozen = ("encoder",)
    if cfg.model in CLIP_CONFIGS and args.clip_weights:
        from image_segmentation_tpu_torch.models.clip_vit import load_pretrained_clip_state

        vit = model.clip.vision_model if cfg.model == "prompt" else model.vision_model
        vit.load_state_dict(load_pretrained_clip_state(args.clip_weights))
        print(f"[run] loaded pretrained CLIP ViT weights from {args.clip_weights}")
    if cfg.model == "prompt" and args.clipunet_checkpoint:
        n = ckpt.load_subtree(args.clipunet_checkpoint, model, "", "clip")
        print(f"[run] grafted the ClipUNet of {args.clipunet_checkpoint} into the prompt "
              f"model's clip branch ({n} entries: params + BN stats)")
    if cfg.model in ("clipunet", "clipunet_noskips") and cfg.freeze_encoder:
        # no_grad gives the ViT no gradient; out of AdamW, no decay shrinks it
        frozen = ("vision_model",)
    elif cfg.model == "prompt":
        # the fine-tuned variant trains the clip decoder and the selection
        # UNet; the ViT inside stays frozen (JAX run.py:515-522)
        frozen = ("clip",) if cfg.freeze_encoder else ("clip.vision_model",)
    freeze_(model, frozen)
    augment_fn = None
    if cfg.augment and cfg.augment_online and cfg.model != "prompt":
        from image_segmentation_tpu_torch.ops.augment import random_augment_batch

        augment_fn = random_augment_batch
        print("[run] online on-device augmentation enabled")

    # fit takes the step batch (the reference's effective batch of 64) and
    # splits it into accum micro-batches; tiny sets shrink both
    micro = min(cfg.batch_size, len(train_data))
    if micro < cfg.batch_size:
        print(f"[run] dataset smaller than batch size; using batch {micro}")
    accum = max(1, min(cfg.accum_steps, len(train_data) // micro))
    # the decay horizon in optimizer steps (one per effective batch)
    total_steps = cfg.epochs * max(1, len(train_data) // (cfg.batch_size * cfg.accum_steps))
    opt, sched = C.build_optimizer(cfg, model, total_steps=total_steps, frozen_prefixes=frozen)
    state = TrainState(model=model, optimizer=opt, scheduler=sched)
    eval_state_fn = None
    if args.cache_features:
        if cfg.model == "clipunet" and cfg.freeze_encoder and augment_fn is None:
            state, train_data, eval_state_fn = _cached_feature_training(cfg, state, train_data,
                                                                        total_steps)
        else:
            print(f"[run] --cache-features ignored: it needs the clipunet config with a "
                  f"frozen encoder and no online augmentation (config {cfg.name}, "
                  f"online augmentation {augment_fn is not None})")
    lead = axis is None or axis.rank == 0
    kw = dict(loss_fn=loss_fn, epochs=cfg.epochs, batch_size=micro * accum, accum_steps=accum,
              save_dir=args.save_dir, name=cfg.name, num_classes=cfg.num_classes,
              eval_ignore_index=cfg.eval_ignore_index, eval_batch_size=cfg.batch_size,
              resume=args.resume, seed=cfg.seed, eval_loss_cfg=val_loss_fn,
              checkpoint_every=args.ckpt_every, early_stop_patience=args.early_stop_patience,
              augment_fn=augment_fn)
    tb = _tb_logger(args, cfg) if lead else None
    try:
        with trace_context(args.profile_dir if lead else None):
            if axis is not None:
                result = fit_multihost(state, train_data, val_data, metrics_logger=tb, **kw)
            else:
                result = fit(state, train_data, val_data, host_loss_fn=host_loss,
                             eval_protocol=args.eval_protocol, eval_state_fn=eval_state_fn,
                             metrics_logger=tb, **kw)
    finally:
        if tb is not None:
            tb.close()
    if lead:
        print(f"[run] done: best {result.best}")
    return result


def _cached_feature_training(cfg, state, train_data, total_steps: int):
    """--cache-features (JAX run.py:556-611): the train set's features
    through the frozen ViT once; a state over the decoder-only view of the
    ClipUNet (its own modules) with an optimizer over the decoder alone;
    and an `eval_state_fn` that hands fit the whole ClipUNet, which it
    validates and checkpoints."""
    from image_segmentation_tpu_torch import config as C
    from image_segmentation_tpu_torch.train import feature_cache as FC
    from image_segmentation_tpu_torch.train.state import TrainState

    full = state.model
    print("[run] caching frozen-CLIP features for the train set …")
    feats = FC.encode_clip_features(full, train_data.images, batch_size=cfg.batch_size,
                                    verbose=True)
    decoder = full.decoder_only()
    opt, sched = C.build_optimizer(cfg, decoder, total_steps=total_steps)
    print(f"[run] training decoder-only on cached features ({feats.nbytes} bytes, "
          f"float32)")
    return (TrainState(decoder, opt, sched), FC.features_dataset(train_data, feats),
            lambda s: TrainState(full, s.optimizer, s.scheduler, s.step))


if __name__ == "__main__":
    main()

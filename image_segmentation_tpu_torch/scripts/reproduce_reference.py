"""One-command reproduction of the reference README results table.

Counterpart of the JAX repository's scripts/reproduce_reference.py. The
reference reports six rows (reference README.md:30-37, PDF Table 2): UNet
(Augmented / No Aug), CLIP (Augmented / No Aug), Autoencoder and
Prompt-based, each trained by a notebook's cell-0 "main" and evaluated on
the held-out Test split at original resolution. This script runs the
whole table through the port's `run.main`, in process, chaining what the
notebooks chain: recon_ae pretraining → the frozen-encoder autoencoder
(`--pretrained-encoder`), and the augmented ClipUNet → the prompt model
(`--clipunet-checkpoint`):

    python -m image_segmentation_tpu_torch.scripts.reproduce_reference \
        --data-root /data/pet --save-dir runs/repro [--clip-weights clip.npz] \
        [--epochs 100] [--rows unet_aug,unet_noaug,...] [--device cpu]

It prints a README-style Accuracy/Dice/IoU table with the Dice delta to
the reference's numbers and writes it as JSON. Each row trains, then
`--evaluate <best checkpoint> --split Test` scores it.

Data layout: {root}/{Train,Val,Test}/{color,label}, the output of
scripts/prepare_oxford_pet.py.

Without --clip-weights the CLIP-family rows run the smoke ViT
(`--smoke-vit`, the CPU only: its head dim 16 is not one the attention
kernel takes): the pipelines run end to end, but those rows are marked not
comparable to the reference, whose numbers come from the frozen
openai/clip-vit-base-patch16. Convert real weights with
`python -m image_segmentation_tpu_torch.utils.convert_clip_weights` first.

Where it departs from JAX's script: `--device` (default cuda) is forwarded
to every run, since the port's runner needs it to use the CPU; JAX's
`--compile-cache` has no counterpart (the port compiles no XLA programs).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

# Reference README.md:32-37 (PDF Table 2): Accuracy / Dice / IoU on the
# Pet Test split, original-resolution protocol, boundary class ignored.
REFERENCE_TABLE = {
    "unet_aug": ("UNet (Augmented)", 0.9462, 0.8661, 0.7687),
    "unet_noaug": ("UNet (No Aug)", 0.9444, 0.8632, 0.7643),
    "clip_aug": ("CLIP (Augmented)", 0.9732, 0.9442, 0.8946),
    "clip_noaug": ("CLIP (No Aug)", 0.9723, 0.9414, 0.8897),
    "autoencoder": ("Autoencoder", 0.8712, 0.6804, 0.5382),
    "prompt": ("Prompt-based", 0.8321, 0.7088, 0.5497),
}
ROW_ORDER = ("unet_aug", "unet_noaug", "clip_aug", "clip_noaug", "autoencoder", "prompt")


def _run(argv):
    """One runner invocation (the notebooks' cell-0 'main')."""
    from image_segmentation_tpu_torch.run import main

    print(f"[repro] run {' '.join(argv)}", flush=True)
    return main(argv)


def _train_and_eval(config, row_dir, common, extra_train=(), extra_eval=()):
    """Train `config`, then evaluate its best checkpoint on Test. Returns
    (test metrics, best checkpoint path)."""
    _run(["--config", config, "--save-dir", row_dir, *common, *extra_train])
    ckpt = os.path.join(row_dir, config)
    res = _run(["--config", config, "--evaluate", ckpt, "--split", "Test",
                *common, *extra_eval])
    return res, ckpt


def reproduce(args) -> dict:
    os.makedirs(args.save_dir, exist_ok=True)
    common = ["--data-root", args.data_root, "--epochs", str(args.epochs),
              "--batch-size", str(args.batch_size), "--device", args.device]
    if args.early_stop_patience:
        # --evaluate ignores fit-only flags, so it can ride `common`
        common += ["--early-stop-patience", str(args.early_stop_patience)]
    if args.target_size:
        common += ["--target-size", str(args.target_size)]
    if args.max_devices:
        common += ["--max-devices", str(args.max_devices)]
    clip_flags = ["--clip-weights", args.clip_weights] if args.clip_weights else ["--smoke-vit"]
    smoke_eval = [] if args.clip_weights else ["--smoke-vit"]
    aug_flags = ["--offline-aug"] if args.offline_aug else []

    rows = [r.strip() for r in args.rows.split(",")] if args.rows else list(ROW_ORDER)
    results = {}
    clip_aug_ckpt = None
    for row in rows:
        row_dir = os.path.join(args.save_dir, row)
        if row == "unet_noaug":
            res, _ = _train_and_eval("unet_noaug", row_dir, common)
        elif row == "unet_aug":
            res, _ = _train_and_eval("unet_aug", row_dir, common, extra_train=aug_flags)
        elif row == "clip_noaug":
            res, _ = _train_and_eval("clipunet", row_dir, common,
                                     extra_train=[*clip_flags, "--augment", "off"],
                                     extra_eval=smoke_eval)
        elif row == "clip_aug":
            res, clip_aug_ckpt = _train_and_eval(
                "clipunet", row_dir, common,
                extra_train=[*clip_flags, "--augment", "on", *aug_flags],
                extra_eval=smoke_eval)
        elif row == "autoencoder":
            # stage 1: reconstruction pretraining (autoencoder.ipynb cell 0),
            # then the frozen-encoder segmentation transfer
            _run(["--config", "recon_ae", "--save-dir", row_dir, *common])
            res, _ = _train_and_eval(
                "autoencoder", row_dir, common,
                extra_train=["--pretrained-encoder", os.path.join(row_dir, "recon_ae")])
        elif row == "prompt":
            # the reference prompt model starts from the trained (augmented)
            # ClipUNet (prompt_based/prompt.py:20-27) and fine-tunes the CLIP
            # branch's decoder (PDF §4: fine-tuning won)
            if clip_aug_ckpt is None:
                clip_aug_ckpt = os.path.join(args.save_dir, "clip_aug", "clipunet")
            if not os.path.isdir(clip_aug_ckpt):
                print(f"[repro] prompt row needs the clip_aug checkpoint at "
                      f"{clip_aug_ckpt}; run the clip_aug row first")
                continue
            extra = ["--clipunet-checkpoint", clip_aug_ckpt, *smoke_eval]
            res, _ = _train_and_eval("prompt", row_dir, common, extra_train=extra,
                                     extra_eval=smoke_eval)
        else:
            sys.exit(f"[repro] unknown row {row!r}; have {ROW_ORDER}")
        results[row] = {k: float(res[k]) for k in ("acc", "dice", "iou", "loss")}
    return results


def format_table(results: dict, smoke_clip: bool) -> str:
    lines = [
        "| Model | Accuracy | Dice | IoU | ref Acc/Dice/IoU | ΔDice |",
        "|---|---|---|---|---|---|",
    ]
    for row in ROW_ORDER:
        if row not in results:
            continue
        name, racc, rdice, riou = REFERENCE_TABLE[row]
        m = results[row]
        smoke = smoke_clip and row in ("clip_aug", "clip_noaug", "prompt")
        note = " (smoke ViT — not comparable)" if smoke else ""
        delta = "n/a" if smoke else f"{m['dice'] - rdice:+.4f}"
        lines.append(
            f"| {name}{note} | {m['acc']:.4f} | {m['dice']:.4f} | "
            f"{m['iou']:.4f} | {racc:.4f}/{rdice:.4f}/{riou:.4f} | "
            f"{delta} |"
        )
    return "\n".join(lines)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(
        prog="python -m image_segmentation_tpu_torch.scripts.reproduce_reference",
        description="Reproduce the reference README results table.")
    p.add_argument("--data-root", required=True,
                   help="{root}/{Train,Val,Test}/{color,label} tree (the output of "
                        "scripts/prepare_oxford_pet.py)")
    p.add_argument("--save-dir", default="runs/repro")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--early-stop-patience", type=int, default=None,
                   help="per-row early stop once val mIoU has not improved for N epochs; "
                        "the best-mIoU checkpoint is what the Test eval scores either way")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--target-size", type=int, default=None,
                   help="override the per-config sizes (UNet/AE 256, CLIP/Prompt 224), "
                        "mainly for smoke runs")
    p.add_argument("--clip-weights", default=None,
                   help="converted CLIP ViT-B/16 weights (.npz); without it the CLIP rows "
                        "run the smoke ViT (a pipeline check, the CPU only)")
    p.add_argument("--offline-aug", action="store_true",
                   help="materialise the augmented datasets offline instead of "
                        "augmenting each step batch on the device")
    p.add_argument("--rows", default=None,
                   help=f"comma-separated subset of {','.join(ROW_ORDER)}")
    p.add_argument("--max-devices", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device for every run (default cuda; cpu runs the plain "
                        "versions)")
    p.add_argument("--json-out", default=None,
                   help="where the JSON goes (default {save-dir}/repro_table.json)")
    args = p.parse_args(argv)

    results = reproduce(args)
    table = format_table(results, smoke_clip=not args.clip_weights)
    print(f"\n[repro] reference-table reproduction (epochs={args.epochs}, "
          f"data={args.data_root}):\n")
    print(table)
    out = args.json_out or os.path.join(args.save_dir, "repro_table.json")
    with open(out, "w") as f:
        json.dump({"epochs": args.epochs, "rows": results,
                   "smoke_clip": not args.clip_weights}, f, indent=2)
    print(f"\n[repro] JSON written to {out}")
    return results


if __name__ == "__main__":
    main()
